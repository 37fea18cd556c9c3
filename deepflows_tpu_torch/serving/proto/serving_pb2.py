# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: serving.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rserving.proto\x12\x0eMyDLPW.serving\"$\n\x06Matrix\x12\r\n\x05value\x18\x01 \x03(\x02\x12\x0b\n\x03\x64im\x18\x02 \x03(\x05\"4\n\nPredictReq\x12&\n\x06matrix\x18\x01 \x03(\x0b\x32\x16.MyDLPW.serving.Matrix\"5\n\x0bPredictResp\x12&\n\x06matrix\x18\x01 \x03(\x0b\x32\x16.MyDLPW.serving.Matrix2U\n\rMyDLPWServing\x12\x44\n\x07Predict\x12\x1a.MyDLPW.serving.PredictReq\x1a\x1b.MyDLPW.serving.PredictResp\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'serving_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _MATRIX._serialized_start=33
  _MATRIX._serialized_end=69
  _PREDICTREQ._serialized_start=71
  _PREDICTREQ._serialized_end=123
  _PREDICTRESP._serialized_start=125
  _PREDICTRESP._serialized_end=178
  _MYDLPWSERVING._serialized_start=180
  _MYDLPWSERVING._serialized_end=265
# @@protoc_insertion_point(module_scope)
