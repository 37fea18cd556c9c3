"""The serving wire types: ``serving.proto`` (package ``MyDLPW.serving``) and its
protoc output, the same bytes as the JAX package's, so that both register
one identical file in protobuf's default descriptor pool."""

from . import serving_pb2  # noqa: F401
