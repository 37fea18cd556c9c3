"""The vendored minimal ONNX schema (``onnx_minimal.proto``, wire-compatible
with ``onnx.proto3``) and its protoc output, the same bytes as the JAX
package's, so that both register one identical file in protobuf's default
descriptor pool.  Regenerate with ``protoc --python_out=. onnx_minimal.proto``."""

from . import onnx_minimal_pb2  # noqa: F401
