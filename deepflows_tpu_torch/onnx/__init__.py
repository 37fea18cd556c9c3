"""ONNX export and execution (counterpart of ``deepflows_tpu/onnx``; the
reference serves ``.onnx`` files through onnxruntime but ships no
exporter, ``DF_serving/serving/serving.py``).

- ``export_onnx(model, sample_input, path)``: an opset-13 file traced from
  one forward's torch calls (the vendored minimal ``onnx.proto3`` schema).
- ``OnnxModel(path, device=None)``: load and run an ONNX file, on the card
  as one CUDA graph per input shape.
- ``check_onnx(path)``: a structural summary.
"""

from .export import export_onnx
from .runtime import OnnxModel, check_onnx

__all__ = ["export_onnx", "OnnxModel", "check_onnx"]
