"""Kernels of the port and their plain PyTorch twins.  The CUDA sources live
in ``deepflows_tpu_torch/csrc`` and are built at first use (``_build.py``)."""

from .quant import (
    int8_matmul,
    int8_matmul_plain,
    quantize_int8,
    quantize_int8_rows,
    w8a8_matmul,
    w8a8_matmul_plain,
)

# every wrapper whose launches chip_smoke.py counts on the main path
KERNELS = (int8_matmul, w8a8_matmul)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = [
    "KERNELS",
    "int8_matmul",
    "int8_matmul_plain",
    "quantize_int8",
    "quantize_int8_rows",
    "reset_launch_counts",
    "w8a8_matmul",
    "w8a8_matmul_plain",
]
