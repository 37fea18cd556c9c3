"""Kernels of the port and their plain PyTorch twins.  The CUDA sources live
in ``deepflows_tpu_torch/csrc`` and are built at first use (``_build.py``)."""

from .adam import (
    fused_adam,
    fused_adam_plain,
    fused_adam_sr,
    fused_adam_sr_plain,
    stochastic_round_bf16,
)
from .flash_attention import (
    flash_attention,
    flash_attention_bwd,
    flash_attention_bwd_plain,
    flash_attention_fwd,
    flash_attention_plain,
)
from .fused_ce import (
    fused_linear_ce,
    fused_linear_ce_bwd,
    fused_linear_ce_bwd_plain,
    fused_linear_ce_fwd,
    fused_linear_ce_plain,
)
from .linear import linear_fused, linear_fused_plain, matmul, matmul_plain
from .quant import (
    int8_matmul,
    int8_matmul_plain,
    quantize_int8,
    quantize_int8_rows,
    w8a8_matmul,
    w8a8_matmul_plain,
)

# every wrapper whose launches chip_smoke.py counts on the main path
KERNELS = (
    int8_matmul,
    w8a8_matmul,
    flash_attention_fwd,
    flash_attention_bwd,
    fused_linear_ce_fwd,
    fused_linear_ce_bwd,
    fused_adam,
    fused_adam_sr,
    matmul,
    linear_fused,
)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


__all__ = [
    "KERNELS",
    "flash_attention",
    "flash_attention_bwd",
    "flash_attention_bwd_plain",
    "flash_attention_fwd",
    "flash_attention_plain",
    "fused_adam",
    "fused_adam_plain",
    "fused_adam_sr",
    "fused_adam_sr_plain",
    "fused_linear_ce",
    "fused_linear_ce_bwd",
    "fused_linear_ce_bwd_plain",
    "fused_linear_ce_fwd",
    "fused_linear_ce_plain",
    "int8_matmul",
    "int8_matmul_plain",
    "linear_fused",
    "linear_fused_plain",
    "matmul",
    "matmul_plain",
    "quantize_int8",
    "quantize_int8_rows",
    "reset_launch_counts",
    "stochastic_round_bf16",
    "w8a8_matmul",
    "w8a8_matmul_plain",
]
