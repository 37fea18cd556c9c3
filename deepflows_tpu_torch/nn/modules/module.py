"""nn.Module (counterpart of ``deepflows_tpu/nn/modules/module.py``).

A thin layer over ``torch.nn.Module``: registration, traversal,
``state_dict`` and ``train``/``eval`` are torch's own, and the key names
they produce are the JAX package's (``blocks.0.attn.q_proj.weight``).
Unlike the JAX package, ``eval()`` does not switch gradient recording off
globally; inference code runs under ``torch.no_grad`` or
``torch.inference_mode`` itself.
"""

from __future__ import annotations

import torch


class Module(torch.nn.Module):
    """Base class of the port's modules."""

    def to_dtype(self, dtype, cast_buffers: bool = False):
        """Cast every parameter to ``dtype`` in place, keeping each
        Parameter object (so an optimizer built before or after sees the
        same tensors).  Buffers keep their dtype unless ``cast_buffers``:
        normalisation statistics want f32.  bf16 parameters with
        ``optim.Adam(stochastic_round=True)`` are the full-bf16 weight
        training recipe."""
        with torch.no_grad():
            for p in self.parameters():
                p.data = p.data.to(dtype)
            if cast_buffers:
                for module in self.modules():
                    for name, b in module._buffers.items():
                        if b is not None:
                            module._buffers[name] = b.to(dtype)
        return self

    def bfloat16(self):
        """``to_dtype(torch.bfloat16)``: unlike torch's own ``bfloat16()``,
        floating buffers stay as they are, as in the JAX package."""
        return self.to_dtype(torch.bfloat16)
