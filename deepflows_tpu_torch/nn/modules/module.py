"""nn.Module (counterpart of ``deepflows_tpu/nn/modules/module.py``).

A thin layer over ``torch.nn.Module``: registration, traversal,
``state_dict`` and ``train``/``eval`` are torch's own, and the key names
they produce are the JAX package's (``blocks.0.attn.q_proj.weight``).
As in the JAX package, ``train(mode)`` and ``eval()`` also set the tape's
grad flag (``autograd.set_grad_enabled(mode)``): the reference's scripts
call ``model.eval()`` to stop recording for their eval loops and
``model.train()`` to record again.  The flag is the tape's alone: a
forward on plain ``torch.Tensor``s after ``eval()`` still builds torch's
autograd graph, so the port's own inference code runs under
``torch.no_grad`` or ``torch.inference_mode`` itself.  The port's own code
that switches a model's mode for its own ends (``fuse_conv_bn``,
``CompiledTrainStep``, ``CompiledEvalStep``, ``evaluate_accuracy``, the
sharded and pipelined steps) leaves the flag as it found it
(``autograd.flag_kept``).
"""

from __future__ import annotations

import torch

from ... import autograd as _tape_grad


class Module(torch.nn.Module):
    """Base class of the port's modules."""

    def register_buffer(self, name, tensor, persistent=True):
        """torch's; a buffer made under lazy mode holds its values
        (``backend/lazy.py``), as a ``Parameter`` does."""
        from ...backend import lazy

        super().register_buffer(name, lazy.force(tensor), persistent)

    def train(self, mode: bool = True):
        """Set train or eval mode recursively, and the tape's grad flag to
        ``mode``."""
        super().train(mode)
        _tape_grad.set_grad_enabled(mode)
        return self

    def state_dict(self, *args, **kwargs):
        """torch's, after the pending work under lazy mode (a readback)."""
        from ...backend import lazy

        if lazy.recording():
            lazy.flush()
        return super().state_dict(*args, **kwargs)

    def load_weights(self, weights):
        """Non-strict load of ``{name: array}`` (the JAX package's
        ``load_weights``): names the module lacks and arrays of another
        shape are skipped.  Returns (missing, unexpected)."""
        from ...utils.convert import load_arrays

        return load_arrays(self, weights, strict=False)

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
