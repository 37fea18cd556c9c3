"""LoRA, low-rank adaptation for fine-tuning (counterpart of
``deepflows_tpu/nn/lora.py``).

A :class:`LoRALinear` wraps a frozen ``nn.Linear`` with a rank-``r`` update
``x @ A @ B · (alpha / r)``: ``A`` is ``(in, r)`` and kaiming-uniform,
``B`` is ``(r, out)`` and zero, so the wrap is exactly the base at first.
:func:`apply_lora` swaps matching Linears in place, freezes the rest and
returns the adapter parameters.  ``merge_lora`` folds the update into the
base weight for serving and ``unmerge_lora`` takes it out again;
``lora_state_dict`` checkpoints the adapters alone.

The decoders read projection weights directly (``q_proj.weight`` is the
base's), so they refuse a model with an unmerged adapter
(:func:`assert_no_unmerged_lora`).  The state dict keys are the JAX
package's: ``q_proj.base.weight``, ``q_proj.lora_A``, ``q_proj.lora_B``.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from ..config import config
from . import init
from .modules.dropout import Dropout
from .modules.linear import Linear
from .modules.module import Module


class LoRALinear(Module):
    """``base(x) + dropout(x) @ A @ B · (alpha / r)`` with ``base`` frozen."""

    def __init__(self, base: Linear, r: int = 8, alpha: float = 16.0,
                 dropout: float = 0.0):
        super().__init__()
        if r < 1:
            raise ValueError("LoRA rank must be >= 1")
        self.base = base
        self.r = int(r)
        self.alpha = float(alpha)
        self.scaling = self.alpha / self.r
        kw = dict(device=base.weight.device, dtype=config.default_dtype)
        self.lora_A = torch.nn.Parameter(torch.empty((base.in_features, r), **kw))
        self.lora_B = torch.nn.Parameter(torch.zeros((r, base.out_features), **kw))
        init.kaiming_uniform_(self.lora_A, a=math.sqrt(5))
        self.lora_dropout = Dropout(dropout) if dropout > 0 else None
        self.merged = False
        self.base.requires_grad_(False)

    @property
    def in_features(self):
        return self.base.in_features

    @property
    def out_features(self):
        return self.base.out_features

    # read-only views for code that inspects a layer's weights; the forward
    # always calls the base module, so the adapter is never skipped there
    @property
    def weight(self):
        return self.base.weight

    @property
    def bias(self):
        return self.base.bias

    def forward(self, input):
        out = self.base(input)
        if self.merged:
            return out
        h = input
        if self.lora_dropout is not None:
            h = self.lora_dropout(h)
        return out + (h @ self.lora_A) @ self.lora_B * self.scaling

    def _delta(self):
        return (self.lora_A.detach() @ self.lora_B.detach()) * self.scaling

    @torch.no_grad()
    def merge(self) -> None:
        """Fold ``A @ B · scaling`` into the base weight, in its dtype."""
        if self.merged:
            return
        w = self.base.weight
        w.copy_(w + self._delta().to(w.dtype))
        self.merged = True

    @torch.no_grad()
    def unmerge(self) -> None:
        if not self.merged:
            return
        w = self.base.weight
        w.copy_(w - self._delta().to(w.dtype))
        self.merged = False

    def extra_repr(self) -> str:
        return (
            f"in_features={self.base.in_features}, "
            f"out_features={self.base.out_features}, r={self.r}, "
            f"alpha={self.alpha}, merged={self.merged}"
        )


def _set_submodule(root: Module, path: str, new: Module) -> None:
    parent = root
    *parents, name = path.split(".")
    for p in parents:
        parent = getattr(parent, p)
    setattr(parent, name, new)  # a Sequential's children are named "0", "1", ...


def apply_lora(
    model: Module,
    r: int = 8,
    alpha: float = 16.0,
    dropout: float = 0.0,
    target: Optional[Iterable[str]] = None,
    freeze_rest: bool = True,
) -> List[torch.nn.Parameter]:
    """Replace Linear submodules with :class:`LoRALinear` in place.

    ``target``: substrings of qualified module names to adapt (e.g.
    ``["q_proj", "v_proj"]``); None adapts every Linear.  With
    ``freeze_rest`` every other parameter is frozen, so the parameters
    that require a gradient (also the return value) are the adapters."""
    targets = list(target) if target is not None else None
    to_swap = []
    for name, mod in model.named_modules():
        if isinstance(mod, Linear):
            if targets is None or any(t in name for t in targets):
                if name == "":
                    raise ValueError("cannot adapt the root module in place")
                to_swap.append((name, mod))
    if not to_swap:
        raise ValueError(f"no Linear submodule matched target={targets!r}")
    if freeze_rest:
        model.requires_grad_(False)
    adapters = []
    for name, mod in to_swap:
        wrapped = LoRALinear(mod, r=r, alpha=alpha, dropout=dropout)
        _set_submodule(model, name, wrapped)
        adapters += [wrapped.lora_A, wrapped.lora_B]
    for p in adapters:
        p.requires_grad_(True)
    return adapters


def _lora_modules(model: Module):
    return [(n, m) for n, m in model.named_modules() if isinstance(m, LoRALinear)]


def lora_state_dict(model: Module) -> Dict[str, torch.Tensor]:
    """The adapters alone, as detached copies."""
    out = {}
    for name, mod in _lora_modules(model):
        out[f"{name}.lora_A"] = mod.lora_A.detach().clone()
        out[f"{name}.lora_B"] = mod.lora_B.detach().clone()
    return out


def load_lora_state_dict(model: Module, sd) -> None:
    """Copy adapters (tensors, or numpy arrays from the JAX package's
    ``lora_state_dict``) into ``model``, each cast to its parameter's
    dtype.  Raises on a missing, unmatched or misshapen entry."""
    found = set()
    with torch.no_grad():
        for name, mod in _lora_modules(model):
            for slot in ("lora_A", "lora_B"):
                key = f"{name}.{slot}"
                if key not in sd:
                    raise KeyError(f"missing adapter entry {key!r}")
                p = getattr(mod, slot)
                src = sd[key]
                if not isinstance(src, torch.Tensor):
                    from ..utils.convert import _from_numpy

                    src = _from_numpy(key, np.asarray(src))
                if tuple(src.shape) != tuple(p.shape):
                    raise ValueError(f"{key}: shape {tuple(src.shape)} != {tuple(p.shape)}")
                p.copy_(src)
                found.add(key)
    extra = set(sd) - found
    if extra:
        raise KeyError(f"unmatched adapter entries: {sorted(extra)}")


def assert_no_unmerged_lora(model: Module, context: str) -> None:
    """Raise if ``model`` holds an unmerged adapter: code that reads the
    projection weights directly (the KV-cache decoders) would drop it."""
    for name, mod in _lora_modules(model):
        if not mod.merged:
            raise RuntimeError(
                f"{context} gathers base weights directly and would skip "
                f"the unmerged LoRA adapter at {name!r} — call "
                "nn.merge_lora(model) first (nn.unmerge_lora restores "
                "the trainable form)"
            )


def merge_lora(model: Module) -> Module:
    for _, mod in _lora_modules(model):
        mod.merge()
    return model


def unmerge_lora(model: Module) -> Module:
    for _, mod in _lora_modules(model):
        mod.unmerge()
    return model
