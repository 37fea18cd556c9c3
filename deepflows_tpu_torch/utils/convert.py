"""Weights across from the JAX package.

``load_jax_state_dict(module, state)`` takes the JAX package's
``module.state_dict()`` — a dict of numpy arrays keyed like
``blocks.0.attn.q_proj.weight`` and ``pos_embed`` — and copies it into the
port's module, on the module's device.  The two packages share parameter
names and layouts, so no key or array is renamed or transposed.  It is
strict: a missing or unexpected key, a shape or a dtype that differs
raises.  Parity tests rest on this copy, never on the two RNGs agreeing.
"""

from __future__ import annotations

import numpy as np
import torch


def load_jax_state_dict(module: torch.nn.Module, state) -> torch.nn.Module:
    own = module.state_dict(keep_vars=True)
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise KeyError(
            f"state_dict keys differ: missing={missing}, unexpected={unexpected}"
        )
    with torch.no_grad():
        for name, target in own.items():
            arr = np.asarray(state[name])
            if tuple(arr.shape) != tuple(target.shape):
                raise ValueError(
                    f"size mismatch for {name}: checkpoint {arr.shape} vs "
                    f"model {tuple(target.shape)}"
                )
            try:
                src = torch.from_numpy(np.array(arr))
            except TypeError as e:
                raise TypeError(f"{name}: unsupported dtype {arr.dtype}") from e
            if src.dtype != target.dtype:
                raise TypeError(
                    f"dtype mismatch for {name}: checkpoint {src.dtype} vs "
                    f"model {target.dtype}"
                )
            target.copy_(src)
    return module
