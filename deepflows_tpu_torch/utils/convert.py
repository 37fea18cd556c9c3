"""Weights and optimizer state across from the JAX package.

``load_jax_state_dict(module, state)`` takes the JAX package's
``module.state_dict()`` — a dict of numpy arrays keyed like
``blocks.0.attn.q_proj.weight`` and ``pos_embed``, the Llama and Mixtral
families' 3-D ``experts_*`` stacks and router biases among them — and
copies it into the port's module, on the module's device.  The two packages share parameter
names and layouts, so no key or array is renamed or transposed.  It is
strict: a missing or unexpected key, a shape or a dtype that differs
raises.  Parity tests rest on this copy, never on the two RNGs agreeing.

``load_jax_optimizer_state(optimizer, state)`` takes the JAX Adam's state,
``{"v": [...], "s": [...], "t": steps taken}`` as numpy arrays (the
``"state"`` entry of its ``state_dict()``), and installs it in the port's
optimizer, so a run trained in JAX resumes in the port.  The slots are
positional, in the order of the optimizer's parameters, which is the
order of ``parameters()`` in both packages.
"""

from __future__ import annotations

import numpy as np
import torch


def _from_numpy(name, arr) -> torch.Tensor:
    """A torch copy of ``arr``.  numpy has no bfloat16 of its own: a JAX bf16
    array arrives with the ``ml_dtypes`` extension dtype, which
    ``torch.from_numpy`` refuses, so its bits cross as int16 and are seen as
    bfloat16 again (the dtype is recognised by name: the port does not
    import ``ml_dtypes``)."""
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    try:
        return torch.from_numpy(np.array(arr))
    except TypeError as e:
        raise TypeError(f"{name}: unsupported dtype {arr.dtype}") from e


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
            src = _from_numpy(name, arr)
            if src.dtype != target.dtype:
                raise TypeError(
                    f"dtype mismatch for {name}: checkpoint {src.dtype} vs "
                    f"model {target.dtype}"
                )
            target.copy_(src)
    return module


def load_jax_optimizer_state(optimizer, state):
    """Install the JAX Adam's ``{"v", "s", "t"}`` in ``optimizer``: moments
    as f32 tensors on each parameter's device, ``t`` as the int32 count of
    steps taken.  Raises on a slot count or a shape that differs."""
    params = optimizer.params
    for key in ("v", "s"):
        if len(state[key]) != len(params):
            raise ValueError(
                f"state[{key!r}] has {len(state[key])} slots for {len(params)} parameters"
            )
    new = {"v": [], "s": []}
    for key in ("v", "s"):
        for i, (arr, p) in enumerate(zip(state[key], params)):
            arr = np.asarray(arr, dtype=np.float32)
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(
                    f"state[{key!r}][{i}] has shape {arr.shape}, parameter {tuple(p.shape)}"
                )
            new[key].append(torch.from_numpy(np.array(arr)).to(p.device))
    dev = params[0].device if params else torch.device("cpu")
    new["t"] = torch.tensor(int(np.asarray(state["t"])), dtype=torch.int32, device=dev)
    optimizer._state = new
    return optimizer
