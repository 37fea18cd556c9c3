"""Weights and optimizer state across from the JAX package.

``load_jax_state_dict(module, state)`` takes the JAX package's
``module.state_dict()`` — a dict of numpy arrays keyed like
``blocks.0.attn.q_proj.weight`` and ``pos_embed``, the Llama and Mixtral
families' 3-D ``experts_*`` stacks and router biases among them — and
copies it into the port's module, on the module's device.  The two packages share parameter
names and layouts, so no key or array is renamed or transposed.  It is
strict: a missing or unexpected key, a shape or a dtype that differs
raises.  Parity tests rest on this copy, never on the two RNGs agreeing.

``load_jax_state_dict`` carries buffers as well as parameters: BatchNorm's
running statistics, and the NF-ResNet convs' ``gain`` with the weights.

``load_jax_optimizer_state(optimizer, state)`` takes a JAX optimizer's
state as numpy arrays (the ``"state"`` entry of its ``state_dict()``):
Adam's or AdamW's ``{"v": [...], "s": [...], "t": steps taken}``, SGD's
``{"v": [...]}`` (``{"v": None}`` without momentum), Muon's ``{"m", "v",
"t"}`` with None in ``v`` for each Muon parameter, Adafactor's factored
``{"row", "col", "var", "t"}`` with None where a slot does not apply, and
the other optimizers' lists, and installs it in the port's optimizer of
the same kind, so a run trained in JAX resumes in the port.  The slots are
positional, in the order of the optimizer's parameters, which is the order
of ``parameters()`` in both packages.  ``optim.ModelEMA.load_state_dict``
takes the JAX ``ModelEMA.state_dict()`` as it is.
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
    """Install a JAX optimizer's state in ``optimizer``, whose own state
    gives the layout: each slot's shape and dtype (a factored Adafactor
    slot's ``(rows, 1)`` or ``(1, cols)`` too) and device come from the
    port's slot, a None entry stays None, a step count becomes its int32
    tensor.  Raises on a key, a slot count, a None or a shape that
    differs."""
    optimizer._ensure_state()
    own = optimizer._state
    if set(own) != set(state):
        raise KeyError(f"optimizer state keys differ: {sorted(state)} vs {sorted(own)}")
    new = {}
    for key, slot in own.items():
        src = state[key]
        if slot is None or src is None:
            if (slot is None) != (src is None):
                raise ValueError(f"state[{key!r}] is {src!r} where the optimizer has {slot!r}")
            new[key] = None
        elif isinstance(slot, list):
            if len(src) != len(slot):
                raise ValueError(
                    f"state[{key!r}] has {len(src)} slots for {len(slot)} parameters"
                )
            new[key] = [_slot(f"state[{key!r}][{i}]", arr, mine)
                        for i, (arr, mine) in enumerate(zip(src, slot))]
        else:
            new[key] = torch.tensor(int(np.asarray(src)), dtype=slot.dtype, device=slot.device)
    optimizer._state = new
    return optimizer


def _slot(name, arr, mine):
    if mine is None or arr is None:
        if (mine is None) != (arr is None):
            raise ValueError(f"{name} is {'None' if arr is None else 'set'} where the "
                             f"optimizer's is {'None' if mine is None else 'set'}")
        return None
    arr = np.asarray(arr, dtype=np.float32)
    if tuple(arr.shape) != tuple(mine.shape):
        raise ValueError(f"{name} has shape {arr.shape}, the optimizer's {tuple(mine.shape)}")
    return torch.from_numpy(np.array(arr)).to(mine.device, mine.dtype)
