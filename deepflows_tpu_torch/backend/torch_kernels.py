"""The device kernel protocol over torch (counterpart of
``deepflows_tpu/backend/jax_kernels.py``).

``BackendTensor`` and the tape call these functions on plain
``torch.Tensor``s.  One module serves both devices: the functions that make
a tensor take the ``device`` (a ``torch.device``) they make it on, which
``BackendDevice`` binds.  The JAX package's ``numpy_kernels.py`` is its
CPU test double; here the ``cpu`` device is torch on the CPU under this
same module, so it has no counterpart of its own.

``matmul`` is the eager f32 kernel route: with ``config.use_pallas`` on,
a product of two 2-D f32 operands that ``ops.matmul`` supports runs on it
(the hand-written kernel for CUDA tensors, its plain twin for CPU
tensors), as ``jax_kernels.matmul`` sends such products to the Pallas
kernel; every other product is ``torch.matmul``.

The protocol's convolution, batch-norm, softmax cross-entropy and pooling
entries (``jax_kernels.py:181-418``) are not repeated here: their
counterparts are the port's ``nn.functional`` (cuDNN and PyTorch's own
kernels), which the tape reaches through torch's ops.

Random draws come from the package generators (``random.generator``),
never from torch's global one; ``seed=`` draws from a generator of its own
seeded with it.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import random as _random
from ..config import config

_NP_TO_TORCH = {
    np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16, np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8, np.dtype(np.int16): torch.int16,
    np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
    np.dtype(np.bool_): torch.bool,
}


def torch_dtype(dtype):
    """A ``torch.dtype`` from a torch dtype, a numpy dtype or type, or a
    name (``"bfloat16"`` too); None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if str(dtype) == "bfloat16" or getattr(dtype, "__name__", "") == "bfloat16":
        return torch.bfloat16
    return _NP_TO_TORCH[np.dtype(dtype)]


# ---------------------------------------------------------------- transfers
def plain(t):
    """``t`` detached, as a plain ``torch.Tensor`` (a tape ``Tensor`` too),
    sharing its storage."""
    if type(t) is torch.Tensor and not t.requires_grad:
        return t
    with torch._C.DisableTorchFunctionSubclass():
        out = t.detach()
    if type(out) is not torch.Tensor and not getattr(out, "_lazy", False):
        out = torch.Tensor._make_subclass(torch.Tensor, out)
    return out


def coerce_numpy(a: np.ndarray, dtype=None) -> np.ndarray:
    """The JAX package's dtype rule for host arrays: float64 becomes the
    default float, int64 becomes int32, unless ``dtype`` is given."""
    if dtype is not None:
        return a
    if a.dtype == np.float64:
        return a.astype(np.float32, copy=False)
    if a.dtype == np.int64:
        return a.astype(np.int32, copy=False)
    return a


def from_numpy(a, device=None, dtype=None):
    """A copy of host array ``a`` on ``device``."""
    a = coerce_numpy(np.asarray(a), dtype)
    dt = torch_dtype(dtype)
    if a.dtype.kind not in "biuf" or str(a.dtype) == "bfloat16":
        a = a.astype(np.float32)  # e.g. a JAX bf16 host array
    t = torch.tensor(a, device=device)
    return t if dt is None else t.to(dt)


def to_numpy(a) -> np.ndarray:
    """A host copy; bf16 widens to f32 (numpy has no bf16).  A readback:
    under lazy mode the pending work runs first."""
    from . import lazy

    if lazy.recording():
        lazy.flush()
    a = plain(a)
    if a.dtype == torch.bfloat16:
        a = a.float()
    return a.cpu().numpy()


# ---------------------------------------------------------------- basics
def fill(shape, value, dtype=None, device=None):
    return torch.full(tuple(shape), value, dtype=torch_dtype(dtype) or config.default_dtype,
                      device=device)


def setitem(arr, idx, value):
    """A copy of ``arr`` with ``arr[idx] = value``; ``arr`` is unchanged."""
    out = arr.clone()
    out[idx] = value
    return out


def astype(arr, dtype):
    return arr.to(torch_dtype(dtype))


def scatter_add(shape, idx, values, dtype=None, device=None):
    """zeros(shape) with ``values`` added at ``idx`` (the slice gradient):
    any key torch indexes with (ints, slices, arrays with repeats), each
    element it selects receiving its value, repeats summed by
    ``index_put_(accumulate=True)`` over the flat positions."""
    device = values.device if device is None else device
    n = int(np.prod(shape)) if len(shape) else 1
    pos = torch.arange(n, device=device).reshape(tuple(shape))[idx]
    out = torch.zeros(n, dtype=torch_dtype(dtype) or values.dtype, device=device)
    vals = torch.as_tensor(values, device=device).to(out.dtype).expand(pos.shape)
    out.index_put_((pos.reshape(-1),), vals.reshape(-1), accumulate=True)
    return out.reshape(tuple(shape))


def matmul_routed(a, b) -> bool:
    """Whether ``a @ b`` takes ``ops.matmul``: ``config.use_pallas`` on,
    both operands 2-D f32 and a pair the kernel takes (inner sizes equal,
    no empty operand, one device)."""
    return (
        config.use_pallas
        and a.dim() == 2
        and b.dim() == 2
        and a.dtype == torch.float32
        and b.dtype == torch.float32
        and a.shape[1] == b.shape[0]
        and a.numel() > 0
        and b.numel() > 0
        and a.device == b.device
    )


def matmul(a, b):
    if matmul_routed(a, b):
        from ..ops.linear import matmul as kernel

        return kernel(a, b)
    return torch.matmul(a, b)


def _dims(axis):
    return () if axis is None else axis


def reduce_sum(a, axis=None, keepdims=False):
    return torch.sum(a, dim=axis, keepdim=keepdims) if axis is not None or keepdims \
        else torch.sum(a)


def reduce_max(a, axis=None, keepdims=False):
    return torch.amax(a, dim=_dims(axis), keepdim=keepdims)


# ---------------------------------------------------------------- RNG
def manual_seed(seed: int, device=None) -> None:
    """Reseed the package generator of ``device``."""
    _random.generator(device).manual_seed(int(seed))


def _generator(seed, device):
    if seed is None:
        return _random.generator(device)
    return torch.Generator(device=device).manual_seed(int(seed))


def randn(shape, dtype=None, seed=None, device=None):
    return torch.randn(tuple(shape), generator=_generator(seed, device), device=device,
                       dtype=torch_dtype(dtype) or config.default_dtype)


def rand(shape, dtype=None, seed=None, device=None):
    return torch.rand(tuple(shape), generator=_generator(seed, device), device=device,
                      dtype=torch_dtype(dtype) or config.default_dtype)


def uniform(low, high, shape, dtype=None, seed=None, device=None):
    u = rand(shape, dtype=dtype, seed=seed, device=device)
    return u * (high - low) + low


def randint(low, high, shape, seed=None, device=None):
    return torch.randint(low, high, tuple(shape), generator=_generator(seed, device),
                         device=device, dtype=torch.int32)


def dropout_mask(shape, keep_prob, dtype=None, device=None):
    """Inverted-dropout mask: 1 / keep_prob where kept, else 0."""
    dt = torch_dtype(dtype) or config.default_dtype
    keep = torch.empty(tuple(shape), dtype=dt, device=device).bernoulli_(
        keep_prob, generator=_random.generator(device))
    return keep / keep_prob


def one_hot(indices, num_classes, dtype=None, device=None):
    idx = torch.as_tensor(np.asarray(indices) if not isinstance(indices, torch.Tensor)
                          else indices, device=device)
    out = torch.nn.functional.one_hot(idx.long(), num_classes)
    return out.to(torch_dtype(dtype) or config.default_dtype)
