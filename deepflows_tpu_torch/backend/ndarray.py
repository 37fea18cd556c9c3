"""BackendTensor, the NDArray layer (counterpart of
``deepflows_tpu/backend/ndarray.py``), over one ``torch.Tensor``.

It keeps the JAX package's surface: ``numpy()`` from any device, ``to``,
``astype``, ``fill``, the views (``reshape``, ``permute``, ``transpose``,
``broadcast_to``, ``flip``, ``pad``), indexing, the arithmetic,
comparisons that return 0/1 floats, ``maximum`` / ``minimum``, the unary
math, ``argmax`` / ``argmin`` and the reductions, with ``mean`` dividing by
the size of the axes it reduces.  ``a @ b`` takes the eager kernel route of
``torch_kernels.matmul``.

Unlike the JAX package's immutable arrays, the tensor is torch's: the
views share its storage, and ``fill``, ``__setitem__`` and the in-place
operators write it (a ``BackendTensor`` that a tape ``Tensor``'s ``.data``
returns writes that ``Tensor``).  ``shape`` is a ``torch.Size``, ``dtype``
a ``torch.dtype`` and ``strides`` the tensor's element strides.  A tensor
marked ``_frozen`` refuses in-place writes, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from . import torch_kernels as K
from .device import BackendDevice, Device, default_device


class BackendTensor:
    __slots__ = ("array", "device", "_frozen")

    def __init__(self, other, device: BackendDevice | None = None, dtype=None):
        if isinstance(other, BackendTensor):
            device = Device(device) if device is not None else other.device
            arr = other.array
            if device is not other.device:
                arr = arr.to(device.torch_device)
            if dtype is not None:
                arr = arr.to(K.torch_dtype(dtype))
            self.array, self.device = arr, device
            return
        device = default_device() if device is None else Device(device)
        if isinstance(other, torch.Tensor):
            arr = K.plain(other).to(device.torch_device)
            if dtype is not None:
                arr = arr.to(K.torch_dtype(dtype))
        elif isinstance(other, (bool, int, float, np.number)):
            arr = K.fill((), other, dtype=dtype, device=device.torch_device)
        else:
            arr = K.from_numpy(other, device=device.torch_device, dtype=dtype)
        self.array, self.device = arr, device

    @classmethod
    def _wrap(cls, array, device) -> "BackendTensor":
        """Adopt a plain torch tensor with no conversion."""
        t = object.__new__(cls)
        t.array = array
        t.device = device
        return t

    def _new(self, array) -> "BackendTensor":
        return BackendTensor._wrap(array, self.device)

    # ------------------------------------------------------------ properties
    @property
    def shape(self):
        return self.array.shape

    @property
    def ndim(self):
        return self.array.dim()

    @property
    def size(self):
        return self.array.numel()

    @property
    def dtype(self):
        return self.array.dtype

    @property
    def strides(self):
        return tuple(self.array.stride())

    @property
    def flat(self):
        return self.reshape((self.size,))

    @property
    def T(self):
        return self.permute(tuple(reversed(range(self.ndim))))

    def __len__(self):
        return self.shape[0]

    def __repr__(self):
        return f"BackendTensor({self.numpy()!r}, device={self.device})"

    # ------------------------------------------------------------ transfers
    def numpy(self) -> np.ndarray:
        return K.to_numpy(self.array)

    def __array__(self, dtype=None, copy=None):
        arr = self.numpy()
        return arr.astype(dtype) if dtype is not None else arr

    def item(self):
        return self.array.item()

    def to(self, device) -> "BackendTensor":
        device = Device(device)
        if device is self.device:
            return self
        return BackendTensor(self, device=device)

    def astype(self, dtype) -> "BackendTensor":
        return self._new(K.astype(self.array, dtype))

    def _check_mutable(self):
        if getattr(self, "_frozen", False):
            raise RuntimeError("in-place mutation of a frozen BackendTensor; operate on a copy")

    def fill(self, value) -> "BackendTensor":
        self._check_mutable()
        self.array.fill_(value)
        return self

    # ------------------------------------------------------------ views
    def compact(self) -> "BackendTensor":
        return self if self.array.is_contiguous() else self._new(self.array.contiguous())

    def is_compact(self) -> bool:
        return self.array.is_contiguous()

    def reshape(self, new_shape) -> "BackendTensor":
        return self._new(self.array.reshape(tuple(new_shape)))

    def permute(self, new_axes) -> "BackendTensor":
        return self._new(self.array.permute(tuple(new_axes)))

    def transpose(self, axes=None) -> "BackendTensor":
        if axes is None:
            return self.T
        return self.permute(axes)

    def broadcast_to(self, new_shape) -> "BackendTensor":
        return self._new(self.array.expand(tuple(new_shape)))

    def flip(self, axes=None) -> "BackendTensor":
        if axes is None:
            axes = tuple(range(self.ndim))
        elif isinstance(axes, int):
            axes = (axes,)
        return self._new(torch.flip(self.array, tuple(axes)))

    def pad(self, axes) -> "BackendTensor":
        """Zero-pad; ``axes`` is ((before, after), ...) per dim."""
        flat = [int(v) for before_after in reversed(tuple(axes)) for v in before_after]
        return self._new(torch.nn.functional.pad(self.array, flat))

    @staticmethod
    def _key(idx):
        if isinstance(idx, BackendTensor):
            return idx.array
        if isinstance(idx, tuple):
            return tuple(i.array if isinstance(i, BackendTensor) else i for i in idx)
        return idx

    def __getitem__(self, idx) -> "BackendTensor":
        return self._new(self.array[self._key(idx)])

    def __setitem__(self, idx, value):
        self._check_mutable()
        self.array[self._key(idx)] = self._other(value)

    # ------------------------------------------------------------ arithmetic
    @staticmethod
    def _other(other):
        return other.array if isinstance(other, BackendTensor) else other

    def __add__(self, other):
        return self._new(self.array + self._other(other))

    __radd__ = __add__

    def __sub__(self, other):
        return self._new(self.array - self._other(other))

    def __rsub__(self, other):
        return self._new(self._other(other) - self.array)

    def __mul__(self, other):
        return self._new(self.array * self._other(other))

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._new(self.array / self._other(other))

    def __rtruediv__(self, other):
        return self._new(self._other(other) / self.array)

    def __pow__(self, other):
        return self._new(self.array ** self._other(other))

    def __rpow__(self, other):
        return self._new(self._other(other) ** self.array)

    def __neg__(self):
        return self._new(-self.array)

    def __iadd__(self, other):
        self._check_mutable()
        self.array += self._other(other)
        return self

    def __isub__(self, other):
        self._check_mutable()
        self.array -= self._other(other)
        return self

    def __imul__(self, other):
        self._check_mutable()
        self.array *= self._other(other)
        return self

    def __itruediv__(self, other):
        self._check_mutable()
        self.array /= self._other(other)
        return self

    def __matmul__(self, other):
        return self._new(K.matmul(self.array, self._other(other)))

    # comparisons return 0/1 in the default float dtype, as in the JAX package
    def _cmp(self, other, op):
        from ..config import config

        return self._new(op(self.array, self._other(other)).to(config.default_dtype))

    def __eq__(self, other):
        return self._cmp(other, torch.eq)

    def __ne__(self, other):
        return self._cmp(other, torch.ne)

    def __ge__(self, other):
        return self._cmp(other, torch.ge)

    def __le__(self, other):
        return self._cmp(other, torch.le)

    def __gt__(self, other):
        return self._cmp(other, torch.gt)

    def __lt__(self, other):
        return self._cmp(other, torch.lt)

    __hash__ = None  # a mutable value container

    # ------------------------------------------------------------ math
    def _tensor(self, other):
        other = self._other(other)
        if isinstance(other, torch.Tensor):
            return other
        return torch.tensor(other, dtype=self.dtype, device=self.array.device)

    def maximum(self, other):
        return self._new(torch.maximum(self.array, self._tensor(other)))

    def minimum(self, other):
        return self._new(torch.minimum(self.array, self._tensor(other)))

    def log(self):
        return self._new(torch.log(self.array))

    def exp(self):
        return self._new(torch.exp(self.array))

    def tanh(self):
        return self._new(torch.tanh(self.array))

    def sqrt(self):
        return self._new(torch.sqrt(self.array))

    def abs(self):
        return self._new(torch.abs(self.array))

    def sign(self):
        return self._new(torch.sign(self.array))

    def argmax(self, axis=None):
        return self._new(torch.argmax(self.array, dim=axis))

    def argmin(self, axis=None):
        return self._new(torch.argmin(self.array, dim=axis))

    # ------------------------------------------------------------ reductions
    def sum(self, axis=None, keepdims=False):
        return self._new(K.reduce_sum(self.array, axis=axis, keepdims=keepdims))

    def max(self, axis=None, keepdims=False):
        return self._new(K.reduce_max(self.array, axis=axis, keepdims=keepdims))

    def min(self, axis=None, keepdims=False):
        return self._new(torch.amin(self.array, dim=() if axis is None else axis,
                                    keepdim=keepdims))

    def mean(self, axis=None, keepdims=False):
        """The mean over ``axis``, dividing by the size of the axes it
        reduces (the reference divided by the whole size)."""
        if axis is None and not keepdims:
            return self._new(torch.mean(self.array))
        return self._new(torch.mean(self.array, dim=axis, keepdim=keepdims))


# ---------------------------------------------------------------- backend_api
def Btensor(obj, device=None, dtype=None) -> BackendTensor:
    return BackendTensor(obj, device=device, dtype=dtype)


def from_numpy(a, device=None) -> BackendTensor:
    return BackendTensor(a, device=device)


def empty(shape, device=None, dtype=None) -> BackendTensor:
    return Device(device).empty(shape, dtype=dtype)


def full(shape, fill_value, device=None, dtype=None) -> BackendTensor:
    return Device(device).full(shape, fill_value, dtype=dtype)


def zeros(shape, device=None, dtype=None) -> BackendTensor:
    return full(shape, 0.0, device=device, dtype=dtype)


def ones(shape, device=None, dtype=None) -> BackendTensor:
    return full(shape, 1.0, device=device, dtype=dtype)


def zeros_like(t: BackendTensor) -> BackendTensor:
    return full(t.shape, 0.0, device=t.device, dtype=t.dtype)


def ones_like(t: BackendTensor) -> BackendTensor:
    return full(t.shape, 1.0, device=t.device, dtype=t.dtype)


def broadcast_to(t: BackendTensor, new_shape) -> BackendTensor:
    return t.broadcast_to(new_shape)


def reshape(t: BackendTensor, new_shape) -> BackendTensor:
    return t.reshape(new_shape)


def maximum(a, b) -> BackendTensor:
    if isinstance(a, BackendTensor):
        return a.maximum(b)
    return b.maximum(a)


def max(t: BackendTensor, axis=None, keepdims=False) -> BackendTensor:  # noqa: A001
    return t.max(axis=axis, keepdims=keepdims)


def log(t: BackendTensor) -> BackendTensor:
    return t.log()


def exp(t: BackendTensor) -> BackendTensor:
    return t.exp()


def tanh(t: BackendTensor) -> BackendTensor:
    return t.tanh()


def flip(t: BackendTensor, axes=None) -> BackendTensor:
    return t.flip(axes)


def summation(t: BackendTensor, axis=None, keepdims=False) -> BackendTensor:
    return t.sum(axis=axis, keepdims=keepdims)


def mean(t: BackendTensor, axis=None, keepdims=False) -> BackendTensor:
    return t.mean(axis=axis, keepdims=keepdims)


def pad(t: BackendTensor, axes) -> BackendTensor:
    return t.pad(axes)


def expand_dims(t: BackendTensor, axis) -> BackendTensor:
    return t._new(t.array.unsqueeze(axis))
