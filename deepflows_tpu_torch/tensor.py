"""The define-by-run tape (counterpart of ``deepflows_tpu/tensor.py``):
``Tensor``, ``Graph``, the op classes and the factories.

The contract is the JAX package's: a ``Tensor`` made with
``requires_grad=True`` while the grad flag is on joins the global
``Graph``, every op on Tensors returns a Tensor that joins it too when it
needs a gradient, ``loss.backward()`` walks back from the loss and then
frees the graph's non-leaves (``Graph.free_graph()`` keeps the leaves),
and ``with no_grad():`` or ``Module.eval()`` stop recording.

Design: ``Tensor`` is a ``torch.Tensor`` subclass with
``__torch_function__``, and the reverse walk is torch's autograd.  So the
port's ``nn`` modules, optimizers and ``CompiledTrainStep`` take a Tensor
as it is, with no second nn library: ``model(Tensor(x, device="cuda"))``
runs the model's own torch ops, each of which comes back through
``__torch_function__``, which runs it (under ``torch.no_grad()`` while the
tape's flag is off), makes its fresh result a Tensor (by setting its
class: no alias, no extra autograd node, no arithmetic) and appends it to
``Graph`` when it needs a gradient.  The parameters stay the port's
``nn.Parameter``s, plain to torch, so a Tensor input is where the tape
starts; ``backward()`` runs ``torch.autograd.backward`` with
``__torch_function__`` off (torch carries that state into its backward
threads), so gradients and everything an autograd ``Function``'s backward
makes are plain tensors.  A Tensor leaf's ``.grad`` reads as a
``BackendTensor`` and ``.data`` as one that writes the Tensor, as in the
JAX package; the parameters' ``.grad`` stay torch's.

The host cost: one Python ``__torch_function__`` call per torch op and
per attribute read (``.shape``, ``.dim()``) on a Tensor, a class
assignment for each result and a ``Graph`` append for each that needs a
gradient.  On the H100's host that made a small op 15.35 µs against 8.49
plain, and a 37-call MLP step 0.65 ms slower (NVIDIA H100 80GB HBM3,
700.00 W; ``chip_smoke.py`` phase 43, PERF.md).

Ops whose gradient the JAX package defines otherwise than torch use
``torch.autograd.Function``s: the product on the eager kernel route
(``config.use_pallas``, both operands 2-D f32) runs ``ops.matmul`` forward
and both backward products through ``ops.matmul`` too.  ``max`` / ``min``
are ``torch.amax`` / ``amin``, whose gradient already splits evenly among
ties as the JAX tape's does; ``maximum`` / ``minimum`` are torch's, whose
gradient halves at a tie, which is the JAX tape's even split between two.

Where the JAX and torch surfaces collide, a Tensor keeps the JAX meaning
when called the JAX way and torch's otherwise, so the port's own code
works on it: ``max(axis, keepdims)`` gives values, ``max(dim=...)`` torch's
(values, indices); ``transpose(*axes)`` permutes by all the axes or
reverses them with none, and swaps two with two (torch's, which is the
same on a matrix); ``to(device)`` with a device alone makes a new leaf
that keeps ``requires_grad`` (the JAX package's), any other call is
torch's ``to``.  ``<``, ``<=``, ``>``, ``>=``, ``eq()`` and ``ne()`` return
0/1 in the default float dtype without a gradient; ``==`` and ``!=`` stay
torch's elementwise comparisons (the JAX Tensor compares identity there).
``size`` stays torch's method (``numel()`` is the element count),
``dtype`` is a ``torch.dtype`` and ``device`` a ``torch.device`` (equal
to the registry's ``Device`` of it).  ``Function.apply`` is not seen by
``__torch_function__``: the port's Functions go through
``function_apply``, which runs them with ``__torch_function__`` off and
tapes their outputs.  Where ``__torch_function__`` is off (inside those
Functions and in the backward walk) every method is torch's.
"""

from __future__ import annotations

import copy as _copy

import numpy as np
import torch

from . import autograd as _autograd
from . import backend as backend_api
from .autograd import no_grad
from .backend import BackendTensor, Device, default_device
from .backend import lazy as _lazy
from .backend import torch_kernels as K
from .config import config

__all__ = [
    "Graph",
    "Tensor",
    "UnaryOperator",
    "BinaryOperator",
    "add",
    "sub",
    "mul",
    "div",
    "pow",
    "matmul",
    "abs",
    "sum",
    "mean",
    "max",
    "min",
    "exp",
    "log",
    "maximum",
    "minimum",
    "sqrt",
    "square",
    "Reshape",
    "transpose",
    "concat",
    "get_slice",
    "empty",
    "zeros",
    "ones",
    "zeros_like",
    "ones_like",
    "randn",
    "rand",
    "uniform",
    "arange",
]

_Disable = torch._C.DisableTorchFunctionSubclass
_taping = torch._C._is_torch_function_enabled  # False inside a Function and in backward
_NOWRAP = torch.overrides.get_default_nowrap_functions()
_Base = torch._C.TensorBase


class Graph:
    """The global tape: every Tensor that needs a gradient, in the order
    made."""

    node_list: list = []

    @classmethod
    def add(cls, node):
        cls.node_list.append(node)

    @classmethod
    def clear(cls):
        cls.node_list.clear()

    @classmethod
    def free_graph(cls):
        """Drop the non-leaves, keep the leaves (weights, inputs)."""
        with _Disable():
            cls.node_list = [n for n in cls.node_list if n.requires_grad and n.grad_fn is None]

    @classmethod
    def free_graph_all(cls):
        cls.node_list = []


def _is_arg(ret, args, kwargs) -> bool:
    for a in args:
        if a is ret or (isinstance(a, (list, tuple)) and any(e is ret for e in a)):
            return True
    return any(v is ret for v in kwargs.values())


def _tape(ret, args, kwargs):
    """An op's result as Tensors: a fresh plain tensor becomes a Tensor in
    place and joins ``Graph`` if it needs a gradient; an argument handed
    back (an in-place op's) stays what it was."""
    if type(ret) is torch.Tensor:
        if _is_arg(ret, args, kwargs):
            return ret
        rg = ret.requires_grad
        ret.__class__ = Tensor
        if rg and _autograd._grad_enabled:
            Graph.node_list.append(ret)
        return ret
    if isinstance(ret, (tuple, list)) and any(type(r) is torch.Tensor for r in ret):
        out = [_tape(r, args, kwargs) for r in ret]
        if isinstance(ret, list):
            return out
        return tuple(out) if type(ret) is tuple else type(ret)(out)
    return ret


def function_apply(fn, *args):
    """``fn.apply(*args)`` for a ``torch.autograd.Function``, which
    ``__torch_function__`` does not see.  With a Tensor among the
    arguments, the Function runs with ``__torch_function__`` off (its
    forward and backward see plain torch), under ``torch.no_grad()`` while
    the grad flag is off, and its outputs join the tape as any op's do;
    otherwise it is ``fn.apply(*args)``.  Under lazy mode the call is one
    recorded node (``backend/lazy.py``)."""
    if _lazy.recording() and any(isinstance(a, torch.Tensor) for a in args):
        return _lazy.record_function(fn, args)
    if not _taping() or not any(isinstance(a, Tensor) for a in args):
        return fn.apply(*args)
    with _Disable():
        if _autograd._grad_enabled:
            out = fn.apply(*args)
        else:
            with torch.no_grad():
                out = fn.apply(*args)
    return _tape(out, args, {})


def _leaf_data(array, dtype, device):
    """The plain tensor a new Tensor holds (sharing a Tensor's or
    BackendTensor's storage where device and dtype allow)."""
    dt = K.torch_dtype(dtype)
    if isinstance(array, BackendTensor):
        dev = array.device if device is None else Device(device)
        out = array.array.to(dev.torch_device)
        return out if dt is None else out.to(dt)
    if isinstance(array, torch.Tensor):
        dev = Device(array.device if device is None else device)
        out = K.plain(array).to(dev.torch_device)
        return out if dt is None else out.to(dt)
    dev = default_device() if device is None else Device(device)
    if isinstance(array, (bool, int, float, np.number)):
        return K.fill((), array, dtype=dt, device=dev.torch_device)
    return K.from_numpy(array, device=dev.torch_device, dtype=dtype)


def _grad_view(t):
    if t.grad_fn is not None:  # a non-leaf keeps no gradient
        return None
    g = _Base.grad.__get__(t)
    return None if g is None else BackendTensor._wrap(K.plain(g), Device(g.device))


class Tensor(torch.Tensor):
    """A tape tensor: ``Tensor(array, dtype=None, device=None, name=None,
    requires_grad=False)``.  ``array`` may be a numpy array, a list, a
    Python scalar, a torch tensor, a ``BackendTensor`` or a Tensor (whose
    storage it shares when the device and dtype stay).  ``device=None``
    is ``default_device()`` (the card unless ``DEEPFLOWS_BACKEND`` names
    another device), or the argument's own device for a tensor.
    ``requires_grad`` holds only while the grad flag is on."""

    name = None

    def __new__(cls, array, dtype=None, device=None, name=None, requires_grad=False):
        rg = bool(requires_grad) and _autograd._grad_enabled
        data = _leaf_data(array, dtype, device)
        if isinstance(data, _lazy.LazyTensor):  # a leaf holds values: a pending one runs now
            data = data.force()
        t = torch.Tensor._make_subclass(cls, data, rg)
        if name is not None:
            t.name = name
        if rg:
            Graph.node_list.append(t)
        return t

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if kwargs is None:
            kwargs = {}
        with _Disable():
            if _autograd._grad_enabled:
                ret = func(*args, **kwargs)
            else:
                with torch.no_grad():
                    ret = func(*args, **kwargs)
        if func in _NOWRAP:
            return ret
        return _tape(ret, args, kwargs)

    def __deepcopy__(self, memo):
        """A fresh leaf with a copy of the values and attributes."""
        with _lazy.paused(), _Disable():
            rg = self.requires_grad
            data = self.detach().clone()
        new = torch.Tensor._make_subclass(type(self), data, rg)
        memo[id(self)] = new
        for k, v in self.__dict__.items():
            setattr(new, k, _copy.deepcopy(v, memo))
        if rg:
            Graph.node_list.append(new)
        return new

    # ------------------------------------------------------------- basics
    @staticmethod
    def make_const(t: "Tensor") -> "Tensor":
        return Tensor(t, requires_grad=False)

    @property
    def data(self):
        """The values as a ``BackendTensor`` that writes this Tensor."""
        with _Disable():
            arr = _Base.data.__get__(self)
        return BackendTensor._wrap(K.plain(arr), Device(arr.device))

    @data.setter
    def data(self, value):
        if isinstance(value, BackendTensor):
            value = value.array
        _Base.data.__set__(self, K.plain(value))

    @property
    def grad(self):
        """A leaf's accumulated gradient as a ``BackendTensor``, or None."""
        with _Disable():
            return _grad_view(self)

    @grad.setter
    def grad(self, value):
        if isinstance(value, BackendTensor):
            value = value.array
        with _Disable():
            _Base.grad.__set__(self, None if value is None else K.plain(value))

    def numpy(self, *, force=False) -> np.ndarray:
        """A host copy from any device (bf16 widened to f32)."""
        return K.to_numpy(self)

    def __array__(self, dtype=None, copy=None):
        if copy is False:
            raise ValueError("np.asarray(tensor, copy=False) cannot alias device memory")
        arr = K.to_numpy(self)
        return arr.astype(dtype) if dtype is not None else arr

    def dispose(self):
        """Drop this node from the tape."""
        for i, n in enumerate(Graph.node_list):
            if n is self:
                del Graph.node_list[i]
                break

    def __repr__(self, **kwargs):
        with _Disable():
            rg = self.requires_grad
            dev = self.device
        return f"Tensor({K.to_numpy(self)!r}, requires_grad={rg}, device={Device(dev)})"

    def __str__(self):
        return str(K.to_numpy(self))

    def __format__(self, spec):
        return format(K.to_numpy(self), spec) if self.dim() == 0 else str(self)

    __hash__ = object.__hash__

    # ------------------------------------------------------------- ops
    @property
    def T(self):
        if not _taping():
            return _Base.T.__get__(self)
        return transpose(self, None)

    def transpose(self, *axes):
        if not _taping() or len(axes) == 2:
            return torch.Tensor.transpose(self, *axes)
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return transpose(self, axes if axes else None)

    def max(self, *args, **kwargs):
        if not _taping() or _torch_style(args, kwargs):
            return torch.Tensor.max(self, *args, **kwargs)
        return max(self, *args, **kwargs)

    def min(self, *args, **kwargs):
        if not _taping() or _torch_style(args, kwargs):
            return torch.Tensor.min(self, *args, **kwargs)
        return min(self, *args, **kwargs)

    def __matmul__(self, x):
        return matmul(self, x) if _taping() else torch.Tensor.__matmul__(self, x)

    def __rmatmul__(self, x):
        return matmul(x, self) if _taping() else torch.Tensor.__rmatmul__(self, x)

    def __getitem__(self, key):
        if _taping():
            return get_slice(self, key)
        return torch.Tensor.__getitem__(self, key)

    def _check_inplace(self):
        if _taping():
            with _Disable():
                rg = self.requires_grad
            if rg:  # the JAX tape's assertion, raised under -O too
                raise AssertionError("In-place operation is forbidden in node requires grad.")

    def __setitem__(self, key, value):
        self._check_inplace()
        if isinstance(key, Tensor):
            key = K.plain(key)
        if isinstance(value, BackendTensor):
            value = value.array
        torch.Tensor.__setitem__(self, key, value)

    def __imatmul__(self, other):
        self._check_inplace()
        if isinstance(other, BackendTensor):
            other = other.array
        with _Disable():
            self.data = K.matmul(K.plain(self), K.plain(other))
        return self

    # ------------------------------------------------------------- autograd
    def backward(self, retain_graph: bool = False):
        """Walk back from this scalar and accumulate into the leaves;
        return quietly for a Tensor not on the tape; free the graph's
        non-leaves (and torch's saved tensors) unless ``retain_graph``."""
        if not _taping():
            return torch.Tensor.backward(self, retain_graph=retain_graph)
        nodes = Graph.node_list
        for i in range(len(nodes) - 1, -1, -1):
            if nodes[i] is self:
                break
        else:
            return
        with _Disable():
            if self.numel() != 1:
                raise ValueError("backward should be called only on a scalar.")
            if _lazy.recording():  # one node: the walk runs when the fragment runs
                _lazy.record_backward(self, retain_graph)
            else:
                torch.autograd.backward(self, retain_graph=retain_graph)
        if not retain_graph:
            Graph.free_graph()

    def zero_grad(self):
        self.grad = None

    # ------------------------------------------------------------- devices
    def to(self, *args, **kwargs):
        """``to(device)``: this Tensor on ``device`` (itself if already
        there) as a new leaf that keeps ``requires_grad``; any other
        arguments are torch's ``to``."""
        if _taping() and len(args) == 1 and not kwargs and _is_device(args[0]):
            dev = Device(args[0])
            with _Disable():
                here, rg = self.device, self.requires_grad
            if dev == here:
                return self
            return Tensor(self, device=dev, requires_grad=rg)
        return torch.Tensor.to(self, *args, **kwargs)

    def cpu(self, *args, **kwargs):
        if args or kwargs or not _taping():
            return torch.Tensor.cpu(self, *args, **kwargs)
        return self.to("cpu")

    def cuda(self, *args, **kwargs):
        if args or kwargs or not _taping():
            return torch.Tensor.cuda(self, *args, **kwargs)
        return self.to("cuda")

    def tpu(self):
        return self.to("cuda")


def _arithmetic(name):
    """A binary operator of torch's with the tape's operand rules: a
    BackendTensor or an array becomes a tensor beside ``self``, a tensor on
    another device is refused; Python scalars are torch's (they take the
    Tensor's dtype where their kind allows)."""
    base = getattr(torch.Tensor, name)

    def op(self, other):
        if _taping() and not isinstance(other, (bool, int, float)):
            other = _tensor_operand(other, self)
        return base(self, other)

    op.__name__ = name
    return op


def _in_place(name):
    """An in-place operator, refused on a Tensor that requires grad."""
    base = getattr(torch.Tensor, name)

    def op(self, other):
        self._check_inplace()
        return base(self, other.array if isinstance(other, BackendTensor) else other)

    op.__name__ = name
    return op


def _comparison(name, fn):
    """A comparison as a constant 0/1 Tensor in the default float dtype
    (torch's bool result inside an autograd Function and the backward)."""
    base = getattr(torch.Tensor, name)

    def op(self, other):
        if not _taping():
            return base(self, other)
        if isinstance(other, BackendTensor):
            other = other.array
        with no_grad():
            return fn(self, other).to(config.default_dtype)

    op.__name__ = name
    return op


for _name in ("__add__", "__sub__", "__rsub__", "__mul__", "__truediv__", "__rtruediv__",
              "__pow__", "__rpow__"):
    setattr(Tensor, _name, _arithmetic(_name))
Tensor.__radd__, Tensor.__rmul__ = Tensor.__add__, Tensor.__mul__
for _name in ("__iadd__", "__isub__", "__imul__", "__itruediv__"):
    setattr(Tensor, _name, _in_place(_name))
for _name, _fn in (("__lt__", torch.lt), ("__le__", torch.le), ("__gt__", torch.gt),
                   ("__ge__", torch.ge), ("eq", torch.eq), ("ne", torch.ne)):
    setattr(Tensor, _name, _comparison(_name, _fn))


def _is_device(arg) -> bool:
    from .backend.device import BackendDevice

    if isinstance(arg, (torch.device, BackendDevice)):
        return True
    return isinstance(arg, str) and arg.split(":")[0].strip().lower() in (
        "cpu", "cuda", "gpu", "tpu", "cpu_native")


def _torch_style(args, kwargs) -> bool:
    """A ``max`` / ``min`` call written torch's way: ``dim=`` or
    ``keepdim=``, or another tensor."""
    return "dim" in kwargs or "keepdim" in kwargs or (
        bool(args) and isinstance(args[0], torch.Tensor))


def _same_device(x, y):
    with _Disable():
        dx, dy = x.device, y.device
    if dx != dy:
        raise AssertionError(f"operands on different devices: {dx} vs {dy}")


def _scalar_dtype(t):
    """A Python scalar operand takes the tensor's floating dtype (bf16
    stays bf16), else the default dtype."""
    return t.dtype if t.is_floating_point() else config.default_dtype


def _const(value, like):
    """A 0-d tensor of a Python scalar in ``like``'s floating dtype (else
    the default dtype) on its device, filled there: no host-to-device
    copy."""
    with _Disable():
        dev, dt = like.device, _scalar_dtype(like)
    return torch.full((), value, dtype=dt, device=dev)


def _tensor_operand(x, like):
    """``x`` as a tensor beside the Tensor ``like``: a tensor as it is (on
    ``like``'s device, or refused), a BackendTensor's tensor, a scalar as a
    0-d constant, an array as a Tensor on ``like``'s device."""
    if isinstance(x, torch.Tensor):
        _same_device(x, like)
        return x
    if isinstance(x, BackendTensor):
        _same_device(x.array, like)
        return x.array
    if isinstance(x, (bool, int, float, np.number)):
        return _const(x.item() if isinstance(x, np.number) else x, like)
    with _Disable():
        dev = like.device
    return Tensor(x, device=dev)


def _pair(x, y):
    if not isinstance(x, torch.Tensor) and not isinstance(y, torch.Tensor):
        x = Tensor(x.array if isinstance(x, BackendTensor) else x)
    if isinstance(x, torch.Tensor):
        return x, _tensor_operand(y, x)
    return _tensor_operand(x, y), y


# ------------------------------------------------------------------ op classes
class _Spec:
    """Holds a user op's instance across its autograd Function."""

    def __init__(self, op):
        self.op = op


class _UserOp(torch.autograd.Function):
    """A ``UnaryOperator`` / ``BinaryOperator`` subclass written the JAX
    package's way (``forward`` and ``grad_fn`` over BackendTensors) as one
    autograd node."""

    @staticmethod
    def forward(ctx, spec, *xs):
        op = spec.op
        ctx.spec = spec
        if len(xs) == 1:
            out = op.forward(op._x)
        else:
            out = op.forward(op._x.data, op._y.data)
        out = out.array if isinstance(out, BackendTensor) else out
        _Base.data.__set__(op, K.plain(out))
        return K.plain(out).clone()

    @staticmethod
    def backward(ctx, g):
        op = ctx.spec.op
        grad = BackendTensor._wrap(g, Device(g.device))
        operands = (op._x,) if not hasattr(op, "_y") else (op._x, op._y)
        out = [None]
        for i, x in enumerate(operands):
            if not ctx.needs_input_grad[i + 1]:
                out.append(None)
                continue
            gi = op.grad_fn(x, grad)
            gi = gi.array if isinstance(gi, BackendTensor) else K.plain(gi)
            if gi.shape != x.shape:
                gi = _unbroadcast(gi, x.shape)
            out.append(gi)
        return tuple(out)


def _unbroadcast(g, shape):
    extra = g.dim() - len(shape)
    if extra > 0:
        g = g.sum(tuple(range(extra)))
    axes = tuple(i for i, (a, b) in enumerate(zip(g.shape, shape)) if a != b)
    if axes:
        g = g.sum(axes, keepdim=True)
    return g.reshape(shape)


def _run_user_op(cls, operands, args, kwargs):
    with _lazy.paused(flush_first=False):
        op = torch.Tensor._make_subclass(cls, torch.empty(0))
    op._building = True
    cls.__init__(op, *args, **kwargs)
    op._building = False
    return function_apply(_UserOp, _Spec(op), *operands(op))


class UnaryOperator(Tensor):
    """An op of one Tensor.  A subclass written the JAX package's way
    defines ``forward(self, x) -> BackendTensor`` (``x`` the operand
    Tensor) and ``grad_fn(self, x, grad) -> BackendTensor``, may set its
    own attributes in ``__init__`` before ``super().__init__(x)``, and
    reads its output as ``self.data``; calling the class returns the
    result Tensor.  The built-in ops define ``_apply`` over torch's ops
    instead."""

    def __new__(cls, x, *args, **kwargs):
        if "_apply" in cls.__dict__:
            if not isinstance(x, torch.Tensor):
                x = Tensor(x)
            return cls._apply(x, *args, **kwargs)
        return _run_user_op(cls, lambda op: (op._x,), (x,) + args, kwargs)

    def __init__(self, x, *args, **kwargs):
        if getattr(self, "_building", False):
            self._x = x if isinstance(x, Tensor) else Tensor(x)

    def forward(self, x):
        raise NotImplementedError

    def grad_fn(self, x, grad):
        raise NotImplementedError


class BinaryOperator(Tensor):
    """An op of two operands; a Python scalar takes the Tensor operand's
    floating dtype, operands on two devices are refused.  Subclassed as
    ``UnaryOperator`` is, with ``forward(self, x, y)`` over the operands'
    BackendTensors and ``grad_fn(self, node, grad)`` for ``node`` either
    operand Tensor."""

    def __new__(cls, x, y, *args, **kwargs):
        x, y = _pair(x, y)
        if "_apply" in cls.__dict__:
            return cls._apply(x, y, *args, **kwargs)
        return _run_user_op(cls, lambda op: (op._x, op._y), (x, y) + args, kwargs)

    def __init__(self, x, y, *args, **kwargs):
        if getattr(self, "_building", False):
            self._x = x if isinstance(x, Tensor) else Tensor(x)
            self._y = y if isinstance(y, Tensor) else Tensor(y, device=self._x.device)
            if self._y is self._x:  # grad_fn tells the operands apart by identity
                self._y = self._x.reshape(self._x.shape)

    def forward(self, x, y):
        raise NotImplementedError

    def grad_fn(self, node, grad):
        raise NotImplementedError


# ------------------------------------------------------------------ arithmetic
class add(BinaryOperator):
    @staticmethod
    def _apply(x, y):
        return torch.add(x, y)


class sub(BinaryOperator):
    @staticmethod
    def _apply(x, y):
        return torch.sub(x, y)


class mul(BinaryOperator):
    @staticmethod
    def _apply(x, y):
        return torch.mul(x, y)


class div(BinaryOperator):
    @staticmethod
    def _apply(x, y):
        return torch.div(x, y)


class pow(BinaryOperator):
    @staticmethod
    def _apply(x, y):
        return torch.pow(x, y)


class _KernelMatmul(torch.autograd.Function):
    """``ops.matmul(a, b)`` with both backward products through
    ``ops.matmul``; only the gradients asked for are computed."""

    @staticmethod
    def forward(ctx, a, b):
        from .ops.linear import matmul as kernel

        ctx.save_for_backward(a, b)
        return kernel(a, b)

    @staticmethod
    def backward(ctx, g):
        from .ops.linear import matmul as kernel

        a, b = ctx.saved_tensors
        ga = kernel(g, b.t()) if ctx.needs_input_grad[0] else None
        gb = kernel(a.t(), g) if ctx.needs_input_grad[1] else None
        return ga, gb


class matmul(BinaryOperator):
    """``x @ y`` with torch's rank rules (1-D promotion, batched broadcast).
    Under ``config.use_pallas`` a product of two 2-D f32 Tensors runs on
    ``ops.matmul``, its backward products too (the kernel on the card, its
    plain twin on the CPU); any other is ``torch.matmul``."""

    @staticmethod
    def _apply(x, y):
        with _Disable():
            routed = K.matmul_routed(x, y)
        if routed:
            return function_apply(_KernelMatmul, x, y)
        return torch.matmul(x, y)


class abs(UnaryOperator):  # noqa: A001
    """|x| with the sign gradient."""

    @staticmethod
    def _apply(x):
        return torch.abs(x)


def _reduce_dims(axis):
    return (axis,) if isinstance(axis, int) else axis


class sum(UnaryOperator):  # noqa: A001
    @staticmethod
    def _apply(x, axis=None, keepdims=False):
        if axis is None and not keepdims:
            return torch.sum(x)
        return torch.sum(x, dim=_reduce_dims(axis), keepdim=keepdims)


class mean(UnaryOperator):
    """The mean over ``axis``, dividing by the size of the axes reduced."""

    @staticmethod
    def _apply(x, axis=None, keepdims=False):
        if axis is None and not keepdims:
            return torch.mean(x)
        return torch.mean(x, dim=_reduce_dims(axis), keepdim=keepdims)


class max(UnaryOperator):  # noqa: A001
    """The largest values over ``axis``; the gradient splits evenly among
    ties."""

    @staticmethod
    def _apply(x, axis=None, keepdims=False):
        return torch.amax(x, dim=() if axis is None else _reduce_dims(axis), keepdim=keepdims)


class min(UnaryOperator):  # noqa: A001
    @staticmethod
    def _apply(x, axis=None, keepdims=False):
        return torch.amin(x, dim=() if axis is None else _reduce_dims(axis), keepdim=keepdims)


class exp(UnaryOperator):
    @staticmethod
    def _apply(x):
        return torch.exp(x)


class log(UnaryOperator):
    @staticmethod
    def _apply(x):
        return torch.log(x)


class maximum(BinaryOperator):
    """Elementwise maximum; at a tie each operand gets half the gradient."""

    @staticmethod
    def _apply(x, y):
        return torch.maximum(x, y)


class minimum(BinaryOperator):
    @staticmethod
    def _apply(x, y):
        return torch.minimum(x, y)


def sqrt(x):
    return x**0.5


def square(x):
    return x * x


# ------------------------------------------------------------------ shape ops
class Reshape(UnaryOperator):
    @staticmethod
    def _apply(x, new_shape):
        return torch.reshape(x, tuple(new_shape))


class transpose(UnaryOperator):
    """Permute by ``axes``; None reverses them."""

    @staticmethod
    def _apply(x, axes=None):
        if axes is None:
            axes = tuple(reversed(range(x.dim())))
        return torch.permute(x, tuple(axes))


class concat(Tensor):
    """Concatenate along ``axis``."""

    def __new__(cls, tensors, axis=0):
        tensors = list(tensors)
        first = next((t for t in tensors if isinstance(t, torch.Tensor)), None)
        dev = None if first is None else first.device
        tensors = [t if isinstance(t, torch.Tensor) else Tensor(t, device=dev) for t in tensors]
        for t in tensors[1:]:
            _same_device(t, tensors[0])
        out = torch.cat(tensors, dim=axis)
        return out if isinstance(out, Tensor) else Tensor(out)


class get_slice(UnaryOperator):
    """``x[key]``; its gradient adds into the selected elements, repeats of
    an array key summed."""

    @staticmethod
    def _apply(x, key):
        if isinstance(key, BackendTensor):
            key = key.array
        elif isinstance(key, tuple):
            key = tuple(k.array if isinstance(k, BackendTensor) else k for k in key)
        return torch.Tensor.__getitem__(x, key)


# ------------------------------------------------------------------ factories
def tensor(array, dtype=None, device=None, requires_grad=False) -> Tensor:
    return Tensor(array, dtype=dtype, device=device, requires_grad=requires_grad)


def empty(shape, dtype=None, device=None, requires_grad=False) -> Tensor:
    return Tensor(backend_api.empty(shape, device=device, dtype=dtype),
                  requires_grad=requires_grad)


def zeros(shape, dtype=None, device=None, requires_grad=False) -> Tensor:
    return Tensor(backend_api.zeros(shape, device=device, dtype=dtype),
                  requires_grad=requires_grad)


def ones(shape, dtype=None, device=None, requires_grad=False) -> Tensor:
    return Tensor(backend_api.ones(shape, device=device, dtype=dtype),
                  requires_grad=requires_grad)


def zeros_like(t, requires_grad=False) -> Tensor:
    return zeros(t.shape, dtype=t.dtype, device=t.device, requires_grad=requires_grad)


def ones_like(t, requires_grad=False) -> Tensor:
    return ones(t.shape, dtype=t.dtype, device=t.device, requires_grad=requires_grad)


def randn(*shape, dtype=None, device=None, requires_grad=False, seed=None) -> Tensor:
    return Tensor(Device(device).randn(*shape, dtype=dtype, seed=seed),
                  requires_grad=requires_grad)


def rand(*shape, dtype=None, device=None, requires_grad=False, seed=None) -> Tensor:
    return Tensor(Device(device).rand(*shape, dtype=dtype, seed=seed),
                  requires_grad=requires_grad)


def uniform(low, high, shape, dtype=None, device=None, requires_grad=False,
            seed=None) -> Tensor:
    dev = Device(device)
    return Tensor(BackendTensor._wrap(dev.uniform(low, high, shape, dtype=dtype, seed=seed),
                                      dev), requires_grad=requires_grad)


def arange(*args, dtype=None, device=None) -> Tensor:
    return Tensor(np.arange(*args), dtype=dtype, device=Device(device))
