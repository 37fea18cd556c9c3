"""ONNX export by tracing one forward's torch calls (counterpart of
``deepflows_tpu/onnx/export.py``).

``export_onnx(model, sample_input, path)`` runs one eval-mode forward of
the model under a ``TorchFunctionMode`` that records every torch call
(as lazy mode's recorder sees them, ``backend/lazy.py``), walks the
recorded calls back from the output to the graph input, folds every
subtree that does not depend on the input (BN's running statistics, the
position tables, the causal mask, Python scalars) into initializers, and
writes an opset-13 ModelProto through the vendored minimal schema
(``proto/onnx_minimal.proto``, the JAX package's bytes: the field numbers
of the official ``onnx.proto3``).  The file is the JAX exporter's: graph
input ``"input"`` (f32, or int32 for token ids), the leading dimension
``"N"`` where ``batch_dynamic``, ``ir_version`` 8.

What reads no data (shapes, dtypes, devices) runs at once and is not
recorded; ``detach``, ``contiguous``, a ``to`` that changes nothing and
an ``as_tensor`` of a tensor alias their operand.  Every traced tensor
is kept alive until the walk ends, so no two values share an ``id``.
An autograd ``Function`` reached through ``tensor.function_apply`` (the
kernel routes, ``nn.torch_function``, a user's tape op) is one opaque
node, which the walk refuses wherever it meets it, as the JAX exporter
refuses its ``_JaxFnOp`` and ``_FusedLinearOp``; so is a call it has no
mapping for that depends on the input.

The mapping follows the JAX exporter's output: BN in eval mode is the
Sub / Div / Mul / Add chain of ``nn.functional.batch_norm_eval``, with no
``BatchNormalization`` node (train-mode BN is refused); ``maximum(x, 0)``
is ``Relu``; GELU and SiLU are decomposed (opset 13 has neither); the
routing mask of ``nn.functional.topk_mask`` is TopK, Slice,
GreaterOrEqual and Cast; a Reshape whose leading dimension mirrors the
input's batch writes 0 there.  Negation is a Mul by -1, ``expand`` an Add
of zeros, and an int index or ``None`` in ``x[...]`` a Reshape after the
Slice, so that every file runs in the JAX package's runtime, which has no
Neg, Expand, Squeeze or Unsqueeze.

An attention layer with ``flash=None`` takes its naive path while it is
traced (the flash kernel has no ONNX form); ``flash=True`` is refused by
the kernel route's name.  The tracer is a mode of the tracing thread
alone: other threads' tape steps and attention layers run as before.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from ..autograd import flag_kept
from ..backend import lazy as _lazy
from .proto import onnx_minimal_pb2 as pb

OPSET = 13
_INT64_MAX = np.iinfo(np.int64).max

def _tensor_proto(name: str, arr: np.ndarray) -> pb.TensorProto:
    tp = pb.TensorProto()
    tp.name = name
    tp.dims.extend(arr.shape)
    if arr.dtype == np.int64:
        tp.data_type = pb.TensorProto.INT64
    elif arr.dtype == np.int32:
        tp.data_type = pb.TensorProto.INT32
    else:
        arr = arr.astype(np.float32)
        tp.data_type = pb.TensorProto.FLOAT
    tp.raw_data = np.ascontiguousarray(arr).tobytes()
    return tp


def _value_info(name: str, shape, batch_dynamic=False, elem_type=None) -> pb.ValueInfoProto:
    vi = pb.ValueInfoProto()
    vi.name = name
    tt = vi.type.tensor_type
    tt.elem_type = elem_type or pb.TensorProto.FLOAT
    for i, d in enumerate(shape):
        dim = tt.shape.dim.add()
        if i == 0 and batch_dynamic:
            dim.dim_param = "N"
        else:
            dim.dim_value = int(d)
    return vi


def _attr_ints(node: pb.NodeProto, name: str, values):
    a = node.attribute.add()
    a.name = name
    a.type = pb.AttributeProto.INTS
    a.ints.extend(int(v) for v in values)


def _attr_int(node: pb.NodeProto, name: str, value):
    a = node.attribute.add()
    a.name = name
    a.type = pb.AttributeProto.INT
    a.i = int(value)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _host(t: torch.Tensor) -> np.ndarray:
    t = t.detach()
    if t.dtype in (torch.bfloat16, torch.float16):
        t = t.float()
    return t.cpu().numpy()


# ------------------------------------------------------------------ the trace
class _Val:
    """One traced value: the node that made it (None for a leaf: the
    input, a parameter, a buffer, a tensor made before the trace), the
    tensor itself (kept alive) and whether it depends on the graph
    input."""

    __slots__ = ("node", "tensor", "dep")

    def __init__(self, node, tensor, dep):
        self.node, self.tensor, self.dep = node, tensor, dep


class _Node:
    """One recorded call: the function, its arguments with every tensor
    replaced by its ``_Val``, its outputs, and for an autograd Function
    (``opaque``) the Function class."""

    __slots__ = ("func", "args", "kwargs", "outs", "opaque")

    def __init__(self, func, args, kwargs, opaque=None):
        self.func, self.args, self.kwargs, self.opaque = func, args, kwargs, opaque
        self.outs = []


_KINDS = {}
_ALIASES = frozenset(("detach", "contiguous", "clone", "alias", "detach_copy", "as_tensor",
                      "asarray"))


def _name(func) -> str:
    name = getattr(func, "__name__", "")
    if name in ("__get__", "__set__"):
        return f"{name}:{_lazy._attr_name(func)}"
    return name


def _kind(func) -> str:
    k = _KINDS.get(func)
    if k is None:
        k = _KINDS[func] = _lazy._classify(func)
    return k


def _in_place(name: str) -> bool:
    return (name.endswith("_") and not name.startswith("__")) or (
        name.startswith("__i") and name not in ("__index__", "__invert__", "__int__", "__iter__"))


class _Tracer(TorchFunctionMode):
    """Records the torch calls of one forward (see the module docstring).
    It is active on the tracing thread alone, as torch keeps the mode
    stack per thread: ``tensor.function_apply`` hands it autograd
    Functions (``take_function``), and an attention layer with
    ``flash=None`` asks it for ``kernel_routes``."""

    kernel_routes = False  # the kernels have no ONNX form

    def __init__(self, x: torch.Tensor):
        super().__init__()
        self.input = _Val(None, x, True)
        self.vals = {id(x): (x, self.input)}  # id -> (the tensor, its value)
        self.keep = [x]

    def val(self, t: torch.Tensor) -> _Val:
        tv = self.vals.get(id(t))
        if tv is not None and tv[0] is t:
            return tv[1]
        v = _Val(None, t, False)
        self.vals[id(t)] = (t, v)
        self.keep.append(t)
        return v

    def _wrap(self, obj):
        if isinstance(obj, torch.Tensor):
            return self.val(obj)
        if type(obj) in (list, tuple):
            return type(obj)(self._wrap(o) for o in obj)
        if isinstance(obj, tuple):  # a named tuple of results handed back in
            return tuple(self._wrap(o) for o in obj)
        return obj

    @staticmethod
    def _deps(obj) -> bool:
        if isinstance(obj, _Val):
            return obj.dep
        if isinstance(obj, (list, tuple)):
            return any(_Tracer._deps(o) for o in obj)
        if isinstance(obj, dict):
            return any(_Tracer._deps(o) for o in obj.values())
        return False

    def record(self, func, args, kwargs, out, opaque=None):
        name = _name(func)
        node = _Node(func, self._wrap(args), {k: self._wrap(v) for k, v in kwargs.items()},
                     opaque)
        dep = self._deps(node.args) or self._deps(node.kwargs)
        if name.startswith("new_") or name.endswith("_like") or _kind(func) == "factory":
            dep = False  # reads the operand's shape and dtype, not its values
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for t in outs:
            if not isinstance(t, torch.Tensor):
                continue
            v = _Val(node, t, dep)
            node.outs.append(v)
            self.vals[id(t)] = (t, v)
            self.keep.append(t)
        return out

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        kind = _kind(func)
        name = _name(func)
        if kind in ("meta", "state", "grad_get", "grad_set", "data_set"):
            return out
        if kind == "read":
            if self._deps(self._wrap(args)):
                raise ValueError(
                    f"{name} reads an input-dependent value on the host during the export "
                    "trace; the graph would bake it in")
            return out
        if not isinstance(out, torch.Tensor) and not (
                isinstance(out, (tuple, list)) and any(isinstance(o, torch.Tensor) for o in out)):
            return out
        if isinstance(out, torch.Tensor) and any(a is out for a in args):
            if _in_place(name) and (self._deps(self._wrap(args)) or
                                    self._deps(self._wrap(tuple(kwargs.values())))):
                # the written tensor becomes this call's value (an op with no ONNX mapping)
                return self.record(func, args, kwargs, out)
            return out  # handed back unchanged (to() of the same dtype), or a constant written
        if name in _ALIASES or (name == "__get__:data"):
            src = args[0] if args and isinstance(args[0], torch.Tensor) else None
            if src is not None and tuple(out.shape) == tuple(src.shape) and \
                    out.dtype == src.dtype:
                self.vals[id(out)] = (out, self.val(src))
                self.keep.append(out)
                return out
        return self.record(func, args, kwargs, out)

    def take_function(self, fn, args):
        """``tensor.function_apply`` on this thread while tracing: the
        Function runs with the mode off and is recorded as one opaque node."""
        with torch._C.DisableTorchFunction():
            out = fn.apply(*args)
        return self.record(fn.apply, args, {}, out, opaque=fn)


@_lazy.eager
def _trace(fn, x: torch.Tensor):
    """``(tracer, output value)`` of ``fn(x)`` traced with gradients off."""
    tracer = _Tracer(x)
    with torch.no_grad(), tracer:
        out = fn(x)
    if not isinstance(out, torch.Tensor):
        raise ValueError(f"the traced forward returned {type(out).__name__}, not one tensor")
    return tracer, tracer.val(out)


def _sample_tensor(model, sample_input) -> torch.Tensor:
    arr = np.asarray(sample_input)
    if np.issubdtype(arr.dtype, np.integer):
        arr = arr.astype(np.int32)  # token ids, as the JAX exporter writes them
    else:
        arr = arr.astype(np.float32)
    p = next(iter(model.parameters()), None)
    dev = p.device if p is not None else torch.device("cpu")
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dev)


def trace(model, sample_input):
    """Trace one eval-mode forward of ``model`` on ``sample_input`` (the
    model's mode and the tape's grad flag are restored):
    ``(tracer, input value, output value)``."""
    x = _sample_tensor(model, sample_input)
    with flag_kept():  # eval() and train() set the tape's grad flag
        was_training = model.training
        model.eval()
        try:
            tracer, out = _trace(model, x)
        finally:
            if was_training:
                model.train()
    return tracer, tracer.input, out


# ------------------------------------------------------------------ the walk
class _Exporter:
    def __init__(self, tracer: _Tracer, batch_dynamic: bool):
        self.tracer = tracer
        self.batch_dynamic = batch_dynamic
        self.batch = tracer.input.tensor.shape[0] if tracer.input.tensor.dim() else None
        self.graph = pb.GraphProto()
        self.graph.name = "deepflows_tpu"
        self.names: dict = {id(tracer.input): "input"}
        self._opaque_checked: dict = {}
        self._count = 0
        self._const_count = 0

    # ---------------------------------------------------------- plumbing
    def _refuse_opaque(self, v: _Val) -> None:
        """Raise if ``v`` is, or folds, an autograd Function's output."""
        stack = [v]
        while stack:
            u = stack.pop()
            if u.node is None or id(u) in self._opaque_checked:
                continue
            self._opaque_checked[id(u)] = True
            if u.node.opaque is not None:
                raise ValueError(
                    f"op {u.node.opaque.__name__} is not exportable to ONNX (an autograd "
                    "Function: a kernel route, nn.torch_function or a user-defined tape op; "
                    "refusing to constant-fold it)")
            stack.extend(_vals(u.node.args))
            stack.extend(_vals(tuple(u.node.kwargs.values())))

    def const(self, arr) -> str:
        name = f"const_{self._const_count}"
        self._const_count += 1
        self.graph.initializer.append(_tensor_proto(name, np.asarray(arr)))
        return name

    def init(self, name: str, arr) -> str:
        self.graph.initializer.append(_tensor_proto(name, np.asarray(arr)))
        return name

    def name_of(self, v: _Val) -> str:
        """Emit (if needed) and return the value name of ``v``: its
        input-dependent ancestors first, in post-order and without
        recursion (a ResNet-50's chain is deeper than Python's stack)."""
        key = id(v)
        if key in self.names:
            return self.names[key]
        self._refuse_opaque(v)
        if not v.dep:
            name = self.const(_host(v.tensor))
            self.names[key] = name
            return name
        order, seen, stack = [], set(), [(v, False)]
        while stack:
            u, ready = stack.pop()
            if ready:
                order.append(u)
            elif u.dep and u.node is not None and id(u) not in self.names \
                    and id(u) not in seen:
                seen.add(id(u))
                stack.append((u, True))
                stack.extend((w, False) for w in _vals(u.node.args) +
                             _vals(tuple(u.node.kwargs.values())))
        for u in order:
            if id(u) not in self.names:
                self._emit_node(u.node)
        return self.names[key]

    def _emit_node(self, node: _Node) -> None:
        outs = []
        for u in node.outs:
            n = f"t{self._count}"
            self._count += 1
            self.names[id(u)] = n
            outs.append(n)
        self._emit(node, outs)

    def _node(self, op_type: str, inputs, output) -> pb.NodeProto:
        n = self.graph.node.add()
        n.op_type = op_type
        outs = [output] if isinstance(output, str) else list(output)
        n.name = f"{op_type}_{outs[0]}"
        n.input.extend(inputs)
        n.output.extend(outs)
        return n

    def operand(self, a, like: _Val = None) -> str:
        """The name of a traced value, or of a Python number made a
        constant in the dtype of ``like``."""
        if isinstance(a, _Val):
            return self.name_of(a)
        dt = like.tensor.dtype if like is not None else torch.float32
        if dt in (torch.int32, torch.int64) and isinstance(a, int):
            return self.const(np.asarray(a, np.int32 if dt == torch.int32 else np.int64))
        return self.const(np.asarray(a, np.float32))

    def _is_zero(self, a) -> bool:
        if isinstance(a, (int, float)):
            return float(a) == 0.0
        if isinstance(a, _Val) and not a.dep and a.tensor.numel() == 1:
            return float(_host(a.tensor).ravel()[0]) == 0.0
        return False

    def reshape(self, src: str, x: _Val, out_shape, out: str) -> None:
        """Reshape to ``out_shape``; its leading dimension is written 0 (copy
        the input's) when it mirrors the graph input's batch."""
        shape = [int(d) for d in out_shape]
        if (self.batch_dynamic and shape and x.tensor.dim() and shape[0] == x.tensor.shape[0]
                and shape[0] == self.batch):
            shape[0] = 0
        sh = self.init(f"shape_{out}", np.asarray(shape, np.int64))
        self._node("Reshape", [src, sh], out)

    # ---------------------------------------------------------- op emitters
    def _emit(self, node: _Node, outs) -> None:
        name = _name(node.func)
        a, kw = node.args, node.kwargs
        out = outs[0]
        emit = _EMITTERS.get(name)
        if emit is None:
            raise ValueError(
                f"op {name or node.func!r} has no ONNX mapping (export supports the model-zoo "
                "inference op set)")
        emit(self, node, a, kw, out, outs)


def _vals(obj):
    if isinstance(obj, _Val):
        return [obj]
    if isinstance(obj, (list, tuple)):
        return [v for o in obj for v in _vals(o)]
    return []


def _arg(a, kw, i, key, default=None):
    if len(a) > i:
        return a[i]
    return kw.get(key, default)


def _dims(d, ndim):
    if d is None:
        return None
    ds = (d,) if isinstance(d, int) else tuple(d)
    return [x % ndim for x in ds]


# binary arithmetic: (ONNX op, operands swapped)
_BINARY = {
    "add": ("Add", False), "__add__": ("Add", False), "__radd__": ("Add", True),
    "sub": ("Sub", False), "__sub__": ("Sub", False), "__rsub__": ("Sub", True),
    "subtract": ("Sub", False), "rsub": ("Sub", True),
    "mul": ("Mul", False), "__mul__": ("Mul", False), "__rmul__": ("Mul", True),
    "multiply": ("Mul", False),
    "div": ("Div", False), "__truediv__": ("Div", False), "__rtruediv__": ("Div", True),
    "true_divide": ("Div", False), "divide": ("Div", False), "__div__": ("Div", False),
    "pow": ("Pow", False), "__pow__": ("Pow", False), "__rpow__": ("Pow", True),
    "float_power": ("Pow", False),
    "matmul": ("MatMul", False), "__matmul__": ("MatMul", False),
    "__rmatmul__": ("MatMul", True), "mm": ("MatMul", False), "bmm": ("MatMul", False),
    "ge": ("GreaterOrEqual", False), "__ge__": ("GreaterOrEqual", False),
    "greater_equal": ("GreaterOrEqual", False),
}


def _binary(ex, node, a, kw, out, outs):
    name = _name(node.func)
    op, swap = _BINARY[name]
    x = a[0]
    y = _arg(a, kw, 1, "other", kw.get("exponent"))
    if kw.get("alpha", 1) != 1 or kw.get("rounding_mode") is not None:
        raise ValueError(f"op {name} with alpha or rounding_mode has no ONNX mapping")
    like = x if isinstance(x, _Val) else y
    lhs, rhs = (y, x) if swap else (x, y)
    if op == "Mul" and isinstance(y, (int, float)) and float(y) == 1.0:
        ex._node("Identity", [ex.operand(x)], out)
        return
    ex._node(op, [ex.operand(lhs, like), ex.operand(rhs, like)], out)


def _max_min(ex, node, a, kw, out, outs):
    name = _name(node.func)
    x, y = a[0], _arg(a, kw, 1, "other")
    is_max = name in ("maximum", "max", "fmax")
    if isinstance(y, _Val) or (name not in ("max", "min") and isinstance(y, (int, float))):
        if is_max:
            # maximum(x, 0) is ReLU: the canonical op
            for p, q in ((x, y), (y, x)):
                if isinstance(p, _Val) and p.dep and ex._is_zero(q):
                    ex._node("Relu", [ex.name_of(p)], out)
                    return
        like = x if isinstance(x, _Val) else y
        ex._node("Max" if is_max else "Min", [ex.operand(x, like), ex.operand(y, like)], out)
        return
    _reduce(ex, node, a, kw, out, outs)


_UNARY = {"exp": "Exp", "log": "Log", "abs": "Abs", "sqrt": "Sqrt", "tanh": "Tanh",
          "sigmoid": "Sigmoid", "erf": "Erf", "relu": "Relu", "__abs__": "Abs"}


def _unary(ex, node, a, kw, out, outs):
    ex._node(_UNARY[_name(node.func)], [ex.name_of(a[0])], out)


def _neg(ex, node, a, kw, out, outs):
    ex._node("Mul", [ex.name_of(a[0]), ex.operand(-1.0, a[0])], out)


def _silu(ex, node, a, kw, out, outs):
    # opset 13 has no Silu: x * sigmoid(x)
    x = ex.name_of(a[0])
    ex._node("Sigmoid", [x], f"{out}_s")
    ex._node("Mul", [x, f"{out}_s"], out)


def _gelu(ex, node, a, kw, out, outs):
    # opset 13 has no Gelu: the exact erf form or the tanh approximation
    x = ex.name_of(a[0])

    def const(val, suffix):
        return ex.init(f"{out}_{suffix}", np.asarray(val, np.float32))

    if _arg(a, kw, 1, "approximate", "none") == "tanh":
        c = float(np.sqrt(2.0 / np.pi))
        ex._node("Mul", [x, x], f"{out}_x2")
        ex._node("Mul", [f"{out}_x2", x], f"{out}_x3")
        ex._node("Mul", [f"{out}_x3", const(0.044715, "k")], f"{out}_kx3")
        ex._node("Add", [x, f"{out}_kx3"], f"{out}_in")
        ex._node("Mul", [f"{out}_in", const(c, "c")], f"{out}_cin")
        ex._node("Tanh", [f"{out}_cin"], f"{out}_t")
        ex._node("Add", [f"{out}_t", const(1.0, "one")], f"{out}_1t")
        ex._node("Mul", [x, f"{out}_1t"], f"{out}_x1t")
        ex._node("Mul", [f"{out}_x1t", const(0.5, "half")], out)
    else:
        ex._node("Div", [x, const(float(np.sqrt(2.0)), "s2")], f"{out}_h")
        ex._node("Erf", [f"{out}_h"], f"{out}_e")
        ex._node("Add", [f"{out}_e", const(1.0, "one")], f"{out}_1e")
        ex._node("Mul", [x, f"{out}_1e"], f"{out}_x1e")
        ex._node("Mul", [f"{out}_x1e", const(0.5, "half")], out)


_REDUCE = {"mean": "ReduceMean", "sum": "ReduceSum", "amax": "ReduceMax",
           "amin": "ReduceMin", "max": "ReduceMax", "min": "ReduceMin"}


def _reduce(ex, node, a, kw, out, outs):
    name = _name(node.func)
    if len(node.outs) > 1 or kw.get("dtype") is not None:
        raise ValueError(f"op {name} with indices or a dtype has no ONNX mapping")
    op = _REDUCE[name]
    x = a[0]
    nd = x.tensor.dim()
    axes = _dims(_arg(a, kw, 1, "dim"), nd)
    keep = bool(_arg(a, kw, 2, "keepdim", False))
    inputs = [ex.name_of(x)]
    if op == "ReduceSum" and axes is not None:
        # opset 13 moved ReduceSum's axes from attribute to input
        inputs.append(ex.init(f"axes_{out}", np.asarray(axes, np.int64)))
    n = ex._node(op, inputs, out)
    if op != "ReduceSum" and axes is not None:
        _attr_ints(n, "axes", axes)
    _attr_int(n, "keepdims", 1 if keep else 0)


def _reshape_like(ex, node, a, kw, out, outs):
    x = a[0]
    ex.reshape(ex.name_of(x), x, node.outs[0].tensor.shape, out)


def _transpose(ex, node, a, kw, out, outs):
    name = _name(node.func)
    x = a[0]
    nd = x.tensor.dim()
    perm = list(range(nd))
    if name in ("transpose", "swapaxes", "swapdims"):
        d0, d1 = (_arg(a, kw, 1, "dim0") % nd, _arg(a, kw, 2, "dim1") % nd)
        perm[d0], perm[d1] = perm[d1], perm[d0]
    elif name == "permute":
        dims = a[1:] if len(a) > 2 or isinstance(_arg(a, kw, 1, "dims"), int) else \
            _arg(a, kw, 1, "dims")
        perm = [int(d) % nd for d in dims]
    elif name in ("movedim", "moveaxis"):
        src, dst = _arg(a, kw, 1, "source"), _arg(a, kw, 2, "destination")
        src, dst = ([s] if isinstance(s, int) else list(s) for s in (src, dst))
        src = [s % nd for s in src]
        dst = [d % nd for d in dst]
        rest = [i for i in range(nd) if i not in src]
        perm = [None] * nd
        for s, d in zip(src, dst):
            perm[d] = s
        it = iter(rest)
        perm = [p if p is not None else next(it) for p in perm]
    else:  # t(), .T, .mT
        if name == "__get__:mT":
            perm[-1], perm[-2] = perm[-2], perm[-1]
        else:
            perm = perm[::-1]
    n = ex._node("Transpose", [ex.name_of(x)], out)
    _attr_ints(n, "perm", perm)


def _expand(ex, node, a, kw, out, outs):
    # no Expand in the JAX package's runtime: broadcast by adding zeros
    shape = tuple(node.outs[0].tensor.shape)
    zeros = ex.const(np.zeros(shape, np.float32))
    ex._node("Add", [ex.name_of(a[0]), zeros], out)


def _concat(ex, node, a, kw, out, outs):
    ts = a[0]
    axis = _arg(a, kw, 1, "dim", 0) % node.outs[0].tensor.dim()
    n = ex._node("Concat", [ex.operand(t) for t in ts], out)
    _attr_int(n, "axis", axis)


def _topk(ex, node, a, kw, out, outs):
    x = a[0]
    k = int(_arg(a, kw, 1, "k"))
    axis = _arg(a, kw, 2, "dim", -1) % x.tensor.dim()
    if not _arg(a, kw, 3, "largest", True):
        raise ValueError("op topk with largest=False has no ONNX mapping")
    kn = ex.init(f"{out}_k", np.asarray([k], np.int64))
    n = ex._node("TopK", [ex.name_of(x), kn], outs if len(outs) == 2 else [out, f"{out}_idx"])
    _attr_int(n, "axis", axis)


_CASTS = {torch.float32: 1, torch.int32: 6, torch.int64: 7, torch.bool: 9,
          torch.float16: 10, torch.float64: 11, torch.bfloat16: 16}


def _cast(ex, node, a, kw, out, outs):
    x = a[0]
    src, dst = x.tensor.dtype, node.outs[0].tensor.dtype
    if src == dst:
        ex._node("Identity", [ex.name_of(x)], out)
        return
    n = ex._node("Cast", [ex.name_of(x)], out)
    _attr_int(n, "to", _CASTS[dst])


def _getitem(ex, node, a, kw, out, outs):
    x, key = a[0], a[1]
    if isinstance(key, _Val):
        if key.tensor.dtype in (torch.int32, torch.int64):
            # integer-array index: Gather along axis 0 (the Embedding lookup)
            n = ex._node("Gather", [ex.name_of(x), ex.name_of(key)], out)
            _attr_int(n, "axis", 0)
            return
        raise ValueError("a boolean-mask index has no ONNX mapping")
    keys = key if isinstance(key, tuple) else (key,)
    if not all(k is None or k is Ellipsis or type(k) in (int, slice) for k in keys):
        raise ValueError(f"index {key!r} has no ONNX mapping (integer-array gather and "
                         "static slices are supported)")
    nd = x.tensor.dim()
    used = sum(1 for k in keys if k is not None and k is not Ellipsis)
    full = []
    for k in keys:
        if k is Ellipsis:
            full.extend([slice(None)] * (nd - used))
        elif k is not None:
            full.append(k)
    full.extend([slice(None)] * (nd - len(full)))
    starts, ends, axes = [], [], []
    for ax, k in enumerate(full):
        if isinstance(k, int):
            starts.append(k)
            ends.append(k + 1 if k != -1 else _INT64_MAX)
            axes.append(ax)
        elif k != slice(None):
            if k.step not in (None, 1):
                raise ValueError(f"a slice step of {k.step} has no ONNX mapping")
            starts.append(0 if k.start is None else int(k.start))
            ends.append(_INT64_MAX if k.stop is None else int(k.stop))
            axes.append(ax)
    src = ex.name_of(x)
    out_shape = tuple(node.outs[0].tensor.shape)
    plain = not any(isinstance(k, int) for k in full) and None not in keys
    if axes:
        sl = out if plain else f"{out}_sl"
        names = [ex.init(f"slice_{tag}_{sl}", np.asarray(vals, np.int64))
                 for tag, vals in (("starts", starts), ("ends", ends), ("axes", axes))]
        ex._node("Slice", [src] + names, sl)
        src = sl
    if not plain:
        ex.reshape(src, x, out_shape, out)
    elif not axes:
        ex._node("Identity", [src], out)


def _conv2d(ex, node, a, kw, out, outs):
    x, w = a[0], a[1]
    b = _arg(a, kw, 2, "bias")
    stride = _pair(_arg(a, kw, 3, "stride", 1))
    padding = _arg(a, kw, 4, "padding", 0)
    dilation = _pair(_arg(a, kw, 5, "dilation", 1))
    groups = _arg(a, kw, 6, "groups", 1)
    if isinstance(padding, str) or any(d != 1 for d in dilation):
        raise ValueError("conv2d with string padding or dilation has no ONNX mapping")
    inputs = [ex.name_of(x), ex.operand(w)]
    if b is not None:
        inputs.append(ex.operand(b))
    n = ex._node("Conv", inputs, out)
    _attr_ints(n, "kernel_shape", w.tensor.shape[2:4])
    _attr_ints(n, "strides", stride)
    ph, pw = _pair(padding)
    _attr_ints(n, "pads", (ph, pw, ph, pw))
    _attr_int(n, "group", groups)


def _pool(ex, node, a, kw, out, outs):
    is_max = _name(node.func) == "max_pool2d"
    k = _pair(_arg(a, kw, 1, "kernel_size"))
    s = _arg(a, kw, 2, "stride")
    s = _pair(s) if s not in (None, ()) else k
    p = _pair(_arg(a, kw, 3, "padding", 0))
    if _arg(a, kw, 5 if is_max else 4, "ceil_mode", False):
        raise ValueError("pooling with ceil_mode has no ONNX mapping")
    if is_max and (_pair(_arg(a, kw, 4, "dilation", 1)) != (1, 1) or
                   _arg(a, kw, 6, "return_indices", False)):
        raise ValueError("max_pool2d with dilation or indices has no ONNX mapping")
    if not is_max and (not _arg(a, kw, 5, "count_include_pad", True) or
                       _arg(a, kw, 6, "divisor_override") is not None):
        raise ValueError("avg_pool2d that excludes the padding has no ONNX mapping")
    n = ex._node("MaxPool" if is_max else "AveragePool", [ex.name_of(a[0])], out)
    _attr_ints(n, "kernel_shape", k)
    _attr_ints(n, "strides", s)
    _attr_ints(n, "pads", (p[0], p[1], p[0], p[1]))
    if not is_max:
        _attr_int(n, "count_include_pad", 1)  # divides by the whole window, as the port's


def _batch_norm(ex, node, a, kw, out, outs):
    if _arg(a, kw, 5, "training", False):
        raise ValueError("train-mode BatchNorm in an export trace — call model.eval() before "
                         "export")
    raise ValueError("op batch_norm has no ONNX mapping (eval-mode BatchNorm exports as "
                     "nn.functional.batch_norm_eval's chain)")


def _identity(ex, node, a, kw, out, outs):
    ex._node("Identity", [ex.name_of(a[0])], out)


_EMITTERS = {}
for _n in _BINARY:
    _EMITTERS[_n] = _binary
for _n in ("maximum", "minimum", "fmax", "fmin", "max", "min"):
    _EMITTERS[_n] = _max_min
for _n in _UNARY:
    _EMITTERS[_n] = _unary
for _n in ("neg", "__neg__", "negative"):
    _EMITTERS[_n] = _neg
for _n in ("mean", "sum", "amax", "amin"):
    _EMITTERS[_n] = _reduce
for _n in ("reshape", "view", "flatten", "unsqueeze", "squeeze", "unflatten", "view_as",
           "reshape_as", "ravel"):
    _EMITTERS[_n] = _reshape_like
for _n in ("transpose", "swapaxes", "swapdims", "permute", "t", "movedim", "moveaxis",
           "__get__:T", "__get__:mT"):
    _EMITTERS[_n] = _transpose
for _n in ("expand", "expand_as", "broadcast_to"):
    _EMITTERS[_n] = _expand
for _n in ("cat", "concat", "concatenate"):
    _EMITTERS[_n] = _concat
for _n in ("to", "float", "double", "half", "bfloat16", "int", "long", "bool", "type_as"):
    _EMITTERS[_n] = _cast
for _n in ("as_tensor", "asarray"):
    _EMITTERS[_n] = _cast
for _n in ("detach", "contiguous", "clone", "alias", "__get__:data"):
    _EMITTERS[_n] = _identity
_EMITTERS.update({
    "silu": _silu, "gelu": _gelu, "topk": _topk, "__getitem__": _getitem,
    "conv2d": _conv2d, "max_pool2d": _pool, "avg_pool2d": _pool, "batch_norm": _batch_norm,
})


def _write(tracer: _Tracer, out: _Val, path: str, batch_dynamic: bool) -> None:
    ex = _Exporter(tracer, batch_dynamic)
    out_name = ex.name_of(out)
    x = tracer.input.tensor
    in_type = pb.TensorProto.INT32 if not x.is_floating_point() else pb.TensorProto.FLOAT
    ex.graph.input.append(_value_info("input", x.shape, batch_dynamic, elem_type=in_type))
    ex.graph.output.append(_value_info(out_name, out.tensor.shape, batch_dynamic))
    m = pb.ModelProto()
    m.ir_version = 8
    m.producer_name = "deepflows_tpu"
    m.producer_version = "0.2"
    m.opset_import.add().version = OPSET
    m.graph.CopyFrom(ex.graph)
    with open(path, "wb") as f:
        f.write(m.SerializeToString())


def export_onnx(model, sample_input, path: str, batch_dynamic: bool = True) -> str:
    """Export ``model``'s inference graph, traced on ``sample_input`` on the
    model's device, to an ONNX file at ``path``; returns ``path``.

    The first dimension of the graph input and output is the dynamic
    ``"N"`` (``batch_dynamic=False`` pins the sample's batch size)."""
    tracer, _, out = trace(model, sample_input)
    _write(tracer, out, path, batch_dynamic)
    return path
