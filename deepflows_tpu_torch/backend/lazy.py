"""Lazy mode (counterpart of ``deepflows_tpu/backend/lazy.py``): the eager
tape's torch calls record into a fragment instead of running, the fragment
runs at the first host readback, and a repeated step replays as one CUDA
graph, with no change to user code.

Enable with ``deepflows_tpu_torch.lazy.enable()`` (or ``DEEPFLOWS_LAZY=1``
at import); ``disable()`` runs what is pending and restores eager calls.

Recording.  A ``torch.overrides.TorchFunctionMode`` sees every torch call
made while lazy mode is on: the tape's ops, the plain-tensor work of
``BackendTensor`` (``K.plain``), factories, the optimizers' arithmetic and
the parameter reads and writes.  ``Tensor.__torch_function__`` alone would
not do: it sees only calls with a tape ``Tensor`` among their arguments,
and much of a step runs on plain tensors that read what a tape op writes
(``nn.functional.batch_norm`` makes its scratch statistics with
``torch.zeros``, has torch's batch norm write into them, then scales the
variance; ``BatchNorm``'s running statistics then read them).  Deferring
one kind of call while the other ran at once would update the running
statistics from zeros.  So every call that reads or writes tensor data is
recorded, in program order; what runs at once is only what reads no data:

- metadata (``shape``, ``dtype``, ``device``, ``stride``, ``dim()``,
  ``requires_grad`` ...), answered from the placeholder without a flush;
- views of tensors that are already computed (``detach``, ``view``,
  ``permute`` ...) and tensors made from host data (``torch.tensor``, a
  batch made by ``Tensor(x, device=...)``).

Each recorded call is a node; its results are placeholders (``LazyTensor``,
``LazyTapeTensor`` where eager code would have made a tape ``Tensor``):
tensor subclasses with the result's shape, strides, dtype, device and
``requires_grad`` and no storage, so they hold no device memory until
their fragment runs.  Output metadata is inferred on meta tensors and
cached per (function, static structure, input metadata); the key holds no
fragment positions (BENCH_NOTES.md's ``_aval_cache`` note), so a
multi-step fragment does not miss at every step.

A flush runs at every host readback (``numpy()``, ``item()``, ``float()``,
``int()``, ``bool()``, ``__array__``, ``repr``, a ``.grad`` read while a
recorded backward may still write it, a device-to-host copy, ``state_dict()``)
and at no other call; also at ``MAX_NODES`` nodes
(``DEEPFLOWS_LAZY_MAX_NODES``) and at the end of ``optimizer.step()``.  A
call whose output shape depends on the data (boolean-mask indexing) or
cannot be inferred flushes, runs alone and counts ``eager_fallback_ops``.

Three calls record as one node each: ``Tensor.backward`` (the loss's
backward walk), an autograd ``Function`` through ``tensor.function_apply``
(the kernel routes: its launch happens when the node runs, never while the
shape is inferred, where the wrapper takes its plain twin on meta
tensors), and ``optimizer.step()`` (the whole update, ``lr`` an input, the
new parameter values and slots written back in place).

Structural replay.  A flushed fragment becomes a template; the next step's
calls are matched against the template's cursor by identity and static
comparisons, with no shape inference, and a mismatch turns the matched
prefix back into a normal fragment (``fast_fallbacks``).  Up to
``DEEPFLOWS_LAZY_TEMPLATES`` (4) templates are kept, most recently used
first.

Running.  On the CPU a fragment's nodes run in order.  On the card, a
template's first flush runs its nodes in order; the next flush that
matches it goes through ``jit.StepGraphs.run``, whose warm-up is the step
itself and whose capture is the graph later matches replay.  The graph
reads an input where it lies only if it lies where the template's
reference input lies, which is kept alive (the parameters, the optimizer's
slots, the running statistics, views of them); it reads every other input
(a batch, a slice of a dataset held on the card) from a tensor of its own,
which a replay fills from the step's input.  So a replay never writes into
a tensor the user holds.  If state the graph reads moves, the template is
captured anew.  A replay rebinds the ``.grad`` of every leaf the backward
reached, and copies the live results out (a loss held from step i keeps
step i's value).  The package generators the nodes draw from are
registered with the graph.  A fragment that cannot be captured (a CPU
input, a result that still needs its autograd graph, a new input that
needs a gradient or that the step writes in place, a capture that fails)
runs its nodes in order and counts ``eager_fallback_fragments``.

Python scalars are inputs of the fragment: a Python number beside a tensor
in add, sub, mul, div, rsub, their in-place forms, ``full`` and
``fill_``, and the optimizer's ``lr``.  The nodes run with the number
itself; a captured graph reads it from a 0-d tensor on the card, written
before each replay.  A tape op's number lies in the operand's dtype (a
division by a number is a product with its reciprocal there, as torch's
CUDA division by a number computes it): in f32 both give the same bits, a
bf16 operand takes the number rounded to bf16 in a graph (the JAX
package's bf16 purity), where eager torch keeps it in f32.  The
optimizer's ``lr`` is a ``_Number``, an f64 tensor that computes as the
Python number does, so a replayed update is the eager update's bits in
every dtype.  A changing learning rate therefore neither changes the
signature nor is frozen into a graph.

Counters (``lazy_stats()``, the JAX package's keys): ``nodes`` recorded,
``flushes``, ``compiles`` (runners built: a CUDA-graph capture on the card,
a promoted template on the CPU), ``eager_fallback_ops``,
``eager_fallback_fragments``, ``fast_ops``, ``fast_flushes`` and
``fast_fallbacks``.
"""

from __future__ import annotations

import contextlib
import functools
import gc
import itertools
import os
import threading
import weakref
from collections import namedtuple

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

__all__ = [
    "LazyTensor",
    "enable",
    "disable",
    "eager",
    "enabled",
    "force",
    "flush",
    "mark_step",
    "paused",
    "captured",
    "record_call",
    "lazy_stats",
]

MAX_NODES = int(os.environ.get("DEEPFLOWS_LAZY_MAX_NODES", "8192"))
_MAX_TEMPLATES = int(os.environ.get("DEEPFLOWS_LAZY_TEMPLATES", "4"))

_Ref = namedtuple("_Ref", ["node", "pos"])  # output `pos` of fragment node `node`
_Leaf = namedtuple("_Leaf", ["idx"])  # fragment input `idx`, a tensor
_Scalar = namedtuple("_Scalar", ["idx"])  # fragment input `idx`, a Python number

_LOCK = threading.RLock()
_NoTF = torch._C.DisableTorchFunction
_mode_enabled = torch._C._is_torch_function_mode_enabled
_Base = torch._C.TensorBase

_stats = {"nodes": 0, "flushes": 0, "compiles": 0, "eager_fallback_ops": 0,
          "eager_fallback_fragments": 0, "fast_ops": 0, "fast_flushes": 0,
          "fast_fallbacks": 0}


def lazy_stats() -> dict:
    """The counters, cumulative since import."""
    return dict(_stats)


# ------------------------------------------------------------------ placeholders
def _values(obj):
    """``obj`` with every placeholder replaced by its value (flushing what is
    pending first), through lists, tuples and dicts."""
    if isinstance(obj, LazyTensor):
        return obj.force()
    if type(obj) in (list, tuple):
        return type(obj)(_values(o) for o in obj)
    if type(obj) is dict:
        return {k: _values(v) for k, v in obj.items()}
    return obj


class LazyTensor(torch.Tensor):
    """A recorded call's pending result: the shape, strides, dtype, device
    and ``requires_grad`` of the tensor it stands for, and no storage until
    its fragment runs.  Once computed it stands for its value; outside lazy
    mode every torch call on it runs on that value."""

    _lazy = True

    @staticmethod
    def _make(cls, meta, node, pos):
        shape, stride, dtype, device, rg = meta[:5]
        t = torch.Tensor._make_wrapper_subclass(
            cls, shape, strides=stride, dtype=dtype, device=device, requires_grad=rg)
        t._node, t._pos, t._value = node, pos, None
        _placeholders.add(t)
        return t

    def force(self):
        """The value, flushing the pending fragment if need be."""
        if self._value is None:
            flush()
            if self._value is None:
                raise RuntimeError("a lazy placeholder did not get its value at the flush")
        return self._value

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        return func(*_values(args), **_values(kwargs or {}))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        return func(*_values(args), **_values(kwargs or {}))


_placeholders = weakref.WeakSet()
_tape_classes = {}


def _placeholder_class(tape: bool):
    """``LazyTensor``, or its subclass that is also a tape ``Tensor``."""
    if not tape:
        return LazyTensor
    cls = _tape_classes.get(True)
    if cls is None:
        from ..tensor import Tensor

        cls = _tape_classes[True] = type("LazyTapeTensor", (LazyTensor, Tensor), {
            "__module__": __name__,
            "__doc__": "A pending result that eager code would have made a tape Tensor."})
    return cls


class _PendingFn:
    """What ``grad_fn`` reads on a pending result that requires grad: not
    None, as the eager result's node is not."""

    def __repr__(self):
        return "<pending lazy node>"


_PENDING_FN = _PendingFn()


def force(x):
    """``x``'s value if it is a placeholder; ``x`` otherwise."""
    return x.force() if isinstance(x, LazyTensor) else x


# ------------------------------------------------------------------ fragments
class _Node:
    __slots__ = ("fn", "args_proto", "kwargs_proto", "out_refs", "out_meta", "spec",
                 "aliases", "grad", "tape", "kind", "scalar_dtypes", "_idx")

    def __init__(self, fn, args_proto, kwargs_proto, grad, tape, kind):
        self.fn = fn
        self.args_proto = args_proto
        self.kwargs_proto = kwargs_proto
        self.out_refs = ()
        self.out_meta = ()
        self.spec = None
        self.aliases = {}  # output -> the argument an in-place call hands back
        self.grad = grad
        self.tape = tape
        self.kind = kind
        self.scalar_dtypes = None  # {scalar slot: dtype of its 0-d tensor in a graph}
        self._idx = -1


class _Fragment:
    __slots__ = ("nodes", "leaves", "leaf_ids", "leaf_meta", "scalars", "sig", "grad_writers")

    def __init__(self):
        self.nodes = []
        self.leaves = []  # concrete tensors, in first-encounter order
        self.leaf_ids = {}
        self.leaf_meta = []
        self.scalars = []  # Python numbers
        self.sig = []
        self.grad_writers = 0  # recorded nodes that write .grad (backward)

    def leaf_index(self, t):
        key = id(t)
        idx = self.leaf_ids.get(key)
        if idx is None:
            idx = len(self.leaves)
            self.leaves.append(t)
            self.leaf_meta.append(_meta_of(t))
            self.leaf_ids[key] = idx
        return idx


def _meta_of(t):
    """(shape, stride, dtype, device, requires_grad, is_leaf, class) of a
    concrete tensor; called with torch function off."""
    return (t.shape, t.stride(), t.dtype, t.device, t.requires_grad, t.grad_fn is None,
            type(t))


_frag = _Fragment()
_aval_cache = {}  # (fn, stripped skeleton, input metadata, grad) -> inferred outputs


# ------------------------------------------------------------------ templates
class _Template:
    """A flushed fragment promoted to a step structure: its nodes (protos
    refer to one another by identity), the per-slot leaf metadata, the
    signature, and on the card its captured graphs by live-output set."""

    __slots__ = ("nodes", "sig", "leaf_meta", "scalar_types", "graphs", "cuda", "eager_only",
                 "free_at", "generators", "ref_leaves", "__weakref__")

    def __init__(self, frag):
        self.nodes = frag.nodes
        self.sig = frag.sig
        self.leaf_meta = frag.leaf_meta
        self.scalar_types = [type(v) for v in frag.scalars]
        self.graphs = {}
        self.cuda = _on_cuda(frag)
        self.eager_only = False
        self.free_at = None
        self.generators = None
        # on the card, the inputs a capture is compared with (``_direct``):
        # the promoting run's, kept alive until then, later the last graph's
        self.ref_leaves = list(frag.leaves) if self.cuda else None


class _FastState:
    """One step being matched against a template."""

    __slots__ = ("tpl", "cursor", "leaves", "scalars", "outs", "grad_writers")

    def __init__(self, tpl):
        self.tpl = tpl
        self.cursor = 0
        self.leaves = []
        self.scalars = []
        self.outs = []  # per matched node: tuple of weakrefs to its placeholders
        self.grad_writers = 0


_templates = []  # most recently used first
_fast = None
_MISS = object()
_graphs = None  # jit.StepGraphs, made at the first capture
_serial = itertools.count()  # its keys


# ------------------------------------------------------------------ the recorder
class _Recorder(TorchFunctionMode):
    def __torch_function__(self, func, types, args=(), kwargs=None):
        return _on_call(func, types, args, kwargs or {})


_mode = None


def enabled() -> bool:
    return _mode is not None


def recording() -> bool:
    """True where a torch call made now would be recorded: lazy mode on,
    and neither inside the recorder's own work nor ``paused()``."""
    return _mode is not None and _mode_enabled()


def _tape_involved(types) -> bool:
    from ..tensor import Tensor

    return any(issubclass(t, Tensor) for t in types)


def _has_pending(obj) -> bool:
    if isinstance(obj, LazyTensor):
        return obj._value is None
    if type(obj) in (list, tuple):
        return any(_has_pending(o) for o in obj)
    if type(obj) is dict:
        return any(_has_pending(o) for o in obj.values())
    return False


def _eager(func, args, kwargs):
    """Run ``func`` now on the values, as eager code would."""
    if _has_pending(args) or _has_pending(kwargs):
        flush()
    return func(*_values(args), **_values(kwargs))


def _pending_work() -> bool:
    fast = _fast
    return bool(_frag.nodes) or (fast is not None and fast.cursor > 0)


def _grads_pending() -> bool:
    fast = _fast
    return _frag.grad_writers > 0 or (fast is not None and fast.grad_writers > 0)


def _meta_call(func, args, kwargs):
    x = args[0] if args else None
    if isinstance(x, LazyTensor):
        if x._value is not None:
            with _NoTF():
                return func(x._value, *args[1:], **kwargs)
        name = _attr_name(func)
        if name == "grad_fn":
            with _NoTF():
                return _PENDING_FN if x.requires_grad else None
        if name == "is_leaf":
            with _NoTF():
                return not x.requires_grad
        if name == "_base":
            return None
    with _NoTF():
        return func(*args, **kwargs)


def _on_call(func, types, args, kwargs):
    kind = _KINDS.get(func)
    if kind is None:
        kind = _KINDS[func] = _classify(func)
    if kind == "to":
        moved = _moves(func, args, kwargs)
        if moved == "same":
            return args[0]
        kind = "read" if moved else "record"  # a copy between devices reads its source now
    if kind == "meta":
        return _meta_call(func, args, kwargs)
    if kind in ("read", "state") or (kind == "data_set" and not _same_view(*args)):
        if _pending_work():
            flush()
        return _eager(func, args, kwargs)
    if kind == "data_set":
        return _eager(func, args, kwargs)
    if kind == "grad_get":
        x = args[0]
        if isinstance(x, LazyTensor):
            return None if x._value is None else func(x._value)  # a pending result has none
        if _grads_pending():
            flush()
        with _NoTF():
            return func(x)
    if kind == "grad_set":
        if _grads_pending() or _has_pending(args):
            flush()
        with _NoTF():
            return func(*_values(args))
    if kind == "backward":
        record_call(_backward_node, tuple(args), kwargs, kind="bwd")
        return None
    if kind == "view" and not _has_pending(args) and _basic_key(func, args):
        return func(*_values(args), **_values(kwargs))
    if kind == "host" and not _has_pending(args) and not _has_pending(kwargs):
        return func(*args, **kwargs)
    if kind == "record" and not _any_tensor(args) and not _any_tensor(kwargs):
        return func(*args, **kwargs)  # no tensor in, none made: torch.device, a mode switch
    return _record(func, args, kwargs, _tape_involved(types))


def _same_view(target, value) -> bool:
    """``target.data = value`` with ``value`` a view of ``target``'s own
    values (``w.data -= g`` writes through ``w.data`` and sets it back): a
    no-op on the data, which needs no flush."""
    if isinstance(target, LazyTensor) or isinstance(value, LazyTensor) or \
            not isinstance(value, torch.Tensor):
        return False
    with _NoTF():
        return (value.data_ptr() == target.data_ptr() and value.shape == target.shape
                and value.stride() == target.stride() and value.dtype == target.dtype)


def _any_tensor(obj) -> bool:
    if isinstance(obj, torch.Tensor):
        return True
    t = type(obj)
    if t is list or t is tuple:
        return any(_any_tensor(o) for o in obj)
    if t is dict:
        return any(_any_tensor(o) for o in obj.values())
    return False


def _attr_name(func):
    return getattr(getattr(func, "__self__", None), "__name__", "")


def _basic_key(func, args):
    """A view call on computed tensors runs at once; ``x[key]`` only with a
    key of ints, slices, None and Ellipsis (other keys copy)."""
    if getattr(func, "__name__", "") != "__getitem__":
        return True
    key = args[1] if len(args) > 1 else None
    keys = key if type(key) is tuple else (key,)
    return all(k is None or k is Ellipsis or type(k) in (int, slice) for k in keys)


def _moves(func, args, kwargs):
    """"d2h", "h2d" or None for a ``to`` / ``cpu`` / ``cuda`` call."""
    x = args[0] if args else None
    if not isinstance(x, torch.Tensor):
        return None
    with _NoTF():
        src = x.device
    name = getattr(func, "__name__", "")
    if name in ("cpu", "cuda"):
        if src.type == name and len(args) == 1 and not kwargs:
            return "same"
        dst = torch.device(name)
    elif name == "to":
        try:
            dst, dtype, _, fmt = torch._C._nn._parse_to(*args[1:], **kwargs)
        except Exception:
            return None
        with _NoTF():
            same_dtype = dtype is None or dtype == x.dtype
        if (dst is None or dst == src or (dst.type == src.type and dst.index is None)) and \
                same_dtype and fmt is None and not kwargs.get("copy", False):
            return "same"  # torch hands x itself back
    else:
        return None
    if dst is None or dst.type == src.type:
        return None
    return "d2h" if dst.type == "cpu" else "h2d"


_META_FUNCS = frozenset((
    "dim", "ndimension", "size", "stride", "numel", "nelement", "element_size",
    "is_floating_point", "is_complex", "is_signed", "is_contiguous", "is_pinned",
    "is_shared", "is_inference", "get_device", "storage_offset", "__len__", "__hash__",
    "is_same_size", "dim_order", "_is_view", "is_neg", "is_conj", "has_names",
    "__dir__", "__sizeof__"))
_META_ATTRS = frozenset((
    "shape", "dtype", "device", "requires_grad", "is_leaf", "grad_fn", "ndim", "is_cuda",
    "is_cpu", "is_meta", "is_sparse", "is_quantized", "is_mkldnn", "is_nested", "layout",
    "names", "itemsize", "nbytes", "_version", "output_nr", "_base", "is_xpu", "is_mps",
    "is_ipu", "is_vulkan", "is_sparse_csr", "is_mtia", "is_maia", "_backward_hooks",
    "_post_accumulate_grad_hooks", "retains_grad", "_grad_fn", "_cdata", "is_xla",
    "is_hpu", "is_lazy"))
_READ_FUNCS = frozenset((
    "item", "tolist", "numpy", "__bool__", "__float__", "__int__", "__index__",
    "__complex__", "__array__", "__array_wrap__", "__repr__", "__str__", "__format__",
    "__reduce_ex__", "__reduce__", "__getstate__", "__deepcopy__", "__copy__", "data_ptr",
    "untyped_storage", "storage", "_typed_storage", "equal", "allclose", "is_nonzero",
    "is_set_to", "__iter__", "__contains__", "__dlpack__", "__dlpack_device__",
    "pin_memory", "tobytes", "__reversed__"))
_STATE_FUNCS = frozenset((
    "requires_grad_", "retain_grad", "register_hook", "register_post_accumulate_grad_hook",
    "share_memory_", "set_", "resize_", "resize_as_", "as_strided_", "t_", "transpose_",
    "squeeze_", "unsqueeze_", "swapdims_", "swapaxes_", "detach_", "__setstate__",
    "_fix_weakref", "record_stream"))
_VIEW_FUNCS = frozenset((
    "detach", "view", "view_as", "t", "permute", "transpose", "swapaxes", "swapdims",
    "expand", "expand_as", "unsqueeze", "squeeze", "narrow", "select", "as_strided",
    "alias", "unflatten", "movedim", "moveaxis", "unbind", "split", "chunk",
    "__getitem__"))
_HOST_FUNCS = frozenset((
    "tensor", "as_tensor", "asarray", "from_numpy", "new_tensor", "frombuffer",
    "scalar_tensor", "new"))

_FACTORIES = frozenset((
    "zeros", "ones", "empty", "full", "rand", "randn", "randint", "randperm", "arange",
    "range", "eye", "linspace", "logspace", "empty_strided", "normal", "bartlett_window",
    "hann_window", "hamming_window", "blackman_window", "kaiser_window", "tril_indices",
    "triu_indices", "zeros_like", "ones_like", "empty_like", "full_like", "rand_like",
    "randn_like", "randint_like"))

_KINDS = {}


def _classify(func):
    name = getattr(func, "__name__", "")
    if name in ("__get__", "__set__", "__delete__"):
        attr = _attr_name(func)
        if name == "__get__":
            if attr in ("grad", "_grad"):
                return "grad_get"
            if attr == "data":
                return "view"
            if attr in _META_ATTRS:
                return "meta"
            if attr in ("T", "mT", "H", "mH", "real", "imag"):
                return "record"
            return "read"
        if attr in ("grad", "_grad"):
            return "grad_set"
        if attr == "data":
            return "data_set"
        return "state"
    if func is torch.Tensor.backward:
        return "backward"
    if name in _META_FUNCS:
        return "meta"
    if name == "type":
        return "state"
    if name in _READ_FUNCS:
        return "read"
    if name in _STATE_FUNCS:
        return "state"
    if name in _VIEW_FUNCS:
        return "view"
    if name in _HOST_FUNCS:
        return "host"
    if name in ("to", "cpu", "cuda"):
        return "to"
    if name in _FACTORIES:
        return "factory"
    return "record"


# Python numbers that become fragment inputs: the function names, and the
# argument positions (or keyword) where a number is an operand
_SCALAR_OPS = {
    "add": (1, "other"), "sub": (1, "other"), "mul": (1, "other"), "div": (1, "other"),
    "true_divide": (1, "other"), "rsub": (1, "other"), "add_": (1, "other"),
    "sub_": (1, "other"), "mul_": (1, "other"), "div_": (1, "other"),
    "__add__": (1, None), "__radd__": (1, None), "__sub__": (1, None),
    "__rsub__": (1, None), "__mul__": (1, None), "__rmul__": (1, None),
    "__truediv__": (1, None), "__rtruediv__": (1, None), "__rdiv__": (1, None),
    "__div__": (1, None), "__iadd__": (1, None), "__isub__": (1, None),
    "__imul__": (1, None), "__itruediv__": (1, None), "__idiv__": (1, None),
    "full": (1, "fill_value"), "fill_": (1, "value"),
}
_DIVISIONS = {"div": torch.mul, "true_divide": torch.mul, "__truediv__": torch.mul,
              "__div__": torch.mul, "div_": torch.Tensor.mul_, "__itruediv__": torch.Tensor.mul_,
              "__idiv__": torch.Tensor.mul_}


def _scalar_slot(func, args, kwargs):
    """(position, keyword) of a Python number operand of ``func``, or None."""
    name = getattr(func, "__name__", "")
    where = _SCALAR_OPS.get(name)
    if where is None or "rounding_mode" in kwargs:
        return None
    pos, kw = where
    if len(args) > pos:
        v = args[pos]
        return (pos, None) if type(v) in (int, float) else None
    if kw is not None and kw in kwargs and type(kwargs[kw]) in (int, float):
        return (None, kw)
    return None


# ------------------------------------------------------------------ traversal
def _walk(obj, frag, skel, meta_sig):
    """(proto, skeleton) of one argument: tensors become _Ref / _Leaf,
    everything else is static."""
    if isinstance(obj, torch.Tensor):
        if isinstance(obj, LazyTensor):
            if obj._value is None:
                node, pos = obj._node, obj._pos
                skel.append(("n", node._idx, pos))
                meta_sig.append(node.out_meta[pos])
                return _Ref(node, pos)
            obj = obj._value
        li = frag.leaf_index(obj)
        skel.append(("l", li))
        meta_sig.append(frag.leaf_meta[li])
        return _Leaf(li)
    t = type(obj)
    if t is list or t is tuple:
        sub = []
        proto = [_walk(o, frag, sub, meta_sig) for o in obj]
        skel.append((t.__name__, tuple(sub)))
        return tuple(proto) if t is tuple else proto
    if t is dict:
        sub = []
        proto = {}
        for k in obj:
            sub.append(("k", k))
            proto[k] = _walk(obj[k], frag, sub, meta_sig)
        skel.append(("dict", tuple(sub)))
        return proto
    skel.append(("s", _static_key(obj)))
    return obj


_uncached = [False]  # the call's key holds an object's identity, not its value


def _static_key(obj):
    try:
        hash(obj)
        return obj
    except TypeError:
        if isinstance(obj, slice):
            return ("slice", obj.start, obj.stop, obj.step)
        _uncached[0] = True
        return ("id", id(obj))


_T = ("t",)


def _strip(skel):
    """A skeleton without fragment positions: the shape-inference key."""
    out = []
    for s in skel:
        tag = s[0]
        if tag in ("n", "l"):
            out.append(_T)
        elif tag in ("list", "tuple", "dict") and isinstance(s[1], tuple):
            out.append((tag, _strip(s[1])))
        else:
            out.append(s)
    return tuple(out)


def _rebuild(proto, leaves, scalars, vals):
    tp = type(proto)
    if tp is _Leaf:
        return leaves[proto.idx]
    if tp is _Ref:
        return vals[id(proto.node)][proto.pos]
    if tp is _Scalar:
        return scalars[proto.idx]
    if tp is list:
        return [_rebuild(p, leaves, scalars, vals) for p in proto]
    if tp is tuple:
        return tuple(_rebuild(p, leaves, scalars, vals) for p in proto)
    if tp is dict:
        return {k: _rebuild(v, leaves, scalars, vals) for k, v in proto.items()}
    return proto


def _refs_in(proto, out):
    tp = type(proto)
    if tp is _Ref:
        out.append(proto.node)
    elif tp is list or tp is tuple:
        for p in proto:
            _refs_in(p, out)
    elif tp is dict:
        for p in proto.values():
            _refs_in(p, out)


# ------------------------------------------------------------------ outputs
def _flatten(out, flat):
    """A spec of ``out`` with its tensors appended to ``flat``."""
    if isinstance(out, torch.Tensor):
        flat.append(out)
        return ("t", len(flat) - 1)
    t = type(out)
    if t is tuple or t is list or (isinstance(out, tuple) and hasattr(out, "n_fields")):
        return ("seq", t, tuple(_flatten(o, flat) for o in out))
    if out is None:
        return ("s", None)
    return ("x", out)  # not a tensor: the call must run eagerly


def _unflatten(spec, flat):
    tag = spec[0]
    if tag == "t":
        return flat[spec[1]]
    if tag == "seq":
        items = [_unflatten(s, flat) for s in spec[2]]
        t = spec[1]
        return items if t is list else (tuple(items) if t is tuple else t(items))
    return spec[1]


def _spec_has_values(spec):
    if spec[0] == "x":
        return True
    if spec[0] == "seq":
        return any(_spec_has_values(s) for s in spec[2])
    return False


# ------------------------------------------------------------------ shape inference
def _meta_tensor(meta):
    shape, stride, dtype, _, rg, is_leaf = meta[:6]
    t = torch.empty_strided(shape, stride, dtype=dtype, device="meta")
    if rg:
        t.requires_grad_(True)
        if not is_leaf:
            t = t.view_as(t)  # a non-leaf, as the result it stands for is
    return t


def _meta_args(proto, frag):
    tp = type(proto)
    if tp is _Leaf:
        return _meta_tensor(frag.leaf_meta[proto.idx])
    if tp is _Ref:
        return _meta_tensor(proto.node.out_meta[proto.pos])
    if tp is _Scalar:
        return frag.scalars[proto.idx]
    if tp is list:
        return [_meta_args(p, frag) for p in proto]
    if tp is tuple:
        return tuple(_meta_args(p, frag) for p in proto)
    if tp is dict:
        return {k: _meta_args(v, frag) for k, v in proto.items()}
    if isinstance(proto, torch.Generator):
        return None
    return proto


def _out_device(func, args_meta_sig, kwargs):
    """The device the call's results lie on: a ``device=`` argument, else
    the first non-CPU input's, else the CPU."""
    dev = kwargs.get("device")
    if dev is not None:
        dev = torch.device(dev)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    first = None
    for m in args_meta_sig:
        d = m[3]
        if first is None:
            first = d
        if d.type != "cpu":
            return d
    return first if first is not None else torch.device("cpu")


def _infer(func, args_proto, kw_proto, frag, grad, meta_sig):
    """(spec, out metadata, aliases) of ``func`` on meta stand-ins of its
    inputs: aliases maps an output to the argument an in-place call hands
    back."""
    m_args = tuple(_meta_args(a, frag) for a in args_proto)
    m_kw = {k: _meta_args(v, frag) for k, v in kw_proto.items()}
    if "device" in m_kw and m_kw["device"] is not None:
        m_kw["device"] = "meta"
    name = getattr(func, "__name__", "")
    if name == "to":
        dev, dt, nb, fmt = torch._C._nn._parse_to(*m_args[1:], **m_kw)
        kw = {} if fmt is None else {"memory_format": fmt}
        m_out_fn = (lambda x: x.to(dtype=dt or x.dtype, **kw))
        with _NoTF(), torch.set_grad_enabled(grad):
            out = m_out_fn(m_args[0])
        out_dev = meta_sig[0][3] if dev is None else dev
    else:
        with _NoTF(), torch.set_grad_enabled(grad):
            out = func(*m_args, **m_kw)
        out_dev = _out_device(func, meta_sig, kw_proto)
    flat = []
    spec = _flatten(out, flat)
    if _spec_has_values(spec):
        raise _NotTensorOutput()
    inputs = [(i, a) for i, a in enumerate(m_args)] + [(k, a) for k, a in m_kw.items()]
    metas, aliases = [], {}
    for j, o in enumerate(flat):
        for key, a in inputs:
            if o is a:
                aliases[j] = key
                break
        metas.append((o.shape, o.stride(), o.dtype, out_dev, o.requires_grad,
                      o.grad_fn is None))
    return spec, tuple(metas), aliases


class _NotTensorOutput(Exception):
    pass


_NO_OUTPUT = (("s", None), (), {})  # a node run for its effects


# ------------------------------------------------------------------ recording
def _record(func, args, kwargs, tape, kind="op", slot=None):
    from .. import autograd as _tape_grad

    grad = torch.is_grad_enabled() and (not tape or _tape_grad._grad_enabled)
    with _LOCK:
        fast = _fast
        if fast is not None:
            out = _fast_try(fast, func, args, kwargs, grad, tape)
            if out is not _MISS:
                return out
            _fast_leave(_fast)
        elif _frag.nodes:
            out = _template_start(func, args, kwargs, grad, tape)
            if out is not _MISS:
                return out
        return _record_slow(func, args, kwargs, grad, tape, kind, slot)


def _template_start(func, args, kwargs, grad, tape):
    """A call that starts a known template ends the fragment being
    recorded: it runs, and the call is matched from the template's start
    (as a step that recorded more calls than its template runs that
    template and matches on).  An eval pass before a training step so
    runs alone, and the step replays its graph."""
    global _fast
    for tpl in list(_templates):
        cand = _FastState(tpl)
        if _fast_match(cand, func, args, kwargs, grad, tape):
            _flush_locked()
            _fast = cand
            _touch_template(tpl)
            return _fast_emit(cand, args, kwargs)
    return _MISS


def _record_slow(func, args, kwargs, grad, tape, kind, slot):
    frag = _frag
    if kind == "op":
        slot = _scalar_slot(func, args, kwargs)
    skel, meta_sig = [], []
    _uncached[0] = False
    with _NoTF():
        args_proto = []
        for i, a in enumerate(args):
            if slot is not None and slot[0] == i:
                frag.scalars.append(a)
                args_proto.append(_Scalar(len(frag.scalars) - 1))
                skel.append(("c", type(a)))
            else:
                args_proto.append(_walk(a, frag, skel, meta_sig))
        args_proto = tuple(args_proto)
        kw_proto = {}
        for k in kwargs:
            skel.append(("kw", k))
            v = kwargs[k]
            if slot is not None and slot[1] == k:
                frag.scalars.append(v)
                kw_proto[k] = _Scalar(len(frag.scalars) - 1)
                skel.append(("c", type(v)))
            else:
                kw_proto[k] = _walk(v, frag, skel, meta_sig)
        skel_t = tuple(skel)
        key = (func, _strip(skel_t), tuple(meta_sig), grad)
        cached = _NO_OUTPUT if kind in ("opt", "bwd") else _aval_cache.get(key)
        if cached is None:
            try:
                cached = _infer(func, args_proto, kw_proto, frag, grad, meta_sig)
            except _NotTensorOutput:
                cached = "eager"
            except Exception:
                cached = "fallback"
            if not _uncached[0]:
                _aval_cache[key] = cached
    if isinstance(cached, str):
        if slot is not None:
            frag.scalars.pop()  # the call is not recorded (its leaves stay: harmless)
        if cached == "fallback":
            _stats["eager_fallback_ops"] += 1
        flush()
        return func(*_values(args), **_values(kwargs))
    spec, metas, aliases = cached
    node = _Node(func, args_proto, kw_proto, grad, tape, kind)
    node._idx = len(frag.nodes)
    node.spec = spec
    node.aliases = aliases
    from ..tensor import _NOWRAP

    wrap = tape and func not in _NOWRAP
    node.out_meta = tuple(m + (wrap,) for m in metas)
    if slot is not None:
        node.scalar_dtypes = {len(frag.scalars) - 1: torch.float64 if kind == "opt" else
                              metas[0][2] if metas else torch.float32}
    frag.nodes.append(node)
    frag.sig.append((func, skel_t, grad, tape))
    if kind == "bwd":
        frag.grad_writers += 1
    outs, node.out_refs = _outputs(node, args, kwargs)
    _stats["nodes"] += 1
    if len(frag.nodes) >= MAX_NODES:
        flush()
    return _unflatten(spec, outs)


def _outputs(node, args, kwargs):
    """The call's results: an in-place call's argument itself, else new
    placeholders; and weakrefs to the placeholders (None where aliased)."""
    from .. import autograd as _tape_grad
    from ..tensor import Graph

    outs, refs = [], []
    for j, meta in enumerate(node.out_meta):
        key = node.aliases.get(j)
        if key is not None:
            outs.append(args[key] if isinstance(key, int) else kwargs[key])
            refs.append(None)
            continue
        cls = _placeholder_class(meta[6])
        ph = LazyTensor._make(cls, meta, node, j)
        if meta[6] and meta[4] and _tape_grad._grad_enabled:
            Graph.node_list.append(ph)
        outs.append(ph)
        refs.append(weakref.ref(ph))
    return outs, tuple(refs)


def record_call(fn, args, kwargs, kind="fn"):
    """Record ``fn(*args, **kwargs)`` as one node; returns its results as
    placeholders.  ``fn`` runs with torch function off when the fragment
    runs; its outputs are inferred by calling it on meta tensors."""
    from ..tensor import Tensor

    tape = kind == "fn" and torch._C._is_torch_function_enabled() and any(
        isinstance(a, Tensor) for a in _flat_args(args))
    with paused(flush_first=False):
        return _record(fn, args, kwargs, tape, kind)


def _flat_args(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif type(obj) in (list, tuple):
        for o in obj:
            yield from _flat_args(o)


# ------------------------------------------------------------------ nodes of their own
def _backward_node(loss, gradient=None, retain_graph=None, create_graph=False, inputs=None):
    """``loss``'s backward walk, run when the fragment runs."""
    torch.autograd.backward(loss, gradient, retain_graph, create_graph, inputs=inputs)


def apply_function(fn, *args):
    """``fn.apply(*args)`` (a ``torch.autograd.Function``), run when the
    fragment runs."""
    return fn.apply(*args)


def record_function(fn, args):
    """``tensor.function_apply`` under lazy mode: the Function as one node."""
    return record_call(apply_function, (fn,) + tuple(args), {})


def record_backward(loss, retain_graph=False):
    record_call(_backward_node, (loss, None, bool(retain_graph)), {}, kind="bwd")


def _optimizer_node(opt, params, state_leaves, spec, lr):
    """The whole update of ``opt``: ``pure_update`` on the parameters'
    values and the gradients the backward left, the new values and slots
    written back in place."""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    state = tree_unflatten(state_leaves, spec)
    data = [p.detach() for p in params]
    grads = [_Base.grad.__get__(p) for p in params]
    grads = [None if g is None else g.detach() for g in grads]
    with torch.no_grad(), _numbers_on() if type(lr) is _Number else contextlib.nullcontext():
        new_params, new_state = opt.pure_update(data, grads, state, lr)
        for d, n in zip(data, new_params):
            if n is not d:
                d.copy_(n)
        new_leaves, _ = tree_flatten(new_state)
        for old, new in zip(state_leaves, new_leaves):
            if isinstance(old, torch.Tensor) and new is not old:
                old.copy_(new)


class _Number(torch.Tensor):
    """A Python number that a captured graph reads from the card (the
    optimizer's ``lr``): a 0-d f64 tensor that computes as the number
    would.  With numbers it computes in f64, as Python does (``1 - lr *
    wd``); beside tensors it takes their compute type, as torch takes a
    Python number: f32 beside bf16 and f16, whose operands widen to f32 and
    whose results round back.  A replay's update is so the eager update's
    bits: a plain 0-d f32 tensor would round ``lr`` to bf16 beside bf16
    weights, and compute ``1 - lr * wd`` in f32."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        others = [t for t in _flat_args((args, tuple(kwargs.values())))
                  if not isinstance(t, _Number)]
        with torch._C.DisableTorchFunctionSubclass():
            if not others:
                out = func(*args, **kwargs)
                if isinstance(out, torch.Tensor) and out.dtype == torch.float64 and \
                        out.numel() == 1:
                    return out.as_subclass(cls)
                return out
            dt = functools.reduce(torch.promote_types, [t.dtype for t in others])
            low = dt in (torch.bfloat16, torch.float16)
            work = torch.float32 if low or not dt.is_floating_point else dt

            def widen(x):
                if isinstance(x, _Number):
                    return x.as_subclass(torch.Tensor).to(work)
                if low and isinstance(x, torch.Tensor) and x.dtype == dt:
                    return x.float()
                return x

            a, kw = _map_tensors(args, widen), _map_tensors(kwargs, widen)
            out = func(*a, **kw)
            if not low:
                return out
            name = getattr(func, "__name__", "")
            if name.endswith("_") and not name.endswith("__") or name in _IN_PLACE:
                return args[0].copy_(a[0])  # in place: the widened copy, rounded back
            return _map_tensors(out, lambda t: t.to(dt) if t.dtype == torch.float32 else t)


_IN_PLACE = frozenset(("__iadd__", "__isub__", "__imul__", "__itruediv__", "__idiv__"))


def _map_tensors(obj, fn):
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if type(obj) in (list, tuple):
        return type(obj)(_map_tensors(o, fn) for o in obj)
    if type(obj) is dict:
        return {k: _map_tensors(v, fn) for k, v in obj.items()}
    return obj


@contextlib.contextmanager
def _numbers_on():
    """Torch function on for ``_Number`` (a graph's runner runs with it off),
    with every mode off the stack (the recorder records nothing here)."""
    with contextlib.ExitStack() as stack:
        for _ in range(torch._C._len_torch_function_stack()):
            stack.enter_context(torch.overrides._pop_mode_temporarily())
        stack.enter_context(torch._C._EnableTorchFunction())
        yield


def record_optimizer_step(opt):
    """``opt.step()`` under lazy mode: one node with ``lr`` an input, then a
    flush (the step's natural boundary)."""
    from torch.utils._pytree import tree_flatten

    with paused(flush_first=False), _LOCK:
        opt._ensure_state()
        leaves, spec = tree_flatten(opt._state)
        _record(_optimizer_node, (opt, list(opt.params), leaves, spec, float(opt.lr)), {},
                False, kind="opt", slot=(4, None))
        flush()


# ------------------------------------------------------------------ the fast path
def _match_meta(raw, m):
    with _NoTF():
        return (raw.shape == m[0] and raw.stride() == m[1] and raw.dtype == m[2]
                and raw.device == m[3] and raw.requires_grad == m[4]
                and (raw.grad_fn is None) == m[5] and type(raw) is m[6])


def _match_arg(proto, val, fast):
    tp = type(proto)
    if tp is _Leaf:
        if isinstance(val, LazyTensor):
            raw = val._value
            if raw is None:
                return False
        elif isinstance(val, torch.Tensor):
            raw = val
        else:
            return False
        idx = proto.idx
        leaves = fast.leaves
        if idx == len(leaves):
            if not _match_meta(raw, fast.tpl.leaf_meta[idx]):
                return False
            leaves.append(raw)
            return True
        if idx < len(leaves):
            return leaves[idx] is raw
        return False
    if tp is _Ref:
        return (isinstance(val, LazyTensor) and val._value is None
                and val._node is proto.node and val._pos == proto.pos)
    if tp is _Scalar:
        return False  # handled by the caller
    if tp is list or tp is tuple:
        if type(val) is not tp or len(val) != len(proto):
            return False
        return all(_match_arg(p, v, fast) for p, v in zip(proto, val))
    if tp is dict:
        if type(val) is not dict or list(val) != list(proto):
            return False
        return all(_match_arg(proto[k], val[k], fast) for k in proto)
    if isinstance(val, torch.Tensor):
        return False
    if proto is val:
        return True
    try:
        return type(proto) is type(val) and bool(proto == val)
    except Exception:
        return False


def _match_one(p, v, fast):
    if type(p) is _Scalar:
        if p.idx != len(fast.scalars) or type(v) is not fast.tpl.scalar_types[p.idx]:
            return False
        fast.scalars.append(v)
        return True
    return _match_arg(p, v, fast)


def _fast_try(fast, func, args, kwargs, grad, tape):
    global _fast
    if fast.cursor >= len(fast.tpl.nodes):
        _fast_flush(fast)  # a longer step: run the template, match on from a start
        fast = _fast
    out = _fast_record(fast, func, args, kwargs, grad, tape)
    if out is _MISS and fast.cursor == 0:
        for tpl in list(_templates):
            cand = _FastState(tpl)
            if tpl is not fast.tpl and _fast_match(cand, func, args, kwargs, grad, tape):
                _fast = cand
                _touch_template(tpl)
                return _fast_emit(cand, args, kwargs)
    return out


def _fast_match(fast, func, args, kwargs, grad, tape) -> bool:
    """Does the call fill the template's next node?  Its new leaves and
    scalars join ``fast`` if so."""
    node = fast.tpl.nodes[fast.cursor]
    if (func is not node.fn and func != node.fn) or grad != node.grad or tape != node.tape:
        return False
    ap = node.args_proto
    if len(args) != len(ap):
        return False
    n_leaves, n_scalars = len(fast.leaves), len(fast.scalars)
    ok = all(_match_one(p, v, fast) for p, v in zip(ap, args))
    if ok:
        kp = node.kwargs_proto
        if kwargs or kp:
            ok = list(kwargs) == list(kp) and all(_match_one(kp[k], kwargs[k], fast) for k in kp)
    if not ok:
        del fast.leaves[n_leaves:]
        del fast.scalars[n_scalars:]
    return ok


def _fast_emit(fast, args, kwargs):
    """The matched node's results, its cursor moved on."""
    node = fast.tpl.nodes[fast.cursor]
    outs, refs = _outputs(node, args, kwargs)
    fast.outs.append(refs)
    fast.cursor += 1
    if node.kind == "bwd":
        fast.grad_writers += 1
    _stats["nodes"] += 1
    _stats["fast_ops"] += 1
    return _unflatten(node.spec, outs)


def _fast_record(fast, func, args, kwargs, grad, tape):
    if not _fast_match(fast, func, args, kwargs, grad, tape):
        return _MISS
    return _fast_emit(fast, args, kwargs)


def _remap_proto(proto, mapping):
    tp = type(proto)
    if tp is _Ref:
        return _Ref(mapping[id(proto.node)], proto.pos)
    if tp is _Leaf or tp is _Scalar:
        return proto
    if tp is list:
        return [_remap_proto(p, mapping) for p in proto]
    if tp is tuple:
        return tuple(_remap_proto(p, mapping) for p in proto)
    if tp is dict:
        return {k: _remap_proto(v, mapping) for k, v in proto.items()}
    return proto


def _fast_leave(fast):
    """The step left the template mid-way: clone the matched prefix into a
    normal fragment and record on from there."""
    global _frag, _fast
    _fast = None
    _stats["fast_fallbacks"] += 1
    k = fast.cursor
    frag = _Fragment()
    if k:
        tpl = fast.tpl
        mapping = {}
        for j in range(k):
            old = tpl.nodes[j]
            clone = _Node(old.fn, _remap_proto(old.args_proto, mapping),
                          _remap_proto(old.kwargs_proto, mapping), old.grad, old.tape, old.kind)
            clone.out_meta, clone.spec, clone.aliases = old.out_meta, old.spec, old.aliases
            clone.scalar_dtypes = old.scalar_dtypes
            clone._idx = j
            refs = fast.outs[j]
            for r in refs:
                ph = r() if r is not None else None
                if ph is not None and ph._value is None:
                    ph._node = clone
            clone.out_refs = refs
            mapping[id(old)] = clone
            frag.nodes.append(clone)
            frag.sig.append(tpl.sig[j])
        frag.leaves = fast.leaves
        frag.leaf_meta = list(tpl.leaf_meta[: len(fast.leaves)])
        frag.leaf_ids = {id(a): i for i, a in enumerate(fast.leaves)}
        frag.scalars = fast.scalars
        frag.grad_writers = fast.grad_writers
    _frag = frag


def _fast_flush(fast):
    global _fast
    tpl = fast.tpl
    _fast = None
    _stats["flushes"] += 1
    _stats["fast_flushes"] += 1
    outputs = _live(fast.outs)
    with _NoTF():
        _run_template(tpl, fast.leaves, fast.scalars, outputs)
    _touch_template(tpl)
    _fast = _FastState(tpl)


def _live(per_node_refs):
    out = []
    for ni, refs in enumerate(per_node_refs):
        for pi, r in enumerate(refs):
            ph = r() if r is not None else None
            if ph is not None and ph._value is None:
                out.append((ni, pi, ph))
    return out


def _touch_template(tpl):
    try:
        _templates.remove(tpl)
    except ValueError:
        pass
    _templates.insert(0, tpl)


def _promote(frag):
    """The flushed fragment becomes the template the next step is matched
    against (an existing template of the same signature adopts its nodes)."""
    global _fast
    for t in _templates:
        if t.sig == frag.sig:
            t.nodes, t.leaf_meta = frag.nodes, frag.leaf_meta
            t.free_at = None
            t.scalar_types = [type(v) for v in frag.scalars]
            _touch_template(t)
            _fast = _FastState(t)
            return
    tpl = _Template(frag)
    _templates.insert(0, tpl)
    for old in _templates[_MAX_TEMPLATES:]:  # an evicted template's graphs go with it
        for g in old.graphs.values():
            _graphs._graphs.pop(g.key, None)
    del _templates[_MAX_TEMPLATES:]
    if not tpl.cuda:
        _stats["compiles"] += 1
    _fast = _FastState(tpl)


# ------------------------------------------------------------------ flushing
def flush():
    """Run the pending fragment.  Called at every host readback; call it at
    a step's end (torch/XLA's ``mark_step``) to start the device's work
    while Python records the next step."""
    with _LOCK, _NoTF():
        _flush_locked()


mark_step = flush


def _flush_locked():
    global _frag
    fast = _fast
    if fast is not None:
        if fast.cursor == 0:
            return
        if fast.cursor == len(fast.tpl.nodes):
            _fast_flush(fast)
            return
        _fast_leave(fast)
    frag = _frag
    if not frag.nodes:
        return
    _frag = _Fragment()
    _stats["flushes"] += 1
    outputs = _live([n.out_refs for n in frag.nodes])
    vals = _run_nodes(frag.nodes, frag.leaves, frag.scalars, [(ni, pi) for ni, pi, _ in outputs],
                      _free_plan(frag.nodes, outputs))
    _materialize(outputs, _detached(outputs, vals, _spent(frag.nodes)))
    _promote(frag)


def _free_plan(nodes, outputs):
    """For each node, the earlier nodes whose results no later node reads
    and the flush does not hand out: dropped after it runs."""
    keep = {id(nodes[ni]) for ni, _, _ in outputs}
    last = {}
    for j, node in enumerate(nodes):
        refs = []
        _refs_in(node.args_proto, refs)
        _refs_in(node.kwargs_proto, refs)
        for r in refs:
            last[id(r)] = j
        last.setdefault(id(node), j)
    free_at = [[] for _ in nodes]
    for key, j in last.items():
        if key not in keep:
            free_at[j].append(key)
    return free_at


def _run_nodes(nodes, leaves, scalars, wanted, free_at, track=None, graph_scalars=None):
    """Run ``nodes`` in order with torch function off; the results at
    ``wanted`` ((node, position) pairs)."""
    vals = {}
    entry = cur = torch.is_grad_enabled()
    with _NoTF():
        try:
            for j, node in enumerate(nodes):
                fn = node.fn
                if graph_scalars is not None and node.scalar_dtypes:
                    a = _rebuild(node.args_proto, leaves, graph_scalars, vals)
                    kw = _rebuild(node.kwargs_proto, leaves, graph_scalars, vals)
                    fn, a, kw = _graph_form(node, a, kw)
                else:
                    a = _rebuild(node.args_proto, leaves, scalars, vals)
                    kw = _rebuild(node.kwargs_proto, leaves, scalars, vals)
                if node.grad != cur:
                    torch.set_grad_enabled(node.grad)
                    cur = node.grad
                if track is not None and node.kind == "bwd":
                    track.before_backward(a[0])
                flat = []
                _flatten(fn(*a, **kw), flat)
                vals[id(node)] = flat
                for key in free_at[j]:
                    vals.pop(key, None)
        finally:
            if cur != entry:
                torch.set_grad_enabled(entry)
    return [vals[id(nodes[ni])][pi] for ni, pi in wanted]


def _graph_form(node, a, kw):
    """A scalar node's call with its number read from a 0-d tensor on the
    card: a division by the number becomes a product with its reciprocal,
    ``full`` an ``empty`` filled from the tensor."""
    name = getattr(node.fn, "__name__", "")
    recip = any(type(x) is _Recip for x in a) or any(type(x) is _Recip for x in kw.values())
    a = [x.t if type(x) is _Recip else x for x in a]
    kw = {k: (v.t if type(v) is _Recip else v) for k, v in kw.items()}
    if recip:
        return _DIVISIONS[name], a, kw
    if name == "full":
        value = a.pop(1) if len(a) > 1 else kw.pop("fill_value")
        return (lambda size, **k: torch.empty(size, **k).fill_(value)), a, kw
    return node.fn, a, kw


class _Recip:
    __slots__ = ("t",)

    def __init__(self, t):
        self.t = t


def _spent(nodes) -> int:
    """The index of the fragment's last backward node that frees its graph,
    or -1: results made before it keep no autograd graph (a graph kept
    alive holds its parameters' AccumulateGrad nodes, on the stream they
    were made on, which a later capture must not meet)."""
    for j in range(len(nodes) - 1, -1, -1):
        n = nodes[j]
        if n.kind == "bwd":
            retain = n.args_proto[2] if len(n.args_proto) > 2 else n.kwargs_proto.get(
                "retain_graph")
            return -1 if retain else j
    return -1


def _detached(outputs, vals, spent):
    return [v.detach() if ni < spent and v.requires_grad else v
            for (ni, _, _), v in zip(outputs, vals)]


def _materialize(outputs, vals):
    from ..tensor import Tensor

    for (ni, pi, ph), v in zip(outputs, vals):
        if ph.__class__ is not LazyTensor and type(v) is torch.Tensor and isinstance(ph, Tensor):
            v.__class__ = Tensor
        ph._value = v
        ph._node = None


def _on_cuda(frag) -> bool:
    return any(m[3].type == "cuda" for m in frag.leaf_meta) or any(
        m[3].type == "cuda" for n in frag.nodes for m in n.out_meta)


# ------------------------------------------------------------------ the card's runner
class _Track:
    """What a run's backward nodes do to ``.grad``: every leaf they reach,
    with its ``.grad`` before the first of them."""

    def __init__(self):
        self.pre = {}

    def before_backward(self, loss):
        seen, stack = [], [loss.grad_fn]  # the nodes themselves: a freed one's id is reused
        ids = set()
        while stack:
            f = stack.pop()
            if f is None or id(f) in ids:
                continue
            seen.append(f)
            ids.add(id(f))
            v = getattr(f, "variable", None)
            if v is not None and id(v) not in self.pre:
                self.pre[id(v)] = (v, _Base.grad.__get__(v))
            stack.extend(n for n, _ in f.next_functions)

    def binds(self):
        return [(v, _Base.grad.__get__(v)) for v, _ in self.pre.values()]

    def restore(self):
        for v, g in self.pre.values():
            _Base.grad.__set__(v, g)


class _Graph:
    """One captured template: the graph, the inputs it reads (the step's
    own tensor where ``direct``, else a copy of its own), its 0-d scalar
    tensors, the tensors its live results and leaves' gradients end in."""

    __slots__ = ("key", "captured", "leaves", "direct", "scalars", "last_scalars", "outs",
                 "pre", "binds")


class _Uncapturable(Exception):
    """The step writes in place into an input the graph reads a copy of."""


def _same_place(a, b) -> bool:
    return a is b or (a.data_ptr() == b.data_ptr() and a.stride() == b.stride()
                      and a.shape == b.shape and a.dtype == b.dtype)


def _direct(tpl, leaves):
    """Which inputs a graph reads where they lie: those at the place of the
    template's reference input, which is still alive, so its memory is the
    same state (a parameter, a slot, a running statistic, a view of one).
    The others (a batch, a slice of a dataset, a held hidden state) are
    copied into the graph's own tensors before each replay, so a replay
    never writes into a tensor the user holds."""
    ref = tpl.ref_leaves or ()
    return [i < len(ref) and _same_place(t, ref[i]) for i, t in enumerate(leaves)]


def _version(t) -> int:
    """``t``'s count of in-place writes (an inference tensor keeps none, and
    none can be written outside inference mode)."""
    return -1 if t.is_inference() else t._version


def _own_copy(t):
    """The graph's tensor for an input it copies: ``t``'s shape, strides,
    dtype and class."""
    new = torch.empty_like(t)
    return new if type(t) is torch.Tensor else torch.Tensor._make_subclass(type(t), new)


def _capturable(tpl, outputs, leaves, direct) -> bool:
    if tpl.eager_only:
        return False
    for m in tpl.leaf_meta:
        if m[3].type != "cuda" or (m[4] and not m[5]):
            return False  # a CPU input, or one that carries an autograd graph
    if any(t.requires_grad and not d for t, d in zip(leaves, direct)):
        return False  # a new leaf that needs a gradient: its copy would get it
    last_bwd = max((j for j, n in enumerate(tpl.nodes) if n.kind == "bwd"), default=-1)
    for ni, pi, ph in outputs:
        meta = tpl.nodes[ni].out_meta[pi]
        if meta[4] and ni > last_bwd:
            return False  # the result still needs its autograd graph
        if meta[3].type != "cuda":
            return False
    return True


def _generators(tpl):
    if tpl.generators is None:
        gens = []

        def scan(p):
            if isinstance(p, torch.Generator):
                if p.device.type == "cuda" and all(g is not p for g in gens):
                    gens.append(p)
            elif type(p) in (list, tuple):
                for q in p:
                    scan(q)
            elif type(p) is dict:
                for q in p.values():
                    scan(q)

        for n in tpl.nodes:
            scan(n.args_proto)
            scan(n.kwargs_proto)
        tpl.generators = gens
    return tpl.generators


def _run_template(tpl, leaves, scalars, outputs):
    wanted = tuple((ni, pi) for ni, pi, _ in outputs)
    if tpl.free_at is None or tpl.free_at[0] != wanted:
        tpl.free_at = (wanted, _free_plan(tpl.nodes, outputs))
    free_at = tpl.free_at[1]
    spent = _spent(tpl.nodes)
    if not tpl.cuda:
        vals = _run_nodes(tpl.nodes, leaves, scalars, wanted, free_at)
        _materialize(outputs, _detached(outputs, vals, spent))
        return
    g = tpl.graphs.get(wanted)
    if g is not None and not all(_same_place(t, st) for t, st, d in
                                 zip(leaves, g.leaves, g.direct) if d):
        _drop(tpl, wanted)  # state the graph reads moved: capture anew, that input copied
        g = None
    if g is None:
        direct = _direct(tpl, leaves)
        if _capturable(tpl, outputs, leaves, direct):
            _capture(tpl, leaves, direct, scalars, outputs, wanted, free_at, spent)
            return
    if g is None or not _replayable(g):
        _stats["eager_fallback_fragments"] += 1
        vals = _run_nodes(tpl.nodes, leaves, scalars, wanted, free_at)
        _materialize(outputs, _detached(outputs, vals, spent))
        return
    _replay(g, leaves, scalars, outputs)


def _drop(tpl, wanted):
    g = tpl.graphs.pop(wanted)
    _graphs._graphs.pop(g.key, None)
    tpl.ref_leaves = g.leaves


def _scalar_buffers(tpl, scalars):
    """A 0-d tensor on the card for each scalar slot, in its node's dtype,
    and the form a node reads it in: "recip" for a divisor (the tensor
    holds its reciprocal), "number" for the optimizer's ``lr`` (f64, read
    as a ``_Number``), else None."""
    dtypes, forms = {}, {}
    for n in tpl.nodes:
        if n.scalar_dtypes:
            dtypes.update(n.scalar_dtypes)
            form = "number" if n.kind == "opt" else \
                "recip" if getattr(n.fn, "__name__", "") in _DIVISIONS else None
            forms.update(dict.fromkeys(n.scalar_dtypes, form))
    dev = torch.device("cuda", torch.cuda.current_device())
    return [(torch.zeros((), dtype=dtypes.get(i, torch.float32), device=dev), forms.get(i))
            for i in range(len(scalars))]


def _write_scalars(g, scalars):
    """Fill the slots whose number changed since the last replay (a fill
    kernel each, no host sync)."""
    for i, v in enumerate(scalars):
        if g.last_scalars is not None and g.last_scalars[i] == v and \
                type(g.last_scalars[i]) is type(v):
            continue
        t, form = g.scalars[i]
        if form == "recip":
            v = float(np.float64(1.0) / np.float64(v)) if t.dtype == torch.float64 else \
                float(np.float32(1.0) / np.float32(v))
        t.fill_(v)
    g.last_scalars = list(scalars)


def _capture(tpl, leaves, direct, scalars, outputs, wanted, free_at, spent):
    global _graphs
    from ..jit import StepGraphs

    if _graphs is None:
        _graphs = StepGraphs()
    g = _Graph()
    g.scalars, g.last_scalars = _scalar_buffers(tpl, scalars), None
    _write_scalars(g, scalars)
    views = [_Recip(t) if form == "recip" else t.as_subclass(_Number) if form == "number"
             else t for t, form in g.scalars]
    g.direct = direct
    g.leaves = [t if d else _own_copy(t) for t, d in zip(leaves, direct)]
    results, written = [], []

    def step():
        track = _Track()
        if results:  # the capture, on the graph's inputs
            if written:
                raise _Uncapturable(f"the step writes its inputs {written} in place")
            results[0][1].restore()  # the leaves' gradients as the warm-up found them
            vals = _run_nodes(tpl.nodes, g.leaves, scalars, wanted, free_at, track,
                              graph_scalars=views)
        else:  # the warm-up: the step itself
            before = [_version(t) for t in leaves]
            vals = _run_nodes(tpl.nodes, leaves, scalars, wanted, free_at, track)
            written.extend(i for i, (t, v) in enumerate(zip(leaves, before))
                           if not direct[i] and _version(t) != v)
        results.append((_detached(outputs, vals, spent), track, track.binds()))

    key = g.key = ("lazy", next(_serial))
    try:
        _graphs.run(key, step, 1, generators=_generators(tpl))
    except Exception:
        if not results:
            raise
        tpl.eager_only, tpl.ref_leaves = True, None
        _stats["eager_fallback_fragments"] += 1
        vals, track, binds = results[0]
        for v, grad in binds:
            _Base.grad.__set__(v, grad)
        _materialize(outputs, vals)
        return
    _stats["compiles"] += 1
    warm_vals, track, warm_binds = results[0]
    static_vals, _, static_binds = results[1]
    g.captured = _graphs[key]
    g.outs = static_vals
    g.pre = [(v, pre is None) for v, pre in track.pre.values()]
    g.binds = static_binds
    tpl.graphs[wanted] = g
    tpl.ref_leaves = g.leaves  # the promoting run's inputs go
    cur = torch.cuda.current_stream()
    for v, grad in warm_binds:
        _Base.grad.__set__(v, grad)
        if grad is not None:
            grad.record_stream(cur)
    for v in warm_vals:
        v.record_stream(cur)
    _materialize(outputs, warm_vals)


def _replayable(g) -> bool:
    """The gradients the backward reaches are None where they were None at
    the capture, and set where they were set."""
    return all((_Base.grad.__get__(v) is None) == was_none for v, was_none in g.pre)


def _replay(g, leaves, scalars, outputs):
    for new, st, d in zip(leaves, g.leaves, g.direct):
        if not d:
            st.copy_(new)  # the step's input into the graph's own copy
    _write_scalars(g, scalars)
    g.captured.replay()
    for v, grad in g.binds:
        _Base.grad.__set__(v, grad)
    _materialize(outputs, [o.clone() for o in g.outs])


# ------------------------------------------------------------------ switch
def enable() -> None:
    """Record the torch calls made from here on (this thread)."""
    global _mode
    if _mode is not None:
        return
    _mode = _Recorder()
    _mode.__enter__()


def captured() -> list:
    """Each template captured on the card: its nodes, the bytes its private
    pool took, the seconds its warm-up and capture took, its replays."""
    return [dict(nodes=len(t.nodes), pool_bytes=g.captured.pool_bytes,
                 capture_s=g.captured.capture_s, replays=g.captured.replays)
            for t in _templates for g in t.graphs.values()]


def disable() -> None:
    """Run what is pending, stop recording, drop the templates and their
    graphs, and put each placeholder's value where a placeholder was held:
    in dicts, lists, tuples, closures and ``BackendTensor``s."""
    global _mode, _fast, _frag, _graphs
    if _mode is None:
        return
    try:
        flush()
    finally:
        mode, _mode = _mode, None
        mode.__exit__(None, None, None)
        _fast = None
        _frag = _Fragment()
        _templates.clear()
        _graphs = None
    _materialize_escaped()


def eager(fn):
    """``fn`` runs outside the recorder, after a flush: the port's whole
    steps and the readers of parameters (EMA, the step report, the
    pipeline) compute on concrete tensors."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not recording():
            return fn(*args, **kwargs)
        with paused():
            return fn(*args, **kwargs)

    return wrapper


@contextlib.contextmanager
def paused(flush_first: bool = True):
    """Torch calls run eagerly inside (after a flush, unless asked not to):
    the port's own whole steps and readers of parameters use it."""
    if not recording():
        yield
        return
    if flush_first:
        flush()
    with torch.overrides._pop_mode_temporarily():
        yield


def _materialize_escaped() -> None:
    """Put each computed placeholder's value where the placeholder is held:
    in dicts, lists, closures' cells and ``BackendTensor``s, and in tuples
    held there (rebuilt)."""
    from types import CellType

    from .ndarray import BackendTensor

    live = [p for p in list(_placeholders) if p._value is not None]
    values = {id(p): p._value for p in live}  # `live` keeps these ids taken

    def swap(v):
        nv = values.get(id(v))
        if nv is not None:
            return nv
        if type(v) is tuple:
            new = tuple(swap(x) for x in v)
            if any(n is not o for n, o in zip(new, v)):
                return new
        return v

    held, seen = live, set()
    while held:
        tuples = []
        for obj in gc.get_referrers(*held):
            if id(obj) in seen or obj is live or obj is held or obj is values:
                continue
            seen.add(id(obj))
            t = type(obj)
            if t is dict:
                for k, v in list(obj.items()):
                    nv = swap(v)
                    if nv is not v:
                        obj[k] = nv
            elif t is list:
                for i, v in enumerate(obj):
                    nv = swap(v)
                    if nv is not v:
                        obj[i] = nv
            elif t is CellType:
                nv = swap(obj.cell_contents)
                if nv is not obj.cell_contents:
                    obj.cell_contents = nv
            elif t is BackendTensor:
                nv = swap(obj.array)
                if nv is not obj.array:
                    obj.array = nv
            elif t is tuple:
                tuples.append(obj)
        held = tuples  # their holders rebuild them
