"""ONNX runtime over torch (counterpart of ``deepflows_tpu/onnx/runtime.py``).

``OnnxModel(path, device=None)`` parses an ONNX file (the exporter's, or a
foreign one within the op set) and runs it on ``device``, the card by
default: what lets the serving layer load a model file from disk as the
reference's ran ``root_dir/model_file`` through onnxruntime.  The op set
and the refusals of ``_validate`` are the JAX package's.  The ops are
torch calls (``F.conv2d`` and the pools, ``torch.matmul`` for MatMul and
Gemm), as the JAX package computes them outside any Pallas kernel.

On the card each input shape runs as one CUDA graph
(``jit.StepGraphs``): the shape's first call runs eagerly on a side stream
and captures the graph, later calls copy the inputs into the graph's own
and replay it (``replays(shape)`` counts them).  The initializers are
copied to the card once and shared by every shape, as the JAX runtime
shares one device copy among its jitted programs.  Each value is dropped
after its last use, so a graph's memory is its live peak, and the graphs
of all shapes share one memory pool, so a shape smaller than one seen
before adds little or nothing.  The first ``MAX_GRAPHS`` shapes get a
graph; later ones run eagerly on the card, whose caching allocator reuses
their memory from call to call, so what the graphs hold stays bounded
however many batch sizes a server meets.  A lock serialises calls
(copy-in, replay, copy-out), since every call of a shape goes through the
same buffers and all shapes through the same pool: a server's concurrent
requests each get their own answer.  Shape-like operands (Reshape's
shape, Slice's bounds, ReduceSum's axes, TopK's k) are read from the host
copy, so Slice's INT64_MAX open-end sentinel stays exact.
``__call__`` returns numpy.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .proto import onnx_minimal_pb2 as pb

_DTYPES = {
    pb.TensorProto.FLOAT: np.float32,
    pb.TensorProto.INT64: np.int64,
    pb.TensorProto.INT32: np.int32,
    pb.TensorProto.DOUBLE: np.float64,
    pb.TensorProto.BOOL: np.bool_,
}

_CASTS = {1: torch.float32, 6: torch.int32, 7: torch.int64, 9: torch.bool,
          10: torch.float16, 11: torch.float64, 16: torch.bfloat16}


def _decode_tensor(tp: pb.TensorProto) -> np.ndarray:
    dtype = _DTYPES.get(tp.data_type)
    if dtype is None:
        raise ValueError(f"unsupported tensor data_type {tp.data_type}")
    shape = tuple(tp.dims)
    if tp.raw_data:
        arr = np.frombuffer(tp.raw_data, dtype=dtype)
    elif tp.float_data:
        arr = np.asarray(tp.float_data, np.float32).astype(dtype)
    elif tp.int64_data:
        arr = np.asarray(tp.int64_data, np.int64).astype(dtype)
    elif tp.int32_data:
        arr = np.asarray(tp.int32_data, np.int32).astype(dtype)
    elif tp.double_data:
        arr = np.asarray(tp.double_data, np.float64).astype(dtype)
    else:
        arr = np.zeros(shape, dtype)
    return arr.reshape(shape)


def _attrs(node: pb.NodeProto) -> dict:
    out = {}
    for a in node.attribute:
        if a.type == pb.AttributeProto.INT:
            out[a.name] = int(a.i)
        elif a.type == pb.AttributeProto.INTS:
            out[a.name] = tuple(a.ints)
        elif a.type == pb.AttributeProto.FLOAT:
            out[a.name] = float(a.f)
        elif a.type == pb.AttributeProto.STRING:
            out[a.name] = a.s.decode()
        elif a.type == pb.AttributeProto.TENSOR:
            out[a.name] = _decode_tensor(a.t)
    return out


def _pads(attrs):
    p = attrs.get("pads", (0, 0, 0, 0))
    if p[0] != p[2] or p[1] != p[3]:
        raise ValueError(f"asymmetric pads {p}")
    return (p[0], p[1])


def _reduce(x, fn, axes, keep):
    if axes is None:
        axes = tuple(range(x.dim()))
    axes = tuple(int(a) % x.dim() for a in axes)
    return fn(x, dim=axes, keepdim=keep)


class OnnxModel:
    """Executable ONNX graph.  ``model(x)`` returns the (first) output as a
    numpy array (a list of them for several outputs)."""

    SUPPORTED = {
        "Conv", "MaxPool", "AveragePool", "GlobalAveragePool", "MatMul",
        "Gemm", "Add", "Sub", "Mul", "Div", "Pow", "Sqrt", "Relu", "Max",
        "Min", "Abs", "Exp", "Log", "Sigmoid", "Reshape", "Transpose",
        "TopK", "GreaterOrEqual", "Cast", "ReduceMean",
        "ReduceSum", "ReduceMax", "ReduceMin", "Erf", "Tanh",
        "Gather", "Slice",
        "Concat", "Flatten", "Softmax", "Identity", "Dropout",
        "BatchNormalization",
    }

    MAX_GRAPHS = 8  # input shapes given a CUDA graph on the card; later ones run eagerly

    # attributes whose non-default values would change numerics silently
    _REJECT_ATTRS = {
        "Conv": {"dilations": lambda v: any(d != 1 for d in v),
                 "auto_pad": lambda v: v not in ("", "NOTSET")},
        "MaxPool": {"dilations": lambda v: any(d != 1 for d in v),
                    "ceil_mode": lambda v: v != 0,
                    "auto_pad": lambda v: v not in ("", "NOTSET")},
        "AveragePool": {"ceil_mode": lambda v: v != 0,
                        "auto_pad": lambda v: v not in ("", "NOTSET")},
    }

    def __init__(self, path: str, device=None):
        from ..device import Device

        m = pb.ModelProto()
        with open(path, "rb") as f:
            m.ParseFromString(f.read())
        self.model = m
        g = m.graph
        self.initializers = {tp.name: _decode_tensor(tp) for tp in g.initializer}
        self.input_names = [vi.name for vi in g.input if vi.name not in self.initializers]
        self.output_names = [vi.name for vi in g.output]
        self.nodes = list(g.node)
        self._validate()
        self._attrs = [_attrs(n) for n in self.nodes]
        self._dead = self._last_uses()
        self.device = Device(device)
        self._lock = threading.Lock()
        self._consts = None  # the initializers on the device, shared by every shape
        self._graphs = None  # jit.StepGraphs on the card
        self._io = {}  # shape key -> (static inputs, static outputs) of its graph

    # ------------------------------------------------------------ checking
    def _validate(self):
        unsupported = {n.op_type for n in self.nodes} - self.SUPPORTED
        if unsupported:
            raise ValueError(f"unsupported ONNX ops: {sorted(unsupported)}")
        for n in self.nodes:
            checks = self._REJECT_ATTRS.get(n.op_type)
            if not checks:
                continue
            a = _attrs(n)
            for name, bad in checks.items():
                if name in a and bad(a[name]):
                    raise ValueError(
                        f"node {n.name or n.op_type}: unsupported attribute "
                        f"{name}={a[name]!r} (would silently change numerics)")
        known = set(self.initializers) | set(self.input_names)
        for n in self.nodes:
            for i in n.input:
                if i and i not in known:
                    raise ValueError(
                        f"node {n.name}: input {i!r} produced by no node/initializer (graph "
                        "is not topologically sorted?)")
            known.update(n.output)
        missing = [o for o in self.output_names if o not in known]
        if missing:
            raise ValueError(f"graph outputs never produced: {missing}")

    def _last_uses(self) -> list:
        """For each node, the values no later node reads and no graph output
        is: ``_run`` drops them once the node has run."""
        last = {}
        for i, n in enumerate(self.nodes):
            for name in (*n.input, *n.output):
                if name:
                    last[name] = i
        dead = [[] for _ in self.nodes]
        for name, i in last.items():
            if name not in self.output_names:
                dead[i].append(name)
        return dead

    # ------------------------------------------------------------ execution
    def _run(self, consts, xs):
        from ..nn import functional as F

        env = dict(consts)
        env.update(zip(self.input_names, xs))

        for i, (n, a) in enumerate(zip(self.nodes, self._attrs)):
            named = [i for i in n.input if i]

            def host(idx):
                """A shape-like operand as host int64 numpy: the initializer's
                own bytes, never a device copy."""
                raw = self.initializers.get(named[idx])
                return np.asarray(raw if raw is not None else env[named[idx]].cpu().numpy())

            ins = [env[i] for i in named]
            o = n.output[0]
            t = n.op_type
            if t == "Conv":
                y = torch.nn.functional.conv2d(
                    ins[0], ins[1], stride=a.get("strides", (1, 1)), padding=_pads(a),
                    groups=a.get("group", 1))
                env[o] = y + ins[2].reshape(1, -1, 1, 1) if len(ins) == 3 else y
            elif t == "MaxPool":
                # ONNX strides default to 1 on each spatial axis (not the kernel)
                env[o] = F.max_pool2d(ins[0], a["kernel_shape"], a.get("strides", (1, 1)),
                                      _pads(a))
            elif t == "AveragePool":
                env[o] = F.avg_pool2d(ins[0], a["kernel_shape"], a.get("strides", (1, 1)),
                                      _pads(a))
            elif t == "GlobalAveragePool":
                env[o] = ins[0].mean((2, 3), keepdim=True)
            elif t == "MatMul":
                env[o] = torch.matmul(ins[0], ins[1])
            elif t == "Gemm":
                x0 = ins[0].t() if a.get("transA") else ins[0]
                w0 = ins[1].t() if a.get("transB") else ins[1]
                y = a.get("alpha", 1.0) * torch.matmul(x0, w0)
                env[o] = y + a.get("beta", 1.0) * ins[2] if len(ins) == 3 else y
            elif t == "Add":
                env[o] = ins[0] + ins[1]
            elif t == "Sub":
                env[o] = ins[0] - ins[1]
            elif t == "Mul":
                env[o] = ins[0] * ins[1]
            elif t == "Div":
                env[o] = ins[0] / ins[1]
            elif t == "Pow":
                env[o] = ins[0] ** ins[1]
            elif t == "Sqrt":
                env[o] = torch.sqrt(ins[0])
            elif t == "Relu":
                env[o] = torch.maximum(ins[0], ins[0].new_zeros(()))
            elif t == "Max":
                env[o] = torch.maximum(ins[0], ins[1])
            elif t == "Min":
                env[o] = torch.minimum(ins[0], ins[1])
            elif t == "Abs":
                env[o] = torch.abs(ins[0])
            elif t == "Exp":
                env[o] = torch.exp(ins[0])
            elif t == "Log":
                env[o] = torch.log(ins[0])
            elif t == "Sigmoid":
                env[o] = torch.sigmoid(ins[0])
            elif t == "TopK":
                k = int(host(1).ravel()[0])
                vals, idx = torch.topk(ins[0], k, dim=a.get("axis", -1))
                env[o] = vals
                if len(n.output) > 1 and n.output[1]:
                    env[n.output[1]] = idx
            elif t == "GreaterOrEqual":
                env[o] = ins[0] >= ins[1]
            elif t == "Cast":
                to = _CASTS.get(a.get("to"))
                if to is None:
                    raise ValueError(f"Cast to={a.get('to')} unsupported")
                env[o] = ins[0].to(to)
            elif t == "Reshape":
                shape = [ins[0].shape[i] if d == 0 else int(d) for i, d in enumerate(host(1))]
                env[o] = ins[0].reshape(shape)
            elif t == "Transpose":
                perm = a.get("perm") or tuple(reversed(range(ins[0].dim())))
                env[o] = ins[0].permute(perm)
            elif t in ("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin"):
                fn = {"ReduceMean": torch.mean, "ReduceSum": torch.sum,
                      "ReduceMax": torch.amax, "ReduceMin": torch.amin}[t]
                axes = a.get("axes")
                if len(ins) > 1:  # opset-13 ReduceSum: the axes as the second input
                    axes = tuple(int(d) for d in host(1))
                env[o] = _reduce(ins[0], fn, axes, bool(a.get("keepdims", 1)))
            elif t == "Gather":
                axis = a.get("axis", 0) % ins[0].dim()
                idx = ins[1].long()  # int32 token ids from the graph input
                idx = torch.where(idx < 0, idx + ins[0].shape[axis], idx)
                y = torch.index_select(ins[0], axis, idx.reshape(-1))
                env[o] = y.reshape(ins[0].shape[:axis] + idx.shape + ins[0].shape[axis + 1:])
            elif t == "Slice":
                starts = [int(d) for d in host(1)]
                ends = [int(d) for d in host(2)]
                axes = [int(d) for d in host(3)] if len(named) > 3 else list(range(len(starts)))
                sl = [slice(None)] * ins[0].dim()
                for st, en, ax in zip(starts, ends, axes):
                    dim = ins[0].shape[ax]
                    if st < 0:
                        st += dim
                    if en >= dim:  # the INT64_MAX open-end sentinel included
                        en = None
                    elif en < 0:  # negative ends count from the end
                        en += dim
                    sl[ax] = slice(st, en)
                env[o] = ins[0][tuple(sl)]
            elif t == "Erf":
                env[o] = torch.erf(ins[0])
            elif t == "Tanh":
                env[o] = torch.tanh(ins[0])
            elif t == "Concat":
                env[o] = torch.cat(ins, a["axis"])
            elif t == "Flatten":
                ax = a.get("axis", 1)
                env[o] = ins[0].reshape(int(np.prod(ins[0].shape[:ax]) or 1), -1)
            elif t == "Softmax":
                ax = a.get("axis", -1)
                e = torch.exp(ins[0] - torch.amax(ins[0], ax, keepdim=True))
                env[o] = e / torch.sum(e, ax, keepdim=True)
            elif t in ("Identity", "Dropout"):
                env[o] = ins[0]
            elif t == "BatchNormalization":
                xv, scale, bias, mean, var = ins[:5]
                eps = a.get("epsilon", 1e-5)
                c = (1, -1, 1, 1)
                env[o] = ((xv - mean.reshape(c)) / torch.sqrt(var.reshape(c) + eps)
                          * scale.reshape(c) + bias.reshape(c))
            else:  # pragma: no cover - _validate guards this
                raise ValueError(t)
            for name in self._dead[i]:
                env.pop(name, None)  # an optional output never set included
        return tuple(env[name] for name in self.output_names)

    def _device_consts(self):
        if self._consts is None:  # one device copy, shared by every shape
            self._consts = {k: torch.from_numpy(np.array(v)).to(self.device)
                            for k, v in self.initializers.items()}
        return self._consts

    def __call__(self, *xs):
        if len(xs) != len(self.input_names):
            raise ValueError(
                f"graph takes {len(self.input_names)} inputs {self.input_names}, got {len(xs)}")
        xs = tuple(
            np.asarray(x) if np.issubdtype(np.asarray(x).dtype, np.integer)
            else np.asarray(x, np.float32)
            for x in xs)
        with self._lock, torch.no_grad():
            consts = self._device_consts()
            if self.device.type != "cuda":
                outs = self._run(consts, [torch.from_numpy(np.ascontiguousarray(x)) for x in xs])
            else:
                outs = self._replayed(consts, xs)
            out = [o.detach().cpu().numpy() for o in outs]
        return out[0] if len(out) == 1 else out

    @staticmethod
    def _key(xs):
        return tuple((x.shape, x.dtype.str) for x in xs)

    def _replayed(self, consts, xs):
        """One CUDA graph per input shape (``jit.StepGraphs``), all in one
        memory pool (the lock replays them one at a time); eager calls past
        ``MAX_GRAPHS`` shapes."""
        from ..jit import StepGraphs

        if self._graphs is None:
            self._graphs = StepGraphs(shared_pool=True)
        key = self._key(xs)
        io = self._io.get(key)
        if io is None and len(self._io) >= self.MAX_GRAPHS:
            return self._run(consts, [torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
                                      for x in xs])
        if io is None:
            ins = [torch.empty(x.shape, dtype=torch.from_numpy(x[:0]).dtype, device=self.device)
                   for x in xs]
            io = self._io[key] = (ins, [])
        ins, outs = io
        for t, x in zip(ins, xs):
            t.copy_(torch.from_numpy(np.ascontiguousarray(x)), non_blocking=False)

        def step():
            res = self._run(consts, ins)
            if not outs:  # the warm-up call, outside the capture: the graph's outputs
                outs.extend(torch.empty_like(r) for r in res)
            for dst, r in zip(outs, res):
                dst.copy_(r)

        self._graphs.run(key, step, 1)
        return outs

    def replays(self, shape) -> int:
        """Replays of the graph of one float input of ``shape`` so far (0
        before its capture)."""
        for key in self._io:
            if key[0][0] == tuple(shape) and key in self._graphs:
                return self._graphs[key].replays
        return 0


def check_onnx(path: str) -> dict:
    """Structural checker: parses and validates the op set and topology;
    returns a summary (node and initializer counts, op histogram, IO
    signature, opset)."""
    m = OnnxModel(path, device="cpu")
    hist = {}
    for n in m.nodes:
        hist[n.op_type] = hist.get(n.op_type, 0) + 1
    return {
        "inputs": m.input_names,
        "outputs": m.output_names,
        "nodes": len(m.nodes),
        "initializers": len(m.initializers),
        "ops": hist,
        "opset": [o.version for o in m.model.opset_import],
    }
