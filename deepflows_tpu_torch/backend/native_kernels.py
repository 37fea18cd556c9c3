"""The ``cpu_native`` device's kernels: ctypes bindings over the C++ library
``native/kernels.cpp`` (counterpart of ``deepflows_tpu/backend/native_kernels.py``;
the source is the JAX package's, byte for byte).

The library is built with ``g++`` at first use into
``deepflows_tpu_torch/_build/native-<hash>/``, the hash covering the
source, the flags and the host CPU's model and features.  The flags are
the JAX package's Makefile's (``-O3 -march=native -fPIC -shared
-std=c++17``, no ``-ffast-math``: linking crtfastmath into a loaded
library would set FTZ/DAZ for the whole process).  A failed build raises with the compiler's output; there is no
quiet fallback device.

Protocol: ``torch_kernels``'s, on CPU tensors.  The 24 ``nat_*`` entry
points run on contiguous f32 CPU tensors (fill, the elementwise and scalar
ops, comparisons, log / exp / tanh, the SGEMM, trailing-axis sums and
maxima, im2col under ``conv2d``, max pooling, train-mode batch norm); what
does not fit them (another dtype, a reduction over leading axes) and the
protocol's other entries fall to ``torch_kernels``, as the JAX package's
fall to ``numpy_kernels``.  ``calls`` counts the C calls by entry.

The tape reaches the library through ``tensor.NativeTensor``, the class
of a tape ``Tensor`` made on ``cpu_native``: its ``__torch_function__``
sends the calls ``route`` recognises (2-D f32 products, elementwise
arithmetic with broadcasting, ``maximum`` against a scalar or a tensor,
exp / log / tanh, scalar powers, trailing sums and maxima, convolution
and max pooling) to autograd Functions over these kernels, and every
other call to the tape as on ``cpu``.  Their backward passes use the C
SGEMM for products and torch for the rest.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from ..config import config
from . import torch_kernels as _tk

SOURCE = Path(__file__).resolve().parent / "native" / "kernels.cpp"
BUILD = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")

calls: collections.Counter = collections.Counter()  # C calls by entry name

_lock = threading.Lock()
_lib = None

_F32P = ctypes.POINTER(ctypes.c_float)
_I64 = ctypes.c_int64
_F32 = ctypes.c_float
_SIGS = {
    "nat_fill": [_F32P, _F32, _I64],
    "nat_ewise_add": [_F32P, _F32P, _F32P, _I64],
    "nat_ewise_sub": [_F32P, _F32P, _F32P, _I64],
    "nat_ewise_mul": [_F32P, _F32P, _F32P, _I64],
    "nat_ewise_div": [_F32P, _F32P, _F32P, _I64],
    "nat_ewise_maximum": [_F32P, _F32P, _F32P, _I64],
    "nat_ewise_eq": [_F32P, _F32P, _F32P, _I64],
    "nat_ewise_ge": [_F32P, _F32P, _F32P, _I64],
    "nat_scalar_add": [_F32P, _F32, _F32P, _I64],
    "nat_scalar_mul": [_F32P, _F32, _F32P, _I64],
    "nat_scalar_div": [_F32P, _F32, _F32P, _I64],
    "nat_scalar_power": [_F32P, _F32, _F32P, _I64],
    "nat_scalar_maximum": [_F32P, _F32, _F32P, _I64],
    "nat_scalar_eq": [_F32P, _F32, _F32P, _I64],
    "nat_scalar_ge": [_F32P, _F32, _F32P, _I64],
    "nat_ewise_log": [_F32P, _F32P, _I64],
    "nat_ewise_exp": [_F32P, _F32P, _I64],
    "nat_ewise_tanh": [_F32P, _F32P, _I64],
    "nat_matmul": [_F32P, _F32P, _F32P, _I64, _I64, _I64],
    "nat_reduce_sum": [_F32P, _F32P, _I64, _I64],
    "nat_reduce_max": [_F32P, _F32P, _I64, _I64],
    "nat_im2col": [_F32P, _F32P] + [_I64] * 10,
    "nat_max_pool2d": [_F32P, _F32P] + [_I64] * 9,
    "nat_batchnorm_train": [_F32P] * 6 + [_I64, _I64, _I64, _F32],
}


_CPU_KEYS = ("model name", "vendor_id", "cpu family", "model", "flags", "Features",
             "CPU implementer", "CPU part")


def _cpuinfo() -> dict:
    """The first value of each key of ``/proc/cpuinfo`` that names the CPU
    or its features (empty where the file cannot be read)."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = f.read().splitlines()
    except OSError:
        return {}
    out = {}
    for ln in lines:
        key, sep, value = ln.partition(":")
        if sep and key.strip() in _CPU_KEYS:
            out.setdefault(key.strip(), value.strip())
    return out


def host_cpu() -> str:
    """The host CPU as ``/proc/cpuinfo`` names it: its model name, else its
    vendor, family and model numbers (an Arm core's implementer and part),
    with the machine's architecture."""
    import platform

    info = _cpuinfo()
    name = info.get("model name", "")
    if name in ("", "unknown"):
        name = " ".join(f"{k} {info[k]}" for k in ("vendor_id", "cpu family", "model",
                                                    "CPU implementer", "CPU part")
                        if info.get(k)) or "unknown"
    return f"{name} ({platform.machine()})"


def source_hash() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    # -march=native builds for this host alone: a build dir copied to
    # another machine is not reused
    h.update(repr(sorted(_cpuinfo().items())).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD / f"native-{source_hash()}" / "libdeepflows_native.so"


def build() -> Path:
    """Compile the library if it is not built yet; returns its path.
    Raises with the compiler's output if the build fails."""
    so = library_path()
    if so.exists():
        return so
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
    cxx = os.environ.get("CXX", "g++")
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"cpu_native: building {SOURCE.name} with {cxx} failed: {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"cpu_native: {cxx} failed for {SOURCE.name} "
                           f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def load() -> ctypes.CDLL:
    """The library, built and bound at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for fname, argtypes in _SIGS.items():
                fn = getattr(lib, fname)
                fn.argtypes = argtypes
                fn.restype = None
            lib.nat_version.restype = ctypes.c_int
            _lib = lib
        return _lib


def _c(entry: str, *args):
    calls[entry] += 1
    getattr(load(), f"nat_{entry}")(*args)


def _ptr(t: torch.Tensor):
    return ctypes.cast(t.data_ptr(), _F32P)


def _f32(a) -> torch.Tensor:
    """A contiguous f32 CPU tensor of ``a`` (sharing its storage where it is
    one already)."""
    if isinstance(a, torch.Tensor):
        return _tk.plain(a).detach().to("cpu", torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def _fits(*ts) -> bool:
    return all(isinstance(t, torch.Tensor) and t.dtype == torch.float32 and t.device.type == "cpu"
               for t in ts)


def __getattr__(attr):
    """The protocol's other entries: ``torch_kernels``'s."""
    return getattr(_tk, attr)


# ------------------------------------------------------------------ the entries
def fill(shape, value, dtype=None, device=None):
    dt = _tk.torch_dtype(dtype)
    if dt not in (None, torch.float32) or (dt is None and config.default_dtype != torch.float32):
        return _tk.fill(shape, value, dtype=dtype, device="cpu")
    out = torch.empty(tuple(shape) if not isinstance(shape, int) else (shape,),
                      dtype=torch.float32)
    _c("fill", _ptr(out), float(value), out.numel())
    return out


def _ewise(entry, a, b):
    a, b = _f32(a), _f32(b)
    if a.shape != b.shape:
        raise ValueError(f"nat_{entry}: shapes {tuple(a.shape)} and {tuple(b.shape)} differ")
    out = torch.empty_like(a)
    _c(entry, _ptr(a), _ptr(b), _ptr(out), a.numel())
    return out


def _scalar(entry, a, val):
    a = _f32(a)
    out = torch.empty_like(a)
    _c(entry, _ptr(a), float(val), _ptr(out), a.numel())
    return out


def _unary(entry, a):
    a = _f32(a)
    out = torch.empty_like(a)
    _c(entry, _ptr(a), _ptr(out), a.numel())
    return out


def ewise_add(a, b):
    return _ewise("ewise_add", a, b)


def ewise_sub(a, b):
    return _ewise("ewise_sub", a, b)


def ewise_mul(a, b):
    return _ewise("ewise_mul", a, b)


def ewise_div(a, b):
    return _ewise("ewise_div", a, b)


def ewise_maximum(a, b):
    return _ewise("ewise_maximum", a, b)


def ewise_eq(a, b):
    return _ewise("ewise_eq", a, b)


def ewise_ge(a, b):
    return _ewise("ewise_ge", a, b)


def scalar_add(a, val):
    return _scalar("scalar_add", a, val)


def scalar_mul(a, val):
    return _scalar("scalar_mul", a, val)


def scalar_div(a, val):
    return _scalar("scalar_div", a, val)


def scalar_power(a, val):
    return _scalar("scalar_power", a, val)


def scalar_maximum(a, val):
    return _scalar("scalar_maximum", a, val)


def scalar_eq(a, val):
    return _scalar("scalar_eq", a, val)


def scalar_ge(a, val):
    return _scalar("scalar_ge", a, val)


def ewise_log(a):
    """-inf for non-positive inputs, as the reference's CUDA kernel."""
    return _unary("ewise_log", a)


def ewise_exp(a):
    return _unary("ewise_exp", a)


def ewise_tanh(a):
    return _unary("ewise_tanh", a)


def matmul(a, b):
    """2-D f32 through the C SGEMM; anything else is ``torch_kernels``'s."""
    if not (getattr(a, "ndim", 0) == 2 and getattr(b, "ndim", 0) == 2):
        return _tk.matmul(torch.as_tensor(a), torch.as_tensor(b))
    a, b = _f32(a), _f32(b)
    m, n = a.shape
    n2, p = b.shape
    if n != n2:
        raise ValueError(f"nat_matmul: inner dimensions {n} and {n2} differ")
    out = torch.empty((m, p), dtype=torch.float32)
    _c("matmul", _ptr(a), _ptr(b), _ptr(out), m, n, p)
    return out


def _reduce(entry, a, axis, keepdims):
    """Over a trailing block of axes (all of them for ``axis=None``), or
    None where the C kernel does not fit."""
    a = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    if a.dtype != torch.float32:
        return None
    nd = a.dim()
    axes = tuple(range(nd)) if axis is None else \
        tuple(ax % nd for ax in ((axis,) if isinstance(axis, int) else axis))
    if tuple(sorted(axes)) != tuple(range(nd - len(axes), nd)):
        return None
    a = _f32(a)
    reduce_size = int(np.prod([a.shape[ax] for ax in axes])) or 1
    out_shape = tuple(a.shape[: nd - len(axes)])
    out = torch.empty(out_shape, dtype=torch.float32)
    _c(entry, _ptr(a), _ptr(out), out.numel(), reduce_size)
    return out.reshape(out_shape + (1,) * len(axes)) if keepdims else out


def reduce_sum(a, axis=None, keepdims=False):
    out = _reduce("reduce_sum", a, axis, keepdims)
    return _tk.reduce_sum(torch.as_tensor(a), axis, keepdims) if out is None else out


def reduce_max(a, axis=None, keepdims=False):
    out = _reduce("reduce_max", a, axis, keepdims)
    return _tk.reduce_max(torch.as_tensor(a), axis, keepdims) if out is None else out


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def conv2d(x, w, stride=1, padding=0, groups=1):
    """C im2col (threaded) and the C SGEMM (groups 1, f32 NCHW); torch's
    convolution otherwise."""
    x, w = torch.as_tensor(x), torch.as_tensor(w)
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    if groups != 1 or not _fits(x, w) or x.dim() != 4:
        return torch.nn.functional.conv2d(x, w, stride=(sh, sw), padding=(ph, pw), groups=groups)
    xpad = _f32(torch.nn.functional.pad(_f32(x), (pw, pw, ph, ph)))
    co, ci, kh, kw = w.shape
    n, _, h, w_ = xpad.shape
    oh, ow = (h - kh) // sh + 1, (w_ - kw) // sw + 1
    cols = torch.empty((n * oh * ow, ci * kh * kw), dtype=torch.float32)
    _c("im2col", _ptr(xpad), _ptr(cols), n, ci, h, w_, kh, kw, sh, sw, oh, ow)
    w2 = _f32(w).reshape(co, ci * kh * kw).t().contiguous()
    y = matmul(cols, w2)  # (N·oh·ow, co)
    return y.reshape(n, oh, ow, co).permute(0, 3, 1, 2).contiguous()


def max_pool2d(x, kernel_size, stride=None, padding=0):
    """Threaded C max pooling (f32 NCHW; the padding is -inf); torch's
    otherwise."""
    x = torch.as_tensor(x)
    kh, kw = _pair(kernel_size)
    sh, sw = _pair(stride or kernel_size)
    ph, pw = _pair(padding)
    if not _fits(x) or x.dim() != 4:
        return torch.nn.functional.max_pool2d(x, (kh, kw), (sh, sw), (ph, pw))
    xc = _f32(x)
    if ph or pw:
        xc = torch.nn.functional.pad(xc, (pw, pw, ph, ph), value=float("-inf")).contiguous()
    n, c, h, w = xc.shape
    oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
    out = torch.empty((n, c, oh, ow), dtype=torch.float32)
    _c("max_pool2d", _ptr(xc), _ptr(out), n * c, h, w, kh, kw, sh, sw, oh, ow)
    return out


def batchnorm_train(x, gamma, beta, axes, eps):
    """Threaded C batch norm over NCHW (axes (0, 2, 3)): ``(out, mean,
    var)``, the statistics (1, C, 1, 1) and the variance biased."""
    x = torch.as_tensor(x)
    if not _fits(x) or x.dim() != 4 or tuple(axes) != (0, 2, 3):
        dims = tuple(axes)
        mean = x.mean(dims, keepdim=True)
        var = ((x - mean) ** 2).mean(dims, keepdim=True)
        out = (x - mean) / torch.sqrt(var + eps)
        if gamma is not None:
            out = out * torch.as_tensor(gamma) + torch.as_tensor(beta)
        return out, mean, var
    n, c, h, w = x.shape
    xc = _f32(x)
    out = torch.empty_like(xc)
    mean = torch.empty(c, dtype=torch.float32)
    var = torch.empty(c, dtype=torch.float32)
    g = None if gamma is None else _f32(gamma).reshape(-1)
    b = None if beta is None else _f32(beta).reshape(-1)
    null = _F32P()
    _c("batchnorm_train", _ptr(xc), null if g is None else _ptr(g),
       null if b is None else _ptr(b), _ptr(out), _ptr(mean), _ptr(var), n, c, h * w,
       float(eps))
    keep = (1, c, 1, 1)
    return out, mean.reshape(keep), var.reshape(keep)


# ------------------------------------------------------------------ the tape's route
def _unbroadcast(g, shape):
    extra = g.dim() - len(shape)
    if extra > 0:
        g = g.sum(tuple(range(extra)))
    axes = tuple(i for i, (a, b) in enumerate(zip(g.shape, shape)) if a != b)
    if axes:
        g = g.sum(axes, keepdim=True)
    return g.reshape(shape)


class _Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return matmul(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = matmul(g, b.t()) if ctx.needs_input_grad[0] else None
        gb = matmul(a.t(), g) if ctx.needs_input_grad[1] else None
        return ga, gb


class _Binary(torch.autograd.Function):
    """``a op b`` for two f32 tensors, broadcast to one shape first."""

    @staticmethod
    def forward(ctx, op, a, b):
        shape = torch.broadcast_shapes(a.shape, b.shape)
        ctx.op, ctx.shapes = op, (a.shape, b.shape)
        ctx.save_for_backward(a, b)
        return globals()[f"ewise_{op}"](a.expand(shape), b.expand(shape))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        op = ctx.op
        if op == "add":
            ga, gb = g, g
        elif op == "sub":
            ga, gb = g, -g
        elif op == "mul":
            ga, gb = g * b, g * a
        elif op == "div":
            ga, gb = g / b, -g * a / (b * b)
        else:  # maximum: a tie splits the gradient, as torch.maximum's
            tie = (a == b).to(g.dtype) * 0.5
            ga, gb = g * ((a > b).to(g.dtype) + tie), g * ((b > a).to(g.dtype) + tie)
        return (None, _unbroadcast(ga, ctx.shapes[0]) if ctx.needs_input_grad[1] else None,
                _unbroadcast(gb, ctx.shapes[1]) if ctx.needs_input_grad[2] else None)


class _Scalar(torch.autograd.Function):
    """``x op s`` for a Python number or 0-d tensor ``s`` (read on the host)."""

    @staticmethod
    def forward(ctx, op, x, s):
        ctx.op, ctx.s = op, s
        ctx.save_for_backward(x)
        return globals()[f"scalar_{op}"](x, s)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        op, s = ctx.op, ctx.s
        if op == "add":
            gx = g
        elif op == "mul":
            gx = g * s
        elif op == "div":
            gx = g / s
        elif op == "power":
            gx = g * s * x ** (s - 1)
        else:  # maximum
            gx = g * ((x > s).to(g.dtype) + (x == s).to(g.dtype) * 0.5)
        return None, gx, None


class _Unary(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, x):
        y = globals()[f"ewise_{op}"](x)
        ctx.op = op
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        if ctx.op == "exp":
            return None, g * y
        if ctx.op == "log":
            return None, g / x
        return None, g * (1.0 - y * y)


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, op, x, dims, keepdim):
        y = _reduce(f"reduce_{op}", x, dims, keepdim)
        ctx.op, ctx.dims, ctx.keep = op, dims, keepdim
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        nd = x.dim()
        dims = tuple(range(nd)) if ctx.dims is None else tuple(
            d % nd for d in ((ctx.dims,) if isinstance(ctx.dims, int) else ctx.dims))
        if not ctx.keep:
            shape = [1 if i in dims else s for i, s in enumerate(x.shape)]
            g, y = g.reshape(shape), y.reshape(shape)
        if ctx.op == "sum":
            return None, g.expand(x.shape), None, None
        hit = (x == y).to(g.dtype)  # ties split evenly, as torch.amax's
        return None, g * hit / hit.sum(dims, keepdim=True), None, None


class _Conv2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.stride, ctx.padding = stride, padding
        return conv2d(x, w, stride, padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = torch.nn.grad.conv2d_input(x.shape, w, g, ctx.stride, ctx.padding) \
            if ctx.needs_input_grad[0] else None
        gw = torch.nn.grad.conv2d_weight(x, w.shape, g, ctx.stride, ctx.padding) \
            if ctx.needs_input_grad[1] else None
        return gx, gw, None, None


class _MaxPool2d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k, s, p):
        ctx.save_for_backward(x)
        ctx.args = (k, s, p)
        return max_pool2d(x, k, s, p)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xr = x.detach().requires_grad_()
            y = torch.nn.functional.max_pool2d(xr, *ctx.args)
        return torch.autograd.grad(y, xr, g)[0], None, None, None


def _number(v):
    """A Python number, or a 0-d f32 CPU tensor's value; else None."""
    if type(v) in (int, float):
        return float(v)
    if isinstance(v, torch.Tensor) and v.dim() == 0 and _fits(v) and not v.requires_grad:
        return float(_tk.plain(v).item())
    return None


_BINARY = {}
for _op, _names in (("add", ("add", "__add__", "__radd__")), ("sub", ("sub", "__sub__")),
                    ("mul", ("mul", "__mul__", "__rmul__")),
                    ("div", ("div", "__truediv__", "true_divide"))):
    for _n in _names:
        _BINARY[_n] = _op
_UNARY = {"exp": "exp", "log": "log", "tanh": "tanh"}


def route(func, args, kwargs):
    """A zero-argument callable that runs ``func(*args, **kwargs)`` through
    the C kernels as an autograd Function, or None where they do not fit."""
    name = getattr(func, "__name__", "")
    if name in ("matmul", "__matmul__", "mm") and len(args) == 2 and not kwargs:
        a, b = args
        if _fits(a, b) and a.dim() == 2 and b.dim() == 2:
            return lambda: _Matmul.apply(a, b)
        return None
    op = _BINARY.get(name)
    if op is not None or name in ("maximum", "pow", "__pow__"):
        if len(args) != 2 or kwargs:
            return None
        x, y = args
        if not _fits(x):
            return None
        if name in ("pow", "__pow__"):
            s = _number(y)
            return None if s is None else (lambda: _Scalar.apply("power", x, s))
        op = op or "maximum"
        s = _number(y)
        if s is not None and op in ("add", "sub", "mul", "div", "maximum"):
            if op == "sub":
                return lambda: _Scalar.apply("add", x, -s)
            return lambda: _Scalar.apply(op, x, s)
        if _fits(y) and y.dim() > 0:
            try:
                torch.broadcast_shapes(x.shape, y.shape)
            except RuntimeError:
                return None
            return lambda: _Binary.apply(op, x, y)
        return None
    op = _UNARY.get(name)
    if op is not None:
        x = args[0] if len(args) == 1 and not kwargs else None
        return None if x is None or not _fits(x) else (lambda: _Unary.apply(op, x))
    if name in ("sum", "amax"):
        if not args or not _fits(args[0]) or kwargs.get("dtype") is not None:
            return None
        x = args[0]
        dims = args[1] if len(args) > 1 else kwargs.get("dim")
        keep = bool(args[2] if len(args) > 2 else kwargs.get("keepdim", False))
        if dims == ():
            dims = None
        if name == "amax" and dims is None and len(args) < 2 and "dim" not in kwargs:
            return None
        nd = x.dim()
        axes = tuple(range(nd)) if dims is None else tuple(
            d % nd for d in ((dims,) if isinstance(dims, int) else dims))
        if nd == 0 or tuple(sorted(axes)) != tuple(range(nd - len(axes), nd)):
            return None
        return lambda: _Reduce.apply("sum" if name == "sum" else "max", x, dims, keep)
    if name == "conv2d":
        x, w = args[0], args[1]
        stride = _pair(args[3] if len(args) > 3 else kwargs.get("stride", 1))
        padding = args[4] if len(args) > 4 else kwargs.get("padding", 0)
        groups = args[6] if len(args) > 6 else kwargs.get("groups", 1)
        bias = args[2] if len(args) > 2 else kwargs.get("bias")
        dil = _pair(args[5] if len(args) > 5 else kwargs.get("dilation", 1))
        if (bias is None and groups == 1 and dil == (1, 1) and not isinstance(padding, str)
                and _fits(x, w) and x.dim() == 4):
            return lambda: _Conv2d.apply(x, w, stride, _pair(padding))
        return None
    if name == "max_pool2d":
        x = args[0]
        k = args[1] if len(args) > 1 else kwargs.get("kernel_size")
        s = args[2] if len(args) > 2 else kwargs.get("stride")
        p = args[3] if len(args) > 3 else kwargs.get("padding", 0)
        extra = {k_: v for k_, v in kwargs.items() if k_ not in ("kernel_size", "stride",
                                                                 "padding")}
        if len(args) <= 4 and not any(extra.values()) and _fits(x) and x.dim() == 4:
            return lambda: _MaxPool2d.apply(x, _pair(k), _pair(s or k), _pair(p))
        return None
    return None
