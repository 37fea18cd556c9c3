"""Build the CUDA kernels of ``csrc/`` at first use and bind them with ctypes.

Each ``csrc/*.cu`` file is compiled by ``nvcc`` into a shared library of its
own with a plain C interface; the ``nvcc`` processes for all sources start
together.  The libraries go to ``_build/<hash>/``, where the hash covers
every source under ``csrc/`` and the compiler flags, so an edited source
rebuilds and an unchanged one is reused.  ``ptxas -v`` output (registers,
shared memory, spills) is kept beside each library in ``<name>.log``.
Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs = None
_functions = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict:
    """Compile every ``csrc/*.cu`` that is not built yet and load them all;
    returns ``{source stem: ctypes.CDLL}``.  Raises with the compiler's
    output if any build fails."""
    global _libs
    with _lock:
        if _libs is not None:
            return _libs
        out = BUILD / source_hash()
        out.mkdir(parents=True, exist_ok=True)
        sources = sorted(CSRC.glob("*.cu"))
        jobs = []
        for src in sources:
            so = out / f"lib{src.stem}.so"
            if so.exists():
                continue
            tmp = out / f"lib{src.stem}.{os.getpid()}.tmp"
            log = out / f"{src.stem}.log"
            with open(log, "w") as f:
                proc = subprocess.Popen(
                    [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                     str(src)],
                    stdout=f, stderr=subprocess.STDOUT,
                )
            jobs.append((src.stem, proc, tmp, so, log))
        failed = []
        for stem, proc, tmp, so, log in jobs:
            if proc.wait() == 0:
                os.replace(tmp, so)
            else:
                failed.append(f"{stem}:\n{log.read_text()[-4000:]}")
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        _libs = {
            src.stem: ctypes.CDLL(str(out / f"lib{src.stem}.so"))
            for src in sources
        }
        return _libs


def c_function(lib: str, name: str, argtypes):
    """The C function ``name`` of ``csrc/<lib>.cu``, built and bound at first
    use; it returns a ``cudaError_t`` as an int."""
    fn = _functions.get(name)
    if fn is None:
        fn = getattr(build_all()[lib], name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
