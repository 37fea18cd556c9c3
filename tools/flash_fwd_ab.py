#!/usr/bin/env python3
"""Check and time flash_attention's bf16 forward on one CUDA card.

    python3 tools/flash_fwd_ab.py --check
    python3 tools/flash_fwd_ab.py PARENT_TREE CHANGE_TREE [--report PATH]

``--check`` builds the kernels of this tree, prints ptxas's report of the
wgmma forward (registers, spills, warnings) and refuses to launch it unless
each of its two instances (D 64 and 128) holds the 168 registers a thread
that its register hand-over (setmaxnreg) counts on.  It also builds copies
of csrc/flash_attention.cu with other choices of the kernel's key tile and
ring slots (``SWEEP``: 64 or 128 keys, 2 or 3 slots, each an edit of the
one line that sets them) and with parts cut out (``MUTANTS``: no softmax
after the first tile, no K and V loads after the ring's first fill, or
neither).  The kernel and each sweep copy are held against the plain twins
at chip_smoke.py's limits, each case on the route it must take: the
slice's shape, its ragged shapes (chip_smoke.FLASH_RAGGED), the views TMA
cannot read (chip_smoke.FLASH_MISALIGNED) and its head views; two
slice-shape forward calls must give the same bits; and each is timed at
the slice's shape.  Then it times the mma.sync route and
scaled_dot_product_attention there, the kernel beside
scaled_dot_product_attention at other (B, H, L) (D 128, ``SHAPES``) with
the count of 128 x 128 block tiles each runs, and the mutants beside the
kernel at the slice's shape, causal and not, to see where a key tile's
time goes: those copies compute wrong values and are never checked.  It
exits non-zero if the kernel fails anything.

With two or more trees (directories that hold a deepflows_tpu_torch
package: an unpacked ``git archive`` of another commit, or ``.``), each is
imported in its own process, in the order A, B, B, A, so drift of the card
over the call shows as a difference between the two runs of one tree.
Every run builds its tree's kernels, then times, on inputs from the same
seeds:

- with CUDA events (chip_smoke.event_ms, L2 flushed between launches): the
  forward at the slice's shape (B 8, H 8, L 1024, D 128, causal, bf16) on
  contiguous (B, H, L, D) tensors and on (B, L, H, D) head views, beside
  scaled_dot_product_attention; the backward at the slice's shape
  (unchanged code: its time must not move);
- on the host's clock (host_us), on head views of ``HOST_SHAPE``: the
  forward wrapper's time a call (the route, the header, the C entry and
  the launch) and, as a control, the unchanged backward wrapper's; in a
  tree with ``_fwd_route``, also the route's check and the C entry on the
  wgmma route (tensor maps encoded, launch) and on the mma.sync route
  (launch) with headers built ahead (entry_calls);
- a bf16 bench-row training step: its device time by kernel group over
  two steps (chip_smoke.step_profile), one step with its launches queued
  ahead, and the median wall time of ``WALL_STEPS`` steps, each from a
  synchronized start to a synchronized end, as chip_smoke.py times them.

Prints the card's name and power limit and a table of the median of each
tree's runs; with ``--report PATH`` it also writes every run to PATH as
JSON.  It needs a card and exits non-zero without one.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import os
import re
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from int8_decode_ab import ROOT, load_chip_smoke  # noqa: E402

ENTRY_REGS = 168  # 65,536 / 384 threads, rounded down to a multiple of 8
HOST_CALLS, HOST_RUNS, HOST_SHAPE, WALL_STEPS = 100, 21, (1, 1, 128, 128), 20
SHAPES = ((8, 8, 1024, True), (8, 8, 1024, False), (8, 8, 512, False), (16, 8, 1024, True),
          (16, 8, 1024, False), (2, 8, 2048, True), (1, 8, 4096, True))  # (B, H, L, causal)


def slice_shape(cs):
    return cs.TRAIN_B, cs.TRAIN["num_heads"], cs.TRAIN_L, cs.TRAIN["dim"] // cs.TRAIN["num_heads"]


def fwd_flops(B, H, L, D):
    """FLOPs of the causal forward's two products over the kept pairs."""
    return 2 * 2 * B * H * (L * (L + 1) // 2) * D


def operands(torch, g, B, H, L, D, heads_view=False):
    dev = torch.device("cuda")
    if heads_view:
        return [torch.randn((B, L, H, D), generator=g, device=dev).bfloat16().transpose(1, 2)
                for _ in range(4)]
    return [torch.randn((B, H, L, D), generator=g, device=dev).bfloat16() for _ in range(4)]


def ptxas_report(build_dir):
    """{kernel: (registers, spill line)} of every wgmma forward instance in
    flash_attention's ptxas log, and its warnings."""
    text = (build_dir / "flash_attention.log").read_text()
    kernels, warnings, name = {}, [], None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        if "warning" in line:
            warnings.append(line.strip())
        if name and "flash_fwd_wgmma" in name:
            if "spill" in line:
                kernels.setdefault(name, [None, None])[1] = line.strip()
            m = re.search(r"Used (\d+) registers", line)
            if m:
                kernels.setdefault(name, [None, None])[0] = int(m.group(1))
    return kernels, warnings


# Edits made in copies of csrc/flash_attention.cu (each (old, new) must
# match the source once).  SWEEP: the kernel's other key tiles and ring
# slots, named (key tile, slots); the source's own is (128, 3).
TILE_LINE = "constexpr int BKT = 128, ST = 3;\n"
SWEEP = {(bk, st): ((TILE_LINE, f"constexpr int BKT = {bk}, ST = {st};\n"),)
         for bk in (128, 64) for st in (3, 2) if (bk, st) != (128, 3)}
# MUTANTS: parts cut out, to see what a key tile's time is made of
NO_SOFTMAX = ("      softmax(s, m, lsum, alpha, sh, (kt0 + i) * BKT, r0, g, tq, sl2);\n",
              "      alpha[0] = alpha[1] = 1.f;\n")
NO_LOADS = ("    mbar_wait(r.kempty + s, ph ^ 1);\n",
            "    mbar_wait(r.kempty + s, ph ^ 1);\n"
            "    if (i >= ST) {\n"
            "      mbar_arrive(r.kfull + s);\n"
            "      mbar_wait(r.vempty + s, ph ^ 1);\n"
            "      mbar_arrive(r.vfull + s);\n"
            "      continue;\n"
            "    }\n")
MUTANTS = {"no softmax": (NO_SOFTMAX,), "no K/V loads": (NO_LOADS,),
           "neither": (NO_SOFTMAX, NO_LOADS)}


def start_copies(build_dir, copies):
    """Starts one nvcc for each copy of csrc/flash_attention.cu with its
    edits ({name: edits}), with the package's flags, into ``build_dir``;
    returns {name: (library path, process)}."""
    from deepflows_tpu_torch.ops import _build

    src = (_build.CSRC / "flash_attention.cu").read_text()
    jobs = {}
    for name, edits in copies.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"flash_fwd_ab: the edit {old!r} does not match the source once")
            text = text.replace(old, new)
        stem = re.sub(r"\W", "_", str(name))
        cu, so = build_dir / f"{stem}.cu", build_dir / f"lib{stem}.so"
        cu.write_text(text)
        jobs[name] = so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so), str(cu)],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    return jobs


def finish_copies(jobs):
    """{name: dft_flash_fwd} of the copies start_copies built."""
    import ctypes

    from deepflows_tpu_torch.ops._common import F, I, P

    fns = {}
    for name, (so, proc) in jobs.items():
        if proc.wait() != 0:
            raise SystemExit(f"flash_fwd_ab: nvcc failed on the copy {name!r}")
        fn = ctypes.CDLL(str(so)).dft_flash_fwd
        fn.argtypes = [P] * 6 + [F, I, P]  # as ops/flash_attention.py binds it
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


@contextlib.contextmanager
def forward_from(fn):
    """ops.flash_attention_fwd calls ``fn`` in place of the package's
    dft_flash_fwd while the block runs."""
    from deepflows_tpu_torch.ops import _build

    intact = _build._functions["dft_flash_fwd"]
    _build._functions["dft_flash_fwd"] = fn
    try:
        yield
    finally:
        _build._functions["dft_flash_fwd"] = intact


def check_cases(torch, ops, cs, g, label):
    """Holds the forward and backward on every case of chip_smoke.py, each on
    the route it must take; returns None, or what failed."""
    B, H, L, D = slice_shape(cs)
    try:
        cs.flash_case(torch, ops, g, B, H, L, L, D, True, None, torch.bfloat16,
                      f"slice {label}", want_route="wgmma")
        for case in cs.FLASH_RAGGED:
            cs.flash_case(torch, ops, g, *case, torch.bfloat16, f"{case} {label}",
                          want_route="mma" if case[4] % 8 else "wgmma")
        for *case, layout in cs.FLASH_MISALIGNED:
            cs.flash_case(torch, ops, g, *case, torch.bfloat16, f"{tuple(case)} {layout} {label}",
                          layout, "mma")
        cs.flash_case(torch, ops, g, B, H, L, L, D, True, None, torch.bfloat16,
                      f"heads view {label}", "heads", "wgmma")
    except SystemExit as e:  # chip_smoke.fail
        return str(e)
    return None


def check():
    import tempfile
    from pathlib import Path

    import torch

    if not torch.cuda.is_available():
        print("flash_fwd_ab: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    cs = load_chip_smoke()
    from deepflows_tpu_torch import ops
    from deepflows_tpu_torch.ops import _build
    from deepflows_tpu_torch.ops._common import F, I, P

    fa = importlib.import_module("deepflows_tpu_torch.ops.flash_attention")
    card = cs.card_line()
    print(card)
    _build.build_all()
    kernels, warnings = ptxas_report(_build.BUILD / _build.source_hash())
    for w in warnings:
        print("  ptxas:", w)
    for name, (regs, spill) in sorted(kernels.items()):
        print(f"  {name}: {regs} registers; {spill}")
    if len(kernels) != 2 or any(r != ENTRY_REGS for r, _ in kernels.values()):
        print(f"flash_fwd_ab: expected 2 wgmma instances of {ENTRY_REGS} registers at entry; "
              f"not launching them", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev).zero_
    B, H, L, D = slice_shape(cs)
    q, k, v, _ = operands(torch, g, B, H, L, D)
    intact = _build.c_function("flash_attention", "dft_flash_fwd", [P] * 6 + [F, I, P])
    with tempfile.TemporaryDirectory() as tmp:
        jobs = start_copies(Path(tmp), {**SWEEP, **MUTANTS})
        failed = check_cases(torch, ops, cs, g, "(128, 3)")
        fns = finish_copies(jobs)
    results = {}
    for name in [(128, 3), *SWEEP]:
        with forward_from(intact if name == (128, 3) else fns[name]):
            bad = failed if name == (128, 3) else check_cases(torch, ops, cs, g, str(name))
            a, b = ops.flash_attention_fwd(q, k, v, True), ops.flash_attention_fwd(q, k, v, True)
            if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                bad = (bad or "") + "; two calls differ"
            ms = cs.event_ms(lambda: ops.flash_attention_fwd(q, k, v, True), 10, flush)
        results[name] = bad
        print(f"  key tile, slots {name}: {bad or 'every case passed, two calls bitwise equal'}; "
              f"{ms * 1e3:.2f} us, {fwd_flops(B, H, L, D) / ms / 1e9:.1f} TFLOP/s", flush=True)
    route = fa._fwd_route
    try:
        fa._fwd_route = lambda q, k, v: "mma"
        mma = cs.event_ms(lambda: ops.flash_attention_fwd(q, k, v, True), 10, flush)
    finally:
        fa._fwd_route = route
    sdpa = cs.event_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True), 10, flush)
    print(f"  mma.sync route {mma * 1e3:.2f} us, scaled_dot_product_attention "
          f"{sdpa * 1e3:.2f} us; {card}")
    for b, h, l, causal in SHAPES:
        qs, ks, vs, _ = operands(torch, g, b, h, l, D)
        ms = cs.event_ms(lambda: ops.flash_attention_fwd(qs, ks, vs, causal), 10, flush)
        lib = cs.event_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qs, ks, vs, is_causal=causal), 10, flush)
        n = l // 128
        tiles = b * h * (n * (n + 1) // 2 if causal else n * n)
        print(f"  {(b, h, l, D)} {'causal' if causal else 'full'}: {b * h * n} blocks, {tiles} "
              f"block tiles; {ms * 1e3:.2f} us, scaled_dot_product_attention {lib * 1e3:.2f} us")
    print(f"  where a key tile's time goes, {(B, H, L, D)}, us causal / full, each cut from a "
          f"copy of the source:")
    for name in ("intact", *MUTANTS):
        with forward_from(intact if name == "intact" else fns[name]):
            t = [cs.event_ms(lambda c=c: ops.flash_attention_fwd(q, k, v, c), 10, flush)
                 for c in (True, False)]
        print(f"    {name}: {t[0] * 1e3:.2f} / {t[1] * 1e3:.2f}")
    return 1 if results[(128, 3)] else 0


def host_us(torch, fns):
    """{name: host µs a call} of each function of ``fns``: HOST_CALLS calls
    back to back (at a shape whose device work is far shorter than the
    host's, so the queue never holds them up), the median of HOST_RUNS such
    runs, the functions' runs interleaved."""
    import time

    runs = {name: [] for name in fns}
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    for _ in range(HOST_RUNS):
        for name, fn in fns.items():
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            runs[name].append((time.perf_counter() - t0) * 1e6 / HOST_CALLS)
            torch.cuda.synchronize()
    return {name: statistics.median(r) for name, r in runs.items()}


def entry_calls(torch, fa, q, k, v):
    """The forward's new work a call, for host_us: the route's check, and
    the C entry with a header built ahead on the wgmma route (three tensor
    maps encoded, then the launch) and on the mma.sync route (the launch)."""
    from deepflows_tpu_torch.ops import _build
    from deepflows_tpu_torch.ops._common import F, I, P, stream

    fn = _build.c_function("flash_attention", "dft_flash_fwd", (P, P, P, P, P, P, F, I, P))
    out = fa._new_like_heads(q)
    lse = torch.empty((q.shape[0] * q.shape[1], q.shape[2]), dtype=torch.float32, device=q.device)
    ptrs = [t.data_ptr() for t in (q, k, v, out, lse)]
    calls = {"route check": lambda: fa._fwd_route(q, k, v)}
    for route in ("wgmma", "mma"):
        meta = fa._meta(q, k, True, None, (q, k, v, out), (fa.ROUTES.index(route),))
        if fn(meta, *ptrs, 1.0, 1, stream()) != 0:
            raise SystemExit(f"flash_fwd_ab: the C entry refused the {route} route")
        calls[f"C entry, {route} route"] = lambda meta=meta: fn(meta, *ptrs, 1.0, 1, stream())
    return calls


def train_runs(torch, cs):
    """The bf16 bench-row step: device ms by kernel over two steps, one
    step's device ms with its launches queued ahead, and the median wall ms
    of WALL_STEPS steps."""
    import time

    import numpy as np

    import deepflows_tpu_torch as dt
    from deepflows_tpu_torch import nn, optim
    from deepflows_tpu_torch.jit import CompiledTrainStep
    from deepflows_tpu_torch.models import TransformerLM

    dt.manual_seed(0)
    lm = TransformerLM(**cs.TRAIN, device="cuda", flash=True)
    step = CompiledTrainStep(lm.trunk(), optim.Adam(lm.parameters(), **cs.ADAM, fused=True),
                             nn.LMHeadCrossEntropy(lm.head), compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(0)
    V = cs.TRAIN["vocab_size"]
    x, y = (torch.as_tensor(rng.integers(0, V, (cs.TRAIN_B, cs.TRAIN_L)).astype(np.int32),
                            device="cuda") for _ in range(2))
    for _ in range(cs.WARMUP):
        step(x, y)
    wall = []
    for _ in range(WALL_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        float(step(x, y))
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    prof = cs.step_profile(torch, step, x, y)
    return {"profile_ms": prof, "profile_total_ms": sum(prof.values()),
            "step_device_ms": cs.event_ms(lambda: step(x, y), 3),
            "step_wall_ms": statistics.median(wall)}


def child(tree):
    """One tree's timings, printed as one JSON line."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    cs = load_chip_smoke()
    from deepflows_tpu_torch import ops
    from deepflows_tpu_torch.ops import _build

    if not ops.__file__.startswith(os.path.abspath(tree)):
        raise SystemExit(f"imported {ops.__file__}, not the tree {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev).zero_
    B, H, L, D = slice_shape(cs)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = {}
    for label, view in (("contiguous", False), ("heads view", True)):
        q, k, v, do = operands(torch, g, B, H, L, D, view)
        out[f"forward {label}"] = {
            "kernel": cs.event_ms(lambda: ops.flash_attention_fwd(q, k, v, True), 20, flush),
            "library": cs.event_ms(lambda: sdpa(q, k, v, is_causal=True), 20, flush)}
    q, k, v, do = operands(torch, g, B, H, L, D)
    o, lse = ops.flash_attention_fwd(q, k, v, True)
    qr, kr, vr = (a.detach().requires_grad_() for a in (q, k, v))
    ref = sdpa(qr, kr, vr, is_causal=True)
    out["backward"] = {
        "kernel": cs.event_ms(lambda: ops.flash_attention_bwd(q, k, v, o, lse, do, True), 20,
                              flush),
        "library": cs.event_ms(lambda: torch.autograd.grad(ref, (qr, kr, vr), do,
                                                           retain_graph=True), 20, flush)}
    q, k, v, do = operands(torch, g, *HOST_SHAPE, True)  # head views, as the model passes them
    o, lse = ops.flash_attention_fwd(q, k, v, True)
    calls = {"forward": lambda: ops.flash_attention_fwd(q, k, v, True),
             "backward": lambda: ops.flash_attention_bwd(q, k, v, o, lse, do, True)}
    fa = importlib.import_module("deepflows_tpu_torch.ops.flash_attention")
    if hasattr(fa, "_fwd_route"):
        calls.update(entry_calls(torch, fa, q, k, v))
    host = host_us(torch, calls)
    print(json.dumps(dict(tree=tree, flash=out, host_us=host, train=train_runs(torch, cs))))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("trees", nargs="*")
    parser.add_argument("--check", action="store_true",
                        help="build and check this tree's kernel and its sweep; no A/B")
    parser.add_argument("--child", metavar="TREE", help=argparse.SUPPRESS)
    parser.add_argument("--report", metavar="PATH",
                        help="also write every run to PATH as JSON")
    args = parser.parse_args()
    if args.check:
        return check()
    if args.child:
        return child(args.child)
    import torch

    if not torch.cuda.is_available() or len(args.trees) < 2:
        print("flash_fwd_ab: needs a CUDA card and two trees", file=sys.stderr)
        return 1
    cs = load_chip_smoke()
    card = cs.card_line()
    order = args.trees + args.trees[::-1]
    runs = []
    for tree in order:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree],
                             capture_output=True, text=True, cwd=ROOT)
        if out.returncode != 0:
            print(out.stdout[-3000:], out.stderr[-6000:], file=sys.stderr)
            return out.returncode
        runs.append(json.loads(out.stdout.strip().splitlines()[-1]))
        print(f"timed {tree}", flush=True)
    by_tree = {t: [r for r in runs if r["tree"] == t] for t in args.trees}

    def med(tree, get):
        return statistics.median(get(r) for r in by_tree[tree])

    def row(label, get, unit=1e3, fmt="{:.2f}"):
        vals = [med(t, get) * unit for t in args.trees]
        print(f"  {label}: " + " / ".join(fmt.format(v) for v in vals))

    B, H, L, D = slice_shape(cs)
    flops = fwd_flops(B, H, L, D)
    print(card)
    print(f"us a call at (B, H, L, D) = {(B, H, L, D)}, causal, bf16 (median of each tree's "
          f"runs), L2 flushed: " + " / ".join(args.trees))
    for key in runs[0]["flash"]:
        for kind in ("kernel", "library"):
            row(f"{key} {kind}", lambda r, key=key, kind=kind: r["flash"][key][kind])
    row("forward contiguous, TFLOP/s", lambda r: flops / r["flash"]["forward contiguous"]["kernel"]
        / 1e9, 1, "{:.1f}")
    print(f"host us a call, head views {HOST_SHAPE}, {HOST_RUNS} runs of {HOST_CALLS} calls "
          f"interleaved:")
    for name in ("forward", "backward"):
        row(f"{name} wrapper" + (" (unchanged code)" if name == "backward" else ""),
            lambda r, name=name: r["host_us"][name], 1)
    for t in args.trees:
        new = [n for n in by_tree[t][0]["host_us"] if n not in ("forward", "backward")]
        if new:
            print(f"  the forward's new work in {t}: " + ", ".join(
                f"{n} {med(t, lambda r, n=n: r['host_us'][n]):.2f}" for n in new))
    print(f"bf16 training step, ms: wall (median of {WALL_STEPS} steps), then device:")
    row("wall", lambda r: r["train"]["step_wall_ms"], 1, "{:.3f}")
    row("by kernel, sum of torch.profiler (2 steps)",
        lambda r: r["train"]["profile_total_ms"], 1, "{:.3f}")
    row("one step, launches queued ahead", lambda r: r["train"]["step_device_ms"], 1, "{:.3f}")
    for name in runs[0]["train"]["profile_ms"]:
        row(name, lambda r, name=name: r["train"]["profile_ms"].get(name, 0.0), 1, "{:.3f}")
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(dict(card=card, order=order, runs=runs), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
