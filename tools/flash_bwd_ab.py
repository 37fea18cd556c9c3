#!/usr/bin/env python3
"""Check and time flash_attention's bf16 backward on one CUDA card.

    python3 tools/flash_bwd_ab.py --check
    python3 tools/flash_bwd_ab.py --family
    python3 tools/flash_bwd_ab.py PARENT_TREE CHANGE_TREE [--report PATH]

``--family`` times, in this tree, the backward at the family's training
shapes as chip_smoke.family_flash_case makes them ((1, 32, 8192, 128)
with window 4096 and (1, 32, 2048, 128) causal; q and dout (B, L, H, D)
head views, K and V contiguous) beside the backward of
scaled_dot_product_attention on the same operands, its band as a boolean
mask where there is a window, as that case times SDPA's forward; CUDA
events, L2 flushed; and each shape's bound (chip_smoke.cost_bound), all
printed, the last line as JSON.

``--check`` builds the kernels of this tree, prints ptxas's report of the
wgmma backward (registers, spills, warnings) and refuses to launch it unless
each of its two instances (D 64 and 128) holds the 168 registers a thread
that its register hand-over (setmaxnreg) counts on, with no spill.  It also
builds copies of csrc/flash_attention.cu with other choices of the dK/dV
role's query tile and the ring's slots (``SWEEP``, each an edit of the
one line that sets them; a copy whose ptxas report spills or whose shared
memory the card refuses is reported and not run, and the copies that pass
still run when the kernel itself fails the gate) and with parts cut out
(``MUTANTS``: the softmax and dS arithmetic, the streamed loads after the
ring's first fill, or one of the two block roles).  The kernel and each
sweep copy are held against the plain twins at chip_smoke.py's limits,
each case on the forward and backward route it must take: the slice's
shape, its ragged shapes (chip_smoke.FLASH_RAGGED), the views TMA cannot
read (chip_smoke.FLASH_MISALIGNED), those where dout alone is such a view
(chip_smoke.FLASH_DOUT_MISALIGNED) and its head views; two slice-shape
backward calls must give the same bits; and each is timed at the slice's
shape.  Then it times the mma.sync route and the backward of
scaled_dot_product_attention there, the kernel beside that backward at
the other (B, H, L) of flash_fwd_ab.SHAPES (D 128), and the mutants beside
the kernel at the slice's shape, causal and not, to see where the time
goes: those copies compute wrong values and are never checked.  It exits
non-zero if the kernel fails anything.

With two or more trees (directories that hold a deepflows_tpu_torch
package: an unpacked ``git archive`` of another commit, or ``.``), each is
imported in its own process, in the order A, B, B, A, so drift of the card
over the call shows as a difference between the two runs of one tree.
Every run builds its tree's kernels, then times, on inputs from the same
seeds:

- with CUDA events (chip_smoke.event_ms, L2 flushed between launches): the
  backward at the slice's shape (B 8, H 8, L 1024, D 128, causal, bf16) on
  contiguous (B, H, L, D) tensors and on (B, L, H, D) head views, beside
  the backward of scaled_dot_product_attention; the delta pass alone (in a
  tree with the C entry dft_flash_bwd_delta, that entry; else the torch
  expression the wrapper ran); the forward (unchanged code: the control);
- on the host's clock (flash_fwd_ab.host_us), on head views of
  ``HOST_SHAPE``: the backward wrapper's time a call;
- a bf16 bench-row training step (flash_fwd_ab.train_runs): its device time
  by kernel group over two steps, one step with its launches queued ahead,
  and the median wall time of ``WALL_STEPS`` steps.

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
from flash_fwd_ab import (  # noqa: E402
    ENTRY_REGS, HOST_SHAPE, SHAPES, WALL_STEPS, host_us, operands, slice_shape, train_runs)
from int8_decode_ab import ROOT, load_chip_smoke  # noqa: E402


def bwd_flops(B, H, L, D):
    """FLOPs of the causal backward's five products over the kept pairs."""
    return 5 * 2 * B * H * (L * (L + 1) // 2) * D


def ptxas_report(log):
    """{kernel: (registers, spill line)} of every wgmma backward instance in
    a ptxas log, and its warnings."""
    kernels, warnings, name = {}, [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
        if "warning" in line:
            warnings.append(line.strip())
        if name and "flash_bwd_wgmma" in name:
            if "spill" in line:
                kernels.setdefault(name, [None, None])[1] = line.strip()
            m = re.search(r"Used (\d+) registers", line)
            if m:
                kernels.setdefault(name, [None, None])[0] = int(m.group(1))
    return kernels, warnings


def gate(kernels):
    """None if there are two instances, each of ENTRY_REGS registers with no
    spill, else why not."""
    if len(kernels) != 2:
        return f"{len(kernels)} wgmma backward instances, not 2"
    for name, (regs, spill) in kernels.items():
        if regs != ENTRY_REGS:
            return f"{name} has {regs} registers at entry, not {ENTRY_REGS}"
        if spill is None or not re.search(r"0 bytes spill stores, 0 bytes spill loads", spill):
            return f"{name} spills: {spill}"
    return None


# Edits made in copies of csrc/flash_attention.cu (each (old, new) must
# match the source once).  SWEEP: the dK/dV role's other query tiles and
# ring slots, named (query tile, slots); the source's own is OWN.
OWN = (64, 3)
TILE_LINE = "constexpr int BQT = {}, BST = {};\n"
SWEEP = {plan: ((TILE_LINE.format(*OWN), TILE_LINE.format(*plan)),)
         for plan in ((64, 2), (128, 2))}
# MUTANTS: parts cut out, to see where the time goes
NO_SOFTMAX = ("        const float p = hide ? 0.f : exp2_ftz(x[i] * sl2 - l2);\n"
              "        x[i] = p;\n"
              "        dp[i] = p * (dp[i] - de) * scale;\n", "")
NO_LOADS = ("    mbar_wait(r.empty + s, ph ^ 1);\n",
            "    mbar_wait(r.empty + s, ph ^ 1);\n"
            "    if (i >= BST) {\n"
            "      mbar_arrive(r.full + s);\n"
            "      continue;\n"
            "    }\n")
ROLE_LINE = "  const int n = t1 > t0 ? t1 - t0 : 0;\n"
DQ_ONLY = (ROLE_LINE, ROLE_LINE + "  if (!dq) return;\n")
DKV_ONLY = (ROLE_LINE, ROLE_LINE + "  if (dq) return;\n")
MUTANTS = {"no softmax or dS": (NO_SOFTMAX,), "no streamed loads": (NO_LOADS,),
           "dQ role alone": (DQ_ONLY,), "dK/dV role alone": (DKV_ONLY,)}


def bwd_argtypes():
    """dft_flash_bwd's ctypes argument types, as ops/flash_attention.py binds it."""
    from deepflows_tpu_torch.ops._common import F, I, P

    return [P] * 11 + [F, I, P]


def start_copies(build_dir, copies):
    """Starts one nvcc for each copy of csrc/flash_attention.cu with its
    edits ({name: edits}), with the package's flags, into ``build_dir``;
    returns {name: (library path, log path, process)}."""
    from deepflows_tpu_torch.ops import _build

    src = (_build.CSRC / "flash_attention.cu").read_text()
    jobs = {}
    for name, edits in copies.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"flash_bwd_ab: the edit {old!r} does not match the source once")
            text = text.replace(old, new)
        stem = re.sub(r"\W", "_", str(name))
        cu, so, log = (build_dir / f"{stem}{ext}" for ext in (".cu", ".so", ".log"))
        cu.write_text(text)
        with open(log, "w") as f:
            jobs[name] = so, log, subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
                 str(cu)], stdout=f, stderr=subprocess.STDOUT)
    return jobs


def finish_copies(jobs):
    """{name: (dft_flash_bwd, ptxas log)} of the copies start_copies built."""
    import ctypes

    fns = {}
    for name, (so, log, proc) in jobs.items():
        if proc.wait() != 0:
            raise SystemExit(f"flash_bwd_ab: nvcc failed on the copy {name!r}:\n"
                             + log.read_text()[-3000:])
        fn = ctypes.CDLL(str(so)).dft_flash_bwd
        fn.argtypes, fn.restype = bwd_argtypes(), ctypes.c_int
        fns[name] = fn, log.read_text()
    return fns


@contextlib.contextmanager
def backward_from(fn):
    """ops.flash_attention_bwd calls ``fn`` in place of the package's
    dft_flash_bwd while the block runs."""
    from deepflows_tpu_torch.ops import _build

    intact = _build._functions["dft_flash_bwd"]
    _build._functions["dft_flash_bwd"] = fn
    try:
        yield
    finally:
        _build._functions["dft_flash_bwd"] = intact


def check_cases(torch, ops, cs, g, label):
    """Holds the forward and backward on every flash case of chip_smoke.py,
    each on the routes it must take; returns None, or what failed."""
    B, H, L, D = slice_shape(cs)
    bf = torch.bfloat16
    try:
        cs.flash_case(torch, ops, g, B, H, L, L, D, True, None, bf, f"slice {label}",
                      want_route="wgmma", want_bwd_route="wgmma")
        for case in cs.FLASH_RAGGED:
            route = "mma" if case[4] % 8 else "wgmma"
            cs.flash_case(torch, ops, g, *case, bf, f"{case} {label}", want_route=route,
                          want_bwd_route=route)
        for *case, layout in cs.FLASH_MISALIGNED:
            cs.flash_case(torch, ops, g, *case, bf, f"{tuple(case)} {layout} {label}", layout,
                          "mma", "mma")
        for *case, layout in cs.FLASH_DOUT_MISALIGNED:
            cs.flash_case(torch, ops, g, *case, bf, f"{tuple(case)} dout {layout} {label}",
                          "contiguous", "wgmma", "mma", layout)
        cs.flash_case(torch, ops, g, B, H, L, L, D, True, None, bf, f"heads view {label}",
                      "heads", "wgmma", "wgmma")
    except SystemExit as e:  # chip_smoke.fail
        return str(e)
    return None


def sdpa_backward(torch, q, k, v, do, causal):
    """A function that runs the backward of scaled_dot_product_attention on
    these operands."""
    qr, kr, vr = (a.detach().requires_grad_() for a in (q, k, v))
    ref = torch.nn.functional.scaled_dot_product_attention(qr, kr, vr, is_causal=causal)
    return lambda: torch.autograd.grad(ref, (qr, kr, vr), do, retain_graph=True)


def check():
    import tempfile
    from pathlib import Path

    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_ab: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    cs = load_chip_smoke()
    from deepflows_tpu_torch import ops
    from deepflows_tpu_torch.ops import _build

    fa = importlib.import_module("deepflows_tpu_torch.ops.flash_attention")
    card = cs.card_line()
    print(card)
    with tempfile.TemporaryDirectory() as tmp:
        jobs = start_copies(Path(tmp), {**SWEEP, **MUTANTS})  # nvcc runs beside the package's
        _build.build_all()
        kernels, warnings = ptxas_report(
            (_build.BUILD / _build.source_hash() / "flash_attention.log").read_text())
        for w in warnings:
            print("  ptxas:", w)
        for name, (regs, spill) in sorted(kernels.items()):
            print(f"  {name}: {regs} registers; {spill}")
        refused = gate(kernels)
        if refused:  # the sweep's copies that pass the gate still run
            print(f"flash_bwd_ab: {refused}; not launching the kernel", file=sys.stderr)
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(2)
        flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev).zero_
        B, H, L, D = slice_shape(cs)
        q, k, v, do = operands(torch, g, B, H, L, D)
        o, lse = ops.flash_attention_fwd(q, k, v, True)
        intact = _build.c_function("flash_attention", "dft_flash_bwd", bwd_argtypes())
        failed = refused or check_cases(torch, ops, cs, g, str(OWN))
        fns = finish_copies(jobs)

    def run():
        return ops.flash_attention_bwd(q, k, v, o, lse, do, True)

    results = {}
    for name in [OWN, *SWEEP]:
        if name == OWN:
            fn, bad = intact, failed
            if refused:
                results[name] = refused
                continue
        else:
            fn, log = fns[name]
            copy_kernels, _ = ptxas_report(log)
            print(f"  query tile, slots {name}: " + "; ".join(
                f"{n[-40:]}: {r} registers, {s}" for n, (r, s) in sorted(copy_kernels.items())))
            bad = gate(copy_kernels)
            if bad:
                print(f"  query tile, slots {name}: not run ({bad})", flush=True)
                results[name] = bad
                continue
        with backward_from(fn):
            try:
                if name != OWN:
                    bad = check_cases(torch, ops, cs, g, str(name))
                a, b = run(), run()
            except RuntimeError as e:  # a launch the card refuses (shared memory)
                print(f"  query tile, slots {name}: not run ({e})", flush=True)
                results[name] = str(e)
                continue
            if not all(torch.equal(x, y) for x, y in zip(a, b)):
                bad = (bad or "") + "; two calls differ"
            ms = cs.event_ms(run, 10, flush)
        results[name] = bad
        print(f"  query tile, slots {name}: "
              f"{bad or 'every case passed, two calls bitwise equal'}"
              f"; {ms * 1e3:.2f} us, {bwd_flops(B, H, L, D) / ms / 1e9:.1f} TFLOP/s", flush=True)
    if refused:
        return 1
    route = fa._bwd_route
    try:
        fa._bwd_route = lambda q, k, v, do: "mma"
        mma = cs.event_ms(run, 10, flush)
    finally:
        fa._bwd_route = route
    lib = cs.event_ms(sdpa_backward(torch, q, k, v, do, True), 10, flush)
    print(f"  mma.sync route {mma * 1e3:.2f} us, the backward of scaled_dot_product_attention "
          f"{lib * 1e3:.2f} us; {card}")
    for b, h, l, causal in SHAPES:
        qs, ks, vs, dos = operands(torch, g, b, h, l, D)
        os_, ls_ = ops.flash_attention_fwd(qs, ks, vs, causal)
        ms = cs.event_ms(lambda: ops.flash_attention_bwd(qs, ks, vs, os_, ls_, dos, causal), 10,
                         flush)
        lib = cs.event_ms(sdpa_backward(torch, qs, ks, vs, dos, causal), 10, flush)
        flops = bwd_flops(b, h, l, D) if causal else 5 * 2 * b * h * l * l * D
        print(f"  {(b, h, l, D)} {'causal' if causal else 'full'}: {ms * 1e3:.2f} us "
              f"({flops / ms / 1e9:.1f} TFLOP/s), the backward of scaled_dot_product_attention "
              f"{lib * 1e3:.2f} us", flush=True)
    print(f"  where the time goes, {(B, H, L, D)}, us causal / full, each cut from a copy of the "
          f"source:")
    for name in ("intact", *MUTANTS):
        with backward_from(intact if name == "intact" else fns[name][0]):
            t = []
            for c in (True, False):
                oc, lc = ops.flash_attention_fwd(q, k, v, c)
                t.append(cs.event_ms(lambda: ops.flash_attention_bwd(q, k, v, oc, lc, do, c), 10,
                                     flush))
        print(f"    {name}: {t[0] * 1e3:.2f} / {t[1] * 1e3:.2f}", flush=True)
    print(f"  {card}")
    return 1 if results[OWN] else 0


def delta_call(torch, fa, q, k, do, o, lse):
    """The delta pass alone, as the wgmma route runs it: the C entry
    dft_flash_bwd_delta where the tree has it (delta and lse log2e into
    padded rows), else the torch expression its wrapper ran."""
    from deepflows_tpu_torch.ops import _build
    from deepflows_tpu_torch.ops._common import I, P, stream

    b, h, lq, _ = q.shape
    lib = _build.build_all()["flash_attention"]
    if not hasattr(lib, "dft_flash_bwd_delta"):
        return "torch expression", lambda: (do.float() * o.float()).sum(-1).reshape(
            b * h, lq).contiguous()
    fn = _build.c_function("flash_attention", "dft_flash_bwd_delta", (P, P, P, P, P, I, P))
    ld, planes = fa._stats_layout("wgmma", lq)
    stats = torch.empty((planes, b * h, ld), dtype=torch.float32, device=q.device)
    meta = fa._meta(q, k, True, None, (q, k, q, do, q, k, k),
                    (fa.ROUTES.index("wgmma"), *o.stride()[:3], ld))

    def call():
        if fn(meta, do.data_ptr(), o.data_ptr(), lse.data_ptr(), stats.data_ptr(), 1,
              stream()) != 0:
            raise SystemExit("flash_bwd_ab: the delta pass failed to launch")
    return "kernel", call


def child(tree):
    """One tree's timings, printed as one JSON line."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    cs = load_chip_smoke()
    from deepflows_tpu_torch import ops
    from deepflows_tpu_torch.ops import _build

    if not ops.__file__.startswith(os.path.abspath(tree)):
        raise SystemExit(f"imported {ops.__file__}, not the tree {tree}")
    fa = importlib.import_module("deepflows_tpu_torch.ops.flash_attention")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev).zero_
    B, H, L, D = slice_shape(cs)
    out = {}
    for label, view in (("contiguous", False), ("heads view", True)):
        q, k, v, do = operands(torch, g, B, H, L, D, view)
        o, lse = ops.flash_attention_fwd(q, k, v, True)
        out[f"backward {label}"] = {
            "kernel": cs.event_ms(lambda: ops.flash_attention_bwd(q, k, v, o, lse, do, True), 20,
                                  flush),
            "library": cs.event_ms(sdpa_backward(torch, q, k, v, do, True), 20, flush)}
    kind, call = delta_call(torch, fa, q, k, do, o, lse)  # head views, as the model passes them
    out["delta pass"] = {"kernel": cs.event_ms(call, 20, flush), "kind": kind}
    q, k, v, do = operands(torch, g, B, H, L, D)
    out["forward (control)"] = {
        "kernel": cs.event_ms(lambda: ops.flash_attention_fwd(q, k, v, True), 20, flush)}
    q, k, v, do = operands(torch, g, *HOST_SHAPE, True)
    o, lse = ops.flash_attention_fwd(q, k, v, True)
    host = host_us(torch, {"backward": lambda: ops.flash_attention_bwd(q, k, v, o, lse, do, True)})
    print(json.dumps(dict(tree=tree, flash=out, host_us=host, train=train_runs(torch, cs))))


def family():
    """--family: the kernel's and SDPA's backward at the family's shapes."""
    import torch

    if not torch.cuda.is_available():
        print("flash_bwd_ab: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    cs = load_chip_smoke()
    from deepflows_tpu_torch import ops
    from deepflows_tpu_torch.ops import _build

    _build.build_all()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(12)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev).zero_
    out = {}
    for L, window in ((cs.LLAMA_TRAIN["max_len"], cs.LLAMA_TRAIN["window"]),
                      (cs.MIXTRAL_TRAIN["max_len"], None)):
        q, do = (cs.flash_operand(torch, g, 1, 32, L, 128, torch.bfloat16, "heads")
                 for _ in range(2))
        k, v = (cs.flash_operand(torch, g, 1, 32, L, 128, torch.bfloat16, "contiguous")
                for _ in range(2))
        o, lse = ops.flash_attention_fwd(q, k, v, True, None, window)
        mask = None
        if window:
            i = torch.arange(L, device=dev)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        qr, kr, vr = (a.detach().requires_grad_() for a in (q, k, v))
        ref = torch.nn.functional.scaled_dot_product_attention(qr, kr, vr, attn_mask=mask,
                                                               is_causal=mask is None)
        r = dict(kernel_ms=cs.event_ms(lambda: ops.flash_attention_bwd(
                     q, k, v, o, lse, do, True, None, window), 5, flush),
                 library_ms=cs.event_ms(lambda: torch.autograd.grad(
                     ref, (qr, kr, vr), do, retain_graph=True), 5, flush))
        r["bound_ms"], r["bound_by"] = cs.cost_bound(ops.flash_attention_bwd, q, k, v, o, lse,
                                                     do, True, None, window)
        out[f"(1, 32, {L}, 128) window {window}"] = r
        print(f"(1, 32, {L}, 128) window {window}: backward {r['kernel_ms']:.4f} ms, the "
              f"backward of scaled_dot_product_attention {r['library_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
        del q, k, v, do, o, lse, mask, qr, kr, vr, ref
        cs.free_card(torch)
    card = cs.card_line()
    print(card)
    print(json.dumps({"family_backward": out, "card": card}))
    return 0


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("trees", nargs="*")
    parser.add_argument("--check", action="store_true",
                        help="build and check this tree's kernel and its sweep; no A/B")
    parser.add_argument("--family", action="store_true",
                        help="time this tree's backward and SDPA's at the family's shapes")
    parser.add_argument("--child", metavar="TREE", help=argparse.SUPPRESS)
    parser.add_argument("--report", metavar="PATH",
                        help="also write every run to PATH as JSON")
    args = parser.parse_args()
    if args.check:
        return check()
    if args.family:
        return family()
    if args.child:
        return child(args.child)
    import torch

    if not torch.cuda.is_available() or len(args.trees) < 2:
        print("flash_bwd_ab: needs a CUDA card and two trees", file=sys.stderr)
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
    flops = bwd_flops(B, H, L, D)
    print(card)
    print(f"us a call at (B, H, L, D) = {(B, H, L, D)}, causal, bf16 (median of each tree's "
          f"runs), L2 flushed: " + " / ".join(args.trees))
    for key, val in runs[0]["flash"].items():
        for kind in ("kernel", "library"):
            if kind in val:
                row(f"{key} {kind}", lambda r, key=key, kind=kind: r["flash"][key][kind])
    print("  delta pass: " + " / ".join(by_tree[t][0]["flash"]["delta pass"]["kind"]
                                        for t in args.trees))
    row("backward contiguous, TFLOP/s (5 products)",
        lambda r: flops / r["flash"]["backward contiguous"]["kernel"] / 1e9, 1, "{:.1f}")
    print(f"host us a call of the backward wrapper, head views {HOST_SHAPE}:")
    row("backward wrapper", lambda r: r["host_us"]["backward"], 1)
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
