#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (deepflows_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

It needs one CUDA card and exits non-zero without one; it never runs on the
CPU instead.  It imports nothing of JAX or of the JAX package.

1. Build: compiles every kernel of deepflows_tpu_torch/csrc with nvcc (one
   process per source, started together) and prints ptxas's resource report.
2. Kernel phase: each kernel of the serving path (int8_matmul, w8a8_matmul)
   against its plain PyTorch twin on the card, at the decoder's shapes of the
   d1024 x 12, V8192 model — (K, N) of qkv, o, fc1, fc2 and head, at decode
   M = 8 and prefill M = 8 * 192 — for x in bf16 and f32 and both output
   dtypes, then at ragged shapes and on a misaligned weight, which take the
   kernels' masked edges.  Tolerances: w8a8 exact; int8 with f32 output
   rtol 1e-4 and atol 1e-3 (the JAX tests' bound); bf16 output that bound
   plus one bf16 ulp.  Times each
   shape and one whole decode step's 49 calls with CUDA events, beside the
   plain twin, torch.matmul on the pre-dequantised weight (int8 only) and
   the card's bound.  f32 products run without TF32
   (torch.backends.cuda.matmul.allow_tf32 = False) in every comparison.
3. Slice phase, the main path: TransformerLM(vocab 8192, max_len 192,
   dim 1024, depth 12, heads 8) with random weights from a seed, served by
   KVCacheDecoder in bf16 with quant None, "int8" and "w8a8", three requests
   each.  Launch counts are zeroed just before and read just after; each
   quantised decoder must launch its kernel 49 times per prefill and per
   decode step, and every output must be in the vocabulary.  Each decoder's
   prefill logits are held against the same decoder on a CPU copy of the
   model (plain twins), at the JAX tests' tolerances.  Then the decode
   throughput of each mode, the device busy share of a decode step (its
   device time, timed with its launches queued in advance, over its wall
   time), and the number of aten ops a step dispatches from the host.

Prints the card's name and power limit, one {"kernels": [...]} line, and as
its last line {"ok": true, "device": {...}}.  With ``--report PATH`` it also
writes every measurement (each shape's times, the throughput of each mode)
to PATH as JSON.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
PEAK_OPS = {"bf16": 989e12, "f32": 67e12, "int8": 1979e12}  # dense, per s
MODEL = dict(vocab_size=8192, max_len=192, dim=1024, depth=12, num_heads=8)
SHAPES = {  # (K, N) of every quantised matrix of the model
    "qkv": (1024, 3072), "o": (1024, 1024), "fc1": (1024, 4096),
    "fc2": (4096, 1024), "head": (1024, 8192),
}
RAGGED = (  # (M, K, N, weight 16-byte aligned)
    (1, 1024, 3072, True), (5, 70, 50, True), (8, 33, 17, True), (9, 1000, 300, True),
    (100, 70, 50, True), (129, 256, 300, True), (200, 4100, 33, True), (8, 64, 48, False),
    (70, 96, 64, False),
)
PER_FORWARD = 4 * MODEL["depth"] + 1  # kernel launches per prefill or step
REQUESTS = (  # (batch, prompt, new tokens, sampling)
    (8, 64, 128, {}),
    (8, 17, 50, dict(temperature=0.8, top_k=50, top_p=0.9, seed=1)),
    (1, 5, 20, {}),
)
# max |Δ| / max(1, |ref|) of quantised bf16 prefill logits, as in
# tests/test_decoding.py (bf16 0.1, int8 0.15, w8a8 0.25)
LOGIT_TOL = {None: 0.1, "int8": 0.15, "w8a8": 0.25}


def fail(msg):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def event_ms(fn, reps, flush=None):
    """Median device time of ``fn`` over ``reps`` runs, each bracketed by its
    own CUDA events.  ``flush`` runs between them, outside the events.  Before
    each run the stream spins (``torch.cuda._sleep``) for twice the host time
    ``fn`` takes to enqueue, so the events time the device's work and not the
    host's launch overhead."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(2 * enqueue_s * 2e9) + 100_000
    pairs = []
    for _ in range(reps):
        if flush is not None:
            flush()
        torch.cuda._sleep(cycles)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
        torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def bf16_ulp(t):
    import torch

    _, e = torch.frexp(t.float().abs().clamp_min(2.0**-126))
    return torch.ldexp(torch.ones_like(t, dtype=torch.float32), e - 8)


def bound_ms(nbytes, ops, kind):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def compare(torch, ops, x, wq, s, label, max_err):
    """Both kernels against their plain twins on one (x, wq, s), for f32 and
    bf16 output; fails on the first disagreement."""
    xq, sx = ops.quantize_int8_rows(x)
    for odt, oname in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        got = ops.int8_matmul(x, wq, s, out_dtype=odt)
        want = ops.int8_matmul_plain(x, wq, s, out_dtype=odt)
        d = (got.float() - want.float()).abs()
        if odt == torch.float32:
            bad = d > 1e-3 + 1e-4 * want.abs()
            max_err["int8_matmul"] = max(max_err["int8_matmul"], d.max().item())
        else:  # the f32 bound, then one bf16 rounding step
            bad = d > 1e-3 + 1e-4 * want.float().abs() + bf16_ulp(
                torch.maximum(got.float().abs(), want.float().abs()))
        if bad.any():
            fail(f"int8_matmul {label} out={oname}: max |d| {d.max().item()}")
        got = ops.w8a8_matmul(xq, sx, wq, s, out_dtype=odt)
        want = ops.w8a8_matmul_plain(xq, sx, wq, s, out_dtype=odt)
        if not torch.equal(got, want):
            fail(f"w8a8_matmul {label} out={oname}: not exact, max |d| "
                 f"{(got.float() - want.float()).abs().max().item()}")
    return xq, sx


def kernel_phase(torch, ops, report):
    """Every kernel against its plain twin at the slice's shapes, then at
    ragged shapes that take the kernels' masked edges; returns the largest
    error of each kernel."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()  # evicts the 50 MB L2 between timed launches

    max_err = {"int8_matmul": 0.0, "w8a8_matmul": 0.0}
    rows = []
    for M in (8, 8 * MODEL["max_len"]):
        for xdt, xname in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            for name, (K, N) in SHAPES.items():
                x = torch.randn((M, K), generator=g, device=dev).to(xdt)
                w = torch.randn((K, N), generator=g, device=dev) * 0.02
                wq, s = ops.quantize_int8(w)
                xq, sx = compare(torch, ops, x, wq, s, f"M={M} {name} x={xname}", max_err)
                out_bytes = M * N * x.element_size()
                wdeq = (wq.float() * s).to(xdt)
                reps = 20
                r = dict(M=M, K=K, N=N, shape=name, x=xname, out=xname)
                r["int8_ms"] = event_ms(lambda: ops.int8_matmul(x, wq, s), reps, flush)
                r["int8_plain_ms"] = event_ms(lambda: ops.int8_matmul_plain(x, wq, s), reps, flush)
                r["int8_library_ms"] = event_ms(lambda: torch.matmul(x, wdeq), reps, flush)
                r["int8_bound_ms"], r["int8_bound_by"] = bound_ms(
                    M * K * x.element_size() + K * N + 4 * N + out_bytes,
                    2 * M * K * N, xname)
                r["w8a8_ms"] = event_ms(
                    lambda: ops.w8a8_matmul(xq, sx, wq, s, out_dtype=xdt), reps, flush)
                r["w8a8_plain_ms"] = event_ms(
                    lambda: ops.w8a8_matmul_plain(xq, sx, wq, s, out_dtype=xdt), reps, flush)
                r["w8a8_bound_ms"], r["w8a8_bound_by"] = bound_ms(
                    M * K + 4 * M + K * N + 4 * N + out_bytes, 2 * M * K * N, "int8")
                rows.append(r)
                print(
                    f"  M={M:5d} {name:4s} K={K:4d} N={N:4d} x={xname:4s} | int8 "
                    f"{r['int8_ms']:.4f} ms (plain {r['int8_plain_ms']:.4f}, matmul "
                    f"{r['int8_library_ms']:.4f}, bound {r['int8_bound_ms']:.4f}) | "
                    f"w8a8 {r['w8a8_ms']:.4f} ms (plain {r['w8a8_plain_ms']:.4f}, "
                    f"bound {r['w8a8_bound_ms']:.4f})"
                )
    # ragged M, K and N, one row (B 1 decode), and a weight whose address is
    # not 16-byte aligned, which takes the kernels' bytewise weight loads
    for M, K, N, aligned in RAGGED:
        for xdt in (torch.bfloat16, torch.float32):
            x = torch.randn((M, K), generator=g, device=dev).to(xdt)
            wq, s = ops.quantize_int8(torch.randn((K, N), generator=g, device=dev) * 0.02)
            if not aligned:
                wq = torch.empty(K * N + 1, dtype=torch.int8, device=dev)[1:].view(K, N).copy_(wq)
            compare(torch, ops, x, wq, s, f"ragged M={M} K={K} N={N} aligned={aligned}"
                    f" x={xdt}", max_err)
    print(f"  ragged shapes agree: {[r[:3] for r in RAGGED]}")
    report["kernel_shapes"] = rows
    return max_err


def decode_step_timing(torch, ops):
    """One decode step's 49 kernel calls at M = 8 with bf16 activations, over
    12 layers of distinct weights (so the weights stream from device memory
    as in the decoder): kernel, plain twin and library times beside the
    bound, per kernel."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    M, depth = 8, MODEL["depth"]
    calls = []  # (x, xq, sx, wq, s, wdeq, out_dtype)
    for layer in range(depth + 1):
        names = ("head",) if layer == depth else ("qkv", "o", "fc1", "fc2")
        for name in names:
            K, N = SHAPES[name]
            x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
            wq, s = ops.quantize_int8(torch.randn((K, N), generator=g, device=dev) * 0.02)
            xq, sx = ops.quantize_int8_rows(x)
            odt = torch.float32 if name == "head" else torch.bfloat16
            calls.append((x, xq, sx, wq, s, (wq.float() * s).to(torch.bfloat16), odt))
    assert len(calls) == PER_FORWARD
    run = {
        "int8_matmul": lambda: [ops.int8_matmul(x, wq, s, out_dtype=o)
                                for x, _, _, wq, s, _, o in calls],
        "int8_matmul_plain": lambda: [ops.int8_matmul_plain(x, wq, s, out_dtype=o)
                                      for x, _, _, wq, s, _, o in calls],
        "int8_matmul_library": lambda: [torch.matmul(x, wd) for x, _, _, _, _, wd, _ in calls],
        "w8a8_matmul": lambda: [ops.w8a8_matmul(xq, sx, wq, s, out_dtype=o)
                                for _, xq, sx, wq, s, _, o in calls],
        "w8a8_matmul_plain": lambda: [ops.w8a8_matmul_plain(xq, sx, wq, s, out_dtype=o)
                                      for _, xq, sx, wq, s, _, o in calls],
    }
    ms = {k: event_ms(f, 10) for k, f in run.items()}
    nb_int8 = sum(x.numel() * 2 + wq.numel() + s.numel() * 4
                  + x.shape[0] * wq.shape[1] * (4 if o == torch.float32 else 2)
                  for x, _, _, wq, s, _, o in calls)
    nb_w8a8 = sum(xq.numel() + sx.numel() * 4 + wq.numel() + s.numel() * 4
                  + xq.shape[0] * wq.shape[1] * (4 if o == torch.float32 else 2)
                  for _, xq, sx, wq, s, _, o in calls)
    flops = sum(2 * x.shape[0] * x.shape[1] * wq.shape[1] for x, _, _, wq, _, _, _ in calls)
    weight_bytes = sum(wq.numel() for _, _, _, wq, _, _, _ in calls)
    return ms, bound_ms(nb_int8, flops, "bf16"), bound_ms(nb_w8a8, flops, "int8"), weight_bytes


def dispatched_ops(fn):
    """Runs ``fn`` once and returns (aten ops it dispatched, how many of them
    were views, which launch no kernel)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = views = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += 1
            self.views += bool(getattr(func, "is_view", False))
            return func(*args, **(kwargs or {}))

    with Count() as c:
        fn()
    return c.n, c.views


def rel_err(got, ref):
    return ((got - ref).abs() / ref.abs().clamp_min(1.0)).max().item()


def step_floor(params, kc, vc):
    """The bytes one decode step must move, each read once: every prepared
    weight, scale, bias and norm parameter, B rows of the token table and
    one row of the position table, and the whole K/V cache, which the step
    reads over max_len.  Returns (weight bytes, cache bytes, the least
    time in ms that takes at the card's memory rate)."""

    def nbytes(t):
        if isinstance(t, dict):
            return sum(nbytes(v) for v in t.values())
        if isinstance(t, list):
            return sum(nbytes(v) for v in t)
        return t.numel() * t.element_size()

    weights = nbytes({k: v for k, v in params.items() if k not in ("tok", "pos")})
    rows = (kc.shape[1] + 1) * params["tok"].shape[1] * params["tok"].element_size()
    cache = nbytes([kc, vc])
    return weights, cache, (weights + rows + cache) / HBM_BYTES_PER_S * 1e3


def slice_phase(torch, dt, report):
    """The main path: serve the full-width model through the three decoder
    modes.  Returns the launch counts of the run."""
    import numpy as np

    from deepflows_tpu_torch import ops
    from deepflows_tpu_torch.models import KVCacheDecoder, TransformerLM

    dt.manual_seed(0)
    lm = TransformerLM(**MODEL, device="cuda").eval()
    n_params = sum(p.numel() for p in lm.parameters())
    print(f"model: TransformerLM {MODEL}, {n_params} parameters on "
          f"{lm.tok_embed.weight.device}")
    decs = {q: KVCacheDecoder(lm, compute_dtype=torch.bfloat16, quant=q)
            for q in (None, "int8", "w8a8")}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, MODEL["vocab_size"], (b, p)).astype(np.int64)
               for b, p, _, _ in REQUESTS]
    kernel_of = {"int8": ops.int8_matmul, "w8a8": ops.w8a8_matmul}

    ops.reset_launch_counts()  # the main path starts here
    for quant, dec in decs.items():
        for (b, p, new, kw), idx in zip(REQUESTS, prompts):
            before = {k: k.launches for k in ops.KERNELS}
            t0 = time.perf_counter()
            out = dec.generate(idx, new, **kw)
            secs = time.perf_counter() - t0
            if out.shape != (b, p + new) or not np.array_equal(out[:, :p], idx):
                fail(f"quant={quant}: output shape {out.shape} or prompt changed")
            if out.min() < 0 or out.max() >= MODEL["vocab_size"]:
                fail(f"quant={quant}: token outside the vocabulary")
            for k in ops.KERNELS:
                want = PER_FORWARD * (1 + new) if kernel_of.get(quant) is k else 0
                if k.launches - before[k] != want:
                    fail(f"quant={quant} B={b} +{new}: {k.__name__} launched "
                         f"{k.launches - before[k]} times, expected {want}")
            print(f"  served quant={str(quant):5s} B={b} prompt={p} +{new} {kw or 'greedy'}"
                  f" in {secs:.3f} s")
    counts = {k.__name__: k.launches for k in ops.KERNELS}  # the main path ends here
    print(f"main-path launches: {counts}")

    # prefill logits against the same decoder on a CPU copy of the model
    cpu_lm = TransformerLM(**MODEL, device="cpu").eval()
    cpu_lm.load_state_dict(lm.state_dict())
    p0 = REQUESTS[0][1]
    prompt = torch.zeros((2, MODEL["max_len"]), dtype=torch.long)
    prompt[:, :p0] = torch.as_tensor(prompts[0][:2])
    checks = {}
    for quant, dec in decs.items():
        cdec = KVCacheDecoder(cpu_lm, compute_dtype=torch.bfloat16, quant=quant)
        with torch.inference_mode():
            _, _, got = dec._prefill(dec._prep_tree(dec._gather()), prompt.cuda(), p0)
            _, _, ref = cdec._prefill(cdec._prep_tree(cdec._gather()), prompt, p0)
        if got.dtype != torch.float32 or not torch.isfinite(got).all():
            fail(f"quant={quant}: prefill logits not finite f32")
        err = rel_err(got.cpu(), ref)
        checks[str(quant)] = err
        print(f"  prefill logits quant={str(quant):5s} card vs CPU plain: max rel err "
              f"{err:.5f} (limit {LOGIT_TOL[quant]})")
        if not err < LOGIT_TOL[quant]:
            fail(f"quant={quant}: prefill logits differ from the CPU reference by {err}")
    report["prefill_vs_cpu"] = checks

    # decode throughput of each mode on the first request (B 8, 64 + 128)
    b, p, new, _ = REQUESTS[0]
    idx = prompts[0]
    rates = {}
    for quant, dec in decs.items():
        gen_s, dec_s, enq_s, pre_s = [], [], [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dec.generate(idx, new)
            gen_s.append(time.perf_counter() - t0)
            with torch.inference_mode():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params = dec._prep_tree(dec._gather())
                prompt = torch.zeros((b, MODEL["max_len"]), dtype=torch.long)
                prompt[:, :p] = torch.as_tensor(idx)
                kc, vc, logits = dec._prefill(params, prompt.cuda(), p)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                tokens, _ = dec._decode(params, (kc, vc), logits.argmax(-1), p, new)
                t2 = time.perf_counter()  # the host has queued every step
                tokens.cpu()
                t3 = time.perf_counter()
            pre_s.append(t1 - t0)
            enq_s.append(t2 - t1)
            dec_s.append(t3 - t1)
        # the device time of one decode step, its launches queued while the
        # stream spins, against the step's wall time: the device busy share
        with torch.inference_mode():
            positions = torch.arange(MODEL["max_len"], device=kc.device)
            tok = tokens[:, -1]

            def step():
                return dec._select(
                    dec._forward_one(params, kc, vc, tok, p + new - 1, positions)[0],
                    None, None, None, None, False)

            step_dev_ms = event_ms(step, 5)
            n_ops, n_views = dispatched_ops(step)
        w_bytes, kv_bytes, floor_ms = step_floor(params, kc, vc)
        r = dict(
            generate_tok_s=b * new / statistics.median(gen_s),
            decode_tok_s=b * new / statistics.median(dec_s),
            decode_step_ms=statistics.median(dec_s) / new * 1e3,
            step_device_ms=step_dev_ms,
            host_enqueue_share=statistics.median(enq_s) / statistics.median(dec_s),
            prep_prefill_ms=statistics.median(pre_s) * 1e3,
            step_aten_ops=n_ops,
            step_aten_views=n_views,
            step_weight_bytes=w_bytes,
            step_cache_bytes=kv_bytes,
            step_floor_ms=floor_ms,
            decode_tok_s_ceiling=b / floor_ms * 1e3,
        )
        r["device_busy_share"] = r["step_device_ms"] / r["decode_step_ms"]
        r["host_us_per_op"] = r["decode_step_ms"] * 1e3 / n_ops
        rates[str(quant)] = r
        print(f"  throughput quant={str(quant):5s}: generate {r['generate_tok_s']:.1f} tok/s,"
              f" decode {r['decode_tok_s']:.1f} tok/s ({r['decode_step_ms']:.3f} ms/step,"
              f" host enqueue {100 * r['host_enqueue_share']:.1f}% of it; device"
              f" {r['step_device_ms']:.3f} ms/step, busy {100 * r['device_busy_share']:.1f}%),"
              f" prep+prefill {r['prep_prefill_ms']:.2f} ms; a step dispatches {n_ops} aten"
              f" ops ({n_views} views), {r['host_us_per_op']:.2f} us of wall time each;"
              f" a step moves at least {w_bytes} weight and {kv_bytes} cache bytes:"
              f" floor {floor_ms:.4f} ms/step, {r['decode_tok_s_ceiling']:.1f} tok/s")
    report["throughput"] = rates
    return counts


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--report", metavar="PATH",
                        help="also write every measurement to PATH as JSON")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs on the card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import deepflows_tpu_torch as dt
    from deepflows_tpu_torch import ops
    from deepflows_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}")
    report = {"card": card, "torch": torch.__version__}

    t0 = time.perf_counter()
    _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    print(f"build: {report['build_s']:.1f} s into {_build.BUILD / _build.source_hash()}")
    for log in sorted((_build.BUILD / _build.source_hash()).glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {log.stem}: {line.strip()}")

    print("kernel phase (kernel vs plain twin, L2 flushed between timed launches):")
    max_err = kernel_phase(torch, ops, report)
    step_ms, b_int8, b_w8a8, wbytes = decode_step_timing(torch, ops)
    report["decode_step_kernels_ms"] = step_ms
    print(f"one decode step's {PER_FORWARD} calls (M=8, bf16 x, {wbytes} weight bytes): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in step_ms.items())
          + f"; bound int8 {b_int8[0]:.4f} ms, w8a8 {b_w8a8[0]:.4f} ms")

    print("slice phase (main path):")
    counts = slice_phase(torch, dt, report)

    at = (f"one decode step: {PER_FORWARD} calls, M=8, bf16 x, (K, N) of qkv/o/fc1/fc2"
          " x 12 layers + head")
    kernels = [
        dict(name="int8_matmul", route="cuda",
             source="deepflows_tpu_torch/csrc/int8_matmul.cu",
             replaces="deepflows_tpu/ops/pallas_kernels.py:377",
             launches=counts["int8_matmul"], max_abs_err=max_err["int8_matmul"],
             ms=step_ms["int8_matmul"], plain_ms=step_ms["int8_matmul_plain"],
             bound_ms=b_int8[0], bound_by=b_int8[1],
             library_ms=step_ms["int8_matmul_library"], at=at),
        dict(name="w8a8_matmul", route="cuda",
             source="deepflows_tpu_torch/csrc/w8a8_matmul.cu",
             replaces="deepflows_tpu/ops/pallas_kernels.py:718",
             launches=counts["w8a8_matmul"], max_abs_err=max_err["w8a8_matmul"],
             ms=step_ms["w8a8_matmul"], plain_ms=step_ms["w8a8_matmul_plain"],
             bound_ms=b_w8a8[0], bound_by=b_w8a8[1], library_ms=None, at=at),
    ]
    for k in kernels:
        if k["launches"] <= 0:
            fail(f"{k['name']} was not launched on the main path")
    report["kernels"] = kernels
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    print(f"card: {card}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
