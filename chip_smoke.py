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
   M = 1, 2, 5 and 8 (the split-K path) and prefill M = 8 * 192 and 192
   (the tensor-core tile, B 8 and B 1) — for x in bf16 and f32 and both
   output dtypes, then at ragged shapes and on a misaligned weight, which
   take the kernels' masked edges: the split edges of the decode path (K
   not a multiple of the chunk, K 17 below one chunk, N not a multiple of
   16, a misaligned weight with splits, 16 splits at K 8192) and the
   prefill tile's (M 9, 16, 100, 129, 300 and 1000 at K 4096 and N 1000 or
   1030, a misaligned weight, bf16 x with K 70 and int8 x with K 33, whose
   rows are not whole 16-byte chunks, and K 9000, past the decode path, at
   M 2 and 300).  Tolerances: w8a8 exact; int8 with f32 output rtol 1e-4
   and atol 1e-3 (the JAX tests' bound); bf16 output that bound plus one
   bf16 ulp.  Then the same decode call (M 8) and prefill call (M 1536)
   twice must give the same bits (int8 with f32 and bf16 output, f32 x,
   w8a8), and 200 calls of mixed decode shapes queued back to back on one
   stream must each equal their twin.  Times each shape at M 8 and 1536,
   one whole decode step's 49 calls and one prefill's 49 calls (48 at
   M 1536 and the head at M 8) with CUDA events, beside the plain twin,
   the library call (int8: torch.matmul on the pre-dequantised weight;
   w8a8: torch._int_mm on the int8 operands, x padded to 32 rows when it
   has 16 or fewer) and the card's bound (int8 with f32 x: the three bf16
   products the kernel runs, 3 x 2 M K N at the bf16 rate).  f32 products
   run without TF32 (torch.backends.cuda.matmul.allow_tf32 = False) in
   every comparison.
3. Slice phase, the main path: TransformerLM(vocab 8192, max_len 192,
   dim 1024, depth 12, heads 8) with random weights from a seed, served by
   KVCacheDecoder in bf16 with quant None, "int8" and "w8a8": three
   generate() requests and two generate_beam() requests (B 2 x 4 beams, the
   split-K path's 8 rows; B 1 x 3 beams with an eos_id the greedy run
   emitted) each, every decode and beam loop replaying its captured CUDA
   graph.  Launch counts are zeroed just before and read just after; a
   quantised generate() must launch its kernel 49 times per prefill and
   per decode step (49 x (1 + new)), a generate_beam() 49 x new (one
   prefill, new - 1 steps), every output must be in the vocabulary, beam
   scores finite and best-first, and every loop must have its graph.  Then,
   outside the count: each request again through a decoder that runs the
   eager loop on the card must give the same tokens and scores;
   num_beams=1 must equal greedy (B 8 +128 and B 1 +20); a weight of the
   model changed in place between two generate() calls must be read (the
   tokens move, and equal a fresh decoder's); each decoder's prefill
   logits are held against the same decoder on a CPU copy of the model
   (plain twins), at the JAX tests' tolerances.  Then, for each mode, graph
   and eager loop in turns: decode and generate tokens/s, ms a step, a
   step's device time (queued while the stream spins) and busy share, the
   host's us to queue a step, the aten ops of an eager step, a new
   decoder's first generate (warm-up and capture) against its second, the
   graph pool's memory, and a replay's device time by kernel group
   (torch.profiler).
4. Training kernel phase: flash_attention (forward and backward),
   fused_linear_ce (forward and backward) and fused_adam against their
   plain twins on the card, in f32 and bf16, at the training slice's shapes
   (flash (8, 8, 1024, 128) causal; CE N 8192, D 1024, V 8192; Adam over the
   model's 198 tensors) and at ragged ones (flash: Lq != Lk, L not a tile
   multiple, D 64 and 100, non-causal, a window, rows that see no key, the
   bf16 wgmma forward's edges (L 1000, 130 x 300, 300 x 130 with rows that
   see no key, windows of 1 and 2 and one past L, D 32 and 96), bf16 views
   that TMA cannot read (rows of D + 4, a base 2 bytes off, at D 64 and
   128), each case held to the forward route it must take and printed with
   it (ops/flash_attention.py _fwd_route: wgmma, mma for D 100 and the
   views TMA cannot read, f32; with the window of 1, dq and dk are exactly
   0 and are held by absolute error against TOL x max |dout| x max |q or
   k|); CE: N
   and V not tile multiples, an f32 bias beside bf16 x and w; Adam: sizes
   that are not a block multiple, weight decay 0 and not), and the slice's
   bf16 flash case again on (B, L, H, D) tensors seen as (B, H, L, D), as
   MultiheadAttention passes them.  Tolerances: flash's out, dq, dk and dv
   by row (row_err: max |kernel - plain| of a row over that row's max
   |plain| plus 1e-2 of the tensor's), below 1e-4 in f32 and 2e-2 in bf16
   (the two round P and dS to bf16 at the same places but sum in other
   orders, and the kernel's P is relative to a running maximum); lse
   elementwise below 1e-4 of max(1, |lse|) in both dtypes; the plain
   backward starts from the plain forward's out and lse.  CE: max |kernel
   - plain| / max |plain| below 1e-4 for loss and lse; dx by row (row_err),
   dw by column (row_err of dw.t()) and db by element (elem_err), below
   1e-4 in f32 and 2e-2 in bf16, at the slice's shape, the ragged ones and
   D 200, 256, 257, 1000, 2048 and 4096 (N 300, V 1000; the bf16
   backward's clusters of 1, 1, 2, 4, 8 and 16 blocks; f32 up to D 1024),
   each CE case with targets V - 1, V + 3 and -1 beside random ones (the
   last two must cost exactly lse, in f32 and bf16, forward and backward);
   Adam below 1e-6.  Rows that see no key must give exactly 0 and lse
   -1e30.  Two planted faults must fail the flash check: the kernel run
   with window L - 64 (up to a key tile dropped from the longest rows) and
   its backward fed lse + 0.1; and two the CE check: dx of the backward
   run on the first V - 64 columns of w and b (one vocab step dropped),
   held by row against the full reference, and the backward fed lse +
   0.1.  Two bf16 CE backward calls and two bf16 flash forward calls at the
   slice's shape must give the same bits.  The bf16 CE forward besides,
   each case held to the route it must take (ops/fused_ce.py _fwd_route:
   wgmma where TMA can read x and w, else mma) with loss and lse below
   1e-4 of the twin: the slice (wgmma; two calls bitwise equal), N 8191
   and 300, V 1000, 8200 and 8190 (mma), D 200 and 1000, an f32 bias, x
   viewed 2 bytes off (mma), each with targets V - 1, V + 3 and -1 (the
   last two must cost exactly lse); and one planted fault it must flag: w
   and b cut to their first V - 128 columns, every 7th target moved into
   the cut tile.
   Times each kernel at the slice's bf16 shapes beside its plain twin, one
   library call (scaled_dot_product_attention; torch.matmul +
   F.cross_entropy; torch.optim.Adam(fused=True)) and its bound; the flash
   forward and the CE forward with their routes and TFLOP/s, the CE
   forward's vocab plan.
5. Training phase, the main path: TransformerLM(vocab 8192, max_len 1024,
   dim 1024, depth 12, heads 8, flash=True) with random weights from a seed,
   trained by CompiledTrainStep(lm.trunk(), Adam(lr 5e-3, weight decay
   5e-4, fused=True), LMHeadCrossEntropy(lm.head), compute_dtype=bf16) on
   the fixed B 8 x L 1024 batch of bench.py (numpy default_rng(0)), 3
   warm-up and 10 timed steps.  Launch counts are zeroed just before and read
   just after; every step must launch flash forward and backward 12 times
   each, the CE forward and backward and fused Adam once each.  Every loss
   must be finite, the first within 1.0 of ln 8192, the last below the
   first.  Prints step ms (CUDA events and wall clock), tokens/s, the
   device busy share, the MFU of the analytic 9.071e12 FLOPs a step, and
   (torch.profiler) the device time of a step by kernel.
6. Card against CPU: the same step in f32 at full width but depth 2 and
   B 2, on the card and on a CPU copy (plain twins), 3 steps; the losses
   must agree within 1e-3 relative, and each parameter's change over the
   3 steps within 1e-3 of its norm (PARAM_TOL).
7. SR kernel phase: fused_adam_sr against its plain twin, bit for bit in
   p, v and s, with its in-kernel Philox bits and with external bits, over
   the model's 198 tensors (bf16 g) and ragged sizes (bf16 and f32 g,
   weight decay 0 and not, aligned and misaligned tensors); the mean SR
   bias over 64 steps' streams of 2^20 elements below 0.01 ulp; the bf16
   stall of tests/test_pallas.py at 2^20 elements (round to nearest stays
   at 1.0, SR moves 0.5-1.5x lr x steps). Times the 198-tensor call beside
   its twin and its bound (22 bytes an element); no PyTorch call rounds
   stochastically, so no library time.
8. bf16-weight training phase, a main path: the model of phase 5 from the
   same seed, cast by .bfloat16(), trained by CompiledTrainStep(lm.trunk(),
   Adam(lr 5e-3, weight decay 5e-4, stochastic_round=True),
   LMHeadCrossEntropy(lm.head)) with no compute_dtype, 3 + 10 steps on the
   same batch. Each step must launch fused_adam_sr once, fused_adam never,
   flash and CE as in phase 5; the losses finite and falling, the first
   within 1e-3 relative of phase 5's first (the same bf16 weights). Prints
   its step ms, tokens/s, MFU, busy share and peak memory beside phase 5's.
9. Eager f32 kernel phase: matmul and linear_fused (none, relu, tanh)
   against their plain twins at rtol 1e-4 / atol 1e-3 (the JAX tests'
   bound): the MLP's layers and backward products (transposed views),
   tests/test_pallas.py's shapes, the linear plan's K split edges (K 8,
   9, 16, 17, 784 and 4095 at (64, K, 48)) and 4096^3 (both); the large
   tile at ragged products (2000, 1032, 2056) (fed by TMA), (2000, 1030,
   2050), (1536, 100, 2817) and (1500, 1001, 2900) (by cp.async) with A, B
   or both as transposed views and A seen through a stride of 2, and each
   epilogue; two MLP layer-1 linear_fused calls must give the same bits,
   and matmul at 4096^3 on the large tile the same bits as the small tile
   forced to one split. Times matmul at 4096^3 and
   linear_fused at the MLP's first layer beside their twins, their bounds
   and torch.matmul / torch.addmm (TF32 off), and the bias-free MLP's 8
   matmul calls a step, summed, beside their summed bounds, twins and
   torch.matmul.
10. Eager f32 phase, two main paths under config.use_pallas: models.MLP
   (784-100-20-10) trained eagerly (forward, CrossEntropyLoss, zero_grad,
   backward, Adam(lr 1e-3).step()) for 30 steps of B 256 of synthetic
   MNIST-shaped data (pixels uniform in [0, 1), labels from a fixed random
   linear teacher), exactly 3 linear_fused launches a step; then a
   bias-free Sequential of the same widths, exactly 8 matmul launches a
   step (3 forward, dW of the first layer, dW and dx of the other two).
   Each loss must fall, and match the same run on a CPU copy (plain twins)
   within 1e-4 relative.

11. Family kernel phase: int8_matmul and w8a8_matmul against their plain
   twins at Mistral-7B's five quantised matrices ((K, N) qkv (4096, 6144),
   o (4096, 4096), gate_up (4096, 28672), down (14336, 4096), head (4096,
   32000)) at M 8, 384 and 1536, bf16 x, the tolerances of phase 2; times
   at M 8 and 1536, and a Llama decode step's and prefill's 33 calls, beside
   their bounds.  flash_attention forward and backward at the two training
   paths' shapes, (1, 32, 8192, 128) with window 4096 and (1, 32, 2048,
   128) causal, bf16, q and dout as (B, L, H, D) views, both on wgmma, held
   by row against the plain twins (computed four heads at a time) at the
   limits of phase 4, timed beside their bounds and SDPA's forward.
   fused_adam over both training models' parameter lists (0.70 G and 1.71
   G elements) against its plain twin (1e-6).
12. Llama serving, a main path: LlamaLM at Mistral-7B-v0.1's widths (dim
   4096, 32 heads, 8 K/V heads, hidden 14336, vocab 32000, window 4096,
   rope_theta 1e4, RMSNorm eps 1e-5), depth 8 of 32, max_len 192, random
   weights from a seed held in bf16, served by KVCacheDecoder in quant
   None, "int8" and "w8a8": B 8, prompt 64, +128 greedy; B 8, prompt 17,
   +50 sampled (temperature 0.8, top_k 50, top_p 0.9, seed 1); B 2 x 4
   beams, prompt 40, +32; every loop replaying its captured graph.  Launch
   counts exact: 4 x depth + 1 = 33 a prefill and a decode step in int8
   and w8a8.  Then the graph against the eager loop (tokens and scores),
   num_beams=1 against greedy, prefill logits (B 2) against the f32
   decoder and, quantised, against the same mode on the plain twins
   (LOGIT_TOL), and graph and eager loop timed as in phase 3 with the
   step's byte floor.
13. Llama streaming, a main path: the same widths at depth 2, max_len 4096
   = window, B 1, prompt 64, +4160 greedy (the ring wraps 128 tokens
   before the end) from a replayed graph keyed by its rope length (8192);
   its tokens against a twin of max_len 8192 with the same weights that
   does not stream.  Where they part, the twin fed the stream's own tokens
   must pick each of them, or see top-2 logits closer than NEAR_TIE there.
14. Llama training, a main path: the same widths at depth 2, max_len 8192,
   f32 masters, CompiledTrainStep(lm, Adam(fused=True),
   CrossEntropyLoss(), compute_dtype=bf16), flash=True, B 1 x L 8192, 5
   steps: each step 2 flash forward and 2 backward launches, all on
   wgmma, and 1 fused_adam; losses finite and falling.  Step ms, tokens/s,
   MFU (6 x Linear weights x tokens + 3 x 4 x banded pairs x dim a layer),
   peak memory and a step's device time by kernel.
15. Mixtral serving, a main path: MixtralLM at Mixtral-8x7B-v0.1's widths
   (8 experts, top-2, rope_theta 1e6), depth 2 of 32, in bf16, B 8, prompt
   64, +128 greedy in quant None and "int8": 2 x depth + 1 = 5 int8 calls
   a prefill and a step (attention and head; the experts stay bf16), graph
   against eager loop, prefill logits and timing as in phase 12.
16. Mixtral training, a main path: depth 1, B 1 x L 2048,
   MoECriterion(CrossEntropyLoss()), 3 steps: 1 flash forward and backward
   and 1 fused_adam a step; losses finite; MFU counting all 8 experts
   (the dense step computes them) and the top-2 alone.

17. ResNet-50 training, a main path: bench.py's row, ResNet50(num_classes
   10) with random weights from a seed, CompiledTrainStep(model, Adam(lr
   5e-3, weight decay 5e-4, fused=True), CrossEntropyLoss(),
   compute_dtype=bf16) on B 128 normal 224 x 224 images with labels below
   10 (numpy default_rng(0), bench.py:218-229), 2 warm-up and 5 timed
   steps, after fused_adam is held against its plain twin over the
   model's 161 parameter shapes (those of phase 20 too) and timed beside
   its bound: exactly one fused_adam launch a step over the 161 tensors, the
   losses finite and falling, the 106 BN buffers f32, finite and moved.
   Step ms (wall and CUDA events), images/s, busy share, peak memory, MFU
   of the analytic FLOPs (2 x the MACs of every conv and the fc, read
   from their output shapes, x 3 x B) and the step's device ms by group
   of the aten op that launched each kernel (convolution forward and
   backward, batch norm forward and backward, pooling, cuBLAS, other
   elementwise; fused_adam by name).  Convolution, batch norm and pooling
   run on cuDNN and PyTorch's kernels by design, as the JAX package
   leaves them to XLA.
18. ResNet-50 evaluation: CompiledEvalStep on the trained model at B 128
   in f32 (TF32 off) and with the model cast to bf16: logits finite, and
   the first 64 images' logits the same alone as in the batch (BN reads
   its running statistics); device ms and images/s.
19. NF-ResNet-50 (norm="free"), a main path: the row's config at lr
   1e-4 (CNN_LR: at 5e-3 its loss blows up), 3 steps, no buffers, one
   fused_adam a step, the loss falling; fused_adam checked first over its
   parameter shapes, as in 17.
20. ResNet-50 with remat=True, a main path: 2 steps from the weights and
   batch of a twin without remat; losses and the running statistics after
   step 1 within 2e-2 (the EMA ran once); peak memory and step ms of both.
21. MobileNetV1 and V2 (B 64, 224), VGG16-BN (B 32, 224) and ViT_Tiny
   (B 256, 32, patch 4: 64 tokens, the naive attention), main paths: 2
   steps each with the row's optimizer and dtype at the lr of CNN_FAMILY
   (1e-4, VGG16-BN's 1e-5), the loss falling, one fused_adam a step and
   no other launch; fused_adam checked first over each model's parameter
   shapes, as in 17.
22. CIFAR10_CNN eager under config.use_pallas, a main path: f32, B 256,
   32 x 32, dropout on, Adam(fused=True), 30 steps of forward,
   CrossEntropyLoss, zero_grad, backward and step: exactly one
   linear_fused (the fc, 2048 -> 10) and one fused_adam a step, no
   matmul; the loss falls; step ms of wall time.  First linear_fused is
   held against its plain twin at the fc's (256, 2048) @ (2048, 10) in
   every activation (rtol 1e-4, atol 1e-3) and fused_adam over the
   model's parameter shapes, each timed beside its bound.
23. Card against CPU: ResNet-18 (small input, f32, B 4, 16 x 16), one
   CompiledTrainStep with SGD(lr 0.01, momentum 0.9) from the same
   weights on the card and on a CPU copy: the loss within 1e-3 relative,
   each weight and running statistic within 1e-3 of its norm.

24. ResNet-50 fused (after phase 17, before 18): nn.fuse_conv_bn on the
   trained model (a B 2 slice as its example input) must fold all 53
   BNs; the fused CompiledEvalStep against the unfused at B 128 in f32
   (within 1e-3 of the logits' norm) and with both cast to bf16 (within
   2e-2 of the largest logit, phase 18's bound); eval ms and images/s of
   each.  Two planted faults must keep their BNs: a conv whose output
   also feeds a residual add, and two convs that tie one weight.
   GroupNorm(32, 256) on a (128, 256, 56, 56) activation, f32 and bf16,
   forward and backward, at 1e-5 and 0.05 (tests/test_torch_batchnorm.py's
   bounds): output and dx card against a CPU copy elementwise (rtol =
   atol), the weight's and bias's gradients (sums of 401,408 terms) card
   against float64 relative to the float64 gradient's norm.
25. Fine-tuning kernel phase: flash_attention at (1, 32, 2048, 128),
   window 4096, as in phase 11; int8_matmul and w8a8_matmul at Mistral's
   five matrices at M 8 and 16384 (the merged model's decode and B 8 x
   2048 prefill rows) against their twins, a depth-2 decode step's 9
   calls timed; fused_adam over the optimizer path's 480 M-element list
   beside torch.optim.Adam(fused=True).
26. LoRA fine-tuning, a main path: LlamaLM at Mistral-7B widths, depth 2,
   max_len 2048, f32 masters, flash; nn.apply_lora(r 16, alpha 32, q_proj,
   v_proj, out_proj: 688,128 adapter elements); CompiledTrainStep with
   AdamW(lr 2e-4, no decay) over the adapters, WarmupCosineLR(warmup 2,
   T_max 6) stepped after every step, clip_by_global_norm(1.0),
   accum_steps 4 and bf16 compute, on a repeated B 4 x L 2048 batch, 6
   steps, the loss nn.CrossEntropyLoss on the logits widened to f32 (a
   bf16 loss cannot show LoRA's first steps): 8 flash forward and
   backward launches a step; the loss finite
   and falling, the lr of each step the scheduler's on the host, the
   frozen base bitwise unchanged.  Then: the clip's pre-clip norm, and
   the transform alone under torch.cuda.set_sync_debug_mode("error");
   one f32 step with accum_steps 4 against 1 from the trained state
   (each adapter's change within 1e-3 of its norm); lora_state_dict into
   a fresh LoRA model, its logits bitwise equal; a planted fault, a
   decoder on the unmerged model, which must raise; merge_lora, the
   merged decoders' prefill logits (bf16, dense and int8) against the
   unmerged f32 forward within LOGIT_TOL.  Step ms, tokens/s and peak
   memory beside a full fine-tune twin (AdamW over every parameter, 2
   steps).
27. Merged serving, a main path: the merged model served dense and int8
   (B 8, prompt 64, +128 greedy), every loop from its captured graph, 9
   int8 launches a prefill and a step; decode and generate tok/s.
28. Optimizers, main paths: LlamaLM at Mistral-7B widths, depth 1, B 1 x
   L 2048, bf16 compute over f32 masters, 4 steps from the same weights
   under each of AdamW, Muon(lr 0.02, adamw_lr 3e-3), Adafactor, Lion,
   RMSprop, Adagrad, Adadelta and Adam(fused=True) (one fused_adam
   launch a step), at the lr of OPTIMIZERS (tools/optim_lr_sweep.py);
   each loss falling; ModelEMA(0.999) beside AdamW, its
   average_parameters() giving the shadow and the live weights back bit
   for bit.  Step ms, update ms (CUDA events around pure_update), state
   bytes, peak memory; Muon's Newton-Schulz ms and TFLOP/s.
29. Card against CPU: one f32 step of each optimizer on a depth-1, dim-64
   LlamaLM, each tensor's change within 1e-3 of its norm.

Prints the card's name and power limit, one {"kernels": [...]} line (the CE
backward's, linear_fused's and matmul's entries with the plan they ran:
(C, BM, BV) and (tile, chunk, splits); the flash forward's with its route
and TFLOP/s; each kernel's launches summed over every main path, with
the family paths' share in ``launches_by_family_path``, the CNN paths'
in ``launches_by_cnn_path``, the fine-tuning slice's in
``launches_by_finetune_path``, its numbers at the family's shapes in
``family``, at each CNN path's in ``cnn``, whose worst error its
max_abs_err takes in, and at the fine-tuning paths' in ``finetune``),
and as its last line {"ok": true,
"device": {...}}.  With ``--report PATH`` it also
writes every measurement (each shape's times, the throughput of each mode,
the training step's numbers) to PATH as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types

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
DECODE_RAGGED = (  # (M, K, N, weight 16-byte aligned): the split-K path's edges
    (8, 1000, 1024, True), (8, 17, 64, True), (5, 1024, 1000, True), (8, 4100, 1024, False),
    (3, 4100, 1030, True), (1, 8192, 32, True), (2, 9000, 48, True),  # K past the decode path
)
PREFILL_RAGGED = (  # (M, K, N, weight 16-byte aligned): the prefill tile's edges
    (9, 4096, 1000, True), (16, 4096, 1030, True), (100, 4096, 1000, True),
    (129, 4096, 1030, True), (300, 4096, 1000, True), (1000, 4096, 1030, True),
    (200, 4096, 1024, False), (100, 70, 64, True), (40, 33, 100, True), (300, 9000, 200, True),
)
PREFILL_M = 8 * MODEL["max_len"]  # rows of a B 8 prefill's products
PER_FORWARD = 4 * MODEL["depth"] + 1  # kernel launches per prefill or step
REQUESTS = (  # (batch, prompt, new tokens, sampling)
    (8, 64, 128, {}),
    (8, 17, 50, dict(temperature=0.8, top_k=50, top_p=0.9, seed=1)),
    (1, 5, 20, {}),
)
BEAM_REQUESTS = (  # (batch, prompt, new tokens, beam search): 8 rows; 3 rows with an eos
    (2, 40, 32, dict(beams=4)),
    (1, 5, 20, dict(beams=3, eos_id="greedy")),
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


def check_int8(torch, got, want, label):
    """int8_matmul's output against its twin's: f32 at rtol 1e-4 and atol
    1e-3, bf16 at that bound plus one bf16 rounding step; returns max |d|."""
    d = (got.float() - want.float()).abs()
    lim = 1e-3 + 1e-4 * want.float().abs()
    if got.dtype == torch.bfloat16:
        lim = lim + bf16_ulp(torch.maximum(got.float().abs(), want.float().abs()))
    if (d > lim).any():
        fail(f"int8_matmul {label} out={got.dtype}: max |d| {d.max().item()}")
    return d.max().item()


def check_w8a8(torch, got, want, label):
    if not torch.equal(got, want):
        fail(f"w8a8_matmul {label} out={got.dtype}: not exact, max |d| "
             f"{(got.float() - want.float()).abs().max().item()}")


def compare(torch, ops, x, wq, s, label, max_err):
    """Both kernels against their plain twins on one (x, wq, s), for f32 and
    bf16 output; fails on the first disagreement."""
    xq, sx = ops.quantize_int8_rows(x)
    for odt in (torch.float32, torch.bfloat16):
        e = check_int8(torch, ops.int8_matmul(x, wq, s, out_dtype=odt),
                       ops.int8_matmul_plain(x, wq, s, out_dtype=odt), label)
        if odt == torch.float32:
            max_err["int8_matmul"] = max(max_err["int8_matmul"], e)
        check_w8a8(torch, ops.w8a8_matmul(xq, sx, wq, s, out_dtype=odt),
                   ops.w8a8_matmul_plain(xq, sx, wq, s, out_dtype=odt), label)
    return xq, sx


def int_mm_operands(torch, xq, wq):
    """The operands of torch._int_mm, the library's int8 x int8 -> int32
    product and the w8a8 kernel's yardstick: xq padded with zero rows to 32
    when it has 16 or fewer (the call refuses those), and wq as it is or,
    if the call refuses that layout, a column-major copy, made here and not
    in the timed call."""
    if xq.shape[0] <= 16:
        xq = torch.cat([xq, xq.new_zeros((32 - xq.shape[0], xq.shape[1]))])
    try:
        torch._int_mm(xq, wq)
    except RuntimeError:
        wq = wq.t().contiguous().t()
    return xq, wq


def misaligned(torch, wq):
    """A copy of wq whose address is one byte past a 16-byte boundary."""
    K, N = wq.shape
    return torch.empty(K * N + 1, dtype=torch.int8, device=wq.device)[1:].view(K, N).copy_(wq)


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
    for M in (1, 2, 5, 8, MODEL["max_len"], PREFILL_M):
        for xdt, xname in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            for name, (K, N) in SHAPES.items():
                x = torch.randn((M, K), generator=g, device=dev).to(xdt)
                w = torch.randn((K, N), generator=g, device=dev) * 0.02
                wq, s = ops.quantize_int8(w)
                xq, sx = compare(torch, ops, x, wq, s, f"M={M} {name} x={xname}", max_err)
                if M not in (8, PREFILL_M):
                    continue  # checked, not timed
                xl, wl = int_mm_operands(torch, xq, wq)
                out_bytes = M * N * x.element_size()
                wdeq = (wq.float() * s).to(xdt)
                reps = 20
                r = dict(M=M, K=K, N=N, shape=name, x=xname, out=xname)
                r["int8_ms"] = event_ms(lambda: ops.int8_matmul(x, wq, s), reps, flush)
                r["int8_plain_ms"] = event_ms(lambda: ops.int8_matmul_plain(x, wq, s), reps, flush)
                r["int8_library_ms"] = event_ms(lambda: torch.matmul(x, wdeq), reps, flush)
                # f32 x: the three bf16 products the kernel runs
                r["int8_bound_ms"], r["int8_bound_by"] = bound_ms(
                    M * K * x.element_size() + K * N + 4 * N + out_bytes,
                    (3 if xname == "f32" else 1) * 2 * M * K * N, "bf16")
                r["int8_bound_ops"] = "3 bf16 products" if xname == "f32" else "1 bf16 product"
                r["w8a8_ms"] = event_ms(
                    lambda: ops.w8a8_matmul(xq, sx, wq, s, out_dtype=xdt), reps, flush)
                r["w8a8_plain_ms"] = event_ms(
                    lambda: ops.w8a8_matmul_plain(xq, sx, wq, s, out_dtype=xdt), reps, flush)
                r["w8a8_library_ms"] = event_ms(lambda: torch._int_mm(xl, wl), reps, flush)
                r["w8a8_bound_ms"], r["w8a8_bound_by"] = bound_ms(
                    M * K + 4 * M + K * N + 4 * N + out_bytes, 2 * M * K * N, "int8")
                rows.append(r)
                print(
                    f"  M={M:5d} {name:4s} K={K:4d} N={N:4d} x={xname:4s} | int8 "
                    f"{r['int8_ms']:.4f} ms (plain {r['int8_plain_ms']:.4f}, matmul "
                    f"{r['int8_library_ms']:.4f}, bound {r['int8_bound_ms']:.4f} of "
                    f"{r['int8_bound_ops']}) | "
                    f"w8a8 {r['w8a8_ms']:.4f} ms (plain {r['w8a8_plain_ms']:.4f}, _int_mm "
                    f"{r['w8a8_library_ms']:.4f}, bound {r['w8a8_bound_ms']:.4f})"
                )
    # ragged M, K and N, one row (B 1 decode), and a weight whose address is
    # not 16-byte aligned, which takes the kernels' bytewise weight loads
    for M, K, N, aligned in RAGGED + DECODE_RAGGED + PREFILL_RAGGED:
        for xdt in (torch.bfloat16, torch.float32):
            x = torch.randn((M, K), generator=g, device=dev).to(xdt)
            wq, s = ops.quantize_int8(torch.randn((K, N), generator=g, device=dev) * 0.02)
            if not aligned:
                wq = misaligned(torch, wq)
            compare(torch, ops, x, wq, s, f"ragged M={M} K={K} N={N} aligned={aligned}"
                    f" x={xdt}", max_err)
    print(f"  ragged shapes agree: {[r[:3] for r in RAGGED + DECODE_RAGGED + PREFILL_RAGGED]}")
    report["decode_repeats"] = decode_repeat_checks(torch, ops, g)
    prefill_repeat_checks(torch, ops, g)
    report["kernel_shapes"] = rows
    return max_err


def decode_repeat_checks(torch, ops, g):
    """The split-K decode path is deterministic and its calls independent:
    the same call twice gives the same bits (int8 with bf16 x and f32 or
    bf16 output, f32 x, w8a8) at the decoder's shapes at M 8, and 200 calls
    of mixed decode shapes, both kernels and both x dtypes, queued back to
    back on one stream, each equal their twin."""
    dev = torch.device("cuda")
    cases = [(M, K, N, True) for M in (1, 2, 5, 8) for K, N in SHAPES.values()]
    cases += [c for c in RAGGED + DECODE_RAGGED if c[0] <= 8]
    operands = []
    for M, K, N, aligned in cases:
        x = torch.randn((M, K), generator=g, device=dev)
        wq, s = ops.quantize_int8(torch.randn((K, N), generator=g, device=dev) * 0.02)
        operands.append((x, wq if aligned else misaligned(torch, wq), s,
                         *ops.quantize_int8_rows(x)))
    for (M, K, N, _), (x, wq, s, xq, sx) in zip(cases, operands):
        if M != 8 or (K, N) not in SHAPES.values():
            continue
        for xin, odt in ((x.bfloat16(), torch.float32), (x.bfloat16(), torch.bfloat16),
                         (x, torch.float32)):
            a = ops.int8_matmul(xin, wq, s, out_dtype=odt)
            if not torch.equal(a, ops.int8_matmul(xin, wq, s, out_dtype=odt)):
                fail(f"int8_matmul M=8 K={K} N={N} x={xin.dtype} out={odt}: two calls differ")
        if not torch.equal(ops.w8a8_matmul(xq, sx, wq, s), ops.w8a8_matmul(xq, sx, wq, s)):
            fail(f"w8a8_matmul M=8 K={K} N={N}: two calls differ")
    queued = []
    for i in range(200):
        x, wq, s, xq, sx = operands[(7 * i) % len(operands)]
        if i % 2:
            odt = torch.float32 if i % 4 == 1 else torch.bfloat16
            queued.append((False, (xq, sx, wq, s, odt), ops.w8a8_matmul(xq, sx, wq, s, odt)))
        else:
            xin = x if i % 4 == 0 else x.bfloat16()
            queued.append((True, (xin, wq, s), ops.int8_matmul(xin, wq, s)))
    torch.cuda.synchronize()
    for i, (int8, args, got) in enumerate(queued):
        if int8:
            check_int8(torch, got, ops.int8_matmul_plain(*args), f"back-to-back call {i}")
        else:
            check_w8a8(torch, got, ops.w8a8_matmul_plain(*args), f"back-to-back call {i}")
    print(f"  decode calls deterministic (two calls bitwise equal at the 5 shapes, M 8); "
          f"{len(queued)} mixed decode calls back to back over {len(cases)} shapes each equal "
          f"their twin")
    return dict(shapes=len(cases), back_to_back=len(queued))


def prefill_repeat_checks(torch, ops, g):
    """The prefill tile is deterministic: the same M 1536 call twice gives
    the same bits (int8 with bf16 x and f32 or bf16 output, f32 x, w8a8) at
    the decoder's four prefill shapes."""
    dev = torch.device("cuda")
    for name in ("qkv", "o", "fc1", "fc2"):
        K, N = SHAPES[name]
        x = torch.randn((PREFILL_M, K), generator=g, device=dev)
        wq, s = ops.quantize_int8(torch.randn((K, N), generator=g, device=dev) * 0.02)
        xq, sx = ops.quantize_int8_rows(x)
        for xin, odt in ((x.bfloat16(), torch.float32), (x.bfloat16(), torch.bfloat16),
                         (x, torch.float32)):
            a = ops.int8_matmul(xin, wq, s, out_dtype=odt)
            if not torch.equal(a, ops.int8_matmul(xin, wq, s, out_dtype=odt)):
                fail(f"int8_matmul M={PREFILL_M} {name} x={xin.dtype} out={odt}: two calls differ")
        if not torch.equal(ops.w8a8_matmul(xq, sx, wq, s), ops.w8a8_matmul(xq, sx, wq, s)):
            fail(f"w8a8_matmul M={PREFILL_M} {name}: two calls differ")
    print(f"  prefill calls deterministic: two calls bitwise equal at the 4 shapes, M {PREFILL_M}")


def decode_step_timing(torch, ops):
    """One decode step's 49 kernel calls at M = 8 with bf16 activations, over
    12 layers of distinct weights (so the weights stream from device memory
    as in the decoder): kernel, plain twin and library times beside the
    bound, per kernel (w8a8's library call is torch._int_mm at 32 rows, the
    integer product alone)."""
    return forward_timing(torch, ops, 8)


def forward_timing(torch, ops, M, shapes=SHAPES, depth=MODEL["depth"],
                   layer_names=("qkv", "o", "fc1", "fc2")):
    """The calls of one forward (49 for the TransformerLM): ``depth``
    layers of distinct weights (``layer_names``, (K, N) from ``shapes``) at
    M rows and the head at M 8 (f32 out), bf16 x.  At M 1536 that is one
    B 8 prefill (the decoder takes only the last position's hidden state to
    the head).  Returns ({kernel, plain twin and library: ms}, int8 bound,
    w8a8 bound, weight bytes)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    calls = []  # (x, xq, sx, wq, s, wdeq, out_dtype)
    int_mm = []  # torch._int_mm's operands of each call
    for layer in range(depth + 1):
        names = ("head",) if layer == depth else layer_names
        for name in names:
            K, N = shapes[name]
            x = torch.randn((8 if name == "head" else M, K), generator=g,
                            device=dev).to(torch.bfloat16)
            wq, s = ops.quantize_int8(torch.randn((K, N), generator=g, device=dev) * 0.02)
            xq, sx = ops.quantize_int8_rows(x)
            odt = torch.float32 if name == "head" else torch.bfloat16
            calls.append((x, xq, sx, wq, s, (wq.float() * s).to(torch.bfloat16), odt))
            int_mm.append(int_mm_operands(torch, xq, wq))
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
        "w8a8_matmul_library": lambda: [torch._int_mm(xl, wl) for xl, wl in int_mm],
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
    reads over max_len (the Llama family has no position table).  Returns
    (weight bytes, cache bytes, the least time in ms that takes at the
    card's memory rate)."""

    def nbytes(t):
        if isinstance(t, dict):
            return sum(nbytes(v) for v in t.values())
        if isinstance(t, list):
            return sum(nbytes(v) for v in t)
        return t.numel() * t.element_size()

    weights = nbytes({k: v for k, v in params.items() if k not in ("tok", "pos")})
    rows = (kc.shape[1] + ("pos" in params)) * params["tok"].shape[1] * params["tok"].element_size()
    cache = nbytes([kc, vc])
    return weights, cache, (weights + rows + cache) / HBM_BYTES_PER_S * 1e3


def loop_key(dec, kind, rows, sample=False):
    """The graph key of ``dec``'s decode (``kind`` "decode") or beam loop
    whose caches have ``rows`` rows (B, or B x beams) and, for decode,
    whose ``do_sample`` is ``sample``."""
    keys = [k for k in dec._loops if k[0] == kind and k[1][1] == rows
            and (kind == "beam" or k[3] == sample)]
    if len(keys) != 1:
        fail(f"expected one {kind} loop of {rows} rows, found {keys}")
    return keys[0]


def serve(dec, idx, new, kw, served):
    """One request: generate(), returning (tokens, None), or, with ``beams``
    in kw, generate_beam(), returning (every beam's tokens, scores).  An
    ``eos_id`` of "greedy" is the token the greedy B 1 request (REQUESTS[2],
    in ``served``) emitted at its 6th step."""
    kw = dict(kw)
    if kw.get("eos_id") == "greedy":
        kw["eos_id"] = int(served[2][0][0, REQUESTS[2][1] + 5])
    if "beams" in kw:
        return dec.generate_beam(idx, new, num_beams=kw.pop("beams"), return_all=True, **kw)
    return dec.generate(idx, new, **kw), None


def loop_timing(torch, dec, idx, new):
    """A B 8 greedy request through ``dec`` (graph or eager loop by
    ``dec._capture``): generate wall s (3 runs), and the decode alone:
    wall s, the host's s to queue every step, and one step's device ms
    (the step queued while the stream spins, position reset before each
    call).  Returns ({name: median}, the loop, aten ops of an eager step)."""
    b, p = idx.shape
    gen_s, dec_s, enq_s, pre_s = [], [], [], []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dec.generate(idx, new)
        gen_s.append(time.perf_counter() - t0)
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params = dec._prepared()
            prompt = torch.zeros((b, dec.lm.max_len), dtype=torch.long)
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
    key = loop_key(dec, "decode", b)
    lp = dec._loops[key]
    with torch.inference_mode():
        def step():
            lp.pos.fill_(p + new - 1)
            lp.i.fill_(new - 1)
            if dec._capture:
                dec._graphs[key].replay()
            else:
                lp.step()

        step_ms = event_ms(step, 5)
        others = {}
        profile = replay_profile(torch, step, others=others)
        n_ops = None
        if not dec._capture:
            lp.pos.fill_(p + new - 1)
            lp.i.fill_(new - 1)
            n_ops = dispatched_ops(lp.step)
    med = statistics.median
    return dict(generate_s=med(gen_s), decode_s=med(dec_s), enqueue_s=med(enq_s),
                prep_prefill_s=med(pre_s), step_device_ms=step_ms, profile=profile,
                others=others), lp, n_ops


def replay_profile(torch, step, reps=5, others=None):
    """Device time of one decode step by kernel group, from torch.profiler
    over ``reps`` calls of ``step`` (a replay with its position reset): ms
    a step and kernels a step for the port's int8 kernels, the matrix
    products (cuBLAS: the dense weights and attention's two products), the
    softmaxes, and everything else PyTorch runs.  ``others``, a dict, gains
    the last group's ms a step by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    groups = {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        us = e.self_cuda_time_total if us is None else us
        if "int8_decode" in e.key or "int8_prefill" in e.key:
            name = "int8 kernels of the port"
        elif any(k in e.key for k in ("nvjet", "gemm", "xmma", "gemv", "cutlass")):
            name = "matrix products (cuBLAS)"
        elif "softmax" in e.key.lower():
            name = "softmax"
        else:
            name = "other PyTorch kernels"
            if others is not None:
                others[e.key] = others.get(e.key, 0.0) + us / 1e3 / reps
        ms, n = groups.get(name, (0.0, 0))
        groups[name] = (ms + us / 1e3 / reps, n + e.count / reps)
    return {k: {"ms": v[0], "kernels": v[1]} for k, v in groups.items()}


def serve_all(decs, requests, prompts, per_forward, vocab, label):
    """A main path: every request through every decoder of ``decs`` (quant:
    decoder), launch counts zeroed just before and read just after.  Each
    request's output must keep its prompt, stay in the vocabulary and, with
    beams, give finite scores best-first; a quantised decoder must launch
    its kernel ``per_forward`` times a prefill and a step, and no other
    kernel.  Returns ({quant: [(tokens, scores), ...]}, the launch counts)."""
    import numpy as np

    from deepflows_tpu_torch import ops

    kernel_of = {"int8": ops.int8_matmul, "w8a8": ops.w8a8_matmul}
    served = {q: [] for q in decs}
    ops.reset_launch_counts()  # the main path starts here
    for quant, dec in decs.items():
        for (b, p, new, kw), idx in zip(requests, prompts):
            before = {k: k.launches for k in ops.KERNELS}
            t0 = time.perf_counter()
            out, scores = serve(dec, idx, new, kw, served[quant])
            secs = time.perf_counter() - t0
            served[quant].append((out, scores))
            lead = (b, kw["beams"]) if "beams" in kw else (b,)
            head = idx[:, None] if "beams" in kw else idx
            if out.shape != (*lead, p + new) or not (out[..., :p] == head).all():
                fail(f"{label}quant={quant}: output shape {out.shape} or prompt changed")
            if out.min() < 0 or out.max() >= vocab:
                fail(f"{label}quant={quant}: token outside the vocabulary")
            if scores is not None and not (np.isfinite(scores).all()
                                           and (np.diff(scores, axis=1) <= 0).all()):
                fail(f"{label}quant={quant} beams {kw}: scores not finite and best-first: "
                     f"{scores}")
            forwards = new if "beams" in kw else 1 + new
            for k in ops.KERNELS:
                want = per_forward * forwards if kernel_of.get(quant) is k else 0
                if k.launches - before[k] != want:
                    fail(f"{label}quant={quant} B={b} +{new} {kw}: {k.__name__} launched "
                         f"{k.launches - before[k]} times, expected {want}")
            print(f"  served {label}quant={str(quant):5s} B={b} prompt={p} +{new} "
                  f"{kw or 'greedy'} in {secs:.3f} s")
    return served, {k.__name__: k.launches for k in ops.KERNELS}  # the main path ends here


def slice_phase(torch, dt, report):
    """The main path: serve the full-width model through the three decoder
    modes, generate() and generate_beam() replaying captured CUDA graphs.
    Returns the launch counts of the run."""
    import numpy as np

    from deepflows_tpu_torch.models import KVCacheDecoder, TransformerLM

    dt.manual_seed(0)
    lm = TransformerLM(**MODEL, device="cuda").eval()
    n_params = sum(p.numel() for p in lm.parameters())
    print(f"model: TransformerLM {MODEL}, {n_params} parameters on "
          f"{lm.tok_embed.weight.device}")
    quants = (None, "int8", "w8a8")
    decs = {q: KVCacheDecoder(lm, compute_dtype=torch.bfloat16, quant=q) for q in quants}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, MODEL["vocab_size"], (b, p)).astype(np.int64)
               for b, p, _, _ in REQUESTS + BEAM_REQUESTS]
    served, counts = serve_all(decs, REQUESTS + BEAM_REQUESTS, prompts, PER_FORWARD,
                               MODEL["vocab_size"], "")
    print(f"main-path launches: {counts}")
    for quant, dec in decs.items():
        missing = [k for k in dec._loops if k not in dec._graphs]
        if missing or len(dec._loops) != 5:
            fail(f"quant={quant}: loops {list(dec._loops)} without a captured graph: {missing}")
    print("  every request's loop ran from a captured CUDA graph (3 decode and 2 beam keys a mode)")

    # the graph against the eager loop on the card: the same tokens
    same = {}
    for quant, dec in decs.items():
        eager = KVCacheDecoder(lm, compute_dtype=torch.bfloat16, quant=quant)
        eager._capture = False
        for (b, p, new, kw), idx, got in zip(REQUESTS + BEAM_REQUESTS, prompts, served[quant]):
            want = serve(eager, idx, new, kw, served[quant])
            if not (np.array_equal(want[0], got[0]) and np.array_equal(want[1], got[1])):
                fail(f"quant={quant} B={b} +{new} {kw}: the graph's tokens or scores differ "
                     "from the eager loop's")
        for r in (0, 2):  # one beam is greedy
            b, p, new, _ = REQUESTS[r]
            one = dec.generate_beam(prompts[r], new, num_beams=1)
            if not np.array_equal(one, served[quant][r][0]):
                col = int(np.nonzero((one != served[quant][r][0]).any(0))[0][0]) - p
                fail(f"quant={quant} B={b} +{new}: num_beams=1 leaves greedy at step {col}")
        # a weight changed in place between two generate() calls is read
        b, p, new, _ = REQUESTS[2]
        w = lm.blocks[0].mlp[2].weight
        saved = w.detach().clone()
        with torch.no_grad():
            w.mul_(-4.0)
        try:
            after = dec.generate(prompts[2], new)
            fresh = KVCacheDecoder(lm, compute_dtype=torch.bfloat16, quant=quant).generate(
                prompts[2], new)
        finally:
            with torch.no_grad():
                w.copy_(saved)
        if not np.array_equal(after, fresh):
            fail(f"quant={quant}: after a weight update the graph's tokens differ from a fresh "
                 "decoder's (stale weights)")
        if np.array_equal(after, served[quant][2][0]):
            fail(f"quant={quant}: the weight update did not move the tokens; the refresh "
                 "check sees nothing")
        if not np.array_equal(dec.generate(prompts[2], new), served[quant][2][0]):
            fail(f"quant={quant}: the restored weights do not give the first tokens again")
        same[str(quant)] = True
        print(f"  quant={str(quant):5s}: graph == eager loop on all {len(served[quant])} "
              "requests (greedy, sampled seed 1, beams 2 x 4 and 1 x 3 with eos); "
              "num_beams=1 == greedy; a weight update is read (== a fresh decoder)")
    report["graph_equals_eager"] = same

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

    # decode throughput of each mode on the first request (B 8, 64 + 128):
    # the graph and the eager loop in turns, and a new decoder's first
    # generate (warm-up and capture) against its second
    b, p, new, _ = REQUESTS[0]
    idx = prompts[0]
    rates = {}
    for quant, dec in decs.items():
        first = KVCacheDecoder(lm, compute_dtype=torch.bfloat16, quant=quant)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        first.generate(idx, new)
        t1 = time.perf_counter()
        first.generate(idx, new)
        t2 = time.perf_counter()
        key = loop_key(first, "decode", b)
        cap = first._graphs[key]
        eager = KVCacheDecoder(lm, compute_dtype=torch.bfloat16, quant=quant)
        eager._capture = False
        runs = {}
        for name, d in (("graph", dec), ("eager", eager), ("graph2", dec)):
            runs[name], lp, n_ops = loop_timing(torch, d, idx, new)
            if n_ops is not None:
                runs[name]["step_aten_ops"], runs[name]["step_aten_views"] = n_ops
        w_bytes, kv_bytes, floor_ms = step_floor(dec._params, lp.kc, lp.vc)
        r = {}
        for name in ("graph", "eager"):
            m = runs[name]
            q = dict(
                generate_tok_s=b * new / m["generate_s"],
                decode_tok_s=b * new / m["decode_s"],
                decode_step_ms=m["decode_s"] / new * 1e3,
                step_device_ms=m["step_device_ms"],
                host_us_per_step=m["enqueue_s"] / new * 1e6,
                prep_prefill_ms=m["prep_prefill_s"] * 1e3,
                step_by_kernel_group=m["profile"],
            )
            q["device_busy_share"] = q["step_device_ms"] / q["decode_step_ms"]
            r[name] = q
        r["eager"]["step_aten_ops"] = runs["eager"]["step_aten_ops"]
        r["eager"]["host_us_per_op"] = r["eager"]["decode_step_ms"] * 1e3 / r["eager"]["step_aten_ops"]
        r["graph_second_run"] = {k: runs["graph2"][k] for k in ("decode_s", "step_device_ms")}
        r.update(first_generate_s=t1 - t0, second_generate_s=t2 - t1,
                 capture_s=cap.capture_s, graph_pool_bytes=cap.pool_bytes,
                 replay_launches={k.__name__: n for k, n in cap.launched},
                 step_weight_bytes=w_bytes, step_cache_bytes=kv_bytes, step_floor_ms=floor_ms,
                 decode_tok_s_ceiling=b / floor_ms * 1e3)
        rates[str(quant)] = r
        g, e = r["graph"], r["eager"]
        print(f"  throughput quant={str(quant):5s}, graph / eager loop: decode "
              f"{g['decode_tok_s']:.1f} / {e['decode_tok_s']:.1f} tok/s "
              f"({g['decode_step_ms']:.4f} / {e['decode_step_ms']:.4f} ms a step; device "
              f"{g['step_device_ms']:.4f} / {e['step_device_ms']:.4f} ms, busy "
              f"{100 * g['device_busy_share']:.1f} / {100 * e['device_busy_share']:.1f}%; host "
              f"{g['host_us_per_step']:.1f} / {e['host_us_per_step']:.1f} us to queue a step, "
              f"{e['step_aten_ops']} aten ops an eager step); generate {g['generate_tok_s']:.1f}"
              f" / {e['generate_tok_s']:.1f} tok/s, prep+prefill {g['prep_prefill_ms']:.2f} ms;"
              f" a new decoder's first generate {r['first_generate_s']:.3f} s (warm-up and "
              f"capture {r['capture_s']:.3f} s, pool {r['graph_pool_bytes'] / 2**20:.1f} MiB), "
              f"its second {r['second_generate_s']:.3f} s; a replay launches "
              f"{r['replay_launches'] or 'no kernel of the port'}; floor {floor_ms:.4f} ms a "
              f"step, {r['decode_tok_s_ceiling']:.1f} tok/s")
        for name in ("graph", "eager"):
            print(f"    {name} step by kernel group (torch.profiler, ms, kernels): " + ", ".join(
                f"{k} {v['ms']:.4f} ({v['kernels']:.0f})"
                for k, v in sorted(r[name]["step_by_kernel_group"].items())))
    report["throughput"] = rates
    return counts


# ---------------------------------------------------------------- training
TRAIN = dict(vocab_size=8192, max_len=1024, dim=1024, depth=12, num_heads=8)
TRAIN_B, TRAIN_L, WARMUP, TIMED = 8, 1024, 3, 10
ADAM = dict(lr=5e-3, weight_decay=5e-4)
PER_STEP = {  # kernel launches per training step
    "flash_attention_fwd": TRAIN["depth"], "flash_attention_bwd": TRAIN["depth"],
    "fused_linear_ce_fwd": 1, "fused_linear_ce_bwd": 1, "fused_adam": 1,
}
PER_STEP_SR = dict(PER_STEP, fused_adam=0, fused_adam_sr=1)  # bf16 weights, SR Adam
FLASH_RAGGED = (  # (B, H, Lq, Lk, D, causal, window)
    (2, 3, 100, 100, 64, True, None), (1, 2, 70, 130, 128, False, None),
    (1, 2, 130, 70, 64, True, None), (2, 2, 200, 200, 128, True, 37),
    (1, 2, 96, 8, 64, True, 9), (1, 1, 33, 47, 100, True, None),
    (2, 2, 64, 64, 64, False, None),
    # the wgmma forward's edges: L not a multiple of its 128-row or key
    # tiles, rows 193.. that see no key, windows of 1 and 2 and one past L
    (2, 2, 1000, 1000, 128, True, None), (1, 2, 130, 300, 64, False, None),
    (1, 2, 300, 130, 128, True, 64), (2, 2, 256, 256, 128, True, 1),
    (2, 2, 256, 256, 128, True, 2), (1, 2, 200, 200, 64, True, 512),
    # D below the 64-wide TMA box and between its two boxes (D 32 and 96)
    (2, 2, 150, 150, 32, True, None), (1, 3, 200, 90, 96, False, None),
)
# bf16 views that TMA cannot read, so the mma.sync route (both of its
# instances, D 64 and D 128): rows of D + 4 elements, or a base 2 bytes off
FLASH_MISALIGNED = (  # (B, H, Lq, Lk, D, causal, window, layout)
    (2, 2, 100, 100, 64, True, None, "rows"), (1, 2, 130, 70, 64, False, None, "offset"),
    (2, 2, 200, 200, 128, True, None, "rows"), (1, 2, 70, 130, 128, True, 37, "offset"),
)
# q, k and v that TMA can read and a dout that it cannot: the forward on
# wgmma, the backward on mma.sync (dout's layout last)
FLASH_DOUT_MISALIGNED = (
    (2, 2, 100, 100, 64, True, None, "rows"), (1, 2, 130, 70, 64, False, None, "offset"),
    (2, 2, 200, 200, 128, True, None, "rows"), (1, 2, 70, 130, 128, True, 37, "offset"),
)
CE_RAGGED = ((37, 64, 513), (100, 200, 300), (1000, 1024, 8000), (130, 1000, 97))
# (N, D, V) across the bf16 backward's cluster edges: C = ceil(D / 256) is 1,
# 1, 2, 4, 8 and 16 (the f32 backward takes D <= 1024)
CE_D_EDGES = ((300, 200, 1000), (300, 256, 1000), (300, 257, 1000), (300, 1000, 1000),
              (300, 2048, 1000), (300, 4096, 1000))
ADAM_RAGGED = (1, 3, 4095, 4096, 4097, 10000, 12345)
# bf16 CE forward cases beside the slice, each held to the route it must
# take (ops/fused_ce.py _fwd_route): (N, D, V, b's dtype, x's layout, route);
# "offset" views x 2 bytes off a 16-byte boundary, which TMA cannot read
CE_FWD_CASES = ((8191, 1024, 8192, "bf16", "contiguous", "wgmma"),
                (300, 1024, 1000, "bf16", "contiguous", "wgmma"),
                (300, 200, 8200, "bf16", "contiguous", "wgmma"),
                (8191, 1000, 8190, "bf16", "contiguous", "mma"),
                (300, 1000, 1000, "f32", "contiguous", "wgmma"),
                (300, 1024, 8192, "bf16", "offset", "mma"))
TOL = {"f32": 1e-4, "bf16": 2e-2}  # see scaled_err and row_err
FAULT_SHIFT = 0.1  # added to lse in the planted backward fault
# |card change - CPU change| / |CPU change| of the worst parameter after 3 f32 steps
PARAM_TOL = 1e-3


def step_flops(B, L, D, depth, V):
    """Analytic FLOPs of one training step, bench.py's lm_analytic_flops:
    3 x (matmuls + head + full L^2 attention)."""
    T = B * L
    return 3.0 * (2 * T * depth * 12 * D * D + 2 * T * D * V + depth * 4 * B * L * L * D)


def scaled_err(got, want):
    """(max |got - want| / max |want|, max |got - want|) in f32."""
    d = (got.float() - want.float()).abs().max().item()
    return d / max(want.float().abs().max().item(), 1e-30), d


def row_err(got, want):
    """(max over rows of max |got - want| / (max |want| + floor), max
    |got - want|), a row being the last axis and floor 1e-2 of the largest
    |want| of the tensor: each row is held to its own scale, so a row of
    small values (a causal row that sees many keys) is held as tightly as
    one of large values, and a row that is only rounding noise (the dq of a
    query that sees one key) is not held to its noise."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    scale = want.abs().amax(-1)
    floor = max(1e-2 * scale.max().item(), 1e-30)
    return (d.amax(-1) / (scale + floor)).max().item(), d.max().item()


def flash_errs(fwd, ref_fwd, grads, ref_grads, live):
    """{name: (relative error, max abs error)} of out, lse, dq, dk and dv
    against their references: out and the gradients by row_err, lse
    elementwise against max(1, |lse|); rows that see no key (``live``
    False) are left out of out and lse."""
    (o, lse), (po, plse) = fwd, ref_fwd
    B, H, Lq = o.shape[:3]
    lse, plse = lse.view(B, H, Lq)[:, :, live], plse.view(B, H, Lq)[:, :, live]
    errs = {"out": row_err(o[:, :, live], po[:, :, live]),
            "lse": (rel_err(lse, plse), (lse - plse).abs().max().item())}
    errs.update((n, row_err(g, r)) for n, g, r in zip(("dq", "dk", "dv"), grads, ref_grads))
    return errs


def flash_routes(q, k, v, do):
    """The forward and backward kernels that ops/flash_attention.py
    _fwd_route and _bwd_route pick for these operands: "wgmma", "mma" or
    "f32" each."""
    import importlib

    fa = importlib.import_module("deepflows_tpu_torch.ops.flash_attention")
    return fa._fwd_route(q, k, v), fa._bwd_route(q, k, v, do)


def flash_operand(torch, g, B, H, L, D, dt, layout):
    """A (B, H, L, D) operand: contiguous, a (B, L, H, D) tensor seen as
    (B, H, L, D) ("heads", as MultiheadAttention passes its heads), a view
    into rows of D + 4 elements ("rows") or one whose base is 2 bytes off
    ("offset")."""
    dev = torch.device("cuda")
    if layout == "heads":
        return torch.randn((B, L, H, D), generator=g, device=dev).to(dt).transpose(1, 2)
    pad, off = {"contiguous": (0, 0), "rows": (4, 0), "offset": (8, 1)}[layout]
    return torch.randn((B, H, L, D + pad), generator=g, device=dev).to(dt)[..., off:off + D]


def flash_case(torch, ops, g, B, H, Lq, Lk, D, causal, window, dt, label, layout="contiguous",
               want_route=None, want_bwd_route=None, dout_layout=None):
    """Forward and backward kernel against the plain twins on one case: the
    plain backward starts from the plain forward's out and lse.  Fails past
    the limits (lse at TOL["f32"] in both dtypes, the rest at the dtype's
    TOL), unless every row without a visible key gives output 0 and lse
    -1e30, or unless the forward takes ``want_route`` and the backward
    ``want_bwd_route`` (where given).  The operands are laid out as
    ``layout`` says (flash_operand), dout as ``dout_layout`` (default
    ``layout``).  With a
    causal window of 1 every row sees one key, its softmax is constant and
    dq and dk are exactly 0: both sides give rounding noise, which no
    relative measure can hold, so those two are held by their absolute
    error against TOL x max |dout| x max(max |q|, max |k|), the size one
    key's term of each would have.  Prints the case's forward route and
    errors; returns the operands, the plain results, the errors and the
    forward's and backward's routes."""
    dev = torch.device("cuda")
    q, k, v = (flash_operand(torch, g, B, H, n, D, dt, layout) for n in (Lq, Lk, Lk))
    do = flash_operand(torch, g, B, H, Lq, D, dt, dout_layout or layout)
    route, bwd_route = flash_routes(q, k, v, do)
    if want_route is not None and route != want_route:
        fail(f"flash {label}: takes the {route} route, not {want_route}")
    if want_bwd_route is not None and bwd_route != want_bwd_route:
        fail(f"flash {label}: its backward takes the {bwd_route} route, not {want_bwd_route}")
    o, lse = ops.flash_attention_fwd(q, k, v, causal, None, window)
    po, plse = ops.flash_attention_plain(q, k, v, causal, None, window)
    grads = ops.flash_attention_bwd(q, k, v, o, lse, do, causal, None, window)
    want = ops.flash_attention_bwd_plain(q, k, v, po, plse, do, causal, None, window)
    kpos, qpos = torch.arange(Lk, device=dev), torch.arange(Lq, device=dev)[:, None]
    seen = (kpos <= qpos) & (kpos > qpos - window) if window else kpos <= qpos
    blind = ~seen.any(1) if causal else torch.zeros(Lq, dtype=torch.bool, device=dev)
    if blind.any():
        if not (o[:, :, blind] == 0).all() or not (lse.view(B, H, Lq)[:, :, blind] == -1e30).all():
            fail(f"flash {label}: a row that sees no key is not 0 with lse -1e30")
    lim = TOL["bf16" if dt == torch.bfloat16 else "f32"]
    errs = flash_errs((o, lse), (po, plse), grads, want, ~blind)
    zero = ("dq", "dk") if causal and window == 1 else ()
    zero_lim = lim * do.float().abs().max().item() * max(
        q.float().abs().max().item(), k.float().abs().max().item())
    for name, (rel, absd) in errs.items():
        how = f"{route} route" if name in ("out", "lse") else f"backward on {bwd_route}"
        if name in zero:
            if not absd < zero_lim:
                fail(f"flash {label} ({how}): {name}, exactly 0, is {absd} off the plain twin "
                     f"(limit {zero_lim:.3g})")
        elif not rel < (TOL["f32"] if name == "lse" else lim):
            fail(f"flash {label} ({how}): {name} differs from the plain twin by {rel} (limit "
                 f"{TOL['f32'] if name == 'lse' else lim})")
    print(f"    flash {label}: {route} route, backward {bwd_route}; " + ", ".join(
        f"{n} {r:.3g}" + (f" (exactly 0: abs {a:.3g}, limit {zero_lim:.3g})" if n in zero else "")
        for n, (r, a) in errs.items()))
    return (q, k, v, o, lse, do), (po, plse, want), errs, route, bwd_route


def flash_planted_faults(ops, operands, refs):
    """Shows that the bf16 check of the causal slice case catches three
    faults: a forward that drops up to one key tile (64 keys) from the
    longest rows (the kernel run with window L - 64), a backward fed an
    lse off by FAULT_SHIFT, and a backward that skips the last 64 query
    rows (run with those rows of dout zeroed, held against the plain
    backward of the whole dout: what a ring that drops its last query tile
    gives).  Fails unless the limits of flash_case flag each; returns each
    fault's errors beside the global measure max |d| / max |plain|, which
    holds every row to the tensor's largest value."""
    q, k, v, o, lse, do = operands
    po, plse, want = refs
    fo, flse = ops.flash_attention_fwd(q, k, v, True, None, q.shape[2] - 64)
    dropped = {"out": row_err(fo, po)[0], "lse": rel_err(flse, plse),
               "out_global_scaled": scaled_err(fo, po)[0]}
    if not (dropped["out"] >= TOL["bf16"] and dropped["lse"] >= TOL["f32"]):
        fail(f"flash planted fault (a dropped key tile) passed the check: {dropped}")
    grads = ops.flash_attention_bwd(q, k, v, o, lse + FAULT_SHIFT, do, True)
    shifted = {n: row_err(a, b)[0] for n, a, b in zip(("dq", "dk", "dv"), grads, want)}
    shifted["global_scaled"] = max(scaled_err(a, b)[0] for a, b in zip(grads, want))
    if not max(shifted[n] for n in ("dq", "dk", "dv")) >= TOL["bf16"]:
        fail(f"flash planted fault (lse + {FAULT_SHIFT} in the backward) passed: {shifted}")
    cut = do.clone()
    cut[:, :, -64:] = 0
    grads = ops.flash_attention_bwd(q, k, v, o, lse, cut, True)
    skipped = {n: row_err(a, b)[0] for n, a, b in zip(("dq", "dk", "dv"), grads, want)}
    skipped["global_scaled"] = max(scaled_err(a, b)[0] for a, b in zip(grads, want))
    if not max(skipped[n] for n in ("dq", "dk", "dv")) >= TOL["bf16"]:
        fail(f"flash planted fault (the backward's last 64 query rows dropped) passed: {skipped}")
    return {"dropped_key_tile": dropped, "lse_shift": shifted, "dropped_query_rows": skipped}


def elem_err(got, want):
    """(max over elements of |got - want| / (|want| + floor), max |got -
    want|), floor 1e-2 of the largest |want|: each element held to its own
    scale."""
    got, want = got.float(), want.float()
    d = (got - want).abs()
    floor = max(1e-2 * want.abs().max().item(), 1e-30)
    return (d / (want.abs() + floor)).max().item(), d.max().item()


def ce_errs(fwd, ref_fwd, grads, ref_grads):
    """{name: (relative error, max abs error)} of loss, lse, dx, dw and db:
    loss and lse by scaled_err, dx by row_err over its rows, dw by row_err
    over its columns (a row of dw.t() is one vocab column), db
    elementwise."""
    (loss, lse), (ploss, plse) = fwd, ref_fwd
    (dx, dw, db), (pdx, pdw, pdb) = grads, ref_grads
    return {"loss": scaled_err(loss, ploss), "lse": scaled_err(lse, plse),
            "dx": row_err(dx, pdx), "dw": row_err(dw.t(), pdw.t()), "db": elem_err(db, pdb)}


def ce_case(torch, ops, g, N, D, V, dt, bdt, label):
    """Forward and backward kernel against the plain twins on one case; the
    plain backward is fed the kernel's lse.  The first three targets are
    the last vocab column, V + 3 and -1: the last two must cost exactly lse
    and add no one-hot term to the gradients.  Fails past the limits (loss
    and lse at TOL["f32"] in both dtypes, the gradients at the dtype's
    TOL).  Returns the operands, the plain backward and the errors."""
    dev = torch.device("cuda")
    x = (torch.randn((N, D), generator=g, device=dev) * 0.5).to(dt)
    w = (torch.randn((D, V), generator=g, device=dev) * 0.05).to(dt)
    b = (torch.randn((V,), generator=g, device=dev) * 0.1).to(bdt)
    t = torch.randint(0, V, (N,), generator=g, device=dev)
    t[:3] = torch.tensor([V - 1, V + 3, -1], device=dev)
    gr = torch.rand((N,), generator=g, device=dev) / N
    fwd = ops.fused_linear_ce_fwd(x, w, b, t)
    if not torch.equal(fwd[0][1:3], fwd[1][1:3]):
        fail(f"fused_linear_ce {label}: a target outside [0, V) does not cost lse")
    ref_fwd = ops.fused_linear_ce_plain(x, w, b, t)
    lse = fwd[1]
    want = ops.fused_linear_ce_bwd_plain(x, w, b, t, lse, gr)
    errs = ce_errs(fwd, ref_fwd, ops.fused_linear_ce_bwd(x, w, b, t, lse, gr), want)
    lim = TOL["bf16" if dt == torch.bfloat16 else "f32"]
    for name, (rel, _) in errs.items():
        if not rel < (TOL["f32"] if name in ("loss", "lse") else lim):
            fail(f"fused_linear_ce {label}: {name} differs from the plain twin by {rel} (limit "
                 f"{TOL['f32'] if name in ('loss', 'lse') else lim})")
    return (x, w, b, t, lse, gr), want, errs


def ce_planted_faults(ops, operands, want):
    """Shows that the bf16 check of the slice case catches two faults of the
    backward: dx of a run on the first V - 64 columns of w and b (one
    vocab step fewer), held by row against the full reference, and the
    backward fed an lse off by FAULT_SHIFT.  Fails unless ce_case's limits
    flag both; returns each fault's errors beside the global measure."""
    x, w, b, t, lse, gr = operands
    V = w.shape[1]
    dx = ops.fused_linear_ce_bwd(x, w[:, :V - 64].contiguous(), b[:V - 64].contiguous(), t,
                                 lse, gr)[0]
    dropped = {"dx": row_err(dx, want[0])[0], "dx_global_scaled": scaled_err(dx, want[0])[0]}
    if not dropped["dx"] >= TOL["bf16"]:
        fail(f"CE planted fault (a dropped vocab step) passed the check: {dropped}")
    grads = ops.fused_linear_ce_bwd(x, w, b, t, lse + FAULT_SHIFT, gr)
    shifted = {"dx": row_err(grads[0], want[0])[0], "dw": row_err(grads[1].t(), want[1].t())[0],
               "db": elem_err(grads[2], want[2])[0]}
    shifted["global_scaled"] = max(scaled_err(a, r)[0] for a, r in zip(grads, want))
    if not max(shifted[n] for n in ("dx", "dw", "db")) >= TOL["bf16"]:
        fail(f"CE planted fault (lse + {FAULT_SHIFT} in the backward) passed: {shifted}")
    return {"dropped_vocab_step": dropped, "lse_shift": shifted}


def routes_taken(wrapper, fn):
    """fn()'s result and the routes of ``wrapper``'s launches during it."""
    before = dict(wrapper.routes)
    out = fn()
    return out, [r for r in wrapper.routes for _ in range(wrapper.routes[r] - before[r])]


def ce_fwd_case(torch, ops, g, N, D, V, bdt, layout, want_route, label):
    """The bf16 forward against its plain twin, held to the route it must
    take; the first three targets are the last vocab column (in a partial
    last tile where V is not a tile multiple), V + 3 and -1 (both cost
    lse).  Fails past TOL["f32"] on loss or lse (scaled_err); returns
    (x, w, b, t), the twin's (loss, lse) and the errors."""
    dev = torch.device("cuda")
    x = (torch.randn((N, D), generator=g, device=dev) * 0.5).bfloat16()
    if layout == "offset":
        x = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(N, D)
    w = (torch.randn((D, V), generator=g, device=dev) * 0.05).bfloat16()
    b = (torch.randn((V,), generator=g, device=dev) * 0.1).to(
        torch.bfloat16 if bdt == "bf16" else torch.float32)
    t = torch.randint(0, V, (N,), generator=g, device=dev)
    t[:3] = torch.tensor([V - 1, V + 3, -1], device=dev)
    got, route = routes_taken(ops.fused_linear_ce_fwd, lambda: ops.fused_linear_ce_fwd(x, w, b, t))
    if route != [want_route]:
        fail(f"fused_linear_ce_fwd {label}: took the route {route}, not {want_route}")
    want = ops.fused_linear_ce_plain(x, w, b, t)
    errs = {"loss": scaled_err(got[0], want[0]), "lse": scaled_err(got[1], want[1])}
    for name, (rel, _) in errs.items():
        if not rel < TOL["f32"]:
            fail(f"fused_linear_ce_fwd {label} ({route[0]} route): {name} differs from the plain "
                 f"twin by {rel} (limit {TOL['f32']})")
    if not torch.equal(got[0][1:3], got[1][1:3]):
        fail(f"fused_linear_ce_fwd {label}: a target outside [0, V) does not cost lse")
    return (x, w, b, t), want, errs


def ce_fwd_checks(torch, ops, g, operands):
    """The bf16 forward beside phase 4's CE cases: CE_FWD_CASES on their
    routes; on the slice's operands (x, w, b, t), its wgmma route, two calls
    bitwise equal, and one planted fault that the check must flag: w and b
    cut to their first V - 128 columns, with every 7th target moved into the
    cut tile, against the twin on the whole of w and b."""
    errs = {str(c): ce_fwd_case(torch, ops, g, *c, f"{c}")[2] for c in CE_FWD_CASES}
    x, w, b, t = operands
    V = w.shape[1]
    one, route = routes_taken(ops.fused_linear_ce_fwd, lambda: ops.fused_linear_ce_fwd(x, w, b, t))
    if route != ["wgmma"]:
        fail(f"fused_linear_ce_fwd slice: took the route {route}, not wgmma")
    same = all(torch.equal(p, q) for p, q in zip(one, ops.fused_linear_ce_fwd(x, w, b, t)))
    if not same:
        fail("fused_linear_ce_fwd: two calls on the slice's inputs differ")
    tc = t.clone()
    tc[::7] = V - 128 + torch.arange(tc[::7].numel(), device=t.device) % 128
    want = ops.fused_linear_ce_plain(x, w, b, tc)
    got = ops.fused_linear_ce_fwd(x, w[:, :V - 128].contiguous(), b[:V - 128].contiguous(), tc)
    cut = {"loss": scaled_err(got[0], want[0])[0], "lse": scaled_err(got[1], want[1])[0]}
    if not max(cut.values()) >= TOL["f32"]:
        fail(f"CE forward planted fault (the last vocab tile cut) passed the check: {cut}")
    return {"cases": errs, "slice_route": route[0], "bitwise_equal": same,
            "planted_cut_tile": cut}


def adam_case(torch, ops, g, shapes, wd, label):
    dev = torch.device("cuda")
    ps = [torch.randn(s, generator=g, device=dev) * 0.02 for s in shapes]
    gs = [torch.randn(s, generator=g, device=dev) * 1e-3 for s in shapes]
    vs = [torch.randn(s, generator=g, device=dev) * 1e-4 for s in shapes]
    ss = [torch.rand(s, generator=g, device=dev) * 1e-6 for s in shapes]
    hyper = torch.tensor([ADAM["lr"], 0.9, 0.999, 1e-8, wd, 1 - 0.9**7, 1 - 0.999**7],
                         dtype=torch.float32, device=dev)
    want = [[t.clone() for t in lst] for lst in (ps, vs, ss)]
    ops.fused_adam_plain(want[0], gs, want[1], want[2], hyper)
    ops.fused_adam(ps, gs, vs, ss, hyper)
    err = 0.0
    for got, ref in zip(ps + vs + ss, want[0] + want[1] + want[2]):
        rel, absd = scaled_err(got, ref)
        err = max(err, absd)
        if not rel < 1e-6:
            fail(f"fused_adam {label}: differs from the plain twin by {rel}")
    return (ps, gs, vs, ss, hyper), err


def train_kernel_phase(torch, ops, report):
    """The training kernels against their plain twins, then their times at
    the slice's bf16 shapes.  Returns {kernel: JSON fields but launches}."""
    import torch.nn.functional as F

    from deepflows_tpu_torch.models import TransformerLM

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    B, H, L = TRAIN_B, TRAIN["num_heads"], TRAIN_L
    D = TRAIN["dim"] // H
    N, E, V = TRAIN_B * TRAIN_L, TRAIN["dim"], TRAIN["vocab_size"]
    shapes = [tuple(p.shape) for p in TransformerLM(**TRAIN, device="cuda").parameters()]
    err = {}
    for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        flash_ops, flash_refs, fe, froute, broute = flash_case(
            torch, ops, g, B, H, L, L, D, True, None, dt, f"slice {name}",
            want_route="wgmma" if name == "bf16" else "f32",
            want_bwd_route="wgmma" if name == "bf16" else "f32")
        ce_ops, ce_want, ce_e = ce_case(torch, ops, g, N, E, V, dt, dt, f"slice {name}")
        if dt == torch.bfloat16:  # the main path's dtype: the JSON line's errors
            err = {"flash_attention_fwd": max(fe["out"][1], fe["lse"][1]),
                   "flash_attention_bwd": max(fe[n][1] for n in ("dq", "dk", "dv")),
                   "fused_linear_ce_fwd": max(ce_e[n][1] for n in ("loss", "lse")),
                   "fused_linear_ce_bwd": max(ce_e[n][1] for n in ("dx", "dw", "db"))}
            report["flash_slice_bf16_errs"], report["ce_slice_bf16_errs"] = fe, ce_e
        for case in FLASH_RAGGED:  # contiguous bf16 with D % 8 == 0 is TMA's to read
            route = "f32" if name == "f32" else "mma" if case[4] % 8 else "wgmma"
            flash_case(torch, ops, g, *case, dt, f"{case} {name}", want_route=route,
                       want_bwd_route=route)
        ce_edges = [c for c in CE_D_EDGES if c[1] <= ops.fused_ce.MAX_DIM[dt]]
        report[f"ce_cases_{name}"] = {
            str(c): ce_case(torch, ops, g, *c, dt, dt, f"{c} {name}")[2]
            for c in CE_RAGGED + tuple(ce_edges)}
    for *case, layout in FLASH_MISALIGNED:
        flash_case(torch, ops, g, *case, torch.bfloat16, f"{tuple(case)} bf16 {layout}", layout,
                   "mma", "mma")
    for *case, layout in FLASH_DOUT_MISALIGNED:
        flash_case(torch, ops, g, *case, torch.bfloat16, f"{tuple(case)} bf16, dout {layout}",
                   "contiguous", "wgmma", "mma", layout)
    _, _, hv, hv_route, hv_broute = flash_case(
        torch, ops, g, B, H, L, L, D, True, None, torch.bfloat16, "slice bf16 (B, L, H, D) views",
        "heads", "wgmma", "wgmma")
    faults = flash_planted_faults(ops, flash_ops, flash_refs)
    report["flash_heads_view_errs"], report["flash_planted_faults"] = hv, faults
    q, k, v, o, lse, do = flash_ops  # the bf16 slice case: two calls give the same bits
    fwd_same = all(torch.equal(a, b) for a, b in zip(ops.flash_attention_fwd(q, k, v, True),
                                                     ops.flash_attention_fwd(q, k, v, True)))
    if not fwd_same:
        fail("flash_attention_fwd: two calls on the slice's inputs differ")
    bwd_same = all(torch.equal(a, b) for a, b in zip(
        ops.flash_attention_bwd(q, k, v, o, lse, do, True),
        ops.flash_attention_bwd(q, k, v, o, lse, do, True)))
    if not bwd_same:
        fail("flash_attention_bwd: two calls on the slice's inputs differ")
    report["flash_fwd_bitwise_equal"], report["flash_bwd_bitwise_equal"] = fwd_same, bwd_same
    report["flash_slice_route"], report["flash_slice_bwd_route"] = froute, broute
    ce_case(torch, ops, g, 130, 1000, 97, torch.bfloat16, torch.float32, "f32 bias")
    ce_faults = ce_planted_faults(ops, ce_ops, ce_want)
    x, w, b, t, clse, gr = ce_ops  # the bf16 slice case: two calls give the same bits
    ce_same = all(torch.equal(p, q) for p, q in zip(ops.fused_linear_ce_bwd(x, w, b, t, clse, gr),
                                                    ops.fused_linear_ce_bwd(x, w, b, t, clse, gr)))
    if not ce_same:
        fail("fused_linear_ce_bwd: two calls on the slice's inputs differ")
    report["ce_planted_faults"], report["ce_bitwise_equal"] = ce_faults, ce_same
    cf = report["ce_fwd"] = ce_fwd_checks(torch, ops, g, (x, w, b, t))
    adam_ops, err["fused_adam"] = adam_case(torch, ops, g, shapes, ADAM["weight_decay"], "slice")
    for wd in (0.0, 0.01):
        adam_case(torch, ops, g, [(n,) for n in ADAM_RAGGED], wd, f"ragged wd={wd}")
    n_flash = len(FLASH_RAGGED) + len(FLASH_MISALIGNED) + len(FLASH_DOUT_MISALIGNED) + 2
    print(f"  flash {n_flash} shapes, CE {len(CE_RAGGED) + len(CE_D_EDGES) + 2} "
          f"shapes, Adam {len(shapes)} + {len(ADAM_RAGGED)} tensors agree with their plain twins "
          f"in f32 and bf16; max abs err (slice, bf16): {err}")

    def fmt(e):
        return ", ".join(f"{n} {r:.3g}" for n, (r, _) in e.items())

    worst = {n: max(e[n][0] for e in report["ce_cases_bf16"].values()) for n in ce_e}
    print(f"  CE bf16, relative errors (limits: loss and lse {TOL['f32']}, the rest "
          f"{TOL['bf16']}; dx by row, dw by column, db by element): slice {fmt(ce_e)}; worst of "
          f"{len(report['ce_cases_bf16'])} other shapes (D up to {CE_D_EDGES[-1][1]}) "
          + ", ".join(f"{n} {v:.3g}" for n, v in worst.items())
          + f"; two slice-shape backward calls bitwise equal: {ce_same}")
    print(f"  CE planted faults, flagged: a dropped vocab step gives dx "
          f"{ce_faults['dropped_vocab_step']['dx']:.3g} (the global measure reads "
          f"{ce_faults['dropped_vocab_step']['dx_global_scaled']:.3g}); lse + {FAULT_SHIFT} gives "
          + ", ".join(f"{n} {v:.3g}" for n, v in ce_faults["lse_shift"].items()))

    print(f"  CE forward, bf16: the slice on the {cf['slice_route']} route, two calls bitwise "
          f"equal: {cf['bitwise_equal']}; {len(CE_FWD_CASES)} more shapes on their routes, worst "
          + ", ".join(f"{n} {max(e[n][0] for e in cf['cases'].values()):.3g}" for n in ("loss", "lse"))
          + f" (limit {TOL['f32']}); planted fault flagged: the last vocab tile cut gives "
          + ", ".join(f"{n} {v:.3g}" for n, v in cf["planted_cut_tile"].items()))

    print(f"  flash slice bf16 ({froute} route, backward {broute}), relative errors (limits: lse "
          f"{TOL['f32']}, the rest {TOL['bf16']}): {fmt(fe)}; as (B, L, H, D) views ({hv_route} "
          f"route, backward {hv_broute}): {fmt(hv)}; two slice-shape calls bitwise equal: "
          f"forward {fwd_same}, backward {bwd_same}")
    print(f"  planted faults, flagged: a dropped key tile gives out {faults['dropped_key_tile']['out']:.3g}"
          f" and lse {faults['dropped_key_tile']['lse']:.3g} (the global measure reads "
          f"{faults['dropped_key_tile']['out_global_scaled']:.3g}); lse + {FAULT_SHIFT} in the "
          f"backward gives " + ", ".join(f"{n} {v:.3g}" for n, v in faults["lse_shift"].items())
          + "; the backward's last 64 query rows dropped give " + ", ".join(
              f"{n} {v:.3g}" for n, v in faults["dropped_query_rows"].items()))

    # times at the slice's bf16 shapes, flushed L2 between timed launches
    q, k, v, o, lse, do = flash_ops
    x, w, b, t, clse, gr = ce_ops
    ps, gs, vs, ss, hyper = adam_ops
    qr, kr, vr = (a.detach().requires_grad_() for a in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
    xr, wr, br = (a.detach().requires_grad_() for a in (x, w, b))
    # F.cross_entropy refuses a target outside [0, V) but its ignore_index:
    # the library's copy ignores ce_case's two such rows (of 8192)
    tl = torch.where((t >= 0) & (t < w.shape[1]), t, -100)
    lib_loss = F.cross_entropy((torch.matmul(xr, wr) + br).float(), tl, reduction="none")
    lib_params = [p.clone().requires_grad_() for p in ps]
    for p, gg in zip(lib_params, gs):
        p.grad = gg.clone()
    lib_adam = torch.optim.Adam(lib_params, **ADAM, fused=True)
    runs = {
        "flash_attention_fwd": (
            lambda: ops.flash_attention_fwd(q, k, v, True),
            lambda: ops.flash_attention_plain(q, k, v, True),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)),
        "flash_attention_bwd": (
            lambda: ops.flash_attention_bwd(q, k, v, o, lse, do, True),
            lambda: ops.flash_attention_bwd_plain(q, k, v, o, lse, do, True),
            lambda: torch.autograd.grad(sdpa, (qr, kr, vr), do, retain_graph=True)),
        "fused_linear_ce_fwd": (
            lambda: ops.fused_linear_ce_fwd(x, w, b, t),
            lambda: ops.fused_linear_ce_plain(x, w, b, t),
            lambda: F.cross_entropy((torch.matmul(x, w) + b).float(), tl, reduction="none")),
        "fused_linear_ce_bwd": (
            lambda: ops.fused_linear_ce_bwd(x, w, b, t, clse, gr),
            lambda: ops.fused_linear_ce_bwd_plain(x, w, b, t, clse, gr),
            lambda: torch.autograd.grad(lib_loss, (xr, wr, br), gr, retain_graph=True)),
        "fused_adam": (
            lambda: ops.fused_adam(ps, gs, vs, ss, hyper),
            lambda: ops.fused_adam_plain(ps, gs, vs, ss, hyper),
            lib_adam.step),
    }
    pairs = B * H * L * (L + 1) // 2  # (query, key) pairs the causal mask keeps
    one_product = 2 * pairs * D  # FLOPs of one causal (L, L, D) product
    qkv = B * H * L * D * 2  # bytes of one bf16 (B, H, L, D) tensor
    n_adam = sum(p.numel() for p in ps)
    # (bytes each input read and each output written once, FLOPs the
    # function needs: the CE backward's three products are one logits
    # recompute, dx and dw, though the kernel's two roles each recompute)
    bounds = {
        "flash_attention_fwd": (4 * qkv + 4 * B * H * L, 2 * one_product),
        "flash_attention_bwd": (8 * qkv + 8 * B * H * L, 5 * one_product),
        "fused_linear_ce_fwd": (2 * (N * E + E * V + V) + 4 * N + 8 * N, 2 * N * E * V),
        "fused_linear_ce_bwd": (2 * 2 * (N * E + E * V + V) + 12 * N, 3 * 2 * N * E * V),
        "fused_adam": (28 * n_adam + 28, 0),
    }
    out = {}
    for name, (kern, plain, lib) in runs.items():
        reps = 3 if name == "fused_linear_ce_bwd" else 10
        r = dict(ms=event_ms(kern, reps, flush), plain_ms=event_ms(plain, reps, flush),
                 library_ms=event_ms(lib, reps, flush), max_abs_err=err[name])
        r["bound_ms"], r["bound_by"] = bound_ms(*bounds[name], "bf16")
        out[name] = r
    out["fused_linear_ce_bwd"]["plan"] = list(ops.fused_ce._bwd_plan(N, E, V))  # (C, BM, BV)
    cfw = out["fused_linear_ce_fwd"]
    cfw["fwd_route"] = cf["slice_route"]
    cfw["plan"] = list(ops.fused_ce._fwd_plan(N, V, cf["slice_route"]))  # (splits, tiles a split)
    cfw["tflops"] = bounds["fused_linear_ce_fwd"][1] / cfw["ms"] / 1e9
    fwd, bwd = out["flash_attention_fwd"], out["flash_attention_bwd"]
    fwd["fwd_route"], fwd["tflops"] = froute, bounds["flash_attention_fwd"][1] / fwd["ms"] / 1e9
    bwd["bwd_route"], bwd["tflops"] = broute, bounds["flash_attention_bwd"][1] / bwd["ms"] / 1e9
    del lib_adam, lib_params
    report["train_kernels"] = out
    return out


def sr_case(torch, ops, g, shapes, wd, gdt, external, label, misalign=False):
    """fused_adam_sr against its plain twin on one list of tensors, with
    the in-kernel Philox bits or ``external`` ones: p, v and s must agree
    bit for bit.  ``misalign`` starts every tensor one element past an
    aligned address, which takes the kernel's narrow loads.  Returns the
    operands."""
    dev = torch.device("cuda")

    def make(shape, dtype, scale, rand=torch.randn):
        if not misalign:
            return (rand(shape, generator=g, device=dev) * scale).to(dtype)
        n = math.prod(shape)
        buf = torch.empty(n + 4, dtype=dtype, device=dev)[1:n + 1].view(shape)
        return buf.copy_(rand(shape, generator=g, device=dev) * scale)

    ps = [make(s, torch.bfloat16, 0.02) for s in shapes]
    gs = [make(s, gdt, 1e-3) for s in shapes]
    vs = [make(s, torch.float32, 1e-4) for s in shapes]
    ss = [make(s, torch.float32, 1e-6, torch.rand) for s in shapes]
    bits = None
    if external:
        bits = [torch.randint(-2**31, 2**31 - 1, s, generator=g, device=dev, dtype=torch.int32)
                for s in shapes]
    hyper = torch.tensor([ADAM["lr"], 0.9, 0.999, 1e-8, wd, 1 - 0.9**7, 1 - 0.999**7],
                         dtype=torch.float32, device=dev)
    step = torch.tensor(7, dtype=torch.int32, device=dev)
    idx = list(range(1, 2 * len(shapes), 2))  # positions in a parameter list
    want = [[t.clone() for t in lst] for lst in (ps, vs, ss)]
    ops.fused_adam_sr_plain(want[0], gs, want[1], want[2], hyper, step, idx, bits)
    ops.fused_adam_sr(ps, gs, vs, ss, hyper, step, idx, bits)
    for got, ref in zip(ps + vs + ss, want[0] + want[1] + want[2]):
        if not torch.equal(got, ref):
            fail(f"fused_adam_sr {label}: not bit-exact, max |d| "
                 f"{(got.float() - ref.float()).abs().max().item()}")
    return ps, gs, vs, ss, hyper, step, idx


def sr_statistics(torch, ops, optim):
    """The rounding's statistics on the card, with the in-kernel Philox
    bits: the mean SR bias over 64 steps' streams at 2^20 elements (limit
    0.01 ulp), and the bf16 stall of tests/test_pallas.py at 2^20 elements
    (round to nearest never moves; SR moves 0.5-1.5x lr x steps)."""
    dev = torch.device("cuda")
    n = 1 << 20
    g = torch.Generator(device=dev).manual_seed(4)
    p = torch.randn(n, generator=g, device=dev).to(torch.bfloat16)
    grad = torch.full((n,), 1e-4, device=dev)
    hyper = torch.tensor([1e-3, 0.9, 0.999, 1e-8, 0.0, 0.1, 0.001], device=dev)
    want = p.double() - 1e-3 * (0.1e-4 / 0.1) / (math.sqrt(0.001e-8 / 0.001) + 1e-8)
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30))) - 7)
    acc = torch.zeros(n, dtype=torch.float64, device=dev)
    for seed in range(64):
        q, v, s = p.clone(), torch.zeros(n, device=dev), torch.zeros(n, device=dev)
        ops.fused_adam_sr(q, grad, v, s, hyper, torch.tensor(seed, dtype=torch.int32, device=dev))
        acc += q.double()
    bias = ((acc / 64 - want) / ulp).mean().item()
    if not abs(bias) < 0.01:
        fail(f"fused_adam_sr: mean SR bias {bias} ulp (limit 0.01)")
    steps, lr = 120, 2e-4
    moved = {}
    for sr in (False, True):
        w = torch.nn.Parameter(torch.ones(n, dtype=torch.bfloat16, device=dev))
        opt = optim.Adam([w], lr=lr, stochastic_round=sr)
        for _ in range(steps):
            w.grad = torch.ones(n, dtype=torch.bfloat16, device=dev)
            opt.step()
        moved[sr] = 1.0 - w.detach().float().mean().item()
        if sr is False and not (w.detach() == 1.0).all():
            fail("round-to-nearest bf16 Adam moved below half an ulp")
    if not 0.5 * lr * steps < moved[True] < 1.5 * lr * steps:
        fail(f"SR Adam moved {moved[True]}, expected about {lr * steps}")
    return dict(mean_bias_ulp=bias, stall_rtn_moved=moved[False], stall_sr_moved=moved[True],
                stall_expected=lr * steps)


def sr_kernel_phase(torch, ops, report):
    """fused_adam_sr against its plain twin, bit for bit, over the
    d1024 x 12 model's 198 tensors and ragged sizes, with both bit sources;
    its statistics; its time at the slice's tensors."""
    from deepflows_tpu_torch import optim
    from deepflows_tpu_torch.models import TransformerLM

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    shapes = [tuple(p.shape) for p in TransformerLM(**TRAIN, device="cuda").parameters()]
    sr_case(torch, ops, g, shapes, ADAM["weight_decay"], torch.bfloat16, True,
            "slice external bits")
    slice_ops = sr_case(torch, ops, g, shapes, ADAM["weight_decay"], torch.bfloat16, False,
                        "slice Philox")
    ragged = [(n,) for n in ADAM_RAGGED]
    for gdt in (torch.bfloat16, torch.float32):
        for wd in (0.0, 0.01):
            for external in (False, True):
                for misalign in (False, True):
                    sr_case(torch, ops, g, ragged, wd, gdt, external,
                            f"ragged g={gdt} wd={wd} external={external} misaligned={misalign}",
                            misalign)
    stats = sr_statistics(torch, ops, optim)
    print(f"  fused_adam_sr bit-exact against its plain twin over {len(shapes)} + "
          f"{len(ADAM_RAGGED)} tensors (Philox and external bits, bf16 and f32 g, aligned and "
          f"not); mean SR bias over 64 streams of 2^20: {stats['mean_bias_ulp']:.5f} ulp (limit "
          f"0.01); stall: RTN moved {stats['stall_rtn_moved']}, SR {stats['stall_sr_moved']:.6f}"
          f" (expected {stats['stall_expected']})")
    ps, gs, vs, ss, hyper, step, idx = slice_ops

    def flush():
        flush_buf.zero_()

    n = sum(p.numel() for p in ps)
    r = dict(ms=event_ms(lambda: ops.fused_adam_sr(ps, gs, vs, ss, hyper, step, idx), 10, flush),
             plain_ms=event_ms(  # one run: the twin's Philox takes a second
                 lambda: ops.fused_adam_sr_plain(ps, gs, vs, ss, hyper, step, idx), 1, flush),
             library_ms=None, max_abs_err=0.0, elements=n, statistics=stats)
    # bf16 p read and written, bf16 g read, f32 v and s read and written
    r["bound_ms"], r["bound_by"] = bound_ms(22 * n + 28 + 4, 0, "f32")
    report["fused_adam_sr"] = r
    return r


MLP_B, MLP_STEPS = 256, 30
MLP_SHAPES = ((256, 784, 100), (256, 100, 20), (256, 20, 10))  # (M, K, N) a layer
MM_SHAPES = ((128, 256, 128), (100, 70, 50), (257, 129, 384), (64, 100, 32))  # tests/test_pallas.py
# the linear plan's K split edges, at an M·N that splits (ops/linear.py _linear_plan)
SPLIT_SHAPES = tuple((64, k, 48) for k in (8, 9, 16, 17, 784, 4095))
# products on the large tile beside 4096^3, ragged M, N and K: rows of 16-byte
# multiples (TMA), B's rows not (cp.async; 1030 and 2050, 2817), A's not
# either (1001: 4-byte copies)
LARGE_SHAPES = ((2000, 1032, 2056), (2000, 1030, 2050), (1536, 100, 2817), (1500, 1001, 2900))


def mm_check(got, want, label):
    d = (got - want).abs()
    if (d > 1e-3 + 1e-4 * want.abs()).any():
        fail(f"{label}: max |d| {d.max().item()} past rtol 1e-4, atol 1e-3")
    return d.max().item()


def large_tile_checks(torch, ops, g):
    """The 128 x 128 tile (ops/linear.py _linear_plan's large tile): at
    LARGE_SHAPES, matmul in each operand layout (contiguous, A or B or both
    transposed views, A seen through a stride of 2 along K) and linear_fused
    with each epilogue against the twins at rtol 1e-4 / atol 1e-3; at 4096^3
    matmul bitwise equal to the small tile forced to one split (both sum
    each output in one fmaf chain over k from 0).  Returns the largest
    error and whether the 4096^3 products are bitwise equal."""
    dev = torch.device("cuda")
    err = 0.0
    for m, k, n in LARGE_SHAPES:
        if ops.linear._linear_plan(m, n, k)[0] != 128:
            fail(f"the linear plan does not take the large tile at {(m, k, n)}")
        a, b = (torch.randn(s, generator=g, device=dev) for s in ((m, k), (k, n)))
        bias = torch.randn((1, n), generator=g, device=dev)
        a2 = torch.randn((m, 2 * k), generator=g, device=dev)[:, ::2]
        at, bt = a.t().contiguous().t(), b.t().contiguous().t()
        for lab, aa, bb in (("", a, b), (" a^T", at, b), (" b^T", a, bt), (" a^T b^T", at, bt),
                            (" a[:, ::2]", a2, b)):
            err = max(err, mm_check(ops.matmul(aa, bb), ops.matmul_plain(aa, bb),
                                    f"matmul {(m, k, n)}{lab}"))
        for act in ops.linear.ACTIVATIONS:
            err = max(err, mm_check(ops.linear_fused(a, b, bias, act),
                                    ops.linear_fused_plain(a, b, bias, act),
                                    f"linear_fused {(m, k, n)} {act}"))
    big = 4096
    a, b = (torch.randn((big, big), generator=g, device=dev) for _ in range(2))
    large = ops.matmul(a, b)
    plan = ops.linear._linear_plan
    ops.linear._linear_plan = lambda m, n, k: (32, k, 1)
    try:
        small = ops.matmul(a, b)
    finally:
        ops.linear._linear_plan = plan
    same = torch.equal(large, small)
    if not same:
        fail(f"matmul 4096^3: the large tile and the small tile with one split differ by "
             f"{(large - small).abs().max().item()}")
    return err, same


def linear_kernel_phase(torch, ops, report):
    """matmul and linear_fused (every activation) against their plain twins
    at rtol 1e-4 / atol 1e-3 (the JAX tests' bound): the MLP's layers and
    their backward products (transposed views), tests/test_pallas.py's
    shapes, and 4096^3; their times beside bound, twin and library call."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    err = {"matmul": 0.0, "linear_fused": 0.0}
    for m, k, n in MLP_SHAPES + MM_SHAPES + SPLIT_SHAPES + ((1, 5, 3),):
        a, b = (torch.randn(s, generator=g, device=dev) for s in ((m, k), (k, n)))
        bias = torch.randn((1, n), generator=g, device=dev)
        views = (("", a, b), (" a^T", a.t().contiguous().t(), b),
                 (" b^T", a, b.t().contiguous().t()))
        for lab, aa, bb in views:
            e = mm_check(ops.matmul(aa, bb), ops.matmul_plain(aa, bb),
                         f"matmul {(m, k, n)}{lab}")
            err["matmul"] = max(err["matmul"], e)
        for act in ops.linear.ACTIVATIONS:
            e = mm_check(ops.linear_fused(a, b, bias, act), ops.linear_fused_plain(a, b, bias, act),
                         f"linear_fused {(m, k, n)} {act}")
            err["linear_fused"] = max(err["linear_fused"], e)
    # the bias-free MLP's backward products: dW = x^T g, dx = g W^T
    for m, k, n in MLP_SHAPES:
        x, w, gy = (torch.randn(s, generator=g, device=dev) for s in ((m, k), (k, n), (m, n)))
        mm_check(ops.matmul(x.t(), gy), ops.matmul_plain(x.t(), gy), f"dW {(k, n)}")
        mm_check(ops.matmul(gy, w.t()), ops.matmul_plain(gy, w.t()), f"dx {(m, k)}")
    big = 4096
    a, b = (torch.randn((big, big), generator=g, device=dev) for _ in range(2))
    e = mm_check(ops.matmul(a, b), ops.matmul_plain(a, b), "matmul 4096^3")
    err["matmul"] = max(err["matmul"], e)
    bias = torch.randn((1, big), generator=g, device=dev)
    for act in ops.linear.ACTIVATIONS:
        e = mm_check(ops.linear_fused(a, b, bias, act), ops.linear_fused_plain(a, b, bias, act),
                     f"linear_fused 4096^3 {act}")
        err["linear_fused"] = max(err["linear_fused"], e)
    e, large_same = large_tile_checks(torch, ops, g)
    err["matmul"] = max(err["matmul"], e)
    report["matmul_large_small_bitwise_equal"] = large_same
    m, k, n = MLP_SHAPES[0]  # two MLP layer-1 calls give the same bits
    x, w = (torch.randn(s, generator=g, device=dev) for s in ((m, k), (k, n)))
    bias = torch.randn((1, n), generator=g, device=dev)
    same = torch.equal(ops.linear_fused(x, w, bias), ops.linear_fused(x, w, bias))
    if not same:
        fail("linear_fused: two calls at MLP layer 1 differ")
    report["linear_bitwise_equal"] = same
    print(f"  matmul and linear_fused agree with their plain twins (rtol 1e-4, atol 1e-3) at "
          f"{len(MLP_SHAPES) + len(MM_SHAPES) + len(SPLIT_SHAPES) + 1} shapes (K split edges "
          f"{[s[1] for s in SPLIT_SHAPES]}), transposed views, the MLP's backward products and "
          f"4096^3; the large tile at {len(LARGE_SHAPES)} ragged shapes in every operand "
          f"layout; max abs err {err}; two MLP layer-1 calls bitwise equal: {same}; matmul "
          f"4096^3 on the large tile bitwise equal to the small tile with one split: "
          f"{large_same}")

    def flush():
        flush_buf.zero_()

    mlp = [[torch.randn(d, generator=g, device=dev) for d in ((m, k), (k, n), (1, n))]
           for m, k, n in MLP_SHAPES]  # (x, w, b) of each layer
    out = {}
    r = dict(ms=event_ms(lambda: ops.matmul(a, b), 10, flush),
             plain_ms=event_ms(lambda: ops.matmul_plain(a, b), 10, flush),
             library_ms=event_ms(lambda: torch.matmul(a, b), 10, flush),
             max_abs_err=err["matmul"], at="4096^3 f32",
             plan=list(ops.linear._linear_plan(big, big, big)))  # (tile, chunk, splits)
    r["tile"] = f"{r['plan'][0]} x {r['plan'][0]}"
    r["bound_ms"], r["bound_by"] = bound_ms(3 * 4 * big * big, 2 * big**3, "f32")
    r["mlp_ms"] = {str(shape): event_ms(lambda o=o: ops.matmul(*o[:2]), 10, flush)
                   for shape, o in zip(MLP_SHAPES, mlp)}
    # the bias-free MLP's 8 calls a step (eager_phase): 3 forward, dW = x^T g
    # of every layer, dx = g W^T of layers 2 and 3, as the transposed views
    # its backward passes; each call's ms and bound, summed
    calls = []
    for i, (x, w, _) in enumerate(mlp):
        gy = torch.randn((x.shape[0], w.shape[1]), generator=g, device=dev)
        calls += [(x, w), (x.t(), gy)] + ([(gy, w.t())] if i else [])
    r["mlp8"] = {name: sum(event_ms(lambda c=c: fn(*c), 10, flush) for c in calls)
                 for name, fn in (("ms", ops.matmul), ("plain_ms", ops.matmul_plain),
                                  ("library_ms", torch.matmul))}
    r["mlp8"]["bound_ms"] = sum(
        bound_ms(4 * (a.shape[0] * a.shape[1] + b.numel() + a.shape[0] * b.shape[1]),
                 2 * a.shape[0] * a.shape[1] * b.shape[1], "f32")[0] for a, b in calls)
    out["matmul"] = r
    (x, w, bias), (m, k, n) = mlp[0], MLP_SHAPES[0]
    r = dict(ms=event_ms(lambda: ops.linear_fused(x, w, bias), 20, flush),
             plain_ms=event_ms(lambda: ops.linear_fused_plain(x, w, bias), 20, flush),
             library_ms=event_ms(lambda: torch.addmm(bias, x, w), 20, flush),
             max_abs_err=err["linear_fused"], at=f"MLP layer 1: ({m}, {k}) @ ({k}, {n}) f32",
             plan=list(ops.linear._linear_plan(m, n, k)))
    r["bound_ms"], r["bound_by"] = bound_ms(4 * (m * k + k * n + n + m * n), 2 * m * k * n, "f32")
    r["mlp_ms"] = {str(shape): event_ms(lambda o=o: ops.linear_fused(*o), 10, flush)
                   for shape, o in zip(MLP_SHAPES, mlp)}
    out["linear_fused"] = r
    report["linear_kernels"] = out
    return out


def eager_phase(torch, dt, report):
    """Main paths 4 and 5: models.MLP trained eagerly under
    config.use_pallas (its three Linear layers as linear_fused), then a
    bias-free twin of its widths (every product, forward and backward, as
    matmul); each run against the same run on a CPU copy."""
    import numpy as np

    from deepflows_tpu_torch import config, nn, ops, optim
    from deepflows_tpu_torch.models import MLP

    rng = np.random.default_rng(3)  # synthetic MNIST: pixels in [0, 1), a linear teacher
    teacher = rng.standard_normal((784, 10)).astype(np.float32)
    xs = rng.random((MLP_STEPS, MLP_B, 784), dtype=np.float32)
    ys = (xs @ teacher).argmax(-1).astype(np.int64)

    def bias_free(device):
        return nn.Sequential(nn.Linear(784, 100, bias=False, device=device), nn.ReLU(),
                             nn.Linear(100, 20, bias=False, device=device), nn.ReLU(),
                             nn.Linear(20, 10, bias=False, device=device))

    def train(model, device, per_step=None):
        x_all, y_all = torch.as_tensor(xs, device=device), torch.as_tensor(ys, device=device)
        opt = optim.Adam(model.parameters(), lr=1e-3)
        crit = nn.CrossEntropyLoss()
        losses, wall = [], []
        for i in range(MLP_STEPS):
            before = {k.__name__: k.launches for k in ops.KERNELS}
            t0 = time.perf_counter()
            loss = crit(model(x_all[i]), y_all[i])
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.append(loss.item())
            wall.append((time.perf_counter() - t0) * 1e3)
            for k in ops.KERNELS if per_step is not None else ():
                want = per_step.get(k.__name__, 0)
                if k.launches - before[k.__name__] != want:
                    fail(f"eager step {i}: {k.__name__} launched "
                         f"{k.launches - before[k.__name__]} times, expected {want}")
        return losses, statistics.median(wall[3:])

    saved = config.use_pallas
    config.use_pallas = True
    out, counts = {}, {}
    try:
        for name, build, per_step in (("mlp", lambda d: MLP(device=d), {"linear_fused": 3}),
                                      ("mlp_bias_free", bias_free, {"matmul": 8})):
            dt.manual_seed(0)
            model = build("cuda")
            cpu = build("cpu")
            cpu.load_state_dict(model.state_dict())
            ops.reset_launch_counts()  # a main path starts here
            got, step_ms = train(model, "cuda", per_step)
            counts[name] = {k.__name__: k.launches for k in ops.KERNELS}  # and ends here
            want, _ = train(cpu, "cpu")
            rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
            print(f"  {name}: {MLP_STEPS} eager steps of B {MLP_B}, launches {counts[name]}; "
                  f"losses {got[0]:.5f} -> {got[-1]:.5f}, against a CPU copy max rel diff "
                  f"{rel:.3g} (limit 1e-4); {step_ms:.3f} ms a step of wall time")
            if not all(math.isfinite(v) for v in got) or not got[-1] < got[0]:
                fail(f"{name}: the eager loss did not fall: {got[0]} -> {got[-1]}")
            if not rel < 1e-4:
                fail(f"{name}: the card's losses differ from the CPU's by {rel}")
            out[name] = dict(losses=got, cpu_losses=want, max_rel=rel, step_wall_ms=step_ms)
    finally:
        config.use_pallas = saved
    report["eager"] = out
    return counts


def run_steps(torch, step, x, y, steps, label, per_step):
    """``steps`` calls of ``step(x, y)``, each with exactly ``per_step``
    ({kernel: launches}; every other kernel none) launches; fails on a
    miscount or a loss that is not finite.  Returns the losses, the wall
    ms and the CUDA-event ms of each step."""
    from deepflows_tpu_torch import ops

    losses, wall, events = [], [], []
    for i in range(steps):
        before = {k.__name__: k.launches for k in ops.KERNELS}
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a.record()
        loss = step(x, y)
        b.record()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
        events.append(a.elapsed_time(b))
        losses.append(float(loss))
        for k in ops.KERNELS:
            want = per_step.get(k.__name__, 0)
            if k.launches - before[k.__name__] != want:
                fail(f"{label} step {i}: {k.__name__} launched "
                     f"{k.launches - before[k.__name__]} times, expected {want}")
    if not all(math.isfinite(v) for v in losses):
        fail(f"a {label} loss is not finite: {losses}")
    return losses, wall, events


def step_profile(torch, step, x, y, steps=2, others=None, ops=None, group=None):
    """Device time of ``steps`` training steps by kernel, from
    torch.profiler, in ms a step: each of the port's kernels, the matrix
    products (cuBLAS), and everything else PyTorch runs (elementwise ops,
    reductions, copies).  ``others``, a dict, gains the last group's ms a
    step by kernel name; ``ops``, a dict, the device ms a step of the
    kernels each aten op launched itself, by op and input shapes.  With
    ``group``, a function of an aten op's name, the kernels that are not
    the port's are grouped by ``group`` of the aten op that launched them
    instead, what no aten op launched stands as "kernels of no aten op",
    and ``others`` gains the ms of each aten op of the group "other
    elementwise"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=ops is not None) as prof:
        for _ in range(steps):
            step(x, y)
        torch.cuda.synchronize()

    def ms(e):
        us = getattr(e, "self_device_time_total", None)
        return (e.self_cuda_time_total if us is None else us) / 1e3 / steps

    ours = {"flash_fwd": "flash_attention_fwd", "flash_bwd": "flash_attention_bwd",
            "ce_fwd": "fused_linear_ce_fwd", "ce_bwd": "fused_linear_ce_bwd",
            "fused_adam_sr": "fused_adam_sr", "fused_adam": "fused_adam"}
    groups, device = {}, 0.0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue  # CPU-side ops; their kernels appear as CUDA events
        device += ms(e)
        name = next((v for k, v in ours.items() if k in e.key), None)
        if name is None:
            if group is not None:
                continue  # grouped by aten op below
            name = ("matrix products (cuBLAS)" if any(k in e.key for k in ("nvjet", "gemm", "xmma"))
                    else "other PyTorch kernels")
            if others is not None and name == "other PyTorch kernels":
                others[e.key] = others.get(e.key, 0.0) + ms(e)
        groups[name] = groups.get(name, 0.0) + ms(e)
    if group is not None:
        for e in prof.key_averages():
            if e.device_type != DeviceType.CPU or ms(e) <= 0:
                continue
            name = group(e.key)
            groups[name] = groups.get(name, 0.0) + ms(e)
            if others is not None and name == "other elementwise":
                others[e.key] = ms(e)
        rest = device - sum(groups.values())
        if abs(rest) > 1e-3:
            groups["kernels of no aten op"] = rest
    if ops is not None:
        for e in prof.key_averages(group_by_input_shape=True):
            if e.device_type == DeviceType.CPU and ms(e) > 0:
                ops[f"{e.key} {e.input_shapes}"] = ms(e)
    return groups


def train_phase(torch, dt, report, sr=False, ref_first_loss=None):
    """A main path: train the full-width, full-depth bench row, with bf16
    compute over f32 masters and fused Adam, or (``sr``) on bf16 weights
    with stochastic-rounding Adam.  Returns the launch counts of the run
    and the step's numbers."""
    import numpy as np

    from deepflows_tpu_torch import nn, ops, optim
    from deepflows_tpu_torch.jit import CompiledTrainStep
    from deepflows_tpu_torch.models import TransformerLM

    dt.manual_seed(0)
    lm = TransformerLM(**TRAIN, device="cuda", flash=True)
    if sr:  # exactly the bf16 copies the compute_dtype step computes with
        lm.bfloat16()
        opt = optim.Adam(lm.parameters(), **ADAM, stochastic_round=True)
        step = CompiledTrainStep(lm.trunk(), opt, nn.LMHeadCrossEntropy(lm.head))
        per_step, key, what = PER_STEP_SR, "train_sr", "bf16 weights, SR Adam"
    else:
        opt = optim.Adam(lm.parameters(), **ADAM, fused=True)
        step = CompiledTrainStep(lm.trunk(), opt, nn.LMHeadCrossEntropy(lm.head),
                                 compute_dtype=torch.bfloat16)
        per_step, key, what = PER_STEP, "train", "bf16 compute, fused Adam"
    params = list(lm.parameters())
    print(f"model: TransformerLM {TRAIN}, {sum(p.numel() for p in params)} parameters in "
          f"{len(params)} tensors of {params[0].dtype}; B {TRAIN_B}, L {TRAIN_L}, {what}")
    rng = np.random.default_rng(0)  # the batch of bench.py
    V = TRAIN["vocab_size"]
    x = torch.as_tensor(rng.integers(0, V, (TRAIN_B, TRAIN_L)).astype(np.int32), device="cuda")
    y = torch.as_tensor(rng.integers(0, V, (TRAIN_B, TRAIN_L)).astype(np.int32), device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    routed = (ops.flash_attention_fwd, ops.flash_attention_bwd, ops.fused_linear_ce_fwd)
    routes_before = [dict(f.routes) for f in routed]
    ops.reset_launch_counts()  # the main path starts here
    losses, wall_ms, event_step_ms = run_steps(torch, step, x, y, WARMUP + TIMED, key, per_step)
    counts = {k.__name__: k.launches for k in ops.KERNELS}  # the main path ends here
    print(f"main-path launches ({key}): {counts}")
    for f, before in zip(routed, routes_before):  # bf16 head views and CE operands: TMA reads them
        by_route = {n: f.routes[n] - before[n] for n in f.routes}
        if by_route["wgmma"] != counts[f.__name__]:
            fail(f"{key}: {f.__name__} launched by route {by_route}, not all on wgmma")
        print(f"  {f.__name__} launches by route: {by_route}")
    print(f"  losses: {[round(v, 4) for v in losses]}")
    if not abs(losses[0] - math.log(V)) < 1.0:
        fail(f"{key} step-1 loss {losses[0]} is not within 1.0 of ln {V} = {math.log(V):.3f}")
    if ref_first_loss is not None:
        rel = abs(losses[0] - ref_first_loss) / abs(ref_first_loss)
        print(f"  step-1 loss {losses[0]:.6f} against the bf16-compute step's "
              f"{ref_first_loss:.6f}: rel diff {rel:.3g} (limit 1e-3)")
        if not rel < 1e-3:
            fail(f"{key} step-1 loss differs from the bf16-compute step's by {rel}")
    if not losses[-1] < losses[0]:
        fail(f"the {key} loss did not fall on the repeated batch: {losses[0]} -> {losses[-1]}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the device time of a step with its launches queued behind a spin,
    # against its wall time: the device busy share
    device_ms = event_ms(lambda: step(x, y), 3)
    timed_wall = statistics.median(wall_ms[WARMUP:])
    flops = step_flops(TRAIN_B, TRAIN_L, TRAIN["dim"], TRAIN["depth"], V)
    r = dict(
        losses=losses, step_wall_ms=timed_wall,
        step_event_ms=statistics.median(event_step_ms[WARMUP:]),
        step_device_ms=device_ms, tokens_per_s=TRAIN_B * TRAIN_L / timed_wall * 1e3,
        device_busy_share=device_ms / timed_wall, step_flops=flops,
        mfu=flops / (timed_wall * 1e-3 * PEAK_OPS["bf16"]),
        step_bound_ms=flops / PEAK_OPS["bf16"] * 1e3, peak_memory_gb=peak_gb,
    )
    print(f"  step {r['step_wall_ms']:.3f} ms wall, {r['step_event_ms']:.3f} ms between CUDA "
          f"events, {r['step_device_ms']:.3f} ms device (busy {100 * r['device_busy_share']:.1f}%);"
          f" {r['tokens_per_s']:.1f} tokens/s; MFU {100 * r['mfu']:.2f}% of {flops:.4g} FLOPs "
          f"(bound {r['step_bound_ms']:.3f} ms); peak memory {peak_gb:.2f} GB")
    r["profile_ms"] = prof = step_profile(torch, step, x, y)
    if prof:
        print(f"  device time of a step by kernel (torch.profiler, 2 steps): "
              f"{sum(prof.values()):.3f} ms: " + ", ".join(
                  f"{k} {v:.3f}" for k, v in sorted(prof.items(), key=lambda kv: -kv[1])))
    else:
        print("  device time of a step by kernel: not measured (the profiler saw no kernel)")
    report[key] = r
    return counts, r


def train_cpu_check(torch, dt, report):
    """The f32 step on the card against the same step on a CPU copy."""
    import numpy as np

    from deepflows_tpu_torch import nn, optim
    from deepflows_tpu_torch.jit import CompiledTrainStep
    from deepflows_tpu_torch.models import TransformerLM

    cfg = dict(TRAIN, depth=2)
    dt.manual_seed(1)
    lms = {"cuda": TransformerLM(**cfg, device="cuda", flash=True)}
    lms["cpu"] = TransformerLM(**cfg, device="cpu", flash=True)
    lms["cpu"].load_state_dict(lms["cuda"].state_dict())
    steps = {d: CompiledTrainStep(lm.trunk(), optim.Adam(lm.parameters(), **ADAM, fused=True),
                                  nn.LMHeadCrossEntropy(lm.head)) for d, lm in lms.items()}
    start = {n: p.detach().clone() for n, p in lms["cpu"].named_parameters()}
    rng = np.random.default_rng(1)
    got = {"cuda": [], "cpu": []}
    t0 = time.perf_counter()
    for _ in range(3):
        x = rng.integers(0, cfg["vocab_size"], (2, TRAIN_L)).astype(np.int32)
        y = rng.integers(0, cfg["vocab_size"], (2, TRAIN_L)).astype(np.int32)
        for d, step in steps.items():
            got[d].append(float(step(x, y)))
    rel = max(abs(a - b) / abs(b) for a, b in zip(got["cuda"], got["cpu"]))
    # each parameter's change over the 3 steps, card against CPU: the worst
    # leaf by norm and by largest element
    card = dict(lms["cuda"].named_parameters())
    moved = {}
    for n, p in lms["cpu"].named_parameters():
        want = p.detach() - start[n]
        d = card[n].detach().cpu() - start[n] - want
        moved[n] = ((d.norm() / want.norm().clamp_min(1e-30)).item(),
                    (d.abs().max() / want.abs().max().clamp_min(1e-30)).item())
    worst_norm = max(moved.items(), key=lambda kv: kv[1][0])
    worst_max = max(moved.items(), key=lambda kv: kv[1][1])
    print(f"  f32, depth 2, B 2: card losses {got['cuda']}, CPU {got['cpu']}; max rel diff "
          f"{rel:.3g} (limit 1e-3); parameter change after 3 steps, card against CPU: worst "
          f"leaf by norm {worst_norm[0]} {worst_norm[1][0]:.3g} (limit {PARAM_TOL}), by largest "
          f"element {worst_max[0]} {worst_max[1][1]:.3g}; {time.perf_counter() - t0:.1f} s")
    if not rel < 1e-3:
        fail(f"the card's f32 losses differ from the CPU's by {rel}")
    if not worst_norm[1][0] < PARAM_TOL:
        fail(f"the card's parameter change in {worst_norm[0]} differs from the CPU's by "
             f"{worst_norm[1][0]} of its norm")
    report["train_vs_cpu"] = dict(cuda=got["cuda"], cpu=got["cpu"], max_rel=rel,
                                  param_change_rel=moved)


# ------------------------------------------------ the Llama and Mixtral family
# Published widths (the config.json of mistralai/Mistral-7B-v0.1 and of
# mistralai/Mixtral-8x7B-v0.1), depth cut as PERF.md section 4 lists;
# weights random from a seed.  Both models' rms_norm_eps is 1e-5, set on the
# norms after construction as utils/hf_llama.py does (LlamaLM takes no eps).
MISTRAL = dict(vocab_size=32000, dim=4096, num_heads=32, num_kv_heads=8, mlp_ratio=3.5,
               rope_theta=10000.0, window=4096)
MIXTRAL = dict(vocab_size=32000, dim=4096, num_heads=32, num_kv_heads=8, mlp_ratio=3.5,
               n_experts=8, top_k=2, rope_theta=1e6)
RMS_EPS = 1e-5
LLAMA_SERVE = dict(MISTRAL, depth=8, max_len=192)
MIXTRAL_SERVE = dict(MIXTRAL, depth=2, max_len=192)
LLAMA_STREAM = dict(MISTRAL, depth=2, max_len=4096)  # max_len = window: the ring wraps
STREAM_PROMPT, STREAM_NEW, STREAM_TWIN_LEN = 64, 4160, 8192
LLAMA_TRAIN = dict(MISTRAL, depth=2, max_len=8192)  # B 1 x L 8192: the window cuts the band
MIXTRAL_TRAIN = dict(MIXTRAL, depth=1, max_len=2048)
FAMILY_STEPS = {"llama": 5, "mixtral": 3}
# Llama 2 7B's published peak learning rate; the bench row's 5e-3 throws a
# 7B-width model's loss about (10.4, 0.36, 3.0, 20.9 in a first run)
FAMILY_ADAM = dict(ADAM, lr=3e-4)
TOP_OTHERS = 6  # the "other PyTorch kernels" printed by name
FAMILY_REQUESTS = {  # (batch, prompt, new tokens, sampling or beams)
    "llama": ((8, 64, 128, {}),
              (8, 17, 50, dict(temperature=0.8, top_k=50, top_p=0.9, seed=1)),
              (2, 40, 32, dict(beams=4))),
    "mixtral": ((8, 64, 128, {}),),
}
FAMILY_QUANTS = {"llama": (None, "int8", "w8a8"), "mixtral": (None, "int8")}
# (K, N) of every quantised matrix of the Llama decoder at Mistral's widths
# (Mixtral's quantised matrices are its qkv, o and head)
MISTRAL_SHAPES = {"qkv": (4096, 6144), "o": (4096, 4096), "gate_up": (4096, 28672),
                  "down": (14336, 4096), "head": (4096, 32000)}
FAMILY_M = (8, 384, 1536)  # decode rows (B 8; B 2 x 4 beams); prefill rows of B 2 and B 8
# a stream token may leave its twin's only where the twin's top-2 logits
# are closer than this: the two sum attention over other cache layouts
NEAR_TIE = 1e-2


def family_model(torch, dt, cls, cfg, seed, serve):
    """A family model on the card from a seed, its RMSNorm eps set to
    RMS_EPS; held in bf16 to serve, in f32 (the masters) to train."""
    from deepflows_tpu_torch import nn

    dt.manual_seed(seed)
    lm = cls(**cfg, device="cuda", **({} if serve else dict(flash=True)))
    for m in lm.modules():
        if isinstance(m, nn.RMSNorm):
            m.eps = RMS_EPS
    if serve:
        lm.bfloat16().eval()
    return lm


def free_card(torch):
    gc.collect()
    torch.cuda.empty_cache()


def banded_pairs(L, window):
    """(query, key) pairs a causal mask with ``window`` (None: the causal
    triangle) keeps over L positions."""
    W = L if window is None else min(window, L)
    return W * (W + 1) // 2 + (L - W) * W


def family_flash_case(torch, ops, g, L, window, label, flush, chunk=4):
    """flash_attention forward and backward at a training path's shape,
    (1, 32, L, 128) bf16, q and dout as MultiheadAttention passes them
    ((B, L, H, D) seen as (B, H, L, D)), K and V repeated to every head:
    both on the wgmma route, held by row against the plain twins, computed
    ``chunk`` heads at a time (the twins materialise the (L, L) scores).
    Times kernel forward and backward and SDPA's forward (its band as a
    boolean mask) beside their bounds.  Returns the case's numbers."""
    import torch.nn.functional as F

    B, H, D = 1, 32, 128
    q, do = (flash_operand(torch, g, B, H, L, D, torch.bfloat16, "heads") for _ in range(2))
    k, v = (flash_operand(torch, g, B, H, L, D, torch.bfloat16, "contiguous") for _ in range(2))
    route, bwd_route = flash_routes(q, k, v, do)
    if (route, bwd_route) != ("wgmma", "wgmma"):
        fail(f"flash {label}: routes {route} / {bwd_route}, not wgmma")
    o, lse = ops.flash_attention_fwd(q, k, v, True, None, window)
    grads = ops.flash_attention_bwd(q, k, v, o, lse, do, True, None, window)
    live = torch.ones(L, dtype=torch.bool, device=q.device)
    errs = {}
    for h0 in range(0, H, chunk):
        sl = slice(h0, h0 + chunk)
        qs, ks, vs, dos = (t[:, sl] for t in (q, k, v, do))
        po, plse = ops.flash_attention_plain(qs, ks, vs, True, None, window)
        want = ops.flash_attention_bwd_plain(qs, ks, vs, po, plse, dos, True, None, window)
        e = flash_errs((o[:, sl], lse.view(B, H, L)[:, sl].reshape(-1, L)), (po, plse),
                       [t[:, sl] for t in grads], want, live)
        for n, (r, a) in e.items():
            r0, a0 = errs.get(n, (0.0, 0.0))
            errs[n] = (max(r0, r), max(a0, a))
        del po, plse, want
    for n, (r, _) in errs.items():
        lim = TOL["f32"] if n == "lse" else TOL["bf16"]
        if not r < lim:
            fail(f"flash {label}: {n} differs from the plain twin by {r} (limit {lim})")
    pairs = B * H * banded_pairs(L, window)
    qkv = B * H * L * D * 2
    mask = None
    if window:
        i = torch.arange(L, device=q.device)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    r = dict(shape=[B, H, L, D], window=window, routes=[route, bwd_route],
             max_abs_err={n: a for n, (_, a) in errs.items()},
             rel_err={n: e for n, (e, _) in errs.items()},
             fwd_ms=event_ms(lambda: ops.flash_attention_fwd(q, k, v, True, None, window), 5,
                             flush),
             bwd_ms=event_ms(lambda: ops.flash_attention_bwd(q, k, v, o, lse, do, True, None,
                                                             window), 5, flush),
             sdpa_fwd_ms=event_ms(lambda: F.scaled_dot_product_attention(
                 q, k, v, attn_mask=mask, is_causal=mask is None), 5, flush))
    r["fwd_bound_ms"], _ = bound_ms(4 * qkv + 4 * B * H * L, 2 * 2 * pairs * D, "bf16")
    r["bwd_bound_ms"], _ = bound_ms(8 * qkv + 8 * B * H * L, 5 * 2 * pairs * D, "bf16")
    print(f"    flash {label} (1, 32, {L}, 128) window {window}: {route} / {bwd_route}; "
          + ", ".join(f"{n} {e:.3g}" for n, e in r["rel_err"].items())
          + f"; fwd {r['fwd_ms']:.4f} ms (bound {r['fwd_bound_ms']:.4f}, SDPA "
          f"{r['sdpa_fwd_ms']:.4f}), bwd {r['bwd_ms']:.4f} ms (bound {r['bwd_bound_ms']:.4f})")
    return r


def family_param_shapes(cfg, moe):
    """The shapes of a family model's parameters, in order, without building it."""
    D, V, Hd = cfg["dim"], cfg["vocab_size"], int(cfg["dim"] * cfg["mlp_ratio"])
    kv = cfg["num_kv_heads"] * D // cfg["num_heads"]
    block = [(D,), (D, D), (D, kv), (D, kv), (D, D), (D,)]
    if moe:
        E = cfg["n_experts"]
        block += [(D, E), (1, E), (E, D, Hd), (E, D, Hd), (E, Hd, D)]
    else:
        block += [(D, Hd), (D, Hd), (Hd, D)]
    return [(V, D)] + block * cfg["depth"] + [(D,), (D, V)]


def family_kernel_phase(torch, ops, report, max_err):
    """The kernels of the family's paths against their plain twins at the
    shapes those paths give them: int8_matmul and w8a8_matmul at Mistral's
    five matrices (K up to 14336, N up to 32000) at M 8, 384 and 1536 with
    bf16 x (both output dtypes), then a Llama decode step's and prefill's
    33 calls timed; flash_attention at the Llama (L 8192, window 4096) and
    Mixtral (L 2048, causal) training shapes; fused_adam over both training
    models' parameter lists.  Returns the numbers; ``max_err`` gains the
    int8 kernels' errors."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)

    def flush():
        flush_buf.zero_()

    out = {"shapes": []}
    for M in FAMILY_M:
        for name, (K, N) in MISTRAL_SHAPES.items():
            x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
            wq, s = ops.quantize_int8(torch.randn((K, N), generator=g, device=dev) * 0.02)
            xq, sx = compare(torch, ops, x, wq, s, f"Mistral M={M} {name}", max_err)
            if M == 384:
                continue  # checked, not timed
            r = dict(M=M, K=K, N=N, shape=name)
            r["int8_ms"] = event_ms(lambda: ops.int8_matmul(x, wq, s), 5, flush)
            r["w8a8_ms"] = event_ms(lambda: ops.w8a8_matmul(xq, sx, wq, s, out_dtype=x.dtype),
                                    5, flush)
            r["int8_bound_ms"], _ = bound_ms(M * K * 2 + K * N + 4 * N + 2 * M * N,
                                             2 * M * K * N, "bf16")
            r["w8a8_bound_ms"], _ = bound_ms(M * K + 4 * M + K * N + 4 * N + 2 * M * N,
                                             2 * M * K * N, "int8")
            out["shapes"].append(r)
            print(f"  Mistral M={M:5d} {name:7s} K={K:5d} N={N:5d}: int8 {r['int8_ms']:.4f} ms "
                  f"(bound {r['int8_bound_ms']:.4f}), w8a8 {r['w8a8_ms']:.4f} ms (bound "
                  f"{r['w8a8_bound_ms']:.4f})")
    print(f"  int8_matmul and w8a8_matmul agree with their plain twins at Mistral's "
          f"{len(MISTRAL_SHAPES)} matrices, M {FAMILY_M}")
    layer = ("qkv", "o", "gate_up", "down")
    for key, M in (("decode_step", 8), ("prefill", 8 * LLAMA_SERVE["max_len"])):
        ms, bi, bw, wbytes = forward_timing(torch, ops, M, MISTRAL_SHAPES, LLAMA_SERVE["depth"],
                                            layer)
        out[key] = dict(ms, int8_bound_ms=bi[0], int8_bound_by=bi[1], w8a8_bound_ms=bw[0],
                        w8a8_bound_by=bw[1], weight_bytes=wbytes)
        print(f"  a Llama {key.replace('_', ' ')}'s {4 * LLAMA_SERVE['depth'] + 1} calls (M={M}, "
              f"bf16 x, {wbytes} weight bytes): "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
              + f"; bound int8 {bi[0]:.4f} ms ({bi[1]}), w8a8 {bw[0]:.4f} ms ({bw[1]})")
        free_card(torch)
    out["flash"] = {"llama": family_flash_case(torch, ops, g, LLAMA_TRAIN["max_len"],
                                               LLAMA_TRAIN["window"], "Llama training", flush),
                    "mixtral": family_flash_case(torch, ops, g, MIXTRAL_TRAIN["max_len"], None,
                                                 "Mixtral training", flush)}
    free_card(torch)
    out["fused_adam"] = {}
    for kind, cfg, moe in (("llama", LLAMA_TRAIN, False), ("mixtral", MIXTRAL_TRAIN, True)):
        out["fused_adam"][kind] = adam_list_check(
            torch, family_param_shapes(cfg, moe), f"the {kind} training model")
        free_card(torch)
    report["family_kernels"] = out
    return out


@contextlib.contextmanager
def plain_twins():
    """The decoders' int8 products on the plain twins, on the card."""
    from deepflows_tpu_torch import ops
    from deepflows_tpu_torch.models import decoding

    saved = decoding.int8_matmul, decoding.w8a8_matmul
    decoding.int8_matmul, decoding.w8a8_matmul = ops.int8_matmul_plain, ops.w8a8_matmul_plain
    try:
        yield
    finally:
        decoding.int8_matmul, decoding.w8a8_matmul = saved


def family_serve_phase(torch, dt, report, kind):
    """A main path: serve the Llama (Mistral-7B widths, depth 8) or Mixtral
    (8x7B widths, depth 2) model in bf16 through KVCacheDecoder in each of
    its modes, every loop replaying its captured CUDA graph; then, outside
    the count, the same requests through the eager loop on the card,
    num_beams=1 against greedy, prefill logits against the f32 decoder and
    the plain twins, and graph and eager loop timed.  Returns the launch
    counts of the run."""
    import numpy as np

    from deepflows_tpu_torch.models import KVCacheDecoder, LlamaLM, MixtralLM

    cls, cfg = {"llama": (LlamaLM, LLAMA_SERVE), "mixtral": (MixtralLM, MIXTRAL_SERVE)}[kind]
    quants, requests = FAMILY_QUANTS[kind], FAMILY_REQUESTS[kind]
    lm = family_model(torch, dt, cls, cfg, 0, serve=True)
    n_params = sum(p.numel() for p in lm.parameters())
    print(f"model: {cls.__name__} {cfg}, rms eps {RMS_EPS}, {n_params} parameters in bf16")
    # a prefill and a decode step each make one int8 product a quantised
    # matrix: q/k/v, o and (Llama) gate/up and down a layer, and the head
    per_forward = (4 if kind == "llama" else 2) * cfg["depth"] + 1
    decs = {q: KVCacheDecoder(lm, compute_dtype=torch.bfloat16, quant=q) for q in quants}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg["vocab_size"], (b, p)).astype(np.int64)
               for b, p, _, _ in requests]
    served, counts = serve_all(decs, requests, prompts, per_forward, cfg["vocab_size"],
                               f"{kind} ")
    print(f"main-path launches ({kind} serving): {counts}")
    for quant, dec in decs.items():
        missing = [k for k in dec._loops if k not in dec._graphs]
        if missing or len(dec._loops) != len(requests):
            fail(f"{kind} quant={quant}: loops {list(dec._loops)} without a graph: {missing}")

    for quant, dec in decs.items():  # the graph against the eager loop on the card
        eager = KVCacheDecoder(lm, compute_dtype=torch.bfloat16, quant=quant)
        eager._capture = False
        for (b, p, new, kw), idx, got in zip(requests, prompts, served[quant]):
            want = serve(eager, idx, new, kw, served[quant])
            if not (np.array_equal(want[0], got[0]) and np.array_equal(want[1], got[1])):
                fail(f"{kind} quant={quant} B={b} +{new} {kw}: the graph's tokens or scores "
                     "differ from the eager loop's")
        one_beam = any("beams" in kw for _, _, _, kw in requests)
        if one_beam:
            b, p, new, _ = requests[0]
            one = dec.generate_beam(prompts[0], new, num_beams=1)
            if not np.array_equal(one, served[quant][0][0]):
                col = int(np.nonzero((one != served[quant][0][0]).any(0))[0][0]) - p
                fail(f"{kind} quant={quant}: num_beams=1 leaves greedy at step {col}")
        del eager
        free_card(torch)
        print(f"  {kind} quant={str(quant):5s}: graph == eager loop on all {len(requests)} "
              "requests" + ("; num_beams=1 == greedy" if one_beam else ""))

    # prefill logits (B 2 of the first request) against the f32 decoder and,
    # quantised, against the same mode on the plain twins
    p0 = requests[0][1]
    prompt = torch.zeros((2, cfg["max_len"]), dtype=torch.long)
    prompt[:, :p0] = torch.as_tensor(prompts[0][:2])
    prompt = prompt.cuda()
    checks = {}
    with torch.inference_mode():
        ref_dec = KVCacheDecoder(lm, compute_dtype=torch.float32)
        ref_params = ref_dec._with_rope(ref_dec._prep_tree(ref_dec._gather()))
        ref = ref_dec._prefill(ref_params, prompt, p0)[2]
        del ref_params
        del ref_dec
        free_card(torch)
        for quant, dec in decs.items():
            got = dec._prefill(dec._prepared(), prompt, p0)[2]
            if got.dtype != torch.float32 or not torch.isfinite(got).all():
                fail(f"{kind} quant={quant}: prefill logits not finite f32")
            c = {"vs_f32": rel_err(got, ref)}
            if quant is not None:
                with plain_twins():
                    c["vs_plain_twins"] = rel_err(got, dec._prefill(dec._prepared(), prompt,
                                                                    p0)[2])
            checks[str(quant)] = c
            print(f"  {kind} prefill logits quant={str(quant):5s}: max rel err "
                  + ", ".join(f"{n} {e:.5f}" for n, e in c.items())
                  + f" (limit {LOGIT_TOL[quant]})")
            if not max(c.values()) < LOGIT_TOL[quant]:
                fail(f"{kind} quant={quant}: prefill logits off by {c}")
    report[f"{kind}_serve_prefill"] = checks

    b, p, new, _ = requests[0]  # decode throughput, graph and eager loop
    rates = {}
    for quant, dec in decs.items():
        eager = KVCacheDecoder(lm, compute_dtype=torch.bfloat16, quant=quant)
        eager._capture = False
        runs = {}
        for name, d in (("graph", dec), ("eager", eager)):
            runs[name], lp, _ = loop_timing(torch, d, prompts[0], new)
        w_bytes, kv_bytes, floor_ms = step_floor(dec._params, lp.kc, lp.vc)
        r = {}
        for name, m in runs.items():
            q = dict(generate_tok_s=b * new / m["generate_s"],
                     decode_tok_s=b * new / m["decode_s"],
                     decode_step_ms=m["decode_s"] / new * 1e3, step_device_ms=m["step_device_ms"],
                     prep_prefill_ms=m["prep_prefill_s"] * 1e3,
                     step_by_kernel_group=m["profile"])
            q["device_busy_share"] = q["step_device_ms"] / q["decode_step_ms"]
            r[name] = q
        r.update(step_weight_bytes=w_bytes, step_cache_bytes=kv_bytes, step_floor_ms=floor_ms,
                 decode_tok_s_ceiling=b / floor_ms * 1e3)
        if quant is None:  # the dense head widens its bf16 weight to f32 every step
            hw = dec._params["head_w"]
            r["head_widening_ms"] = event_ms(lambda: hw.float(), 5)
        rates[str(quant)] = r
        gr, er = r["graph"], r["eager"]
        print(f"  {kind} throughput quant={str(quant):5s}, graph / eager loop: decode "
              f"{gr['decode_tok_s']:.1f} / {er['decode_tok_s']:.1f} tok/s, generate "
              f"{gr['generate_tok_s']:.1f} / {er['generate_tok_s']:.1f} tok/s; "
              f"{gr['decode_step_ms']:.4f} / {er['decode_step_ms']:.4f} ms a step, device "
              f"{gr['step_device_ms']:.4f} / {er['step_device_ms']:.4f} ms (busy "
              f"{100 * gr['device_busy_share']:.1f} / {100 * er['device_busy_share']:.1f}%); "
              f"prep+prefill {gr['prep_prefill_ms']:.2f} ms; floor {floor_ms:.4f} ms a step "
              f"({w_bytes} weight bytes, {kv_bytes} cache bytes)"
              + (f"; the head's f32 widening alone {r['head_widening_ms']:.4f} ms"
                 if quant is None else ""))
        gr["other_kernels_ms"] = top_others(runs["graph"]["others"])
        print("    graph step by kernel group (torch.profiler, ms, kernels): " + ", ".join(
            f"{k} {v['ms']:.4f} ({v['kernels']:.0f})"
            for k, v in sorted(gr["step_by_kernel_group"].items())))
        print("    the largest other PyTorch kernels (ms a step): " + "; ".join(
            f"{v:.4f} {k}" for k, v in gr["other_kernels_ms"].items()))
        del eager, lp
        free_card(torch)
    report[f"{kind}_serve"] = rates
    del decs, lm
    free_card(torch)
    return counts


def stream_twin_check(torch, dec, prompt, got):
    """The non-streaming twin's decoder ``dec`` fed the stream's own tokens
    (its step called eagerly) must pick the stream's token at every step,
    or see a near-tie there (top-2 logits closer than NEAR_TIE).  Returns
    (steps, near-ties, steps where the two part at a near-tie)."""
    plen = prompt.shape[1]
    new = got.shape[1] - plen
    with torch.inference_mode():
        params = dec._prepared()
        padded = torch.zeros((1, dec.lm.max_len), dtype=torch.long)
        padded[:, :plen] = torch.as_tensor(prompt)
        kc, vc, logits = dec._prefill(params, padded.cuda(), plen)
        toks = torch.as_tensor(got[0], device="cuda")
        positions = torch.arange(dec.lm.max_len, device="cuda")
        pos = torch.tensor(plen, device="cuda")
        near = parted = 0
        for t in range(new):
            top = torch.topk(logits[0], 2)
            lead = (top.values[0] - top.values[1]).item()
            near += lead < NEAR_TIE
            if top.indices[0].item() != int(got[0, plen + t]):
                if not lead < NEAR_TIE:
                    fail(f"stream token {t} is {int(got[0, plen + t])}; fed the same tokens, the "
                         f"twin picks {top.indices[0].item()}, ahead by {lead}")
                parted += 1
            if t + 1 < new:
                logits, kc, vc = dec._forward_one(params, kc, vc, toks[plen + t:plen + t + 1],
                                                  pos, positions)
                pos += 1
    return new, near, parted


def llama_stream_phase(torch, dt, report):
    """A main path: the Llama model at depth 2, max_len 4096 = window,
    streams 64 + 4160 greedy tokens past max_len on its ring cache (a
    replayed graph); its tokens against the twin of max_len 8192 with the
    same weights, which does not stream."""
    import numpy as np

    from deepflows_tpu_torch import ops
    from deepflows_tpu_torch.models import KVCacheDecoder, LlamaLM

    lm = family_model(torch, dt, LlamaLM, LLAMA_STREAM, 1, serve=True)
    twin = family_model(torch, dt, LlamaLM, dict(LLAMA_STREAM, max_len=STREAM_TWIN_LEN), 2,
                        serve=True)
    twin.load_state_dict(lm.state_dict())
    prompt = np.random.default_rng(2).integers(0, MISTRAL["vocab_size"], (1, STREAM_PROMPT))
    dec = KVCacheDecoder(lm, compute_dtype=torch.bfloat16)
    twin_dec = KVCacheDecoder(twin, compute_dtype=torch.bfloat16)
    print(f"model: LlamaLM {LLAMA_STREAM} and its twin at max_len {STREAM_TWIN_LEN}; B 1, "
          f"prompt {STREAM_PROMPT} + {STREAM_NEW}")
    ops.reset_launch_counts()  # the main path starts here (dense: no kernel of the port)
    dec.generate(prompt, STREAM_NEW)  # the key's first call warms up and captures
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = dec.generate(prompt, STREAM_NEW)
    stream_s = time.perf_counter() - t0
    counts = {k.__name__: k.launches for k in ops.KERNELS}  # the main path ends here
    keys = [k for k in dec._loops if k[0] == "stream"]
    if len(keys) != 1 or keys[0][-1] != STREAM_TWIN_LEN or keys[0] not in dec._graphs:
        fail(f"stream: loop keys {list(dec._loops)}, expected one captured stream key of rope "
             f"length {STREAM_TWIN_LEN}")
    twin_dec.generate(prompt, STREAM_NEW)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = twin_dec.generate(prompt, STREAM_NEW)
    twin_s = time.perf_counter() - t0
    if got.shape != want.shape or got.min() < 0 or got.max() >= MISTRAL["vocab_size"]:
        fail(f"stream: shape {got.shape} or tokens outside the vocabulary")
    diff = np.nonzero(got[0] != want[0])[0]
    r = dict(stream_tok_s=STREAM_NEW / stream_s, twin_tok_s=STREAM_NEW / twin_s,
             equal=not diff.size,
             first_difference=int(diff[0]) - STREAM_PROMPT if diff.size else None)
    if diff.size:  # a split is legitimate only at a near-tie: the twin fed the stream's tokens
        r["steps"], r["near_ties"], r["parted_at_near_ties"] = stream_twin_check(
            torch, twin_dec, prompt, got)
    print(f"  stream {r['stream_tok_s']:.1f} tok/s (the twin without a ring "
          f"{r['twin_tok_s']:.1f}); the ring wraps at step "
          f"{LLAMA_STREAM['max_len'] - STREAM_PROMPT}; "
          + (f"tokens equal to the twin's over all {STREAM_NEW}" if r["equal"] else
             f"tokens leave the twin's at step {r['first_difference']}; fed the stream's tokens "
             f"the twin picks each of them but {r['parted_at_near_ties']} near-ties "
             f"({r['near_ties']} steps with top-2 logits closer than {NEAR_TIE})"))
    report["llama_stream"] = r
    del dec, twin_dec, lm, twin
    free_card(torch)
    return counts


def family_step_flops(cfg, L, moe):
    """FLOPs of one B 1 x L training step and the Linear weights it
    multiplies (attention, the MLP or every expert, computed densely, and
    the head): 6 x weights x L, plus 3 x 4 x pairs x D a layer for the
    attention products over the (query, key) pairs the causal mask (and
    window) keeps."""
    D, Hd = cfg["dim"], int(cfg["dim"] * cfg["mlp_ratio"])
    kv = cfg["num_kv_heads"] * D // cfg["num_heads"]
    ffn = 3 * D * Hd * (cfg["n_experts"] if moe else 1)
    weights = cfg["depth"] * (2 * D * D + 2 * D * kv + ffn) + D * cfg["vocab_size"]
    attn = 3 * cfg["depth"] * 4 * banded_pairs(L, cfg.get("window")) * D
    return 6.0 * weights * L + attn, weights


def top_others(others):
    """The TOP_OTHERS largest of {kernel or op name: ms}, names cut to 100
    characters."""
    top = sorted(others.items(), key=lambda kv: -kv[1])[:TOP_OTHERS]
    return {k[:100]: v for k, v in top}


def train_pieces_ms(torch, lm, cfg, moe):
    """Device ms a training step spends on the family's elementwise pieces,
    each timed alone, forward and backward, at the step's bf16 shapes and
    times its calls a step: the K/V repeat to every head (2 a layer), RoPE
    (q and k a layer), RMSNorm (2 a layer and the final one), SwiGLU's
    silu(g)·u (a layer, every expert's under MoE) and the cross-entropy on
    full logits."""
    from deepflows_tpu_torch import nn

    dev, bf = torch.device("cuda"), torch.bfloat16
    L, D, V = cfg["max_len"], cfg["dim"], cfg["vocab_size"]
    H, Hkv, depth = cfg["num_heads"], cfg["num_kv_heads"], cfg["depth"]
    Dh, Hd = D // H, int(D * cfg["mlp_ratio"])
    attn = lm.blocks[0].attn
    norm = nn.RMSNorm(D, device=dev).bfloat16()
    ce = nn.CrossEntropyLoss()

    def fwd_bwd(f, *shapes):
        xs = [torch.randn(sh, device=dev, dtype=bf).requires_grad_() for sh in shapes]
        out = f(*xs)
        g = torch.randn_like(out) if out.dim() else None
        return event_ms(lambda: torch.autograd.grad(f(*xs), xs, g), 3)

    y = torch.randint(0, V, (1, L), device=dev)
    E = cfg["n_experts"] if moe else 1
    pieces = {
        "kv_repeat": 2 * depth * fwd_bwd(
            lambda k: k.reshape(1, Hkv, 1, L, Dh).expand(1, Hkv, H // Hkv, L, Dh)
            .reshape(1, H, L, Dh), (1, Hkv, L, Dh)),
        "rope": depth * (fwd_bwd(lambda q: attn._apply_rope(q, L), (1, H, L, Dh))
                         + fwd_bwd(lambda k: attn._apply_rope(k, L), (1, Hkv, L, Dh))),
        "rmsnorm": (2 * depth + 1) * fwd_bwd(norm, (1, L, D)),
        "swiglu": depth * fwd_bwd(lambda g, u: nn.functional.silu(g) * u, (E, L, Hd), (E, L, Hd)),
        "cross_entropy": fwd_bwd(lambda z: ce(z, y), (1, L, V)),
    }
    return pieces


def step_copies_ms(torch, step, x, y):
    """Device ms a step spends on the copies the bf16 recipe makes around
    the model, each timed alone: the bf16 copies of the f32 masters
    (``_compute_copies``), the bf16 gradients widened to f32, and the
    strided ones among them made contiguous for fused Adam (with how many
    gradients, and elements, arrive strided)."""
    opt = step.optimizer
    seen = []
    update = opt.pure_update

    def spy(params, grads, state, lr):
        seen.extend(g for g in grads if g is not None)
        return update(params, grads, state, lr)

    opt.pure_update = spy
    try:
        step(x, y)
    finally:
        opt.pure_update = update
    strided = [g for g in seen if not g.is_contiguous()]
    low = [g.to(torch.bfloat16) for g in seen]
    out = dict(masters_to_bf16=event_ms(step._compute_copies, 3),
               grads_to_f32=event_ms(lambda: [g.float() for g in low], 3),
               strided_grads_made_contiguous=event_ms(lambda: [g.contiguous() for g in strided], 3),
               strided_grads=len(strided), strided_grad_elements=sum(g.numel() for g in strided))
    del seen, strided, low
    return out


def family_train_phase(torch, dt, report, kind):
    """A main path: train the Llama (depth 2, B 1 x L 8192, window 4096) or
    Mixtral (depth 1, B 1 x L 2048, MoECriterion) model with bf16 compute
    over f32 masters, flash=True and Adam(lr 3e-4, fused=True), on full
    logits with CrossEntropyLoss as the JAX package trains the family.
    Returns the launch counts of the run."""
    import numpy as np

    from deepflows_tpu_torch import nn, ops, optim
    from deepflows_tpu_torch.jit import CompiledTrainStep
    from deepflows_tpu_torch.models import LlamaLM, MixtralLM

    cls, cfg = {"llama": (LlamaLM, LLAMA_TRAIN), "mixtral": (MixtralLM, MIXTRAL_TRAIN)}[kind]
    L, steps, depth = cfg["max_len"], FAMILY_STEPS[kind], cfg["depth"]
    lm = family_model(torch, dt, cls, cfg, 3, serve=False)
    opt = optim.Adam(lm.parameters(), **FAMILY_ADAM, fused=True)
    crit = nn.CrossEntropyLoss()
    if kind == "mixtral":
        crit = nn.MoECriterion(crit, lm)
    step = CompiledTrainStep(lm, opt, crit, compute_dtype=torch.bfloat16)
    n_params = sum(p.numel() for p in lm.parameters())
    print(f"model: {cls.__name__} {cfg}, {n_params} parameters in f32; B 1, L {L}, bf16 "
          f"compute, fused Adam, flash, {type(crit).__name__}")
    rng = np.random.default_rng(3)
    V = cfg["vocab_size"]
    x = torch.as_tensor(rng.integers(0, V, (1, L)).astype(np.int32), device="cuda")
    y = torch.as_tensor(rng.integers(0, V, (1, L)).astype(np.int32), device="cuda")
    per_step = {"flash_attention_fwd": depth, "flash_attention_bwd": depth, "fused_adam": 1}
    routed = (ops.flash_attention_fwd, ops.flash_attention_bwd)
    routes_before = [dict(f.routes) for f in routed]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()  # the main path starts here
    losses, wall_ms, _ = run_steps(torch, step, x, y, steps, f"{kind} training", per_step)
    counts = {k.__name__: k.launches for k in ops.KERNELS}  # the main path ends here
    print(f"main-path launches ({kind} training): {counts}")
    for f, before in zip(routed, routes_before):
        by_route = {n: f.routes[n] - before[n] for n in f.routes}
        if by_route["wgmma"] != counts[f.__name__]:
            fail(f"{kind} training: {f.__name__} launched by route {by_route}, not all on wgmma")
    print(f"  losses: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"the {kind} training loss did not fall on the repeated batch: {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    flops, weights = family_step_flops(cfg, L, kind == "mixtral")
    wall = statistics.median(wall_ms[1:])
    device_ms = event_ms(lambda: step(x, y), 2)
    r = dict(losses=losses, step_wall_ms=wall, step_device_ms=device_ms,
             device_busy_share=device_ms / wall, tokens_per_s=L / wall * 1e3, step_flops=flops,
             mfu=flops / (wall * 1e-3 * PEAK_OPS["bf16"]),
             step_bound_ms=flops / PEAK_OPS["bf16"] * 1e3, linear_weights=weights,
             peak_memory_gb=peak_gb)
    if kind == "mixtral":  # the FLOPs of the top-2 experts alone (the step computes all 8)
        active, _ = family_step_flops(dict(cfg, n_experts=cfg["top_k"]), L, True)
        r["mfu_top2_flops"] = active / (wall * 1e-3 * PEAK_OPS["bf16"])
    others, aten = {}, {}
    r["profile_ms"] = prof = step_profile(torch, step, x, y, steps=1, others=others, ops=aten)
    r["other_kernels_ms"] = top_others(others)
    r["aten_ops_ms"] = top_others(aten)
    r["pieces_ms"] = train_pieces_ms(torch, lm, cfg, kind == "mixtral")
    r["pieces_ms"].update(step_copies_ms(torch, step, x, y))
    print(f"  step {wall:.3f} ms wall, {device_ms:.3f} ms device (busy "
          f"{100 * r['device_busy_share']:.1f}%); {r['tokens_per_s']:.1f} tokens/s; MFU "
          f"{100 * r['mfu']:.2f}% of {flops:.4g} FLOPs (6 x {weights} Linear weights x {L} "
          f"tokens + 3 x 4 x pairs x D a layer; bound {r['step_bound_ms']:.3f} ms)"
          + (f", {100 * r['mfu_top2_flops']:.2f}% counting the top-2 experts only"
             if kind == "mixtral" else "") + f"; peak memory {peak_gb:.2f} GB")
    print("  device time of a step by kernel (torch.profiler): " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(prof.items(), key=lambda kv: -kv[1])))
    print("  the largest other PyTorch kernels (ms a step): " + "; ".join(
        f"{v:.3f} {k}" for k, v in r["other_kernels_ms"].items()))
    print("  the aten ops whose own kernels take longest (ms a step): " + "; ".join(
        f"{v:.3f} {k}" for k, v in r["aten_ops_ms"].items()))
    print("  the step's elementwise pieces alone, forward and backward (ms a step): " + ", ".join(
        f"{k} {v:.3f}" for k, v in r["pieces_ms"].items()))
    report[f"{kind}_train"] = r
    del step, opt, lm, crit
    free_card(torch)
    return counts


def family_phases(torch, dt, ops, report, max_err, phase):
    """The Llama and Mixtral family's kernel checks and its five main paths,
    each with its launch counts; returns {path: counts} and the kernel
    phase's numbers."""
    phase("family kernel phase (kernels vs plain twins at Mistral and Mixtral shapes):")
    fk = family_kernel_phase(torch, ops, report, max_err)
    paths = {}
    phase("Llama serving (main path):")
    paths["llama_serve"] = family_serve_phase(torch, dt, report, "llama")
    phase("Llama streaming past max_len (main path):")
    paths["llama_stream"] = llama_stream_phase(torch, dt, report)
    phase("Llama training (main path):")
    paths["llama_train"] = family_train_phase(torch, dt, report, "llama")
    phase("Mixtral serving (main path):")
    paths["mixtral_serve"] = family_serve_phase(torch, dt, report, "mixtral")
    phase("Mixtral training (main path):")
    paths["mixtral_train"] = family_train_phase(torch, dt, report, "mixtral")
    return paths, fk


# ------------------------------------------------------------ the CNN family
# bench.py's ResNet-50 row (bench.py:102-103, the batch of :218-229): 10
# classes, 224 x 224, B 128, bf16 compute over f32 masters, Adam(lr 5e-3,
# weight decay 5e-4), here fused.  Convolution, batch norm and pooling run
# on cuDNN and PyTorch's own kernels by design (the JAX package leaves them
# to XLA); the port's kernel on these paths is fused_adam, and linear_fused
# on the eager CIFAR10_CNN path.
CNN_B, CNN_IMAGE, CNN_CLASSES = 128, 224, 10
CNN_WARMUP, CNN_TIMED = 2, 5
# The paths beside ResNet-50 train at an lr where their loss falls on the
# repeated batch (tools/cnn_lr_sweep.py): at bench's 5e-3 the NF-ResNet-50,
# VGG16-BN and ViT_Tiny losses blow up, and VGG16-BN's rises up to 1e-4
CNN_LR = 1e-4
CNN_FAMILY = (  # (name, constructor, keyword arguments, batch, image, lr): bench.py's shapes
    ("mobilenet_v1", "MobileNetV1", dict(num_classes=10), 64, 224, CNN_LR),
    ("mobilenet_v2", "MobileNetV2", dict(num_classes=10), 64, 224, CNN_LR),
    ("vgg16_bn", "VGG16", dict(num_classes=10, batch_norm=True), 32, 224, 1e-5),
    ("vit_tiny", "ViT_Tiny", dict(image_size=32, patch_size=4, num_classes=10), 256, 32, CNN_LR),
)
CIFAR_B, CIFAR_STEPS, CIFAR_FC_IN = 256, 30, 128 * 4 * 4
CNN_PER_STEP = {"fused_adam": 1}
CNN_CPU_TOL = 1e-3


def cnn_batch(B, image):
    """bench.py's batch: normal images, integer labels below 10, from
    numpy's default_rng(0), on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    x = rng.standard_normal((B, 3, image, image)).astype(np.float32)
    y = rng.integers(0, 10, B).astype(np.int32)
    return torch.as_tensor(x, device="cuda"), torch.as_tensor(y, device="cuda")


def cnn_step_flops(torch, model, image, B):
    """Analytic FLOPs of a training step: 2 x the MACs of every conv and
    Linear, read from their output shapes in a forward of one image, x 3
    (forward and backward) x B."""
    from deepflows_tpu_torch import nn

    macs = []

    def hook(mod, inp, out):
        fan_in = mod.weight[0].numel() if isinstance(mod, nn.Conv2d) else mod.in_features
        macs.append(out.numel() * fan_in)

    hooks = [m.register_forward_hook(hook) for m in model.modules()
             if isinstance(m, (nn.Conv2d, nn.Linear))]
    was = model.training
    model.eval()
    try:
        with torch.no_grad():
            model(torch.zeros(1, 3, image, image, device=next(model.parameters()).device))
    finally:
        for h in hooks:
            h.remove()
        model.train(was)
    return 2 * sum(macs) * 3 * B


def cnn_group(op):
    """A CNN step's group of the kernels that the aten op ``op`` launched."""
    if "convolution_backward" in op:
        return "convolution backward"
    if "convolution" in op:
        return "convolution forward"
    if "batch_norm" in op:
        return "batch norm backward" if "backward" in op else "batch norm forward"
    if "pool" in op:
        return "pooling"
    if op in ("aten::mm", "aten::addmm", "aten::bmm", "aten::matmul"):
        return "matrix products (cuBLAS)"
    return "other elementwise"


def cnn_adam_check(torch, model, label):
    """adam_list_check over ``model``'s parameter shapes."""
    return adam_list_check(torch, [tuple(p.shape) for p in model.parameters()], label)


def adam_list_check(torch, shapes, label):
    """fused_adam against its plain twin over a parameter list of
    ``shapes`` (adam_case's random values), then its time beside its
    bound, its plain twin's and torch.optim.Adam(fused=True)'s.  The
    library updates the checked tensors themselves, once they are checked
    (no copies: a list of a billion elements fits the card once)."""
    from deepflows_tpu_torch import ops

    g = torch.Generator(device="cuda").manual_seed(6)
    (ps, gs, vs, ss, hyper), err = adam_case(torch, ops, g, shapes, ADAM["weight_decay"], label)
    lib_params = [torch.nn.Parameter(p) for p in ps]
    for p, gg in zip(lib_params, gs):
        p.grad = gg
    lib = torch.optim.Adam(lib_params, **ADAM, fused=True)
    n = sum(p.numel() for p in ps)
    r = dict(tensors=len(shapes), elements=n, max_abs_err=err,
             ms=event_ms(lambda: ops.fused_adam(ps, gs, vs, ss, hyper), 3),
             plain_ms=event_ms(lambda: ops.fused_adam_plain(ps, gs, vs, ss, hyper), 3),
             library_ms=event_ms(lib.step, 3))
    r["bound_ms"], r["bound_by"] = bound_ms(28 * n + 28, 0, "bf16")
    print(f"  fused_adam over {label}'s {len(shapes)} parameter tensors ({n} elements) agrees "
          f"with its plain twin (max abs err {err:.3g}); {r['ms']:.4f} ms, bound "
          f"{r['bound_ms']:.4f} ({r['bound_by']}), plain {r['plain_ms']:.4f}, library "
          f"{r['library_ms']:.4f}")
    return r


def cifar_fc_check(torch):
    """linear_fused against its plain twin at CIFAR10_CNN's fc, (B, 2048) @
    (2048, 10) + b, in every activation at rtol 1e-4 / atol 1e-3 (the JAX
    tests' bound), then its time beside its bound, its plain twin's and
    torch.addmm's, L2 flushed between timed launches."""
    from deepflows_tpu_torch import ops

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    m, k, n = CIFAR_B, CIFAR_FC_IN, CNN_CLASSES
    x, w, bias = (torch.randn(s, generator=g, device=dev) for s in ((m, k), (k, n), (1, n)))
    err = max(mm_check(ops.linear_fused(x, w, bias, act), ops.linear_fused_plain(x, w, bias, act),
                       f"linear_fused CIFAR10_CNN fc {(m, k, n)} {act}")
              for act in ops.linear.ACTIVATIONS)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    r = dict(max_abs_err=err, at=f"CIFAR10_CNN fc: ({m}, {k}) @ ({k}, {n}) f32",
             plan=list(ops.linear._linear_plan(m, n, k)),
             ms=event_ms(lambda: ops.linear_fused(x, w, bias), 20, flush_buf.zero_),
             plain_ms=event_ms(lambda: ops.linear_fused_plain(x, w, bias), 20, flush_buf.zero_),
             library_ms=event_ms(lambda: torch.addmm(bias, x, w), 20, flush_buf.zero_))
    r["bound_ms"], r["bound_by"] = bound_ms(4 * (m * k + k * n + n + m * n), 2 * m * k * n, "f32")
    print(f"  linear_fused at {r['at']} agrees with its plain twin in every activation (max abs "
          f"err {err:.3g}); {r['ms']:.4f} ms, bound {r['bound_ms']:.4f} ({r['bound_by']}), plain "
          f"{r['plain_ms']:.4f}, library {r['library_ms']:.4f}")
    return r


def cnn_model(dt, cls, seed=0, **kw):
    from deepflows_tpu_torch import models

    dt.manual_seed(seed)
    return getattr(models, cls)(device="cuda", **kw)


def cnn_step(torch, model, adam=ADAM):
    from deepflows_tpu_torch import nn, optim
    from deepflows_tpu_torch.jit import CompiledTrainStep

    opt = optim.Adam(model.parameters(), **adam, fused=True)
    return CompiledTrainStep(model, opt, nn.CrossEntropyLoss(), compute_dtype=torch.bfloat16)


def bn_buffers(model):
    return {n: b for n, b in model.named_buffers() if "running" in n}


def resnet50_train_phase(torch, dt, report, card):
    """A main path: ResNet-50 trained at bench.py's row, after fused_adam
    is checked over its parameters (those of the remat path too); returns
    the launch counts, the fused_adam check, the trained model and the
    batch."""
    from deepflows_tpu_torch import ops

    model = cnn_model(dt, "ResNet50", num_classes=CNN_CLASSES)
    adam = cnn_adam_check(torch, model, "ResNet-50")
    step = cnn_step(torch, model)
    x, y = cnn_batch(CNN_B, CNN_IMAGE)
    start = {n: b.clone() for n, b in bn_buffers(model).items()}
    params = list(model.parameters())
    print(f"model: ResNet50(num_classes {CNN_CLASSES}), {sum(p.numel() for p in params)} "
          f"parameters in {len(params)} f32 tensors, {len(start)} BN buffers; B {CNN_B}, "
          f"{CNN_IMAGE} x {CNN_IMAGE}, bf16 compute, Adam(lr 5e-3, wd 5e-4, fused)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()  # the main path starts here
    losses, wall, events = run_steps(torch, step, x, y, CNN_WARMUP + CNN_TIMED, "resnet50",
                                     CNN_PER_STEP)
    counts = {k.__name__: k.launches for k in ops.KERNELS}  # and ends here
    print(f"main-path launches (resnet50 training): {counts}")
    print(f"  losses: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"the ResNet-50 loss did not fall on the repeated batch: {losses}")
    for n, b in bn_buffers(model).items():
        if b.dtype != torch.float32 or not torch.isfinite(b).all():
            fail(f"ResNet-50 buffer {n} is {b.dtype} or not finite")
        if torch.equal(b, start[n]):
            fail(f"ResNet-50 buffer {n} did not change")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    wall_ms = statistics.median(wall[CNN_WARMUP:])
    device_ms = event_ms(lambda: step(x, y), 3)
    flops = cnn_step_flops(torch, model, CNN_IMAGE, CNN_B)
    r = dict(losses=losses, step_wall_ms=wall_ms, step_event_ms=statistics.median(events[CNN_WARMUP:]),
             step_device_ms=device_ms, images_per_s=CNN_B / wall_ms * 1e3,
             device_busy_share=device_ms / wall_ms, step_flops=flops,
             mfu=flops / (wall_ms * 1e-3 * PEAK_OPS["bf16"]),
             step_bound_ms=flops / PEAK_OPS["bf16"] * 1e3, peak_memory_gb=peak_gb)
    others = {}
    r["profile_ms"] = step_profile(torch, step, x, y, others=others, group=cnn_group)
    r["other_ops_ms"] = top_others(others)
    print(f"  step {wall_ms:.3f} ms wall, {r['step_event_ms']:.3f} ms between CUDA events, "
          f"{device_ms:.3f} ms device (busy {100 * r['device_busy_share']:.1f}%); "
          f"{r['images_per_s']:.1f} images/s; MFU {100 * r['mfu']:.2f}% of {flops:.4g} FLOPs "
          f"(2 x conv and fc MACs x 3 x B; bound {r['step_bound_ms']:.3f} ms at 989 TFLOP/s); "
          f"peak memory {peak_gb:.2f} GB; {card}")
    print("  device time of a step by group (torch.profiler, 2 steps): "
          f"{sum(r['profile_ms'].values()):.3f} ms: " + ", ".join(
              f"{k} {v:.3f}" for k, v in sorted(r["profile_ms"].items(), key=lambda kv: -kv[1])))
    print("  the aten ops of the other elementwise group that take longest (ms a step): "
          + "; ".join(f"{v:.3f} {k}" for k, v in r["other_ops_ms"].items()))
    report["resnet50_train"] = r
    del step
    return counts, adam, model, x


def resnet50_eval_phase(torch, dt, report, model, x, card):
    """CompiledEvalStep on the trained ResNet-50, f32 (TF32 off) and cast
    to bf16; BN reads its running statistics, so each image's logits do not
    depend on the rest of the batch."""
    from deepflows_tpu_torch.jit import CompiledEvalStep

    out = {}
    for dtype in ("f32", "bf16"):
        if dtype == "bf16":
            model.bfloat16()
        ev = CompiledEvalStep(model)
        xi = x if dtype == "f32" else x.bfloat16()
        logits = ev(xi)
        if tuple(logits.shape) != (CNN_B, CNN_CLASSES) or not torch.isfinite(logits).all():
            fail(f"ResNet-50 {dtype} eval logits: shape {tuple(logits.shape)} or not finite")
        half = ev(xi[: CNN_B // 2])
        scale = logits.float().abs().max().item()
        diff = (half.float() - logits[: CNN_B // 2].float()).abs().max().item()
        tol = 1e-3 if dtype == "f32" else 2e-2
        if not diff <= tol * scale:
            fail(f"ResNet-50 {dtype} eval: the first half's logits move by {diff} with the "
                 f"rest of the batch (limit {tol} x {scale}): BN did not read running stats")
        if not model.training:
            fail("CompiledEvalStep left the model in eval mode")
        ms = event_ms(lambda: ev(xi), 5)
        out[dtype] = dict(ms=ms, images_per_s=CNN_B / ms * 1e3, half_batch_max_diff=diff)
        print(f"  eval {dtype}: {ms:.3f} ms device a B {CNN_B} call, "
              f"{out[dtype]['images_per_s']:.1f} images/s; half batch against whole "
              f"max |diff| {diff:.3g} (limit {tol} x {scale:.3g}); {card}")
    report["resnet50_eval"] = out


def nf_resnet50_phase(torch, dt, report, card):
    """A main path: the NF-ResNet-50 (norm="free") at the same row but lr
    CNN_LR, 3 steps, its loss falling; returns the launch counts and the
    fused_adam check."""
    from deepflows_tpu_torch import ops

    model = cnn_model(dt, "ResNet50", num_classes=CNN_CLASSES, norm="free")
    if list(model.buffers()):
        fail("NF-ResNet-50 has buffers")
    adam = cnn_adam_check(torch, model, "NF-ResNet-50")
    step = cnn_step(torch, model, dict(ADAM, lr=CNN_LR))
    x, y = cnn_batch(CNN_B, CNN_IMAGE)
    ops.reset_launch_counts()  # the main path starts here
    losses, wall, _ = run_steps(torch, step, x, y, 3, "nf_resnet50", CNN_PER_STEP)
    counts = {k.__name__: k.launches for k in ops.KERNELS}  # and ends here
    print(f"main-path launches (nf_resnet50 training): {counts}; losses {losses}; step "
          f"{statistics.median(wall[1:]):.3f} ms wall; {card}")
    if not losses[-1] < losses[0]:
        fail(f"the NF-ResNet-50 loss did not fall on the repeated batch: {losses}")
    report["nf_resnet50_train"] = dict(losses=losses, step_wall_ms=statistics.median(wall[1:]),
                                       lr=CNN_LR)
    return counts, adam


def remat_phase(torch, dt, report, card):
    """A main path: ResNet-50 with remat=True, 2 steps from the weights and
    batch of a twin without remat; losses and the running statistics after
    step 1 agree within the bf16 bound (the EMA ran once); peak memory of
    each."""
    from deepflows_tpu_torch import ops

    x, y = cnn_batch(CNN_B, CNN_IMAGE)
    runs = {}
    counts = None
    for remat in (False, True):
        model = cnn_model(dt, "ResNet50", num_classes=CNN_CLASSES, remat=remat)
        if remat:
            model.load_state_dict(runs[False]["start"])
        start = {k: v.clone() for k, v in model.state_dict().items()}
        step = cnn_step(torch, model)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        if remat:
            ops.reset_launch_counts()  # the main path starts here
        losses, wall, _ = run_steps(torch, step, x, y, 1, f"resnet50 remat={remat}", CNN_PER_STEP)
        stats = {n: b.clone() for n, b in bn_buffers(model).items()}
        more, wall2, _ = run_steps(torch, step, x, y, 1, f"resnet50 remat={remat}", CNN_PER_STEP)
        if remat:
            counts = {k.__name__: k.launches for k in ops.KERNELS}  # and ends here
        runs[remat] = dict(start=start, losses=losses + more, stats=stats,
                           peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
                           step_wall_ms=wall2[0])
        del step, model
        free_card(torch)
    a, b = runs[False], runs[True]
    rel = max(abs(p - q) / max(abs(p), 1e-30) for p, q in zip(a["losses"], b["losses"]))
    worst = max(((a["stats"][n] - b["stats"][n]).norm() / a["stats"][n].norm()).item()
                for n in a["stats"])
    print(f"main-path launches (resnet50 remat training): {counts}; losses {b['losses']} "
          f"against {a['losses']} without remat (max rel diff {rel:.3g}, limit 2e-2); running "
          f"stats after step 1 worst rel diff by norm {worst:.3g} (limit 2e-2); peak memory "
          f"above the model {b['peak_gb']:.2f} GB with remat, {a['peak_gb']:.2f} GB without; "
          f"step {b['step_wall_ms']:.3f} ms wall against {a['step_wall_ms']:.3f}; {card}")
    if not rel < 2e-2:
        fail(f"ResNet-50 with remat: losses differ from the twin's by {rel}")
    if not worst < 2e-2:
        fail(f"ResNet-50 with remat: running stats after step 1 differ by {worst}")
    report["resnet50_remat"] = dict(losses=b["losses"], twin_losses=a["losses"], max_rel=rel,
                                    stats_rel=worst, peak_gb=b["peak_gb"], twin_peak_gb=a["peak_gb"],
                                    step_wall_ms=b["step_wall_ms"], twin_step_wall_ms=a["step_wall_ms"])
    return counts


def cnn_family_phase(torch, dt, report, card):
    """Main paths: MobileNetV1/V2, VGG16-BN and ViT_Tiny, 2 steps each at
    their lr of CNN_FAMILY, each loss falling, each after fused_adam is
    checked over its parameters; returns {path: launch counts} and {path:
    the check}."""
    from deepflows_tpu_torch import ops

    paths, adam, out = {}, {}, {}
    for name, cls, kw, B, image, lr in CNN_FAMILY:
        model = cnn_model(dt, cls, **kw)
        adam[name] = cnn_adam_check(torch, model, name)
        step = cnn_step(torch, model, dict(ADAM, lr=lr))
        x, y = cnn_batch(B, image)
        ops.reset_launch_counts()  # the main path starts here
        losses, wall, _ = run_steps(torch, step, x, y, 2, name, CNN_PER_STEP)
        paths[name] = {k.__name__: k.launches for k in ops.KERNELS}  # and ends here
        out[name] = dict(losses=losses, step_wall_ms=wall[1], batch=B, image=image, lr=lr)
        print(f"  {name} (B {B}, {image} x {image}, lr {lr}): losses {losses}, second step "
              f"{wall[1]:.3f} ms wall; launches {paths[name]}; {card}")
        if not losses[-1] < losses[0]:
            fail(f"the {name} loss did not fall on the repeated batch: {losses}")
        del step, model
        free_card(torch)
    report["cnn_family"] = out
    return paths, adam


def cifar_eager_phase(torch, dt, report, card):
    """A main path: CIFAR10_CNN trained eagerly under config.use_pallas, f32,
    B 256, dropout on, 30 steps: its fc (2048 -> 10) is one linear_fused a
    step (the backward's products are torch.matmul's), Adam one fused_adam.
    Both kernels are first checked at the path's shapes; returns the launch
    counts and {kernel: its check}."""
    from deepflows_tpu_torch import config, nn, ops, optim

    model = cnn_model(dt, "CIFAR10_CNN")
    checks = {"fused_adam": cnn_adam_check(torch, model, "CIFAR10_CNN"),
              "linear_fused": cifar_fc_check(torch)}
    opt = optim.Adam(model.parameters(), **ADAM, fused=True)
    crit = nn.CrossEntropyLoss()
    x, y = cnn_batch(CIFAR_B, 32)
    per_step = {"linear_fused": 1, "fused_adam": 1}

    def step(x, y):
        loss = crit(model(x), y)
        opt.zero_grad()
        loss.backward()
        opt.step()
        return loss.detach()

    saved = config.use_pallas
    config.use_pallas = True
    try:
        ops.reset_launch_counts()  # the main path starts here
        losses, wall, _ = run_steps(torch, step, x, y, CIFAR_STEPS, "cifar10_cnn eager",
                                    per_step)
        counts = {k.__name__: k.launches for k in ops.KERNELS}  # and ends here
    finally:
        config.use_pallas = saved
    if not losses[-1] < losses[0]:
        fail(f"the CIFAR10_CNN eager loss did not fall: {losses[0]} -> {losses[-1]}")
    ms = statistics.median(wall[3:])
    print(f"main-path launches (cifar10_cnn eager): {counts}; losses {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; {ms:.3f} ms a step of wall time; {card}")
    report["cifar10_cnn_eager"] = dict(losses=losses, step_wall_ms=ms)
    return counts, checks


def cnn_cpu_check(torch, dt, report):
    """ResNet-18 (small input, f32, B 4, 16 x 16), one SGD(lr 0.01, momentum
    0.9) step on the card and on a CPU copy: loss, weights and running
    statistics within 1e-3 (each tensor by its norm)."""
    import numpy as np

    from deepflows_tpu_torch import nn, optim
    from deepflows_tpu_torch.jit import CompiledTrainStep
    from deepflows_tpu_torch.models import ResNet18

    dt.manual_seed(4)
    models = {"cuda": ResNet18(num_classes=10, small_input=True, device="cuda")}
    models["cpu"] = ResNet18(num_classes=10, small_input=True, device="cpu")
    models["cpu"].load_state_dict(models["cuda"].state_dict())
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 3, 16, 16)).astype(np.float32)
    y = rng.integers(0, 10, 4).astype(np.int32)
    loss = {}
    for d, m in models.items():
        step = CompiledTrainStep(m, optim.SGD(m.parameters(), lr=0.01, momentum=0.9),
                                 nn.CrossEntropyLoss())
        loss[d] = float(step(x, y))
    rel = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
    card_sd = models["cuda"].state_dict()
    errs = {k: ((card_sd[k].cpu() - v).norm() / v.norm().clamp_min(1e-30)).item()
            for k, v in models["cpu"].state_dict().items()}
    worst = max(errs.items(), key=lambda kv: kv[1])
    print(f"  ResNet-18 f32 SGD step: card loss {loss['cuda']}, CPU {loss['cpu']} (rel diff "
          f"{rel:.3g}, limit {CNN_CPU_TOL}); worst tensor {worst[0]} {worst[1]:.3g} of its norm")
    if not rel < CNN_CPU_TOL:
        fail(f"ResNet-18: the card's loss differs from the CPU's by {rel}")
    if not worst[1] < CNN_CPU_TOL:
        fail(f"ResNet-18: {worst[0]} differs from the CPU's by {worst[1]} of its norm")
    report["cnn_vs_cpu"] = dict(loss=loss, rel=rel, worst=worst)


def cnn_phases(torch, dt, report, phase, card):
    """The CNN family's seven phases; returns {path: launch counts} and
    {kernel: {path: its check against its plain twin at the path's
    shapes}}."""
    paths, adam = {}, {}
    phase("ResNet-50 training (main path):")
    paths["resnet50_train"], adam["resnet50_train"], model, x = resnet50_train_phase(
        torch, dt, report, card)
    phase("ResNet-50 evaluation fused by fuse_conv_bn, its planted faults, GroupNorm:")
    resnet50_fusion_phase(torch, dt, report, model, x, card)
    fusion_planted_faults(torch, dt)
    group_norm_check(torch, report)
    phase("ResNet-50 evaluation:")
    resnet50_eval_phase(torch, dt, report, model, x, card)
    del model, x
    free_card(torch)
    phase("NF-ResNet-50 training (main path):")
    paths["nf_resnet50_train"], adam["nf_resnet50_train"] = nf_resnet50_phase(
        torch, dt, report, card)
    free_card(torch)
    phase("ResNet-50 with remat (main path):")
    paths["resnet50_remat"] = remat_phase(torch, dt, report, card)
    phase("MobileNetV1/V2, VGG16-BN, ViT_Tiny training (main paths):")
    fam_paths, fam_adam = cnn_family_phase(torch, dt, report, card)
    paths.update(fam_paths)
    adam.update(fam_adam)
    phase("CIFAR10_CNN eager under use_pallas (main path):")
    paths["cifar10_cnn_eager"], cifar = cifar_eager_phase(torch, dt, report, card)
    adam["cifar10_cnn_eager"] = cifar["fused_adam"]
    phase("card against CPU (ResNet-18 f32 SGD step):")
    cnn_cpu_check(torch, dt, report)
    checks = {"fused_adam": adam, "linear_fused": {"cifar10_cnn_eager": cifar["linear_fused"]}}
    report["cnn_kernel_checks"] = checks
    return paths, checks


# ------------------------------------------------ fine-tuning and optimizers
# LoRA on LlamaLM at Mistral-7B's widths (examples/lora_finetune.py's target
# list), trained with AdamW, WarmupCosineLR, clipping and accum_steps, then
# merged and served; every optimizer of the port on the same family.
FT_CFG = dict(MISTRAL, depth=2, max_len=2048)
FT_LORA = dict(r=16, alpha=32.0, target=["q_proj", "v_proj", "out_proj"])
FT_ADAPTER_ELEMENTS = 688_128  # 2 layers x (q 4096·16 + 16·4096, v 4096·16 + 16·1024, o as q)
FT_B, FT_ACCUM, FT_STEPS, FT_TWIN_STEPS = 4, 4, 6, 2
FT_ADAMW = dict(lr=2e-4, weight_decay=0.0)
FT_SCHEDULE = dict(warmup_epochs=2, T_max=6)
FT_CLIP = 1.0
FT_REQUEST = (8, 64, 128, {})  # the family's serving request
FT_QUANTS = (None, "int8")
OPT_CFG = dict(MISTRAL, depth=1, max_len=2048)
OPT_STEPS = 4
# (name, class, keyword arguments): the lr of the JAX examples
# (examples/llama_text_train.py:55-60, transformer_lm_train.py:43) where
# the loss falls at every step of tools/optim_lr_sweep.py on this path
# (Muon 0.02, Adafactor 0.02, Adadelta's default 1.0), else the sweep's
# largest lr where it does (PERF.md section 6): AdamW and Adam 3e-4 (the
# examples' 3e-3 rises again after step 1), Lion 3e-4 (6.7e-4 rises after
# step 2), RMSprop 1e-5 and Adagrad 1e-3 (no example)
OPTIMIZERS = (
    ("adamw", "AdamW", dict(lr=3e-4, weight_decay=1e-2)),
    ("muon", "Muon", dict(lr=0.02, adamw_lr=3e-3)),
    ("adafactor", "Adafactor", dict(lr=0.02)),
    ("lion", "Lion", dict(lr=3e-4)),
    ("rmsprop", "RMSprop", dict(lr=1e-5)),
    ("adagrad", "Adagrad", dict(lr=1e-3)),
    ("adadelta", "Adadelta", dict(lr=1.0)),
    ("adam_fused", "Adam", dict(lr=3e-4, fused=True)),
)
EMA_DECAY = 0.999
OPT_CPU = dict(vocab_size=256, max_len=32, dim=64, depth=1, num_heads=4, num_kv_heads=2,
               mlp_ratio=3.5, rope_theta=1e4, window=4096)
GN_SHAPE, GN_GROUPS = (128, 256, 56, 56), 32  # a ResNet-50 stage-1 activation
GN_TOL = {"f32": 1e-5, "bf16": 0.05}  # tests/test_torch_batchnorm.py's bounds
RESNET50_BNS = 53


def ft_batch(torch, B, L, V, seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    seq = rng.integers(0, V, (B, L + 1)).astype(np.int64)
    return (torch.as_tensor(seq[:, :L], device="cuda"),
            torch.as_tensor(seq[:, 1:], device="cuda"))


def ft_kernel_phase(torch, ops, report, max_err):
    """The kernels of the fine-tuning and optimizer paths against their
    plain twins at the shapes those paths give them: flash_attention at
    (1, 32, 2048, 128) with window 4096 (the band is the causal triangle at
    L 2048); int8_matmul and w8a8_matmul at Mistral's five matrices at the
    merged model's decode rows (M 8) and prefill rows (B 8 x max_len 2048),
    and the 9 calls of a depth-2 decode step timed; fused_adam over the
    optimizer path's parameter list, beside torch.optim.Adam(fused=True).
    Returns the numbers; ``max_err`` gains the int8 kernels' errors."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=dev)
    out = {"flash": family_flash_case(torch, ops, g, FT_CFG["max_len"], FT_CFG["window"],
                                      "LoRA fine-tuning and optimizers", flush_buf.zero_)}
    free_card(torch)
    for M in (8, FT_REQUEST[0] * FT_CFG["max_len"]):
        for name, (K, N) in MISTRAL_SHAPES.items():
            x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
            wq, s = ops.quantize_int8(torch.randn((K, N), generator=g, device=dev) * 0.02)
            compare(torch, ops, x, wq, s, f"merged Mistral M={M} {name}", max_err)
            del x, wq, s
        free_card(torch)
    print(f"  int8_matmul and w8a8_matmul agree with their plain twins at Mistral's "
          f"{len(MISTRAL_SHAPES)} matrices, M 8 and {FT_REQUEST[0] * FT_CFG['max_len']}")
    layer = ("qkv", "o", "gate_up", "down")
    ms, bi, _, wbytes = forward_timing(torch, ops, 8, MISTRAL_SHAPES, FT_CFG["depth"], layer)
    out["decode_step"] = dict(ms, int8_bound_ms=bi[0], int8_bound_by=bi[1], weight_bytes=wbytes)
    print(f"  a merged depth-2 decode step's {4 * FT_CFG['depth'] + 1} calls (M=8, bf16 x): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
          + f"; bound int8 {bi[0]:.4f} ms ({bi[1]})")
    free_card(torch)
    out["fused_adam"] = adam_list_check(torch, family_param_shapes(OPT_CFG, False),
                                        "the optimizer path's LlamaLM")
    free_card(torch)
    report["finetune_kernels"] = out
    return out


def counted(ops, fn):
    """Runs ``fn`` with the launch counts zeroed just before and read just
    after: a main path.  Returns (fn's result, the counts)."""
    ops.reset_launch_counts()
    result = fn()
    return result, {k.__name__: k.launches for k in ops.KERNELS}


def timed_steps(torch, step, x, y, steps, label, per_step, after=None):
    """run_steps one step at a time, ``after(i)`` between steps (a
    scheduler's step); returns the losses, wall ms and the lr each step
    read."""
    losses, wall, lrs = [], [], []
    for i in range(steps):
        lrs.append(step.optimizer.lr)
        loss, ms, _ = run_steps(torch, step, x, y, 1, label, per_step)
        losses += loss
        wall += ms
        if after is not None:
            after(i)
    return losses, wall, lrs


def step_grads(step, x, y):
    """The gradients one call of ``step`` hands its optimizer (after its
    grad_transform); the call is a real step."""
    opt, seen = step.optimizer, {}
    update = opt.pure_update

    def spy(params, grads, state, lr):
        seen["grads"] = grads
        return update(params, grads, state, lr)

    opt.pure_update = spy
    try:
        step(x, y)
    finally:
        opt.pure_update = update
    return seen["grads"]


def lora_model(torch, dt, seed):
    from deepflows_tpu_torch import nn
    from deepflows_tpu_torch.models import LlamaLM

    lm = family_model(torch, dt, LlamaLM, FT_CFG, seed, serve=False)
    adapters = nn.apply_lora(lm, **FT_LORA)
    return lm, adapters


class F32CrossEntropy:
    """nn.CrossEntropyLoss on the logits widened to f32: a bf16 loss near
    ln 32000 moves in steps of 0.0625, past the few thousandths that
    LoRA's first steps at lr 2e-4 take off it."""

    reduction = "mean"

    def __init__(self):
        from deepflows_tpu_torch import nn

        self.ce = nn.CrossEntropyLoss()

    def __call__(self, logits, y):
        return self.ce(logits.float(), y)


def lora_step(torch, lm, opt, accum=FT_ACCUM, compute_dtype=None):
    from deepflows_tpu_torch import optim
    from deepflows_tpu_torch.jit import CompiledTrainStep

    return CompiledTrainStep(lm, opt, F32CrossEntropy(),
                             compute_dtype=compute_dtype or torch.bfloat16,
                             grad_transform=optim.clip_by_global_norm(FT_CLIP),
                             accum_steps=accum)


def accum_check(torch, lm, adapters, opt, x, y):
    """One step with accum_steps=4 against one with accum_steps=1 from the
    same trained adapters and AdamW state, on the same batch, in f32 (TF32
    off): each adapter's change within PARAM_TOL of its norm."""
    from deepflows_tpu_torch import optim

    start = [p.detach().clone() for p in adapters]
    state = {k: [t.clone() for t in v] if isinstance(v, list) else v.clone()
             for k, v in opt._state.items()}
    moved = {}
    for accum in (FT_ACCUM, 1):
        twin = optim.AdamW(adapters, lr=FT_ADAMW["lr"], weight_decay=0.0)
        twin._state = {k: [t.clone() for t in v] if isinstance(v, list) else v.clone()
                       for k, v in state.items()}
        lora_step(torch, lm, twin, accum, torch.float32)(x, y)
        moved[accum] = [(p.detach() - s0).clone() for p, s0 in zip(adapters, start)]
        with torch.no_grad():
            for p, s0 in zip(adapters, start):
                p.copy_(s0)
        del twin
    worst = max(((a - b).norm() / b.norm().clamp_min(1e-30)).item()
                for a, b in zip(moved[FT_ACCUM], moved[1]))
    print(f"  one f32 step with accum_steps={FT_ACCUM} against accum_steps=1 from the trained "
          f"state: worst adapter change differs by {worst:.3g} of its norm (limit {PARAM_TOL})")
    if not worst < PARAM_TOL:
        fail(f"LoRA: accum_steps={FT_ACCUM} moves the adapters {worst} of their change away "
             "from accum_steps=1")
    return worst


def clip_check(torch, step, x, y):
    """The clip's pre-clip norm over one step's gradients, and the
    transform run alone on them with the card's sync debug mode at "error"
    (a host readback would raise)."""
    from deepflows_tpu_torch import optim
    from deepflows_tpu_torch.optim.clip import _global_norm

    transform, step.grad_transform = step.grad_transform, None
    try:
        grads = step_grads(step, x, y)  # a real step, its gradients unclipped
    finally:
        step.grad_transform = transform
    norm = float(_global_norm(grads))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        clipped = optim.clip_by_global_norm(FT_CLIP)(grads)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = float(_global_norm(clipped))
    print(f"  clip_by_global_norm({FT_CLIP}): pre-clip norm {norm:.5g}, after {after:.5g}; "
          "the transform ran with no host readback (sync debug mode 'error')")
    if not after <= FT_CLIP * (1 + 1e-3):
        fail(f"clip_by_global_norm left a norm of {after}")
    return norm


def lora_finetune_phase(torch, dt, report, card):
    """A main path: LoRA on LlamaLM at Mistral-7B widths (depth 2, f32
    masters, flash, bf16 compute), AdamW over the adapters with
    WarmupCosineLR stepped every step, clip_by_global_norm and
    accum_steps=4 on a repeated B 4 x L 2048 batch, 6 steps; then, outside
    the count, the checks (the frozen base bitwise unchanged, the lr
    sequence, the clip, accum 4 against 1, the adapter checkpoint into a
    fresh model) and a decoder on the unmerged model, which must raise; and
    a second main path: the merged model served dense and int8, graphed.
    Returns {path: launch counts} and the numbers."""
    import numpy as np

    from deepflows_tpu_torch import nn, ops, optim
    from deepflows_tpu_torch.models import KVCacheDecoder

    L, V, depth = FT_CFG["max_len"], FT_CFG["vocab_size"], FT_CFG["depth"]
    lm, adapters = lora_model(torch, dt, 5)
    n_adapt = sum(p.numel() for p in adapters)
    n_total = sum(p.numel() for p in lm.parameters())
    if n_adapt != FT_ADAPTER_ELEMENTS:
        fail(f"LoRA: {n_adapt} adapter elements, expected {FT_ADAPTER_ELEMENTS}")
    frozen = {n: p.detach().clone() for n, p in lm.named_parameters() if not p.requires_grad}
    opt = optim.AdamW(adapters, **FT_ADAMW)
    sch = optim.WarmupCosineLR(opt, **FT_SCHEDULE)
    host = optim.WarmupCosineLR(types.SimpleNamespace(lr=FT_ADAMW["lr"]), **FT_SCHEDULE)
    step = lora_step(torch, lm, opt)
    x, y = ft_batch(torch, FT_B, L, V, 5)
    print(f"model: LlamaLM {FT_CFG}, rms eps {RMS_EPS}, {n_total} parameters in f32; LoRA "
          f"{FT_LORA}: {len(adapters)} adapters, {n_adapt} elements trainable; B {FT_B} x L {L}, "
          f"accum_steps {FT_ACCUM}, AdamW {FT_ADAMW}, WarmupCosineLR {FT_SCHEDULE}, clip "
          f"{FT_CLIP}, bf16 compute")
    per_step = {"flash_attention_fwd": depth * FT_ACCUM, "flash_attention_bwd": depth * FT_ACCUM}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (losses, wall, lrs), counts = counted(ops, lambda: timed_steps(
        torch, step, x, y, FT_STEPS, "LoRA fine-tuning", per_step,
        after=lambda i: sch.step()))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"main-path launches (LoRA fine-tuning): {counts}")
    want_lrs = [FT_ADAMW["lr"]]
    for _ in range(FT_STEPS - 1):
        host.step()
        want_lrs.append(host.optimizer.lr)
    print(f"  losses: {losses}; lr each step: {lrs}")
    if lrs != want_lrs:
        fail(f"LoRA: the lr sequence {lrs} is not the scheduler's on the host {want_lrs}")
    if not losses[-1] < losses[0]:
        fail(f"the LoRA loss did not fall on the repeated batch: {losses}")
    for n, p in lm.named_parameters():
        if n in frozen and not torch.equal(p, frozen[n]):
            fail(f"LoRA: the frozen {n} changed")
    del frozen
    wall_ms = statistics.median(wall[1:])
    r = dict(losses=losses, lrs=lrs, step_wall_ms=wall_ms, tokens_per_s=FT_B * L / wall_ms * 1e3,
             peak_memory_gb=peak_gb, adapter_elements=n_adapt, parameters=n_total)
    r["step_device_ms"] = event_ms(lambda: step(x, y), 2)
    others = {}
    r["profile_ms"] = step_profile(torch, step, x, y, steps=1, others=others)
    r["other_kernels_ms"] = top_others(others)
    r["clip_norm"] = clip_check(torch, step, x, y)
    r["accum_vs_1"] = accum_check(torch, lm, adapters, opt, x, y)
    print(f"  LoRA step {wall_ms:.3f} ms wall, {r['step_device_ms']:.3f} ms device, "
          f"{r['tokens_per_s']:.1f} tokens/s, peak memory {peak_gb:.2f} GB; the frozen base "
          f"bitwise unchanged; {card}")
    print("  device time of a LoRA step by kernel (torch.profiler): " + ", ".join(
        f"{k} {v:.3f}" for k, v in sorted(r["profile_ms"].items(), key=lambda kv: -kv[1]))
          + "; the largest other PyTorch kernels: " + "; ".join(
              f"{v:.3f} {k}" for k, v in r["other_kernels_ms"].items()))

    # the adapter checkpoint into a fresh LoRA model: the same logits, bit for bit
    sd = nn.lora_state_dict(lm)
    fresh, _ = lora_model(torch, dt, 5)
    nn.load_lora_state_dict(fresh, sd)
    with torch.no_grad():
        a, b = lm(x[:1, :256]), fresh(x[:1, :256])
    if not torch.equal(a, b):
        fail(f"LoRA: the reloaded adapters' logits differ by {(a - b).abs().max().item()}")
    print(f"  lora_state_dict: {len(sd)} tensors, "
          f"{sum(t.numel() * t.element_size() for t in sd.values())} bytes; reloaded into a "
          "fresh model, the logits equal bit for bit")
    del fresh, sd, a, b
    free_card(torch)

    try:  # planted fault: a decoder on the unmerged model
        KVCacheDecoder(lm, compute_dtype=torch.bfloat16)
        fail("a decoder accepted an unmerged LoRA model")
    except RuntimeError as e:
        if "merge_lora" not in str(e):
            raise
        print("  planted fault flagged: KVCacheDecoder on the unmerged LoRA model raises")

    b, p0, new, kw = FT_REQUEST
    rng = np.random.default_rng(5)
    prompt_np = rng.integers(0, V, (b, p0)).astype(np.int64)
    with torch.no_grad():  # the unmerged model's own forward, f32
        ref = lm(torch.as_tensor(prompt_np[:2], device="cuda"))[:, p0 - 1].float()
    nn.merge_lora(lm)
    decs = {q: KVCacheDecoder(lm, compute_dtype=torch.bfloat16, quant=q) for q in FT_QUANTS}
    prompt = torch.zeros((2, L), dtype=torch.long, device="cuda")
    prompt[:, :p0] = torch.as_tensor(prompt_np[:2])
    checks = {}
    with torch.inference_mode():
        for quant, dec in decs.items():
            got = dec._prefill(dec._prepared(), prompt, p0)[2]
            checks[str(quant)] = rel_err(got, ref)
            print(f"  merged prefill logits quant={str(quant):5s} against the unmerged forward: "
                  f"max rel err {checks[str(quant)]:.5f} (limit {LOGIT_TOL[quant]})")
            if not checks[str(quant)] < LOGIT_TOL[quant]:
                fail(f"merged quant={quant}: prefill logits off by {checks[str(quant)]}")
    r["merged_prefill_rel_err"] = checks
    served, scounts = serve_all(decs, (FT_REQUEST,), [prompt_np], 4 * depth + 1, V,
                                "merged LoRA ")
    print(f"main-path launches (merged LoRA serving): {scounts}")
    rates = {}
    for quant, dec in decs.items():
        m, lp, _ = loop_timing(torch, dec, prompt_np, new)
        rates[str(quant)] = dict(decode_tok_s=b * new / m["decode_s"],
                                 generate_tok_s=b * new / m["generate_s"],
                                 step_device_ms=m["step_device_ms"],
                                 prep_prefill_ms=m["prep_prefill_s"] * 1e3)
        q = rates[str(quant)]
        print(f"  merged quant={str(quant):5s}: decode {q['decode_tok_s']:.1f} tok/s, generate "
              f"{q['generate_tok_s']:.1f} tok/s, step device {q['step_device_ms']:.4f} ms, "
              f"prep+prefill {q['prep_prefill_ms']:.2f} ms (B {b}, {p0} + {new}, max_len {L}); "
              f"{card}")
        del lp
    r["merged_serve"] = rates
    report["lora_finetune"] = r
    del decs, step, opt, lm, adapters
    free_card(torch)
    r["full_finetune"] = full_finetune_twin(torch, dt, x, y, card)
    return {"lora_train": counts, "lora_serve": scounts}, r


def full_finetune_twin(torch, dt, x, y, card):
    """The LoRA path's model and batch trained in full: AdamW over every
    parameter, the same schedule, clip and accum_steps, 2 steps; step ms,
    tokens/s and peak memory beside LoRA's."""
    from deepflows_tpu_torch import optim
    from deepflows_tpu_torch.models import LlamaLM

    lm = family_model(torch, dt, LlamaLM, FT_CFG, 5, serve=False)
    opt = optim.AdamW(lm.parameters(), **FT_ADAMW)
    step = lora_step(torch, lm, opt)
    per_step = {"flash_attention_fwd": FT_CFG["depth"] * FT_ACCUM,
                "flash_attention_bwd": FT_CFG["depth"] * FT_ACCUM}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, wall, _ = run_steps(torch, step, x, y, FT_TWIN_STEPS, "full fine-tune", per_step)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    r = dict(losses=losses, step_wall_ms=wall[-1], peak_memory_gb=peak_gb,
             tokens_per_s=x.numel() / wall[-1] * 1e3)
    print(f"  full fine-tune twin (AdamW over all {sum(p.numel() for p in lm.parameters())} "
          f"parameters): losses {losses}, step {wall[-1]:.3f} ms wall, {r['tokens_per_s']:.1f} "
          f"tokens/s, peak memory {peak_gb:.2f} GB; {card}")
    del step, opt, lm
    free_card(torch)
    return r


def state_bytes(state):
    return sum(t.numel() * t.element_size() for v in state.values()
               for t in (v if isinstance(v, list) else [v]) if t is not None)


def ns_ms(torch, opt):
    """Device ms of Newton-Schulz over every Muon parameter's momentum
    (the step's NS work), and its f32 FLOPs."""
    from deepflows_tpu_torch.optim.muon import ns_orthogonalize

    mats, flops = [], 0
    for p, m, v in zip(opt.params, opt._state["m"], opt._state["v"]):
        if v is None:
            mat = m.reshape(p.shape[0], -1)
            mats.append(mat)
            a, c = sorted(mat.shape)  # NS works on the wide orientation: a x c
            flops += opt.ns_steps * (2 * a * a * c * 2 + 2 * a ** 3)
    ms = event_ms(lambda: [ns_orthogonalize(t, opt.ns_steps) for t in mats], 1)
    return ms, flops


def optimizer_phase(torch, dt, report, card):
    """Main paths: LlamaLM at Mistral-7B widths, depth 1, B 1 x L 2048,
    bf16 compute over f32 masters, 4 steps on a repeated batch under each
    optimizer of OPTIMIZERS from the same weights; ModelEMA beside the
    AdamW run.  Each loss must be finite and fall.  Returns {path: launch
    counts} and the numbers."""
    from deepflows_tpu_torch import nn, ops, optim
    from deepflows_tpu_torch.jit import CompiledTrainStep
    from deepflows_tpu_torch.models import LlamaLM

    L, V = OPT_CFG["max_len"], OPT_CFG["vocab_size"]
    lm = family_model(torch, dt, LlamaLM, OPT_CFG, 6, serve=False)
    start = {k: v.clone() for k, v in lm.state_dict().items()}
    x, y = ft_batch(torch, 1, L, V, 6)
    n = sum(p.numel() for p in lm.parameters())
    print(f"model: LlamaLM {OPT_CFG}, {n} parameters in f32; B 1 x L {L}, bf16 compute")
    paths, out = {}, {}
    for name, cls, kw in OPTIMIZERS:
        lm.load_state_dict(start)
        opt = getattr(optim, cls)(lm.parameters(), **kw)
        step = CompiledTrainStep(lm, opt, nn.CrossEntropyLoss(), compute_dtype=torch.bfloat16)
        ema = optim.ModelEMA(lm, decay=EMA_DECAY) if name == "adamw" else None
        update, update_ms = opt.pure_update, []

        def timed_update(*a, update=update, update_ms=update_ms):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            res = update(*a)
            e1.record()
            update_ms.append((e0, e1))
            return res

        opt.pure_update = timed_update
        per_step = {"flash_attention_fwd": 1, "flash_attention_bwd": 1,
                    "fused_adam": int(name == "adam_fused")}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        (losses, wall, _), paths[name] = counted(ops, lambda: timed_steps(
            torch, step, x, y, OPT_STEPS, name, per_step,
            after=(lambda i: ema.update()) if ema is not None else None))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        opt.pure_update = update
        r = dict(kw={k: v for k, v in kw.items()}, losses=losses,
                 step_wall_ms=statistics.median(wall[1:]),
                 update_ms=statistics.median(a.elapsed_time(b) for a, b in update_ms[1:]),
                 state_bytes=state_bytes(opt._state), peak_memory_gb=peak_gb)
        if cls == "Muon":
            r["ns_ms"], r["ns_flops"] = ns_ms(torch, opt)
        out[name] = r
        print(f"  {name} {kw}: losses {losses}; step {r['step_wall_ms']:.3f} ms wall, update "
              f"{r['update_ms']:.3f} ms (CUDA events around pure_update), state "
              f"{r['state_bytes']} bytes, peak memory {peak_gb:.2f} GB"
              + (f"; Newton-Schulz {r['ns_ms']:.3f} ms ({r['ns_flops']:.4g} f32 FLOPs, "
                 f"{r['ns_flops'] / r['ns_ms'] / 1e9:.1f} TFLOP/s)" if cls == "Muon" else "")
              + f"; launches {paths[name]}; {card}")
        if not losses[-1] < losses[0]:
            fail(f"the {name} loss did not fall on the repeated batch: {losses}")
        if ema is not None:
            ema_check(torch, lm, ema)
        del step, opt, ema
        free_card(torch)
    report["optimizers"] = out
    del lm, start
    free_card(torch)
    return paths, out


def ema_check(torch, lm, ema):
    """ModelEMA after the AdamW run: average_parameters() gives the shadow
    weights, and the live weights come back bit for bit on exit."""
    live = {n: p.detach().clone() for n, p in lm.named_parameters()}
    shadow = ema.state_dict()["shadow"]
    with ema.average_parameters():
        for n, p in lm.named_parameters():
            if not torch.equal(p, shadow[n].to(p.dtype)):
                fail(f"ModelEMA: average_parameters() does not give the shadow of {n}")
    for n, p in lm.named_parameters():
        if not torch.equal(p, live[n]):
            fail(f"ModelEMA: the live {n} did not come back bit for bit")
    moved = max(((live[n] - s).norm() / live[n].norm()).item() for n, s in shadow.items())
    print(f"  ModelEMA(decay {EMA_DECAY}) beside AdamW: {ema.num_updates} updates, shadow up to "
          f"{moved:.3g} of a weight's norm from the live one; average_parameters() gives the "
          "shadow, the live weights back bit for bit")


def optimizer_cpu_check(torch, dt, report):
    """One f32 step of each optimizer on a depth-1, dim-64 LlamaLM on the
    card and on a CPU copy: every tensor's change within PARAM_TOL of its
    norm."""
    import numpy as np

    from deepflows_tpu_torch import nn, optim
    from deepflows_tpu_torch.jit import CompiledTrainStep
    from deepflows_tpu_torch.models import LlamaLM

    dt.manual_seed(7)
    card_lm = LlamaLM(**OPT_CPU, device="cuda", flash=False)
    start = {k: v.cpu() for k, v in card_lm.state_dict().items()}
    rng = np.random.default_rng(7)
    seq = rng.integers(0, OPT_CPU["vocab_size"], (2, OPT_CPU["max_len"] + 1)).astype(np.int64)
    x, y = seq[:, :-1], seq[:, 1:]
    worst = {}
    for name, cls, kw in OPTIMIZERS:
        moved = {}
        for dev in ("cuda", "cpu"):
            m = LlamaLM(**OPT_CPU, device=dev, flash=False)
            m.load_state_dict(start)
            CompiledTrainStep(m, getattr(optim, cls)(m.parameters(), **kw),
                              nn.CrossEntropyLoss())(x, y)
            moved[dev] = {k: v.cpu() - start[k] for k, v in m.state_dict().items()}
        errs = {k: ((moved["cuda"][k] - v).norm() / v.norm().clamp_min(1e-30)).item()
                for k, v in moved["cpu"].items() if v.norm() > 0}
        k = max(errs, key=errs.get)
        worst[name] = (k, errs[k])
        if not errs[k] < PARAM_TOL:
            fail(f"{name}: {k}'s change on the card differs from the CPU's by {errs[k]} of its "
                 "norm")
    print("  one f32 step, card against CPU, worst tensor's change (of its norm): "
          + ", ".join(f"{n} {e:.3g} ({k})" for n, (k, e) in worst.items())
          + f"; limit {PARAM_TOL}")
    report["optimizers_vs_cpu"] = worst


def finetune_phases(torch, dt, ops, report, max_err, phase, card):
    """The fine-tuning slice's kernel checks and its main paths (LoRA
    training, merged serving, one per optimizer) and the card-against-CPU
    optimizer check; returns {path: launch counts} and the kernel phase's
    numbers."""
    phase("fine-tuning kernel phase (kernels vs plain twins at the LoRA and optimizer paths' "
          "shapes):")
    fk = ft_kernel_phase(torch, ops, report, max_err)
    phase("LoRA fine-tuning at Mistral-7B widths, merged and served (main paths):")
    paths, _ = lora_finetune_phase(torch, dt, report, card)
    phase("every optimizer on the Llama family (main paths):")
    opaths, _ = optimizer_phase(torch, dt, report, card)
    paths.update({f"optimizer_{k}": v for k, v in opaths.items()})
    phase("card against CPU (one f32 step of each optimizer):")
    optimizer_cpu_check(torch, dt, report)
    return paths, fk


def resnet50_fusion_phase(torch, dt, report, model, x, card):
    """fuse_conv_bn on the trained ResNet-50, still in train mode (its 53
    BNs must all fold in the eval copy; the model stays in train mode):
    the fused CompiledEvalStep against the unfused in f32 (within PARAM_TOL
    of the logits' norm) and in bf16 (phase 18's eval bound, 2e-2 of the
    largest logit); eval images/s fused and unfused in both dtypes."""
    import copy

    from deepflows_tpu_torch import nn
    from deepflows_tpu_torch.jit import CompiledEvalStep

    fused = nn.fuse_conv_bn(model, x[:2])  # the trained model as it is, in train mode
    if not model.training or fused.training:
        fail("fuse_conv_bn changed the caller's training flag or left its copy in train mode")
    left = sum(isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)) for m in fused.modules())
    folded = sum(isinstance(m, nn.Identity) for m in fused.modules())
    print(f"  fuse_conv_bn on the trained ResNet-50: {folded} BNs folded, {left} left")
    if left or folded != RESNET50_BNS:
        fail(f"fuse_conv_bn folded {folded} of ResNet-50's BNs, left {left}")
    out = {"folded": folded}
    for dtype in ("f32", "bf16"):
        pair = {"unfused": model, "fused": fused}
        if dtype == "bf16":
            pair = {k: copy.deepcopy(m).bfloat16() for k, m in pair.items()}
        xi = x if dtype == "f32" else x.bfloat16()
        steps = {k: CompiledEvalStep(m) for k, m in pair.items()}
        logits = {k: s(xi).float() for k, s in steps.items()}
        u, f = logits["unfused"], logits["fused"]
        if dtype == "f32":
            err, lim = ((f - u).norm() / u.norm()).item(), PARAM_TOL
        else:
            err, lim = ((f - u).abs().max() / u.abs().max()).item(), 2e-2
        r = {"err": err, "limit": lim}
        for k, s in steps.items():
            r[f"{k}_ms"] = event_ms(lambda s=s: s(xi), 5)
            r[f"{k}_images_per_s"] = CNN_B / r[f"{k}_ms"] * 1e3
        out[dtype] = r
        print(f"  eval {dtype}: fused {r['fused_ms']:.3f} ms ({r['fused_images_per_s']:.1f} "
              f"images/s) against unfused {r['unfused_ms']:.3f} ms "
              f"({r['unfused_images_per_s']:.1f}); logits differ by {err:.3g} (limit {lim}); "
              f"{card}")
        if not err < lim:
            fail(f"fused ResNet-50 {dtype} eval logits differ from the unfused by {err}")
        del pair, steps, logits
    report["resnet50_fusion"] = out
    del fused
    free_card(torch)


def fusion_planted_faults(torch, dt):
    """Two planted faults fuse_conv_bn must flag by keeping the BN: a conv
    whose output also feeds a residual add, and two convs that tie one
    weight."""
    from deepflows_tpu_torch import nn

    class Residual(nn.Module):
        def __init__(self):
            super().__init__()
            self.conv = nn.Conv2d(8, 8, 3, padding=1, device="cuda")
            self.bn = nn.BatchNorm2d(8, device="cuda")

        def forward(self, x):
            h = self.conv(x)
            return self.bn(h) + h

    class Tied(nn.Module):
        def __init__(self):
            super().__init__()
            self.a = nn.Conv2d(8, 8, 3, padding=1, device="cuda")
            self.b = nn.Conv2d(8, 8, 3, padding=1, device="cuda")
            self.b.weight = self.a.weight
            self.bn_a = nn.BatchNorm2d(8, device="cuda")
            self.bn_b = nn.BatchNorm2d(8, device="cuda")

        def forward(self, x):
            return self.bn_a(self.a(x)) + self.bn_b(self.b(x))

    dt.manual_seed(9)
    x = torch.randn(2, 8, 16, 16, device="cuda")
    for name, cls, kept in (("residual", Residual, 1), ("tied weight", Tied, 2)):
        m = cls().eval()
        fused = nn.fuse_conv_bn(m, x)
        left = sum(isinstance(b, nn.BatchNorm2d) for b in fused.modules())
        if left != kept:
            fail(f"planted fault not flagged: fuse_conv_bn folded the {name} case ({left} BNs "
                 f"left of {kept})")
        with torch.no_grad():
            err = (fused(x) - m(x)).abs().max().item()
        print(f"  planted fault flagged: the {name} conv keeps its BN ({left} left); outputs "
              f"equal within {err:.3g}")


def group_norm_check(torch, report):
    """GroupNorm (32 groups) on a ResNet-50 stage activation, f32 and bf16,
    forward and backward.  The output and dx: the card against a CPU copy,
    elementwise within GN_TOL (rtol = atol).  The weight's and bias's
    gradients, sums over N·H·W = 401,408 terms that cancel to about 1/600
    of their magnitudes, against a float64 reference on the same (rounded)
    inputs, relative to that reference's norm within the same GN_TOL: a
    zero gradient reads 1, and an H100 80GB HBM3 (700 W) reads 1.8e-7 (f32)
    and 4.1e-3 / 1.8e-3 (bf16), as the CPU does."""
    import torch.nn.functional as F

    from deepflows_tpu_torch import nn

    g = torch.Generator().manual_seed(10)
    x = torch.randn(GN_SHAPE, generator=g)
    gout = torch.randn(GN_SHAPE, generator=g)
    w = 1 + 0.3 * torch.randn(GN_SHAPE[1], generator=g)
    b = torch.randn(GN_SHAPE[1], generator=g)
    out = {}
    for dtype, tdt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        res = {}
        for dev in ("cuda", "cpu"):
            m = nn.GroupNorm(GN_GROUPS, GN_SHAPE[1], device=dev)
            with torch.no_grad():
                m.weight.copy_(w)
                m.bias.copy_(b)
            m.to_dtype(tdt)
            xi = x.to(dev, tdt, copy=True).requires_grad_()
            y = m(xi)
            y.backward(gout.to(dev, tdt))
            res[dev] = [t.detach().double().cpu() for t in (y, xi.grad, m.weight.grad, m.bias.grad)]
            eps = m.eps
            del m, xi, y
        tol = GN_TOL[dtype]
        g64 = gout.to(tdt).double()
        xhat = F.group_norm(x.to(tdt).double(), GN_GROUPS, eps=eps)
        ref = {"dweight": (g64 * xhat).sum((0, 2, 3)), "dbias": g64.sum((0, 2, 3))}
        del g64, xhat
        r = {k: ((a - c).abs() / (tol + tol * c.abs())).max().item()
             for k, a, c in zip(("out", "dx"), res["cuda"], res["cpu"])}
        for k, a, c in zip(ref, res["cuda"][2:], res["cpu"][2:]):
            r[k] = ((a - ref[k]).norm() / ref[k].norm()).item()
            r[f"{k}_cpu"] = ((c - ref[k]).norm() / ref[k].norm()).item()
        out[dtype] = r
        print(f"  GroupNorm({GN_GROUPS}, {GN_SHAPE[1]}) on {GN_SHAPE} {dtype}: out and dx card "
              f"against CPU {r['out']:.3g} and {r['dx']:.3g} of the elementwise bound (rtol = "
              f"atol = {tol}); dweight and dbias {r['dweight']:.3g} and {r['dbias']:.3g} of the "
              f"float64 gradient's norm (CPU {r['dweight_cpu']:.3g} and {r['dbias_cpu']:.3g}; "
              f"limit {tol})")
        if not (r["out"] <= 1 and r["dx"] <= 1 and r["dweight"] <= tol and r["dbias"] <= tol):
            fail(f"GroupNorm {dtype}: the card's output or dx differs from the CPU past rtol = "
                 f"atol = {tol}, or its dweight or dbias from float64 past {tol} of the norm")
        del res, ref
    report["group_norm"] = out
    free_card(torch)


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

    t_run = t0 = time.perf_counter()

    def phase(title):
        print(f"[{time.perf_counter() - t_run:.1f} s] {title}")

    _build.build_all()
    report["build_s"] = time.perf_counter() - t0
    print(f"build: {report['build_s']:.1f} s into {_build.BUILD / _build.source_hash()}")
    for log in sorted((_build.BUILD / _build.source_hash()).glob("*.log")):
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {log.stem}: {line.strip()}")

    phase("kernel phase (kernel vs plain twin, L2 flushed between timed launches):")
    max_err = kernel_phase(torch, ops, report)
    step_ms, b_int8, b_w8a8, wbytes = decode_step_timing(torch, ops)
    report["decode_step_kernels_ms"] = step_ms
    print(f"one decode step's {PER_FORWARD} calls (M=8, bf16 x, {wbytes} weight bytes): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in step_ms.items())
          + f"; bound int8 {b_int8[0]:.4f} ms, w8a8 {b_w8a8[0]:.4f} ms")
    pre_ms, p_int8, p_w8a8, _ = forward_timing(torch, ops, PREFILL_M)
    report["prefill_kernels_ms"] = dict(pre_ms, int8_bound_ms=p_int8[0], w8a8_bound_ms=p_w8a8[0])
    print(f"one prefill's {PER_FORWARD} calls (48 at M={PREFILL_M} and the head at M=8, bf16 x): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in pre_ms.items())
          + f"; bound int8 {p_int8[0]:.4f} ms ({p_int8[1]}), w8a8 {p_w8a8[0]:.4f} ms "
          f"({p_w8a8[1]}); {card}")

    phase("slice phase (main path):")
    counts = slice_phase(torch, dt, report)

    at = (f"one decode step: {PER_FORWARD} calls, M=8, bf16 x, (K, N) of qkv/o/fc1/fc2"
          f" x 12 layers + head; prefill_*: one prefill, the 48 at M={PREFILL_M} + head")
    kernels = [
        dict(name="int8_matmul", route="cuda",
             source="deepflows_tpu_torch/csrc/int8_matmul.cu",
             replaces="deepflows_tpu/ops/pallas_kernels.py:377",
             launches=counts["int8_matmul"], max_abs_err=max_err["int8_matmul"],
             ms=step_ms["int8_matmul"], plain_ms=step_ms["int8_matmul_plain"],
             bound_ms=b_int8[0], bound_by=b_int8[1],
             library_ms=step_ms["int8_matmul_library"], at=at,
             prefill_ms=pre_ms["int8_matmul"], prefill_library_ms=pre_ms["int8_matmul_library"],
             prefill_bound_ms=p_int8[0]),
        dict(name="w8a8_matmul", route="cuda",
             source="deepflows_tpu_torch/csrc/w8a8_matmul.cu",
             replaces="deepflows_tpu/ops/pallas_kernels.py:718",
             launches=counts["w8a8_matmul"], max_abs_err=max_err["w8a8_matmul"],
             ms=step_ms["w8a8_matmul"], plain_ms=step_ms["w8a8_matmul_plain"],
             bound_ms=b_w8a8[0], bound_by=b_w8a8[1],
             library_ms=step_ms["w8a8_matmul_library"], at=at,
             prefill_ms=pre_ms["w8a8_matmul"], prefill_library_ms=pre_ms["w8a8_matmul_library"],
             prefill_bound_ms=p_w8a8[0]),
    ]

    phase("training kernel phase (kernel vs plain twin; times at the slice's bf16 shapes, "
          "L2 flushed between timed launches):")
    tk = train_kernel_phase(torch, ops, report)
    phase("training phase (main path):")
    tcounts, tr = train_phase(torch, dt, report)
    phase("card against CPU (f32 training step):")
    train_cpu_check(torch, dt, report)
    replaces = {  # the Pallas kernel body each kernel replaces
        "flash_attention_fwd": ("flash_attention.cu", 807),
        "flash_attention_bwd": ("flash_attention.cu", 869),
        "fused_linear_ce_fwd": ("fused_linear_ce.cu", 445),
        "fused_linear_ce_bwd": ("fused_linear_ce.cu", 484),
        "fused_adam": ("fused_adam.cu", 167),
        "fused_adam_sr": ("fused_adam_sr.cu", 230),
        "matmul": ("linear_f32.cu", 50),
        "linear_fused": ("linear_f32.cu", 104),
    }

    def entry(name, r, launches, at):
        src, line = replaces[name]
        return dict(
            name=name, route="cuda", source=f"deepflows_tpu_torch/csrc/{src}",
            replaces=f"deepflows_tpu/ops/pallas_kernels.py:{line}", launches=launches,
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"], at=at,
            **{k: r[k] for k in ("plan", "tile", "fwd_route", "bwd_route", "tflops") if k in r})

    at = (f"training step: TransformerLM d{TRAIN['dim']} x {TRAIN['depth']}, B {TRAIN_B}, "
          f"L {TRAIN_L}, V {TRAIN['vocab_size']}, bf16; ms and bounds per call")
    for name, r in tk.items():
        n = PER_STEP[name]
        route = r.get("fwd_route", r.get("bwd_route"))
        how = f" ({route} route, {r['tflops']:.1f} TFLOP/s)" if route else ""
        print(f"  {name}: {r['ms']:.4f} ms a call{how}, {n * r['ms']:.3f} ms a step ({n} calls); "
              f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms, "
              f"library {r['library_ms']:.4f} ms; {card}")
        kernels.append(entry(name, r, tcounts[name], at))
    print(f"training step: {tr['step_wall_ms']:.3f} ms wall, {tr['step_event_ms']:.3f} ms CUDA "
          f"events, {tr['tokens_per_s']:.1f} tokens/s, busy {100 * tr['device_busy_share']:.1f}%, "
          f"MFU {100 * tr['mfu']:.2f}%; {card}")

    phase("SR kernel phase (fused_adam_sr vs its plain twin, bit for bit):")
    sk = sr_kernel_phase(torch, ops, report)
    phase("bf16-weight training phase (main path):")
    scounts, sr = train_phase(torch, dt, report, sr=True, ref_first_loss=tr["losses"][0])
    print(f"  fused_adam_sr: {sk['ms']:.4f} ms a step over {sk['elements']} elements; bound "
          f"{sk['bound_ms']:.4f} ms ({sk['bound_by']}), plain {sk['plain_ms']:.4f} ms; {card}")
    kernels.append(entry("fused_adam_sr", sk, scounts["fused_adam_sr"],
                         at + "; bf16 weights, the 198 tensors in one call"))
    print(f"bf16-weight step: {sr['step_wall_ms']:.3f} ms wall ({tr['step_wall_ms']:.3f} with "
          f"f32 masters), {sr['tokens_per_s']:.1f} tokens/s ({tr['tokens_per_s']:.1f}), busy "
          f"{100 * sr['device_busy_share']:.1f}% ({100 * tr['device_busy_share']:.1f}%), MFU "
          f"{100 * sr['mfu']:.2f}% ({100 * tr['mfu']:.2f}%), peak memory "
          f"{sr['peak_memory_gb']:.2f} GB ({tr['peak_memory_gb']:.2f}); {card}")

    phase("eager f32 kernel phase (matmul and linear_fused vs their plain twins):")
    lk = linear_kernel_phase(torch, ops, report)
    phase("eager f32 phase (use_pallas, main paths):")
    ecounts = eager_phase(torch, dt, report)
    for name, run in (("matmul", "mlp_bias_free"), ("linear_fused", "mlp")):
        r = lk[name]
        print(f"  {name} at {r['at']}: {r['ms']:.4f} ms; bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), plain {r['plain_ms']:.4f} ms, library {r['library_ms']:.4f} ms;"
              f" at the MLP's three layers " + ", ".join(
                  f"{v:.4f}" for v in r["mlp_ms"].values()) + f" ms; {card}")
        if "mlp8" in r:
            m8 = r["mlp8"]
            print(f"  matmul, the bias-free MLP's 8 calls summed: {m8['ms']:.4f} ms; bound "
                  f"{m8['bound_ms']:.4f} ms, plain {m8['plain_ms']:.4f} ms, library "
                  f"{m8['library_ms']:.4f} ms; {card}")
        kernels.append(entry(name, r, ecounts[run][name], r["at"]))
    fpaths, fk = family_phases(torch, dt, ops, report, max_err, phase)
    family = {  # each kernel's numbers at the family's shapes
        "int8_matmul": dict(decode_step_ms=fk["decode_step"]["int8_matmul"],
                            decode_step_bound_ms=fk["decode_step"]["int8_bound_ms"],
                            prefill_ms=fk["prefill"]["int8_matmul"],
                            prefill_bound_ms=fk["prefill"]["int8_bound_ms"]),
        "w8a8_matmul": dict(decode_step_ms=fk["decode_step"]["w8a8_matmul"],
                            decode_step_bound_ms=fk["decode_step"]["w8a8_bound_ms"],
                            prefill_ms=fk["prefill"]["w8a8_matmul"],
                            prefill_bound_ms=fk["prefill"]["w8a8_bound_ms"]),
        "flash_attention_fwd": {k: {n: v[n] for n in ("fwd_ms", "fwd_bound_ms", "sdpa_fwd_ms")}
                                for k, v in fk["flash"].items()},
        "flash_attention_bwd": {k: {n: v[n] for n in ("bwd_ms", "bwd_bound_ms")}
                                for k, v in fk["flash"].items()},
        "fused_adam": {k: {n: v[n] for n in ("ms", "bound_ms", "plain_ms", "library_ms",
                                             "elements")}
                       for k, v in fk["fused_adam"].items()},
    }
    cpaths, cchecks = cnn_phases(torch, dt, report, phase, card)
    ftpaths, ftk = finetune_phases(torch, dt, ops, report, max_err, phase, card)
    finetune = {  # each kernel's numbers at the fine-tuning slice's shapes
        "int8_matmul": dict(decode_step_ms=ftk["decode_step"]["int8_matmul"],
                            decode_step_plain_ms=ftk["decode_step"]["int8_matmul_plain"],
                            decode_step_library_ms=ftk["decode_step"]["int8_matmul_library"],
                            decode_step_bound_ms=ftk["decode_step"]["int8_bound_ms"]),
        "flash_attention_fwd": {n: ftk["flash"][n] for n in ("fwd_ms", "fwd_bound_ms",
                                                             "sdpa_fwd_ms")},
        "flash_attention_bwd": {n: ftk["flash"][n] for n in ("bwd_ms", "bwd_bound_ms")},
        "fused_adam": {n: ftk["fused_adam"][n] for n in ("ms", "bound_ms", "plain_ms",
                                                         "library_ms", "elements")},
    }
    for k in kernels:
        for key, paths in (("launches_by_family_path", fpaths), ("launches_by_cnn_path", cpaths),
                           ("launches_by_finetune_path", ftpaths)):
            by_path = {p: c[k["name"]] for p, c in paths.items() if c[k["name"]]}
            if by_path:
                k[key] = by_path
                k["launches"] += sum(by_path.values())
        if k["name"] in max_err:
            k["max_abs_err"] = max_err[k["name"]]
        if k["name"] in family:
            k["family"] = family[k["name"]]
        if k["name"] in finetune:
            k["finetune"] = finetune[k["name"]]
        if k["name"] in cchecks:  # each CNN path's check at its own shapes
            k["cnn"] = cchecks[k["name"]]
            k["max_abs_err"] = max([k["max_abs_err"]]
                                   + [r["max_abs_err"] for r in k["cnn"].values()])
    for k in kernels:
        if k["launches"] <= 0:
            fail(f"{k['name']} was not launched on the main path")
    report["kernels"] = kernels
    if args.report:
        os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
        with open(args.report, "w") as f:
            json.dump(report, f, indent=1)
    report["run_s"] = time.perf_counter() - t_run
    print(f"card: {card}; {report['run_s']:.1f} s from the build's start")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
