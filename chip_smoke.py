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
   M 2 and 300; M 48 and below take the stream, quant.STREAM_M).  Every
   int8_matmul call is held to the route it must take
   (int8_matmul.routes): decode, stream, and at prefill M "wgmma" for
   bf16 x where TMA can read both operands (K a multiple of 8, N of 16,
   aligned bases) and the mma.sync tile ("mma") otherwise (f32 x, N 1000 and 1030,
   K 70, the misaligned weight); the wgmma tile's edges (WGMMA_RAGGED:
   ragged M, K not a multiple of 64, N not of 128 or 256, K 8) at each
   tile of quant._WGMMA_TILES, and one planted fault that the check must
   flag (a call on one K stage fewer, the kernel's last stage dropped).
   Every w8a8_matmul call is held to its route likewise
   (w8a8_matmul.routes, w8a8_route_wanted): at prefill M "wgmma" (s8 x)
   where TMA can read both operands (K and N multiples of 16, aligned
   bases), else "mma"; the s8 wgmma tile's edges (W8A8_RAGGED: ragged M,
   K a multiple of 16 but not of 128, N not of 128 or 256, K 16) with each
   tile of quant._W8A8_TILES forced and with "mma" forced, all bitwise
   equal to the plain twin, two calls bitwise equal, and one planted fault
   (the last K stage of 128 dropped).
   Tolerances: w8a8 exact; int8 with f32 output rtol 1e-4
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
   prefill, new - 1 steps), the int8 and w8a8 decoders every prefill
   launch on the "wgmma" route (path_routes; the kernels line prints them
   by serving path), every output must be in the vocabulary, beam
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
   and V not tile multiples (V no multiple of 8 too: w staged into padded
   rows), an f32 bias beside bf16 x and w, x viewed 2 bytes off a 16-byte
   boundary, each case held to the routes its forward and its backward
   must take (ops/fused_ce.py _fwd_route and _bwd_route: wgmma in bf16 at
   D a multiple of 8 with x's base aligned, mma.sync at D 257 and for the
   offset x); Adam: sizes
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
   backward's clusters of 1, 1, 2, 4, 8 and 16 blocks, the last at 2
   stages; f32 up to D 1024),
   each CE case with targets V - 1, V + 3 and -1 beside random ones (the
   last two must cost exactly lse, in f32 and bf16, forward and backward);
   Adam below 1e-6.  Rows that see no key must give exactly 0 and lse
   -1e30.  Two planted faults must fail the flash check: the kernel run
   with window L - 64 (up to a key tile dropped from the longest rows) and
   its backward fed lse + 0.1; and two the CE check: dx of the backward
   run on the first V - 64 columns of w and b (one vocab step dropped),
   held by row against the full reference, and the backward fed lse +
   0.1, both on the backward's wgmma route.  Two bf16 CE backward calls
   (wgmma) and two bf16 flash forward calls at the slice's shape must give
   the same bits.  The bf16 CE forward besides,
   each case held to the route it must take (ops/fused_ce.py _fwd_route:
   wgmma where TMA can read x, w staged into 16-byte aligned rows at any V,
   else mma) with loss and lse below 1e-4 of the twin: the slice (wgmma;
   two calls bitwise equal), N 8191 and 300, V 1000, 8200 and 8190 (now
   wgmma), D 200, 1000 and 1001 (mma), an f32 bias, x viewed 2 bytes off
   at V 8192 and 8190 (mma), each with targets V - 1, V + 3 and -1 (the
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
   each, the CE forward and backward and fused Adam once each, flash and
   the CE both ways on their wgmma routes (printed by route).  Every loss
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
   their bounds.  Each matrix's route (ops/quant.py _route) asserted: the
   down projection (K 14336) at M 1 and 8 on the stream, the others on the
   decode kernel, M 384 and 1536 on the prefill tile.  The stream against
   both plain twins at its edges (stream_ragged: M 1, 8, 9, 17, 33, 40 and
   STREAM_M 48, and M 63 on the prefill tile; K 8193, 14336 and 16385; N
   50, 4096 and 4097; misaligned weights), f32 and bf16 x and output, w8a8
   bitwise, and the same call twice bitwise.  flash_attention forward and
   backward at the two training paths' shapes, (1, 32, 8192, 128) with
   window 4096 and (1, 32, 2048, 128) causal, bf16, q and dout as (B, L,
   H, D) views, both on wgmma, held by row against the plain twins
   (computed four heads at a time) at the limits of phase 4, timed beside
   their bounds and SDPA's forward.
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

30. Serving kernel phase: int8_matmul and w8a8_matmul against their plain
   twins at Mistral's five matrices at M 40 (the speculative verify
   forward, B 8 x (gamma 4 + 1)) and M 2048 (an admission prefill, B 1 x
   max_len), the tolerances of phase 2 (M 8 is phase 25's), each held to
   its route (M 40 the stream, M 2048 the prefill tile); a verify
   forward's 33 calls (the head at M 40 too) and an admission prefill's
   (the head at M 1) timed beside their twins, library calls and bounds.
31. The in-flight engine, main paths: LlamaLM at Mistral-7B widths, depth
   8, max_len 2048, bf16, random weights from a seed, served by
   InflightEngine(slots 8, chunk 8, top_k 50) in quant None, "int8" and
   "w8a8", with a dense cache and then a paged one (512 blocks of 16:
   half the dense positions).  Traffic from a seed: 32 requests, prompts
   of 16-1024 tokens and +32-256, half starting with a 512-token system
   prompt registered with register_prefix (one of them the prompt
   alone), a quarter sampled (temperature 0.8, top_p 0.9), a quarter
   greedy with an eos_id the one-shot run emits, from 4 threads with
   staggered arrivals.  Launch counts zeroed just before and read just
   after: 33 x (prefills + suffix forwards + chunk steps) in int8 and
   w8a8, none dense.  Every request finishes in the vocabulary at its
   length or cut at its eos; 16 prefix hits (one full), 16 misses; every
   chunk step after a key's first replays its graph.  Greedy tokens
   against the one-shot graphed decoder (each request alone at B 1), the
   paged engine's against the dense engine's, by the comparison rule:
   equal until they part, and where they part the one-shot run's f32
   top-2 logit margin below 0.05 (a near tie); at least half of the
   greedy tokens compared.  A head negated in place and refresh_params()
   move the tokens.  Then a burst of 8 requests of 1024 + 256 positions,
   which the paged pool must hold back (backpressure), its tokens against
   the dense engine's.  Requests/s, generated tokens/s, latency p50 and
   p99, a chunk's wall and device ms and busy share, admission ms
   (prefill, suffix), the cache's memory, a step's device time by kernel
   group, and the one-shot decoder's tokens/s.
32. Speculative decoding, main paths: SpeculativeDecoder(gamma 4) over the
   same model, B 8, prompt 64, +128, the draft a depth-1 LlamaLM holding
   the target's embedding, first block, final norm and head: greedy with
   a dense and with an int8 target (33 int8 launches a target prefill and
   a round), against the plain graphed generate until the rows part, then
   every token against the plain decoder's step fed the stream's own
   tokens: its pick, or a near tie (top-2 closer than 0.05) there;
   one sampled run (temperature 0.8), reproducible under its seed; the
   target as its own draft accepting 90% of its proposals; every round
   after the first from its graph.  Accepted share, rounds and tokens/s
   beside the plain decoder's.
33. gRPC: the model served by MyDLPWServicer on 127.0.0.1 (int8, an
   in-flight engine of 8 slots) to 4 concurrent clients, 8 Generate calls
   of prompt 64, +32 greedy, against the one-shot int8 decoder by the
   comparison rule.

34. seq2seq training, a main path: Seq2SeqTransformer at BART-base's
   widths (facebook/bart-base config.json: d_model 768, 12 heads, FFN
   3072, 6 encoder and 6 decoder layers, vocab 50265, source 1024 =
   max_position_embeddings, target 256; this repo's pre-norm GELU blocks,
   naive attention), f32 with random weights from a seed, first
   fused_adam held bitwise against its plain twin over the model's 261
   parameter tensors (177 M elements) and timed beside its bound and
   torch.optim.Adam(fused=True); then CompiledTrainStep(model,
   Adam(lr 1e-4, fused=True), CrossEntropyLoss()) on a repeated B 8 batch
   of the reversal task of examples/seq2seq_reversal.py (the target the
   reversed source's first 256 tokens through a fixed vocabulary
   permutation), 5 steps of exactly one fused_adam launch each; the first
   loss within 1.0 of ln 50265, the last below the first.  Step ms (wall,
   CUDA events, device), target tokens/s, busy share, peak memory, MFU of
   the analytic FLOPs against the f32 peak (TF32 off) and the step's
   device time by kernel group (torch.profiler).
35. seq2seq checkpoint: save_checkpoint of the trained model and its Adam,
   load_checkpoint into a fresh model and optimizer, every parameter and
   slot and the step count bitwise equal; then AsyncCheckpointer.save with
   the next training step queued right behind it: the file holds the state
   before that step (held against the loaded model), though the step
   moved every parameter in place.  The files live in a directory of the
   checkout that is removed afterwards.
36. seq2seq serving, a main path: the loaded model served by
   Seq2SeqGenerator in bf16, B 8, source 1024, +128 greedy: the eager
   loop, then the captured step (its graph replayed 127 times), tokens
   equal; generate and decode tokens/s, a step's device ms against its
   byte floor and by kernel group; the f32 generator against the tape's
   teacher-forced greedy for 8 tokens (parting only at a top-2 margin
   under 1e-3); 4 concurrent gRPC Generate calls to MyDLPWServicer (bf16)
   on 127.0.0.1, equal to the in-process generator's; then a ResNet-50
   checkpoint served from its file (model_file "resnet50.pkl", model_name
   "resnet50"): a Predict of 8 x 3 x 224^2 equal to CompiledEvalStep on
   the saved model.  Seconds of each of 34-36.

37. text_trainer, the utils slice's main path: the repository's markdown
   (*.md, then docs/*.md, sorted) -> BPETokenizer().train on its first
   65,536 characters (vocab 512), save and load (the merges equal) ->
   LMDataset over the whole corpus at seq_len 1024 -> Trainer(lm, Adam,
   LMHeadCrossEntropy(lm.head), checkpoint_path, step=the bench row's
   CompiledTrainStep(lm.trunk(), Adam(lr 5e-3, wd 5e-4, fused=True),
   LMHeadCrossEntropy(lm.head), compute_dtype=bf16)).fit(epochs 1, B 8,
   prefetch 2) on the phase-5 model (vocab 8192: the tokenizer's ids stay
   below 512).  Launch counts zeroed just before fit and read just after:
   PER_STEP a step, every batch staged on the card; the loss falls from
   the first step to the last.  Then load_checkpoint of the file fit wrote
   into a fresh LM and Adam: logits on a batch bitwise equal, the Adam
   slots equal; 48 greedy tokens from "## Architecture" on the graphed
   bf16 decoder, decoded; the bare step (run_steps) timed against a step
   inside fit; one more epoch under profiling.trace: the card's busy
   share, and every batch copy pinned, on the loader's stream, beside a
   kernel.  Host seconds of the tokenizer and the dataset.
38. cnn_trainer, a main path: ResNet-50 (bf16 compute, fused Adam at
   CNN_LR) through Trainer.fit, one epoch of 4 steps of B 128 x 224^2 (one
   batch of uint8-range images from a seed, scaled to [0, 1], repeated in
   order) with RandomCrop(224, 4), RandomHorizontalFlip and
   Normalize(IMAGENET_STATS) on the prefetch thread: one fused_adam launch
   a step, the loss falls, each step gets the x the thread augmented for
   it (the sum of its bits, on the card and on the host) and its own
   labels; Trainer.evaluate over 256 images,
   one device-to-host readback (profiling.trace); one batch's
   augmentation on the host against the step's device ms;
   DeviceDataLoader over a DataLoader: batches on the card equal to the
   host's, copied from pinned memory.
39. pretrained: a seeded ResNet-50 -> export_torch_state_dict ->
   torch.save -> convert_weights_to_deepflows -> load_pretrained_model
   (strict) into a fresh ResNet-50 on the card: eval logits at B 32 bitwise
   equal to the source's.
40. hf_interop: an HF-layout Llama state dict at Mistral-7B widths (depth
   2; numpy arrays from a seed under HF's key names and (out, in)
   layouts; a SimpleNamespace with config.json's field names) through
   build_llama_from_hf_config and load_hf_llama_state: 32 greedy tokens
   (B 2, prompt 64) from the graphed decoder and the f32 logits bitwise
   equal to the same arrays loaded by load_jax_state_dict.  Then, a main
   path, an HF-layout GPT-2 at GPT-2 small's widths (n_embd 768, 12
   layers and heads, vocab 50257, n_positions 1024) converted and trained
   3 bf16 steps at B 8 x L 1024 with LMHeadCrossEntropy (Adam lr 6e-4,
   fused): 12 flash launches each way at D 64, the CE forward and
   backward on their wgmma routes (w staged once a step into rows padded
   to 50264, since V 50257 is no multiple of 8; the backward's launches
   printed by route), flash on wgmma both ways.  Then each of
   the path's kernels against its plain twins at the path's shapes,
   timed beside its bound, plain twin and library call: the CE at (N
   8192, D 768, V 50257) with ce_case's tolerances, flash causal
   at (8, 12, 1024, 64) as (B, L, H, D) views with flash_case's, and
   fused_adam over GPT-2's 198 parameter tensors (adam_list_check).
   Seconds of each of 37-40.
41. parallel, main paths: a one-rank NCCL process group (a FileStore in a
   temporary directory of the checkout) and a DeviceMesh {data: 1,
   model: 1}.  The training phase's model and batch train 3 steps by the
   plain CompiledTrainStep and by parallel.ShardedTrainStep under DP,
   tensor_parallel_rules("model"), fsdp_rules(mesh,
   base=tensor_parallel_rules()) and zero_shard_state=True, each from
   the same seeded weights (Adam fused, LMHeadCrossEntropy, bf16
   compute): every step of every layout launches flash 12 times each way,
   the CE once each way and fused_adam once, as the plain step does; each
   loss within 1e-3 of the plain run's (relative) and each weight's
   distance from the plain run's within 1e-2 of its change (by norm).
   Then the model with ring=(mesh, "model") (one chunk: an f32 (L, L)
   block a head; no flash launch) against the flash model's losses within
   2e-2, with its peak memory; then MixtralLM at MIXTRAL_TRAIN with
   expert_parallel_rules("model") and MoECriterion, 2 steps against its
   plain step to the same bounds.  Each step's wall ms beside the plain
   step's, one {"parallel": ...} line with the card; the group is
   destroyed at the end.
42. pipeline, main paths: the training phase's model and batch (bf16
   compute, fused Adam, nn.CrossEntropyLoss on the logits widened to f32)
   split by pipeline_partition() and trained 3 steps by
   parallel.PipelinedTrainStep on a one-rank NCCL mesh {pipe: 1}: GPipe
   and 1F1B with one stage (the 12 blocks), interleaved 1F1B with the 12
   blocks as 12 chunks, each at 4 microbatches, against the plain
   CompiledTrainStep with accum_steps=4 from the same seeded weights:
   every step launches flash 48 times each way and fused_adam once, each
   loss within 1e-3 of the plain run's (relative) and each weight's
   distance within 1e-2 of its change (by norm); then eval_logits against
   the plain model's f32 forward with the pipeline's weights.  With more
   than one card (an even count n), one NCCL rank a card: GPipe and 1F1B
   over {pipe: n} (12/n blocks a stage), interleaved over {pipe: n} (12
   chunks), and with 4 cards GPipe over {data: 2, pipe: 2}, each at 8
   microbatches (4 over data), against the one-card twin with
   accum_steps=8 that every rank trains; every rank must hold the same
   losses and weights.  Each schedule's step wall ms beside the plain
   step's, its bubble fraction and peak memory a card, on one
   {"pipeline": ...} line with the card.
43. tape, main paths, under config.use_pallas, f32, on device="cuda":
   first matmul against its plain twin at the raw-tape MLP's 8 products
   in the layouts its backward hands it (transposed views) and
   linear_fused at the MLP's layers (phase 9's rtol 1e-4 / atol 1e-3),
   the 8 calls timed beside bound, twin and torch.matmul.  Then the
   reference's loop (out = model(Tensor(x, device="cuda")); loss =
   criterion(out, Tensor(y, ...)); zero_grad; backward; step;
   float(loss.numpy()); Graph.free_graph_all()) on models.MLP with
   phase 10's data and Adam(lr 1e-3) for 30 steps, one model.eval() /
   model.train() pass in the middle (nothing recorded, outputs without
   gradients): exactly 3 linear_fused a step; on CIFAR10_CNN with phase
   22's model, batch and fused Adam, dropout on, 30 steps: exactly one
   linear_fused and one fused_adam a step, no matmul.  Each beside its
   plain-tensor loop re-run here from the same weights and generator
   state, cuDNN deterministic in both (its default weight-gradient
   algorithms vary run to run): losses and final weights bitwise equal;
   Graph at its leaf count
   (0: the parameters are not tape nodes) after every backward; peak
   memory after the last step within 1 MiB of the peak after step 3.
   Then the MLP written with tape ops alone (leaf Tensors, x @ w + b,
   maximum(h, 0), a log-softmax from exp, log, max and sum, mean; SGD as
   w.data -= 0.1 * w.grad under no_grad), 30 steps of B 256: exactly 8
   matmul a step, Graph at its 6 leaves after every backward, losses
   within 1e-4 relative of a CPU copy's.  Then a reference-style script
   (from DeepFlows.tensor import *; y = 3x + 5 fitted by nn.Linear and
   SGD) through python -m deepflows_tpu_torch.shim with device 'cuda' in
   a subprocess: its fit within 1e-2 of (3, 5).  Prints each loop's
   median step ms beside its plain loop's, the __torch_function__ calls
   of one tape MLP step and the host us a call they cost, one small op's
   host us on the tape and plain, and one {"tape": ...} line with the
   card.
44. lazy, main paths: the same reference loops with lazy mode on
   (deepflows_tpu_torch.lazy: the step's torch calls recorded, run at the
   optimizer step's flush, and from the second matching step replayed as
   one captured CUDA graph).  models.MLP and CIFAR10_CNN as in phase 43,
   each in three loops (plain, tape, lazy) from the same weights and
   generator state, the MLP's under a per-step CosineAnnealingLR in every
   loop: the lazy loop bitwise the plain loop (losses, weights, BN's
   running statistics), exactly 3 linear_fused or 1 linear_fused + 1
   fused_adam a step, Graph at 0 after every backward, peak memory after
   the last step within 1 MiB of the peak after step 3, no eager fallback,
   at most 3 runners built, and every step from the fourth on that is not
   next to the eval pass a template replay.  The raw-tape MLP with an lr
   that changes every step, lazy against its eager loop on the card
   (bitwise) and a CPU copy (1e-4 relative).  Two MLP loops over a dataset
   held on the card, each step's batch a slice of it, for two epochs (f32
   Adam; bf16 Lion with weight decay at a per-step cosine lr), lazy against
   eager: bitwise past the capture, graphs replayed, the dataset unchanged.
   ResNet-50 at 224, f32, B 64,
   Adam(lr=1e-3, fused=True), 20 steps of an eager tape loop and of a lazy
   loop from the same weights, every step's loss kept and all of them read
   at every 10th step: the lazy loop bitwise the eager one, every held loss
   its own step's value, one fused_adam a step; a CompiledTrainStep of the
   same model timed beside them.  The DeepFlows shim's script under
   DEEPFLOWS_LAZY=1 fits 3x + 5.  Prints each loop's median step ms, each
   captured template's pool bytes, the peak memory and lazy_stats(), and
   one {"lazy": ...} line with the card.
45. onnx, main paths: ResNet-50 (1000 classes, f32, random weights from a
   seed, BN running statistics moved off their initial values) exported
   with onnx.export_onnx on the card (the seconds, the file's MB and
   check_onnx's histogram printed: 53 Conv, BN folded), run by OnnxModel on
   the card at B 8 and B 1 (the dynamic batch), each shape one CUDA graph
   whose later calls replay it (3 replays a shape counted), against
   CompiledEvalStep with TF32 off: max |diff| within 1e-3 of the largest
   |logit| and the top-1 equal where the top-2 margin exceeds that.  ms a
   batch of 8 (wall, numpy in and out): the runtime, CompiledEvalStep and
   the eager model; device ms of a replay and of the eager forward.  The
   file served by MyDLPWServicer(model_file="resnet50.onnx") on 127.0.0.1:
   a Predict of 8 x 3 x 224^2, its first call and a replay, bitwise the
   in-process OnnxModel (cuDNN deterministic in this phase).  The bench
   row's TransformerLM widths (dim 1024, heads 8, V 8192, L 1024) at depth
   2 with flash=None exported (its attention traced on the naive path) and
   run on fresh tokens (B 2) against CompiledEvalStep (the flash route) at
   the same bound; the same model with flash=True refused by the route's
   name.  The files go to a .onnx_* directory of the checkout, removed.
46. viz, a main path: make_server on 127.0.0.1, a WebSocket client, and
   POST /api/train/start with MNIST_CNN, the whole digits set (the viz
   package's own copy), 1 epoch at batch 64 on device "tpu": the metrics
   frames' losses finite and falling, the epoch message and "finished",
   the parameters on the card; the ms a step printed.
47. bridge: nn.torch_function on card tensors, forward and gradients
   against autograd through the same math within 1e-6, with and without
   checkpoint.
48. cpu_native on the card's host (its CPU model from /proc/cpuinfo
   printed): the g++ build, the 24 C entries against torch on the CPU, the
   MLP's 30 Adam steps through the C kernels (5 SGEMMs a step counted, none
   on the cpu device, losses within 1e-5 of the cpu device's and halved),
   and a 1024^3 SGEMM timed against torch.matmul on the host.  The four
   phases print one {"last_slice": ...} line with the card.

Prints the card's name and power limit, one {"kernels": [...]} line (the CE
backward's, linear_fused's and matmul's entries with the plan they ran:
(C, BM, BV) and (tile, chunk, splits); the flash forward's with its route
and TFLOP/s; each kernel's launches summed over every main path, with
the family paths' share in ``launches_by_family_path``, the CNN paths'
in ``launches_by_cnn_path``, the fine-tuning slice's in
``launches_by_finetune_path``, the serving slice's in
``launches_by_serving_path``, the seq2seq slice's in
``launches_by_seq2seq_path`` (fused_adam's numbers at its list in
``seq2seq``), the parallel slice's in ``launches_by_parallel_path``, the
pipeline slice's in ``launches_by_pipeline_path``, the tape slice's in
``launches_by_tape_path`` (matmul's numbers at the raw-tape MLP's
products in ``tape``), the lazy slice's in ``launches_by_lazy_path``, the last slice's in
``launches_by_last_slice_path``, the
utils slice's in ``launches_by_utils_path`` (the CE's,
flash's and fused_adam's numbers at GPT-2's shapes in ``gpt2``), its numbers at the family's shapes in
``family``, at each CNN path's in ``cnn``, whose worst error its
max_abs_err takes in, at the fine-tuning paths' in ``finetune`` and at
the serving slice's rows (M 40 and 2048) in ``serving``),
and as its last line {"ok": true,
"device": {...}}.  With ``--report PATH`` it also
writes every measurement (each shape's times, the throughput of each mode,
the training step's numbers) to PATH as JSON.
"""

from __future__ import annotations

import argparse
import bisect
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
PREFILL_RAGGED = (  # (M, K, N, weight 16-byte aligned): the prefill tile's edges; M 9,
    # 16 and 40 take the stream
    (9, 4096, 1000, True), (16, 4096, 1030, True), (100, 4096, 1000, True),
    (129, 4096, 1030, True), (300, 4096, 1000, True), (1000, 4096, 1030, True),
    (200, 4096, 1024, False), (100, 70, 64, True), (40, 33, 100, True), (300, 9000, 200, True),
)
WGMMA_RAGGED = (  # (M, K, N, weight 16-byte aligned): the wgmma tile's edges (bf16 x):
    # ragged M, K not a multiple of 64, N not of 128 or 256, K 8
    (49, 4096, 1024, True), (65, 1032, 1040, True), (129, 4104, 208, True),
    (1000, 4096, 1040, True), (300, 9000, 2064, True), (100, 8, 16, True),
)
W8A8_RAGGED = (  # (M, K, N, weight 16-byte aligned): the s8 wgmma tile's edges (w8a8):
    # ragged M, K a multiple of 16 but not of 128, N not of 128 or 256, K 16
    (49, 4096, 1024, True), (65, 1040, 1040, True), (129, 4112, 208, True),
    (1000, 4096, 1040, True), (300, 9008, 2064, True), (100, 16, 16, True),
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


def cost_bound(wrapper, *args, kind="bf16"):
    """bound_ms of one call of a kernel wrapper on ``args``, from the
    operations and bytes the wrapper states (``<wrapper>.cost``,
    ops._common.costed): the bounds of flash, the CE and Adam."""
    n_ops, n_bytes = wrapper.cost(*args)
    return bound_ms(n_bytes, n_ops, kind)


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


def int8_route_wanted(M, K, N, x_bf16, aligned):
    """The route an int8_matmul call must take (quant._int8_route): the
    decode kernel at most 8 rows with K up to 8192, the stream up to
    quant.STREAM_M (48) rows, and above that the wgmma tile for bf16 x
    that TMA can read (K a multiple of 8, N of 16, aligned bases), else
    the mma.sync tile.  w8a8_matmul's rule is w8a8_route_wanted."""
    if M <= 8 and K <= 8192:
        return "decode"
    if M <= 48:
        return "stream"
    return "wgmma" if x_bf16 and aligned and K % 8 == 0 and N % 16 == 0 else "mma"


def w8a8_route_wanted(M, K, N, aligned):
    """The route a w8a8_matmul call on a fresh (aligned) xq must take
    (quant._w8a8_route): decode and stream as int8_route_wanted, and above
    quant.STREAM_M (48) rows the s8 wgmma tile where TMA can read both
    operands (K a multiple of 16, N of 16, aligned bases), else the
    mma.sync tile."""
    if M <= 8 and K <= 8192:
        return "decode"
    if M <= 48:
        return "stream"
    return "wgmma" if aligned and K % 16 == 0 and N % 16 == 0 else "mma"


def compare_routed(torch, ops, x, wq, s, label, max_err, aligned=True):
    """compare(), with int8_matmul's two calls and w8a8_matmul's two each
    held to their own route."""
    M, K = x.shape
    N = wq.shape[1]
    want = int8_route_wanted(M, K, N, x.dtype == torch.bfloat16, aligned)
    want8 = w8a8_route_wanted(M, K, N, aligned)
    (out, taken), taken8 = routes_taken(ops.w8a8_matmul, lambda: routes_taken(
        ops.int8_matmul, lambda: compare(torch, ops, x, wq, s, label, max_err)))
    if taken != [want] * 2:
        fail(f"int8_matmul {label}: took {taken}, not {want}")
    if taken8 != [want8] * 2:
        fail(f"w8a8_matmul {label}: took {taken8}, not {want8}")
    return out


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
                xq, sx = compare_routed(torch, ops, x, wq, s, f"M={M} {name} x={xname}",
                                        max_err)
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
    for M, K, N, aligned in RAGGED + DECODE_RAGGED + PREFILL_RAGGED + WGMMA_RAGGED + W8A8_RAGGED:
        for xdt in (torch.bfloat16, torch.float32):
            x = torch.randn((M, K), generator=g, device=dev).to(xdt)
            wq, s = ops.quantize_int8(torch.randn((K, N), generator=g, device=dev) * 0.02)
            if not aligned:
                wq = misaligned(torch, wq)
            compare_routed(torch, ops, x, wq, s, f"ragged M={M} K={K} N={N} aligned={aligned}"
                           f" x={xdt}", max_err, aligned)
    print(f"  ragged shapes agree, each call on its route: "
          f"{[r[:3] for r in RAGGED + DECODE_RAGGED + PREFILL_RAGGED + WGMMA_RAGGED]}"
          f" + {[r[:3] for r in W8A8_RAGGED]}")
    report["decode_repeats"] = decode_repeat_checks(torch, ops, g)
    prefill_repeat_checks(torch, ops, g)
    report["wgmma_checks"] = wgmma_checks(torch, ops, g, max_err)
    report["w8a8_wgmma_checks"] = w8a8_wgmma_checks(torch, ops, g)
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
    """The prefill tiles are deterministic: the same M 1536 call twice gives
    the same bits (int8 with bf16 x and f32 or bf16 output on the wgmma
    route, f32 x on the mma.sync tile, w8a8 on the s8 wgmma route) at the
    decoder's four prefill shapes."""
    dev = torch.device("cuda")
    for name in ("qkv", "o", "fc1", "fc2"):
        K, N = SHAPES[name]
        x = torch.randn((PREFILL_M, K), generator=g, device=dev)
        wq, s = ops.quantize_int8(torch.randn((K, N), generator=g, device=dev) * 0.02)
        xq, sx = ops.quantize_int8_rows(x)
        for xin, odt in ((x.bfloat16(), torch.float32), (x.bfloat16(), torch.bfloat16),
                         (x, torch.float32)):
            (a, b), taken = routes_taken(ops.int8_matmul, lambda: [
                ops.int8_matmul(xin, wq, s, out_dtype=odt) for _ in range(2)])
            want = "wgmma" if xin.dtype == torch.bfloat16 else "mma"
            if taken != [want] * 2:
                fail(f"int8_matmul M={PREFILL_M} {name} x={xin.dtype}: took {taken}, not {want}")
            if not torch.equal(a, b):
                fail(f"int8_matmul M={PREFILL_M} {name} x={xin.dtype} out={odt}: two calls differ")
        (a, b), taken = routes_taken(ops.w8a8_matmul, lambda: [
            ops.w8a8_matmul(xq, sx, wq, s) for _ in range(2)])
        if taken != ["wgmma"] * 2:
            fail(f"w8a8_matmul M={PREFILL_M} {name}: took {taken}, not wgmma")
        if not torch.equal(a, b):
            fail(f"w8a8_matmul M={PREFILL_M} {name}: two calls differ")
    print(f"  prefill calls deterministic: two calls bitwise equal at the 4 shapes, M {PREFILL_M} "
          "(bf16 x and w8a8 on wgmma, f32 x on the mma.sync tile)")


def wgmma_checks(torch, ops, g, max_err):
    """The wgmma tile at its edges (WGMMA_RAGGED) with each tile of
    quant._WGMMA_TILES forced, f32 and bf16 output, against the plain twin;
    then one planted fault the check must flag: the decoder's qkv product
    at M 1536 run on K - 64 rows (the kernel's last K stage dropped) and
    held against the whole product.  Returns the tiles checked and the
    fault's error beside its limit."""
    dev = torch.device("cuda")
    plan = ops.quant._prefill_wgmma_plan
    try:
        for M, K, N, _ in WGMMA_RAGGED:
            x = torch.randn((M, K), generator=g, device=dev).bfloat16()
            wq, s = ops.quantize_int8(torch.randn((K, N), generator=g, device=dev) * 0.02)
            for tile in ops.quant._WGMMA_TILES:
                ops.quant._prefill_wgmma_plan = lambda *a, tile=tile: tile
                for odt in (torch.float32, torch.bfloat16):
                    got, taken = routes_taken(ops.int8_matmul,
                                              lambda: ops.int8_matmul(x, wq, s, out_dtype=odt))
                    if taken != ["wgmma"]:
                        fail(f"int8_matmul tile {tile} M={M} K={K} N={N}: took {taken}")
                    e = check_int8(torch, got, ops.int8_matmul_plain(x, wq, s, out_dtype=odt),
                                   f"wgmma tile {tile} M={M} K={K} N={N}")
                    if odt == torch.float32:
                        max_err["int8_matmul"] = max(max_err["int8_matmul"], e)
    finally:
        ops.quant._prefill_wgmma_plan = plan
    K, N = SHAPES["qkv"]
    x = torch.randn((PREFILL_M, K), generator=g, device=dev).bfloat16()
    wq, s = ops.quantize_int8(torch.randn((K, N), generator=g, device=dev) * 0.02)
    want = ops.int8_matmul_plain(x, wq, s, out_dtype=torch.float32)
    cut, taken = routes_taken(ops.int8_matmul, lambda: ops.int8_matmul(
        x[:, :K - 64].contiguous(), wq[:K - 64].contiguous(), s, out_dtype=torch.float32))
    d = (cut - want).abs()
    lim = 1e-3 + 1e-4 * want.abs()
    fault = dict(max_abs_err=d.max().item(), outputs_past_limit=int((d > lim).sum()),
                 route=taken)
    if taken != ["wgmma"] or not fault["outputs_past_limit"]:
        fail(f"int8 planted fault (the last K stage dropped) passed the check: {fault}")
    print(f"  the wgmma tile agrees at its edges {[c[:3] for c in WGMMA_RAGGED]} with each of "
          f"its tiles {list(ops.quant._WGMMA_TILES)}; planted fault flagged: the last K stage "
          f"dropped gives max |d| {fault['max_abs_err']:.4g}, {fault['outputs_past_limit']} "
          f"outputs past the limit")
    return dict(tiles=[list(t) for t in ops.quant._WGMMA_TILES],
                shapes=[list(c[:3]) for c in WGMMA_RAGGED], planted_fault=fault)


def forced_w8a8(ops, tile):
    """A context in which every w8a8 prefill call takes ``tile`` of
    quant._W8A8_TILES, or, for tile "mma", the mma.sync route."""
    import contextlib

    @contextlib.contextmanager
    def ctx():
        q = ops.quant
        saved = q._w8a8_wgmma_plan, q._w8a8_prefill_route
        if tile == "mma":
            q._w8a8_prefill_route = lambda *a: "mma"
        else:
            q._w8a8_wgmma_plan = lambda *a: tile
        try:
            yield
        finally:
            q._w8a8_wgmma_plan, q._w8a8_prefill_route = saved

    return ctx()


def w8a8_wgmma_checks(torch, ops, g):
    """The s8 wgmma tile at its edges (W8A8_RAGGED) with each tile of
    quant._W8A8_TILES forced and with the "mma" route forced, f32 and bf16
    output, each bitwise equal to the plain twin (the sums are exact) and
    held to its route; the same call twice bitwise equal; then one planted
    fault the check must flag: the decoder's qkv product at M 1536 run on
    K - 128 rows (the kernel's last K stage dropped) and held against the
    whole product.  Returns the tiles checked and the fault's outputs that
    differ."""
    dev = torch.device("cuda")
    tiles = list(ops.quant._W8A8_TILES) + ["mma"]
    for M, K, N, _ in W8A8_RAGGED:
        xq, sx = ops.quantize_int8_rows(torch.randn((M, K), generator=g, device=dev))
        wq, s = ops.quantize_int8(torch.randn((K, N), generator=g, device=dev) * 0.02)
        for odt in (torch.float32, torch.bfloat16):
            want = ops.w8a8_matmul_plain(xq, sx, wq, s, out_dtype=odt)
            for tile in tiles:
                with forced_w8a8(ops, tile):
                    (a, b), taken = routes_taken(ops.w8a8_matmul, lambda: [
                        ops.w8a8_matmul(xq, sx, wq, s, out_dtype=odt) for _ in range(2)])
                route = "mma" if tile == "mma" else "wgmma"
                if taken != [route] * 2:
                    fail(f"w8a8_matmul tile {tile} M={M} K={K} N={N}: took {taken}")
                check_w8a8(torch, a, want, f"tile {tile} M={M} K={K} N={N}")
                if not torch.equal(a, b):
                    fail(f"w8a8_matmul tile {tile} M={M} K={K} N={N}: two calls differ")
    K, N = SHAPES["qkv"]
    xq, sx = ops.quantize_int8_rows(torch.randn((PREFILL_M, K), generator=g, device=dev))
    wq, s = ops.quantize_int8(torch.randn((K, N), generator=g, device=dev) * 0.02)
    want = ops.w8a8_matmul_plain(xq, sx, wq, s)
    cut, taken = routes_taken(ops.w8a8_matmul, lambda: ops.w8a8_matmul(
        xq[:, :K - 128].contiguous(), sx, wq[:K - 128].contiguous(), s))
    fault = dict(outputs_that_differ=int((cut != want).sum()), route=taken,
                 max_abs_err=(cut - want).abs().max().item())
    if taken != ["wgmma"] or not fault["outputs_that_differ"]:
        fail(f"w8a8 planted fault (the last K stage dropped) passed the check: {fault}")
    print(f"  the s8 wgmma tile agrees bitwise at its edges {[c[:3] for c in W8A8_RAGGED]} with "
          f"each of {tiles} forced, two calls bitwise equal; planted fault flagged: the last K "
          f"stage dropped changes {fault['outputs_that_differ']} outputs")
    return dict(tiles=[list(t) if t != "mma" else t for t in tiles],
                shapes=[list(c[:3]) for c in W8A8_RAGGED], planted_fault=fault)


def stream_ragged(stream_m):
    """(M, K, N, weight 16-byte aligned): the stream's edges, at M 9 to
    ``stream_m`` (quant.STREAM_M) and at most 8 rows with K past the decode
    kernel's 8192: K not a multiple of the chunk or of 16 (x rows that are
    not whole 16-byte chunks), N not a multiple of 128 or 16 and N 50 (16
    splits, the largest cluster), misaligned weights; and M 63, past
    ``stream_m``, on the prefill tile."""
    return ((9, 8193, 4096, True), (17, 14336, 4097, True), (33, 8193, 4097, False),
            (40, 16385, 50, True), (stream_m, 14336, 4096, True), (63, 8193, 4097, True),
            (8, 14336, 50, True), (1, 16385, 4096, False))


def check_routes(ops, label, cases):
    """Fails unless each (M, K, N) of ``cases`` takes its route
    (quant._route)."""
    for M, K, N, want in cases:
        got = ops.quant._route(M, N, K)
        if got != want:
            fail(f"{label} M={M} K={K} N={N}: routed to {got}, not {want}")


def stream_checks(torch, ops, g, max_err):
    """The stream against both plain twins at its ragged shapes
    (stream_ragged), f32 and bf16 x and output, w8a8 bitwise; then the same
    call twice gives the same bits (int8 with bf16 x and f32 or bf16
    output, f32 x, w8a8).  Returns the shapes checked."""
    dev = torch.device("cuda")
    cases = stream_ragged(ops.quant.STREAM_M)
    for M, K, N, aligned in cases:
        x = torch.randn((M, K), generator=g, device=dev)
        wq, s = ops.quantize_int8(torch.randn((K, N), generator=g, device=dev) * 0.02)
        if not aligned:
            wq = misaligned(torch, wq)
        for xdt in (torch.bfloat16, torch.float32):
            compare(torch, ops, x.to(xdt), wq, s, f"stream M={M} K={K} N={N} "
                    f"aligned={aligned} x={xdt}", max_err)
        xq, sx = ops.quantize_int8_rows(x)
        for xin, odt in ((x.bfloat16(), torch.float32), (x.bfloat16(), torch.bfloat16),
                         (x, torch.float32)):
            a = ops.int8_matmul(xin, wq, s, out_dtype=odt)
            if not torch.equal(a, ops.int8_matmul(xin, wq, s, out_dtype=odt)):
                fail(f"int8_matmul stream M={M} K={K} N={N} x={xin.dtype} out={odt}: "
                     "two calls differ")
        if not torch.equal(ops.w8a8_matmul(xq, sx, wq, s), ops.w8a8_matmul(xq, sx, wq, s)):
            fail(f"w8a8_matmul stream M={M} K={K} N={N}: two calls differ")
        del x, wq, s, xq, sx
    print(f"  the stream (up to STREAM_M {ops.quant.STREAM_M} rows) agrees with both plain "
          f"twins at {[c[:3] for c in cases]}, f32 and bf16 x and output, w8a8 bitwise; two "
          "calls bitwise equal")
    return [list(c) for c in cases]


def decode_step_timing(torch, ops):
    """One decode step's 49 kernel calls at M = 8 with bf16 activations, over
    12 layers of distinct weights (so the weights stream from device memory
    as in the decoder): kernel, plain twin and library times beside the
    bound, per kernel (w8a8's library call is torch._int_mm at 32 rows, the
    integer product alone)."""
    return forward_timing(torch, ops, 8)


def forward_timing(torch, ops, M, shapes=SHAPES, depth=MODEL["depth"],
                   layer_names=("qkv", "o", "fc1", "fc2"), head_m=8):
    """The calls of one forward (49 for the TransformerLM): ``depth``
    layers of distinct weights (``layer_names``, (K, N) from ``shapes``) at
    M rows and the head at ``head_m`` rows (f32 out), bf16 x.  At M 1536 that is one
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
            x = torch.randn((head_m if name == "head" else M, K), generator=g,
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
    kernel, and an int8 or w8a8 decoder every prefill product on the wgmma
    route (path_routes).  Returns ({quant: [(tokens, scores), ...]}, the
    launch counts)."""
    import numpy as np

    from deepflows_tpu_torch import ops

    kernel_of = {"int8": ops.int8_matmul, "w8a8": ops.w8a8_matmul}
    served = {q: [] for q in decs}
    before_routes = {q: dict(kernel_of[q].routes) for q in decs if q in kernel_of}
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
    counts = {k.__name__: k.launches for k in ops.KERNELS}  # the main path ends here
    for quant, before in before_routes.items():
        path_routes(kernel_of[quant], before, f"{label}serving")
    return served, counts


# int8_matmul's and w8a8_matmul's launches by route on the serving paths
PATH_ROUTES = {"int8_matmul": {}, "w8a8_matmul": {}}


def path_routes(wrapper, before, path):
    """``wrapper``'s (int8_matmul's or w8a8_matmul's) launches by route
    since ``before`` on a main path of bf16 activations: every prefill
    launch must be on "wgmma" (none on "mma") and there must be some.
    Recorded in PATH_ROUTES."""
    name = wrapper.__name__
    by_route = {k: n - before[k] for k, n in wrapper.routes.items()}
    if by_route["mma"] or not by_route["wgmma"]:
        fail(f"{path}: {name} launched by route {by_route}: every prefill launch must take "
             "wgmma")
    PATH_ROUTES[name][path] = by_route
    print(f"  {path}: {name} launches by route {by_route} (every prefill on wgmma)")
    return by_route


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
CE_OFFSET = (300, 1024, 1000)  # bf16 x viewed 2 bytes off: both directions on mma.sync
ADAM_RAGGED = (1, 3, 4095, 4096, 4097, 10000, 12345)
# bf16 CE forward cases beside the slice, each held to the route it must
# take (ops/fused_ce.py _fwd_route): (N, D, V, b's dtype, x's layout, route);
# "offset" views x 2 bytes off a 16-byte boundary, which TMA cannot read
CE_FWD_CASES = ((8191, 1024, 8192, "bf16", "contiguous", "wgmma"),
                (300, 1024, 1000, "bf16", "contiguous", "wgmma"),
                (300, 200, 8200, "bf16", "contiguous", "wgmma"),
                (8191, 1000, 8190, "bf16", "contiguous", "wgmma"),
                (300, 1000, 1000, "f32", "contiguous", "wgmma"),
                (300, 1024, 8192, "bf16", "offset", "mma"),
                (8191, 1000, 8190, "bf16", "offset", "mma"),
                (300, 1001, 1001, "bf16", "contiguous", "mma"))
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


def ce_case(torch, ops, g, N, D, V, dt, bdt, label, layout="contiguous"):
    """Forward and backward kernel against the plain twins on one case; the
    plain backward is fed the kernel's lse.  The first three targets are
    the last vocab column, V + 3 and -1: the last two must cost exactly lse
    and add no one-hot term to the gradients; "offset" views x 2 bytes off
    a 16-byte boundary.  Fails past the limits (loss and lse at TOL["f32"]
    in both dtypes, the gradients at the dtype's TOL).  Returns the
    operands, the plain backward and the errors."""
    dev = torch.device("cuda")
    x = (torch.randn((N, D), generator=g, device=dev) * 0.5).to(dt)
    if layout == "offset":
        x = torch.cat([x.new_zeros(1), x.reshape(-1)])[1:].view(N, D)
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


def ce_routed(torch, ops, g, case, dt, label, layout="contiguous", bdt=None):
    """ce_case at (N, D, V) = case, its forward and its backward each held
    to the route _fwd_route and _bwd_route give it: f32, or in bf16 wgmma at
    D a multiple of 8 with x's base 16-byte aligned (any V: w is staged)
    and mma.sync otherwise (D 257 of CE_D_EDGES, an offset x).  Returns
    ce_case's result."""
    (res, fwd), bwd = routes_taken(ops.fused_linear_ce_bwd, lambda: routes_taken(
        ops.fused_linear_ce_fwd,
        lambda: ce_case(torch, ops, g, *case, dt, bdt or dt, label, layout)))
    want = ("f32" if dt == torch.float32 else "mma" if case[1] % 8 or layout == "offset"
            else "wgmma")
    if fwd != [want] or bwd != [want]:
        fail(f"fused_linear_ce {label}: the forward took {fwd} and the backward {bwd}, not "
             f"{want}")
    return res


def ce_planted_faults(ops, operands, want):
    """Shows that the bf16 check of the slice case catches two faults of the
    backward on its wgmma route: dx of a run on the first V - 64 columns of
    w and b (one vocab step fewer), held by row against the full reference,
    and the backward fed an lse off by FAULT_SHIFT.  Fails unless ce_case's
    limits flag both; returns each fault's errors beside the global
    measure."""
    x, w, b, t, lse, gr = operands
    V = w.shape[1]
    before = dict(ops.fused_linear_ce_bwd.routes)
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
    routes = {k: n - before[k] for k, n in ops.fused_linear_ce_bwd.routes.items() if n - before[k]}
    if routes != {"wgmma": 2}:
        fail(f"the CE planted faults ran the backward on {routes}, not wgmma")
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
        ce_ops, ce_want, ce_e = ce_routed(torch, ops, g, (N, E, V), dt, f"slice {name}")
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
            str(c): ce_routed(torch, ops, g, c, dt, f"{c} {name}")[2]
            for c in CE_RAGGED + tuple(ce_edges)}
        if dt == torch.bfloat16:  # x 2 bytes off: both directions on mma.sync
            report["ce_cases_bf16"][f"{CE_OFFSET} offset"] = ce_routed(
                torch, ops, g, CE_OFFSET, dt, f"{CE_OFFSET} bf16 offset", "offset")[2]
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
    ce_routed(torch, ops, g, (130, 1000, 97), torch.bfloat16, "f32 bias", bdt=torch.float32)
    ce_faults = ce_planted_faults(ops, ce_ops, ce_want)
    x, w, b, t, clse, gr = ce_ops  # the bf16 slice case: two calls give the same bits
    (one, two), bwd_route = routes_taken(ops.fused_linear_ce_bwd, lambda: [
        ops.fused_linear_ce_bwd(x, w, b, t, clse, gr) for _ in range(2)])
    ce_same = all(torch.equal(p, q) for p, q in zip(one, two))
    if not ce_same or bwd_route != ["wgmma"] * 2:
        fail(f"fused_linear_ce_bwd: two calls on the slice's inputs differ ({bwd_route})")
    report["ce_planted_faults"], report["ce_bitwise_equal"] = ce_faults, ce_same
    cf = report["ce_fwd"] = ce_fwd_checks(torch, ops, g, (x, w, b, t))
    adam_ops, err["fused_adam"] = adam_case(torch, ops, g, shapes, ADAM["weight_decay"], "slice")
    for wd in (0.0, 0.01):
        adam_case(torch, ops, g, [(n,) for n in ADAM_RAGGED], wd, f"ragged wd={wd}")
    n_flash = len(FLASH_RAGGED) + len(FLASH_MISALIGNED) + len(FLASH_DOUT_MISALIGNED) + 2
    print(f"  flash {n_flash} shapes, CE {len(CE_RAGGED) + len(CE_D_EDGES) + 3} "
          f"shapes, Adam {len(shapes)} + {len(ADAM_RAGGED)} tensors agree with their plain twins "
          f"in f32 and bf16; max abs err (slice, bf16): {err}")

    def fmt(e):
        return ", ".join(f"{n} {r:.3g}" for n, (r, _) in e.items())

    worst = {n: max(e[n][0] for e in report["ce_cases_bf16"].values()) for n in ce_e}
    print(f"  CE bf16, relative errors (limits: loss and lse {TOL['f32']}, the rest "
          f"{TOL['bf16']}; dx by row, dw by column, db by element): slice {fmt(ce_e)}; worst of "
          f"{len(report['ce_cases_bf16'])} other shapes (D up to {CE_D_EDGES[-1][1]}) "
          + ", ".join(f"{n} {v:.3g}" for n, v in worst.items())
          + f"; two slice-shape backward calls ({bwd_route[0]} route) bitwise equal: {ce_same}")
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
    # (operations, bytes) of one call, as each wrapper states them: the CE
    # backward's three products are one logits recompute, dx and dw,
    # though the kernel's two roles each recompute
    costs = {
        "flash_attention_fwd": ops.flash_attention_fwd.cost(q, k, v, True),
        "flash_attention_bwd": ops.flash_attention_bwd.cost(q, k, v, o, lse, do, True),
        "fused_linear_ce_fwd": ops.fused_linear_ce_fwd.cost(x, w, b, t),
        "fused_linear_ce_bwd": ops.fused_linear_ce_bwd.cost(x, w, b, t, clse, gr),
        "fused_adam": ops.fused_adam.cost(ps, gs, vs, ss, hyper),
    }
    out = {}
    for name, (kern, plain, lib) in runs.items():
        reps = 3 if name == "fused_linear_ce_bwd" else 10
        r = dict(ms=event_ms(kern, reps, flush), plain_ms=event_ms(plain, reps, flush),
                 library_ms=event_ms(lib, reps, flush), max_abs_err=err[name])
        n_ops, n_bytes = costs[name]
        r["bound_ms"], r["bound_by"] = bound_ms(n_bytes, n_ops, "bf16")
        out[name] = r
    cbw = out["fused_linear_ce_bwd"]
    cbw["bwd_route"] = bwd_route[0]
    cbw["plan"] = list(ops.fused_ce._bwd_wgmma_plan(N, E, V))  # (C, 128, stages)
    cbw["tflops"] = costs["fused_linear_ce_bwd"][0] / cbw["ms"] / 1e9  # the function's 3 products
    cfw = out["fused_linear_ce_fwd"]
    cfw["fwd_route"] = cf["slice_route"]
    cfw["plan"] = list(ops.fused_ce._fwd_plan(N, V, cf["slice_route"]))  # (splits, tiles a split)
    cfw["tflops"] = costs["fused_linear_ce_fwd"][0] / cfw["ms"] / 1e9
    fwd, bwd = out["flash_attention_fwd"], out["flash_attention_bwd"]
    fwd["fwd_route"], fwd["tflops"] = froute, costs["flash_attention_fwd"][0] / fwd["ms"] / 1e9
    bwd["bwd_route"], bwd["tflops"] = broute, costs["flash_attention_bwd"][0] / bwd["ms"] / 1e9
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
    r["bound_ms"], r["bound_by"] = cost_bound(ops.fused_adam_sr, ps, gs, vs, ss, hyper, step, idx)
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


def mnist_like():
    """MLP_STEPS batches of B MLP_B of synthetic MNIST: pixels uniform in
    [0, 1) from numpy's default_rng(3), labels from a fixed random linear
    teacher."""
    import numpy as np

    rng = np.random.default_rng(3)
    teacher = rng.standard_normal((784, 10)).astype(np.float32)
    xs = rng.random((MLP_STEPS, MLP_B, 784), dtype=np.float32)
    return xs, (xs @ teacher).argmax(-1).astype(np.int64)


def eager_phase(torch, dt, report):
    """Main paths 4 and 5: models.MLP trained eagerly under
    config.use_pallas (its three Linear layers as linear_fused), then a
    bias-free twin of its widths (every product, forward and backward, as
    matmul); each run against the same run on a CPU copy."""
    import numpy as np

    from deepflows_tpu_torch import config, nn, ops, optim
    from deepflows_tpu_torch.models import MLP

    xs, ys = mnist_like()

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
    routed = (ops.flash_attention_fwd, ops.flash_attention_bwd, ops.fused_linear_ce_fwd,
              ops.fused_linear_ce_bwd)
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
    r["fwd_bound_ms"], _ = cost_bound(ops.flash_attention_fwd, q, k, v, True, None, window)
    r["bwd_bound_ms"], _ = cost_bound(ops.flash_attention_bwd, q, k, v, o, lse, do, True, None,
                                      window)
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
            xq, sx = compare_routed(torch, ops, x, wq, s, f"Mistral M={M} {name}", max_err)
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
    check_routes(ops, "Mistral", [(M, K, N, "stream" if name == "down" else "decode")
                                  for M in (1, 8) for name, (K, N) in MISTRAL_SHAPES.items()]
                 + [(M, K, N, "prefill") for M in FAMILY_M[1:]
                    for K, N in MISTRAL_SHAPES.values()])
    out["stream_ragged"] = stream_checks(torch, ops, g, max_err)
    free_card(torch)
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
    from deepflows_tpu_torch.ops.flash_attention import visible_pairs

    D, Hd = cfg["dim"], int(cfg["dim"] * cfg["mlp_ratio"])
    kv = cfg["num_kv_heads"] * D // cfg["num_heads"]
    ffn = 3 * D * Hd * (cfg["n_experts"] if moe else 1)
    weights = cfg["depth"] * (2 * D * D + 2 * D * kv + ffn) + D * cfg["vocab_size"]
    attn = 3 * cfg["depth"] * 4 * visible_pairs(L, L, True, cfg.get("window")) * D
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
    r["bound_ms"], r["bound_by"] = cost_bound(ops.fused_adam, ps, gs, vs, ss, hyper)
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
            compare_routed(torch, ops, x, wq, s, f"merged Mistral M={M} {name}", max_err)
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


SERVE_CFG = dict(MISTRAL, depth=8, max_len=2048)  # the serving slice's model
SERVE_ENGINE = dict(slots=8, chunk=8, top_k=50)
SERVE_N, SERVE_THREADS, SERVE_SYS = 32, 4, 512  # requests, submitting threads, system prompt
SERVE_SAMPLE = dict(temperature=0.8, top_p=0.9)
SERVE_PAGED = dict(paged_blocks=8 * 2048 // 16 // 2, block_size=16)  # half the dense positions
SERVE_MODES = (None, "int8", "w8a8")
SPEC_RUN = dict(gamma=4, B=8, prompt=64, new=128)
SERVING_M = (40, 2048)  # the verify forward's rows (8 x (gamma + 1)), an admission prefill's
GRPC_CALLS = dict(threads=4, each=2, prompt=64, new=32)
# after the traffic, a burst of 8 greedy requests of 1024 + 256 positions
# (80 blocks of 16 each): the paged pool (512 blocks) holds 6 at once
SERVE_BURST = dict(n=8, prompt=1024, new=256)
# where two greedy streams part, the one-shot run's f32 top-2 logit margin
# there must be below this: a near tie that either rounding may flip
TIE_MARGIN = 0.05


def serving_kernel_phase(torch, ops, report, max_err):
    """int8_matmul and w8a8_matmul against their plain twins at Mistral's
    five matrices at the serving slice's new row counts: M 40 (the
    speculative verify forward, B 8 x (gamma + 1)) and M 2048 (an
    admission prefill, B 1 x max_len); M 8 (the engine's step) is phase
    25's.  Then a verify forward's and an admission prefill's 33 calls
    timed beside their twins, library calls and bounds.  Returns the
    numbers; ``max_err`` gains the int8 kernels' errors."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(15)
    check_routes(ops, "serving Mistral", [(M, K, N, route) for M, route in
                                          zip(SERVING_M, ("stream", "prefill"))
                                          for K, N in MISTRAL_SHAPES.values()])
    for M in SERVING_M:
        for name, (K, N) in MISTRAL_SHAPES.items():
            x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
            wq, s = ops.quantize_int8(torch.randn((K, N), generator=g, device=dev) * 0.02)
            compare_routed(torch, ops, x, wq, s, f"serving Mistral M={M} {name}", max_err)
            del x, wq, s
        free_card(torch)
    print(f"  int8_matmul and w8a8_matmul agree with their plain twins at Mistral's "
          f"{len(MISTRAL_SHAPES)} matrices, M {SERVING_M}; M 8 at these shapes is phase 25's")
    layer = ("qkv", "o", "gate_up", "down")
    depth = SERVE_CFG["depth"]
    out = {}
    for key, M, head_m in (("verify", SERVING_M[0], SERVING_M[0]),
                           ("admission_prefill", SERVING_M[1], 1)):
        ms, bi, bw, wbytes = forward_timing(torch, ops, M, MISTRAL_SHAPES, depth, layer, head_m)
        out[key] = dict(ms, M=M, head_M=head_m, int8_bound_ms=bi[0], int8_bound_by=bi[1],
                        w8a8_bound_ms=bw[0], w8a8_bound_by=bw[1], weight_bytes=wbytes)
        print(f"  a {key.replace('_', ' ')}'s {4 * depth + 1} calls (M={M}, head M={head_m}, "
              "bf16 x): " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
              + f"; bound int8 {bi[0]:.4f} ms ({bi[1]}), w8a8 {bw[0]:.4f} ms ({bw[1]})")
        free_card(torch)
    report["serving_kernels"] = out
    return out


def serving_traffic(V):
    """The engine's traffic, from a seed: SERVE_N requests of new_tokens
    32-256; half start with the SERVE_SYS-token system prompt (the first
    of them is the system prompt alone), the rest are prompts of 16-1024
    tokens; a quarter sampled (SERVE_SAMPLE), a quarter greedy with an
    eos_id (chosen from the one-shot run), the rest greedy; each with its
    submitting thread and the pause before it."""
    import numpy as np

    rng = np.random.default_rng(0)
    sys_prompt = rng.integers(0, V, SERVE_SYS)
    kinds = rng.permutation(["greedy"] * (SERVE_N // 2) + ["eos"] * (SERVE_N // 4)
                            + ["sample"] * (SERVE_N // 4))
    prefixed = rng.permutation([True] * (SERVE_N // 2) + [False] * (SERVE_N // 2))
    reqs, first = [], True
    for i in range(SERVE_N):
        if prefixed[i]:
            sfx = 0 if first else int(rng.integers(1, SERVE_SYS + 1))
            first = False
            prompt = np.concatenate([sys_prompt, rng.integers(0, V, sfx)])
        else:
            prompt = rng.integers(0, V, int(rng.integers(16, 1025)))
        reqs.append(dict(prompt=prompt.astype(np.int64), new=int(rng.integers(32, 257)),
                         kind=str(kinds[i]), prefixed=bool(prefixed[i]),
                         thread=i % SERVE_THREADS, pause=float(rng.uniform(0.0, 0.03))))
    return sys_prompt.astype(np.int64), reqs


def one_shot_margin(torch, dec, prompt, tokens, j):
    """The f32 top-1 minus top-2 logit margin of ``dec``'s prediction of
    generated token ``j`` after ``prompt`` + ``tokens[:j]`` (a B 1
    prefill in the decoder's mode)."""
    seq = list(prompt) + list(tokens[:j])
    pad = torch.zeros((1, dec.lm.max_len), dtype=torch.long)
    pad[0, :len(seq)] = torch.as_tensor(seq)
    with torch.inference_mode():
        logits = dec._prefill(dec._prepared(), pad.cuda(), len(seq))[2][0]
    top = torch.topk(logits, 2).values
    return (top[0] - top[1]).item()


def parted(torch, dec, prompt, got, want, label):
    """Greedy streams ``got`` and ``want`` (``dec``'s one-shot tokens) held
    by the comparison rule: equal until they part, and where they part the
    one-shot run's margin below TIE_MARGIN.  Returns the tokens compared
    (those before the parting, or all) and the margin where they parted."""
    n = min(len(got), len(want))
    diff = [j for j in range(n) if got[j] != want[j]]
    if not diff:
        return n, None
    j = diff[0]
    m = one_shot_margin(torch, dec, prompt, want, j)
    if not m < TIE_MARGIN:
        fail(f"{label}: token {j} is {got[j]}, the one-shot run's {want[j]}, at a top-2 margin "
             f"of {m:.4f} (not a near tie)")
    return j, m


def forced_check(torch, dec, prompt, toks, label):
    """The plain decoder ``dec`` fed a stream's own tokens: after a B-row
    prefill of ``prompt`` (B, P), its one-token steps (the eager twin of
    its graphed step) at each of ``toks`` (B, n) must pick the stream's
    next token, or see top-2 logits closer than TIE_MARGIN there.  Every
    token is checked.  Returns (tokens it picked, tokens excused as near
    ties)."""
    B, P = prompt.shape
    L = dec.lm.max_len
    oks, ties = [], []
    with torch.inference_mode():
        params = dec._prepared()
        pad = torch.zeros((B, L), dtype=torch.long)
        pad[:, :P] = torch.as_tensor(prompt)
        kc, vc, logits = dec._prefill(params, pad.cuda(), P)
        positions = torch.arange(L, device="cuda")
        t = torch.as_tensor(toks, device="cuda")
        for j in range(t.shape[1]):
            top = torch.topk(logits, 2)
            oks.append(top.indices[:, 0] == t[:, j])
            ties.append(top.values[:, 0] - top.values[:, 1] < TIE_MARGIN)
            if j + 1 < t.shape[1]:
                pos = torch.tensor(P + j, device="cuda")
                logits = dec._forward_one(params, kc, vc, t[:, j], pos, positions)[0]
        ok, tie = torch.stack(oks, 1).cpu(), torch.stack(ties, 1).cpu()
    bad = ~(ok | tie)
    if bad.any():
        b, j = (int(v) for v in bad.nonzero()[0])
        fail(f"{label}: row {b} token {j} is not the plain decoder's pick on the stream's own "
             "tokens, and not a near tie")
    return int(ok.sum()), int((~ok).sum())


def engine_run(torch, eng, reqs, eos):
    """The traffic through ``eng`` from SERVE_THREADS threads, each
    submitting its requests with their pauses.  Returns (each request's
    tokens, latencies s, the wall s from the first submit to the last
    finish)."""
    import threading

    handles = [None] * len(reqs)
    errors = []

    def submitter(t):
        try:
            for i, r in enumerate(reqs):
                if r["thread"] != t:
                    continue
                time.sleep(r["pause"])
                kw = SERVE_SAMPLE if r["kind"] == "sample" else {}
                handles[i] = eng.submit(r["prompt"], r["new"], eos_id=eos.get(i), **kw)
        except Exception as e:  # noqa: BLE001 - re-raised below
            errors.append(e)

    threads = [threading.Thread(target=submitter, args=(t,)) for t in range(SERVE_THREADS)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    outs = [h.result(timeout=600)[len(r["prompt"]):] for h, r in zip(handles, reqs)]
    t0 = min(h.t_submit for h in handles)
    wall = max(h.t_done for h in handles) - t0
    return outs, [h.t_done - h.t_submit for h in handles], wall


def engine_checks(torch, eng, reqs, outs, eos, V, label):
    """Every request finished in the vocabulary at its length, or cut at
    its eos; the prefix hits, misses and admissions tally with the
    traffic; every chunk after a key's first step replayed its graph."""
    for i, (r, o) in enumerate(zip(reqs, outs)):
        if o.min() < 0 or o.max() >= V:
            fail(f"{label} request {i}: token outside the vocabulary")
        e = eos.get(i)
        if len(o) != r["new"] and not (e is not None and o[-1] == e
                                       and e not in o[:-1].tolist()):
            fail(f"{label} request {i}: {len(o)} tokens of {r['new']}, not cut at its eos")
    hits = sum(r["prefixed"] for r in reqs)
    st = eng.stats
    want = dict(admit_prefill=len(reqs) - hits, admit_full_hit=1, admit_suffix=hits - 1)
    if (eng.prefix_hits, eng.prefix_misses) != (hits, len(reqs) - hits) or any(
            st[k] != v for k, v in want.items()):
        fail(f"{label}: prefix hits {eng.prefix_hits} / misses {eng.prefix_misses}, admissions "
             f"{ {k: st[k] for k in want} }; the traffic has {hits} hits")
    graphs = eng._graphs._graphs
    replays = sum(c.replays for c in graphs.values())
    if set(eng._steps) != set(graphs) or replays != st["chunks"] * eng.chunk - len(graphs):
        fail(f"{label}: {replays} replays of {len(graphs)} graphs for {st['chunks']} chunks")
    return replays


def engine_numbers(torch, eng, outs, lat, wall, label):
    """Requests/s, generated tokens/s, latency percentiles, host ms a chunk,
    a chunk's device ms (its greedy graph replayed ``chunk`` times, queued
    while the stream spins) and the busy share, admission ms by kind, the
    cache's memory, and one replay's device time by kernel group."""
    import numpy as np

    st = eng.stats
    key = eng._key(False) if eng._key(False) in eng._graphs else eng._key(True)
    graph = eng._graphs[key]  # the greedy step's, or the sampling step's
    i = eng._st.i  # the output column a replay writes: back to 0 before each chunk

    def step():
        i.zero_()
        graph.replay()

    with eng._lock:
        chunk_dev = event_ms(lambda: [i.zero_()] + [graph.replay() for _ in range(eng.chunk)], 5)
        profile = replay_profile(torch, step)
    n = dict(requests_per_s=len(outs) / wall, tokens_per_s=sum(len(o) for o in outs) / wall,
             wall_s=wall, latency_p50_s=float(np.percentile(lat, 50)),
             latency_p99_s=float(np.percentile(lat, 99)), chunks=st["chunks"],
             chunk_wall_ms=st["chunk_s"] / st["chunks"] * 1e3, chunk_device_ms=chunk_dev,
             admit_prefill_ms=st["admit_prefill_s"] / max(st["admit_prefill"], 1) * 1e3,
             admit_suffix_ms=st["admit_suffix_s"] / max(st["admit_suffix"], 1) * 1e3,
             cache_bytes=eng.cache_bytes(), backpressure=st["backpressure"],
             step_by_kernel_group=profile)
    n["busy_share"] = n["chunk_device_ms"] / n["chunk_wall_ms"]
    print(f"  {label}: {n['requests_per_s']:.2f} requests/s, {n['tokens_per_s']:.1f} generated "
          f"tok/s, latency p50 {n['latency_p50_s']:.3f} s p99 {n['latency_p99_s']:.3f} s; a chunk "
          f"{n['chunk_wall_ms']:.3f} ms wall, {n['chunk_device_ms']:.3f} ms device (busy "
          f"{100 * n['busy_share']:.1f}%); admission {n['admit_prefill_ms']:.2f} ms prefill, "
          f"{n['admit_suffix_ms']:.2f} ms suffix; cache {n['cache_bytes'] / 1e6:.1f} MB; "
          f"{n['backpressure']} admissions refused for want of blocks")
    print("    a step by kernel group (torch.profiler, ms, kernels): " + ", ".join(
        f"{k} {v['ms']:.4f} ({v['kernels']:.0f})" for k, v in sorted(profile.items())))
    return n


def engine_phase(torch, report, lm, sys_prompt, reqs):
    """Main paths: the traffic through InflightEngine(SERVE_ENGINE) in each
    of SERVE_MODES, dense cache then paged (SERVE_PAGED), every chunk from
    its captured graph, each with its launch counts zeroed just before
    and read just after; greedy tokens against the one-shot graphed
    decoder (B 1, the requests one at a time) and the paged engine's
    against the dense engine's, by the comparison rule; a weight changed
    in place and refresh_params() move the tokens.  Returns {path: launch
    counts}."""
    import numpy as np

    from deepflows_tpu_torch import ops
    from deepflows_tpu_torch.models import InflightEngine, KVCacheDecoder

    V = SERVE_CFG["vocab_size"]
    per_forward = 4 * SERVE_CFG["depth"] + 1
    kernel_of = {"int8": ops.int8_matmul, "w8a8": ops.w8a8_matmul}
    greedy = [i for i, r in enumerate(reqs) if r["kind"] != "sample"]
    paths, rep = {}, {}
    for quant in SERVE_MODES:
        mode = str(quant)
        one = KVCacheDecoder(lm, compute_dtype=torch.bfloat16, quant=quant)
        want, t_one = {}, 0.0
        one.generate(reqs[0]["prompt"][None], 2)  # warm-up and capture
        for i in greedy:  # the one-shot decoder, one request at a time
            r = reqs[i]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            want[i] = one.generate(r["prompt"][None], r["new"])[0, len(r["prompt"]):]
            t_one += time.perf_counter() - t0
        one_tok_s = sum(reqs[i]["new"] for i in greedy) / t_one
        # an eos the greedy run emits, at a quarter to half of its budget
        eos = {i: int(want[i][reqs[i]["new"] // 4 + i % (reqs[i]["new"] // 4)])
               for i in greedy if reqs[i]["kind"] == "eos"}
        rep[mode] = {"one_shot_tokens_per_s": one_tok_s}
        dense_outs = dense_burst = None
        burst = np.random.default_rng(2).integers(
            0, V, (SERVE_BURST["n"], SERVE_BURST["prompt"])).astype(np.int64)
        for cache, kw in (("dense", {}), ("paged", SERVE_PAGED)):
            label = f"engine {cache} quant={mode}"
            eng = InflightEngine(lm, compute_dtype=torch.bfloat16, quant=quant,
                                 **SERVE_ENGINE, **kw)
            eng.register_prefix(sys_prompt)
            torch.cuda.synchronize()
            before_routes = dict(kernel_of[quant].routes) if quant in kernel_of else None
            ops.reset_launch_counts()  # the main path starts here
            outs, lat, wall = engine_run(torch, eng, reqs, eos)
            counts = {k.__name__: k.launches for k in ops.KERNELS}  # and ends here
            paths[f"engine_{cache}_{mode}"] = counts
            if quant in kernel_of:  # the admissions' prefills
                path_routes(kernel_of[quant], before_routes, label)
            replays = engine_checks(torch, eng, reqs, outs, eos, V, label)
            st = eng.stats
            forwards = st["admit_prefill"] + st["admit_suffix"] + st["chunks"] * eng.chunk
            for k in ops.KERNELS:
                n = per_forward * forwards if kernel_of.get(quant) is k else 0
                if counts[k.__name__] != n:
                    fail(f"{label}: {k.__name__} launched {counts[k.__name__]} times, expected "
                         f"{n} ({per_forward} x {forwards} forwards)")
            compared = total = 0
            margins = []
            for i in greedy:
                ref = want[i] if cache == "dense" else dense_outs[i]
                if i in eos and cache == "dense":
                    ref = ref[: list(ref).index(eos[i]) + 1]
                c, m = parted(torch, one, reqs[i]["prompt"], outs[i], ref, f"{label} request {i}")
                compared += c
                total += len(ref)
                if m is not None:
                    margins.append(m)
            if compared < total / 2:
                fail(f"{label}: only {compared} of {total} greedy tokens compared")
            print(f"  {label}: {SERVE_N} requests done; greedy tokens compared {compared} of "
                  f"{total} against the {'one-shot decoder' if cache == 'dense' else 'dense engine'}"
                  f" ({len(margins)} requests parted, at near ties {['%.4f' % m for m in margins]}); "
                  f"prefix hits {eng.prefix_hits}, misses {eng.prefix_misses}; {replays} graph "
                  f"replays; launches {({k: v for k, v in counts.items() if v})}")
            n = engine_numbers(torch, eng, outs, lat, wall, label)
            n.update(compared=compared, greedy_tokens=total, parted_margins=margins)
            refused = eng.stats["backpressure"]
            got = [h.result(timeout=600)[SERVE_BURST["prompt"]:]
                   for h in [eng.submit(p, SERVE_BURST["new"]) for p in burst]]
            n["burst_backpressure"] = eng.stats["backpressure"] - refused
            if cache == "dense":
                dense_burst = got
            else:
                c = sum(parted(torch, one, p, o, w, f"{label} burst")[0]
                        for p, o, w in zip(burst, got, dense_burst))
                if c < burst.size // SERVE_BURST["prompt"] * SERVE_BURST["new"] / 2:
                    fail(f"{label} burst: only {c} tokens compared with the dense engine's")
                if not n["burst_backpressure"]:
                    fail(f"{label}: the burst of {SERVE_BURST} met no backpressure")
                print(f"  {label}: the burst of {SERVE_BURST}: {n['burst_backpressure']} admissions "
                      f"refused for want of blocks ({refused} during the traffic); tokens "
                      f"compared {c} with the dense engine's")
            if cache == "dense":
                dense_outs = outs
                r = reqs[greedy[0]]  # a weight changed in place moves the tokens
                before = eng.generate(r["prompt"], 16)
                with torch.no_grad():
                    lm.head.weight.neg_()
                eng.refresh_params()
                after = eng.generate(r["prompt"], 16)
                with torch.no_grad():
                    lm.head.weight.neg_()
                eng.refresh_params()
                back = eng.generate(r["prompt"], 16)
                if np.array_equal(before, after) or not np.array_equal(before, back):
                    fail(f"{label}: refresh_params did not follow a weight changed in place")
                print(f"  {label}: a head negated in place and refresh_params() move the tokens; "
                      "put back, they return")
            eng.close()
            rep[mode][cache] = n
            del eng
            free_card(torch)
        print(f"  quant={mode}: one-shot decoder, the {len(greedy)} greedy requests one at a "
              f"time: {one_tok_s:.1f} tok/s; engine dense {rep[mode]['dense']['tokens_per_s']:.1f}"
              f", paged {rep[mode]['paged']['tokens_per_s']:.1f} tok/s (all {SERVE_N} requests)"
              f"; cache {rep[mode]['dense']['cache_bytes'] / 1e6:.1f} MB dense, "
              f"{rep[mode]['paged']['cache_bytes'] / 1e6:.1f} MB paged")
        del one
        free_card(torch)
    report["serving_engine"] = rep
    return paths


def layer_skip_draft(torch, dt, lm):
    """A depth-1 LlamaLM of the target's widths holding the target's
    embedding, first block, final norm and head."""
    from deepflows_tpu_torch.models import LlamaLM

    draft = family_model(torch, dt, LlamaLM, dict(SERVE_CFG, depth=1), 1, serve=True)
    state = {k: v for k, v in lm.state_dict().items()
             if not k.startswith("blocks.") or k.startswith("blocks.0.")}
    draft.load_state_dict(state)
    return draft


def speculative_phase(torch, dt, report, lm):
    """Main paths: SpeculativeDecoder(gamma 4) over the target with the
    layer-skip draft, B 8, prompt 64, +128: greedy with a dense and with an
    int8 target (launch counts zeroed just before and read just after:
    33 a target prefill and a verify round in int8), against the plain
    graphed generate until the rows part, then every token by the plain
    decoder fed the stream's own tokens (``forced_check``); one sampled run (temperature
    0.8), reproducible under its seed; the target as its own draft must
    accept 90% of its proposals.  Every round after the first replays the
    round's graph.  Tokens/s beside the plain decoder's.  Returns {path:
    launch counts}."""
    import numpy as np

    from deepflows_tpu_torch import ops
    from deepflows_tpu_torch.models import KVCacheDecoder, SpeculativeDecoder

    g, B, P, new = (SPEC_RUN[k] for k in ("gamma", "B", "prompt", "new"))
    V = SERVE_CFG["vocab_size"]
    per_forward = 4 * SERVE_CFG["depth"] + 1
    draft = layer_skip_draft(torch, dt, lm)
    prompt = np.random.default_rng(5).integers(0, V, (B, P)).astype(np.int64)
    paths, rep = {}, {}
    plain = {}
    for name, quant, d, temp in (("dense", None, draft, 0.0), ("int8", "int8", draft, 0.0),
                                 ("self_draft", None, lm, 0.0), ("sampled", None, draft, 0.8)):
        if quant not in plain:
            dec = KVCacheDecoder(lm, compute_dtype=torch.bfloat16, quant=quant)
            dec.generate(prompt, new)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            toks = dec.generate(prompt, new)[:, P:]
            plain[quant] = (dec, toks, B * new / (time.perf_counter() - t0))
        dec, want, plain_tok_s = plain[quant]
        spec = SpeculativeDecoder(lm, d, gamma=g, compute_dtype=torch.bfloat16, quant=quant)
        first = spec.generate(prompt, new, temperature=temp, seed=3)  # warm-up and capture
        torch.cuda.synchronize()
        ops.reset_launch_counts()  # the main path starts here
        t0 = time.perf_counter()
        out = spec.generate(prompt, new, temperature=temp, seed=3)
        secs = time.perf_counter() - t0
        counts = {k.__name__: k.launches for k in ops.KERNELS}  # and ends here
        st = dict(spec.last_stats)
        if name != "self_draft":
            paths[f"speculative_{name}"] = counts
        if out.shape != (B, P + new) or out.min() < 0 or out.max() >= V:
            fail(f"speculative {name}: output shape {out.shape} or a token outside the vocabulary")
        n_int8 = per_forward * (1 + st["rounds_run"]) if quant == "int8" else 0
        if counts["int8_matmul"] != n_int8 or sum(counts.values()) != n_int8:
            fail(f"speculative {name}: launches {counts}, expected int8_matmul {n_int8}")
        (key, lp), = spec._loops.items()
        if spec._graphs[key].replays < st["rounds_run"] * 2 - 1:
            fail(f"speculative {name}: {spec._graphs[key].replays} replays for "
                 f"{2 * st['rounds_run']} rounds")
        r = dict(st, tokens_per_s=B * new / secs, plain_tokens_per_s=plain_tok_s, seconds=secs)
        if temp > 0:
            if not np.array_equal(out, first):
                fail("speculative sampled: the same seed gave other tokens")
            print(f"  speculative sampled (temperature {temp}): reproducible under its seed")
        else:
            # equal until they part (the rows part at near ties: the verify
            # forward at M 40 rounds otherwise than the step at M 8), then
            # every token by the plain decoder fed the stream's own tokens
            before = sum(next((j for j in range(new) if out[b, P + j] != want[b, j]), new)
                         for b in range(B))
            picked, excused = forced_check(torch, dec, prompt, out[:, P:], f"speculative {name}")
            if picked < B * new / 2:
                fail(f"speculative {name}: only {picked} of {B * new} greedy tokens are the "
                     "plain decoder's picks")
            r.update(equal_before_parting=before, picked=picked, near_ties=excused)
            print(f"  speculative {name}: greedy tokens equal to the plain decoder's until the rows "
                  f"part: {before} of {B * new}; on the stream's own tokens the plain decoder "
                  f"picks {picked} and sees a near tie at the other {excused}")
        if name == "self_draft" and not st["acceptance_rate"] >= 0.9:
            fail(f"speculative self-draft accepted {st['acceptance_rate']:.3f} of its proposals")
        print(f"  speculative {name}: accepted {100 * st['acceptance_rate']:.1f}% of proposals, "
              f"{st['rounds']} rounds ({st['rounds_run']} replayed), {r['tokens_per_s']:.1f} tok/s;"
              f" the plain decoder {plain_tok_s:.1f} tok/s; launches "
              f"{({k: v for k, v in counts.items() if v})}")
        rep[name] = r
        del spec
        free_card(torch)
    report["serving_speculative"] = rep
    del plain, draft
    free_card(torch)
    return paths


def grpc_phase(torch, report, lm):
    """The model served through MyDLPWServicer on 127.0.0.1 (int8, an
    in-flight engine of SERVE_ENGINE) to GRPC_CALLS["threads"] concurrent
    clients, each sending Generate calls (prompt 64, +32 greedy): the
    tokens against the one-shot int8 decoder by the comparison rule."""
    import threading

    import numpy as np

    from deepflows_tpu_torch.models import KVCacheDecoder
    from deepflows_tpu_torch.serving import MyDLPWServicer, PredictClient

    V = SERVE_CFG["vocab_size"]
    c = GRPC_CALLS
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, V, (1, c["prompt"])).astype(np.int64)
               for _ in range(c["threads"] * c["each"])]
    server = MyDLPWServicer("127.0.0.1:0", model=lm, decode_dtype=torch.bfloat16,
                            decode_quant="int8", inflight_slots=SERVE_ENGINE["slots"],
                            inflight_chunk=SERVE_ENGINE["chunk"],
                            inflight_top_k=SERVE_ENGINE["top_k"])
    server.serve(wait=False)
    outs = [None] * len(prompts)
    errors = []
    try:
        addr = f"127.0.0.1:{server.port}"

        def client(t):
            try:
                cl = PredictClient(addr)
                for i in range(t, len(prompts), c["threads"]):
                    outs[i] = cl.generate(prompts[i], c["new"])
                cl.close()
            except Exception as e:  # noqa: BLE001 - re-raised below
                errors.append(e)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(t,)) for t in range(c["threads"])]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        if errors:
            raise errors[0]
        engine = server._service._engine
    finally:
        server.stop()
    if engine is None:
        fail("gRPC: the in-flight engine did not serve the Generate calls")
    one = KVCacheDecoder(lm, compute_dtype=torch.bfloat16, quant="int8")
    compared = 0
    for i, (p, o) in enumerate(zip(prompts, outs)):
        if o.shape != (1, c["prompt"] + c["new"]) or not (o[:, :c["prompt"]] == p).all():
            fail(f"gRPC call {i}: shape {o.shape} or prompt changed")
        want = one.generate(p, c["new"])[0, c["prompt"]:]
        compared += parted(torch, one, p[0], o[0, c["prompt"]:], want, f"gRPC call {i}")[0]
    total = len(prompts) * c["new"]
    if compared < total / 2:
        fail(f"gRPC: only {compared} of {total} greedy tokens compared")
    r = dict(calls=len(prompts), wall_s=wall, tokens_per_s=total / wall, compared=compared)
    print(f"  gRPC: {len(prompts)} Generate calls from {c['threads']} clients in {wall:.3f} s "
          f"({r['tokens_per_s']:.1f} tok/s), tokens compared {compared} of {total} against the "
          f"one-shot int8 decoder")
    report["serving_grpc"] = r
    del one
    free_card(torch)


def serving_phases(torch, dt, ops, report, max_err, phase, card):
    """The serving slice: its kernel checks, then the in-flight engine
    (dense and paged, each quant mode), the speculative decoder and the
    gRPC server over LlamaLM at Mistral-7B widths, depth 8, max_len 2048,
    bf16.  Returns {path: launch counts} and the kernel phase's numbers."""
    phase("serving kernel phase (int8 kernels vs plain twins at M 40 and 2048):")
    sk = serving_kernel_phase(torch, ops, report, max_err)
    from deepflows_tpu_torch.models import LlamaLM

    lm = family_model(torch, dt, LlamaLM, SERVE_CFG, 0, serve=True)
    print(f"model: LlamaLM {SERVE_CFG}, rms eps {RMS_EPS}, "
          f"{sum(p.numel() for p in lm.parameters())} parameters in bf16; {card}")
    sys_prompt, reqs = serving_traffic(SERVE_CFG["vocab_size"])
    phase(f"in-flight engine (main paths): {SERVE_N} requests from {SERVE_THREADS} threads, "
          f"{SERVE_ENGINE}:")
    paths = engine_phase(torch, report, lm, sys_prompt, reqs)
    phase(f"speculative decoding (main paths): {SPEC_RUN}:")
    paths.update(speculative_phase(torch, dt, report, lm))
    phase("gRPC serving (MyDLPWServicer on 127.0.0.1, concurrent clients):")
    grpc_phase(torch, report, lm)
    del lm
    free_card(torch)
    return paths, sk


# ------------------------------------------------------------------ seq2seq
# facebook/bart-base's config.json widths (d_model, heads, ffn_dim, layers,
# vocab_size, max_position_embeddings as the source length); the blocks are
# this repo's pre-norm GELU blocks
S2S_CFG = dict(vocab_size=50265, src_len=1024, tgt_len=256, dim=768, enc_depth=6,
               dec_depth=6, num_heads=12, mlp_ratio=4.0)
S2S_B = 8
S2S_STEPS = 5
S2S_PER_STEP = {"fused_adam": 1}  # kernel launches a training step
S2S_LR = 1e-4
S2S_SEED = 0
S2S_BOS = 0
S2S_NEW = 128  # tokens a serving request generates
S2S_TAPE = 8  # tokens of the f32 generator held against the tape's greedy
S2S_F32_TIE = 1e-3  # the f32 generator and the tape may part only at a smaller top-2 margin
S2S_GRPC_CALLS = 4
S2S_IMAGES = (8, 3, 224, 224)  # the ResNet-50 Predict batch


def s2s_model(dt, seed):
    from deepflows_tpu_torch.models import Seq2SeqTransformer

    dt.manual_seed(seed)
    return Seq2SeqTransformer(**S2S_CFG, device="cuda")


def s2s_sources(rng):
    return rng.integers(1, S2S_CFG["vocab_size"], (S2S_B, S2S_CFG["src_len"]))


def s2s_batch(torch):
    """The reversal task of examples/seq2seq_reversal.py at S2S_CFG's
    lengths, from S2S_SEED: the target is the reversed source's first
    tgt_len tokens mapped through a fixed permutation of the vocabulary;
    x = [source, BOS + target[:-1]], y = target."""
    import numpy as np

    V, Lt = S2S_CFG["vocab_size"], S2S_CFG["tgt_len"]
    rng = np.random.default_rng(S2S_SEED)
    perm = np.concatenate([[0], rng.permutation(np.arange(1, V))])
    src = s2s_sources(rng)
    tgt = perm[src[:, ::-1][:, :Lt]]
    tgt_in = np.concatenate([np.full((S2S_B, 1), S2S_BOS), tgt[:, :-1]], 1)
    return (torch.as_tensor(np.concatenate([src, tgt_in], 1), device="cuda"),
            torch.as_tensor(tgt, device="cuda"))


def s2s_step_flops(cfg, B):
    """A training step's FLOPs: 6 x the multiply-adds of the forward (every
    Linear on its tokens, the cross K/V on the source's, the head, and
    attention's two products over every score: the naive path computes the
    causal ones too)."""
    D, F = cfg["dim"], int(cfg["dim"] * cfg["mlp_ratio"])
    Ls, Lt, V = cfg["src_len"], cfg["tgt_len"], cfg["vocab_size"]
    enc = cfg["enc_depth"] * (B * Ls * (4 * D * D + 2 * D * F) + 2 * B * Ls * Ls * D)
    dec = cfg["dec_depth"] * (B * Lt * (6 * D * D + 2 * D * F) + B * Ls * 2 * D * D
                              + 2 * B * Lt * Lt * D + 2 * B * Lt * Ls * D)
    return 6 * (enc + dec + B * Lt * D * V)


def s2s_train_phase(torch, dt, report, card):
    """A main path: the f32 Seq2SeqTransformer at S2S_CFG trained by
    CompiledTrainStep(model, Adam(fused=True), CrossEntropyLoss()) on the
    repeated reversal batch, S2S_STEPS steps of exactly one fused_adam
    launch each, after fused_adam is held bitwise against its plain twin
    over the model's parameter list.  Returns ({path: counts}, the step's
    numbers, the Adam check's, the model, the step, x, y)."""
    from deepflows_tpu_torch import nn, ops, optim
    from deepflows_tpu_torch.jit import CompiledTrainStep

    model = s2s_model(dt, S2S_SEED)
    params = list(model.parameters())
    n = sum(p.numel() for p in params)
    print(f"model: Seq2SeqTransformer {S2S_CFG} (BART-base's widths), {n} parameters in "
          f"{len(params)} f32 tensors; B {S2S_B} x ({S2S_CFG['src_len']} + "
          f"{S2S_CFG['tgt_len']}); {card}")
    adam = adam_list_check(torch, [tuple(p.shape) for p in params], "Seq2SeqTransformer")
    if adam["max_abs_err"] != 0.0:
        fail(f"fused_adam over the seq2seq list differs from its twin: {adam['max_abs_err']}")
    step = CompiledTrainStep(model, optim.Adam(params, lr=S2S_LR, fused=True),
                             nn.CrossEntropyLoss())
    x, y = s2s_batch(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    (losses, wall, events), counts = counted(ops, lambda: run_steps(
        torch, step, x, y, S2S_STEPS, "seq2seq training", S2S_PER_STEP))
    print(f"main-path launches (seq2seq training): {counts}")
    print(f"  losses: {[round(v, 4) for v in losses]}")
    V = S2S_CFG["vocab_size"]
    if not abs(losses[0] - math.log(V)) < 1.0:
        fail(f"seq2seq step-1 loss {losses[0]} is not within 1.0 of ln {V}")
    if not losses[-1] < losses[0]:
        fail(f"the seq2seq loss did not fall on the repeated batch: {losses}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    device_ms = event_ms(lambda: step(x, y), 3)
    timed = statistics.median(wall[1:])
    flops = s2s_step_flops(S2S_CFG, S2S_B)
    r = dict(losses=losses, parameters=n, tensors=len(params), step_wall_ms=timed,
             step_event_ms=statistics.median(events[1:]), step_device_ms=device_ms,
             target_tokens_per_s=S2S_B * S2S_CFG["tgt_len"] / timed * 1e3,
             device_busy_share=device_ms / timed, step_flops=flops,
             mfu=flops / (timed * 1e-3 * PEAK_OPS["f32"]),
             step_bound_ms=flops / PEAK_OPS["f32"] * 1e3, peak_memory_gb=peak_gb)
    print(f"  step {timed:.3f} ms wall (steps 2-{S2S_STEPS}), {r['step_event_ms']:.3f} ms between "
          f"CUDA events, {device_ms:.3f} ms device (busy {100 * r['device_busy_share']:.1f}%); "
          f"{r['target_tokens_per_s']:.1f} target tokens/s; MFU {100 * r['mfu']:.2f}% of the f32 "
          f"peak (TF32 off) at {flops:.4g} FLOPs (bound {r['step_bound_ms']:.3f} ms); peak "
          f"memory {peak_gb:.2f} GB; {card}")
    others = {}
    r["profile_ms"] = prof = step_profile(torch, step, x, y, others=others)
    r["top_others_ms"] = top = top_others(others)
    print(f"  device time of a step by kernel (torch.profiler, 2 steps): "
          f"{sum(prof.values()):.3f} ms: " + ", ".join(
              f"{k} {v:.3f}" for k, v in sorted(prof.items(), key=lambda kv: -kv[1])))
    print("  the largest other PyTorch kernels, ms a step: "
          + "; ".join(f"{k} {v:.3f}" for k, v in top.items()))
    report["seq2seq_train"] = r
    return {"seq2seq_training": counts}, r, adam, model, step, x, y


def s2s_same_state(torch, model, opt, other, other_opt, label):
    """Every parameter, buffer and optimizer slot of the two equal bit for
    bit, and the step counts equal."""
    pairs = list(zip(model.state_dict().values(), other.state_dict().values()))
    for key in ("v", "s"):
        pairs += list(zip(opt._state[key], other_opt._state[key]))
    bad = sum(not torch.equal(a, b) for a, b in pairs)
    if bad or int(opt._state["t"]) != int(other_opt._state["t"]):
        fail(f"{label}: {bad} of {len(pairs)} tensors differ, or t "
             f"{int(opt._state['t'])} != {int(other_opt._state['t'])}")
    return len(pairs)


def s2s_file_equals(torch, path, model, opt, label):
    """The checkpoint at ``path`` holds ``model``'s and ``opt``'s state bit
    for bit (compared on the card)."""
    from deepflows_tpu_torch.utils import model_utils

    with open(path, "rb") as f:
        ck = model_utils.pickle.load(f)

    def same(arr, t):
        return torch.equal(torch.from_numpy(arr).to(t.device), t)

    own = dict(model.named_parameters())
    bad = [n for n, arr in ck["model_parameters"].items() if not same(arr, own[n])]
    st = ck["optimizer_state"]
    for key in ("v", "s"):
        bad += [f"{key}[{i}]" for i, (arr, t) in enumerate(zip(st[key], opt._state[key]))
                if not same(arr, t)]
    if bad or st["t"] != int(opt._state["t"]) + 1 or len(own) != len(ck["model_parameters"]):
        fail(f"{label}: {len(bad)} arrays differ ({bad[:4]}), or t {st['t']}")
    return ck["epoch"]


def s2s_checkpoint_phase(torch, dt, report, model, step, x, y, tmp):
    """save_checkpoint of the trained model and its Adam, loaded into a
    fresh model and optimizer bit for bit; then AsyncCheckpointer.save with
    the next step queued right behind it: the file holds the state before
    that step.  Returns the loaded model."""
    from deepflows_tpu_torch import optim
    from deepflows_tpu_torch.utils import AsyncCheckpointer, load_checkpoint, save_checkpoint

    opt = step.optimizer
    spath, apath = os.path.join(tmp, "seq2seq.pkl"), os.path.join(tmp, "seq2seq_async.pkl")
    t0 = time.perf_counter()
    save_checkpoint(model, opt, epoch=S2S_STEPS, save_path=spath)
    save_s = time.perf_counter() - t0
    loaded = s2s_model(dt, S2S_SEED + 1)
    loaded_opt = optim.Adam(loaded.parameters(), lr=0.5, fused=True)
    t0 = time.perf_counter()
    info = load_checkpoint(loaded, loaded_opt, spath)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    n = s2s_same_state(torch, model, opt, loaded, loaded_opt, "the loaded checkpoint")
    if info["epoch"] != S2S_STEPS or loaded_opt.lr != S2S_LR:
        fail(f"the loaded checkpoint's epoch {info['epoch']} or lr {loaded_opt.lr}")
    with AsyncCheckpointer() as ck:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fut = ck.save(model, opt, epoch=S2S_STEPS + 1, save_path=apath)
        call_ms = (time.perf_counter() - t0) * 1e3
        step(x, y)  # updates in place while the write runs
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        fut.result()
        async_s = time.perf_counter() - t0
    moved = sum(not torch.equal(a, b) for a, b in zip(model.parameters(), loaded.parameters()))
    if not moved:
        fail("the step after the async save moved no parameter")
    s2s_file_equals(torch, apath, loaded, loaded_opt, "the async checkpoint")
    r = dict(file_bytes=os.path.getsize(spath), save_s=save_s, load_s=load_s, tensors=n,
             async_save_call_ms=call_ms, async_step_done_s=step_s, async_write_s=async_s,
             params_moved_by_the_step=moved)
    print(f"  save_checkpoint {r['file_bytes'] / 1e9:.3f} GB in {save_s:.2f} s; load_checkpoint "
          f"into a fresh model and Adam {load_s:.2f} s, {n} tensors and t bitwise equal; "
          f"AsyncCheckpointer.save returned in {call_ms:.1f} ms, the next step done at "
          f"{step_s:.2f} s, the file at {async_s:.2f} s, equal to the state before the step "
          f"({moved} parameters moved by it)")
    report["seq2seq_checkpoint"] = r
    return loaded


def s2s_step_floor(model, B, Ls):
    """The bytes a decode step must move over the card's memory rate: the
    decoder's bf16 weights it reads (cross K/V projections excluded: they
    ran once), the head read in bf16 and written and read again widened to
    f32, the cross K/V and the whole self-attention cache (bf16)."""
    dec = sum(p.numel() for name, p in model.dec_blocks.named_parameters()
              if ".cross_attn.k_proj." not in name and ".cross_attn.v_proj." not in name)
    norm = sum(p.numel() for p in model.norm.parameters())
    head = model.head.weight.numel() + model.head.bias.numel()
    D, layers = S2S_CFG["dim"], S2S_CFG["dec_depth"]
    cache = 2 * layers * B * D * (Ls + S2S_CFG["tgt_len"])
    nbytes = 2 * (dec + norm + cache) + 10 * head
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def s2s_tape_greedy(torch, model, src, n):
    """Greedy decoding through the f32 forward, teacher-forcing the grown
    prefix; the tokens and each step's top-2 logit margin."""
    B = src.shape[0]
    tgt_in = torch.zeros((B, S2S_CFG["tgt_len"]), dtype=torch.long, device="cuda")
    tgt_in[:, 0] = S2S_BOS
    src = torch.as_tensor(src, device="cuda")
    out, margins = [], []
    with torch.no_grad():
        for t in range(n):
            logits = model(torch.cat([src, tgt_in], 1))[:, t]
            top2 = torch.topk(logits, 2).values
            margins.append((top2[:, 0] - top2[:, 1]).cpu())
            out.append(logits.argmax(-1))
            if t + 1 < S2S_CFG["tgt_len"]:
                tgt_in[:, t + 1] = out[-1]
    return torch.stack(out, 1).cpu().numpy(), torch.stack(margins, 1).numpy()


def s2s_grpc(torch, model, srcs):
    """S2S_GRPC_CALLS Generate calls from as many client threads to
    MyDLPWServicer(model, decode_dtype bf16) on 127.0.0.1; their answers
    and the wall seconds."""
    import threading

    from deepflows_tpu_torch.serving import MyDLPWServicer, PredictClient

    server = MyDLPWServicer("127.0.0.1:0", model=model, decode_dtype=torch.bfloat16)
    server.serve(wait=False)
    outs, errors = [None] * len(srcs), []
    try:
        def client(i):
            try:
                cl = PredictClient(f"127.0.0.1:{server.port}")
                outs[i] = cl.generate(srcs[i], S2S_NEW)
                cl.close()
            except Exception as e:  # noqa: BLE001 - re-raised below
                errors.append(e)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(len(srcs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
    finally:
        server.stop()
    if errors:
        raise errors[0]
    return outs, wall


def s2s_predict_phase(torch, dt, tmp, rng):
    """A ResNet-50 checkpoint served from its file (model_file
    "resnet50.pkl", model_name "resnet50"): a Predict of S2S_IMAGES against
    CompiledEvalStep on the saved model, which it must equal."""
    import numpy as np

    from deepflows_tpu_torch.jit import CompiledEvalStep
    from deepflows_tpu_torch.models import ResNet50
    from deepflows_tpu_torch.serving import MyDLPWServicer, PredictClient
    from deepflows_tpu_torch.utils import save_checkpoint

    dt.manual_seed(S2S_SEED)
    rn = ResNet50(num_classes=1000, device="cuda")
    save_checkpoint(rn, save_path=os.path.join(tmp, "resnet50.pkl"))
    images = rng.standard_normal(S2S_IMAGES).astype("float32")
    want = CompiledEvalStep(rn)(images).float().cpu().numpy()
    del rn
    server = MyDLPWServicer("127.0.0.1:0", root_dir=tmp, model_file="resnet50.pkl",
                            model_name="resnet50", device="cuda")
    server.serve(wait=False)
    try:
        client = PredictClient(f"127.0.0.1:{server.port}")
        t0 = time.perf_counter()
        (out,) = client.predict(images)
        call_s = time.perf_counter() - t0
        client.close()
    finally:
        server.stop()
    diff = float(abs(out - want).max())
    if (out.shape != (S2S_IMAGES[0], 1000) or not np.isfinite(want).all()
            or not (out == want).all()):
        fail(f"Predict from resnet50.pkl: shape {out.shape}, max |diff| {diff} against "
             "CompiledEvalStep on the saved model")
    return dict(call_s=call_s, max_abs_diff=diff)


def s2s_serve_phase(torch, dt, report, model, tmp, card):
    """A main path: the loaded model served by Seq2SeqGenerator in bf16 (B
    8, source 1024, S2S_NEW tokens from a captured step), its tokens equal
    to the eager loop's; the f32 generator against the tape's greedy; the
    gRPC Generate route against the in-process generator; Predict from a
    ResNet-50 checkpoint file.  Returns {path: counts}."""
    import numpy as np

    from deepflows_tpu_torch import ops
    from deepflows_tpu_torch.models import Seq2SeqGenerator

    model.eval()
    rng = np.random.default_rng(S2S_SEED + 2)
    src = s2s_sources(rng)
    B, Ls = src.shape
    gen = Seq2SeqGenerator(model, compute_dtype=torch.bfloat16)
    gen._capture = False
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = gen.generate(src, S2S_NEW)
    eager_s = time.perf_counter() - t0
    gen._capture = True
    graphed, counts = counted(ops, lambda: gen.generate(src, S2S_NEW))
    print(f"main-path launches (seq2seq serving): {counts}")
    key = ("decode", B, Ls, S2S_NEW, torch.bfloat16)
    captured = gen._graphs[key]
    if captured.replays != S2S_NEW - 1:
        fail(f"seq2seq serving: {captured.replays} replays, not {S2S_NEW - 1}")
    if not (graphed == eager).all():
        j = int(np.argmax((graphed != eager).any(0)))
        fail(f"seq2seq serving: the graphed tokens part from the eager loop's at step {j}")
    if graphed.shape != (B, S2S_NEW) or not ((graphed >= 0) & (graphed < S2S_CFG["vocab_size"])).all():
        fail(f"seq2seq serving: tokens of shape {graphed.shape} outside the vocabulary")
    gen_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gen.generate(src, S2S_NEW)
        gen_s.append(time.perf_counter() - t0)
    lp = gen._loops[key]

    def decode_all():
        lp.pos.zero_()
        for _ in range(S2S_NEW):
            captured.replay()

    def one_step():
        lp.pos.zero_()
        captured.replay()

    others = {}
    with torch.inference_mode():
        step_ms = event_ms(decode_all, 3) / S2S_NEW
        profile = replay_profile(torch, one_step, others=others)
    floor_ms, floor_bytes = s2s_step_floor(model, B, Ls)
    generate_s = statistics.median(gen_s)
    r = dict(generate_s=generate_s, generate_tokens_per_s=B * S2S_NEW / generate_s,
             eager_generate_s=eager_s, step_device_ms=step_ms,
             decode_tokens_per_s=B / step_ms * 1e3, step_floor_ms=floor_ms,
             step_floor_bytes=floor_bytes, capture_s=captured.capture_s,
             graph_pool_mib=captured.pool_bytes / 2**20, profile=profile,
             top_others_ms=top_others(others))
    print(f"  bf16, B {B}, source {Ls}, +{S2S_NEW}: graphed tokens equal the eager loop's; "
          f"generate {generate_s * 1e3:.1f} ms ({r['generate_tokens_per_s']:.1f} generated tok/s;"
          f" eager loop {eager_s * 1e3:.1f} ms, its first call), a step {step_ms:.4f} ms device "
          f"({r['decode_tokens_per_s']:.1f} tok/s) against a floor of {floor_ms:.4f} ms "
          f"({floor_bytes / 1e9:.3f} GB); capture {captured.capture_s:.3f} s, pool "
          f"{r['graph_pool_mib']:.1f} MiB; {card}")
    print("  a step's device time by kernel group: " + ", ".join(
        f"{k} {v['ms']:.4f} ms ({v['kernels']:.0f} kernels)" for k, v in profile.items()))
    print("  the largest other PyTorch kernels, ms a step: "
          + "; ".join(f"{k} {v:.4f}" for k, v in r["top_others_ms"].items()))
    f32 = Seq2SeqGenerator(model).generate(src, S2S_TAPE)
    tape, margins = s2s_tape_greedy(torch, model, src, S2S_TAPE)
    parted = (f32 != tape).any(0)
    if parted.any():
        j = int(np.argmax(parted))
        rows = (f32[:, j] != tape[:, j])
        if not (margins[rows, j] < S2S_F32_TIE).all() or (f32[:, :j] != tape[:, :j]).any():
            fail(f"seq2seq f32 generator parts from the tape's greedy at step {j}, top-2 "
                 f"margins {margins[rows, j]}")
        print(f"  f32 generator and tape part at step {j} at a near tie "
              f"(margins {margins[rows, j]}); equal before it")
    else:
        print(f"  f32 generator equals the tape's greedy for {S2S_TAPE} tokens (least top-2 "
              f"margin {float(margins.min()):.4g})")
    r["f32_tape_parted_at"] = int(np.argmax(parted)) if parted.any() else None
    r["f32_tape_least_margin"] = float(margins.min())
    srcs = [s2s_sources(rng) for _ in range(S2S_GRPC_CALLS)]
    want = [gen.generate(s, S2S_NEW) for s in srcs]
    outs, wall = s2s_grpc(torch, model, srcs)
    for i, (o, w) in enumerate(zip(outs, want)):
        if o.shape != w.shape or not (o == w).all():
            fail(f"seq2seq gRPC call {i}: shape {o.shape}, tokens differ from the in-process "
                 "generator's")
    r["grpc"] = dict(calls=len(srcs), wall_s=wall, tokens_per_s=len(srcs) * B * S2S_NEW / wall)
    print(f"  gRPC: {len(srcs)} Generate calls (B {B}, +{S2S_NEW}) from {len(srcs)} clients in "
          f"{wall:.3f} s, tokens equal to the in-process generator's")
    del gen
    free_card(torch)
    r["predict"] = p = s2s_predict_phase(torch, dt, tmp, rng)
    print(f"  Predict from resnet50.pkl ({S2S_IMAGES}): equal to CompiledEvalStep on the saved "
          f"model, {p['call_s']:.3f} s a call")
    report["seq2seq_serving"] = r
    return {"seq2seq_serving": counts}


def seq2seq_phases(torch, dt, report, phase, card):
    """The encoder-decoder slice at BART-base's widths: training (a main
    path), the checkpoint phase, serving (a main path).  Returns ({path:
    launch counts}, the fused_adam check's numbers)."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix=".seq2seq_ckpt_", dir=ROOT)
    marks = [time.perf_counter()]
    try:
        phase("seq2seq training at BART-base widths (main path):")
        paths, _, adam, model, step, x, y = s2s_train_phase(torch, dt, report, card)
        marks.append(time.perf_counter())
        phase("seq2seq checkpoint (save, load, an async save beside the next step):")
        loaded = s2s_checkpoint_phase(torch, dt, report, model, step, x, y, tmp)
        del model, step, x, y
        free_card(torch)
        marks.append(time.perf_counter())
        phase("seq2seq serving (main path): the bf16 generator, gRPC Generate, Predict from a "
              "checkpoint file:")
        paths.update(s2s_serve_phase(torch, dt, report, loaded, tmp, card))
        del loaded
        free_card(torch)
        marks.append(time.perf_counter())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    secs = dict(zip(("training_s", "checkpoint_s", "serving_s"),
                    (b - a for a, b in zip(marks, marks[1:]))))
    secs["total_s"] = marks[-1] - marks[0]
    report["seq2seq_phases_s"] = secs
    print("  seq2seq phases: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    return paths, adam


# ------------------------------------------------------------------ the utils
TEXT_VOCAB = 512  # the tokenizer's vocabulary; the head keeps the bench row's 8192
TEXT_CHARS = 65536  # the tokenizer learns on the sorted corpus's first 64 Ki characters
TEXT_PROMPT, TEXT_NEW = "## Architecture", 48
TEXT_BARE = 5  # bare steps timed beside the Trainer's
AUG_PAD = 4  # RandomCrop's padding
CNN_FIT_STEPS, CNN_EVAL_IMAGES = 4, 256
PRETRAINED_B = 32
HF_SEED = 5
HF_STD = 0.02  # the seeded HF weights: uniform with this standard deviation
HF_LLAMA = types.SimpleNamespace(  # Mistral-7B-v0.1's config.json field names, depth 2 of 32
    vocab_size=32000, hidden_size=4096, intermediate_size=14336, num_hidden_layers=2,
    num_attention_heads=32, num_key_value_heads=8, max_position_embeddings=32768,
    rms_norm_eps=1e-5, rope_theta=10000.0, sliding_window=4096)
HF_LLAMA_MAX_LEN = 192
HF_LLAMA_REQUEST = (2, 64, 32)  # batch, prompt, greedy tokens
HF_GPT2 = types.SimpleNamespace(  # GPT-2 small's config.json (n_inner None: 4 x n_embd)
    vocab_size=50257, n_positions=1024, n_embd=768, n_layer=12, n_head=12,
    layer_norm_epsilon=1e-5)
GPT2_B, GPT2_STEPS = 8, 3
GPT2_ADAM = dict(lr=6e-4, weight_decay=0.0)  # GPT-2 small's published peak lr
GPT2_PER_STEP = {"flash_attention_fwd": HF_GPT2.n_layer, "flash_attention_bwd": HF_GPT2.n_layer,
                 "fused_linear_ce_fwd": 1, "fused_linear_ce_bwd": 1, "fused_adam": 1}


def repo_corpus():
    """The repository's markdown, sorted (``*.md``, then ``docs/*.md``), as
    examples/llama_text_train.py loads it."""
    import glob

    texts = []
    for path in (sorted(glob.glob(os.path.join(ROOT, "*.md")))
                 + sorted(glob.glob(os.path.join(ROOT, "docs", "*.md")))):
        with open(path, errors="replace") as f:
            texts.append(f.read())
    return texts


def corpus_head(texts, chars):
    """The texts, in order, cut after ``chars`` characters."""
    out, n = [], 0
    for t in texts:
        if n >= chars:
            break
        out.append(t[: chars - n])
        n += len(out[-1])
    return out


class StepLog:
    """An injected Trainer step that records each call's loss (left on the
    card), host time and whether its batch arrived staged on the card; with
    ``checksums`` also, on the card, the sum of x's bits as int32 words and
    a copy of y: what the step was given, for the host to compare."""

    def __init__(self, step, checksums=False):
        self.step, self.losses, self.times, self.staged = step, [], [], []
        self.checksums, self.given = checksums, []

    def __call__(self, x, y):
        import torch

        self.times.append(time.perf_counter())
        self.staged.append(bool(x.is_cuda and y.is_cuda))
        if self.checksums:
            self.given.append((x.contiguous().view(torch.int32).sum(dtype=torch.int64), y.clone()))
        loss = self.step(x, y)
        self.losses.append(loss)
        return loss


def trace_device_events(log_dir):
    """The device events (kernels, copies, memsets) of the Chrome trace that
    profiling.trace wrote into ``log_dir``."""
    import glob

    (path,) = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e for e in events if e.get("ph") == "X"
            and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def busy_us(events):
    """The union of the events' intervals, and the idle gaps between them
    as (start after the first event, length), in µs."""
    total, end, first, gaps = 0.0, -math.inf, None, []
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        first = a if first is None else first
        if a > end > -math.inf:
            gaps.append((end - first, a - end))
        if b > end:
            total += b - max(a, end)
            end = b
    return total, gaps


def fit_parts(step, t_fit, epoch_s):
    """Where an epoch of Trainer.fit went, in host ms: before the first
    step's call, the first step, the median interval of the later steps,
    and from the last step's call to the epoch's end (the loss readback)."""
    t = step.times
    later = [(b - a) * 1e3 for a, b in zip(t[1:], t[2:])]
    return dict(before_first_ms=(t[0] - t_fit) * 1e3, first_step_ms=(t[1] - t[0]) * 1e3,
                later_step_ms=statistics.median(later) if later else None,
                after_last_ms=(t_fit + epoch_s - t[-1]) * 1e3)


def timed_fit(trainer, step, x, y, **kw):
    """One epoch of trainer.fit with ``step`` (a StepLog) cleared first:
    (the history, fit_parts of the epoch and what the host spent besides
    the steps: Python's garbage collections, count and ms, and the caching
    allocators' cudaMalloc, cudaFree and pinned host allocations)."""
    import torch

    step.times.clear()
    step.losses.clear()
    step.staged.clear()
    step.given.clear()
    pauses, start = [], {}

    def on_gc(event, info):
        if event == "start":
            start["t"] = time.perf_counter()
        elif "t" in start:
            pauses.append((time.perf_counter() - start.pop("t")) * 1e3)

    def counts():
        dev = torch.cuda.memory_stats()
        host = getattr(torch.cuda, "host_memory_stats", dict)()
        return (dev.get("segment.all.allocated", 0), dev.get("segment.all.freed", 0),
                host.get("num_host_alloc", 0))

    before = counts()
    gc.callbacks.append(on_gc)
    try:
        t_fit = time.perf_counter()
        hist = trainer.fit(x, y, epochs=1, **kw)
    finally:
        gc.callbacks.remove(on_gc)
    parts = fit_parts(step, t_fit, hist["epoch_time"][-1])
    mallocs, frees, pinned = (b - a for a, b in zip(before, counts()))
    parts.update(gc_collections=len(pauses), gc_ms=sum(pauses),
                 cuda_mallocs=mallocs, cuda_frees=frees, pinned_allocs=pinned)
    return hist, parts


def h2d_copies(events):
    """Host-to-device copies on streams where no kernel ran (the loaders'
    side streams): (their number, how many read pinned memory, how many ran
    while a kernel of another stream did)."""
    kernels = [e for e in events if e["cat"] == "kernel"]
    kstreams = {e.get("args", {}).get("stream") for e in kernels}
    copies = [e for e in events if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]
              and e.get("args", {}).get("stream") not in kstreams]
    spans = sorted((k["ts"], k["ts"] + k["dur"]) for k in kernels)
    starts = [a for a, _ in spans]

    def beside_a_kernel(c):
        a, b = c["ts"], c["ts"] + c["dur"]
        i = bisect.bisect_left(starts, b)
        return any(s < b and e > a for s, e in spans[max(0, i - 64):i])

    return (len(copies), sum("Pinned" in c["name"] for c in copies),
            sum(beside_a_kernel(c) for c in copies))


def text_trainer_phase(torch, dt, report, card, tmp):
    """A main path, the slice's: the repository's markdown -> BPETokenizer
    (vocab 512) -> LMDataset(seq_len 1024) -> Trainer.fit with the bench
    row's step injected (the loader's prefetch thread stages each batch on
    the card) -> the checkpoint fit wrote -> load_checkpoint into a fresh LM
    -> greedy text from the graphed decoder.  Returns the launch counts."""
    import numpy as np

    from deepflows_tpu_torch import nn, ops, optim
    from deepflows_tpu_torch.jit import CompiledTrainStep
    from deepflows_tpu_torch.models import KVCacheDecoder, TransformerLM
    from deepflows_tpu_torch.utils import (
        BPETokenizer,
        LMDataset,
        Trainer,
        load_checkpoint,
        profiling,
    )

    r = {}
    t0 = time.perf_counter()
    texts = repo_corpus()
    tok = BPETokenizer().train(corpus_head(texts, TEXT_CHARS), TEXT_VOCAB)
    r["tokenizer_train_s"] = time.perf_counter() - t0
    back = BPETokenizer.load(tok.save(os.path.join(tmp, "tokenizer.json")))
    if list(back.merges.items()) != list(tok.merges.items()) or \
            back.special_tokens != tok.special_tokens:
        fail("the tokenizer's save / load round trip changed its merges or specials")
    t1 = time.perf_counter()
    ds = LMDataset(texts, back, TRAIN_L)
    x = np.stack([ds[i][0] for i in range(len(ds))])
    y = np.stack([ds[i][1] for i in range(len(ds))])
    r["dataset_s"] = time.perf_counter() - t1
    chars = sum(len(t) for t in texts)
    if not int(ds.tokens.max()) < tok.vocab_size <= TRAIN["vocab_size"]:
        fail(f"token ids reach {int(ds.tokens.max())} (vocabulary {tok.vocab_size})")
    steps = len(ds) // TRAIN_B
    print(f"  corpus {len(texts)} files, {chars} characters; tokenizer: {len(tok.merges)} merges "
          f"learned on {TEXT_CHARS} characters in {r['tokenizer_train_s']:.3f} s (host); "
          f"LMDataset: {ds.tokens.size} tokens, {len(ds)} windows of {TRAIN_L} in "
          f"{r['dataset_s']:.3f} s (host); {steps} steps of B {TRAIN_B}")
    dt.manual_seed(0)
    lm = TransformerLM(**TRAIN, device="cuda", flash=True)
    opt = optim.Adam(lm.parameters(), **ADAM, fused=True)
    head_ce = nn.LMHeadCrossEntropy(lm.head)
    step = StepLog(CompiledTrainStep(lm.trunk(), opt, head_ce, compute_dtype=torch.bfloat16))
    ckpt = os.path.join(tmp, "lm.pkl")
    trainer = Trainer(lm, opt, head_ce, checkpoint_path=ckpt, step=step,
                      log_fn=lambda s: print(f"  Trainer: {s}"))
    torch.cuda.synchronize()
    ops.reset_launch_counts()  # the main path starts here
    hist, parts = timed_fit(trainer, step, x, y, batch_size=TRAIN_B, prefetch_size=2)
    counts = {k.__name__: k.launches for k in ops.KERNELS}  # and ends here
    print(f"main-path launches (text_trainer): {counts}")
    n = len(step.losses)
    if n != steps or not all(step.staged):
        fail(f"Trainer.fit ran {n} steps of {steps}; staged on the card: {step.staged}")
    for k, c in counts.items():
        if c != PER_STEP.get(k, 0) * n:
            fail(f"text_trainer: {k} launched {c} times in {n} steps, expected "
                 f"{PER_STEP.get(k, 0)} a step")
    losses = [float(v) for v in step.losses]
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"the text loss did not fall over the epoch: {losses}")
    r.update(steps=n, first_loss=losses[0], last_loss=losses[-1], epoch_mean_loss=hist["loss"][0],
             epoch_s=hist["epoch_time"][0], epoch_parts_ms=parts,
             launches_per_step={k: c // n for k, c in counts.items() if c})
    print(f"  {n} steps: loss {losses[0]:.4f} -> {losses[-1]:.4f} (epoch mean "
          f"{hist['loss'][0]:.4f}); launches a step {r['launches_per_step']} (PER_STEP); the "
          f"epoch's {1e3 * hist['epoch_time'][0]:.1f} ms: " + ", ".join(
              f"{k} {v:.1f}" for k, v in parts.items()))
    # the checkpoint fit wrote, into a fresh LM and Adam
    dt.manual_seed(1)
    fresh = TransformerLM(**TRAIN, device="cuda", flash=True)
    fresh_opt = optim.Adam(fresh.parameters(), **ADAM, fused=True)
    t2 = time.perf_counter()
    info = load_checkpoint(fresh, fresh_opt, ckpt)
    r["checkpoint_load_s"] = time.perf_counter() - t2
    r["checkpoint_bytes"] = os.path.getsize(ckpt)
    xb = torch.as_tensor(x[:TRAIN_B], device="cuda")
    lm.eval()
    fresh.eval()
    with torch.no_grad():
        same = torch.equal(lm(xb), fresh(xb))
    slots = all(torch.equal(a, b) for key in ("v", "s")
                for a, b in zip(opt._state[key], fresh_opt._state[key]))
    if info["epoch"] != 0 or not same or not slots:
        fail(f"the checkpoint did not load equal: epoch {info['epoch']}, logits equal {same}, "
             f"Adam slots equal {slots}")
    del fresh_opt
    print(f"  checkpoint {r['checkpoint_bytes']} bytes loaded into a fresh LM in "
          f"{r['checkpoint_load_s']:.2f} s: logits on a batch bitwise equal, Adam slots equal")
    # greedy text from the loaded LM on the graphed decoder
    dec = KVCacheDecoder(fresh, compute_dtype=torch.bfloat16)
    prompt = np.asarray([tok.encode(TEXT_PROMPT)])
    out = dec.generate(prompt, TEXT_NEW)
    if loop_key(dec, "decode", 1) not in dec._graphs:
        fail("the text decoder's loop has no graph")
    new = [int(i) for i in out[0, prompt.shape[1]:]]
    outside = sum(i >= tok.vocab_size for i in new)
    r["generated"] = tok.decode([i for i in new if i < tok.vocab_size])
    r["generated_outside_vocabulary"] = outside
    print(f"  greedy text of the loaded LM from {TEXT_PROMPT!r} (+{TEXT_NEW}, graphed decoder, "
          f"bf16; {outside} ids outside the tokenizer's vocabulary): {r['generated']!r}")
    del dec, fresh
    lm.train()
    # a warm epoch (no checkpoint), then the bare step on one staged
    # batch: their difference is what the loader and the Trainer cost
    trainer.checkpoint_path = None
    warm, wparts = timed_fit(trainer, step, x, y, batch_size=TRAIN_B, prefetch_size=2)
    fit_ms = warm["epoch_time"][-1] / n * 1e3
    yb = torch.as_tensor(y[:TRAIN_B], device="cuda")
    _, wall, _ = run_steps(torch, step.step, xb, yb, TEXT_BARE, "text bare step", PER_STEP)
    r.update(fit_step_ms=fit_ms, warm_epoch_parts_ms=wparts, bare_step_ms=statistics.median(wall[1:]))
    r["trainer_overhead_ms"] = fit_ms - r["bare_step_ms"]
    print(f"  a step inside fit (a warm epoch): {fit_ms:.3f} ms ({warm['epoch_time'][-1]:.3f} s / "
          f"{n}: " + ", ".join(f"{k} {v:.1f}" for k, v in wparts.items()) + f") against the bare "
          f"step's {r['bare_step_ms']:.3f} ms (run_steps, synchronised): the loader and the "
          f"Trainer cost {r['trainer_overhead_ms']:.3f} ms a step; {card}")
    # one more epoch under the port's own trace: busy share, the batches' copies
    tdir = os.path.join(tmp, "trace")
    with profiling.trace(tdir):
        traced, tparts = timed_fit(trainer, step, x, y, batch_size=TRAIN_B, prefetch_size=2)
    events = trace_device_events(tdir)
    busy, gaps = busy_us(events)
    wall_us = traced["epoch_time"][-1] * 1e6
    r["traced_epoch_parts_ms"] = tparts
    r["idle_gaps_ms"] = [(round(a / 1e3, 3), round(b / 1e3, 3))
                         for a, b in sorted(gaps, key=lambda g: -g[1])[:6]]
    ncopy, pinned, beside = h2d_copies(events)
    r.update(traced_epoch_s=traced["epoch_time"][-1],
             device_busy_share=busy / wall_us if events else None,
             batch_copies=ncopy, pinned_copies=pinned, copies_beside_a_kernel=beside)
    if not events:
        print("  busy share over the epoch: not measured (the trace holds no device event)")
    else:
        print(f"  traced epoch (profiling.trace, CPU and CUDA activities): {wall_us / 1e6:.3f} s "
              f"wall (" + ", ".join(f"{k} {v:.1f}" for k, v in tparts.items()) + "), the card "
              f"busy {busy / 1e6:.3f} s: busy share {100 * busy / wall_us:.1f}%; idle "
              f"{sum(g for _, g in gaps) / 1e3:.1f} ms in {len(gaps)} gaps, the largest (ms after "
              f"the first device event, ms long): {r['idle_gaps_ms']}; "
              f"batch copies to the card on the loader's stream: {ncopy} ({2 * n} expected), "
              f"{pinned} from pinned memory, {beside} while a step's kernel ran; {card}")
        if ncopy and pinned != ncopy:
            fail(f"{ncopy - pinned} batch copies read pageable memory")
    report["text_trainer"] = r
    return counts


def cnn_trainer_phase(torch, dt, report, card, tmp):
    """A main path: ResNet-50 (bf16, B 128 x 224^2, Adam at CNN_LR) through
    Trainer.fit for one epoch of 4 steps over one batch repeated, in order,
    RandomCrop, RandomHorizontalFlip and Normalize on the prefetch thread:
    the loss must fall, and each step must get the batch the thread
    augmented for it (the bits of x) with its own labels.  Then
    Trainer.evaluate over 256 images; DeviceDataLoader over a DataLoader.
    Returns the launch counts."""
    import numpy as np

    from deepflows_tpu_torch import nn, ops
    from deepflows_tpu_torch.utils import IMAGENET_STATS, Trainer, profiling
    from deepflows_tpu_torch.utils.data import (
        Compose,
        DataLoader,
        DeviceDataLoader,
        Normalize,
        RandomCrop,
        RandomHorizontalFlip,
        TensorDataset,
    )

    r = {}
    rng = np.random.default_rng(0)
    # uint8-range images scaled to [0, 1], as load_image_folder gives them;
    # one batch repeated, so that the loss can fall in one epoch
    x = rng.integers(0, 256, (CNN_B, 3, CNN_IMAGE, CNN_IMAGE), dtype=np.uint8).astype(np.float32)
    x /= 255.0
    y = rng.integers(0, CNN_CLASSES, CNN_B).astype(np.int32)
    x, y = np.tile(x, (CNN_FIT_STEPS, 1, 1, 1)), np.tile(y, CNN_FIT_STEPS)
    augment = Compose([RandomCrop(CNN_IMAGE, AUG_PAD, seed=1), RandomHorizontalFlip(seed=2),
                       Normalize(IMAGENET_STATS["mean"], IMAGENET_STATS["std"])])
    on_thread, made = [], []  # the augmentation's host ms on the prefetch thread; its x's bits

    def timed_augment(batch):
        t0 = time.perf_counter()
        out = augment(batch)
        on_thread.append((time.perf_counter() - t0) * 1e3)
        made.append(int(np.ascontiguousarray(out, np.float32).view(np.int32).sum(dtype=np.int64)))
        return out

    model = cnn_model(dt, "ResNet50", num_classes=CNN_CLASSES)
    step = StepLog(cnn_step(torch, model, dict(ADAM, lr=CNN_LR)), checksums=True)
    trainer = Trainer(model, step.step.optimizer, nn.CrossEntropyLoss(), augment_fn=timed_augment,
                      step=step, log_fn=lambda s: print(f"  Trainer: {s}"))
    torch.cuda.synchronize()
    ops.reset_launch_counts()  # the main path starts here
    hist, parts = timed_fit(trainer, step, x, y, batch_size=CNN_B, prefetch_size=2, shuffle=False)
    counts = {k.__name__: k.launches for k in ops.KERNELS}  # and ends here
    print(f"main-path launches (cnn_trainer): {counts}")
    if len(step.losses) != CNN_FIT_STEPS or not all(step.staged):
        fail(f"ResNet-50 Trainer.fit ran {len(step.losses)} steps; staged: {step.staged}")
    for k, c in counts.items():
        if c != CNN_PER_STEP.get(k, 0) * CNN_FIT_STEPS:
            fail(f"cnn_trainer: {k} launched {c} times in {CNN_FIT_STEPS} steps")
    got = [int(sx) for sx, _ in step.given]
    labels = [bool((gy.cpu().numpy() == y[i * CNN_B:(i + 1) * CNN_B]).all())
              for i, (_, gy) in enumerate(step.given)]
    if got != made or not all(labels) or len(set(made)) != CNN_FIT_STEPS:
        fail(f"cnn_trainer: the steps' x bit sums {got} against the augmented batches' {made}; "
             f"labels equal to their batch's {labels}")
    losses = [float(v) for v in step.losses]
    print(f"  each step got the batch the prefetch thread augmented for it (x's bit sums, "
          f"{len(set(made))} distinct) and its own labels")
    if not all(math.isfinite(v) for v in losses) or not losses[-1] < losses[0]:
        fail(f"the ResNet-50 Trainer loss is not finite or did not fall: {losses}")
    r.update(losses=losses, x_bit_sums=got, epoch_s=hist["epoch_time"][0], epoch_parts_ms=parts,
             augment_on_thread_ms=list(on_thread),
             fit_step_ms=hist["epoch_time"][0] / CNN_FIT_STEPS * 1e3)
    # evaluate: every step queued, one readback
    xe, ye = x[:CNN_EVAL_IMAGES], y[:CNN_EVAL_IMAGES]
    edir = os.path.join(tmp, "eval_trace")
    with profiling.trace(edir):
        acc = trainer.evaluate(xe, ye, batch_size=CNN_B)
    events = trace_device_events(edir)
    d2h = sum(e["cat"] == "gpu_memcpy" and "DtoH" in e["name"] for e in events)
    r.update(eval_accuracy=acc, eval_readbacks=d2h if events else None)
    if events and d2h != 1:
        fail(f"Trainer.evaluate read back {d2h} times, not once")
    # the augmentation's host time against the step's device time
    aug = []
    for _ in range(3):
        t0 = time.perf_counter()
        augment(x[:CNN_B])
        aug.append((time.perf_counter() - t0) * 1e3)
    xb = torch.as_tensor(augment(x[:CNN_B]), device="cuda")
    yb = torch.as_tensor(y[:CNN_B], device="cuda")
    r["augment_host_ms"] = statistics.median(aug)
    r["step_device_ms"] = event_ms(lambda: step.step(xb, yb), 3)
    print(f"  {CNN_FIT_STEPS} steps, losses {[round(v, 4) for v in losses]}; a step inside fit "
          f"{r['fit_step_ms']:.3f} ms (" + ", ".join(f"{k} {v:.1f}" for k, v in parts.items())
          + f"); one batch's augmentation {r['augment_host_ms']:.3f} ms on "
          f"the host alone ({', '.join(f'{v:.1f}' for v in on_thread)} ms on the prefetch thread "
          f"during fit) against the step's {r['step_device_ms']:.3f} ms on the card (the prefetch "
          f"thread keeps up: {r['augment_host_ms'] < r['step_device_ms']}); evaluate over "
          f"{CNN_EVAL_IMAGES} images: accuracy {acc:.4f}, "
          f"{'not measured' if not events else d2h} device-to-host readback(s); {card}")
    # DeviceDataLoader over a DataLoader: staged, pinned, equal batches
    ddir = os.path.join(tmp, "ddl_trace")
    with profiling.trace(ddir):
        got = [(a, b) for a, b in DeviceDataLoader(DataLoader(TensorDataset(xe, ye), CNN_B),
                                                      device="cuda")]
    events = trace_device_events(ddir)
    copies = [e for e in events if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]]
    equal = len(got) == CNN_EVAL_IMAGES // CNN_B and all(
        a.is_cuda and b.is_cuda and np.array_equal(a.cpu().numpy(), xe[i * CNN_B:(i + 1) * CNN_B])
        and np.array_equal(b.cpu().numpy(), ye[i * CNN_B:(i + 1) * CNN_B])
        for i, (a, b) in enumerate(got))
    pinned = sum("Pinned" in c["name"] for c in copies)
    if not equal or (copies and pinned != len(copies)):
        fail(f"DeviceDataLoader: batches equal {equal}, {pinned} of {len(copies)} copies pinned")
    r.update(device_loader_batches=len(got), device_loader_copies=len(copies),
             device_loader_pinned=pinned)
    print(f"  DeviceDataLoader: {len(got)} batches on the card equal to the host's; "
          f"{pinned} of {len(copies)} copies from pinned memory")
    report["cnn_trainer"] = r
    return counts


def pretrained_phase(torch, dt, report, card, tmp):
    """A seeded ResNet-50 -> export_torch_state_dict -> torch.save (.pth)
    -> convert_weights_to_deepflows -> load_pretrained_model into a fresh
    ResNet-50 on the card: eval logits at B 32 bitwise equal."""
    import numpy as np

    from deepflows_tpu_torch.utils import pretrained_models as pre

    src = cnn_model(dt, "ResNet50", seed=3)
    with torch.no_grad():  # running statistics that are not the init's
        for name, b in src.named_buffers():
            if name.endswith("running_mean"):
                b.uniform_(-0.1, 0.1)
            elif name.endswith("running_var"):
                b.uniform_(0.5, 1.5)
    t0 = time.perf_counter()
    pth = os.path.join(tmp, "resnet50_torch.pth")
    torch.save({k: torch.from_numpy(v) for k, v in pre.export_torch_state_dict(src).items()}, pth)
    out = pre.convert_weights_to_deepflows("resnet50", pth, pretrained_dir=tmp)
    fresh = cnn_model(dt, "ResNet50", seed=4)
    pre.load_pretrained_model(fresh, "resnet50", pretrained_dir=tmp, strict=True)
    secs = time.perf_counter() - t0
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (PRETRAINED_B, 3, CNN_IMAGE, CNN_IMAGE)).astype(np.float32), device="cuda")
    src.eval()
    fresh.eval()
    with torch.no_grad():
        same = torch.equal(src(x), fresh(x))
    if not same:
        fail("the converted ResNet-50's eval logits differ from the source's")
    meta = pre.load_model_metadata("resnet50", tmp)
    report["pretrained"] = dict(seconds=secs, arrays=meta["num_arrays"],
                                pth_bytes=os.path.getsize(pth), pkl_bytes=os.path.getsize(out))
    print(f"  ResNet-50 exported, saved ({os.path.getsize(pth)} bytes), converted "
          f"({meta['num_arrays']} arrays) and loaded strictly in {secs:.2f} s: eval logits at "
          f"B {PRETRAINED_B} bitwise equal to the source's")


def seeded_arrays(shapes, seed):
    """numpy f32 arrays from default_rng(seed): ones for norm weights, zeros
    for biases, else uniform with standard deviation HF_STD."""
    import numpy as np

    rng = np.random.default_rng(seed)
    half = HF_STD * math.sqrt(3.0)
    out = {}
    for key, shape in shapes.items():
        if "norm" in key or key.endswith(("ln_1.weight", "ln_2.weight", "ln_f.weight")):
            out[key] = np.ones(shape, np.float32)
        elif key.endswith(".bias"):
            out[key] = np.zeros(shape, np.float32)
        else:
            a = rng.random(shape, dtype=np.float32)
            a -= 0.5
            a *= 2 * half
            out[key] = a
    return out


def hf_llama_shapes(cfg):
    """HF's key names and (out, in) layouts of a Llama / Mistral state dict."""
    D, F, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kv = D // cfg.num_attention_heads * cfg.num_key_value_heads
    shapes = {"model.embed_tokens.weight": (V, D)}
    for i in range(cfg.num_hidden_layers):
        p = f"model.layers.{i}."
        shapes.update({
            p + "input_layernorm.weight": (D,), p + "self_attn.q_proj.weight": (D, D),
            p + "self_attn.k_proj.weight": (kv, D), p + "self_attn.v_proj.weight": (kv, D),
            p + "self_attn.o_proj.weight": (D, D), p + "post_attention_layernorm.weight": (D,),
            p + "mlp.gate_proj.weight": (F, D), p + "mlp.up_proj.weight": (F, D),
            p + "mlp.down_proj.weight": (D, F)})
    shapes.update({"model.norm.weight": (D,), "lm_head.weight": (V, D)})
    return shapes


def port_llama_arrays(sd, depth):
    """The same arrays in the port's (and the JAX package's) names and
    (in, out) layout, for load_jax_state_dict."""
    out = {"tok_embed.weight": sd["model.embed_tokens.weight"], "norm.weight": sd["model.norm.weight"],
           "head.weight": sd["lm_head.weight"].T}
    pairs = (("attn.q_proj", "self_attn.q_proj"), ("attn.k_proj", "self_attn.k_proj"),
             ("attn.v_proj", "self_attn.v_proj"), ("attn.out_proj", "self_attn.o_proj"),
             ("gate", "mlp.gate_proj"), ("up", "mlp.up_proj"), ("down", "mlp.down_proj"))
    for i in range(depth):
        p, h = f"blocks.{i}.", f"model.layers.{i}."
        out[p + "norm1.weight"] = sd[h + "input_layernorm.weight"]
        out[p + "norm2.weight"] = sd[h + "post_attention_layernorm.weight"]
        for ours, theirs in pairs:
            out[p + ours + ".weight"] = sd[h + theirs + ".weight"].T
    return out


def hf_gpt2_shapes(cfg):
    D, V = cfg.n_embd, cfg.vocab_size
    shapes = {"transformer.wte.weight": (V, D), "transformer.wpe.weight": (cfg.n_positions, D)}
    for i in range(cfg.n_layer):
        p = f"transformer.h.{i}."
        shapes.update({
            p + "ln_1.weight": (D,), p + "ln_1.bias": (D,),
            p + "attn.c_attn.weight": (D, 3 * D), p + "attn.c_attn.bias": (3 * D,),
            p + "attn.c_proj.weight": (D, D), p + "attn.c_proj.bias": (D,),
            p + "ln_2.weight": (D,), p + "ln_2.bias": (D,),
            p + "mlp.c_fc.weight": (D, 4 * D), p + "mlp.c_fc.bias": (4 * D,),
            p + "mlp.c_proj.weight": (4 * D, D), p + "mlp.c_proj.bias": (D,)})
    shapes.update({"transformer.ln_f.weight": (D,), "transformer.ln_f.bias": (D,)})
    return shapes


def hf_llama_phase(torch, dt, report, card):
    """An HF-layout Llama state dict at Mistral-7B widths (depth 2) through
    build_llama_from_hf_config and load_hf_llama_state, decoded greedily on
    the graphed decoder: tokens and logits equal to the same arrays loaded
    through load_jax_state_dict."""
    import numpy as np

    from deepflows_tpu_torch import nn
    from deepflows_tpu_torch.models import KVCacheDecoder, LlamaLM
    from deepflows_tpu_torch.utils import (
        build_llama_from_hf_config,
        load_hf_llama_state,
        load_jax_state_dict,
    )

    cfg = HF_LLAMA
    t0 = time.perf_counter()
    sd = seeded_arrays(hf_llama_shapes(cfg), HF_SEED)
    t1 = time.perf_counter()
    lm = build_llama_from_hf_config(cfg, max_len=HF_LLAMA_MAX_LEN, device="cuda")
    load_hf_llama_state(lm, sd)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    twin = LlamaLM(**dict(MISTRAL, depth=cfg.num_hidden_layers, max_len=HF_LLAMA_MAX_LEN),
                   device="cuda")
    for m in twin.modules():
        if isinstance(m, nn.RMSNorm):
            m.eps = cfg.rms_norm_eps
    load_jax_state_dict(twin, port_llama_arrays(sd, cfg.num_hidden_layers))
    del sd
    B, P, new = HF_LLAMA_REQUEST
    ids = np.random.default_rng(HF_SEED).integers(0, cfg.vocab_size, (B, P))
    idx = torch.as_tensor(ids, device="cuda")
    toks, logits = [], []
    for m in (lm, twin):
        m.eval()
        with torch.no_grad():
            logits.append(m(idx))
        dec = KVCacheDecoder(m, compute_dtype=torch.bfloat16)
        toks.append(dec.generate(ids, new))
        if loop_key(dec, "decode", B) not in dec._graphs:
            fail("the converted Llama's decode loop has no graph")
        del dec
    if lm.blocks[0].attn.window != cfg.sliding_window:
        fail(f"sliding_window {cfg.sliding_window} became window {lm.blocks[0].attn.window}")
    same_t, same_l = np.array_equal(*toks), torch.equal(*logits)
    if not (same_t and same_l):
        fail(f"the HF-loaded Llama differs from load_jax_state_dict's: tokens equal {same_t}, "
             f"logits equal {same_l}")
    n = sum(p.numel() for p in lm.parameters())
    report["hf_llama"] = dict(parameters=n, arrays_s=t1 - t0, load_s=t2 - t1)
    print(f"  HF Llama (Mistral-7B widths, depth {cfg.num_hidden_layers}, {n} parameters): "
          f"seeded arrays {t1 - t0:.2f} s, built and loaded on the card {t2 - t1:.2f} s; greedy "
          f"B {B}, prompt {P}, +{new} on the graphed decoder: tokens and f32 logits bitwise equal "
          f"to load_jax_state_dict's")
    del lm, twin, logits
    free_card(torch)


def gpt2_phase(torch, dt, report, card):
    """A main path: an HF-layout GPT-2 (GPT-2 small's widths) converted and
    trained GPT2_STEPS bf16 steps at B 8 x L 1024 with LMHeadCrossEntropy.
    Each of its kernels is then held against its plain twin at the shapes
    the path gives it and timed beside its bound, plain twin and library
    call: the CE at V 50257 on its wgmma route (w staged into padded rows;
    ce_case's tolerances), flash causal at (8, 12, 1024, 64) as (B, L, H,
    D) views on wgmma both ways (flash_case's), fused_adam over GPT-2's
    parameter list (adam_list_check).
    Returns (launch counts, {kernel: numbers})."""
    import numpy as np
    import torch.nn.functional as F

    from deepflows_tpu_torch import nn, ops, optim
    from deepflows_tpu_torch.jit import CompiledTrainStep
    from deepflows_tpu_torch.utils import build_gpt2_from_hf_config, load_hf_gpt2_state

    cfg = HF_GPT2
    lm = build_gpt2_from_hf_config(cfg, device="cuda")
    load_hf_gpt2_state(lm, seeded_arrays(hf_gpt2_shapes(cfg), HF_SEED + 1))
    if lm.blocks[0].mlp[1].approximate != "tanh" or lm.head.bias.detach().any():
        fail("the converted GPT-2 lacks its tanh GELU or keeps a head bias")
    step = CompiledTrainStep(lm.trunk(), optim.Adam(lm.parameters(), **GPT2_ADAM, fused=True),
                             nn.LMHeadCrossEntropy(lm.head), compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(HF_SEED)
    L, V = cfg.n_positions, cfg.vocab_size
    x = torch.as_tensor(rng.integers(0, V, (GPT2_B, L)), device="cuda")
    y = torch.as_tensor(rng.integers(0, V, (GPT2_B, L)), device="cuda")
    routed = (ops.flash_attention_fwd, ops.flash_attention_bwd, ops.fused_linear_ce_fwd,
              ops.fused_linear_ce_bwd)
    before = [dict(f.routes) for f in routed]
    (losses, wall, _), counts = counted(ops, lambda: run_steps(
        torch, step, x, y, GPT2_STEPS, "gpt2 training", GPT2_PER_STEP))
    print(f"main-path launches (gpt2_training): {counts}")
    routes = {f.__name__: {k: f.routes[k] - b[k] for k in f.routes if f.routes[k] - b[k]}
              for f, b in zip(routed, before)}
    for name in ("fused_linear_ce_fwd", "fused_linear_ce_bwd"):
        if routes[name] != {"wgmma": GPT2_STEPS}:
            fail(f"the GPT-2 CE's {name} took {routes[name]}, not wgmma")
    print(f"  fused_linear_ce_bwd launches by route: {routes['fused_linear_ce_bwd']}")
    for name in ("flash_attention_fwd", "flash_attention_bwd"):
        if set(routes[name]) != {"wgmma"}:
            fail(f"GPT-2's {name} took {routes[name]}, not wgmma alone")
    shapes = [tuple(p.shape) for p in lm.parameters()]
    n = sum(p.numel() for p in lm.parameters())
    print(f"  GPT-2 ({n} parameters, {cfg.n_layer} x d{cfg.n_embd}, V {V}): losses "
          f"{[round(v, 4) for v in losses]}, step {statistics.median(wall[1:]):.3f} ms wall; "
          f"routes {routes}")
    del lm, step
    free_card(torch)
    g = torch.Generator(device="cuda").manual_seed(17)
    N, D, H = GPT2_B * L, cfg.n_embd, cfg.n_head
    # the CE call at the step's shape: (N, D, V) = (B L, 768, 50257), bf16
    ce_ops, want, errs = ce_routed(torch, ops, g, (N, D, V), torch.bfloat16, "GPT-2 head")
    cx, cw, cb, ct, clse, cgr = ce_ops
    xr, wr, br = (a.detach().requires_grad_() for a in (cx, cw, cb))
    tl = torch.where((ct >= 0) & (ct < V), ct, -100)
    lib_loss = F.cross_entropy((torch.matmul(xr, wr) + br).float(), tl, reduction="none")
    # flash at the step's shape and layout: q, k, v and dout (B, L, H, D)
    # seen as (B, H, L, D), as MultiheadAttention passes them
    fops, _, ferrs, _, _ = flash_case(torch, ops, g, GPT2_B, H, L, L, D // H, True, None,
                                      torch.bfloat16, "GPT-2", "heads", "wgmma", "wgmma")
    q, k, v, o, lse, do = fops
    qr, kr, vr = (a.detach().requires_grad_() for a in (q, k, v))
    sdpa = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True)
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def flush():
        flush_buf.zero_()

    ce_at, fl_at = f"N {N}, D {D}, V {V}, bf16", f"({GPT2_B}, {H}, {L}, {D // H}) causal, bf16"
    # (plain twin, library call, the wrapper's arguments, route, at, max abs
    # err); the CE forward is timed with its staging copy of w, the backward
    # on that copy, as fused_linear_ce runs them
    runs = {
        "fused_linear_ce_fwd": (
            lambda: ops.fused_linear_ce_plain(cx, cw, cb, ct),
            lambda: F.cross_entropy((torch.matmul(cx, cw) + cb).float(), tl, reduction="none"),
            (cx, cw, cb, ct), "wgmma", ce_at, max(errs[n][1] for n in ("loss", "lse"))),
        "fused_linear_ce_bwd": (
            lambda: ops.fused_linear_ce_bwd_plain(cx, cw, cb, ct, clse, cgr),
            lambda: torch.autograd.grad(lib_loss, (xr, wr, br), cgr, retain_graph=True),
            (cx, ops.fused_ce._staged(cw), cb, ct, clse, cgr), "wgmma", ce_at,
            max(errs[n][1] for n in ("dx", "dw", "db"))),
        "flash_attention_fwd": (
            lambda: ops.flash_attention_plain(q, k, v, True),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
            (q, k, v, True), "wgmma", fl_at, max(ferrs["out"][1], ferrs["lse"][1])),
        "flash_attention_bwd": (
            lambda: ops.flash_attention_bwd_plain(q, k, v, o, lse, do, True),
            lambda: torch.autograd.grad(sdpa, (qr, kr, vr), do, retain_graph=True),
            (q, k, v, o, lse, do, True), "wgmma", fl_at,
            max(ferrs[n][1] for n in ("dq", "dk", "dv"))),
    }
    out = {}
    for name, (plain, lib, args, route, at, err) in runs.items():
        kern = getattr(ops, name)
        r = dict(ms=event_ms(lambda: kern(*args), 3, flush), plain_ms=event_ms(plain, 3, flush),
                 library_ms=event_ms(lib, 3, flush), route=route, at=at, max_abs_err=err)
        r["bound_ms"], r["bound_by"] = cost_bound(kern, *args)
        out[name] = r
        print(f"  {name} at GPT-2's {at} ({route} route): {r['ms']:.4f} ms; bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain {r['plain_ms']:.4f} ms, library "
              f"{r['library_ms']:.4f} ms; max abs err {err:.3g}; {card}")
    del lib_loss, sdpa, ce_ops, want, fops
    free_card(torch)
    out["fused_adam"] = adam_list_check(torch, shapes, "GPT-2 small")
    report["gpt2"] = dict(losses=losses, parameters=n, routes=routes, kernels=out,
                          ce_errors={k: v[0] for k, v in errs.items()},
                          flash_errors={k: v[0] for k, v in ferrs.items()})
    free_card(torch)
    return counts, out


def utils_phases(torch, dt, phase, report, card):
    """The utils slice: text_trainer (the slice's main path), cnn_trainer,
    pretrained and hf_interop (HF Llama, then GPT-2's training path).
    Returns ({path: launch counts}, GPT-2's kernel numbers)."""
    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix=".utils_ckpt_", dir=ROOT)
    marks = [time.perf_counter()]
    paths = {}
    try:
        phase("text_trainer (main path): the repository's markdown, BPE, LMDataset, Trainer.fit, "
              "the checkpoint, greedy text:")
        paths["text_trainer"] = text_trainer_phase(torch, dt, report, card, tmp)
        free_card(torch)
        marks.append(time.perf_counter())
        phase("cnn_trainer (main path): ResNet-50 through Trainer.fit with augmentation, "
              "evaluate, DeviceDataLoader:")
        paths["cnn_trainer"] = cnn_trainer_phase(torch, dt, report, card, tmp)
        free_card(torch)
        marks.append(time.perf_counter())
        phase("pretrained: ResNet-50 exported, converted and loaded:")
        pretrained_phase(torch, dt, report, card, tmp)
        free_card(torch)
        marks.append(time.perf_counter())
        phase("hf_interop: an HF Llama at Mistral-7B widths, GPT-2 trained (main path):")
        hf_llama_phase(torch, dt, report, card)
        paths["gpt2_training"], gpt2 = gpt2_phase(torch, dt, report, card)
        marks.append(time.perf_counter())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    secs = dict(zip(("text_trainer_s", "cnn_trainer_s", "pretrained_s", "hf_interop_s"),
                    (b - a for a, b in zip(marks, marks[1:]))))
    secs["total_s"] = marks[-1] - marks[0]
    report["utils_phases_s"] = secs
    print("  utils phases: " + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    return paths, gpt2


# ------------------------------------------------------------- the parallel slice
PAR_STEPS = 3  # steps of each layout on the TRAIN model
PAR_EP_STEPS = 2  # steps of the expert-parallel MixtralLM
PAR_LAYOUTS = (  # (name, placement rule, ShardedTrainStep keywords) on {data: 1, model: 1}
    ("dp", None, {}),
    ("tp", "tp", {}),
    ("fsdp_tp", "fsdp_tp", {}),
    ("zero1", None, {"zero_shard_state": True}),
)
PAR_LOSS_TOL = 1e-3  # a sharded run's loss against the plain run's, relative
# a parameter's distance from the plain run's over the plain run's change,
# by norm: one rank computes the plain step's ops, but the embedding's and
# the CE's backward sum with atomics, and Adam's m / sqrt(v) turns a
# near-zero gradient's last bits into a step of up to lr
PAR_PARAM_TOL = 1e-2
PAR_EP_PER_STEP = {"flash_attention_fwd": MIXTRAL_TRAIN["depth"],
                   "flash_attention_bwd": MIXTRAL_TRAIN["depth"], "fused_adam": 1}
PAR_RING_TOL = TOL["bf16"]  # the ring's f32 attention against flash's bf16, relative loss
PAR_MULTI = (  # (name, mesh axes over n ranks, rule, ring): the part on more than one card
    ("dp", lambda n: {"data": n}, None, False),
    ("fsdp", lambda n: {"data": n}, "fsdp", False),
    ("ring", lambda n: {"data": n // 2, "model": 2}, None, True),
)
PAR_MULTI_TIMEOUT_S = 300
# Every rank also trains each layout's one-card twin on its own card: the
# rows of a rank of the data axis a microbatch (accum_steps = the axis's
# size), so that the twin's products have the ranks' shapes and only the
# order of the gradients' f32 sum differs (the ring's twin is the one-chunk
# ring, whose f32 chunk merge differs too).  Against the plain step, bf16
# products of other shapes moved the losses by up to 6.8e-4 on 4 H100s
# (PERF.md section 6); the bounds below were set before the run that
# first held the twins.
PAR_MULTI_TWIN_TOL = 2e-4  # a layout's losses against its twin's, relative
PAR_MULTI_PLAIN_TOL = 3e-3  # against the one-card plain step's, relative
# The first step's gradients against the twin's, relative by the global
# norm: held before any update.  The ring's chunked f32 softmax merge
# rounds a few bf16 activations the other way, and Adam's first updates
# carry that into the later losses as far as bf16 products of other shapes
# do (its losses 9.3e-4 and weights 0.10 of their change off the twin's on
# 4 H100s): its later losses are held at PAR_MULTI_PLAIN_TOL and its
# weights are printed, not held.
PAR_MULTI_GRAD_TOL = 1e-2


def par_rules(name, mesh):
    from deepflows_tpu_torch.parallel import (expert_parallel_rules, fsdp_rules,
                                              tensor_parallel_rules)

    return {None: lambda: None, "tp": lambda: tensor_parallel_rules("model"),
            "fsdp": lambda: fsdp_rules(mesh),
            "fsdp_tp": lambda: fsdp_rules(mesh, base=tensor_parallel_rules("model")),
            "ep": lambda: expert_parallel_rules("model")}[name]()


def par_batch(torch, device):
    """The training phase's batch (bench.py's: numpy default_rng(0))."""
    import numpy as np

    rng = np.random.default_rng(0)
    V = TRAIN["vocab_size"]
    return tuple(torch.as_tensor(rng.integers(0, V, (TRAIN_B, TRAIN_L)).astype(np.int32),
                                 device=device) for _ in range(2))


def par_lm_build(torch, dt, device, ring=None):
    """A builder of the TRAIN model from seed 0 with fused Adam and
    LMHeadCrossEntropy (``par_run``'s ``build``)."""
    from deepflows_tpu_torch import nn, optim
    from deepflows_tpu_torch.models import TransformerLM

    def build():
        dt.manual_seed(0)
        lm = TransformerLM(**TRAIN, device=device, flash=True, ring=ring)
        return (lm, lm.trunk(), optim.Adam(lm.parameters(), **ADAM, fused=True),
                nn.LMHeadCrossEntropy(lm.head))

    return build


def parallel_rank(rank, world, port, out, device="cuda"):
    """One rank of the part on more cards (a process of its own, started by
    ``parallel_multi``): joins an NCCL group of ``world`` ranks, one card
    each, trains the TRAIN model by the plain step and under each layout of
    PAR_MULTI beside the layout's one-card twin, each step's launches held
    to the plain step's, and measures each layout's losses and weights
    against the twin's and the plain step's (``par_diffs``) and its first
    step's gradients against the twin's.  Every rank
    writes its numbers and a fingerprint of its final weights to
    ``out``.<rank> as JSON; ``parallel_multi`` holds them to the bounds."""
    import torch

    sys.path.insert(0, ROOT)
    import deepflows_tpu_torch as dt
    from deepflows_tpu_torch.parallel import init_process_group, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = init_process_group(device, rank, world, f"tcp://127.0.0.1:{port}")
    per_ring = dict(PER_STEP, flash_attention_fwd=0, flash_attention_bwd=0)
    res = {}
    try:
        x, y = par_batch(torch, dev)
        # a one-rank mesh for each card (every rank makes all of them)
        one = [make_mesh({"data": 1, "model": 1}, [r]) for r in range(world)][rank]

        def build(ring=False, mesh=None):
            return par_lm_build(torch, dt, dev, (mesh, "model") if ring else None)

        init = whole_params(torch, build()()[0])
        plain, _, plain_params = par_run(torch, build(), x, y, PAR_STEPS, PER_STEP,
                                         f"rank {rank}: plain")
        res["plain"] = plain
        for name, axes, rules, ring in PAR_MULTI:
            mesh = make_mesh(axes(world))
            d = axes(world)["data"]
            per = per_ring if ring else PER_STEP
            twin_grads, keep = first_grads(torch)
            twin, _, twin_params = par_run(
                torch, build(ring, one), x, y, PAR_STEPS, accumulated(per, d),
                f"rank {rank}: {name}'s twin", one if ring else None, accum_steps=d,
                grad_transform=keep)
            grads, keep = first_grads(torch)
            r, _, params = par_run(torch, build(ring, mesh), x, y, PAR_STEPS, per,
                                   f"rank {rank} of {world}, {name}", mesh, rules,
                                   grad_transform=keep)
            r.update(mesh=axes(world), ring=ring, twin=twin, fingerprint=fingerprint(params),
                     vs_twin=par_diffs(r, params, twin, twin_params, init))
            r["vs_twin"]["grad_rel_diff"] = float(
                sum(((a - b) ** 2).sum() for a, b in zip(grads, twin_grads) if b is not None)
                .sqrt() / sum((b ** 2).sum() for b in twin_grads if b is not None).sqrt())
            if not ring:
                r["vs_plain"] = par_diffs(r, params, plain, plain_params, init)
            res[name] = r
            del params, twin_params
            free_card(torch)
    finally:
        import torch.distributed as tdist

        tdist.destroy_process_group()
    with open(f"{out}.{rank}", "w") as f:
        json.dump(res, f)
    return 0


def first_grads(torch):
    """A list and a ``grad_transform`` that fills it with the first step's
    gradients (f32, on the host), passing every step's through."""
    kept = []

    def keep(grads):
        if not kept:
            kept.extend(None if g is None else g.detach().float().cpu() for g in grads)
        return grads

    return kept, keep


def accumulated(per_step, n):
    """Launches a step with ``accum_steps=n``: the forward and backward
    kernels n times, the update once."""
    return {k: v if k.startswith("fused_adam") else v * n for k, v in per_step.items()}


def fingerprint(params):
    """Each weight's sum and sum of magnitudes (f64): equal on every rank
    that holds the same weights."""
    return {n: [float(p.double().sum()), float(p.double().abs().sum())]
            for n, p in params.items()}


def parallel_multi(torch, plain, card):
    """With more than one card: one process per card (an even count) runs
    ``parallel_rank``; fails unless every rank passed its checks and every
    rank holds the same losses and weights under each layout.  Returns
    their numbers, or None on one card."""
    import shutil
    import socket
    import tempfile

    n = torch.cuda.device_count()
    n -= n % 2
    if n < 2:
        print("  one card: the part on more cards is not run")
        return None
    tmp = tempfile.mkdtemp(prefix=".parallel_", dir=ROOT)
    out = os.path.join(tmp, "rank")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--parallel-rank",
                               str(r), "--parallel-world", str(n), "--parallel-port", str(port),
                               "--parallel-out", out]) for r in range(n)]
    deadline = time.monotonic() + PAR_MULTI_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    try:
        if any(rcs) or not all(os.path.exists(f"{out}.{r}") for r in range(n)):
            fail(f"parallel ranks on {n} cards exited with {rcs}")
        ranks = []
        for r in range(n):
            with open(f"{out}.{r}") as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res = ranks[0]
    for name, r in res.items():
        if name == "plain":
            continue
        for k, other in enumerate(ranks[1:], 1):
            if (other[name]["losses"] != r["losses"]
                    or other[name]["fingerprint"] != r["fingerprint"]):
                fail(f"parallel {name} on {n} cards: rank {k}'s losses or weights differ from "
                     f"rank 0's ({other[name]['losses']} against {r['losses']})")
        r.pop("fingerprint")
        # the weights are held against the twin's: against the plain step's,
        # bf16 products of other shapes move them by more than arithmetic
        # order does, and that distance is printed alone
        held = [("its twin", r["vs_twin"], PAR_MULTI_PLAIN_TOL if r["ring"]
                 else PAR_MULTI_TWIN_TOL, None if r["ring"] else PAR_PARAM_TOL)]
        if "vs_plain" in r:
            held.append(("the plain step", r["vs_plain"], PAR_MULTI_PLAIN_TOL, None))
        print(f"  {n} cards, {name} on {r['mesh']}: losses {[round(v, 5) for v in r['losses']]}"
              f" and weights the same on every rank; step wall ms "
              f"{[round(v, 2) for v in r['wall_ms']]} (one card: twin "
              f"{[round(v, 2) for v in r['twin']['wall_ms']]}, plain "
              f"{[round(v, 2) for v in res['plain']['wall_ms']]}), peak "
              f"{r['peak_memory_gb']:.2f} GB a card (twin {r['twin']['peak_memory_gb']:.2f}, "
              f"plain {res['plain']['peak_memory_gb']:.2f}); " + "; ".join(
                  f"against {what}: loss rel diff {dif['loss_rel_diff']:.3g} (limit {tol}), "
                  f"weight diff / change {dif['param_rel_diff']:.3g} (limit {ptol})"
                  for what, dif, tol, ptol in held)
              + f"; the first step's gradients against the twin's {r['vs_twin']['grad_rel_diff']:.3g}"
              f" by norm (limit {PAR_MULTI_GRAD_TOL}); {card}")
        if not r["vs_twin"]["grad_rel_diff"] < PAR_MULTI_GRAD_TOL:
            fail(f"parallel {name} on {n} cards: the first step's gradients differ from the "
                 f"twin's by {r['vs_twin']['grad_rel_diff']} of their norm")
        for what, dif, tol, ptol in held:
            if not (dif["loss_rel_diff"] < tol
                    and (ptol is None or dif["param_rel_diff"] < ptol)):
                fail(f"parallel {name} on {n} cards against {what}: {dif}")
    for k, other in enumerate(ranks):
        if other["plain"]["losses"] != plain["losses"]:
            print(f"  note: rank {k}'s plain losses {other['plain']['losses']} against card "
                  f"0's one-rank run {plain['losses']}")
    return dict(cards=n, runs=res)


def whole_params(torch, model):
    """Every parameter's whole value in f32, by name (a DTensor gathered)."""
    from torch.distributed.tensor import DTensor

    with torch.no_grad():
        return {n: (p.full_tensor() if isinstance(p, DTensor) else p.detach()).float().clone()
                for n, p in model.named_parameters()}


def par_run(torch, build, x, y, steps, per_step, label, mesh=None, rules=None, **kw):
    """Train a fresh model ``build() -> (model, trunk, optimizer,
    criterion)`` for ``steps`` steps, by ``CompiledTrainStep`` or (with a
    mesh) ``ShardedTrainStep``, with bf16 compute and the step's keywords
    ``kw``; each step's launches must be ``per_step``.  Returns its
    numbers, launch counts and final weights."""
    from deepflows_tpu_torch import ops
    from deepflows_tpu_torch.jit import CompiledTrainStep
    from deepflows_tpu_torch.parallel import ShardedTrainStep

    model, trunk, opt, crit = build()
    if mesh is None:
        step = CompiledTrainStep(trunk, opt, crit, compute_dtype=torch.bfloat16, **kw)
    else:
        step = ShardedTrainStep(trunk, opt, crit, mesh, param_rules=par_rules(rules, mesh),
                                compute_dtype=torch.bfloat16, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()  # the path starts here
    losses, wall, _ = run_steps(torch, step, x, y, steps, label, per_step)
    counts = {k.__name__: k.launches for k in ops.KERNELS}  # the path ends here
    r = dict(losses=losses, wall_ms=wall, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    params = whole_params(torch, model)
    del step, opt, crit, trunk, model
    free_card(torch)
    return r, counts, params


def par_diffs(r, params, ref, ref_params, init):
    """A run's largest relative loss difference from the reference run's,
    its largest weight difference, and its largest weight difference by
    norm over the reference's change from ``init``."""
    return dict(
        loss_rel_diff=max(abs(a - b) / abs(b) for a, b in zip(r["losses"], ref["losses"])),
        param_max_abs_diff=max(float((p - ref_params[n]).abs().max())
                               for n, p in params.items()),
        param_rel_diff=max(float((p - ref_params[n]).norm()
                                 / (ref_params[n] - init[n]).norm().clamp_min(1e-30))
                           for n, p in params.items()))


def par_compare(torch, r, params, ref, ref_params, init, label, loss_tol=PAR_LOSS_TOL):
    """Hold a run's losses and weights against the plain run's; fails past
    the tolerances, prints and records the largest differences."""
    r.update(par_diffs(r, params, ref, ref_params, init))
    print(f"  {label}: losses {[round(v, 5) for v in r['losses']]}, step wall ms "
          f"{[round(v, 2) for v in r['wall_ms']]} (plain {[round(v, 2) for v in ref['wall_ms']]}),"
          f" peak {r['peak_memory_gb']:.2f} GB (plain {ref['peak_memory_gb']:.2f}); max loss rel "
          f"diff {r['loss_rel_diff']:.3g} (limit {loss_tol}), max |weight diff| "
          f"{r['param_max_abs_diff']:.3g}, max weight diff / change {r['param_rel_diff']:.3g} "
          f"(limit {PAR_PARAM_TOL})")
    if not r["loss_rel_diff"] < loss_tol:
        fail(f"parallel {label}: losses {r['losses']} against the plain step's {ref['losses']}")
    if not r["param_rel_diff"] < PAR_PARAM_TOL:
        fail(f"parallel {label}: weights differ from the plain step's by "
             f"{r['param_rel_diff']} of their change")


def parallel_one_rank(torch, dt, x, y, plain, init, ref_params, tmp, runs, paths):
    """``parallel_phase``'s part on a one-rank NCCL group: the layouts of
    PAR_LAYOUTS, the ring and expert-parallel MixtralLM; records into
    ``runs`` and ``paths``."""
    import numpy as np
    import torch.distributed as tdist

    from deepflows_tpu_torch import nn, optim
    from deepflows_tpu_torch.models import MixtralLM
    from deepflows_tpu_torch.parallel import init_process_group, make_mesh

    def lm_build(ring=None):
        return par_lm_build(torch, dt, "cuda", ring)

    init_process_group("cuda", rank=0, world_size=1,
                       store=tdist.FileStore(os.path.join(tmp, "store"), 1))
    mesh = make_mesh({"data": 1, "model": 1})
    for name, rules, kw in PAR_LAYOUTS:
        r, counts, params = par_run(torch, lm_build(), x, y, PAR_STEPS, PER_STEP,
                                    f"parallel {name}", mesh, rules, **kw)
        par_compare(torch, r, params, plain, ref_params, init, name)
        runs[name], paths[f"parallel_{name}"] = r, counts
        del params
    per_ring = dict(PER_STEP, flash_attention_fwd=0, flash_attention_bwd=0)
    r, counts, params = par_run(torch, lm_build((mesh, "model")), x, y, PAR_STEPS, per_ring,
                                "parallel ring", mesh)
    r["loss_rel_diff"] = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], plain["losses"]))
    print(f"  ring (one chunk of L {TRAIN_L}): losses {[round(v, 5) for v in r['losses']]}, "
          f"step wall ms {[round(v, 2) for v in r['wall_ms']]} (flash "
          f"{[round(v, 2) for v in plain['wall_ms']]}), peak {r['peak_memory_gb']:.2f} GB "
          f"(flash {plain['peak_memory_gb']:.2f}); max loss rel diff against flash "
          f"{r['loss_rel_diff']:.3g} (limit {PAR_RING_TOL})")
    if not r["loss_rel_diff"] < PAR_RING_TOL:
        fail(f"parallel ring: losses {r['losses']} against flash's {plain['losses']}")
    runs["ring"], paths["parallel_ring"] = r, counts
    del init, ref_params, params
    free_card(torch)

    def mixtral_build():
        lm = family_model(torch, dt, MixtralLM, MIXTRAL_TRAIN, 3, serve=False)
        return (lm, lm, optim.Adam(lm.parameters(), **FAMILY_ADAM, fused=True),
                nn.MoECriterion(nn.CrossEntropyLoss(), lm))

    L, Vm = MIXTRAL_TRAIN["max_len"], MIXTRAL_TRAIN["vocab_size"]
    rng = np.random.default_rng(3)  # the family training phase's batch
    xm = torch.as_tensor(rng.integers(0, Vm, (1, L)).astype(np.int32), device="cuda")
    ym = torch.as_tensor(rng.integers(0, Vm, (1, L)).astype(np.int32), device="cuda")
    per_ep = PAR_EP_PER_STEP
    init = whole_params(torch, mixtral_build()[0])
    free_card(torch)
    ref, _, ref_params = par_run(torch, mixtral_build, xm, ym, PAR_EP_STEPS, per_ep,
                                 "plain mixtral")
    r, counts, params = par_run(torch, mixtral_build, xm, ym, PAR_EP_STEPS, per_ep,
                                "parallel ep", mesh, "ep")
    par_compare(torch, r, params, ref, ref_params, init, "ep (MixtralLM, MoECriterion)")
    runs["mixtral_plain"], runs["ep"], paths["parallel_ep"] = ref, r, counts
    del init, ref_params, params, xm, ym
    tdist.destroy_process_group()


def parallel_phase(torch, dt, report, card, multi_only=False):
    """The parallel slice's main path on one card: a one-rank NCCL group
    (a FileStore in a temporary directory of the checkout) and a mesh
    {data: 1, model: 1}.  The TRAIN model trains PAR_STEPS steps by the
    plain CompiledTrainStep and by ShardedTrainStep under each layout of
    PAR_LAYOUTS, each from the same seeded weights, with fused Adam and
    LMHeadCrossEntropy: every sharded step launches flash, the CE and
    fused_adam as the plain step does, and its losses and weights are held
    against the plain run's.  Then the same model with ring=(mesh,
    "model"), held against the flash model's losses (PAR_RING_TOL), and
    MixtralLM at MIXTRAL_TRAIN with expert_parallel_rules and MoECriterion
    against its plain step.  Last, with more than one card,
    ``parallel_multi``.  ``multi_only``: the plain run and that part
    alone.  Returns {path: launch counts}."""
    import shutil
    import tempfile

    import torch.distributed as tdist

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix=".parallel_", dir=ROOT)
    paths, runs = {}, {}
    try:
        x, y = par_batch(torch, "cuda")

        def lm_build(ring=None):
            return par_lm_build(torch, dt, "cuda", ring)

        init = whole_params(torch, lm_build()()[0])
        plain, _, ref_params = par_run(torch, lm_build(), x, y, PAR_STEPS, PER_STEP, "plain")
        runs["plain"] = plain
        print(f"  plain CompiledTrainStep: losses {[round(v, 5) for v in plain['losses']]}, "
              f"step wall ms {[round(v, 2) for v in plain['wall_ms']]}")
        if not multi_only:
            parallel_one_rank(torch, dt, x, y, plain, init, ref_params, tmp, runs, paths)
        del x, y, init, ref_params
        free_card(torch)
        runs["multi"] = parallel_multi(torch, plain, card)
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
        report["parallel"] = out = dict(
            card=card, phase_s=time.perf_counter() - t0, steps=PAR_STEPS,
            ep_steps=PAR_EP_STEPS, mesh={"data": 1, "model": 1}, runs=runs)
    print(f"  parallel phase: {out['phase_s']:.1f} s; {card}")
    print(json.dumps({"parallel": out}))
    return paths


# ------------------------------------------------------------- the pipeline slice
PIPE_STEPS = 3  # steps of each schedule
PIPE_M = 4  # microbatches of the one-card runs (rows of 2)
PIPE_MULTI_M = 8  # microbatches on more cards (rows of 1)
PIPE_SCHEDULES = ("gpipe", "1f1b", "interleaved_1f1b")
PIPE_MULTI_TIMEOUT_S = 300


def pipe_per_step(blocks, micro):
    """Launches a pipelined step makes on a rank that runs ``blocks``
    blocks of ``micro`` microbatches: flash once a block a microbatch each
    way (the graphs are kept, nothing is recomputed), fused_adam once."""
    return {"flash_attention_fwd": blocks * micro, "flash_attention_bwd": blocks * micro,
            "fused_adam": 1}


def pipe_lm(torch, dt, device):
    from deepflows_tpu_torch.models import TransformerLM

    dt.manual_seed(0)
    return TransformerLM(**TRAIN, device=device, flash=True)


def pipe_twin(torch, dt, device, x, y, accum, label):
    """The plain CompiledTrainStep of the TRAIN model with ``accum``
    microbatches (fused Adam, the CE on f32 logits, bf16 compute): its
    numbers, launch counts and final weights by name."""
    from deepflows_tpu_torch import ops, optim
    from deepflows_tpu_torch.jit import CompiledTrainStep

    lm = pipe_lm(torch, dt, device)
    step = CompiledTrainStep(lm, optim.Adam(lm.parameters(), **ADAM, fused=True),
                             F32CrossEntropy(), compute_dtype=torch.bfloat16, accum_steps=accum)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, wall, _ = run_steps(torch, step, x, y, PIPE_STEPS, label,
                                pipe_per_step(TRAIN["depth"], accum))
    counts = {k.__name__: k.launches for k in ops.KERNELS}
    r = dict(losses=losses, wall_ms=wall, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9)
    params = whole_params(torch, lm)
    del step, lm
    free_card(torch)
    return r, counts, params


def pipe_stages(blocks, per_stage):
    """The blocks as stages of ``per_stage`` blocks (one: the blocks)."""
    from deepflows_tpu_torch import nn

    if per_stage == 1:
        return list(blocks)
    return [nn.Sequential(*blocks[k:k + per_stage]) for k in range(0, len(blocks), per_stage)]


def pipe_params(torch, step, stack, pre, post, per_stage):
    """A pipelined run's weights whole in f32 by the TransformerLM's names
    (stacked rows in logical order; every rank gathers)."""
    from torch.distributed.tensor import DTensor

    def whole(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t.detach()).float().clone()

    with torch.no_grad():
        out = {n: whole(p) for mod in (pre, post) for n, p in mod.named_parameters()}
        inv = step._stage_inv
        for name, p in zip(stack._param_names, stack.parameters()):
            full = whole(p)
            if inv is not None:
                full = full[torch.as_tensor(inv, device=full.device)]
            for s in range(full.shape[0]):
                if per_stage == 1:
                    out[f"blocks.{s}.{name}"] = full[s]
                else:
                    k, rest = name.split(".", 1)
                    out[f"blocks.{s * per_stage + int(k)}.{rest}"] = full[s]
    return out


def pipe_run(torch, dt, device, mesh, schedule, per_stage, micro, x, y, label):
    """Train the TRAIN model split by pipeline_partition() by
    PipelinedTrainStep over ``mesh``; every step's launches must be this
    rank's share.  Returns its numbers, launch counts, weights by name and
    the step (for eval_logits)."""
    from deepflows_tpu_torch import ops, optim
    from deepflows_tpu_torch.parallel import PipelinedTrainStep, PipelineStack
    from deepflows_tpu_torch.parallel.mesh import axis_size

    lm = pipe_lm(torch, dt, device)
    pre, blocks, post = lm.pipeline_partition()
    stack = PipelineStack(pipe_stages(blocks, per_stage))
    params = list(pre.parameters()) + list(stack.parameters()) + list(post.parameters())
    step = PipelinedTrainStep(stack, optim.Adam(params, **ADAM, fused=True), F32CrossEntropy(),
                              mesh, n_micro=micro, pre=pre, post=post,
                              compute_dtype=torch.bfloat16, schedule=schedule)
    del lm, blocks, params
    data = axis_size(mesh, "data") if "data" in mesh.mesh_dim_names else 1
    mine = TRAIN["depth"] // axis_size(mesh, "pipe")  # blocks on this rank
    per = pipe_per_step(mine, micro)
    free_card(torch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()  # the path starts here
    losses, wall, _ = run_steps(torch, step, x, y, PIPE_STEPS, label, per)
    counts = {k.__name__: k.launches for k in ops.KERNELS}  # the path ends here
    r = dict(losses=losses, wall_ms=wall, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
             bubble_fraction=step.bubble_fraction, n_micro=micro, data=data,
             launches_a_step=per)
    return r, counts, pipe_params(torch, step, stack, pre, post, per_stage), step


def pipe_eval_check(torch, dt, step, params, x, label):
    """eval_logits of a trained pipeline against the plain model's eval
    forward with the same weights (f32 masters: flash's f32 route both
    ways); fails past 1e-4 of the logits' scale."""
    from deepflows_tpu_torch.utils.convert import load_arrays

    got = step.eval_logits(x)
    ref = pipe_lm(torch, dt, "cuda")
    load_arrays(ref, {n: p for n, p in params.items()}, strict=False)
    ref.eval()
    with torch.no_grad():
        want = ref(x)
    err = float((got.float() - want.float()).abs().max() / want.float().abs().max().clamp_min(1))
    del ref, want, got
    free_card(torch)
    if not err < 1e-4:
        fail(f"pipeline {label}: eval_logits differ from the plain forward by {err}")
    return err


def pipe_multi_layouts(n):
    """(name, mesh axes, schedule, blocks a stage, microbatches) on n cards."""
    out = [("gpipe", {"pipe": n}, "gpipe", TRAIN["depth"] // n, PIPE_MULTI_M),
           ("1f1b", {"pipe": n}, "1f1b", TRAIN["depth"] // n, PIPE_MULTI_M),
           ("interleaved_1f1b", {"pipe": n}, "interleaved_1f1b", 1, PIPE_MULTI_M)]
    if n == 4:
        out.append(("gpipe_dp", {"data": 2, "pipe": 2}, "gpipe", TRAIN["depth"] // 2,
                    PIPE_MULTI_M // 2))
    return out


def pipeline_rank(rank, world, port, out, device="cuda"):
    """One rank of the pipeline part on more cards (a process of its own,
    started by ``pipeline_multi``): joins an NCCL group of ``world``
    ranks, trains the one-card twin (accum_steps 8: the ranks' rows) on its
    own card, then each layout of ``pipe_multi_layouts``, and writes each
    run's numbers, its distance from the twin and a fingerprint of its
    weights to ``out``.<rank> as JSON."""
    import torch

    sys.path.insert(0, ROOT)
    import deepflows_tpu_torch as dt
    from deepflows_tpu_torch.parallel import init_process_group, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = init_process_group(device, rank, world, f"tcp://127.0.0.1:{port}")
    res = {}
    try:
        x, y = par_batch(torch, dev)
        init = whole_params(torch, pipe_lm(torch, dt, dev))
        free_card(torch)
        twin, _, twin_params = pipe_twin(torch, dt, dev, x, y, PIPE_MULTI_M,
                                         f"rank {rank}: twin")
        res["twin"] = twin
        for name, axes, schedule, per_stage, micro in pipe_multi_layouts(world):
            r, _, params, step = pipe_run(torch, dt, dev, make_mesh(axes), schedule, per_stage,
                                          micro, x, y, f"rank {rank} of {world}, {name}")
            r.update(mesh=axes, fingerprint=fingerprint(params),
                     vs_twin=par_diffs(r, params, twin, twin_params, init))
            res[name] = r
            del params, step
            free_card(torch)
    finally:
        import torch.distributed as tdist

        tdist.destroy_process_group()
    with open(f"{out}.{rank}", "w") as f:
        json.dump(res, f)
    return 0


def pipeline_multi(torch, card):
    """With more than one card: one process per card (an even count) runs
    ``pipeline_rank``; fails unless every rank passed its checks, every
    rank holds the same losses and weights under each layout, and each is
    within the bounds of its twin.  Returns their numbers, or None on one
    card."""
    import shutil
    import socket
    import tempfile

    n = torch.cuda.device_count()
    n -= n % 2
    if n < 2:
        print("  one card: the part on more cards is not run")
        return None
    tmp = tempfile.mkdtemp(prefix=".pipeline_", dir=ROOT)
    out = os.path.join(tmp, "rank")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--pipeline-rank",
                               str(r), "--pipeline-world", str(n), "--pipeline-port", str(port),
                               "--pipeline-out", out]) for r in range(n)]
    deadline = time.monotonic() + PIPE_MULTI_TIMEOUT_S
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    try:
        if any(rcs) or not all(os.path.exists(f"{out}.{r}") for r in range(n)):
            fail(f"pipeline ranks on {n} cards exited with {rcs}")
        ranks = []
        for r in range(n):
            with open(f"{out}.{r}") as f:
                ranks.append(json.load(f))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res = ranks[0]
    for name, r in res.items():
        if name == "twin":
            continue
        for k, other in enumerate(ranks[1:], 1):
            if (other[name]["losses"] != r["losses"]
                    or other[name]["fingerprint"] != r["fingerprint"]):
                fail(f"pipeline {name} on {n} cards: rank {k}'s losses or weights differ from "
                     f"rank 0's ({other[name]['losses']} against {r['losses']})")
        r.pop("fingerprint")
        dif = r["vs_twin"]
        print(f"  {n} cards, {name} on {r['mesh']}, M {r['n_micro']}: losses "
              f"{[round(v, 5) for v in r['losses']]} and weights the same on every rank; step "
              f"wall ms {[round(v, 2) for v in r['wall_ms']]} (one-card twin "
              f"{[round(v, 2) for v in res['twin']['wall_ms']]}); bubble "
              f"{r['bubble_fraction']:.4f}; peak {r['peak_memory_gb']:.2f} GB a card (twin "
              f"{res['twin']['peak_memory_gb']:.2f}); against the twin: loss rel diff "
              f"{dif['loss_rel_diff']:.3g} (limit {PAR_LOSS_TOL}), weight diff / change "
              f"{dif['param_rel_diff']:.3g} (limit {PAR_PARAM_TOL}); {card}")
        if not (dif["loss_rel_diff"] < PAR_LOSS_TOL and dif["param_rel_diff"] < PAR_PARAM_TOL):
            fail(f"pipeline {name} on {n} cards against its twin: {dif}")
    return dict(cards=n, runs=res)


def pipeline_phase(torch, dt, report, card, multi_only=False):
    """The pipeline slice's main paths on one card: a one-rank NCCL group
    (a FileStore in a temporary directory of the checkout) and a mesh
    {pipe: 1}.  The TRAIN model trains PIPE_STEPS steps by the plain
    CompiledTrainStep with accum_steps=PIPE_M and by PipelinedTrainStep
    under each schedule from the same seeded weights; each is held to the
    plain run's launches, losses and weights, and its eval_logits to the
    plain model's forward.  Then, with more than one card,
    ``pipeline_multi``.  ``multi_only``: that part alone.  Returns {path:
    launch counts}."""
    import shutil
    import tempfile

    import torch.distributed as tdist

    from deepflows_tpu_torch.parallel import init_process_group, make_mesh

    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix=".pipeline_", dir=ROOT)
    paths, runs = {}, {}
    try:
        if not multi_only:
            x, y = par_batch(torch, "cuda")
            init = whole_params(torch, pipe_lm(torch, dt, "cuda"))
            free_card(torch)
            plain, _, ref_params = pipe_twin(torch, dt, "cuda", x, y, PIPE_M, "plain")
            runs["plain"] = plain
            print(f"  plain CompiledTrainStep (accum_steps={PIPE_M}): losses "
                  f"{[round(v, 5) for v in plain['losses']]}, step wall ms "
                  f"{[round(v, 2) for v in plain['wall_ms']]}, peak "
                  f"{plain['peak_memory_gb']:.2f} GB")
            init_process_group("cuda", rank=0, world_size=1,
                               store=tdist.FileStore(os.path.join(tmp, "store"), 1))
            mesh = make_mesh({"pipe": 1})
            for schedule in PIPE_SCHEDULES:
                per_stage = 1 if schedule == "interleaved_1f1b" else TRAIN["depth"]
                r, counts, params, step = pipe_run(torch, dt, "cuda", mesh, schedule, per_stage,
                                                   PIPE_M, x, y, f"pipeline {schedule}")
                r["eval_err"] = pipe_eval_check(torch, dt, step, params, x[:PIPE_M], schedule)
                par_compare(torch, r, params, plain, ref_params, init,
                            f"{schedule} (bubble {r['bubble_fraction']:.4f}; eval_logits "
                            f"{r['eval_err']:.2g} of the plain forward)")
                runs[schedule], paths[f"pipeline_{schedule}"] = r, counts
                del params, step
                free_card(torch)
            tdist.destroy_process_group()
            del x, y, init, ref_params
            free_card(torch)
        runs["multi"] = pipeline_multi(torch, card)
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
        report["pipeline"] = out = dict(
            card=card, phase_s=time.perf_counter() - t0, steps=PIPE_STEPS, n_micro=PIPE_M,
            mesh={"pipe": 1}, runs=runs)
    print(f"  pipeline phase: {out['phase_s']:.1f} s; {card}")
    print(json.dumps({"pipeline": out}))
    return paths


# ------------------------------------------------ the define-by-run tape
# The reference's own loop, out = model(Tensor(x, device="cuda")); loss =
# criterion(out, Tensor(y, device="cuda")); zero_grad; backward; step, on
# the MLP and CIFAR10_CNN paths of phases 10 and 22, each beside its plain
# loop re-run here; then an MLP written with tape ops alone, and a
# reference-style script through the DeepFlows shim.
TAPE_SGD_LR = 0.1  # the raw-tape MLP's SGD step
TAPE_EVAL_AT = MLP_STEPS // 2  # the MLP loop's eval pass comes before this step
TAPE_MEM_SLACK = 1 << 20  # bytes the peak may grow from step 3 to the last
TAPE_REL_TOL = 1e-4  # the raw-tape MLP's losses against its CPU copy's, relative
TAPE_OP_REPS = 2000  # calls timed for the host cost of one tape op
TAPE_SHIM_TIMEOUT_S = 300
TAPE_SHIM_SCRIPT = """
import sys

import numpy as np

from DeepFlows.tensor import *
from DeepFlows import nn, optim
import DeepFlows

dev = sys.argv[1]
DeepFlows.manual_seed(0)
rng = np.random.default_rng(0)
x = rng.uniform(-1, 1, (256, 1)).astype(np.float32)
y = 3.0 * x + 5.0
model = nn.Linear(1, 1, device=dev)
criterion = nn.MSELoss()
optimizer = optim.SGD(model.parameters(), lr=0.1)
for epoch in range(300):
    loss = criterion(model(Tensor(x, device=dev)), Tensor(y, device=dev))
    optimizer.zero_grad()
    loss.backward()
    optimizer.step()
    Graph.free_graph_all()
print(DeepFlows.__name__, isinstance(loss, Tensor), str(loss.device))
print("fitted", float(model.weight.numpy().ravel()[0]), float(model.bias.numpy().ravel()[0]))
"""


def raw_mlp_shapes():
    """The raw-tape MLP's 8 products a step as (a shape, b shape, a
    transposed, b transposed): 3 forward, dW = h^T g of every layer (h^T a
    transposed view), dx = g W^T of layers 2 and 3 (W^T a view)."""
    dims = (784, 100, 20, 10)
    out = [((MLP_B, k), (k, n), False, False) for k, n in zip(dims[:-1], dims[1:])]
    for i, (k, n) in enumerate(zip(dims[:-1], dims[1:])):
        out.append(((k, MLP_B), (MLP_B, n), True, False))  # dW
        if i:
            out.append(((MLP_B, n), (n, k), False, True))  # dx
    return out


def tape_matmul_check(torch, ops):
    """matmul against its plain twin at the raw-tape MLP's 8 products, in
    the layouts the tape's backward hands it, at rtol 1e-4 / atol 1e-3
    (phase 9's bound); then the 8 calls timed, summed, beside their
    bounds, twins and torch.matmul.  linear_fused likewise at the MLP's
    three layers."""
    g = torch.Generator(device="cuda").manual_seed(43)
    calls, err = [], 0.0
    for ash, bsh, at, bt in raw_mlp_shapes():
        a = torch.randn(ash[::-1] if at else ash, generator=g, device="cuda")
        b = torch.randn(bsh[::-1] if bt else bsh, generator=g, device="cuda")
        a, b = (a.t() if at else a), (b.t() if bt else b)
        err = max(err, mm_check(ops.matmul(a, b), ops.matmul_plain(a, b),
                                f"tape matmul {ash} @ {bsh}"))
        calls.append((a, b))
    lf_err = 0.0
    for m, k, n in MLP_SHAPES:
        x, w, bias = (torch.randn(s, generator=g, device="cuda") for s in ((m, k), (k, n), (1, n)))
        lf_err = max(lf_err, mm_check(ops.linear_fused(x, w, bias),
                                      ops.linear_fused_plain(x, w, bias),
                                      f"tape linear_fused {(m, k, n)}"))
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")
    r = {name: sum(event_ms(lambda c=c: fn(*c), 10, flush_buf.zero_) for c in calls)
         for name, fn in (("ms", ops.matmul), ("plain_ms", ops.matmul_plain),
                          ("library_ms", torch.matmul))}
    r["bound_ms"] = sum(
        bound_ms(4 * (a.numel() + b.numel() + a.shape[0] * b.shape[1]),
                 2 * a.shape[0] * a.shape[1] * b.shape[1], "f32")[0] for a, b in calls)
    r.update(max_abs_err=err, linear_fused_max_abs_err=lf_err, calls=len(calls))
    print(f"  matmul agrees with its plain twin at the raw-tape MLP's {len(calls)} products "
          f"(transposed views; max abs err {err:.3g}), linear_fused at the MLP's 3 layers "
          f"({lf_err:.3g}); the 8 calls summed: {r['ms']:.4f} ms, bound {r['bound_ms']:.4f}, "
          f"plain {r['plain_ms']:.4f}, library {r['library_ms']:.4f}")
    return r


def tape_step_counts(ops, before, per_step, label):
    for k in ops.KERNELS:
        want = per_step.get(k.__name__, 0)
        if k.launches - before[k.__name__] != want:
            fail(f"{label}: {k.__name__} launched {k.launches - before[k.__name__]} times, "
                 f"expected {want}")


def tape_model_loops(torch, dt, build, xs, ys, steps, per_step, label, adam, eval_at=None,
                     modes=("plain", "tape"), schedule=False):
    """The plain loop and the tape loop of one model (and with "lazy" in
    ``modes`` the tape loop under lazy mode) from the same weights and the
    same package-generator state (so all draw the same dropout masks):
    losses, final state dicts, each step's wall ms, the tape loops' launch
    counts (every step exactly ``per_step``), their Graph size after every
    backward, and their peak memory after step 3 and the last.  With
    ``eval_at``, an eval pass (model.eval(), a forward, model.train())
    comes before that step in every loop, outside the counts.  With
    ``schedule`` every loop sets its lr by CosineAnnealingLR(T_max=steps)
    after each step.  The lazy loop also returns each step's change of the
    lazy counters."""
    from deepflows_tpu_torch import Graph, Tensor, lazy, nn, ops, optim
    from deepflows_tpu_torch.random import generator

    torch.backends.cudnn.deterministic = True  # cuDNN's atomic weight gradients vary
    models = {m: build() for m in modes}
    for m in modes[1:]:
        models[m].load_state_dict(models[modes[0]].state_dict())
    gen = generator("cuda")  # after the builds: a manual_seed makes new generators
    state = gen.get_state()
    out = {}
    for mode in modes:
        model = models[mode]
        gen.set_state(state)
        opt = optim.Adam(model.parameters(), **adam)
        sched = optim.CosineAnnealingLR(opt, T_max=steps) if schedule else None
        crit = nn.CrossEntropyLoss()
        losses, wall, graph_sizes, peaks, stats = [], [], [], {}, []
        Graph.free_graph_all()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        counts = None
        if mode == "lazy":
            lazy.enable()
        try:
            for i in range(steps):
                x, y = xs[i], ys[i]
                if i == eval_at:
                    model.eval()
                    if mode != "plain":
                        nodes = len(Graph.node_list)
                        e = model(Tensor(x, device="cuda"))
                        if e.requires_grad or len(Graph.node_list) != nodes or \
                                dt.is_grad_enable():
                            fail(f"{label}: the eval pass recorded on the tape")
                    else:
                        with torch.no_grad():
                            model(torch.as_tensor(x, device="cuda"))
                    model.train()
                if mode != "plain" and i == 0:
                    ops.reset_launch_counts()  # the tape's main path starts here
                before = {k.__name__: k.launches for k in ops.KERNELS}
                lz = lazy.lazy_stats()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if mode != "plain":
                    o = model(Tensor(x, device="cuda"))
                    loss = crit(o, Tensor(y, device="cuda"))
                    opt.zero_grad()
                    loss.backward()
                    graph_sizes.append(len(Graph.node_list))
                    opt.step()
                    losses.append(float(loss.numpy()))
                    Graph.free_graph_all()
                else:
                    loss = crit(model(torch.as_tensor(x, device="cuda")),
                                torch.as_tensor(y, device="cuda"))
                    opt.zero_grad()
                    loss.backward()
                    opt.step()
                    losses.append(loss.item())
                if sched is not None:
                    sched.step()
                wall.append((time.perf_counter() - t0) * 1e3)
                if mode == "lazy":
                    after = lazy.lazy_stats()
                    stats.append({k: after[k] - lz[k] for k in after})
                if mode != "plain":
                    if i != eval_at:
                        tape_step_counts(ops, before, per_step, f"{label} {mode} step {i}")
                    if i + 1 in (3, steps):
                        peaks[i + 1] = torch.cuda.max_memory_allocated()
        finally:
            if mode == "lazy":
                lazy.disable()
        if mode != "plain":
            counts = {k.__name__: k.launches for k in ops.KERNELS}  # and ends here
        out[mode] = dict(losses=losses, step_wall_ms=statistics.median(wall[3:]),
                         state={k: v.detach().clone() for k, v in model.state_dict().items()},
                         graph_sizes=graph_sizes, peaks=peaks, counts=counts, stats=stats)
    torch.backends.cudnn.deterministic = False
    return out


def tape_op_cost_us(torch):
    """Host µs of one small op (a + b on (8, 8) f32 tensors on the card)
    through the tape's __torch_function__ and on plain tensors, from
    time.perf_counter over TAPE_OP_REPS calls each."""
    from deepflows_tpu_torch import Tensor

    a = torch.randn((8, 8), device="cuda")
    t = Tensor(a)
    res = {}
    for name, x in (("plain", a), ("tape", t)):
        for _ in range(50):
            x + x
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(TAPE_OP_REPS):
            x + x
        res[name] = (time.perf_counter() - t0) / TAPE_OP_REPS * 1e6
        torch.cuda.synchronize()
    return res


def tape_calls_in(fn):
    """The __torch_function__ calls one run of ``fn`` makes on the tape."""
    from deepflows_tpu_torch import tensor

    orig = tensor.Tensor.__dict__["__torch_function__"]
    n = [0]

    def counting(cls, func, types, args=(), kwargs=None):
        n[0] += 1
        return orig.__func__(cls, func, types, args, kwargs)

    tensor.Tensor.__torch_function__ = classmethod(counting)
    try:
        fn()
    finally:
        tensor.Tensor.__torch_function__ = orig
    return n[0]


def raw_tape_mlp(torch, dt, device, xs, ys, per_step=None, lrs=None, lazy_on=False):
    """The MLP written with tape ops only: leaf Tensors w (in, out) and b
    (1, out) from numpy's default_rng(43), x @ w + b, maximum(h, 0), a
    log-softmax from exp, log, max and sum, the mean NLL, and SGD as
    w.data -= lr * w.grad under no_grad, lr TAPE_SGD_LR or step i's
    ``lrs[i]``; under lazy mode with ``lazy_on``.  Returns the losses, each
    step's wall ms and the Graph size after every backward; on the card
    each step must launch exactly ``per_step``."""
    import numpy as np

    from deepflows_tpu_torch import Graph, Tensor, ops

    r = np.random.default_rng(43)
    dims = (784, 100, 20, 10)
    Graph.free_graph_all()
    ws = []
    for a, b in zip(dims[:-1], dims[1:]):
        ws.append(Tensor((r.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
                         device=device, requires_grad=True))
        ws.append(Tensor(np.zeros((1, b), np.float32), device=device, requires_grad=True))
    eye = np.eye(dims[-1], dtype=np.float32)
    losses, wall, sizes = [], [], []
    if lazy_on:
        dt.lazy.enable()
    for i, (x, y) in enumerate(zip(xs, ys)):
        lr = TAPE_SGD_LR if lrs is None else lrs[i]
        before = {k.__name__: k.launches for k in ops.KERNELS}
        t0 = time.perf_counter()
        h = Tensor(x, device=device)
        for j in range(0, len(ws), 2):
            h = h @ ws[j] + ws[j + 1]
            if j + 2 < len(ws):
                h = dt.maximum(h, 0.0)
        m = h.max(axis=1, keepdims=True)
        logp = h - m - dt.log(dt.exp(h - m).sum(axis=1, keepdims=True))
        loss = -(logp * Tensor(eye[y], device=device)).sum(axis=1).mean()
        loss.backward()
        sizes.append(len(Graph.node_list))
        with dt.no_grad():
            for w in ws:
                w.data -= lr * w.grad
                w.zero_grad()
        losses.append(float(loss.numpy()))
        wall.append((time.perf_counter() - t0) * 1e3)
        if per_step is not None:
            tape_step_counts(ops, before, per_step, f"raw-tape MLP step {i}")
    if lazy_on:
        dt.lazy.disable()
    Graph.free_graph_all()
    return losses, wall, sizes


def tape_shim_run(lazy=False):
    """TAPE_SHIM_SCRIPT through python -m deepflows_tpu_torch.shim with
    device 'cuda', in a subprocess (with DEEPFLOWS_LAZY=1 if ``lazy``):
    (w, b) it printed, and its seconds."""
    import tempfile

    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".tape_shim_") as tmp:
        script = os.path.join(tmp, "linear_regression.py")
        with open(script, "w") as f:
            f.write(TAPE_SHIM_SCRIPT)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [ROOT] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
        env.pop("DEEPFLOWS_LAZY", None)
        if lazy:
            env["DEEPFLOWS_LAZY"] = "1"
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "deepflows_tpu_torch.shim", script, "cuda"],
                              capture_output=True, text=True, timeout=TAPE_SHIM_TIMEOUT_S,
                              env=env, cwd=tmp)
        secs = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"the shim's script failed: {proc.stderr[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    if lines[0].split()[:2] != ["DeepFlows", "True"] or \
            not lines[0].split()[2].startswith("cuda"):
        fail(f"the shim's script did not run the port's tape on the card: {lines[0]}")
    w, b = (float(v) for v in lines[-1].split()[1:])
    return w, b, secs


def tape_phase(torch, dt, report, card):
    """Phase 43, main paths: the tape.  Returns {path: launch counts} and
    the matmul check at the raw-tape MLP's shapes."""
    import numpy as np

    from deepflows_tpu_torch import config, ops
    from deepflows_tpu_torch.models import MLP

    mm = tape_matmul_check(torch, ops)
    bare = dt.Tensor(np.zeros(2, np.float32))
    if bare.device.type != "cuda" or dt.default_device().torch_device != bare.device:
        fail(f"a Tensor made without device= is on {bare.device}, not the card")
    xs, ys = mnist_like()
    cx, cy = cnn_batch(CIFAR_B, 32)
    cxs = [cx.cpu().numpy()] * CIFAR_STEPS
    cys = [cy.cpu().numpy()] * CIFAR_STEPS
    paths, res = {}, {}
    saved = config.use_pallas
    config.use_pallas = True
    try:
        def mlp():
            dt.manual_seed(0)
            return MLP(device="cuda")

        runs = {
            "mlp_tape": tape_model_loops(torch, dt, mlp, xs, ys, MLP_STEPS, {"linear_fused": 3},
                                         "MLP", dict(lr=1e-3), eval_at=TAPE_EVAL_AT),
            "cifar10_cnn_tape": tape_model_loops(
                torch, dt, lambda: cnn_model(dt, "CIFAR10_CNN"), cxs, cys, CIFAR_STEPS,
                {"linear_fused": 1, "fused_adam": 1}, "CIFAR10_CNN", dict(ADAM, fused=True)),
        }
        for name, run in runs.items():
            p, t = run["plain"], run["tape"]
            same_loss = p["losses"] == t["losses"]
            same_state = all(torch.equal(p["state"][k], t["state"][k]) for k in p["state"])
            if not (same_loss and same_state):
                fail(f"{name}: the tape loop is not bitwise its plain loop (losses "
                     f"{same_loss}, weights {same_state})")
            if any(n != 0 for n in t["graph_sizes"]):
                fail(f"{name}: Graph held {max(t['graph_sizes'])} nodes after a backward; its "
                     f"leaf count is 0 (the parameters are not tape nodes)")
            if not t["losses"][-1] < t["losses"][0]:
                fail(f"{name}: the loss did not fall: {t['losses'][0]} -> {t['losses'][-1]}")
            growth = t["peaks"][MLP_STEPS if name == "mlp_tape" else CIFAR_STEPS] - t["peaks"][3]
            if growth > TAPE_MEM_SLACK:
                fail(f"{name}: peak memory grew {growth} bytes from step 3 to the last")
            paths[name] = t["counts"]
            res[name] = dict(losses=t["losses"], step_wall_ms=t["step_wall_ms"],
                             plain_step_wall_ms=p["step_wall_ms"], bitwise=True,
                             peak_bytes=t["peaks"], graph_after_backward=max(t["graph_sizes"]))
            print(f"  {name}: {len(t['losses'])} steps, launches {t['counts']}; losses "
                  f"{t['losses'][0]:.5f} -> {t['losses'][-1]:.5f}, bitwise the plain loop's "
                  f"(losses and every weight); median step {t['step_wall_ms']:.3f} ms of wall "
                  f"time, plain {p['step_wall_ms']:.3f} ms; peak memory {t['peaks']} bytes; "
                  f"{card}")
        # host cost: the ops a tape step sends through __torch_function__
        from deepflows_tpu_torch import Graph, Tensor, nn, optim

        model = mlp()
        opt, crit = optim.Adam(model.parameters(), lr=1e-3), nn.CrossEntropyLoss()

        def one_step():
            loss = crit(model(Tensor(xs[0], device="cuda")), Tensor(ys[0], device="cuda"))
            opt.zero_grad()
            loss.backward()
            opt.step()
            float(loss.numpy())
            Graph.free_graph_all()

        calls = tape_calls_in(one_step)
        per_op = tape_op_cost_us(torch)
        m = res["mlp_tape"]
        res["host"] = dict(
            mlp_step_torch_function_calls=calls,
            mlp_step_extra_us=(m["step_wall_ms"] - m["plain_step_wall_ms"]) * 1e3,
            us_per_call_from_step=(m["step_wall_ms"] - m["plain_step_wall_ms"]) * 1e3 / calls,
            op_us=per_op)
        print(f"  host: a tape MLP step makes {calls} __torch_function__ calls; the step's "
              f"{res['host']['mlp_step_extra_us']:.1f} us over the plain loop's are "
              f"{res['host']['us_per_call_from_step']:.2f} us a call; one (8, 8) add takes "
              f"{per_op['tape']:.2f} us of host time on the tape, {per_op['plain']:.2f} plain")

        # the raw-tape MLP on the card (8 matmul a step), then on the CPU
        ops.reset_launch_counts()  # its main path starts here
        got, wall, sizes = raw_tape_mlp(torch, dt, "cuda", xs, ys, per_step={"matmul": 8})
        paths["raw_tape_mlp"] = {k.__name__: k.launches for k in ops.KERNELS}  # and ends here
        want, cpu_wall, _ = raw_tape_mlp(torch, dt, "cpu", xs, ys)
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        if not rel < TAPE_REL_TOL:
            fail(f"raw-tape MLP: the card's losses differ from the CPU copy's by {rel}")
        if any(n != 6 for n in sizes):
            fail(f"raw-tape MLP: Graph held {sizes} nodes after backward, not its 6 leaves")
        if not got[-1] < got[0]:
            fail(f"raw-tape MLP: the loss did not fall: {got[0]} -> {got[-1]}")
        res["raw_tape_mlp"] = dict(losses=got, cpu_losses=want, max_rel=rel,
                                   step_wall_ms=statistics.median(wall[3:]),
                                   matmul=mm)
        print(f"  raw_tape_mlp: {len(got)} SGD steps, launches {paths['raw_tape_mlp']}; losses "
              f"{got[0]:.5f} -> {got[-1]:.5f}, against a CPU copy max rel diff {rel:.3g} (limit "
              f"{TAPE_REL_TOL}); Graph at its 6 leaves after every backward; median step "
              f"{res['raw_tape_mlp']['step_wall_ms']:.3f} ms of wall time; {card}")
    finally:
        config.use_pallas = saved
    w, b, secs = tape_shim_run()
    if not (abs(w - 3.0) < 1e-2 and abs(b - 5.0) < 1e-2):
        fail(f"the shim's script fitted y = {w}x + {b}, not 3x + 5")
    res["shim"] = dict(w=w, b=b, seconds=secs)
    print(f"  shim: python -m deepflows_tpu_torch.shim ran a reference-style script on the card "
          f"in {secs:.1f} s: fitted y = {w:.4f}x + {b:.4f}")
    print(json.dumps({"tape": dict(card=card, **{
        k: {n: v for n, v in r.items() if n not in ("losses", "cpu_losses", "matmul")}
        for k, r in res.items()})}))
    report["tape"] = res
    return paths, mm


# ------------------------------------------------ lazy mode
# Phase 43's loops with lazy.enable(): the recorder, the templates and the
# captured CUDA graphs are on the main path; then ResNet-50 at 224 the
# JAX package's lazy protocol (tools/lazy_chip.py) with fused Adam.
LAZY_COMPILES = 3  # runners (captured graphs) a loop may build
LAZY_RESNET_B, LAZY_RESNET_STEPS, LAZY_READ_EVERY = 64, 20, 10
LAZY_CTS_STEPS = 10  # CompiledTrainStep steps timed beside the ResNet-50 loops


LAZY_EPOCH_STEPS = 4  # batches in an epoch of the held-input loops' card-resident dataset


def lazy_held_inputs(torch, dt, card, device="cuda"):
    """Two loops of models.MLP, each run as an eager tape loop and under
    lazy mode from the same weights, for two epochs of LAZY_EPOCH_STEPS
    batches of a dataset held on the card, each step's batch a slice
    Tensor(X[i*B:(i+1)*B]): f32 with Adam, and bf16 with Lion (weight
    decay) at a cosine lr that changes every step.  The lazy loop must be
    bitwise the eager loop (losses and weights) past its capture, replay
    graphs with no eager fallback, and leave the dataset unchanged."""
    from deepflows_tpu_torch import Graph, Tensor, lazy, nn, optim
    from deepflows_tpu_torch.models import MLP

    xs, ys = mnist_like()
    n, B = LAZY_EPOCH_STEPS, MLP_B
    X = torch.as_tensor(xs[:n].reshape(n * B, -1), device=device)
    Y = torch.as_tensor(ys[:n].reshape(-1), device=device)
    cases = {
        "f32_adam": (torch.float32, lambda ps: optim.Adam(ps, lr=1e-3), False),
        "bf16_lion": (torch.bfloat16, lambda ps: optim.Lion(ps, lr=1e-4, weight_decay=0.1),
                      True),
    }
    res = {}
    for name, (dtype, make_opt, schedule) in cases.items():
        data = X.to(dtype)
        kept = (data.clone(), Y.clone())
        runs = {}
        for mode in ("eager", "lazy"):
            dt.manual_seed(0)
            model = MLP(device=device).to(dtype)
            opt = make_opt(model.parameters())
            sched = optim.CosineAnnealingLR(opt, T_max=2 * n) if schedule else None
            crit = nn.CrossEntropyLoss()
            losses, st0 = [], lazy.lazy_stats()
            if mode == "lazy":
                lazy.enable()
            try:
                for i in range(2 * n):
                    j = i % n
                    loss = crit(model(Tensor(data[j * B:(j + 1) * B])),
                                Tensor(Y[j * B:(j + 1) * B]))
                    opt.zero_grad()
                    loss.backward()
                    opt.step()
                    losses.append(float(loss.numpy()))
                    Graph.free_graph_all()
                    if sched is not None:
                        sched.step()
                caps = lazy.captured()
            finally:
                if mode == "lazy":
                    lazy.disable()
            st = {k: v - st0[k] for k, v in lazy.lazy_stats().items()}
            runs[mode] = dict(losses=losses, stats=st, captured=caps,
                              state={k: v.detach().clone()
                                     for k, v in model.state_dict().items()})
        e, lz = runs["eager"], runs["lazy"]
        label = f"lazy held inputs, {name}"
        if not (torch.equal(data, kept[0]) and torch.equal(Y, kept[1])):
            fail(f"{label}: the dataset held on the card changed under the loops")
        if lz["losses"] != e["losses"] or not all(
                torch.equal(e["state"][k], lz["state"][k]) for k in e["state"]):
            fail(f"{label}: the lazy loop is not bitwise the eager loop: losses "
                 f"{lz['losses']} vs {e['losses']}")
        st = lz["stats"]
        if st["eager_fallback_ops"] or st["eager_fallback_fragments"]:
            fail(f"{label}: lazy mode fell back to eager calls: {st}")
        replays = sum(c["replays"] for c in lz["captured"])
        if device == "cuda" and replays < 2 * n - 3:
            fail(f"{label}: {replays} graph replays in {2 * n} steps: {lz['captured']}")
        res[name] = dict(steps=2 * n, replays=replays, lazy_stats=st, losses=lz["losses"])
        print(f"  lazy held inputs, {name}: {2 * n} steps over a dataset on the card, sliced a "
              f"batch a step, two epochs: bitwise the eager loop (losses, weights), the "
              f"dataset unchanged, {replays} graph replays; lazy_stats {st}; {card}")
    return res


def lazy_loop_checks(name, run, eval_at, steps):
    """The lazy loop bitwise the plain loop (and the tape loop too), no
    eager fallback, at most LAZY_COMPILES runners, and every step from the
    fourth on but the one the eval pass joins a template replay."""
    p = run["plain"]
    for mode in ("tape", "lazy"):
        t = run[mode]
        same_loss = p["losses"] == t["losses"]
        same_state = all(torch_equal(p["state"][k], t["state"][k]) for k in p["state"])
        if not (same_loss and same_state):
            fail(f"{name}: the {mode} loop is not bitwise the plain loop (losses {same_loss}, "
                 f"weights and running statistics {same_state})")
        if any(n != 0 for n in t["graph_sizes"]):
            fail(f"{name}: Graph held {max(t['graph_sizes'])} nodes after a {mode} backward")
        growth = t["peaks"][steps] - t["peaks"][3]
        if growth > TAPE_MEM_SLACK:
            fail(f"{name}: {mode} peak memory grew {growth} bytes from step 3 to the last")
    st = run["lazy"]["stats"]
    tot = {k: sum(d[k] for d in st) for k in st[0]}
    if tot["eager_fallback_ops"] or tot["eager_fallback_fragments"]:
        fail(f"{name}: lazy mode fell back to eager calls: {tot}")
    if tot["compiles"] > LAZY_COMPILES:
        fail(f"{name}: lazy mode built {tot['compiles']} runners (limit {LAZY_COMPILES})")
    slow = [i for i in range(3, steps) if i != eval_at
            and not (st[i]["flushes"] == st[i]["fast_flushes"] == 1)]
    if slow:
        fail(f"{name}: steps {slow} were not one template replay each: "
             f"{[st[i] for i in slow]}")
    return tot


def torch_equal(a, b):
    import torch

    return torch.equal(a, b)


def lazy_resnet50(torch, dt, card):
    """ResNet-50 at 224, f32, B 64, Adam(lr=1e-3, fused=True): an eager tape
    loop and a lazy loop from the same weights, LAZY_RESNET_STEPS steps
    each, every step's loss kept and all read at every LAZY_READ_EVERY-th
    step; then a CompiledTrainStep of the eager loop's model and optimizer.
    Each loop's step ms is its last window's wall time over its steps (one
    readback a window)."""
    from deepflows_tpu_torch import Graph, Tensor, lazy, nn, ops, optim
    from deepflows_tpu_torch.jit import CompiledTrainStep

    torch.backends.cudnn.deterministic = True
    x, y = cnn_batch(LAZY_RESNET_B, CNN_IMAGE)
    init = {k: v.detach().clone()
            for k, v in cnn_model(dt, "ResNet50", num_classes=CNN_CLASSES).state_dict().items()}
    free_card(torch)
    res, models = {}, {}
    for mode in ("tape", "lazy"):
        model = cnn_model(dt, "ResNet50", num_classes=CNN_CLASSES)
        model.load_state_dict(init)
        opt = optim.Adam(model.parameters(), lr=1e-3, fused=True)
        crit = nn.CrossEntropyLoss()
        model.train()
        kept, reads, counts, marks = [], {}, [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if mode == "lazy":
            ops.reset_launch_counts()  # the lazy ResNet-50 path starts here
            lazy.enable()
            st0 = lazy.lazy_stats()
        try:
            t_start = time.perf_counter()
            for i in range(LAZY_RESNET_STEPS):
                before = ops.fused_adam.launches
                loss = crit(model(Tensor(x)), Tensor(y))
                opt.zero_grad()
                loss.backward()
                opt.step()
                kept.append(loss)
                Graph.free_graph_all()
                if (i + 1) % LAZY_READ_EVERY == 0:
                    reads[i + 1] = [float(v.numpy()) for v in kept]
                    marks.append(time.perf_counter())
                counts.append(ops.fused_adam.launches - before)
            pools = lazy.captured() if mode == "lazy" else []
        finally:
            if mode == "lazy":
                st = lazy.lazy_stats()
                lazy.disable()
        window = (marks[-1] - marks[-2]) / LAZY_READ_EVERY * 1e3
        r = dict(reads=reads, step_ms=window, counts=counts,
                 peak_bytes=torch.cuda.max_memory_allocated(),
                 wall_s=marks[-1] - t_start)
        if mode == "lazy":
            r["launches"] = {k.__name__: k.launches for k in ops.KERNELS}  # and ends here
            r["stats"] = {k: st[k] - st0[k] for k in st}
            r["captured"] = pools
        res[mode] = r
        models[mode] = (model, opt, crit)
    t, lz = res["tape"], res["lazy"]
    for r, mode in ((t, "tape"), (lz, "lazy")):
        first, last = r["reads"][LAZY_READ_EVERY], r["reads"][LAZY_RESNET_STEPS]
        if last[:LAZY_READ_EVERY] != first:
            fail(f"ResNet-50 {mode}: a held loss changed after later steps: {first} -> "
                 f"{last[:LAZY_READ_EVERY]}")
        if any(c != 1 for c in r["counts"]):
            fail(f"ResNet-50 {mode}: fused_adam launched {r['counts']} times a step, not once")
    if lz["reads"] != t["reads"]:
        fail(f"ResNet-50: the lazy loop's losses are not the eager tape loop's: "
             f"{lz['reads'][LAZY_RESNET_STEPS]} vs {t['reads'][LAZY_RESNET_STEPS]}")
    ts, ls = models["tape"][0].state_dict(), models["lazy"][0].state_dict()
    diff = [k for k in ts if not torch.equal(ts[k], ls[k])]
    if diff:
        fail(f"ResNet-50: the lazy loop's weights or running statistics differ from the "
             f"eager tape loop's: {diff[:5]}")
    if lz["stats"]["eager_fallback_ops"] or lz["stats"]["eager_fallback_fragments"]:
        fail(f"ResNet-50: lazy mode fell back to eager calls: {lz['stats']}")
    if not lz["captured"]:
        fail("ResNet-50: lazy mode captured no graph")
    del models["lazy"], ls
    free_card(torch)
    model, opt, crit = models["tape"]
    step = CompiledTrainStep(model, opt, crit)
    step(x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LAZY_CTS_STEPS):
        step(x, y)
    torch.cuda.synchronize()
    cts_ms = (time.perf_counter() - t0) / LAZY_CTS_STEPS * 1e3
    torch.backends.cudnn.deterministic = False
    del models, model, opt, step
    free_card(torch)
    return dict(tape_step_ms=t["step_ms"], lazy_step_ms=lz["step_ms"],
                compiled_step_ms=cts_ms, captured=lz["captured"],
                peak_bytes={"tape": t["peak_bytes"], "lazy": lz["peak_bytes"]},
                lazy_stats=lz["stats"], losses=lz["reads"][LAZY_RESNET_STEPS],
                launches=lz["launches"])


def lazy_phase(torch, dt, report, card):
    """Phase 44, main paths: lazy mode.  Returns {path: launch counts}."""
    import numpy as np

    from deepflows_tpu_torch import config

    t0 = time.perf_counter()
    xs, ys = mnist_like()
    cx, cy = cnn_batch(CIFAR_B, 32)
    cxs = [cx.cpu().numpy()] * CIFAR_STEPS
    cys = [cy.cpu().numpy()] * CIFAR_STEPS
    paths, res = {}, {}
    saved = config.use_pallas
    config.use_pallas = True
    try:
        def mlp():
            from deepflows_tpu_torch.models import MLP

            dt.manual_seed(0)
            return MLP(device="cuda")

        modes = ("plain", "tape", "lazy")
        runs = {
            "mlp_lazy": (tape_model_loops(torch, dt, mlp, xs, ys, MLP_STEPS, {"linear_fused": 3},
                                          "MLP", dict(lr=1e-3), eval_at=TAPE_EVAL_AT,
                                          modes=modes, schedule=True), TAPE_EVAL_AT, MLP_STEPS),
            "cifar10_cnn_lazy": (tape_model_loops(
                torch, dt, lambda: cnn_model(dt, "CIFAR10_CNN"), cxs, cys, CIFAR_STEPS,
                {"linear_fused": 1, "fused_adam": 1}, "CIFAR10_CNN", dict(ADAM, fused=True),
                modes=modes), None, CIFAR_STEPS),
        }
        for name, (run, eval_at, steps) in runs.items():
            tot = lazy_loop_checks(name, run, eval_at, steps)
            lz = run["lazy"]
            paths[name] = lz["counts"]
            res[name] = dict(step_wall_ms={m: run[m]["step_wall_ms"] for m in modes},
                             peak_bytes=lz["peaks"], lazy_stats=tot, bitwise=True,
                             losses=lz["losses"])
            print(f"  {name}: {steps} steps, launches {lz['counts']}, bitwise the plain loop "
                  f"(losses, weights, running statistics); median step ms plain "
                  f"{run['plain']['step_wall_ms']:.3f}, tape {run['tape']['step_wall_ms']:.3f}, "
                  f"lazy {lz['step_wall_ms']:.3f}; lazy_stats {tot}; peak memory "
                  f"{lz['peaks']} bytes; {card}")

        # the raw-tape MLP, lr changing every step: lazy against eager on the card and a CPU copy
        from deepflows_tpu_torch import lazy, ops

        lrs = [TAPE_SGD_LR * (1.0 - i / (2 * MLP_STEPS)) for i in range(MLP_STEPS)]
        eager, ewall, _ = raw_tape_mlp(torch, dt, "cuda", xs, ys, {"matmul": 8}, lrs=lrs)
        ops.reset_launch_counts()  # the lazy raw-tape path starts here
        st0 = lazy.lazy_stats()
        got, wall, sizes = raw_tape_mlp(torch, dt, "cuda", xs, ys, {"matmul": 8}, lrs=lrs,
                                        lazy_on=True)
        paths["raw_tape_mlp_lazy"] = {k.__name__: k.launches for k in ops.KERNELS}  # ends here
        st = {k: v - st0[k] for k, v in lazy.lazy_stats().items()}
        want, _, _ = raw_tape_mlp(torch, dt, "cpu", xs, ys, lrs=lrs)
        if got != eager:
            fail(f"raw-tape MLP: the lazy loop is not bitwise the eager loop on the card")
        rel = max(abs(a - b) / abs(b) for a, b in zip(got, want))
        if not rel < TAPE_REL_TOL:
            fail(f"raw-tape MLP lazy: the card's losses differ from the CPU copy's by {rel}")
        if any(n != 6 for n in sizes):
            fail(f"raw-tape MLP lazy: Graph held {sizes} nodes after backward, not its 6 leaves")
        if st["eager_fallback_ops"] or st["eager_fallback_fragments"]:
            fail(f"raw-tape MLP lazy: lazy mode fell back to eager calls: {st}")
        res["raw_tape_mlp_lazy"] = dict(
            step_wall_ms=dict(tape=statistics.median(ewall[3:]), lazy=statistics.median(wall[3:])),
            max_rel=rel, lazy_stats=st, losses=got)
        print(f"  raw_tape_mlp_lazy: {len(got)} SGD steps at an lr that changes every step, "
              f"launches {paths['raw_tape_mlp_lazy']}; bitwise the eager loop on the card, "
              f"against a CPU copy max rel diff {rel:.3g}; median step ms tape "
              f"{res['raw_tape_mlp_lazy']['step_wall_ms']['tape']:.3f}, lazy "
              f"{res['raw_tape_mlp_lazy']['step_wall_ms']['lazy']:.3f}; lazy_stats {st}; {card}")
    finally:
        config.use_pallas = saved
    res["held_inputs"] = lazy_held_inputs(torch, dt, card)
    rn = lazy_resnet50(torch, dt, card)
    paths["resnet50_lazy"] = rn.pop("launches")
    res["resnet50_lazy"] = rn
    print(f"  resnet50_lazy: {LAZY_RESNET_STEPS} steps a loop at B {LAZY_RESNET_B}, f32, fused "
          f"Adam, a readback every {LAZY_READ_EVERY}: bitwise the eager tape loop (losses, "
          f"weights, running statistics), one fused_adam a step, held losses kept; step ms "
          f"tape {rn['tape_step_ms']:.3f}, lazy {rn['lazy_step_ms']:.3f}, CompiledTrainStep "
          f"{rn['compiled_step_ms']:.3f}; captured {rn['captured']}; peak bytes "
          f"{rn['peak_bytes']}; lazy_stats {rn['lazy_stats']}; {card}")
    w, b, secs = tape_shim_run(lazy=True)
    if not (abs(w - 3.0) < 1e-2 and abs(b - 5.0) < 1e-2):
        fail(f"the shim's script under DEEPFLOWS_LAZY=1 fitted y = {w}x + {b}, not 3x + 5")
    res["shim"] = dict(w=w, b=b, seconds=secs)
    print(f"  shim: DEEPFLOWS_LAZY=1 python -m deepflows_tpu_torch.shim ran the reference-style "
          f"script on the card in {secs:.1f} s: fitted y = {w:.4f}x + {b:.4f}")
    res["phase_s"] = time.perf_counter() - t0
    print(f"  lazy phase: {res['phase_s']:.1f} s; {card}")
    print(json.dumps({"lazy": dict(card=card, **{
        k: ({n: v for n, v in r.items() if n != "losses"} if isinstance(r, dict) else r)
        for k, r in res.items()})}, default=str))
    report["lazy"] = res
    return paths


# ------------------------------------------------------------------ the last slice
ONNX_B = 8  # ResNet-50's batch through the ONNX runtime (and B 1, B 32: the dynamic batch)
ONNX_B_BIG = 32
ONNX_CLIENTS = 8  # concurrent Predict clients, each with its own input
ONNX_IMAGE = 224
ONNX_REPS = 10  # calls timed a path
ONNX_TOL = 1e-3  # max |diff| against CompiledEvalStep, relative to the largest |logit|
ONNX_LM = dict(TRAIN, depth=2)  # the bench row's TransformerLM widths, depth cut to 2
ONNX_LM_B = 2
VIZ_BATCH = 64
BRIDGE_TOL = 1e-6
NATIVE_SGEMM = 1024  # M = K = N of the host SGEMM timed against torch.matmul
NATIVE_REPS = 3


def wall_ms(torch, fn, reps):
    """Median wall ms of ``fn`` (synchronised) over ``reps`` calls after one."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def onnx_check_logits(got, want, label):
    """max |diff| within ONNX_TOL of the largest |logit|; the top-1 equal
    wherever the reference's top-2 margin exceeds that bound."""
    import numpy as np

    scale = float(np.abs(want).max())
    diff = float(np.abs(got - want).max())
    if got.shape != want.shape or not np.isfinite(got).all() or not diff <= ONNX_TOL * scale:
        fail(f"{label}: shape {got.shape} vs {want.shape}, max |diff| {diff} against a "
             f"largest |logit| of {scale}")
    flat_g, flat_w = got.reshape(-1, got.shape[-1]), want.reshape(-1, want.shape[-1])
    top2 = np.sort(flat_w, -1)[:, -2:]
    sure = (top2[:, 1] - top2[:, 0]) > ONNX_TOL * scale
    if (flat_g.argmax(-1) != flat_w.argmax(-1))[sure].any():
        fail(f"{label}: a top-1 differs where the top-2 margin exceeds {ONNX_TOL * scale}")
    return diff, scale


def onnx_concurrent_predicts(om, tmp, rng):
    """ONNX_CLIENTS clients on threads send different inputs of one shape
    at once to a fresh server (so its first calls race too); each answer
    must be bitwise ``om`` on that request's own input.  Returns the
    seconds for all."""
    from concurrent.futures import ThreadPoolExecutor

    from deepflows_tpu_torch.serving import MyDLPWServicer, PredictClient

    xs = [rng.standard_normal((ONNX_B, 3, ONNX_IMAGE, ONNX_IMAGE)).astype("float32")
          for _ in range(ONNX_CLIENTS)]
    wants = [om(x) for x in xs]
    server = MyDLPWServicer("127.0.0.1:0", root_dir=tmp, model_file="resnet50.onnx",
                            device="cuda")
    server.serve(wait=False)

    def ask(x):
        client = PredictClient(f"127.0.0.1:{server.port}")
        try:
            return client.predict(x)[0]
        finally:
            client.close()

    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(ONNX_CLIENTS) as pool:
            outs = list(pool.map(ask, xs))
        seconds = time.perf_counter() - t0
    finally:
        server.stop()
    for i, (out, want) in enumerate(zip(outs, wants)):
        if out.shape != want.shape or not (out == want).all():
            fail(f"concurrent Predict from resnet50.onnx: client {i}'s answer is not the "
                 "in-process OnnxModel's on its own input")
    return seconds


def onnx_phase(torch, dt, card, tmp):
    """ResNet-50 (1000 classes, f32, 224) exported on the card, run by
    OnnxModel as one replayed CUDA graph per batch shape (B 8, 1, 32 in one
    shared pool; a shape past MAX_GRAPHS eager) against CompiledEvalStep,
    served over gRPC Predict from its file, to one client and to several
    at once; the bench row's TransformerLM widths at depth 2 exported and
    round-tripped, its flash=True twin refused."""
    import numpy as np

    from deepflows_tpu_torch.jit import CompiledEvalStep
    from deepflows_tpu_torch.models import ResNet50, TransformerLM
    from deepflows_tpu_torch.onnx import OnnxModel, check_onnx, export_onnx
    from deepflows_tpu_torch.serving import MyDLPWServicer, PredictClient

    res = {}
    rng = np.random.default_rng(45)
    dt.manual_seed(45)
    rn = ResNet50(num_classes=1000, device="cuda")
    with torch.no_grad():  # running statistics off their initial values: the folded BN is read
        for name, buf in rn.named_buffers():
            shift = torch.from_numpy(rng.standard_normal(tuple(buf.shape)).astype("float32"))
            buf.copy_(buf + 0.1 * shift.cuda() if name.endswith("mean")
                      else buf * torch.exp(0.1 * shift.cuda()))
    rn.eval()
    x8 = rng.standard_normal((ONNX_B, 3, ONNX_IMAGE, ONNX_IMAGE)).astype("float32")
    x1 = rng.standard_normal((1, 3, ONNX_IMAGE, ONNX_IMAGE)).astype("float32")
    x32 = rng.standard_normal((ONNX_B_BIG, 3, ONNX_IMAGE, ONNX_IMAGE)).astype("float32")
    shapes = ((x8, "B 8"), (x1, "B 1"), (x32, f"B {ONNX_B_BIG}"))
    path = os.path.join(tmp, "resnet50.onnx")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    export_onnx(rn, x8, path)
    res["export_s"] = time.perf_counter() - t0
    res["file_mb"] = os.path.getsize(path) / 2**20
    info = check_onnx(path)
    res["ops"] = info["ops"]
    if info["ops"].get("Conv") != 53 or "BatchNormalization" in info["ops"]:
        fail(f"resnet50.onnx: op histogram {info['ops']} (53 Conv, BN folded, expected)")
    ev = CompiledEvalStep(rn)
    t0 = time.perf_counter()
    om = OnnxModel(path)
    res["load_s"] = time.perf_counter() - t0
    for x, label in shapes:
        want = ev(x).float().cpu().numpy()
        first = om(x)  # the shape's first call: eager on a side stream, then its capture
        for _ in range(3):
            got = om(x)
            if not (got == first).all():
                fail(f"OnnxModel resnet50 {label}: a replay differs from the first call")
        diff, scale = onnx_check_logits(got, want, f"OnnxModel resnet50 {label}")
        res[f"max_abs_diff_{label}"] = diff
        res[f"max_logit_{label}"] = scale
    replays = {label: om.replays(x.shape) for x, label in shapes}
    if set(replays.values()) != {3}:
        fail(f"OnnxModel resnet50: replays {replays}, not 3 a shape after its first call")
    res["replays"] = replays
    # one pool for every shape: B 1's graph reuses B 8's memory (a pool of its
    # own would take about an eighth of B 8's), the three together take no
    # more than B 8's and B 32's graphs alone, and cycling them adds nothing
    pools = {label: om._graphs[om._key((x,))].pool_bytes for x, label in shapes}
    alone = OnnxModel(path)
    alone(x32)
    big = alone._graphs[alone._key((x32,))].pool_bytes
    alone.MAX_GRAPHS = 1  # past the cap a shape runs eagerly, with no graph
    if not (alone(x8) == om(x8)).all() or alone.replays(x8.shape) or len(alone._io) != 1:
        fail("OnnxModel resnet50: B 8 past MAX_GRAPHS is not an eager call equal to the graph's")
    del alone
    free_card(torch)
    reserved = torch.cuda.memory_reserved()
    for _ in range(2):
        for x, _label in shapes:
            om(x)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_reserved() - reserved
    res["graph_pool_bytes"] = dict(pools, all=sum(pools.values()), b32_alone=big,
                                   cycled_growth=grown)
    if (pools["B 1"] > pools["B 8"] / 16 or sum(pools.values()) > pools["B 8"] + big
            or grown != 0):
        fail(f"OnnxModel resnet50: graph pools {res['graph_pool_bytes']} (B 1 over a 16th of "
             f"B 8, the shapes together over B 8's and B {ONNX_B_BIG}'s alone, or growing as "
             "the shapes cycle)")
    key = om._key((x8,))
    xd = torch.from_numpy(x8).cuda()

    def eager():
        with torch.no_grad():
            return rn(torch.from_numpy(x8).cuda()).cpu()

    res["ms"] = dict(
        onnx_runtime=wall_ms(torch, lambda: om(x8), ONNX_REPS),
        compiled_eval_step=wall_ms(torch, lambda: ev(x8).cpu(), ONNX_REPS),
        eager=wall_ms(torch, eager, ONNX_REPS),
        onnx_replay_device=event_ms(om._graphs[key].graph.replay, ONNX_REPS))
    with torch.no_grad():
        res["ms"]["eager_device"] = event_ms(lambda: rn(xd), ONNX_REPS)
    print(f"  onnx resnet50: export {res['export_s']:.2f} s, {res['file_mb']:.1f} MB, ops "
          f"{info['ops']}; load {res['load_s']:.2f} s; B 8 max |diff| "
          f"{res['max_abs_diff_B 8']:.3g} of max |logit| {res['max_logit_B 8']:.3g}, B 1 "
          f"{res['max_abs_diff_B 1']:.3g}, B {ONNX_B_BIG} "
          f"{res[f'max_abs_diff_B {ONNX_B_BIG}']:.3g}; replays {replays}; graph pool bytes "
          f"{res['graph_pool_bytes']}; ms a batch of 8 (wall, numpy in and out): runtime "
          f"{res['ms']['onnx_runtime']:.3f}, CompiledEvalStep "
          f"{res['ms']['compiled_eval_step']:.3f}, eager {res['ms']['eager']:.3f}; device ms: "
          f"replay {res['ms']['onnx_replay_device']:.3f}, eager forward "
          f"{res['ms']['eager_device']:.3f}; {card}")
    want = om(x8)
    server = MyDLPWServicer("127.0.0.1:0", root_dir=tmp, model_file="resnet50.onnx",
                            device="cuda")
    server.serve(wait=False)
    try:
        client = PredictClient(f"127.0.0.1:{server.port}")
        outs = []
        for _ in range(2):  # the server's runtime: its first call, then a replay
            t0 = time.perf_counter()
            (out,) = client.predict(x8)
            outs.append(time.perf_counter() - t0)
            if out.shape != want.shape or not (out == want).all():
                fail(f"Predict from resnet50.onnx: shape {out.shape}, max |diff| "
                     f"{float(np.abs(out - want).max())} against the in-process OnnxModel")
        client.close()
    finally:
        server.stop()
    res["predict_s"] = outs
    res["concurrent_predict_s"] = onnx_concurrent_predicts(om, tmp, rng)
    print(f"  onnx Predict from resnet50.onnx over gRPC (8 x 3 x 224^2): bitwise the in-process "
          f"OnnxModel; call s {outs[0]:.3f} (first), {outs[1]:.3f}; {ONNX_CLIENTS} clients at "
          f"once on a fresh server, each its own input: each answer bitwise the in-process "
          f"OnnxModel on it, {res['concurrent_predict_s']:.3f} s for all; {card}")
    del om, ev, rn, xd
    free_card(torch)

    dt.manual_seed(46)
    lm = TransformerLM(**ONNX_LM, device="cuda", flash=None)
    lm.eval()
    idx = rng.integers(0, ONNX_LM["vocab_size"], (ONNX_LM_B, ONNX_LM["max_len"])).astype("int32")
    fresh = rng.integers(0, ONNX_LM["vocab_size"], idx.shape).astype("int32")
    lpath = os.path.join(tmp, "lm.onnx")
    t0 = time.perf_counter()
    export_onnx(lm, idx, lpath)
    res["lm_export_s"] = time.perf_counter() - t0
    res["lm_file_mb"] = os.path.getsize(lpath) / 2**20
    lom = OnnxModel(lpath)
    want = CompiledEvalStep(lm)(fresh).float().cpu().numpy()  # flash route: L >= 512 on the card
    got = lom(fresh)
    lm_diff, lm_scale = onnx_check_logits(got, want, "OnnxModel TransformerLM")
    res["lm_max_abs_diff"], res["lm_max_logit"] = lm_diff, lm_scale
    for blk in lm.blocks:
        blk.attn.flash = True
    try:
        export_onnx(lm, idx, os.path.join(tmp, "flash.onnx"))
    except ValueError as e:
        if "_FlashAttention" not in str(e):
            fail(f"export of the flash=True TransformerLM refused without naming the route: {e}")
        res["flash_refusal"] = str(e)
    else:
        fail("export of the flash=True TransformerLM was not refused")
    print(f"  onnx TransformerLM (d{ONNX_LM['dim']} x {ONNX_LM['depth']}, V "
          f"{ONNX_LM['vocab_size']}, L {ONNX_LM['max_len']}, B {ONNX_LM_B}): export "
          f"{res['lm_export_s']:.2f} s, {res['lm_file_mb']:.1f} MB; fresh tokens against "
          f"CompiledEvalStep (flash route) max |diff| {lm_diff:.3g} of {lm_scale:.3g}; flash=True "
          f"refused: {res['flash_refusal'][:60]}...; {card}")
    del lom, lm
    free_card(torch)
    return res


def viz_phase(torch, card):
    """The viz server on 127.0.0.1: a WebSocket client, MNIST_CNN trained on
    the whole digits set for 1 epoch at batch 64 on device "tpu" (the card);
    finite falling losses in the metrics frames, the epoch message, the
    parameters on the card."""
    import socket
    import threading
    import urllib.request

    import numpy as np

    from deepflows_tpu_torch.viz import make_server
    from deepflows_tpu_torch.viz.server import load_digits_images
    from deepflows_tpu_torch.viz.websocket import read_frame

    srv = make_server("127.0.0.1", 0)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    host = f"127.0.0.1:{srv.server_address[1]}"
    try:
        sock = socket.create_connection(("127.0.0.1", srv.server_address[1]), timeout=120)
        sock.sendall(b"GET /ws HTTP/1.1\r\nHost: " + host.encode() + b"\r\nUpgrade: websocket"
                     b"\r\nConnection: Upgrade\r\nSec-WebSocket-Key: dGhlIHNhbXBsZSBub25jZQ=="
                     b"\r\nSec-WebSocket-Version: 13\r\n\r\n")
        resp = b""
        while b"\r\n\r\n" not in resp:
            resp += sock.recv(4096)
        if b" 101 " not in resp.split(b"\r\n")[0] + b" ":
            fail(f"viz: the WebSocket handshake answered {resp.splitlines()[0]!r}")
        n = len(load_digits_images(limit=10**6)[0])
        cfg = dict(model="MNIST_CNN", num_samples=n, epochs=1, batch_size=VIZ_BATCH,
                   device="tpu")
        req = urllib.request.Request(f"http://{host}/api/train/start",
                                     data=json.dumps(cfg).encode(), method="POST",
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=10) as r:
            if json.loads(r.read())["status"] != "started":
                fail("viz: /api/train/start did not start")
        msgs = []
        while True:
            frame = read_frame(sock)
            if frame is None:
                fail(f"viz: the WebSocket closed before the run ended; frames {msgs}")
            msgs.append(json.loads(frame[1]))
            if msgs[-1]["type"] == "status" and msgs[-1]["data"] not in ("loading data",
                                                                         "training"):
                break
        wall = time.perf_counter() - t0
        sock.close()
    finally:
        srv.state.flags["stop"] = True
        srv.shutdown()
        srv.server_close()
    losses = [m["data"]["loss"] for m in msgs if m["type"] == "metrics"]
    epochs = [m["data"] for m in msgs if m["type"] == "epoch"]
    if msgs[-1]["data"] != "finished" or not epochs:
        fail(f"viz: the run ended {msgs[-1]['data']!r}, epoch messages {epochs}")
    if len(losses) < 2 or not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        fail(f"viz: metrics losses {losses} are not finite and falling")
    p = next(srv.state.model.parameters())
    if not p.is_cuda:
        fail(f"viz: the trained model's parameters are on {p.device}, not the card")
    steps = (n - max(1, n // 6)) // VIZ_BATCH
    res = dict(losses=losses, epoch=epochs[0], steps=steps, wall_s=wall,
               ms_per_step=1e3 * epochs[0]["epoch_time"] / steps,
               history=srv.state.history[-1])
    print(f"  viz: MNIST_CNN on the card, {n} digits ({steps} steps of {VIZ_BATCH}), 1 epoch: "
          f"metrics losses {[round(v, 4) for v in losses]}, test acc "
          f"{epochs[0]['test_acc']:.4f}, epoch {epochs[0]['epoch_time']:.2f} s "
          f"({res['ms_per_step']:.2f} ms a step, data and first-step warm-up included), run "
          f"{wall:.2f} s; parameters on {p.device}; {card}")
    return res


def bridge_phase(torch, card):
    """nn.torch_function on card tensors: forward and gradients equal
    autograd's through the same math, with and without checkpoint."""
    from deepflows_tpu_torch.nn import torch_function

    g = torch.Generator(device="cuda").manual_seed(47)

    def math_fn(x, w, b):
        h = x @ w
        return torch.tanh(h) * torch.sigmoid(h) + b

    res = {}
    ins = [torch.randn(s, device="cuda", generator=g) for s in ((256, 512), (512, 128), (1, 128))]
    for checkpoint in (False, True):
        leaves = [t.clone().requires_grad_() for t in ins]
        y = torch_function(math_fn, checkpoint=checkpoint)(*leaves)
        (y * y).sum().backward()
        ref = [t.clone().requires_grad_() for t in ins]
        yr = math_fn(*ref)
        (yr * yr).sum().backward()
        err = max([float((y - yr).detach().abs().max())]
                  + [float((a.grad - b.grad).abs().max()) for a, b in zip(leaves, ref)])
        if not err <= BRIDGE_TOL:
            fail(f"torch_function(checkpoint={checkpoint}) on the card: max |diff| {err} "
                 "against autograd")
        res[f"checkpoint={checkpoint}"] = err
    print(f"  bridge: torch_function on card tensors against autograd, max |diff| {res}; {card}")
    return res


def native_phase(torch, dt, card):
    """cpu_native on the card's host: the g++ build, the entries against
    torch, the MLP's 30 steps through the C kernels (counted), a 1024^3
    SGEMM against torch.matmul."""
    import numpy as np

    from deepflows_tpu_torch import Tensor, nn, optim
    from deepflows_tpu_torch.backend import Device
    from deepflows_tpu_torch.backend import native_kernels as nk

    dt.set_grad_enabled(True)  # the reference's loop starts with the tape recording
    cpu = nk.host_cpu()
    res = dict(host_cpu=cpu, threads=os.cpu_count())
    t0 = time.perf_counter()
    so = nk.build()
    res["build_s"] = time.perf_counter() - t0
    Device("cpu_native")
    rng = np.random.default_rng(48)
    a = torch.from_numpy(rng.standard_normal((64, 33)).astype("float32"))
    b = torch.from_numpy(rng.standard_normal((64, 33)).astype("float32")) + 2
    pos = a.abs() + 0.1
    x4 = torch.from_numpy(rng.standard_normal((2, 3, 11, 9)).astype("float32"))
    w4 = torch.from_numpy(rng.standard_normal((4, 3, 3, 3)).astype("float32"))
    m1 = torch.from_numpy(rng.standard_normal((100, 37)).astype("float32"))
    m2 = torch.from_numpy(rng.standard_normal((37, 251)).astype("float32"))
    bn = nk.batchnorm_train(x4, None, None, (0, 2, 3), 1e-5)
    cases = {
        "fill": (nk.fill((4, 5), 3.25), torch.full((4, 5), 3.25)),
        "ewise_add": (nk.ewise_add(a, b), a + b), "ewise_sub": (nk.ewise_sub(a, b), a - b),
        "ewise_mul": (nk.ewise_mul(a, b), a * b), "ewise_div": (nk.ewise_div(a, b), a / b),
        "ewise_maximum": (nk.ewise_maximum(a, b), torch.maximum(a, b)),
        "ewise_eq": (nk.ewise_eq(a, a), torch.ones_like(a)),
        "ewise_ge": (nk.ewise_ge(a, b), (a >= b).float()),
        "scalar_add": (nk.scalar_add(a, 1.5), a + 1.5), "scalar_mul": (nk.scalar_mul(a, 1.5), a * 1.5),
        "scalar_div": (nk.scalar_div(a, 1.5), a / 1.5),
        "scalar_power": (nk.scalar_power(pos, 2.0), pos ** 2),
        "scalar_maximum": (nk.scalar_maximum(a, 0.0), a.clamp_min(0.0)),
        "scalar_eq": (nk.scalar_eq(a, 0.0), (a == 0).float()),
        "scalar_ge": (nk.scalar_ge(a, 0.0), (a >= 0).float()),
        "ewise_log": (nk.ewise_log(pos), torch.log(pos)),
        "ewise_exp": (nk.ewise_exp(a), torch.exp(a)), "ewise_tanh": (nk.ewise_tanh(a), torch.tanh(a)),
        "matmul": (nk.matmul(m1, m2), m1 @ m2),
        "reduce_sum": (nk.reduce_sum(a, 1), a.sum(1)), "reduce_max": (nk.reduce_max(a, 1), a.amax(1)),
        "im2col": (nk.conv2d(x4, w4, 2, 1), torch.nn.functional.conv2d(x4, w4, stride=2, padding=1)),
        "max_pool2d": (nk.max_pool2d(x4, 3, 2, 1),
                       torch.nn.functional.max_pool2d(x4, 3, 2, 1)),
        "batchnorm_train": (bn[0], torch.nn.functional.batch_norm(
            x4, None, None, training=True, eps=1e-5)),
        "batchnorm_train mean": (bn[1].reshape(-1), x4.mean((0, 2, 3))),
        "batchnorm_train var": (bn[2].reshape(-1), x4.var((0, 2, 3), unbiased=False)),
    }
    errs = {}
    for name, (got, want) in cases.items():
        errs[name] = float((got - want).abs().max() / want.abs().max().clamp_min(1.0))
        if not errs[name] <= 1e-5:
            fail(f"cpu_native {name}: scaled max |diff| {errs[name]} against torch")
    missing = set(nk._SIGS) - {f"nat_{k}" for k in nk.calls}
    if missing:
        fail(f"cpu_native: entries {sorted(missing)} were not called")
    res["max_scaled_err"] = errs

    X = rng.standard_normal((64, 8)).astype("float32")
    yl = (X @ rng.standard_normal((8, 2)).astype("float32")).argmax(1).astype("int32")
    losses = {}
    for dev in ("cpu", "cpu_native"):
        dt.manual_seed(48)
        model = nn.Sequential(nn.Linear(8, 16, device=dev), nn.ReLU(), nn.Linear(16, 2, device=dev))
        opt, crit = optim.Adam(model.parameters(), lr=0.05), nn.CrossEntropyLoss()
        nk.calls.clear()
        t0 = time.perf_counter()
        for _ in range(30):
            loss = crit(model(Tensor(X, device=dev)), Tensor(yl, device=dev))
            opt.zero_grad()
            loss.backward()
            opt.step()
            losses.setdefault(dev, []).append(float(loss.numpy()))
        res[f"mlp_{dev}_s"] = time.perf_counter() - t0
        res[f"mlp_{dev}_calls"] = dict(nk.calls)
    if res["mlp_cpu_calls"] or res["mlp_cpu_native_calls"].get("matmul") != 150:
        fail(f"cpu_native MLP: C calls {res['mlp_cpu_native_calls']} (cpu: "
             f"{res['mlp_cpu_calls']}), not 5 SGEMMs a step on cpu_native alone")
    rel = max(abs(p - q) / abs(q) for p, q in zip(losses["cpu_native"], losses["cpu"]))
    if not rel < 1e-5 or not losses["cpu_native"][-1] < 0.5 * losses["cpu_native"][0]:
        fail(f"cpu_native MLP: losses {losses['cpu_native']} (cpu {losses['cpu']})")
    res["mlp_losses"], res["mlp_max_rel"] = losses["cpu_native"], rel

    n = NATIVE_SGEMM
    A = torch.from_numpy(rng.standard_normal((n, n)).astype("float32"))
    B = torch.from_numpy(rng.standard_normal((n, n)).astype("float32"))
    times = {}
    for name, fn in (("native", lambda: nk.matmul(A, B)), ("torch", lambda: torch.matmul(A, B))):
        fn()
        ts = []
        for _ in range(NATIVE_REPS):
            t0 = time.perf_counter()
            fn()
            ts.append(1e3 * (time.perf_counter() - t0))
        times[name] = statistics.median(ts)
    err = float((nk.matmul(A, B) - A @ B).abs().max())
    res["sgemm_ms"], res["sgemm_max_abs_diff"] = times, err
    print(f"  cpu_native on the host ({cpu}, {os.cpu_count()} threads): g++ build "
          f"{res['build_s']:.2f} s into {so.parent.name}; 24 entries against torch, worst scaled "
          f"|diff| {max(errs.values()):.3g}; MLP 30 Adam steps {res['mlp_cpu_native_s']:.3f} s "
          f"({res['mlp_cpu_s']:.3f} s on cpu), C calls {res['mlp_cpu_native_calls']}, losses "
          f"{losses['cpu_native'][0]:.4f} -> {losses['cpu_native'][-1]:.4f}, max rel vs cpu "
          f"{rel:.3g}; {n}^3 SGEMM {times['native']:.1f} ms native, {times['torch']:.1f} ms "
          f"torch.matmul (max |diff| {err:.3g}); card {card}")
    return res


def last_slice_phases(torch, dt, report, card):
    """Phases 45-48: ONNX, viz, nn.torch_function and cpu_native.  Returns
    {path: launch counts} (each path's counts zeroed just before it)."""
    import shutil
    import tempfile

    from deepflows_tpu_torch import ops
    from deepflows_tpu_torch.autograd import flag_kept

    t0 = time.perf_counter()
    res, paths = {}, {}
    tmp = tempfile.mkdtemp(prefix=".onnx_", dir=ROOT)
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # a served file's Predict is bitwise the runtime's
    try:
        ops.reset_launch_counts()
        with flag_kept():  # the models' eval() turns the tape's grad flag off
            res["onnx"] = onnx_phase(torch, dt, card, tmp)
        paths["onnx"] = {k.__name__: k.launches for k in ops.KERNELS}
    finally:
        torch.backends.cudnn.deterministic = saved
        shutil.rmtree(tmp, ignore_errors=True)
    for name, run in (("viz", lambda: viz_phase(torch, card)),
                      ("bridge", lambda: bridge_phase(torch, card)),
                      ("cpu_native", lambda: native_phase(torch, dt, card))):
        ops.reset_launch_counts()
        with flag_kept():
            res[name] = run()
        paths[name] = {k.__name__: k.launches for k in ops.KERNELS}
    res["phase_s"] = time.perf_counter() - t0
    print(f"  last slice's phases: {res['phase_s']:.1f} s; {card}")
    print(json.dumps({"last_slice": dict(card=card, **{
        k: ({n: v for n, v in r.items() if n not in ("losses", "mlp_losses")}
            if isinstance(r, dict) else r) for k, r in res.items()})}, default=str))
    report["last_slice"] = res
    return paths


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--report", metavar="PATH",
                        help="also write every measurement to PATH as JSON")
    for flag, kind in (("--parallel-rank", int), ("--parallel-world", int),
                       ("--parallel-port", int), ("--parallel-out", str),
                       ("--pipeline-rank", int), ("--pipeline-world", int),
                       ("--pipeline-port", int), ("--pipeline-out", str)):
        parser.add_argument(flag, type=kind, help=argparse.SUPPRESS)  # the multi parts' ranks
    args = parser.parse_args(argv)
    if args.parallel_rank is not None:
        return parallel_rank(args.parallel_rank, args.parallel_world, args.parallel_port,
                             args.parallel_out)
    if args.pipeline_rank is not None:
        return pipeline_rank(args.pipeline_rank, args.pipeline_world, args.pipeline_port,
                             args.pipeline_out)
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
             prefill_bound_ms=p_int8[0], prefill_route="wgmma",
             routes_by_serving_path=PATH_ROUTES["int8_matmul"]),
        dict(name="w8a8_matmul", route="cuda",
             source="deepflows_tpu_torch/csrc/w8a8_matmul.cu",
             replaces="deepflows_tpu/ops/pallas_kernels.py:718",
             launches=counts["w8a8_matmul"], max_abs_err=max_err["w8a8_matmul"],
             ms=step_ms["w8a8_matmul"], plain_ms=step_ms["w8a8_matmul_plain"],
             bound_ms=b_w8a8[0], bound_by=b_w8a8[1],
             library_ms=step_ms["w8a8_matmul_library"], at=at,
             prefill_ms=pre_ms["w8a8_matmul"], prefill_library_ms=pre_ms["w8a8_matmul_library"],
             prefill_bound_ms=p_w8a8[0], prefill_route="wgmma",
             routes_by_serving_path=PATH_ROUTES["w8a8_matmul"]),
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
    spaths, svk = serving_phases(torch, dt, ops, report, max_err, phase, card)
    serving = {  # the int8 kernels at the serving slice's new row counts
        name: {f"{key}_{n}": svk[key][f"{name}{suffix}"]
               for key in ("verify", "admission_prefill")
               for n, suffix in (("ms", ""), ("plain_ms", "_plain"), ("library_ms", "_library"))}
        | {f"{key}_bound_ms": svk[key][f"{name.split('_')[0]}_bound_ms"]
           for key in ("verify", "admission_prefill")}
        | {f"{key}_M": svk[key]["M"] for key in ("verify", "admission_prefill")}
        for name in ("int8_matmul", "w8a8_matmul")
    }
    s2paths, s2adam = seq2seq_phases(torch, dt, report, phase, card)
    upaths, gpt2k = utils_phases(torch, dt, phase, report, card)
    phase("parallel (main path): DP, TP, FSDP + TP and ZeRO-1 ShardedTrainSteps of the training "
          "model on a one-rank NCCL mesh, ring attention, expert-parallel MixtralLM:")
    ppaths = parallel_phase(torch, dt, report, card)
    phase("pipeline (main path): GPipe, 1F1B and interleaved 1F1B PipelinedTrainSteps of the "
          "training model on a one-rank NCCL mesh {pipe: 1}:")
    pipepaths = pipeline_phase(torch, dt, report, card)
    phase("tape (main paths): the reference's loop on models.MLP and CIFAR10_CNN beside their "
          "plain loops, a raw-tape MLP, a script through the DeepFlows shim:")
    tapepaths, tape_mm = tape_phase(torch, dt, report, card)
    phase("lazy (main paths): the tape loops under lazy mode, replayed as captured CUDA graphs, "
          "beside their plain and tape loops; the raw-tape MLP; ResNet-50 at 224; the shim:")
    lazypaths = lazy_phase(torch, dt, report, card)
    phase("last slice (main paths): ResNet-50 exported to ONNX on the card and run as one CUDA "
          "graph per batch shape, served over gRPC from the file; the bench row's TransformerLM "
          "exported; the viz server training MNIST_CNN; nn.torch_function; cpu_native:")
    lastpaths = last_slice_phases(torch, dt, report, card)
    for k in kernels:
        for key, paths in (("launches_by_family_path", fpaths), ("launches_by_cnn_path", cpaths),
                           ("launches_by_finetune_path", ftpaths),
                           ("launches_by_serving_path", spaths),
                           ("launches_by_seq2seq_path", s2paths),
                           ("launches_by_utils_path", upaths),
                           ("launches_by_parallel_path", ppaths),
                           ("launches_by_pipeline_path", pipepaths),
                           ("launches_by_tape_path", tapepaths),
                           ("launches_by_lazy_path", lazypaths),
                           ("launches_by_last_slice_path", lastpaths)):
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
        if k["name"] in serving:
            k["serving"] = serving[k["name"]]
        if k["name"] == "fused_adam":  # at the seq2seq model's parameter list
            k["seq2seq"] = {n: s2adam[n] for n in ("ms", "bound_ms", "plain_ms", "library_ms",
                                                   "elements", "tensors", "max_abs_err")}
        if k["name"] in gpt2k:  # at GPT-2's shapes: the CE at V 50257 on wgmma, flash at D 64
            k["gpt2"] = gpt2k[k["name"]]
            k["max_abs_err"] = max(k["max_abs_err"], k["gpt2"]["max_abs_err"])
        if k["name"] == "matmul":  # the raw-tape MLP's 8 products a step, summed
            k["tape"] = tape_mm
            k["max_abs_err"] = max(k["max_abs_err"], tape_mm["max_abs_err"])
        if k["name"] == "linear_fused":
            k["max_abs_err"] = max(k["max_abs_err"], tape_mm["linear_fused_max_abs_err"])
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
