"""In-flight (continuous) batching (counterpart of ``InflightEngine`` and
``InflightHandle`` in ``deepflows_tpu/models/engine.py``).

A slot-based engine over fixed shapes:

- the KV cache is ``(layers, slots, Hc, max_len, Dh)`` and each slot is a
  sequence at its own depth (``KVCacheDecoder._forward_multi``), or, with
  ``paged_blocks=N``, a pool of N blocks of ``block_size`` positions that
  each slot addresses through its row of a block table
  (``_forward_multi_paged``); admission waits while the pool lacks the
  blocks a request needs;
- a CHUNK advances every live slot ``chunk`` tokens and the host reads the
  (slots, chunk) output buffer once.  Where JAX runs the chunk as one
  ``lax.fori_loop`` program, the port captures one step in a CUDA graph on
  the card (``jit.StepGraphs``, one graph per slot count, cache shape and
  dtype, ``any_sample``, ``top_k`` and dense or paged) and replays it
  ``chunk`` times.  The step forwards every slot, selects the next tokens
  (``_select_multi``), freezes the slots that are not live (inactive, or
  at their budget: token and position hold, and re-forwarding the frozen
  token rewrites the same K/V), writes column ``i`` of the output buffer
  and advances the live slots' positions.  The host's slot state (active,
  limit, temperature, top_p, sampling mask, the block table) lives in
  tensors on the card that outlive the graph and is copied in before each
  chunk;
- admission runs eagerly: a B 1 prefill (or, when the prompt starts with a
  registered prefix, the prefix's cached K/V and a forward of the suffix
  alone through ``_forward_chunk``), the copy into the slot's cache row or
  blocks, and the first token's selection;
- retirement (budget or ``eos_id``) frees the slot, and its blocks, between
  chunks.

Requests come from any thread (``submit`` returns a handle whose
``result()`` blocks); a daemon thread owns the card.  One lock serialises
that thread's device work with prefix prefills from callers' threads, so
no prefill runs while a step is being captured.  ``ops.KERNELS`` launch
counts are process-wide: read them while no other thread uses the card.
"""

from __future__ import annotations

import queue
import threading
import time
from types import SimpleNamespace

import numpy as np
import torch

from ..jit import StepGraphs
from .decoding import KVCacheDecoder

__all__ = ["InflightEngine", "InflightHandle"]


class InflightHandle:
    """A request's handle: ``result()`` blocks until the request finishes
    and returns the 1-D ``prompt + generated`` token array (generation stops
    at ``new_tokens`` or at the first ``eos_id``, which is kept)."""

    def __init__(self, prompt, new_tokens, eos_id):
        self.prompt = np.asarray(prompt, np.int64)
        self.new_tokens = int(new_tokens)
        self.eos_id = eos_id
        self.tokens: list = []
        self._done = threading.Event()
        self._err = None
        self.t_submit = self.t_done = None  # perf_counter seconds

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout=None) -> np.ndarray:
        if not self._done.wait(timeout):
            raise TimeoutError("request not finished")
        if self._err is not None:
            raise self._err
        return np.concatenate([self.prompt, np.asarray(self.tokens, np.int64)])

    def _finish(self, err=None):
        self._err = err
        self.t_done = time.perf_counter()
        self._done.set()


class InflightEngine:
    def __init__(
        self,
        lm,
        slots: int = 4,
        chunk: int = 8,
        top_k=None,
        compute_dtype=None,
        quant=None,
        seed: int = 0,
        start: bool = True,
        max_prefixes: int = 8,
        paged_blocks=None,
        block_size: int = 16,
    ):
        """``slots``: concurrent sequences; ``chunk``: decode steps between
        host readbacks (the admission granularity); ``top_k``: the
        engine-wide top-k of sampling requests (None: none);
        ``compute_dtype`` and ``quant`` configure the ``KVCacheDecoder``
        (``lm`` may be one).  Sampling requests draw from one engine-wide
        ``torch.Generator`` seeded by ``seed``, so a request's draws depend
        on the rest of the batch.  ``paged_blocks=N`` keeps K/V in a pool of
        N ``block_size``-position blocks (block 0, the null target of
        unallocated table entries, comes on top).  The engine runs on the
        model's device."""
        self.dec = lm if isinstance(lm, KVCacheDecoder) else KVCacheDecoder(
            lm, compute_dtype=compute_dtype, quant=quant)
        lm = self.lm = self.dec.lm
        self.S, self.chunk, self.top_k = int(slots), int(chunk), top_k
        self.L = lm.max_len
        if self.S < 1 or self.chunk < 1:
            raise ValueError("slots and chunk must be >= 1")
        self.device = dev = lm.tok_embed.weight.device
        a0 = lm.blocks[0].attn
        layers, Hc, Dh = len(lm.blocks), a0.num_kv_heads, a0.head_dim
        cdtype = self.dec.compute_dtype or lm.tok_embed.weight.dtype
        self.paged = paged_blocks is not None
        st = self._st = SimpleNamespace()  # the tensors the captured step reads and writes
        if self.paged:
            if self.L % int(block_size):
                raise ValueError(f"block_size {block_size} must divide max_len {self.L}")
            self.bs = int(block_size)
            self.nb = self.L // self.bs  # a table row: the logical blocks of max_len
            n_pool = int(paged_blocks) + 1
            if n_pool < 2:
                raise ValueError("paged_blocks must be >= 1")
            st.kc = torch.zeros((layers, n_pool, Hc, self.bs, Dh), dtype=cdtype, device=dev)
            st.tbl = torch.zeros((self.S, self.nb), dtype=torch.long, device=dev)
            self._tbl = np.zeros((self.S, self.nb), np.int64)
            self._free = list(range(1, n_pool))
            self._blocks_of = [[] for _ in range(self.S)]
        else:
            st.kc = torch.zeros((layers, self.S, Hc, self.L, Dh), dtype=cdtype, device=dev)
        st.vc = torch.zeros_like(st.kc)
        st.tok = torch.zeros(self.S, dtype=torch.long, device=dev)
        st.pos = torch.zeros(self.S, dtype=torch.long, device=dev)
        st.active = torch.zeros(self.S, dtype=torch.bool, device=dev)
        st.limit = torch.zeros(self.S, dtype=torch.long, device=dev)
        st.temp = torch.zeros(self.S, dtype=torch.float32, device=dev)
        st.topp = torch.zeros(self.S, dtype=torch.float32, device=dev)
        st.smask = torch.zeros(self.S, dtype=torch.bool, device=dev)
        st.out = torch.zeros((self.S, self.chunk), dtype=torch.long, device=dev)
        st.i = torch.zeros((), dtype=torch.long, device=dev)
        st.positions = torch.arange(self.L, device=dev)
        self._generator = torch.Generator(device=dev).manual_seed(int(seed))
        self._graphs = StepGraphs()
        self._steps = {}  # graph key -> step function
        with torch.inference_mode():
            self.params = self.dec._prepared()

        # the host's slot state, copied into ``st`` before each chunk
        self._active = np.zeros(self.S, bool)
        self._limit = np.zeros(self.S, np.int64)
        self._temp = np.zeros(self.S, np.float32)
        self._topp = np.zeros(self.S, np.float32)
        self._smask = np.zeros(self.S, bool)
        self._slot_req: list = [None] * self.S

        # registered prefixes: their K/V and next-token logits, prefilled
        # once; LRU beyond max_prefixes; recomputed after refresh_params
        self.max_prefixes = int(max_prefixes)
        self._prefixes: dict = {}  # tuple(tokens) -> entry
        self._prefix_clock = 0
        self._params_ver = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        # the engine thread's device work and prefix prefills from other
        # threads (register_prefix) take this lock, as does the prefix table
        self._lock = threading.RLock()
        # admissions by kind, chunks run, times refused for want of blocks,
        # and the host seconds each took (the chunk's readback included)
        self.stats = dict(chunks=0, admit_prefill=0, admit_suffix=0, admit_full_hit=0,
                          backpressure=0, chunk_s=0.0, admit_prefill_s=0.0,
                          admit_suffix_s=0.0)

        self._queue: "queue.Queue" = queue.Queue()
        self._pending: list = []
        self._stop = False
        self._refresh = False
        self._thread = None
        if start:
            self.start()

    # ----------------------------------------------------------- the step
    def _step_fn(self, any_sample):
        """The chunk's step: forward every slot one token, select, freeze
        the slots that are not live, write output column ``i``, advance the
        live slots' positions.  Reads and writes only ``self._st`` and the
        prepared weights."""
        st, dec, params = self._st, self.dec, self.params
        gen = self._generator if any_sample else None

        def step():
            live = st.active & (st.pos < st.limit)
            if self.paged:
                logits, _, _ = dec._forward_multi_paged(params, st.kc, st.vc, st.tbl, st.tok,
                                                         st.pos, st.positions)
            else:
                logits, _, _ = dec._forward_multi(params, st.kc, st.vc, st.tok, st.pos,
                                                  st.positions)
            nxt = dec._select_multi(logits, gen, st.temp, st.topp, st.smask, self.top_k,
                                    any_sample)
            nxt = torch.where(live, nxt, st.tok)
            st.out.index_copy_(1, st.i.reshape(1), nxt[:, None])
            st.tok.copy_(nxt)
            st.pos.add_(live.long())
            st.i.add_(1)

        return step

    def _key(self, any_sample):
        st = self._st
        return ("chunk", self.S, tuple(st.kc.shape), st.kc.dtype, any_sample, self.top_k,
                "paged" if self.paged else "dense")

    def _run_chunk(self):
        """One chunk: the host state copied in, ``chunk`` steps (replays of
        the key's graph on the card), one readback of the output buffer."""
        st = self._st
        any_sample = bool(self._smask[self._active].any())
        st.active.copy_(torch.from_numpy(self._active))
        st.limit.copy_(torch.from_numpy(self._limit))
        st.temp.copy_(torch.from_numpy(self._temp))
        st.topp.copy_(torch.from_numpy(self._topp))
        st.smask.copy_(torch.from_numpy(self._smask))
        if self.paged:
            st.tbl.copy_(torch.from_numpy(self._tbl))
        st.i.zero_()
        key = self._key(any_sample)
        step = self._steps.get(key)
        if step is None:
            step = self._steps[key] = self._step_fn(any_sample)
        if st.kc.is_cuda:
            self._graphs.run(key, step, self.chunk, (self._generator,) if any_sample else ())
        else:
            for _ in range(self.chunk):
                step()
        out = st.out.cpu().numpy()  # the chunk's one readback
        self.stats["chunks"] += 1
        for slot in np.flatnonzero(self._active):
            req = self._slot_req[slot]
            take = min(self.chunk, req.new_tokens - len(req.tokens))
            toks = out[slot, :take].tolist()
            if req.eos_id is not None and req.eos_id in toks:
                toks = toks[: toks.index(req.eos_id) + 1]
            req.tokens.extend(toks)
            if len(req.tokens) >= req.new_tokens or (
                req.eos_id is not None and toks and toks[-1] == req.eos_id
            ):
                req._finish()
                self._slot_req[slot] = None
                self._active[slot] = False
                self._smask[slot] = False
                if self.paged:
                    self._release_blocks(slot)

    # ----------------------------------------------------------- prefixes
    def _prefill(self, tokens):
        """A B 1 prefill of ``tokens``: (K, V (layers, 1, Hc, L, Dh), logits
        (1, V) after the last)."""
        prompt = torch.zeros((1, self.L), dtype=torch.long)
        prompt[0, : tokens.size] = torch.as_tensor(tokens, dtype=torch.long)
        return self.dec._prefill(self.params, prompt.to(self.device), int(tokens.size))

    def register_prefix(self, tokens) -> None:
        """Prefill ``tokens`` (a non-empty 1-D array: a shared system prompt)
        once and keep its K/V; a later request whose prompt starts with it
        forwards only the rest.  Thread-safe; entries are evicted least
        recently used beyond ``max_prefixes`` and recomputed lazily after
        ``refresh_params``.  Each holds one slot row of cache memory."""
        tokens = np.asarray(tokens)
        if tokens.ndim != 1 or tokens.size < 1:
            raise ValueError("prefix must be a non-empty 1-D token array")
        if tokens.size + 1 > self.L:
            raise ValueError(
                f"prefix length {tokens.size} leaves no room under max_len {self.L}")
        self._prefix_entry(tuple(int(t) for t in tokens))

    def _prefix_entry(self, key: tuple) -> dict:
        """The entry of prefix ``key``, computed (or recomputed after new
        weights) under the lock."""
        with self._lock, torch.inference_mode():
            entry = self._prefixes.get(key)
            if entry is None or entry["ver"] != self._params_ver:
                kc, vc, logits = self._prefill(np.asarray(key, np.int64))
                entry = {"plen": len(key), "kc": kc, "vc": vc, "logits": logits,
                         "ver": self._params_ver}
                self._prefixes[key] = entry
            self._prefix_clock += 1
            entry["used"] = self._prefix_clock
            while len(self._prefixes) > self.max_prefixes:
                oldest = min(self._prefixes, key=lambda k: self._prefixes[k]["used"])
                del self._prefixes[oldest]
            return entry

    def _match_prefix(self, prompt: np.ndarray):
        """The longest registered prefix that ``prompt`` starts with (the
        whole prompt included), or None."""
        best = None
        with self._lock:
            keys = list(self._prefixes)
        for key in keys:
            n = len(key)
            if n > prompt.size or (best is not None and n <= len(best)):
                continue
            if np.array_equal(prompt[:n], np.asarray(key, prompt.dtype)):
                best = key
        return best

    def _suffix_bucket(self, sfx_size: int, plen: int) -> int:
        """The padded width of a prefix hit's suffix forward: a power of two,
        capped at the cache's room past the prefix, so the chunk's window
        stays inside the cache (XLA clamps an out-of-range window's start;
        ``_scatter_chunk`` would write out of bounds).  At least
        ``sfx_size``, since submit keeps prompt + new_tokens <= max_len."""
        return min(1 << (sfx_size - 1).bit_length(), self.L - plen)

    def _suffix(self, entry, sfx):
        """The K/V and next-token logits of prefix + ``sfx``: the entry's
        K/V copied (the entry stays as it is) and the suffix, zero-padded to
        its bucket, forwarded at the prefix's end by ``_forward_chunk``.
        Pad positions' K/V are written but never seen: each decode step
        overwrites its position before the mask admits it."""
        plen = entry["plen"]
        bucket = self._suffix_bucket(int(sfx.size), plen)
        toks = torch.zeros((1, bucket), dtype=torch.long)
        toks[0, : sfx.size] = torch.as_tensor(sfx, dtype=torch.long)
        kc, vc = entry["kc"].clone(), entry["vc"].clone()
        posv = torch.full((1,), plen, dtype=torch.long, device=self.device)
        logits, _, _ = self.dec._forward_chunk(self.params, kc, vc, toks.to(self.device), posv,
                                               self._st.positions)
        return kc, vc, logits[:, sfx.size - 1]

    # ----------------------------------------------------------- lifecycle
    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        return self

    def close(self):
        """Stop the engine thread; unfinished requests fail with RuntimeError."""
        self._stop = True
        if self._thread is not None:
            self._thread.join(timeout=60)
            self._thread = None
        err = RuntimeError("engine closed")
        for req in self._pending + [r for r in self._slot_req if r is not None]:
            if not req.done():
                req._finish(err)
        while True:
            try:
                self._queue.get_nowait()._finish(err)
            except queue.Empty:
                break

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def refresh_params(self):
        """Pick up changed weights: the engine thread prepares them again,
        between chunks, into the tensors its graphs read, and prefix K/V
        from older weights recompute at their next use."""
        self._refresh = True

    # -------------------------------------------------------------- submit
    def submit(self, prompt, new_tokens: int, temperature: float = 0.0, top_p=None,
               eos_id=None) -> InflightHandle:
        """Queue one sequence: ``prompt`` a 1-D int array; ``new_tokens``
        tokens are generated (fewer when ``eos_id`` comes, which is kept).
        ``temperature > 0`` samples, with the engine's ``top_k`` and this
        request's ``top_p``; 0 is greedy.  Thread-safe; returns at once."""
        prompt = np.asarray(prompt)
        if prompt.ndim != 1 or prompt.size < 1:
            raise ValueError("prompt must be a non-empty 1-D token array")
        new_tokens = int(new_tokens)
        if new_tokens < 1:
            raise ValueError("new_tokens must be >= 1")
        if prompt.size + new_tokens > self.L:
            raise ValueError(
                f"prompt_len {prompt.size} + new_tokens {new_tokens} exceeds max_len {self.L}")
        if self._stop or self._thread is None:
            raise RuntimeError("engine is not running")
        req = InflightHandle(prompt, new_tokens, eos_id)
        req.temperature = float(temperature)
        req.top_p = float(top_p) if top_p else 0.0
        req.t_submit = time.perf_counter()
        self._queue.put(req)
        return req

    def generate(self, prompt, new_tokens: int, **kw) -> np.ndarray:
        """``submit`` and ``result``."""
        return self.submit(prompt, new_tokens, **kw).result()

    # --------------------------------------------------------- engine loop
    def _loop(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        try:
            while not self._stop:
                self._drain_queue(block=not self._active.any())
                with self._lock, torch.inference_mode():
                    if self._refresh:
                        self._refresh = False
                        self.dec._prepared()  # copied into self.params' tensors
                        self._params_ver += 1
                    while self._pending and not self._active.all():
                        slot = int(np.flatnonzero(~self._active)[0])
                        if not self._admit(self._pending[0], slot):
                            break  # the pool lacks blocks: wait for retirements
                        self._pending.pop(0)
                    if self._active.any():
                        t0 = time.perf_counter()
                        self._run_chunk()
                        self.stats["chunk_s"] += time.perf_counter() - t0
        except Exception as e:  # resolve every waiter, then fail loudly
            for req in self._pending + [r for r in self._slot_req if r is not None]:
                if not req.done():
                    req._finish(e)
            self._stop = True
            raise

    def _drain_queue(self, block: bool):
        try:
            self._pending.append(self._queue.get(timeout=0.05 if block else 0.0))
        except queue.Empty:
            pass
        while True:
            try:
                self._pending.append(self._queue.get_nowait())
            except queue.Empty:
                return

    def _admit(self, req, slot: int) -> bool:
        """Admit ``req`` into ``slot``; False (the request stays queued)
        when the paged pool lacks the blocks of its whole position range."""
        st = self._st
        plen = req.prompt.size
        if self.paged:
            n_need = (plen + req.new_tokens - 1) // self.bs + 1  # positions 0 .. plen + new - 1
            if len(self._free) < n_need:
                self.stats["backpressure"] += 1
                return False
        t0 = time.perf_counter()
        kind = "admit_prefill"
        pkey = self._match_prefix(req.prompt.astype(np.int64))
        if pkey is None:
            self.prefix_misses += 1
            kcn, vcn, logits0 = self._prefill(req.prompt)
        else:
            self.prefix_hits += 1
            entry = self._prefix_entry(pkey)
            sfx = req.prompt[entry["plen"]:]
            if sfx.size == 0:  # the prompt is the prefix
                kind = "admit_full_hit"
                kcn, vcn, logits0 = entry["kc"], entry["vc"], entry["logits"]
            else:
                kind = "admit_suffix"
                kcn, vcn, logits0 = self._suffix(entry, sfx)
        any_s = req.temperature > 0.0
        one = lambda v, dt: torch.tensor([v], dtype=dt, device=self.device)  # noqa: E731
        tok0 = self.dec._select_multi(
            logits0, self._generator, one(req.temperature, torch.float32),
            one(req.top_p, torch.float32), one(any_s, torch.bool), self.top_k, any_s)
        if self.paged:
            blocks = [self._free.pop() for _ in range(n_need)]
            idx = torch.tensor(blocks, dtype=torch.long, device=self.device)
            for pool, new in ((st.kc, kcn), (st.vc, vcn)):
                lay, _, Hc, _, Dh = new.shape
                rows = new[:, 0].reshape(lay, Hc, self.nb, self.bs, Dh).transpose(1, 2)
                pool.index_copy_(1, idx, rows[:, :n_need].to(pool.dtype))
            self._tbl[slot] = 0
            self._tbl[slot, :n_need] = blocks
            self._blocks_of[slot] = blocks
        else:
            st.kc[:, slot].copy_(kcn[:, 0])
            st.vc[:, slot].copy_(vcn[:, 0])
        st.tok[slot] = tok0[0]
        st.pos[slot] = plen
        first = int(tok0[0])  # waits for the admission's work
        self.stats[kind] += 1
        if kind + "_s" in self.stats:
            self.stats[kind + "_s"] += time.perf_counter() - t0
        req.tokens.append(first)
        if req.new_tokens == 1 or (req.eos_id is not None and first == req.eos_id):
            req._finish()
            if self.paged:
                self._release_blocks(slot)
            return True
        self._slot_req[slot] = req
        self._active[slot] = True
        self._limit[slot] = plen + req.new_tokens - 1  # the position of its last token
        self._temp[slot] = req.temperature
        self._topp[slot] = req.top_p
        self._smask[slot] = any_s
        return True

    def _release_blocks(self, slot: int):
        self._free.extend(self._blocks_of[slot])
        self._blocks_of[slot] = []
        self._tbl[slot] = 0

    def cache_bytes(self) -> int:
        """Device memory of the K/V cache (dense rows or the paged pool)."""
        return 2 * self._st.kc.numel() * self._st.kc.element_size()
