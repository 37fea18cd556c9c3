"""Data pipeline (counterpart of ``deepflows_tpu/utils/data/dataloader.py``).

The JAX package's surface and index plans: samplers, fancy-index batching
through ``dataset[index_list]``, ``data_loader(X, y, ...)``.

- The sampling is numpy's: a shuffle with one seed gives the same plan in
  both packages.
- ``prefetch_size > 0`` runs batch assembly (indexing, ``collate_fn``,
  staging) on a daemon thread that fills a bounded queue.  An error raised
  there is raised in the consumer.  When an epoch ends, or the consumer
  stops early, the loader stops that thread and joins it, so nothing is
  left to queue work on the card: a CUDA graph's capture must be the
  card's only work.
- ``device=`` stages each batch as torch tensors:
  - ``None`` leaves numpy batches on the host;
  - ``True`` means the CUDA card (``Device(None)``, which raises without
    one), and so does a CUDA device;
  - ``"cpu"`` gives CPU tensors.

  On the card each part is copied into pinned host memory and then to the
  card with ``non_blocking`` on a side stream of the loader.  An event is
  recorded after the copies.  Where the batch is handed over, the
  consumer's current stream waits on that event, and ``record_stream``
  keeps the card's copy from being reused before the consumer's work on it
  is done.  So batch N+1's copy is ordered before the work that reads it
  and is free to run beside step N's kernels; whether it does depends on
  when the thread gets to queue it (``chip_smoke.py`` counts the copies
  that ran beside a kernel).
"""

from __future__ import annotations

import itertools
import queue
import threading

import numpy as np
import torch

from ...device import Device
from .dataset import Dataset, TensorDataset


class Sampler:
    """Index-stream protocol."""

    def __init__(self, source=None):
        self.source = source

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        return len(self.source)


class SequentialSampler(Sampler):
    @property
    def dataset(self):
        return self.source

    def __iter__(self):
        return iter(range(len(self.source)))


class RandomSampler(Sampler):
    def __init__(self, source, seed=None):
        super().__init__(source)
        self._rng = np.random.default_rng(seed)

    @property
    def dataset(self):
        return self.source

    def __iter__(self):
        return iter(self._rng.permutation(len(self.source)).tolist())


class DistributedSampler(Sampler):
    """One process's shard of the index stream.  ``num_replicas`` and
    ``rank`` default to ``torch.distributed``'s world size and rank when a
    process group is initialised, else 1 and 0.  Every replica sees the
    same seeded permutation of an epoch and takes a disjoint rank-strided
    slice; ``set_epoch(e)`` reseeds (``seed + e``).

    ``drop_last=False`` pads the stream to a multiple of ``num_replicas``
    by wrapping around, so every rank yields the same count;
    ``drop_last=True`` truncates instead."""

    def __init__(self, source, num_replicas=None, rank=None, shuffle=True, seed=0,
                 drop_last=False):
        super().__init__(source)
        if num_replicas is None or rank is None:
            import torch.distributed as dist

            grouped = dist.is_available() and dist.is_initialized()
            if num_replicas is None:
                num_replicas = dist.get_world_size() if grouped else 1
            if rank is None:
                rank = dist.get_rank() if grouped else 0
        if not (0 <= rank < num_replicas):
            raise ValueError(f"rank {rank} out of range for {num_replicas} replicas")
        self.num_replicas = int(num_replicas)
        self.rank = int(rank)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.drop_last = bool(drop_last)
        self.epoch = 0
        n = len(source)
        if self.drop_last:
            self.num_samples = n // self.num_replicas
        else:
            self.num_samples = -(-n // self.num_replicas)  # ceil

    @property
    def dataset(self):
        return self.source

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __iter__(self):
        n = len(self.source)
        if self.shuffle:
            order = np.random.default_rng(self.seed + self.epoch).permutation(n)
        else:
            order = np.arange(n)
        total = self.num_samples * self.num_replicas
        if total > n:  # wrap-around pad so all ranks yield num_samples
            order = np.concatenate([order, order[: total - n]])
        else:
            order = order[:total]
        return iter(order[self.rank :: self.num_replicas].tolist())

    def __len__(self):
        return self.num_samples


class BatchSampler(Sampler):
    """Chunk an index stream into lists of ``batch_size``."""

    def __init__(self, sampler, batch_size, drop_last=False):
        super().__init__(sampler)
        self.sampler = sampler
        self.batch_size = int(batch_size)
        self.drop_last = bool(drop_last)

    def __iter__(self):
        stream = iter(self.sampler)
        while True:
            chunk = list(itertools.islice(stream, self.batch_size))
            if not chunk or (self.drop_last and len(chunk) < self.batch_size):
                return
            yield chunk

    def __len__(self):
        full, rem = divmod(len(self.sampler), self.batch_size)
        return full + (1 if rem and not self.drop_last else 0)


def _parts(batch):
    return batch if isinstance(batch, tuple) else (batch,)


class _Stager:
    """Puts host batches on ``device`` (None: leaves them as they are).
    ``stage`` may run on any thread; ``ready`` runs on the thread that
    consumes the batch."""

    def __init__(self, device):
        self.device = device
        self.stream = None
        if device is not None and device.type == "cuda":
            self.stream = torch.cuda.Stream(device)

    def _tensor(self, part):
        t = part if isinstance(part, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(part))
        if self.stream is None:
            return t.to(self.device)
        if t.device.type == "cpu":
            t = t.pin_memory()  # a pageable source would make the copy synchronous
        return t.to(self.device, non_blocking=True)

    def stage(self, batch):
        """(the staged batch, the event after its copies or None)."""
        if self.device is None:
            return batch, None
        if self.stream is None:
            staged = tuple(self._tensor(p) for p in _parts(batch))
            return (staged if isinstance(batch, tuple) else staged[0]), None
        with torch.cuda.stream(self.stream):
            staged = tuple(self._tensor(p) for p in _parts(batch))
            event = torch.cuda.Event()
            event.record(self.stream)
        return (staged if isinstance(batch, tuple) else staged[0]), event

    def ready(self, staged):
        """The batch, once the consumer's current stream waits on its copies."""
        batch, event = staged
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in _parts(batch):
                t.record_stream(current)
        return batch


_DONE = object()


def _produce(batch_indices, assemble, q, stop, errbox):
    """Producer body: a free function, so the thread holds no reference to
    its ``_Prefetcher`` (an iterator dropped before it started can still be
    collected, and its ``__del__`` stops the thread)."""
    try:
        for idx in batch_indices:
            if stop.is_set():
                return
            item = assemble(idx)
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    break
                except queue.Full:
                    continue
    except BaseException as exc:  # raised again on the consumer's thread
        errbox.append(exc)
    finally:
        while not stop.is_set():
            try:
                q.put(_DONE, timeout=0.1)
                break
            except queue.Full:
                continue


class _Prefetcher:
    """A daemon producer thread filling a bounded queue with assembled
    batches; ``ready`` hands each one over on the consumer's thread.

    ``close()`` stops the producer and joins it: at an epoch's end, from
    generator teardown when a consumer stops early, and from ``__del__``
    when an iterator is dropped without being started."""

    def __init__(self, batch_indices, assemble, depth, ready=None):
        self._queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._errbox = []
        self._ready = ready
        self._worker = threading.Thread(
            target=_produce,
            args=(batch_indices, assemble, self._queue, self._stop, self._errbox),
            daemon=True,
            name="deepflows-prefetch",
        )
        self._worker.start()

    def close(self):
        self._stop.set()
        if self._worker is not threading.current_thread():
            self._worker.join()

    __del__ = close

    def __iter__(self):
        try:
            while True:
                item = self._queue.get()
                if item is _DONE:
                    if self._errbox:
                        raise self._errbox[0]
                    return
                yield item if self._ready is None else self._ready(item)
        finally:
            self.close()


class DataLoader:
    """Batched iteration over a ``Dataset`` with fancy-index fetch.

    ``drop_last`` keeps batch shapes static, ``collate_fn`` runs on the
    prefetch thread (put augmentation there), ``device`` stages batches
    ahead of their use (see the module's notes), ``sampler`` replaces the
    index stream."""

    def __init__(
        self,
        dataset: Dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        drop_last: bool = False,
        prefetch_size: int = 0,
        as_contiguous: bool = True,
        collate_fn=None,
        seed=None,
        sampler=None,
        device=None,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.drop_last = bool(drop_last)
        self.prefetch_size = max(0, int(prefetch_size))
        self.as_contiguous = as_contiguous
        self.collate_fn = collate_fn
        self.device = None if device is None else Device(None if device is True else device)
        # the sampler decides the order; replacing loader.sampler takes
        # effect on the next epoch
        self.sampler = sampler if sampler is not None else (
            RandomSampler(dataset, seed=seed) if shuffle else SequentialSampler(dataset)
        )

    @property
    def batch_sampler(self):
        """Chunked view over the current ``self.sampler``."""
        return BatchSampler(self.sampler, self.batch_size, self.drop_last)

    def _plan(self):
        """Each batch's index list for one epoch."""
        yield from self.batch_sampler

    def _assemble(self, idx):
        """One host batch: fetch, collate, make contiguous (on the prefetch
        thread when there is one)."""
        batch = self.dataset[idx]
        if self.collate_fn is not None:
            batch = self.collate_fn(batch)
        if self.as_contiguous and isinstance(batch, tuple):
            batch = tuple(
                np.ascontiguousarray(part) if isinstance(part, np.ndarray) else part
                for part in batch
            )
        return batch

    def __iter__(self):
        plan = self._plan()
        stager = _Stager(self.device)

        def assemble(idx):
            return stager.stage(self._assemble(idx))

        if self.prefetch_size > 0:
            return iter(_Prefetcher(plan, assemble, self.prefetch_size, stager.ready))
        return (stager.ready(assemble(idx)) for idx in plan)

    def __len__(self):
        return len(self.batch_sampler)


def data_loader(
    X,
    y,
    batch_size,
    shuffle=False,
    prefetch_size: int = 0,
    as_contiguous: bool = True,
    drop_last: bool = False,
    collate_fn=None,
    device=None,
    seed=None,
):
    """``DataLoader(TensorDataset(X, y), ...)`` over in-memory arrays."""
    return DataLoader(
        TensorDataset(X, y),
        batch_size,
        shuffle,
        drop_last=drop_last,
        prefetch_size=prefetch_size,
        as_contiguous=as_contiguous,
        collate_fn=collate_fn,
        device=device,
        seed=seed,
    )
