"""The port's data pipeline (``deepflows_tpu_torch.utils.data``) against the
JAX package's on the CPU: every plan and batch bit for bit.

Samplers and ``BatchSampler`` give the JAX index plans (numpy seeds in
both), ``DistributedSampler`` with an explicit ``num_replicas`` and ``rank``
too; ``DataLoader`` and ``data_loader`` give the same batches with and
without the prefetch thread, with a ``collate_fn`` on that thread; a
consumer that stops early leaves no producer thread alive; an error raised
by the producer (in ``collate_fn`` or while staging) is raised in the
consumer; ``device="cpu"`` and ``DeviceDataLoader(..., device="cpu")`` give
CPU tensors equal to the numpy batches; ``device=True`` means the card and
raises without one.  Each transform gives JAX's bits for one seed, and
``pre`` reads PNGs written with PIL as JAX's does.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from deepflows_tpu.utils import data as jdata
from deepflows_tpu.utils.data import transforms as jtf
from deepflows_tpu_torch.utils import data as tdata
from deepflows_tpu_torch.utils.data import transforms as ttf

RNG = np.random.default_rng(0)


def _plan(sampler):
    return list(iter(sampler))


@pytest.mark.parametrize("kind", ["sequential", "random", "random_unseeded_len"])
def test_samplers_match_jax(kind):
    ds_j = jdata.TensorDataset(np.arange(23))
    ds_t = tdata.TensorDataset(np.arange(23))
    if kind == "sequential":
        assert _plan(tdata.SequentialSampler(ds_t)) == _plan(jdata.SequentialSampler(ds_j))
    elif kind == "random":
        js, ts = jdata.RandomSampler(ds_j, seed=7), tdata.RandomSampler(ds_t, seed=7)
        for _ in range(3):  # one generator across epochs, as in JAX
            assert _plan(ts) == _plan(js)
    else:
        ts = tdata.RandomSampler(ds_t)
        assert sorted(_plan(ts)) == list(range(23)) and len(ts) == 23


@pytest.mark.parametrize("n,bs,drop", [(23, 5, False), (23, 5, True), (20, 5, True), (3, 8, False)])
def test_batch_sampler_matches_jax(n, bs, drop):
    js = jdata.BatchSampler(jdata.RandomSampler(range(n), seed=3), bs, drop)
    ts = tdata.BatchSampler(tdata.RandomSampler(range(n), seed=3), bs, drop)
    assert _plan(ts) == _plan(js)
    assert len(ts) == len(js)


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("drop_last", [True, False])
@pytest.mark.parametrize("replicas", [1, 3, 4])
def test_distributed_sampler_matches_jax(shuffle, drop_last, replicas):
    src = range(22)
    for rank in range(replicas):
        js = jdata.DistributedSampler(src, replicas, rank, shuffle, seed=5, drop_last=drop_last)
        ts = tdata.DistributedSampler(src, replicas, rank, shuffle, seed=5, drop_last=drop_last)
        for epoch in (0, 1):
            js.set_epoch(epoch)
            ts.set_epoch(epoch)
            assert _plan(ts) == _plan(js)
        assert len(ts) == len(js)


def test_distributed_sampler_defaults_and_errors():
    """Without a process group the world is one process, rank 0 (JAX's
    defaults are its process grid, one process here too)."""
    ts = tdata.DistributedSampler(range(10), shuffle=False)
    assert (ts.num_replicas, ts.rank) == (1, 0)
    assert _plan(ts) == list(range(10))
    for pkg in (jdata, tdata):
        with pytest.raises(ValueError, match="out of range"):
            pkg.DistributedSampler(range(10), num_replicas=2, rank=2)


def _arrays(n=37):
    x = RNG.standard_normal((n, 3, 4)).astype(np.float32)
    y = RNG.integers(0, 10, n).astype(np.int32)
    return x, y


def _same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, tuple) and len(g) == len(w)
        for a, b in zip(g, w):
            a = a.numpy() if isinstance(a, torch.Tensor) else a
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("prefetch", [0, 2])
@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, True), (True, False)])
def test_data_loader_batches_match_jax(prefetch, shuffle, drop_last):
    x, y = _arrays()

    def collate(batch):  # runs on the prefetch thread when there is one
        return batch[0] * 2.0, batch[1] + 1

    for fn in (None, collate):
        kw = dict(shuffle=shuffle, drop_last=drop_last, prefetch_size=prefetch, seed=11,
                  collate_fn=fn)
        want = list(jdata.data_loader(x, y, 6, **kw))
        loader = tdata.data_loader(x, y, 6, **kw)
        got = list(loader)
        _same_batches(got, want)
        assert len(loader) == len(jdata.data_loader(x, y, 6, **kw))


def test_dataloader_custom_sampler_and_single_array_dataset():
    x, _ = _arrays(10)

    class Evens(tdata.SequentialSampler):
        def __iter__(self):
            return iter(range(0, len(self.source), 2))

    ds = tdata.TensorDataset(x)
    got = list(tdata.DataLoader(ds, batch_size=2, sampler=Evens(ds)))
    assert len(got) == 3 and all(isinstance(b, np.ndarray) for b in got)
    np.testing.assert_array_equal(np.concatenate(got), x[0:10:2])
    with pytest.raises(ValueError):
        tdata.TensorDataset(x, x[:3])


def test_collate_runs_on_the_prefetch_thread():
    main = threading.get_ident()
    seen = []

    def collate(batch):
        seen.append(threading.get_ident())
        return batch

    x, y = _arrays(16)
    batches = list(tdata.data_loader(x, y, 4, prefetch_size=2, collate_fn=collate))
    assert len(batches) == 4 and seen and all(t != main for t in seen)
    np.testing.assert_array_equal(batches[-1][1], y[12:])


def _producers():
    return [t for t in threading.enumerate() if t.name == "deepflows-prefetch" and t.is_alive()]


def test_early_exit_joins_the_producer():
    """The consumer stops after two batches: the producer thread has ended
    when the loop is left (``close`` joins it), not some time later."""
    x, y = np.zeros((64, 1), np.float32), np.zeros(64, np.int32)
    assert not _producers()
    it = iter(tdata.data_loader(x, y, 4, prefetch_size=2))
    for i, _ in enumerate(it):
        if i == 1:
            break
    it.close()
    assert not _producers()
    # a full epoch ends with the thread joined too
    assert len(list(tdata.data_loader(x, y, 4, prefetch_size=3))) == 16
    assert not _producers()


def test_producer_errors_raise_in_the_consumer():
    class Boom(Exception):
        pass

    def collate(batch):
        raise Boom("bad batch")

    x, y = np.zeros((8, 1), np.float32), np.zeros(8, np.int32)
    for pkg in (jdata, tdata):
        with pytest.raises(Boom):
            list(pkg.data_loader(x, y, 4, prefetch_size=2, collate_fn=collate))
    # staging fails on the producer thread: an object array is no tensor
    objs = np.empty(8, dtype=object)
    with pytest.raises(TypeError):
        list(tdata.data_loader(objs, y, 4, prefetch_size=2, device="cpu"))
    assert not _producers()


@pytest.mark.parametrize("prefetch", [0, 2])
def test_cpu_staging_gives_equal_tensors(prefetch):
    x, y = _arrays(20)
    want = list(jdata.data_loader(x, y, 8))
    got = list(tdata.data_loader(x, y, 8, prefetch_size=prefetch, device="cpu"))
    assert all(isinstance(p, torch.Tensor) and p.device.type == "cpu" for b in got for p in b)
    _same_batches(got, want)
    staged = list(tdata.DeviceDataLoader(tdata.data_loader(x, y, 8), device="cpu"))
    _same_batches(staged, want)
    assert len(tdata.DeviceDataLoader(tdata.data_loader(x, y, 8), device="cpu")) == 3


def test_device_true_means_the_card():
    x, y = _arrays(8)
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the refusal without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdata.data_loader(x, y, 4, device=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdata.DeviceDataLoader(tdata.data_loader(x, y, 4))


def test_empty_loader_yields_nothing():
    x, y = _arrays(3)
    assert list(tdata.data_loader(x, y, 4, drop_last=True, prefetch_size=2)) == []
    assert list(tdata.DeviceDataLoader(tdata.data_loader(x, y, 4, drop_last=True),
                                       device="cpu")) == []


@pytest.mark.parametrize("name", ["flip", "crop", "erase", "normalize", "compose"])
def test_transforms_bit_equal_to_jax(name):
    x = RNG.standard_normal((9, 3, 12, 10)).astype(np.float32)

    def build(m):
        return {
            "flip": lambda: m.RandomHorizontalFlip(p=0.5, seed=4),
            "crop": lambda: m.RandomCrop(10, padding=3, seed=4),
            "erase": lambda: m.RandomErasing(p=0.7, scale=(0.05, 0.3), seed=4),
            "normalize": lambda: m.Normalize([0.4, 0.5, 0.6], [0.2, 0.25, 0.3]),
            "compose": lambda: m.Compose([m.RandomCrop(10, 2, seed=1),
                                          m.RandomHorizontalFlip(seed=2),
                                          m.RandomErasing(seed=3),
                                          m.Normalize([0.5] * 3, [2.0] * 3)]),
        }[name]()

    jt, tt = build(jtf), build(ttf)
    for _ in range(3):  # the generators advance alike
        want, got = jt(x), tt(x)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_image_folder_matches_jax(tmp_path):
    Image = pytest.importorskip("PIL.Image")
    for cls in ("cat", "dog"):
        os.makedirs(tmp_path / cls)
        for i in range(3):
            Image.fromarray(RNG.integers(0, 255, (16, 12, 3), dtype=np.uint8), "RGB").save(
                tmp_path / cls / f"{i}.png")
    (tmp_path / "cat" / "notes.txt").write_text("not an image")
    for size in ((8, 8), (6, 10)):
        want = jdata.load_image_folder(str(tmp_path), size=size)
        got = tdata.load_image_folder(str(tmp_path), size=size)
        for a, b in zip(got[:2], want[:2]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert got[2] == want[2] == ["cat", "dog"]
    imgs = tdata.read_png_images_from_folder(str(tmp_path / "dog"))
    ref = jdata.read_png_images_from_folder(str(tmp_path / "dog"))
    assert len(imgs) == 3 and all(np.array_equal(a, b) for a, b in zip(imgs, ref))


def test_prefetch_keeps_up_without_leaking_threads():
    """Many short epochs back to back, each with its producer joined."""
    x, y = _arrays(40)
    t0 = time.perf_counter()
    for epoch in range(20):
        n = sum(1 for _ in tdata.data_loader(x, y, 4, shuffle=True, prefetch_size=2))
        assert n == 10
    assert not _producers()
    assert time.perf_counter() - t0 < 20
