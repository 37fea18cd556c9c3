"""The port's byte-level BPE and text datasets (``deepflows_tpu_torch.utils.text``)
against the JAX package's on the CPU: the merges in their order, every
encoded id, decode, the datasets' arrays, all identical; a tokenizer file
saved by either package loads in the other.

The port learns and encodes with numpy passes over the whole corpus where
the JAX package loops in Python; the corpora here hold the cases where a
vectorised merge could part from ``_merge_once``: runs of one byte (pair
a = a, merged left to right without overlaps), ties between pair counts
(broken by the smallest pair), texts that end on half a pair, empty texts,
multi-byte UTF-8 and text the merges never saw.
"""

import numpy as np
import pytest

from deepflows_tpu.utils import text as jtext
from deepflows_tpu_torch.utils import text as ttext

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "the lazy dog sleeps while the quick fox runs",
    "pack my box with five dozen liquor jugs",
    "aaaaaaa aaaa aaa bbbbbb abababab",
    "",
    "héllo wörld ☃☃☃ — naïve café",
    "ab" * 9 + "a",
] * 3
PROBES = CORPUS + ["completely unseen text!", "aaaaaaaaaaa", "zz", "", "☃", "a"]


@pytest.fixture(scope="module")
def pair():
    return (jtext.BPETokenizer().train(CORPUS, vocab_size=330),
            ttext.BPETokenizer().train(CORPUS, vocab_size=330))


def test_merges_identical_in_order(pair):
    jt, tt = pair
    assert list(tt.merges.items()) == list(jt.merges.items())
    assert all(type(a) is int and type(b) is int for a, b in tt.merges)
    assert tt.vocab_size == jt.vocab_size == 330
    assert (tt.pad_id, tt.eos_id) == (jt.pad_id, jt.eos_id)


def test_merges_stop_where_jax_stops():
    """A corpus that runs out of pairs before the vocabulary is full."""
    texts = ["ab", "abab", "c"]
    jt = jtext.BPETokenizer().train(texts, vocab_size=300)
    tt = ttext.BPETokenizer().train(texts, vocab_size=300)
    assert list(tt.merges.items()) == list(jt.merges.items())
    assert tt.vocab_size == jt.vocab_size < 300
    for pkg in (jtext, ttext):
        with pytest.raises(ValueError, match="base alphabet"):
            pkg.BPETokenizer().train(texts, vocab_size=257)


def test_encode_decode_identical(pair):
    jt, tt = pair
    for t in PROBES:
        ids = tt.encode(t)
        assert ids == jt.encode(t), t
        assert tt.encode(t, add_eos=True) == jt.encode(t, add_eos=True)
        assert tt.decode(ids) == jt.decode(ids) == t
    assert tt.encode_batch(PROBES, add_eos=True) == jt.encode_batch(PROBES, add_eos=True)
    # decode skips specials and takes any int sequence, numpy ints too
    ids = np.asarray(jt.encode("the lazy dog", add_eos=True) + [jt.pad_id])
    assert tt.decode(ids) == jt.decode(ids) == "the lazy dog"


def test_save_load_across_packages(pair, tmp_path):
    jt, tt = pair
    jpath, tpath = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jt.save(jpath)
    tt.save(tpath)
    with open(jpath) as a, open(tpath) as b:
        assert a.read() == b.read()  # one file layout
    from_jax = ttext.BPETokenizer.load(jpath)
    from_port = jtext.BPETokenizer.load(tpath)
    assert list(from_jax.merges.items()) == list(jt.merges.items())
    assert list(from_port.merges.items()) == list(tt.merges.items())
    for t in PROBES:
        assert from_jax.encode(t) == from_port.encode(t) == jt.encode(t)


def test_specials_without_eos():
    jt = jtext.BPETokenizer(special_tokens=("<pad>",)).train(CORPUS, 300)
    tt = ttext.BPETokenizer(special_tokens=("<pad>",)).train(CORPUS, 300)
    assert tt.eos_id == jt.eos_id == -1
    assert tt.encode("the fox", add_eos=True) == jt.encode("the fox", add_eos=True)
    jd, td = jtext.LMDataset(CORPUS, jt, 8), ttext.LMDataset(CORPUS, tt, 8)
    np.testing.assert_array_equal(td.tokens, jd.tokens)


@pytest.mark.parametrize("seq_len", [5, 16, 33])
def test_lm_dataset_identical(pair, seq_len):
    jt, tt = pair
    jd, td = jtext.LMDataset(CORPUS, jt, seq_len), ttext.LMDataset(CORPUS, tt, seq_len)
    assert td.tokens.dtype == jd.tokens.dtype
    np.testing.assert_array_equal(td.tokens, jd.tokens)
    assert len(td) == len(jd)
    for i in (0, len(jd) // 2, len(jd) - 1):
        for a, b in zip(td[i], jd[i]):
            assert a.dtype == b.dtype == np.int64
            np.testing.assert_array_equal(a, b)


def test_lm_dataset_too_small(pair):
    jt, tt = pair
    for pkg, tok in ((jtext, jt), (ttext, tt)):
        with pytest.raises(ValueError, match="corpus too small"):
            pkg.LMDataset(["ab"], tok, 64)


def test_sft_dataset_identical(pair):
    jt, tt = pair
    pairs = [("Q: what is the fox?", " A quick brown one."),
             ("aaaa", "bbbb" * 10),
             ("a very long prompt " * 5, "cut"),  # the response is cut away: skipped
             ("hi", "")]
    for seq_len in (8, 24):
        jd = jtext.SFTDataset(pairs, jt, seq_len)
        td = ttext.SFTDataset(pairs, tt, seq_len, ignore_index=-100)
        np.testing.assert_array_equal(td.inputs, jd.inputs)
        np.testing.assert_array_equal(td.labels, jd.labels)
        assert len(td) == len(jd)
        for a, b in zip(td[1], jd[1]):
            np.testing.assert_array_equal(a, b)
    for pkg, tok in ((jtext, jt), (ttext, tt)):
        with pytest.raises(ValueError, match="no usable"):
            pkg.SFTDataset([("x" * 50, "y")], tok, 4)


def test_repository_markdown_slice(pair):
    """A slice of the repository's own markdown, the corpus chip_smoke.py
    trains on, through both packages (a few KB: the JAX learner is slow)."""
    import glob
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    texts = []
    for path in sorted(glob.glob(os.path.join(root, "*.md")))[:3]:
        with open(path, errors="replace") as f:
            texts.append(f.read()[:1500])
    jt = jtext.BPETokenizer().train(texts, 300)
    tt = ttext.BPETokenizer().train(texts, 300)
    assert list(tt.merges.items()) == list(jt.merges.items())
    np.testing.assert_array_equal(ttext.LMDataset(texts, tt, 32).tokens,
                                  jtext.LMDataset(texts, jt, 32).tokens)
