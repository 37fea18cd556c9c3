"""Text for the LM families (counterpart of ``deepflows_tpu/utils/text.py``):
a byte-level BPE tokenizer (train, encode, decode, save, load) and two
datasets, ``LMDataset`` (documents packed into dense next-token windows)
and ``SFTDataset`` (prompt / response pairs with the prompt masked).

The merges, their tie-break and every id are the JAX package's, and so is
the saved JSON, so each package loads the other's file.  The JAX
tokenizer recounts every pair of the corpus in Python for each merge and
makes one Python pass over a text for each merge it encodes; here both
are numpy passes over the whole corpus at once: the texts are laid end to
end with a separator id that no pair may hold, a pair (a, b) is the key
a·K + b, the most frequent pair with the smallest key is the JAX
``min`` of the most frequent pairs, and a merge replaces, left to right,
each occurrence that does not overlap the one before it (in a run of
a = b, every other pair from the run's start), as the JAX
``_merge_once`` does.
"""

from __future__ import annotations

import json
import os
from typing import Iterable, List, Sequence

import numpy as np

from .data.dataset import Dataset


def _join(byte_seqs):
    """The sequences laid end to end, each followed by the separator -1."""
    parts = []
    for seq in byte_seqs:
        parts.append(seq)
        parts.append(np.full(1, -1, np.int64))
    return np.concatenate(parts) if parts else np.zeros(0, np.int64)


def _split(flat):
    """The sequences of ``_join`` back as lists."""
    ends = np.flatnonzero(flat < 0)
    starts = np.concatenate([[0], ends[:-1] + 1])
    return [flat[a:b].tolist() for a, b in zip(starts, ends)]


def _merge(flat, a: int, b: int, new_id: int):
    """Every occurrence of (a, b) in ``flat`` replaced by ``new_id``, left to
    right without overlaps; ``flat`` itself if there is none."""
    hit = np.flatnonzero((flat[:-1] == a) & (flat[1:] == b))
    if hit.size == 0:
        return flat
    if a == b and hit.size > 1:
        # runs of consecutive hits: keep those at an even offset in their run
        new_run = np.concatenate([[True], hit[1:] != hit[:-1] + 1])
        run_start = np.maximum.accumulate(np.where(new_run, np.arange(hit.size), 0))
        hit = hit[(np.arange(hit.size) - run_start) % 2 == 0]
    out = flat.copy()
    out[hit] = new_id
    return np.delete(out, hit + 1)


class BPETokenizer:
    """Byte-level BPE.

    - ids 0..255 are the raw bytes; learned merges take ids 256+, special
      tokens come after the merges.
    - ``train(texts, vocab_size)`` learns merges greedily by pair count,
      ties broken by the smallest pair.
    - ``encode`` and ``decode`` are exact inverses for any string.
    """

    def __init__(self, special_tokens: Sequence[str] = ("<pad>", "<eos>")):
        self.merges: dict[tuple[int, int], int] = {}
        self.special_tokens = list(special_tokens)
        self._special_ids: dict[str, int] = {}
        self._rebuild_specials()

    @property
    def vocab_size(self) -> int:
        return 256 + len(self.merges) + len(self.special_tokens)

    def special_id(self, token: str) -> int:
        return self._special_ids[token]

    @property
    def pad_id(self) -> int:
        return self._special_ids.get("<pad>", -1)

    @property
    def eos_id(self) -> int:
        return self._special_ids.get("<eos>", -1)

    def _rebuild_specials(self):
        base = 256 + len(self.merges)
        self._special_ids = {t: base + i for i, t in enumerate(self.special_tokens)}

    # ------------------------------------------------------------ training
    def train(self, texts: Iterable[str], vocab_size: int) -> "BPETokenizer":
        """Learn ``vocab_size - 256 - len(special_tokens)`` merges."""
        n_merges = vocab_size - 256 - len(self.special_tokens)
        if n_merges < 0:
            raise ValueError(f"vocab_size {vocab_size} < base alphabet + specials")
        flat = _join(np.frombuffer(t.encode("utf-8"), np.uint8).astype(np.int64)
                     for t in texts if t)
        key_base = 256 + n_merges  # above every id a merge can make
        self.merges = {}
        for _ in range(n_merges):
            left, right = flat[:-1], flat[1:]
            keys = (left * key_base + right)[(left >= 0) & (right >= 0)]
            if keys.size == 0:
                break
            uniq, counts = np.unique(keys, return_counts=True)
            best = int(uniq[np.argmax(counts)])  # the first maximum: the smallest pair
            pair = divmod(best, key_base)
            new_id = 256 + len(self.merges)
            self.merges[pair] = new_id
            flat = _merge(flat, *pair, new_id)
        self._rebuild_specials()
        return self

    # ------------------------------------------------------- encode/decode
    def _encode_flat(self, texts: Sequence[str]):
        """The texts encoded, laid end to end as in ``_join``: the merges
        applied one pass each, in their order of creation."""
        flat = _join(np.frombuffer(t.encode("utf-8"), np.uint8).astype(np.int64)
                     for t in texts)
        for (a, b), new_id in self.merges.items():
            flat = _merge(flat, a, b, new_id)
        return flat

    def encode(self, text: str, add_eos: bool = False) -> List[int]:
        return self.encode_batch([text], add_eos=add_eos)[0]

    def encode_batch(self, texts: Sequence[str], add_eos=False):
        seqs = _split(self._encode_flat(texts))
        if add_eos and "<eos>" in self._special_ids:
            for seq in seqs:
                seq.append(self.eos_id)
        return seqs

    def decode(self, ids: Sequence[int]) -> str:
        unmerge = {v: k for k, v in self.merges.items()}
        out_bytes: List[int] = []
        stack = list(ids)[::-1]
        specials = set(self._special_ids.values())
        while stack:
            i = int(stack.pop())
            if i in specials:
                continue
            if i < 256:
                out_bytes.append(i)
            else:
                a, b = unmerge[i]
                stack.append(b)
                stack.append(a)
        return bytes(out_bytes).decode("utf-8", errors="replace")

    # ---------------------------------------------------------- persistence
    def save(self, path: str) -> str:
        payload = {
            "merges": [[a, b, i] for (a, b), i in self.merges.items()],
            "special_tokens": self.special_tokens,
        }
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)  # atomic
        return path

    @classmethod
    def load(cls, path: str) -> "BPETokenizer":
        with open(path) as f:
            payload = json.load(f)
        tok = cls(special_tokens=payload["special_tokens"])
        tok.merges = {(a, b): i for a, b, i in payload["merges"]}
        tok._rebuild_specials()
        return tok


class SFTDataset(Dataset):
    """Supervised fine-tuning pairs: each (prompt, response) example becomes
    fixed-length ``(input_ids, labels)``, the labels the next-token targets
    with the prompt's positions and the padding set to ``ignore_index``
    (for ``nn.CrossEntropyLoss(ignore_index=...)``).

    Per example, right-padded to ``seq_len`` with the pad id:
    ``input = prompt + response (+ eos)``, cut to seq_len + 1;
    ``labels[t] = input[t + 1]`` where that token is the response's.
    """

    def __init__(self, pairs, tokenizer: BPETokenizer, seq_len: int,
                 ignore_index: int = -100):
        self.tokenizer = tokenizer
        self.seq_len = int(seq_len)
        self.ignore_index = int(ignore_index)
        pad = tokenizer.pad_id if tokenizer.pad_id >= 0 else 0
        xs, ys = [], []
        for prompt, response in pairs:
            p, r = tokenizer.encode_batch([prompt, response])
            if tokenizer.eos_id >= 0:
                r = r + [tokenizer.eos_id]
            toks = (p + r)[: self.seq_len + 1]
            if len(p) >= len(toks):  # the response was cut away entirely
                continue
            x = np.full(self.seq_len, pad, np.int64)
            y = np.full(self.seq_len, self.ignore_index, np.int64)
            n = len(toks) - 1
            x[:n] = toks[:-1]
            # positions len(p)-1 .. n-1 predict the response's tokens
            lo = len(p) - 1
            y[lo:n] = toks[lo + 1 : n + 1]
            xs.append(x)
            ys.append(y)
        if not xs:
            raise ValueError("no usable (prompt, response) pairs")
        self.inputs = np.stack(xs)
        self.labels = np.stack(ys)

    def __len__(self):
        return len(self.inputs)

    def __getitem__(self, idx):
        return self.inputs[idx], self.labels[idx]


class LMDataset(Dataset):
    """Next-token LM dataset over a packed token stream: the documents one
    after another (an ``<eos>`` after each when the tokenizer has one), cut
    into non-overlapping windows of seq_len + 1; ``__getitem__`` returns
    ``(input_ids, target_ids)``, the window's first and last ``seq_len``
    tokens, int64."""

    def __init__(self, texts: Sequence[str], tokenizer: BPETokenizer, seq_len: int):
        self.tokenizer = tokenizer
        self.seq_len = int(seq_len)
        flat = tokenizer._encode_flat(list(texts))
        eos = tokenizer.eos_id
        stream = flat[flat >= 0] if eos < 0 else np.where(flat < 0, eos, flat)
        n_windows = (len(stream) - 1) // self.seq_len
        if n_windows < 1:
            raise ValueError(f"corpus too small: {len(stream)} tokens < seq_len+1")
        used = n_windows * self.seq_len + 1
        self.tokens = np.asarray(stream[:used], dtype=np.int32)
        self._n = n_windows

    def __len__(self) -> int:
        return self._n

    def __getitem__(self, idx: int):
        lo = idx * self.seq_len
        window = self.tokens[lo : lo + self.seq_len + 1]
        return window[:-1].astype(np.int64), window[1:].astype(np.int64)
