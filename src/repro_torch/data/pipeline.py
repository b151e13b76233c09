"""Data substrate: synthetic corpus, packing, LENGTH BUCKETING (one of the
paper's Table 3(a) mitigations), and a prefetching host-side loader.

The synthetic corpus is a seeded Zipf token stream with document structure
(variable-length docs + EOS) so packing/bucketing behave like real text.
"""

from __future__ import annotations

import threading
import queue as _q
from dataclasses import dataclass

import numpy as np


@dataclass
class DataConfig:
    vocab: int
    seq_len: int
    batch: int
    doc_len_mean: int = 256
    zipf_a: float = 1.2
    eos: int = 0
    seed: int = 0


class SyntheticCorpus:
    """Deterministic document stream."""

    def __init__(self, cfg: DataConfig) -> None:
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)

    def doc(self) -> np.ndarray:
        n = max(8, int(self.rng.exponential(self.cfg.doc_len_mean)))
        toks = self.rng.zipf(self.cfg.zipf_a, n) % (self.cfg.vocab - 1) + 1
        return np.concatenate([toks.astype(np.int32),
                               [self.cfg.eos]]).astype(np.int32)


def pack_documents(corpus: SyntheticCorpus, n_batches: int):
    """Greedy sequence packing into (batch, seq_len) token/label arrays."""
    cfg = corpus.cfg
    buf = np.empty(0, np.int32)
    for _ in range(n_batches):
        need = cfg.batch * (cfg.seq_len + 1)
        while buf.size < need:
            buf = np.concatenate([buf, corpus.doc()])
        chunk = buf[:need].reshape(cfg.batch, cfg.seq_len + 1)
        buf = buf[need:]
        yield {"tokens": chunk[:, :-1].copy(),
               "labels": chunk[:, 1:].copy()}


def length_buckets(lengths: list[int],
                   edges: tuple[int, ...] = (64, 128, 256, 512, 1024, 2048)
                   ) -> dict[int, list[int]]:
    """Group request indices by padded-length bucket (3a mitigation:
    'length bucketing, batch formation')."""
    out: dict[int, list[int]] = {}
    for i, n in enumerate(lengths):
        b = next((e for e in edges if n <= e), edges[-1])
        out.setdefault(b, []).append(i)
    return out


def padding_waste(lengths: list[int], bucketed: bool,
                  edges: tuple[int, ...] = (64, 128, 256, 512, 1024, 2048)
                  ) -> float:
    """Fraction of padded tokens — quantifies the bucketing win.

    Unbucketed = every request padded to ONE compiled shape (the bucket
    edge covering the longest request); bucketed = per-request bucket.
    """
    if not lengths:
        return 0.0
    if bucketed:
        waste = tot = 0
        for b, idxs in length_buckets(lengths, edges).items():
            for i in idxs:
                waste += b - lengths[i]
                tot += b
        return waste / max(tot, 1)
    m = next((e for e in edges if max(lengths) <= e), edges[-1])
    return sum(m - n for n in lengths) / (m * len(lengths))


class Prefetcher:
    """Host-side background prefetch (overlap data with compute)."""

    def __init__(self, it, depth: int = 2) -> None:
        self._q: _q.Queue = _q.Queue(maxsize=depth)
        self._done = object()

        def worker():
            for item in it:
                self._q.put(item)
            self._q.put(self._done)

        self._t = threading.Thread(target=worker, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item
