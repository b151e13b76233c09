"""The general traffic generator: a closed loop of clients whose requests
come from one traffic mix file (``traffic/<mix>.json``).

Lengths follow log-normal distributions given by their median and sigma,
clipped to [min, max].  So that every seed asks for the same work, the sizes
are a fixed deck: ``deck`` (prompt, output) pairs at evenly spaced
quantiles of the two distributions, paired by a fixed shuffle.  The seed
only orders the deck and draws the token ids (uniform over the vocabulary).
A client's first request draws its output length from an evenly spread set
over [1, output max], in a seeded order, so that completions spread out
from the start."""

from __future__ import annotations

import statistics
from dataclasses import dataclass

import numpy as np


@dataclass
class Request:
    """One request: its client, prompt and output length, and what the
    loop records of it (host-clock stamps in seconds)."""
    rid: int
    client: int
    prompt: np.ndarray
    max_new: int
    submitted: float = -1.0
    first: float = -1.0
    finished: float = -1.0
    bucket: int = 0
    stamps: list | None = None     # host time of each emitted token
    tokens: list | None = None     # served tokens: the prefill's, then one
                                   # per step


def quantiles(spec: dict, n: int) -> np.ndarray:
    """``n`` lengths at evenly spaced quantiles of the log-normal with
    ``spec``'s median and sigma, clipped to [min, max], as whole numbers."""
    dist = statistics.NormalDist(0.0, 1.0)
    z = np.array([dist.inv_cdf((i + 0.5) / n) for i in range(n)])
    vals = np.exp(np.log(spec["median"]) + spec["sigma"] * z)
    return np.clip(np.rint(vals), spec["min"], spec["max"]).astype(np.int64)


class ClosedLoop:
    """Requests for ``mix["clients"]`` clients: ``first(c)`` is client c's
    first request, ``next(c)`` its next one, drawn in the order asked."""

    def __init__(self, mix: dict, vocab: int, seed: int) -> None:
        self.mix = mix
        self.vocab = vocab
        n = mix["deck"]
        fixed = np.random.default_rng(0)
        prompts = quantiles(mix["prompt"], n)
        outputs = quantiles(mix["output"], n)[fixed.permutation(n)]
        self.rng = np.random.default_rng(int(seed))
        order = self.rng.permutation(n)
        self.deck = list(zip(prompts[order].tolist(),
                             outputs[order].tolist()))
        clients = mix["clients"]
        top = mix["output"]["max"]
        spread = 1 + (np.arange(clients) * top) // clients
        self.first_out = self.rng.permutation(spread).tolist()
        self.drawn = 0
        self.rid = 0

    def _request(self, client: int, prompt_len: int, max_new: int
                 ) -> Request:
        prompt = self.rng.integers(0, self.vocab, prompt_len,
                                   dtype=np.int64)
        self.rid += 1
        return Request(self.rid, client, prompt, int(max_new), stamps=[],
                       tokens=[])

    def first(self, client: int) -> Request:
        prompt_len, _ = self.deck[self.drawn % len(self.deck)]
        self.drawn += 1
        return self._request(client, prompt_len, self.first_out[client])

    def next(self, client: int) -> Request:
        prompt_len, max_new = self.deck[self.drawn % len(self.deck)]
        self.drawn += 1
        return self._request(client, prompt_len, max_new)
