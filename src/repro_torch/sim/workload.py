"""Request workload generators for the cluster simulator.

Models the request-level facts the paper's Table 2(b) signals derive from:
arrival process (Poisson / bursty), prompt lengths, decode lengths (the
sequence-length variance that drives every early-stop pathology).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Request:
    flow: int
    arrival: float
    prompt_len: int
    decode_len: int
    session: int = -1             # prefix/session affinity key (-1: none)
    node: int = -1                # assigned serving node
    device: int = -1              # device slot within the node
    start_decode: float = -1.0
    finish: float = -1.0
    tokens_out: int = 0

    @property
    def latency(self) -> float:
        return self.finish - self.arrival if self.finish >= 0 else float("inf")


@dataclass
class WorkloadSpec:
    rate: float = 200.0            # requests/sec across the cluster
    duration: float = 2.0          # seconds of arrivals
    prompt_mean: int = 512
    decode_mean: int = 64
    decode_cv: float = 0.3         # length variance (early-stop driver)
    burst_factor: float = 1.0      # >1: clumped arrivals (3a.1 driver)
    burst_start: float = 0.0       # bursts begin after this time (baseline)
    flow_skew: float = 0.0         # 0: uniform flows; >0: zipf-ish volume skew
    n_sessions: int = 0            # >0: requests share this many sticky
    #                                prefix/session keys (prefix-heavy
    #                                workloads); 0 = every request unique
    seed: int = 0


def generate(spec: WorkloadSpec) -> list[Request]:
    # same seeded np.random.Generator family the simulator draws from, so
    # one (seed, spec) pair fully determines a scenario end to end
    rng = np.random.default_rng(spec.seed)
    reqs: list[Request] = []
    t = 0.0
    flow = 0
    mean_gap = 1.0 / spec.rate
    while t < spec.duration:
        if (spec.burst_factor > 1.0 and t >= spec.burst_start
                and rng.random() < 0.05):
            # microburst: a clump of arrivals at ~the same instant
            n = int(spec.burst_factor * 8)
            for _ in range(n):
                reqs.append(_mk(rng, flow, t + rng.random() * 1e-4, spec))
                flow += 1
            t += rng.exponential(mean_gap) * spec.burst_factor
        else:
            reqs.append(_mk(rng, flow, t, spec))
            flow += 1
            t += rng.exponential(mean_gap)
    return reqs


def _mk(rng: np.random.Generator, flow: int, t: float,
        spec: WorkloadSpec) -> Request:
    prompt = max(8, int(rng.lognormal(0, 0.4) * spec.prompt_mean))
    sigma = spec.decode_cv
    decode = max(4, int(rng.lognormal(0, sigma) * spec.decode_mean))
    if spec.flow_skew > 0 and flow % 7 == 0:
        # heavy-hitter sessions: much longer prompts+decodes
        prompt = int(prompt * (1 + 10 * spec.flow_skew))
        decode = int(decode * (1 + 4 * spec.flow_skew))
    session = flow % spec.n_sessions if spec.n_sessions > 0 else -1
    return Request(flow=flow, arrival=t, prompt_len=prompt,
                   decode_len=decode, session=session)
