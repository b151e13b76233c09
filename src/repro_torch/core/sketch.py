"""Line-rate streaming statistics for the DPU-analog telemetry plane.

A DPU processing packets at line rate cannot buffer traces; it keeps O(1)
per-flow state.  Every statistic detectors rely on is therefore implemented
as a constant-memory streaming sketch:

  EWMA          — exponentially weighted mean (+variance, Welford-style)
  P2Quantile    — Jain & Chlamtac's P² algorithm: quantile without storage
  CUSUM         — one-sided cumulative-sum change-point detector
  RateMeter     — events/bytes per second over a sliding decay window
  GapTracker    — inter-arrival gap stats (starvation / jitter signals)
  SpreadTracker — max-min arrival spread within tagged groups (straggler signal)
  BurstMeter    — short-window burst magnitude vs long-window baseline

All pure Python / float math — no JAX — because these run on the host telemetry
path, off the accelerator critical path (the paper's "offload to the DPU").
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


class EWMA:
    """Exponentially weighted moving average and variance."""

    __slots__ = ("alpha", "mean", "var", "n")

    def __init__(self, alpha: float = 0.05) -> None:
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = alpha
        self.mean = 0.0
        self.var = 0.0
        self.n = 0

    def update(self, x: float) -> float:
        self.n += 1
        if self.n == 1:
            self.mean = x
            self.var = 0.0
        else:
            delta = x - self.mean
            self.mean += self.alpha * delta
            # EW variance (West 1979): decays old variance, adds new deviation.
            self.var = (1.0 - self.alpha) * (self.var + self.alpha * delta * delta)
        return self.mean

    def update_many(self, xs) -> float:
        """Batch update — bit-identical to calling ``update`` per element.

        The recurrence is inherently sequential (mean_i depends on mean_i-1)
        so the batch form cannot reorder the float math; the win is purely
        mechanical: one call, locals-bound loop, no per-element dispatch.
        """
        a = self.alpha
        one_m = 1.0 - a
        mean = self.mean
        var = self.var
        n = self.n
        for x in xs:
            n += 1
            if n == 1:
                mean = x
                var = 0.0
            else:
                delta = x - mean
                mean += a * delta
                var = one_m * (var + a * delta * delta)
        self.mean = mean
        self.var = var
        self.n = n
        return mean

    @property
    def std(self) -> float:
        return math.sqrt(max(self.var, 0.0))

    def zscore(self, x: float) -> float:
        """How anomalous is x against the learned baseline."""
        if self.n < 2 or self.std == 0.0:
            return 0.0
        return (x - self.mean) / self.std


class P2Quantile:
    """P² algorithm (Jain & Chlamtac 1985): streaming quantile in O(1) memory.

    Tracks a single quantile q with five markers; no sample storage.  Accuracy
    is within a few percent for smooth distributions — exactly the trade a DPU
    makes.
    """

    __slots__ = ("q", "n", "heights", "pos", "desired", "incr", "count")

    def __init__(self, q: float = 0.99) -> None:
        if not 0.0 < q < 1.0:
            raise ValueError(f"quantile must be in (0,1), got {q}")
        self.q = q
        self.heights: list[float] = []
        self.pos = [1.0, 2.0, 3.0, 4.0, 5.0]
        self.desired = [1.0, 1.0 + 2.0 * q, 1.0 + 4.0 * q, 3.0 + 2.0 * q, 5.0]
        self.incr = [0.0, q / 2.0, q, (1.0 + q) / 2.0, 1.0]
        self.count = 0

    def update(self, x: float) -> None:
        self.count += 1
        if len(self.heights) < 5:
            self.heights.append(x)
            self.heights.sort()
            return
        h = self.heights
        # locate cell k
        if x < h[0]:
            h[0] = x
            k = 0
        elif x >= h[4]:
            h[4] = x
            k = 3
        else:
            k = 0
            for i in range(1, 4):
                if x < h[i]:
                    k = i - 1
                    break
            else:
                k = 3
        for i in range(k + 1, 5):
            self.pos[i] += 1.0
        for i in range(5):
            self.desired[i] += self.incr[i]
        # adjust interior markers with parabolic interpolation
        for i in range(1, 4):
            d = self.desired[i] - self.pos[i]
            if (d >= 1.0 and self.pos[i + 1] - self.pos[i] > 1.0) or (
                d <= -1.0 and self.pos[i - 1] - self.pos[i] < -1.0
            ):
                s = 1.0 if d >= 0 else -1.0
                hp = self._parabolic(i, s)
                if h[i - 1] < hp < h[i + 1]:
                    h[i] = hp
                else:
                    h[i] = self._linear(i, s)
                self.pos[i] += s

    def update_many(self, xs) -> None:
        """Batch update — bit-identical to per-element ``update`` calls.

        P² marker motion is strictly sequential, so this is the same
        algorithm with the interpreter overhead stripped: bound locals,
        branch-ladder cell location, and the marker-adjustment loop inlined.
        """
        h = self.heights
        pos = self.pos
        desired = self.desired
        incr = self.incr
        count = self.count
        n = len(xs)
        j0 = 0
        while len(h) < 5 and j0 < n:
            h.append(xs[j0])
            h.sort()
            count += 1
            j0 += 1
        inc1, inc2, inc3, inc4 = incr[1], incr[2], incr[3], incr[4]
        parabolic = self._parabolic
        linear = self._linear
        for j in range(j0, n):
            x = xs[j]
            count += 1
            if x < h[0]:
                h[0] = x
                k = 0
            elif x >= h[4]:
                h[4] = x
                k = 3
            elif x < h[1]:
                k = 0
            elif x < h[2]:
                k = 1
            elif x < h[3]:
                k = 2
            else:
                k = 3
            for i in range(k + 1, 5):
                pos[i] += 1.0
            desired[1] += inc1
            desired[2] += inc2
            desired[3] += inc3
            desired[4] += inc4
            for i in (1, 2, 3):
                d = desired[i] - pos[i]
                if (d >= 1.0 and pos[i + 1] - pos[i] > 1.0) or (
                        d <= -1.0 and pos[i - 1] - pos[i] < -1.0):
                    s = 1.0 if d >= 0 else -1.0
                    hp = parabolic(i, s)
                    if h[i - 1] < hp < h[i + 1]:
                        h[i] = hp
                    else:
                        h[i] = linear(i, s)
                    pos[i] += s
        self.count = count

    def _parabolic(self, i: int, s: float) -> float:
        h, p = self.heights, self.pos
        return h[i] + s / (p[i + 1] - p[i - 1]) * (
            (p[i] - p[i - 1] + s) * (h[i + 1] - h[i]) / (p[i + 1] - p[i])
            + (p[i + 1] - p[i] - s) * (h[i] - h[i - 1]) / (p[i] - p[i - 1])
        )

    def _linear(self, i: int, s: float) -> float:
        h, p = self.heights, self.pos
        j = i + int(s)
        return h[i] + s * (h[j] - h[i]) / (p[j] - p[i])

    @property
    def value(self) -> float:
        if not self.heights:
            return 0.0
        if len(self.heights) < 5:
            # exact small-sample quantile
            idx = min(int(self.q * len(self.heights)), len(self.heights) - 1)
            return sorted(self.heights)[idx]
        return self.heights[2]


class CUSUM:
    """One-sided cumulative-sum change detector on a drifting baseline.

    Fires when the cumulative positive deviation from (baseline + slack)
    exceeds ``threshold`` standard-ish units.  Self-calibrating: the baseline
    is an EWMA of the input, so detectors need no per-workload tuning.
    """

    __slots__ = ("baseline", "slack", "rel_slack", "threshold", "stat",
                 "fired_at", "n")

    def __init__(self, slack: float = 0.5, threshold: float = 5.0,
                 alpha: float = 0.02, rel_slack: float = 0.05) -> None:
        self.baseline = EWMA(alpha)
        self.slack = slack
        # floor the deviation scale at rel_slack * |mean| so near-constant
        # streams (std -> 0) don't turn numeric noise into huge z-scores
        self.rel_slack = rel_slack
        self.threshold = threshold
        self.stat = 0.0
        self.fired_at: int | None = None
        self.n = 0

    def update(self, x: float) -> bool:
        self.n += 1
        if self.baseline.n >= 8:  # need a warm baseline before accumulating
            scale = max(self.baseline.std,
                        self.rel_slack * abs(self.baseline.mean), 1e-9)
            dev = (x - self.baseline.mean) / scale - self.slack
            self.stat = max(0.0, self.stat + dev)
        self.baseline.update(x)
        fired = self.stat > self.threshold
        if fired and self.fired_at is None:
            self.fired_at = self.n
        return fired

    def update_many(self, xs) -> bool:
        """Batch update — bit-identical to per-element ``update`` calls."""
        fired = False
        for x in xs:
            fired = self.update(x)
        return fired

    def reset(self) -> None:
        self.stat = 0.0
        self.fired_at = None


class RateMeter:
    """Decayed events/sec and bytes/sec meter (token-bucket style)."""

    __slots__ = ("halflife", "_rate", "_brate", "_last_ts")

    def __init__(self, halflife: float = 0.1) -> None:
        self.halflife = halflife
        self._rate = 0.0
        self._brate = 0.0
        self._last_ts: float | None = None

    def update(self, ts: float, nbytes: int = 0) -> None:
        if self._last_ts is None:
            self._last_ts = ts
            self._rate = 0.0
            self._brate = 0.0
            return
        dt = max(ts - self._last_ts, 1e-9)
        decay = 0.5 ** (dt / self.halflife)
        self._rate = self._rate * decay + (1.0 - decay) / dt
        self._brate = self._brate * decay + (1.0 - decay) * nbytes / dt
        self._last_ts = ts

    def update_many(self, tss, sizes=None) -> None:
        """Batch update — bit-identical to per-element ``update`` calls.

        ``tss`` is an ascending timestamp sequence; ``sizes`` an optional
        same-length byte sequence (None = all zero).  The decay recurrence is
        sequential (and ``0.5 ** x`` must stay the interpreter's pow — numpy's
        vectorized pow rounds differently), so this is a locals-bound loop.
        """
        n = len(tss)
        if n == 0:
            return
        hl = self.halflife
        last = self._last_ts
        rate = self._rate
        brate = self._brate
        i = 0
        if last is None:
            last = tss[0]
            rate = 0.0
            brate = 0.0
            i = 1
        if sizes is None:
            # scalar adds (1-decay)*0/dt == +0.0 to brate; brate >= 0.0
            # always, so dropping the term is bit-exact
            for j in range(i, n):
                ts = tss[j]
                dt = ts - last
                if dt < 1e-9:
                    dt = 1e-9
                decay = 0.5 ** (dt / hl)
                rate = rate * decay + (1.0 - decay) / dt
                brate = brate * decay
                last = ts
        else:
            for j in range(i, n):
                ts = tss[j]
                dt = ts - last
                if dt < 1e-9:
                    dt = 1e-9
                decay = 0.5 ** (dt / hl)
                one_m = 1.0 - decay
                rate = rate * decay + one_m / dt
                brate = brate * decay + one_m * sizes[j] / dt
                last = ts
        self._last_ts = last
        self._rate = rate
        self._brate = brate

    @property
    def rate(self) -> float:
        return self._rate

    @property
    def byte_rate(self) -> float:
        return self._brate

    def rate_at(self, now: float) -> float:
        """Event rate with decay applied up to ``now`` (for stale reads)."""
        if self._last_ts is None:
            return 0.0
        return self._rate * 0.5 ** (max(now - self._last_ts, 0.0)
                                    / self.halflife)

    def byte_rate_at(self, now: float) -> float:
        if self._last_ts is None:
            return 0.0
        return self._brate * 0.5 ** (max(now - self._last_ts, 0.0)
                                     / self.halflife)


class GapTracker:
    """Inter-arrival gap statistics: mean/EW-variance + running max gap.

    Starvation red flags ("long gaps between ingress packets", Table 3a row 2;
    "doorbells sporadic", 3b row 3) and jitter ("packets spread unevenly over
    time", 3a row 6) both reduce to gap statistics.

    The P² p99 sketch is by far the most expensive per-gap work, and most
    consumers never read it (jitter/mean-only detectors), or stop reading it
    once they freeze a warmup reference.  ``track_p99=False`` drops it;
    ``p99_cap=N`` stops feeding it after N gaps (the reference-freeze
    pattern: the value is only consulted while ``gaps.n <= N``).
    """

    __slots__ = ("gaps", "last_ts", "max_gap", "p99", "p99_cap")

    def __init__(self, alpha: float = 0.05, track_p99: bool = True,
                 p99_cap: int | None = None) -> None:
        self.gaps = EWMA(alpha)
        self.p99: P2Quantile | None = P2Quantile(0.99) if track_p99 else None
        self.p99_cap = p99_cap
        self.last_ts: float | None = None
        self.max_gap = 0.0

    def update(self, ts: float) -> float:
        """Returns the gap that just closed (0.0 for the first event)."""
        if self.last_ts is None:
            self.last_ts = ts
            return 0.0
        gap = ts - self.last_ts
        self.last_ts = ts
        self.gaps.update(gap)
        if self.p99 is not None and (self.p99_cap is None
                                     or self.gaps.n <= self.p99_cap):
            self.p99.update(gap)
        if gap > self.max_gap:
            self.max_gap = gap
        return gap

    def update_many(self, tss) -> None:
        """Batch update — bit-identical to per-element ``update`` calls.

        ``tss`` is an ascending timestamp sequence.  Gap extraction is a
        plain successive subtraction (exactly the scalar op); the EW/max
        fold is inlined into the same pass, and the P² fold (when tracked)
        reuses the quantile sketch's batch form.
        """
        n = len(tss)
        if n == 0:
            return
        last = self.last_ts
        i = 0
        if last is None:
            last = tss[0]
            i = 1
        if i >= n:
            self.last_ts = last
            return
        ew = self.gaps
        a = ew.alpha
        one_m = 1.0 - a
        mean = ew.mean
        var = ew.var
        ew_n = ew.n
        max_gap = self.max_gap
        p99 = self.p99
        cap = self.p99_cap
        want_p99 = p99 is not None and (cap is None or ew_n < cap)
        gaps = [] if want_p99 else None
        for j in range(i, n):
            ts = tss[j]
            gap = ts - last
            last = ts
            if want_p99:
                gaps.append(gap)
            ew_n += 1
            if ew_n == 1:
                mean = gap
                var = 0.0
            else:
                delta = gap - mean
                mean += a * delta
                var = one_m * (var + a * delta * delta)
            if gap > max_gap:
                max_gap = gap
        self.last_ts = last
        ew.mean = mean
        ew.var = var
        ew.n = ew_n
        self.max_gap = max_gap
        if want_p99:
            p99.update_many(gaps if cap is None
                            else gaps[:cap - (ew_n - len(gaps))])

    def current_gap(self, now: float) -> float:
        """Open gap since the last event — the live starvation signal."""
        if self.last_ts is None:
            return 0.0
        return now - self.last_ts

    def jitter(self) -> float:
        """Coefficient of variation of inter-arrival gaps."""
        if self.gaps.n < 2 or self.gaps.mean <= 0.0:
            return 0.0
        return self.gaps.std / self.gaps.mean


class SpreadTracker:
    """Max-min arrival spread within tagged rounds (the straggler statistic).

    Table 3c row 1 (TP straggler): "wide arrival spread of collective bursts
    (max-min arrival gap up)".  Each collective round r collects one arrival
    timestamp per participant; spread(r) = max - min.  We keep an EWMA of the
    spread plus the worst offender identity counts.
    """

    __slots__ = ("spread", "arrivals", "late_counts", "expected", "rounds")

    def __init__(self, expected: int, alpha: float = 0.1) -> None:
        self.expected = expected
        self.spread = EWMA(alpha)
        self.arrivals: dict[int, dict[int, float]] = {}
        self.late_counts: dict[int, int] = {}
        self.rounds = 0

    MIN_SPREAD = 1e-6   # ignore tie rounds: a zero/near-zero spread has no
                        # meaningful "slowest" participant

    def update(self, round_id: int, participant: int, ts: float) -> float | None:
        """Record an arrival; returns the spread when the round completes."""
        arr = self.arrivals.setdefault(round_id, {})
        arr[participant] = ts
        if len(arr) < self.expected:
            return None
        self.rounds += 1
        tss = arr.values()
        spread = max(tss) - min(tss)
        if spread > self.MIN_SPREAD:
            slowest = max(arr, key=arr.__getitem__)
            self.late_counts[slowest] = self.late_counts.get(slowest, 0) + 1
        self.spread.update(spread)
        del self.arrivals[round_id]
        return spread

    def dominant_straggler(self) -> tuple[int, float]:
        """(participant, fraction of rounds it was slowest)."""
        if not self.late_counts or self.rounds == 0:
            return (-1, 0.0)
        worst = max(self.late_counts, key=self.late_counts.__getitem__)
        return worst, self.late_counts[worst] / self.rounds


class BurstMeter:
    """Short-window rate vs long-window baseline — the microburst statistic.

    Table 3a row 1 (burst admission backlog) and §4.1 "early detection of
    microbursts".  burstiness() >> 1 means a short spike well above sustained
    load.
    """

    __slots__ = ("fast", "slow")

    def __init__(self, fast_halflife: float = 0.005,
                 slow_halflife: float = 0.5) -> None:
        self.fast = RateMeter(fast_halflife)
        self.slow = RateMeter(slow_halflife)

    def update(self, ts: float, nbytes: int = 0) -> None:
        self.fast.update(ts, nbytes)
        self.slow.update(ts, nbytes)

    def burstiness(self) -> float:
        if self.slow.rate <= 1e-9:
            return 0.0
        return self.fast.rate / self.slow.rate

    def byte_burstiness(self) -> float:
        if self.slow.byte_rate <= 1e-9:
            return 0.0
        return self.fast.byte_rate / self.slow.byte_rate


@dataclass
class Welford:
    """Exact running mean/variance (for finite populations, e.g. per-node
    volume skew where the population is the node set, not a stream)."""

    n: int = 0
    mean: float = 0.0
    m2: float = 0.0

    def update(self, x: float) -> None:
        self.n += 1
        d = x - self.mean
        self.mean += d / self.n
        self.m2 += d * (x - self.mean)

    @property
    def var(self) -> float:
        return self.m2 / self.n if self.n > 1 else 0.0

    @property
    def std(self) -> float:
        return math.sqrt(max(self.var, 0.0))

    def cv(self) -> float:
        """Coefficient of variation — the load-skew statistic (3c row 3)."""
        return self.std / self.mean if self.mean > 0 else 0.0
