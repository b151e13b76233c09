"""The metric arithmetic on hand-built runs, and the work counts against
hand-worked shapes."""

import math

import pytest

from bench import work
from bench.reference import moe
from bench.loop import Iteration
from bench.readout import Readout, reader
from bench.traffic import Request
from bench.tiny import TINY_MIX, run_sizes


def steady(stall_at=None, stall=0.0, steps=100, slots=4, dt=0.01):
    """A window of ``steps`` decode steps of ``dt`` seconds on ``slots``
    requests, with one step ``stall`` seconds longer at ``stall_at``."""
    its, reqs = [], [Request(i, i, None, 10**6, stamps=[], tokens=[])
                     for i in range(slots)]
    t = 0.0
    for k in range(steps):
        t0 = t
        t += dt + (stall if k == stall_at else 0.0)
        its.append(Iteration(t0, t, running=slots, step_s=t - t0))
        for r in reqs:
            r.stamps.append(t)
            r.tokens.append(0)
    return Readout(run_sizes("moe"), TINY_MIX, 1.0, 0.0, t, its, reqs)


def test_stall_shows_in_itl_and_rate():
    base = steady()
    stalled = steady(stall_at=50, stall=0.5)
    itl, rate = reader("itl_p95_ms.host"), reader("tokens_per_s")
    assert itl(base) == pytest.approx(10.0)
    assert rate(base) == pytest.approx(400.0)
    assert rate(stalled) == pytest.approx(400 / 1.5)
    # one long gap in 99: the 95th percentile stays at the steady gap...
    assert itl(stalled) == pytest.approx(10.0)
    # ...and six in 99 move it
    many = steady()
    for k in (10, 25, 40, 55, 70, 85):
        many = _stall(many, k, 0.5)
    assert itl(many) > 100.0


def _stall(ro, k, s):
    for it in ro.iterations[k:]:
        it.t0 += s if it is not ro.iterations[k] else 0.0
        it.t1 += s
    ro.iterations[k].step_s += s
    for r in ro.requests:
        r.stamps = [x + s if i >= k else x for i, x in enumerate(r.stamps)]
    ro.t_close += s
    return ro


def test_ttft_counts_waiting_requests():
    ro = steady()
    ro.requests[0].submitted, ro.requests[0].first = 0.1, 0.15
    ro.requests[1].submitted, ro.requests[1].first = 0.2, -1.0
    for r in ro.requests[2:]:
        r.submitted = -1.0
    # 50 ms, and (1.0 - 0.2) s waited at the close
    assert reader("ttft_p90_ms.host")(ro) == pytest.approx(
        (50 + 0.9 * (800 - 50)))


def test_flash_work_by_hand():
    # causal s = 4: 10 (query, key) pairs, 2 flops each for QK and PV
    flops, nbytes = work.flash_work(1, 4, 2, 1, 8)
    assert flops == 4 * 8 * 2 * 10
    assert nbytes == 2 * (2 * 4 * 2 * 8 + 2 * 4 * 1 * 8)


def test_paged_work_by_hand():
    flops, nbytes = work.paged_work(30, 2, 4, 2, 16, per_seq=3)
    assert flops == 4 * 16 * 4 * 30
    assert nbytes == 2 * 30 * 2 * 16 * 2 + 2 * 2 * 4 * 16 * 2 + 2 * 3 * 4 \
        + 2 * 4


def test_ssd_work_by_hand():
    # one chunk of 3 steps: 6 lower-triangle pairs
    flops, nbytes = work.ssd_work(1, 3, 2, 4, 5, init=True)
    assert flops == 6 * 5 * 2 + 2 * (6 * 4 * 2 + 2 * 3 * 5 * 4 * 2)
    assert nbytes == 4 * (2 * 3 * 2 * 4 + 3 * 2 + 2 * 3 * 5 + 2 * 2 * 4 * 5)
    # a ragged second chunk counts as long as it is
    f2, _ = work.ssd_work(1, 130, 1, 1, 1, init=False)
    tri = 128 * 129 / 2 + 2 * 3 / 2
    assert f2 == tri * 2 + (tri * 2 + 2 * 130 * 2)


@pytest.mark.parametrize("groups", [1, 2, 8])
def test_ssd_work_counts_each_group(groups):
    # one chunk of 3 steps: C B^T (6 pairs of n = 5) once per group; B and
    # C (3 x 5 each) read once per group; the heads' work unchanged
    flops, nbytes = work.ssd_work(1, 3, 2, 4, 5, True, groups=groups)
    assert flops == groups * 6 * 5 * 2 + 2 * (6 * 4 * 2 + 2 * 3 * 5 * 4 * 2)
    assert nbytes == 4 * (2 * 3 * 2 * 4 + 3 * 2 + groups * 2 * 3 * 5
                          + 2 * 2 * 4 * 5)
    one = work.ssd_work(1, 3, 2, 4, 5, True)
    f1, b1 = work.ssd_work(1, 3, 2, 4, 5, True, groups=1)
    assert (f1, b1) == one
    assert flops - f1 == (groups - 1) * 6 * 5 * 2
    assert nbytes - b1 == 4 * (groups - 1) * 2 * 3 * 5


def test_bound_takes_the_larger_term():
    assert work.bound_s(989e12, 0, "bfloat16") == pytest.approx(1.0)
    assert work.bound_s(1.0, 3.35e12, "bfloat16") == pytest.approx(1.0)


def dense(run: dict) -> work.Counts:
    """The counts a plain dense decoder's reference module would state: per
    layer its attention and a SwiGLU of width ``d_ff``."""
    d, hd = run["d_model"], run["head_dim"]
    attn = d * run["n_heads"] * hd * 2 + d * run["n_kv_heads"] * hd * 2
    return work.Counts(
        weights=run["n_layers"] * (attn + 3 * d * run["d_ff"]),
        head=d * run["vocab"],
        attention=((run["n_layers"], run["n_heads"], run["n_kv_heads"], hd),))


def test_token_flops_by_hand():
    run = {"d_model": 8, "n_heads": 2, "n_kv_heads": 1, "head_dim": 4,
           "d_ff": 16, "n_layers": 2, "vocab": 10}
    c = dense(run)
    per_layer = 8 * 8 * 2 + 8 * 4 * 2 + 3 * 8 * 16
    assert c.weights == 2 * per_layer
    f = work.token_flops(c, 5, True)
    assert f == 2 * 2 * per_layer + 4 * 4 * 2 * 5 * 2 + 2 * 8 * 10
    # a prompt of 3: contexts 1 + 2 + 3, the head once
    assert work.prompt_flops(c, 3) == pytest.approx(
        3 * 2 * 2 * per_layer + 4 * 4 * 2 * 2 * 6 + 2 * 8 * 10)
    assert work.step_flops(c, 2, 9) == pytest.approx(
        2 * work.token_flops(c, 0, True) + 4 * 4 * 2 * 2 * 9)


def test_moe_params_count_routed_and_shared():
    run = run_sizes("moe")
    d, f = run["d_model"], run["expert_d_ff"]
    hd = run["head_dim"]
    attn = 2 * d * run["n_heads"] * hd + 2 * d * run["n_kv_heads"] * hd
    ffn = d * run["n_experts"] + run["top_k"] * 3 * d * f \
        + run["n_shared_experts"] * 3 * d * f
    c = moe.counts(run)
    assert c.weights == run["n_layers"] * (attn + ffn)
    assert math.isfinite(work.token_flops(c, 10, True))
