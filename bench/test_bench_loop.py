"""The harness at a tiny size on the CPU, through the kernels' plain
versions: one well-formed result, and the reference agreeing with the
program."""

import json

import numpy as np
import pytest
import torch

from bench import check, tiny
from bench.cell import execute

LIMITS = {"gap_max": 0.05, "gap_mean": 0.01}


@pytest.mark.parametrize("family", ["hybrid", "moe"])
@pytest.mark.parametrize("trace", [False, True])
def test_run_prints_one_wellformed_line(family, trace, monkeypatch):
    tiny.steady_clock(monkeypatch)
    cell = tiny.cell(family, LIMITS)
    res, _ = execute(cell, 2**31 + 977, 0.5, trace, torch.device("cpu"),
                     0.0)
    line = json.loads(json.dumps(res))
    assert list(line)[:4] == ["correct", "attempted", "failed", "metrics"]
    assert list(line)[-1] == "check"
    assert line["correct"] is True
    assert line["failed"] == 0 and line["attempted"] > 0
    assert line["check"]["sampled_tokens"] >= 20
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    # the CPU has no kernels and no device: those readers stay silent
    assert set(line["metrics"]) <= names
    for m in (["decode_step_ms", "telemetry_flush_ms", "mfu_pct",
               "itl_p95_ms.host"] if trace else ["tokens_per_s", "setup_s"]):
        assert line["metrics"][m]["value"] > 0
    assert ("breakdown" in line) == trace
    if trace:
        assert line["device"]["window_s"] > 0


@pytest.mark.parametrize("family", ["hybrid", "moe"])
def test_reference_follows_the_program(family):
    """Prefill then decode through the program's cache, against the
    reference's one pass over the whole sequence (float32 both)."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import net_type, Model

    from bench.reference import hybrid, moe
    from bench.weights import fill
    run = tiny.run_sizes(family)
    cfg = ModelConfig(**run)
    net = fill(net_type(cfg)(cfg, torch.device("cpu")), 5,
               torch.device("cpu"), tiny.DT_INIT)
    model = Model(cfg, net, torch.device("cpu"))
    gen = torch.Generator().manual_seed(3)
    bucket, steps = 64, 6
    toks = torch.randint(0, run["vocab"], (1, bucket), generator=gen)
    toks[0, :9] = 0                       # left padding, as the engine pads
    cache = model.init_cache(1, 96, 16)
    logits, cache = model.prefill(toks.to(torch.int32), cache)
    got = [logits[0, -1]]
    seq = toks[0].tolist()
    for _ in range(steps):
        nxt = int(got[-1].argmax())
        seq.append(nxt)
        logits, cache = model.decode_step(
            torch.tensor([[nxt]], dtype=torch.int32), cache)
        got.append(logits[0, -1])
    ref = hybrid if family == "hybrid" else moe
    params = dict(net.named_parameters())
    x = ref.forward(run, params, torch.tensor([seq]), prefill=[bucket])
    want = ref.logits(run, params, x[0, bucket - 1:])
    assert torch.allclose(torch.stack(got), want, atol=1e-4, rtol=1e-4)


def test_capacity_drops_as_the_program_does():
    """Prefill groups hit the capacity: the reference drops the same
    pairs as the program (logits equal), and not dropping would differ."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.moe import MoE, moe_per_row

    from bench.reference import moe as ref
    from bench.weights import fill
    run = tiny.run_sizes("moe")
    cfg = ModelConfig(**run)
    layer = MoE(cfg, torch.device("cpu"))
    layer.embed = torch.nn.Parameter(torch.empty(1, 1), requires_grad=False)
    fill(layer, 9, torch.device("cpu"))
    h = torch.randn(2, 40, run["d_model"], generator=torch.Generator()
                    .manual_seed(1))
    h[:, :12] = h[:, :1]                  # identical rows crowd one expert
    want, _ = moe_per_row(layer, cfg, h)
    params = {k: v for k, v in layer.named_parameters() if k != "embed"}
    got = ref.moe(h, params, run, prefill=[40, 40])
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
    undropped = ref.moe(h, params, run, prefill=[0, 0])
    assert not torch.allclose(undropped, want, atol=1e-3)


def test_sample_takes_the_longest_and_meets_the_rule():
    from bench.traffic import Request
    reqs = [Request(i, 0, None, 4, tokens=[0] * (5 + i % 7))
            for i in range(40)]
    rule = {"min_requests": 3, "min_tokens": 30, "max_requests": 8}
    picked = check.sample(reqs, rule, 11)
    assert max(len(r.tokens) for r in reqs) == len(picked[0].tokens)
    assert len(picked) >= 3 and sum(len(r.tokens) for r in picked) >= 30
    assert [r.rid for r in picked] == [r.rid for r in
                                      check.sample(reqs, rule, 11)]


def test_ratio_to_the_baseline():
    prog = [np.array([0.0, 0.2]), np.array([0.1])]
    base = [np.array([0.0, 0.05]), np.array([0.0])]
    nums = check.numbers(prog, base)
    assert nums["gap_mean_over_bf16"] == pytest.approx(0.1 / (0.05 / 3))
    assert nums["baseline_flips"] == 1
    assert check.numbers(prog, [np.zeros(3)])["gap_mean_over_bf16"] \
        == float("inf")
    assert "gap_mean_over_bf16" not in check.numbers(prog)


def test_rounded_weights_round_both_operands():
    w = torch.randn(8, 4, generator=torch.Generator().manual_seed(1))
    x = torch.randn(3, 8, generator=torch.Generator().manual_seed(2))
    for fmt, eps in (("bf16", 2e-2), ("e4m3", 2e-1)):
        got = x @ check.rounded_weights({"w": w}, fmt)["w"]
        want = check.ROUNDINGS[fmt](x, -1) @ check.ROUNDINGS[fmt](w, -2)
        if fmt in check.ROUNDED_RESULT:
            want = check.ROUNDINGS[fmt](want, -1)
        assert torch.equal(got, want)
        assert torch.allclose(got, x @ w, atol=eps * 8, rtol=eps)
