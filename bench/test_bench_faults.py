"""The check fails a broken timed path: a run at a tiny size on the CPU
(the harness's look for a card skipped), with a fault planted under the
engine's decode step, must come out not correct; the same run without a
fault is correct."""

import pytest
import torch

from bench import cell as cellmod
from bench import tiny

LIMITS = {"gap_max": 0.05, "gap_mean": 0.01}


def altered(step):
    """Every token changed where it is produced: each row's best logit
    pushed below all others."""
    def fn(tokens, cache):
        logits, cache = step(tokens, cache)
        logits = logits.clone()
        best = logits[:, -1].argmax(-1)
        logits[torch.arange(logits.shape[0]), -1, best] = -1e30
        return logits, cache
    return fn


def unchanged(step):
    """The step returns its state unchanged: every cache tensor as it
    was before the step."""
    def fn(tokens, cache):
        saved = {k: v.clone() for k, v in cache.items()
                 if isinstance(v, torch.Tensor)}
        logits, new = step(tokens, cache)
        for k, v in saved.items():
            cache[k].copy_(v)
        return logits, cache
    return fn


def half_batch(step):
    """Half of the batch left out: the second half of the rows gets the
    first half's logits."""
    def fn(tokens, cache):
        logits, cache = step(tokens, cache)
        logits = logits.clone()
        h = logits.shape[0] // 2
        logits[h:2 * h] = logits[:h]
        return logits, cache
    return fn


def run(family, fault, monkeypatch):
    build = cellmod.build

    def faulty_build(*args, **kw):
        model, engine = build(*args, **kw)
        if fault is not None:
            model.decode_step = fault(model.decode_step)
        return model, engine
    monkeypatch.setattr(cellmod, "build", faulty_build)
    tiny.steady_clock(monkeypatch)
    return cellmod.execute(tiny.cell(family, LIMITS), 4242, 0.5, False,
                           torch.device("cpu"), 0.0)[0]


@pytest.mark.parametrize("family", ["hybrid", "moe"])
@pytest.mark.parametrize("fault", [altered, unchanged, half_batch],
                         ids=lambda f: f.__name__)
def test_fault_is_not_correct(family, fault, monkeypatch):
    res = run(family, fault, monkeypatch)
    assert res["correct"] is False
    assert any(v["value"] > v["limit"] for v in res["check"].values()
               if isinstance(v, dict))


@pytest.mark.parametrize("family", ["hybrid", "moe"])
def test_no_fault_is_correct(family, monkeypatch):
    assert run(family, None, monkeypatch)["correct"] is True
