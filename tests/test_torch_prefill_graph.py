"""The engine's prefill as one body for every device
(``serving.engine.prefill_body``), which the card captures as one CUDA
graph per prefill bucket and replays: an engine whose prefills replay
recorded graphs (the CPU stand-in of ``torch_graphs``) serves the same
tokens and leaves the same cache rows as an eager engine, every bucket is
captured once, a prefill that waits for the device stays eager, and the
replays book the kernels' launches.  Beside them, what the body rests on:
``Model.prefill(..., fresh=True)`` against the read-back of ``pos``, and
``reset_cache`` against a fresh cache.  The tests marked ``card`` hold the
real graphs to the eager prefills on an NVIDIA card."""

import dataclasses
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.model import CACHE_BATCH_AXIS, reset_cache  # noqa: E402
from repro_torch.serving import EngineConfig, InferenceEngine  # noqa: E402
from repro_torch.serving import ServeRequest  # noqa: E402
from repro_torch.serving.engine import capture_step  # noqa: E402
from torch_graphs import capture, capture_prefills, stand_in  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
NEMOTRON = json.loads((ROOT / "bench" / "configs" / "nemotron-3-nano.json")
                      .read_text())["run"]
# dense, dense on a sliding-window ring, MoE, the zamba2 hybrid, the
# layer-pattern stack, xLSTM: every family the engine serves
SERVED = ("qwen3-0.6b", "h2o-danube-3-4b", "qwen2-moe-a2.7b", "zamba2-7b",
          "nemotron-3-nano", "xlstm-125m")
# two buckets (64, 128); more requests than slots, so slots are reused
PROMPTS = (20, 90, 40, 100, 30, 64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def config(arch: str) -> ModelConfig:
    if arch == "nemotron-3-nano":
        return ModelConfig(**NEMOTRON).reduced()
    return ARCHS[arch].reduced()


def model_of(arch: str, device: str = "cpu", **over):
    return build_model(dataclasses.replace(config(arch), **over),
                       device=device, seed=7)


def _engine(model, slots: int = 2) -> InferenceEngine:
    return InferenceEngine(model, EngineConfig(max_slots=slots, max_seq=160,
                                               control="dpu"))


def _requests(vocab: int, prompts=PROMPTS) -> list[ServeRequest]:
    return [ServeRequest(i, 0.002 * i, [(7 * i + 3 * j) % vocab
                                        for j in range(n)], 3 + i % 3)
            for i, n in enumerate(prompts)]


def _row(engine, slot: int) -> dict:
    return {key: engine.slot_cache[key].select(axis, slot).clone()
            for key, axis in CACHE_BATCH_AXIS.items()
            if key in engine.slot_cache}


def _watch(engine) -> dict:
    """What the engine hands on: each prefill's first token and the
    slot's cache row right after it, each step's tokens."""
    seen = {"prefills": [], "steps": []}
    prefill, record = engine._prefill, engine._record_tokens

    def tap_prefill(slot, req):
        prefill(slot, req)
        seen["prefills"].append((req.req_id, slot,
                                 engine._slot_next_token[slot],
                                 _row(engine, slot)))

    def tap_record(slots, nxt):
        seen["steps"].append(list(nxt))
        record(slots, nxt)
    engine._prefill, engine._record_tokens = tap_prefill, tap_record
    return seen


def _strip(rep):
    """The report without the telemetry plane's wall-clock timings."""
    tel = {k: v for k, v in rep["telemetry"].items()
           if not k.startswith("ns_per_event")}
    return {**rep, "telemetry": tel}


def _same(a: list, b: list) -> None:
    assert len(a) == len(b)
    for (rid, slot, tok, row), (rid_, slot_, tok_, row_) in zip(a, b):
        assert (rid, slot, tok) == (rid_, slot_, tok_)
        assert row.keys() == row_.keys()
        for key in row:
            assert torch.equal(row[key], row_[key]), (rid, key)


@pytest.mark.parametrize("arch", SERVED)
def test_replayed_prefills_serve_as_eager_ones(arch):
    model = model_of(arch)
    eager, replayed = _engine(model), _engine(model)
    capture_prefills(replayed)
    want, got = _watch(eager), _watch(replayed)
    reqs = _requests(model.cfg.vocab)
    rep = replayed.run(reqs)
    assert _strip(rep) == _strip(eager.run(_requests(model.cfg.vocab)))
    assert rep["completed"] == len(reqs)
    assert len({slot for _, slot, _, _ in got["prefills"]}) == 2
    _same(got["prefills"], want["prefills"])
    assert got["steps"] == want["steps"]
    # the two buckets, each captured at its first prefill and replayed at
    # every later one
    buckets = [replayed.sched.bucket_len(n) for n in PROMPTS]
    assert sorted(replayed._prefills) == [64, 128]
    for bucket, graph in replayed._prefills.items():
        assert graph.graph.replays == buckets.count(bucket) - 1
    assert eager._prefills == {}
    for key, value in replayed.slot_cache.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(value, eager.slot_cache[key]), key


def test_each_bucket_is_captured_once():
    model = model_of("qwen3-0.6b")
    eng = _engine(model, slots=3)
    captured = []

    def counted(body):
        captured.append(body)
        return capture(body)
    eng._capture_prefill = counted
    prompts = (10, 200, 70, 60, 150, 250, 90, 5, 129, 64)
    rep = eng.run(_requests(model.cfg.vocab, prompts))
    assert rep["completed"] == len(prompts)
    assert sorted(eng._prefills) == [64, 128, 256]
    assert len(captured) == 3
    for bucket, graph in eng._prefills.items():
        n = sum(1 for p in prompts if eng.sched.bucket_len(p) == bucket)
        assert graph.graph.replays == n - 1, bucket


def test_a_prefill_that_waits_stays_eager():
    """A capture that finds the body waiting for the device (``capture_step``
    returns no graph) leaves that bucket eager: its later prefills run the
    body, and it is never captured again; other buckets still are."""
    model = model_of("qwen3-0.6b")
    eng, ref = _engine(model), _engine(model)
    tries, bodies = [], []
    body = eng._prefill_body

    def counted(bucket):
        bodies.append(bucket)
        return body(bucket)

    def waits_at_64(body):
        out = body()            # the capture's run, a real prefill
        tries.append(bodies[-1])
        return out, None if bodies[-1] == 64 else stand_in(body)
    eng._prefill_body, eng._capture_prefill = counted, waits_at_64
    got, want = _watch(eng), _watch(ref)
    eng.run(_requests(model.cfg.vocab))
    ref.run(_requests(model.cfg.vocab))
    _same(got["prefills"], want["prefills"])
    assert tries == [64, 128]
    assert eng._prefills[64] is None
    assert eng._prefills[128].graph.replays == 1
    # bucket 64: the capture's run, then every later prefill eagerly; 128:
    # the capture's run and its recording, then a replay's run
    assert bodies.count(64) == 4 and bodies.count(128) == 3


def test_replays_book_the_launches_of_an_eager_prefill():
    model = model_of("zamba2-7b")
    per_prefill = {"flash_attention": 2, "ssd_scan": 3}
    counts = []
    for graphs in (False, True):
        eng = _engine(model)
        if graphs:
            capture_prefills(eng)
        body = eng._prefill_body

        def launching(bucket, body=body):
            # what the kernels' wrappers count as a prefill's kernels run
            for name, n in per_prefill.items():
                ops.KERNELS[name].launches += n
            return body(bucket)
        eng._prefill_body = launching
        ops.reset_launch_counts()
        try:
            eng.run(_requests(model.cfg.vocab))
            counts.append(ops.launch_counts())
        finally:
            ops.reset_launch_counts()
        if graphs:
            assert sorted(eng._prefills) == [64, 128]
            for graph in eng._prefills.values():
                assert graph.launches == per_prefill
                assert graph.graph.replays >= 1
    n = eng.stats["prefills"]
    assert n == len(PROMPTS)
    assert counts[0] == counts[1] == {
        **dict.fromkeys(ops.KERNELS, 0),
        **{name: k * n for name, k in per_prefill.items()}}


FAMILIES = SERVED + ("llava-next-mistral-7b",)


@pytest.mark.parametrize("arch", FAMILIES)
def test_a_fresh_prefill_need_not_read_back(arch):
    """``fresh=True`` on a fresh cache is the read-back's prefill, bit for
    bit; ``fresh=False`` on a cache past position 0 likewise."""
    model = model_of(arch)
    gen = torch.Generator().manual_seed(3)
    tokens = torch.randint(0, model.cfg.vocab, (2, 24), generator=gen,
                           dtype=torch.int32)
    runs = {}
    for fresh in (None, True):
        cache = model.init_cache(2, 64, 16)
        logits, cache = model.prefill(tokens, cache, fresh=fresh)
        more, cache = model.prefill(tokens[:, :8], cache,
                                    fresh=None if fresh is None else False)
        runs[fresh] = (logits, more, cache)
    (a, a2, ca), (b, b2, cb) = runs[None], runs[True]
    assert torch.equal(a, b) and torch.equal(a2, b2)
    assert ca.keys() == cb.keys()
    for key, value in ca.items():
        if isinstance(value, torch.Tensor):
            assert torch.equal(value, cb[key]), key


@pytest.mark.parametrize("arch", FAMILIES + ("seamless-m4t-large-v2",))
def test_reset_cache_makes_a_fresh_cache(arch):
    model = model_of(arch)
    cache = model.init_cache(2, 32, 8, src_len=4)
    held = {k: (v, v.data_ptr()) for k, v in cache.items()
            if isinstance(v, torch.Tensor)}
    for value, _ in held.values():
        value.copy_(torch.rand(value.shape) * 100 - 50)
    reset_cache(cache)
    fresh = model.init_cache(2, 32, 8, src_len=4)
    assert cache.keys() == fresh.keys()
    for key, value in fresh.items():
        if not isinstance(value, torch.Tensor):
            assert cache[key] == value
            continue
        assert cache[key] is held[key][0]
        assert cache[key].data_ptr() == held[key][1]
        assert torch.equal(cache[key], value), key


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    from repro_torch.kernels import build
    build.build()


@pytest.mark.card
def test_capture_step_leaves_a_waiting_body_eager():
    _card()
    x = torch.arange(6, dtype=torch.float32, device="cuda")
    out = torch.zeros_like(x)

    def waits():
        return out.copy_(x * 2 if float(x.sum()) > 0 else x)

    def flows():
        return out.copy_(x * 3)
    got, graph = capture_step(waits, x.device)
    assert graph is None and torch.equal(got, x * 2)
    got, graph = capture_step(flows, x.device,
                              torch.cuda.graph_pool_handle())
    assert graph is not None and torch.equal(got, x * 3)
    out.zero_()
    x.add_(1)
    graph.replay()
    assert torch.equal(out, x * 3)


@pytest.mark.card
@pytest.mark.parametrize("arch", SERVED)
def test_graphs_on_the_card_serve_as_eager_prefills(arch):
    """bf16 on the card: the engine's captured and replayed prefills give
    the eager engine's first tokens and cache rows bit for bit, over two
    buckets and reused slots, with the same launches counted."""
    _card()
    model = model_of(arch, device="cuda", dtype="bfloat16")
    eager, replayed = _engine(model), _engine(model)
    eager._capture_prefill = None
    launches = []
    seen = []
    for eng in (eager, replayed):
        seen.append(_watch(eng))
        ops.reset_launch_counts()
        eng.run(_requests(model.cfg.vocab))
        torch.cuda.synchronize()
        launches.append(ops.launch_counts())
    ops.reset_launch_counts()
    _same(seen[1]["prefills"], seen[0]["prefills"])
    assert seen[1]["steps"] == seen[0]["steps"]
    assert launches[0] == launches[1]
    assert sorted(replayed._prefills) == [64, 128]
    assert all(g is not None for g in replayed._prefills.values())
