"""The engine's decode step as one body for every device
(``serving.engine.decode_body``), which the card captures as a CUDA graph
and replays: on the CPU it must give ``Model.decode_step``'s logits bit
for bit and advance ``pos`` and ``kpos`` as it does, without rebinding or
moving a cache tensor; the engine's run keeps its cache's tensors; and a
replayed graph books the kernels' launches as the eager step would."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import EngineConfig, InferenceEngine  # noqa: E402
from repro_torch.serving import ServeRequest  # noqa: E402
from repro_torch.serving.engine import StepGraph, decode_body  # noqa: E402
from torch_graphs import install  # noqa: E402

FAMILIES = ("qwen3-0.6b", "qwen2-moe-a2.7b", "zamba2-7b",
            "llava-next-mistral-7b", "seamless-m4t-large-v2", "xlstm-125m")
PROMPT, STEPS, PAGE = 16, 8, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tensors(cache: dict) -> dict:
    return {k: v for k, v in cache.items() if isinstance(v, torch.Tensor)}


def _clone(cache: dict) -> dict:
    return {k: v.clone() if isinstance(v, torch.Tensor) else v
            for k, v in cache.items()}


def _prefilled(arch: str):
    """Two rows prefilled with different prompts (after a VLM's patch
    embeddings, or over an encoder-decoder's frames), in a ring four
    positions longer than the prompt, so the steps wrap it."""
    cfg = ARCHS[arch].reduced()
    model = build_model(cfg, device="cpu", seed=2)
    gen = torch.Generator().manual_seed(4)
    front = None
    total = PROMPT
    src = 0
    if cfg.family == "vlm":
        front = torch.randn((2, cfg.frontend_tokens, cfg.d_model),
                            generator=gen)
        total += cfg.frontend_tokens
    elif cfg.family == "encdec":
        src = 8
        front = torch.randn((2, src, cfg.d_model), generator=gen)
    cache = model.init_cache(2, total + 4, PAGE, src_len=src)
    tokens = torch.randint(0, cfg.vocab, (2, PROMPT), generator=gen,
                           dtype=torch.int32)
    _, cache = model.prefill(tokens, cache, frontend=front)
    feed = torch.randint(0, cfg.vocab, (STEPS, 2, 1), generator=gen,
                         dtype=torch.int32)
    return model, cache, feed


@pytest.mark.parametrize("arch", FAMILIES)
def test_body_steps_as_decode_step(arch):
    model, cache, feed = _prefilled(arch)
    ref, mine = _clone(cache), _clone(cache)
    before = {k: (v, v.data_ptr()) for k, v in _tensors(mine).items()}
    tokens = torch.zeros((2, 1), dtype=torch.int32)
    nxt = torch.zeros((2,), dtype=torch.int64)
    for t in range(STEPS):
        want, ref = model.decode_step(feed[t], ref)
        tokens.copy_(feed[t])
        got = decode_body(model, tokens, mine, nxt)
        assert torch.equal(got, want)
        assert torch.equal(nxt, want[:, -1].argmax(dim=-1))
        for key in ("pos", "kpos"):
            if key in ref:
                assert torch.equal(mine[key], ref[key]), key
    assert int(mine["pos"][0]) == int(cache["pos"][0]) + STEPS
    assert ("kpos" in mine) == (arch != "xlstm-125m")
    assert mine.keys() == ref.keys()
    for key, value in _tensors(mine).items():
        assert value is before[key][0] and \
            value.data_ptr() == before[key][1], key
        assert torch.equal(value, ref[key]), key


def _requests():
    return [ServeRequest(i, i * 0.002, [3 + i] * (6 + 5 * i), 4 + i % 3)
            for i in range(6)]


@pytest.fixture(scope="module")
def qwen():
    return build_model(ARCHS["qwen3-0.6b"].reduced(), device="cpu", seed=1)


def _engine(model):
    return InferenceEngine(model, EngineConfig(max_slots=4, max_seq=64,
                                               control="dpu"))


def test_engine_run_keeps_its_cache_tensors(qwen):
    eng = _engine(qwen)
    held = dict(eng.slot_cache)
    ptrs = {k: v.data_ptr() for k, v in _tensors(held).items()}
    rep = eng.run(_requests())
    assert rep["completed"] == len(_requests()) and rep["steps"] > 0
    assert eng._graph is None and eng.step_logits is not None
    assert eng.slot_cache.keys() == held.keys()
    for key, value in _tensors(eng.slot_cache).items():
        assert value is held[key] and value.data_ptr() == ptrs[key], key


def _strip(rep):
    """The report without the telemetry plane's wall-clock timings."""
    tel = {k: v for k, v in rep["telemetry"].items()
           if not k.startswith("ns_per_event")}
    return {**rep, "telemetry": tel}


def _tokens(engine) -> list:
    """Each step's greedy tokens, as the engine hands them on."""
    seen = []
    record = engine._record_tokens

    def tap(slots, nxt):
        seen.append(list(nxt))
        record(slots, nxt)
    engine._record_tokens = tap
    return seen


def test_replayed_steps_serve_as_eager_ones(qwen):
    """Every step of an engine replayed from a (stand-in) graph: the same
    tokens and report as the eager engine's."""
    eager, replayed = _engine(qwen), _engine(qwen)
    graph = install(replayed)
    want, got = _tokens(eager), _tokens(replayed)
    rep = replayed.run(_requests())
    assert _strip(rep) == _strip(eager.run(_requests()))
    assert got == want and len(got) == rep["steps"]
    assert graph.replays == rep["steps"]
    assert replayed.step_logits is graph.out
    assert [(r.req_id, r.tokens_out, r.finished) for r in
            replayed.completed] == [(r.req_id, r.tokens_out, r.finished)
                                    for r in eager.completed]


class Counted:
    """A graph stand-in whose replays are counted."""

    def __init__(self) -> None:
        self.replays = 0

    def replay(self) -> None:
        self.replays += 1


def test_replays_book_the_launches_a_capture_takes_back():
    def body():
        # what the wrappers count as a step's kernels are called
        ops.KERNELS["paged_attention"].launches += 3
        ops.KERNELS["flash_attention"].launches += 1
        return torch.ones(2)

    ops.reset_launch_counts()
    try:
        graph = Counted()
        step = StepGraph(body, graph, lambda g: _Capturing(g))
        zero = dict.fromkeys(ops.KERNELS, 0)
        assert ops.launch_counts() == zero
        assert step.launches == {"paged_attention": 3, "flash_attention": 1}
        out = step.replay()
        assert out is step.output and graph.replays == 1
        step.replay()
        assert ops.launch_counts() == {**zero, "paged_attention": 6,
                                       "flash_attention": 2}
        ops.add_launch_counts({"ssd_scan": 5})
        assert ops.launch_counts()["ssd_scan"] == 5
    finally:
        ops.reset_launch_counts()


class _Capturing:
    """The capture's context: the graph is not replayed inside it."""

    def __init__(self, graph) -> None:
        self.graph = graph

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        assert self.graph.replays == 0
