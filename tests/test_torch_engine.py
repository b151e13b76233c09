"""The port's InferenceEngine against the JAX package's, with the same
weights, on the workloads of tests/test_system.py, of
tests/test_serving_training.py::TestInferenceEngine (instant control and
the DPU sidecar) and of examples/serve_with_dpu_telemetry.py (static
batching, 200-token generations over max_seq 128: the decode ring wraps;
instant control and the sidecar), some of them traced.

Scheduling, event sizes and the clock do not depend on the tokens, so the
reports (wall-clock timings aside), every telemetry batch (at the sink the
engine feeds, and at the plane behind a sidecar's wire and budget), the
sidecar's report, the tracer's incidents and counters and the flight
recorder's snapshot must be equal.
Tokens are compared through the logits: the port is fed the JAX engine's
inputs at every model call (teacher forcing), because greedy argmax may
flip on near-ties in a random-init model, and each call's logits must agree
to 1e-4."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.core.events import BATCH_COLUMNS  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import InferenceEngine as JEngine  # noqa: E402
from repro.serving import ServeRequest as JRequest  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.serving import EngineConfig, InferenceEngine  # noqa: E402
from repro_torch.serving import ServeRequest  # noqa: E402

LOGIT_TOL = 1e-4
WALL_CLOCK = ("ns_per_event", "ns_per_event_by_detector")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes side by side; one intra-op
    thread each keeps torch's many small CPU ops from oversubscribing the
    cores (its spinning worker threads slow every process down)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def models():
    out = {}
    for arch in ("qwen3-0.6b", "llama3.2-3b"):
        jm = jax_build_model(JARCHS[arch].reduced())
        params = jm.init(jax.random.key(0))
        tm = params_from_jax(ARCHS[arch].reduced(),
                             jax.tree.map(np.asarray, params), device="cpu")
        out[arch] = (jm, params, tm)
    return out


# ----------------------------------------------------------------------
# workloads: (arch, engine kwargs, static batching, request specs, steps)
# ----------------------------------------------------------------------

def _system_vantages():
    rng = random.Random(0)
    return [(i, i * 0.002, [1] * rng.randrange(8, 30), 6) for i in range(8)]


def _system_healthy():
    return [(i, i * 0.004, [1] * 16, 8) for i in range(10)]


def _system_overhead():
    return [(i, 0.0, [1] * 16, 8) for i in range(8)]


def _engine_completes(vocab):
    rng = random.Random(0)
    return [(i, i * 0.004,
             [rng.randrange(vocab) for _ in range(rng.randrange(8, 40))],
             rng.randrange(4, 16)) for i in range(10)]


def _engine_batching(vocab, mode):
    rng = random.Random(1)
    sets = [[(i, 0.0, [rng.randrange(vocab) for _ in range(8)],
              40 if i % 4 == 0 else 4) for i in range(12)]
            for _ in range(2)]   # the test builds the continuous set first
    return sets[0 if mode == "continuous" else 1]


def _example(vocab):
    rng = random.Random(7)
    return [(i, 0.0, [rng.randrange(vocab) for _ in range(8)],
             200 if i % 4 == 0 else 4) for i in range(16)]


def _serving_dpu(vocab):
    rng = random.Random(2)
    return [(i, i * 0.004, [rng.randrange(vocab) for _ in range(12)], 6)
            for i in range(8)]


SYSTEM = dict(max_slots=4, max_seq=128, n_pages=128, page_size=16)
LLAMA_V = JARCHS["llama3.2-3b"].reduced().vocab
QWEN_V = JARCHS["qwen3-0.6b"].reduced().vocab
WORKLOADS = {
    "system_vantages": ("qwen3-0.6b", SYSTEM, False, _system_vantages(), 200),
    "system_healthy": ("qwen3-0.6b", SYSTEM, False, _system_healthy(), 300),
    "system_overhead": ("qwen3-0.6b", SYSTEM, False, _system_overhead(),
                        200),
    "engine_completes": ("llama3.2-3b",
                         dict(max_slots=4, max_seq=128, n_pages=64,
                              page_size=16), False,
                         _engine_completes(LLAMA_V), 400),
    "engine_continuous": ("llama3.2-3b",
                          dict(max_slots=4, max_seq=128, n_pages=256,
                               page_size=16, telemetry=False), False,
                          _engine_batching(LLAMA_V, "continuous"), 600),
    "engine_static": ("llama3.2-3b",
                      dict(max_slots=4, max_seq=128, n_pages=256,
                           page_size=16, telemetry=False), True,
                      _engine_batching(LLAMA_V, "static"), 600),
    "example_static": ("qwen3-0.6b",
                       dict(max_slots=4, max_seq=128, n_pages=256,
                            telemetry=True, mitigate=False), True,
                       _example(QWEN_V), 800),
    "example_mitigated": ("qwen3-0.6b",
                          dict(max_slots=4, max_seq=128, n_pages=256,
                               telemetry=True, mitigate=True), True,
                          _example(QWEN_V), 800),
    "example_dpu": ("qwen3-0.6b",
                    dict(max_slots=4, max_seq=128, n_pages=256,
                         telemetry=True, mitigate=True, control="dpu"), True,
                    _example(QWEN_V), 800),
    # the closed loop that chip_smoke.py serves at full width on the card
    "example_dpu_traced": ("qwen3-0.6b",
                           dict(max_slots=4, max_seq=128, n_pages=256,
                                telemetry=True, mitigate=True,
                                control="dpu", trace=True), True,
                           _example(QWEN_V), 800),
    "engine_dpu": ("llama3.2-3b",
                   dict(max_slots=4, max_seq=128, n_pages=64, page_size=16,
                        control="dpu"), False, _serving_dpu(LLAMA_V), 400),
    "system_vantages_traced": ("qwen3-0.6b", dict(SYSTEM, trace=True),
                               False, _system_vantages(), 200),
    "system_vantages_dpu_traced": ("qwen3-0.6b",
                                   dict(SYSTEM, control="dpu", trace=True),
                                   False, _system_vantages(), 200),
}


def _tap(obj) -> list[dict]:
    """Every batch handed to ``obj.observe_batch``, its columns copied."""
    batches = []
    observe = obj.observe_batch

    def tap(batch):
        batches.append({c: np.array(getattr(batch, c))
                        for c in BATCH_COLUMNS})
        return observe(batch)
    obj.observe_batch = tap
    return batches


def _capture_batches(eng) -> dict[str, list[dict]]:
    """The batches the engine hands its sink and, behind a DPU sidecar's
    wire and budget, those that reach the plane."""
    if eng.plane is None:
        return {}
    out = {"plane": _tap(eng.plane)}
    if eng.dpu is not None:
        out["sink"] = _tap(eng.dpu)
    return out


def _loop_state(eng) -> dict:
    """What the control loop observed, beyond the report."""
    out = {}
    if eng.dpu is not None:
        out["dpu"] = eng.dpu.report()
    if eng.tracer is not None:
        out["tracer"] = (eng.tracer.reports(), eng.tracer.counters)
        out["recorder"] = eng.recorder.snapshot(eng.clock)
    return out


def _run_jax(jm, params, kw, static, specs, steps):
    eng = JEngine(jm, params, JEngineConfig(**kw))
    if static:
        eng.sched.set_continuous(False)
    batches = _capture_batches(eng)
    calls = []      # (kind, input tokens, logits (rows, V))
    decode = eng._decode_vmapped

    def decode_tap(toks, cache):
        logits, cache = decode(toks, cache)
        calls.append(("decode", np.asarray(toks).reshape(-1, 1),
                      np.asarray(logits).reshape(toks.shape[0], -1)))
        return logits, cache
    eng._decode_vmapped = decode_tap
    prefill_fn = eng._prefill_fn

    def prefill_tap(bucket):
        fn = prefill_fn(bucket)

        def run(p, toks, cache):
            logits, cache = fn(p, toks, cache)
            calls.append(("prefill", np.asarray(toks),
                          np.asarray(logits).reshape(1, -1)))
            return logits, cache
        return run
    eng._prefill_fn = prefill_tap
    rep = eng.run([JRequest(*s) for s in specs], max_steps=steps)
    return rep, batches, calls, _loop_state(eng)


class ForcedModel:
    """The port's model, fed the JAX engine's inputs call by call."""

    def __init__(self, model, calls) -> None:
        self.model = model
        self.cfg = model.cfg
        self.device = model.device
        self.calls = iter(calls)
        self.pairs = []     # (port logits, jax logits)

    def init_cache(self, *args):
        return self.model.init_cache(*args)

    def _next(self, kind, tokens):
        got_kind, toks, want = next(self.calls)
        assert got_kind == kind
        assert tokens.shape == toks.shape
        return torch.from_numpy(np.array(toks)), want

    def prefill(self, tokens, cache, fresh=None):
        toks, want = self._next("prefill", tokens)
        np.testing.assert_array_equal(tokens.numpy(), toks.numpy())
        logits, cache = self.model.prefill(tokens, cache, fresh=fresh)
        self.pairs.append((logits.reshape(1, -1).numpy(), want))
        return logits, cache

    def decode_step(self, tokens, cache):
        toks, want = self._next("decode", tokens)
        logits, cache = self.model.decode_step(toks, cache)
        self.pairs.append((logits.reshape(toks.shape[0], -1).numpy(), want))
        return logits, cache


def _strip(rep: dict) -> dict:
    rep = dict(rep)
    if "telemetry" in rep:
        rep["telemetry"] = {k: v for k, v in rep["telemetry"].items()
                            if k not in WALL_CLOCK}
    return rep


def engine_parity(jm, params, model, workload) -> list[tuple]:
    """One workload (a name of ``WORKLOADS``, or such an entry itself)
    through the JAX engine and through the port's, the port fed the JAX
    engine's inputs at every model call.  Asserts that the reports, the
    batches at each tap and the loop's state are equal; returns the (port,
    JAX) logits of every call, for the caller to hold to its tolerance."""
    _, kw, static, specs, steps = (WORKLOADS[workload]
                                   if isinstance(workload, str) else workload)
    jrep, jbatches, calls, jstate = _run_jax(jm, params, kw, static, specs,
                                             steps)

    forced = ForcedModel(model, calls)
    eng = InferenceEngine(forced, EngineConfig(**kw))
    if static:
        eng.sched.set_continuous(False)
    batches = _capture_batches(eng)
    rep = eng.run([ServeRequest(*s) for s in specs], max_steps=steps)

    assert _strip(rep) == _strip(jrep)
    assert rep["completed"] == len(specs)
    assert batches.keys() == jbatches.keys()
    for tap, want_batches in jbatches.items():
        assert len(batches[tap]) == len(want_batches), tap
        for got, want in zip(batches[tap], want_batches):
            for col in BATCH_COLUMNS:
                np.testing.assert_array_equal(got[col], want[col],
                                              err_msg=f"{tap}: {col}")
    state = _loop_state(eng)
    assert state == jstate
    assert state.keys() == {
        *(("dpu",) if kw.get("control") == "dpu" else ()),
        *(("tracer", "recorder") if kw.get("trace") else ())}
    assert len(forced.pairs) == len(calls)
    return forced.pairs


@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_engine_matches_jax(models, workload):
    jm, params, tm = models[WORKLOADS[workload][0]]
    for got, want in engine_parity(jm, params, tm, workload):
        np.testing.assert_allclose(got, want, atol=LOGIT_TOL,
                                   rtol=LOGIT_TOL)


def test_mitigated_example_recovers_steps(models):
    """The example's closed loop, on the port: mitigation, in process or
    through the DPU sidecar's command bus, flips static batching to
    continuous and finishes in fewer steps."""
    _, _, tm = models["qwen3-0.6b"]
    steps = {}
    for name, kw in (("static", dict(mitigate=False)),
                     ("instant", dict(mitigate=True)),
                     ("dpu", dict(mitigate=True, control="dpu"))):
        eng = InferenceEngine(tm, EngineConfig(
            max_slots=4, max_seq=128, n_pages=256, telemetry=True, **kw))
        eng.sched.set_continuous(False)
        rep = eng.run([ServeRequest(*s) for s in _example(QWEN_V)],
                      max_steps=800)
        steps[name] = rep["steps"]
        if name != "static":
            assert "inflight_remap" in [a for _, a, _ in
                                        rep["telemetry"]["actions"]]
    assert eng.dpu.report()["commands"]["applied"] >= 1
    assert steps["instant"] < steps["static"]
    assert steps["dpu"] < steps["static"]


def test_mitigation_surface(models):
    _, _, tm = models["llama3.2-3b"]
    eng = InferenceEngine(tm, EngineConfig(max_slots=2, max_seq=64,
                                           telemetry=False))
    assert eng.apply_action("inflight_remap", 0, {})
    assert eng.sched.cfg.continuous
    assert eng.apply_action("compress_kv", 0, {})
    assert eng.kv_compress
    assert eng.apply_action("admission_control", 0, {})
    assert eng.apply_action("throttle_telemetry", 0, {})
    assert eng.telemetry_stride == 2
    assert not eng.apply_action("no_such_action", 0, {})
    assert eng.tracer is None and eng.recorder is None


def test_unknown_control_raises(models):
    _, _, tm = models["qwen3-0.6b"]
    with pytest.raises(ValueError):
        InferenceEngine(tm, EngineConfig(max_slots=2, max_seq=64,
                                         control="bogus"))


@pytest.mark.parametrize("control", ["instant", "dpu"])
def test_loop_wiring(models, control):
    """Who owns actuation: the plane's controller (instant), or the
    sidecar's policy engine with the engine behind its command bus (dpu);
    a tracer hangs on whichever runs the loop."""
    _, _, tm = models["qwen3-0.6b"]
    eng = InferenceEngine(tm, EngineConfig(max_slots=2, max_seq=64,
                                           control=control, trace=True))
    assert eng.tracer is not None and eng.recorder is not None
    if control == "dpu":
        assert eng.plane.controller is None
        assert eng.dpu.bus.engine is eng
        assert eng.dpu.policy.tracer is eng.tracer
    else:
        assert eng.dpu is None
        assert eng.plane.controller.engine is eng
        assert eng.plane.tracer is eng.tracer
        assert eng.plane.recorder is eng.recorder
