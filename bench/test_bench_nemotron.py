"""The nemotron-3-nano cell's files: its reference module's counts, its two
readers on hand-built records and a hand-built trace (silent on a program
that keeps no such record), and a tiny configuration of the architecture
through the harness on the CPU."""

import dataclasses
import json

import pytest
import torch

from bench import program_spans, work
from bench.cell import ROOT, Cell, execute, load, reference
from bench.loop import Iteration
from bench.readout import METRICS, Readout, module, reader
from bench.tiny import TINY_MIX, steady_clock
from bench.trace import Trace

CELL = "nemotron-3-nano.chat"
CONFIG = json.loads((ROOT / "bench" / "configs" / "nemotron-3-nano.json")
                    .read_text())
MS = 1_000_000
SHIFT = 7 * 10**17              # the profiler's clock against the host's
GEMM = ("void cutlass::device_kernel<at::cuda::detail::"
        "enable_3x_kernel_for_sm9x<cutlass::gemm::kernel::GemmUniversal<"
        "cutlass::gemm::GroupProblemShape<cute::tuple<int, int, int> > > >"
        " >(T1::Params)")


def test_counts_by_hand():
    c = reference(CONFIG).counts(CONFIG["run"])
    d, f, v = 2688, 1856, 131072
    mamba = d * (2 * 4096 + 2 * 8 * 128 + 64) + 4096 * d
    moe = d * 128 + 6 * 64 // 128 * 2 * d * f + 2 * d * 3712
    attn = 2 * d * 32 * 128 + 2 * d * 2 * 128
    assert c.weights == 23 * mamba + 23 * moe + 6 * attn == 2_186_010_624
    assert c.head == d * v
    assert c.attention == ((6, 32, 2, 128),)
    assert c.ssd == ((23, 64, 64, 128, 8),)
    assert c.other_flops == 23 * (4 * 64 * 64 * 128 + 2 * 4 * 6144)


def test_the_cell_reads_its_own_metrics_only():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    names = {m["name"] for m in load(CELL).per_layer}
    assert {"held_experts_touched_pct", "expert_roofline"} <= names
    for m in spec["per_layer"]:
        if m["name"] in ("held_experts_touched_pct", "expert_roofline"):
            assert m["workloads"] == [CELL]


class Steps:
    """A stand-in for the program's ``EXPERT_STEPS``."""

    def __init__(self, steps):
        self.steps = steps

    def within(self, t0, t1):
        return [s for s in self.steps if t0 <= s.t <= t1]


class Spans:
    def __init__(self, spans):
        self.spans = spans

    def within(self, t0, t1):
        return [s for s in self.spans if s.start >= t0 and s.end <= t1]


def _step(ms, pairs, touched, held=23 * 64):
    from repro_torch.obs import ExpertStep
    return ExpertStep(round(ms * MS), pairs, touched, held)


# two window steps, then two traced steps (and the traced prefill between)
STEPS = [_step(1100, 8832, 1400), _step(1500, 8832, 1380),
         _step(2196, 8832, 1390), _step(2299, 8832, 1372)]
ENQUEUE = [(2102, 2180), (2262, 2290)]
# (name, launch, device start, device end) in ms, on the profiler's clock
OPS = {1: (GEMM, 2105, 2110, 2122), 2: ("nvjet_gemm", 2106, 2122, 2130),
       3: (GEMM, 2265, 2270, 2280), 4: (GEMM, 2210, 2212, 2240)}


@pytest.fixture
def program(monkeypatch):
    import repro_torch.obs as obs
    from repro_torch.obs import HostSpan
    monkeypatch.setattr(obs, "EXPERT_STEPS", Steps(STEPS))
    spans = [HostSpan(i, "step.enqueue", round(s * MS), round(e * MS), -1,
                      -1, 0) for i, (s, e) in enumerate(ENQUEUE)]
    monkeypatch.setattr(program_spans, "source", lambda: (
        Spans(spans), lambda t: t + SHIFT))
    return obs


def readout() -> Readout:
    ops = [(name, "kernel", round(s * MS) + SHIFT, round(e * MS) + SHIFT,
            corr) for corr, (name, _, s, e) in OPS.items()]
    tr = Trace((2099 * MS + SHIFT, 2301 * MS + SHIFT), ops=ops,
               launches={c: round(v[1] * MS) + SHIFT
                         for c, v in OPS.items()})
    its = [Iteration(2.1, 2.201, running=64), Iteration(2.201, 2.301)]
    return Readout(CONFIG["run"], TINY_MIX, 30.0, 1.0, 2.0, [], [],
                   trace=tr, traced=its)


def test_touched_share_over_the_window(program):
    got = reader("held_experts_touched_pct")(readout())
    assert got == pytest.approx((1400 + 1380) / 2 / (23 * 64) * 100)


def test_roofline_of_the_traced_steps(program):
    d, f = 2688, 1856
    bound = sum(max(8832 * 4.0 * d * f / 989e12,
                    2 * (t * 2 * d * f + 8832 * (2 * d + 2 * f)) / 3.35e12)
                for t in (1390, 1372))
    got = reader("expert_roofline")(readout())
    # the prefill's grouped GEMM and the step's other kernels left out
    assert got == pytest.approx(bound / 0.022 * 100)
    assert 0 < got <= 100


def test_the_bound_reads_each_touched_weight_once():
    roof = module(METRICS / "expert_roofline.py", "expert_roofline")
    run = CONFIG["run"]
    w = 2 * 2 * run["d_model"] * run["expert_d_ff"] * 1000
    assert roof.step_bound_s(run, 0, 1000) == pytest.approx(
        w / work.PEAK_BYTES_PER_S)


def test_silent_on_a_program_without_the_record(program, monkeypatch):
    monkeypatch.delattr(program, "EXPERT_STEPS")
    for name in ("held_experts_touched_pct", "expert_roofline"):
        assert reader(name)(readout()) is None
    monkeypatch.setattr(program, "EXPERT_STEPS", Steps([]), raising=False)
    for name in ("held_experts_touched_pct", "expert_roofline"):
        assert reader(name)(readout()) is None


def _tiny_cell() -> Cell:
    from repro_torch.models.config import ModelConfig
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    run = dataclasses.asdict(ModelConfig(**CONFIG["run"]).reduced(vocab=512))
    config = {"run": run, "dt_init": CONFIG["dt_init"],
              "reference": CONFIG["reference"]}
    applies = [m for m in spec["per_layer"]
               if CELL in m.get("workloads", [CELL])]
    return Cell("tiny-nemotron", config, TINY_MIX,
                {"gap_max": 0.05, "gap_mean": 0.01}, spec["end_to_end"],
                applies, reference(config))


@pytest.mark.parametrize("trace", [False, True])
def test_a_tiny_cell_serves_the_reference(trace, monkeypatch):
    from bench import cell
    from repro_torch.obs import hostspans
    steady_clock(monkeypatch)
    # the program books its counts on the same steady clock
    monkeypatch.setattr(hostspans, "perf_counter_ns",
                        lambda: round(cell.time.perf_counter() * 1e9))
    torch.manual_seed(0)
    res, _ = execute(_tiny_cell(), 2**31 + 4093, 0.5, trace,
                     torch.device("cpu"), 0.0)
    assert res["correct"] is True and res["failed"] == 0
    assert res["check"]["sampled_tokens"] >= 20
    assert res["check"]["gap_max"]["value"] <= 1e-4
    if trace:
        touched = res["metrics"]["held_experts_touched_pct"]["value"]
        assert 0 < touched <= 100
        # no kernels on the CPU
        assert "expert_roofline" not in res["metrics"]
    else:
        assert res["metrics"]["tokens_per_s"]["value"] > 0
