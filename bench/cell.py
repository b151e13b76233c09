"""One run of one cell: the model and engine built from the cell's files,
warm-up, the measured window, the optional traced iterations, then the
check against the reference and the metrics.

A cell (``BENCHMARK.json``'s ``workloads`` entry) names a configuration
(``configs[].file``: the model's ``run`` sizes, its dtype, the weight
initialisation, and under ``"reference"`` the path of its plain float32
module, which computes its logits for the check and states its work for
the metrics) and a traffic mix (``bench/traffic/<traffic>.json``); the
limits of its check are in ``bench/checks/<workload>.json``."""

from __future__ import annotations

import gc
import json
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from bench import check
from bench.loop import Loop
from bench.readout import Readout, module, reader
from bench.weights import fill

ROOT = Path(__file__).resolve().parents[1]
PAGE = 16
TRACED = "traced_window"
BASELINE = "gap_mean_over_bf16"


@dataclass
class Cell:
    name: str
    config: dict              # the configuration file
    mix: dict                 # the traffic mix file
    limits: dict | None       # the check's limits, by number
    end_to_end: list          # metric entries of BENCHMARK.json
    per_layer: list
    reference: object         # the configuration's reference module


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def reference(config: dict, root: Path = ROOT):
    """The module at the configuration's ``"reference"`` path (relative to
    ``root``, the checkout), loaded by path as the metric readers are."""
    path = root / config["reference"]
    return module(path, f"bench_reference_{path.stem}")


def load(workload: str, root: Path = ROOT) -> Cell:
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in spec["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = json.loads((root / cfg["file"]).read_text())
    mix = json.loads((root / "bench" / "traffic"
                      / f"{cell['traffic']}.json").read_text())
    limits_file = root / "bench" / "checks" / f"{workload}.json"
    limits = json.loads(limits_file.read_text())["limits"] \
        if limits_file.exists() else None
    return Cell(workload, config, mix, limits,
                [m for m in spec["end_to_end"] if _applies(m, workload)],
                [m for m in spec["per_layer"] if _applies(m, workload)],
                reference(config, root))


def buckets(mix: dict, prefill_buckets: tuple) -> list[int]:
    """The prefill buckets the mix's prompt lengths fall into."""
    lo, hi = mix["prompt"]["min"], mix["prompt"]["max"]
    out = []
    for b in prefill_buckets:
        if b >= lo:
            out.append(b)
        if b >= hi:
            break
    return out


def build(config: dict, mix: dict, seed: int, device: torch.device):
    """The model, its weights drawn on ``device`` from ``seed``, and the
    engine as deployed: telemetry and mitigation on, DPU control."""
    from repro_torch.models import Model
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import net_type
    from repro_torch.serving.engine import EngineConfig, InferenceEngine
    cfg = ModelConfig(**config["run"])
    net = net_type(cfg)(cfg, torch.device("cpu"))
    net = fill(net, seed, device, config.get("dt_init"),
               config.get("residual_out"))
    model = Model(cfg, net, device)
    longest = mix["prompt"]["max"] + 2 * mix["output"]["max"]
    ecfg = EngineConfig(max_slots=mix["slots"], max_seq=mix["max_seq"],
                        page_size=PAGE,
                        n_pages=mix["slots"] * -(-longest // PAGE),
                        telemetry=True, mitigate=True, control="dpu",
                        dpu_seed=int(seed) & 0x7FFFFFFF)
    return model, InferenceEngine(model, ecfg)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclass
class Served:
    """What a run leaves for its check and its metrics."""
    model: object
    readout: Readout
    finished: list            # requests finished inside the window
    peak: int                 # device memory peak, bytes
    trace: object


def serve(cell: Cell, seed: int, seconds: float, trace: bool,
          device: torch.device, t_start: float, log=lambda *a: None
          ) -> Served:
    """Build, warm up, run the window (and with ``trace`` the traced
    iterations after it), read the memory peak, and free the engine."""
    marks = [("start", time.perf_counter())]
    model, engine = build(cell.config, cell.mix, seed, device)
    _sync(device)
    marks.append(("model and engine", time.perf_counter()))
    with torch.no_grad():
        for b in buckets(cell.mix, engine.sched.cfg.prefill_buckets):
            model.prefill(torch.zeros((1, b), dtype=torch.int32,
                                      device=device),
                          model.init_cache(1, cell.mix["max_seq"], PAGE))
    _sync(device)
    marks.append(("bucket warm-up", time.perf_counter()))
    loop = Loop(engine, cell.mix, cell.config["run"]["vocab"], seed,
                annotate=trace)
    for _ in range(cell.mix["warmup_iters"]):
        loop.iterate()
    _sync(device)
    # as servers do after warm-up, the set-up's objects leave the
    # collector's generations: its passes in the window scan only what the
    # window makes
    gc.collect()
    gc.freeze()
    t_open = time.perf_counter()
    marks.append(("loop warm-up", t_open))
    setup_s = t_open - t_start
    log(f"setup {setup_s:.2f} s (" + ", ".join(
        f"{name} {b - a:.2f}" for (_, a), (name, b)
        in zip(marks, marks[1:])) + f"); window of {seconds} s")
    while True:
        it = loop.iterate()
        if it.t1 - t_open >= seconds:
            break
    t_close = it.t1
    log(f"window: {sum(1 for it in loop.iterations if it.t0 >= t_open)} "
        f"iterations; mitigations applied (iteration, action): "
        f"{loop.actions}")
    tr, traced = None, []
    if trace:
        tr, traced = _traced(loop, cell.mix["trace_iters"], device)
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    finished = [r for r in loop.requests.values()
                if t_open <= r.finished <= t_close]
    ro = Readout(cell.config["run"], cell.mix, setup_s, t_open, t_close,
                 loop.iterations, list(loop.requests.values()), PAGE, tr,
                 traced, cell.reference)
    # the program's state goes before the reference runs
    engine.slot_cache = None
    del engine, loop
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return Served(model, ro, finished, peak, tr)


@dataclass
class Checked:
    """The check's sample and its gaps, one array per request: the
    program's served tokens, the baseline's choices where the cell's limits
    need them, and on request the control's."""
    picked: list
    program: list
    baseline: list | None = None
    control: list | None = None


def execute(cell: Cell, seed: int, seconds: float, trace: bool,
            device: torch.device, t_start: float,
            log=lambda *a: None, control: bool = False
            ) -> tuple[dict, Checked]:
    """Run the cell once; returns the result line's object and the check's
    gaps (with ``control``, the control's too, on the same requests)."""
    sv = serve(cell, seed, seconds, trace, device, t_start, log)
    run = cell.config["run"]
    params = dict(sv.model.decoder.named_parameters())
    picked = check.sample(sv.finished, cell.mix["check"], seed)
    t_check = time.perf_counter()
    ref = cell.reference
    checked = Checked(picked, check.gaps(run, ref, params, picked))
    if control or BASELINE in (cell.limits or {}):
        checked.baseline = check.gaps(run, ref, params, picked,
                                      rounding="bf16")
    nums = check.numbers(checked.program, checked.baseline)
    log(f"check of {len(picked)} requests, {nums['tokens']} tokens: "
        f"{time.perf_counter() - t_check:.2f} s")
    ok, lines = check.judge(nums, cell.limits or {})
    ro = sv.readout
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = reader(m["name"])(ro)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(ok and cell.limits),
              "attempted": sum(1 for r in ro.requests
                               if ro.t_open <= r.submitted <= ro.t_close),
              "failed": 0, "metrics": metrics}
    result["device"] = _device(device, sv.peak)
    if sv.trace is not None:
        result["device"].update(busy_s=sv.trace.busy_s(),
                                window_s=sv.trace.window_s)
        result["breakdown"] = breakdown(sv.trace)
    result["check"] = {"sampled_requests": len(picked),
                       "sampled_tokens": nums["tokens"], **lines}
    if control:
        checked.control = check.gaps(run, ref, params, picked,
                                     rounding="e4m3")
    return result, checked


def _traced(loop: Loop, iters: int, device: torch.device):
    from torch.profiler import ProfilerActivity, profile, record_function

    from bench.trace import reduce
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=acts) as prof:
        with record_function(TRACED):
            traced = [loop.iterate() for _ in range(iters)]
            _sync(device)
    return reduce(prof, TRACED), traced


def breakdown(tr) -> dict:
    """The device operations that took most time, and the device's idle
    time summed by the loop span the host was in."""
    ops: dict[str, float] = {}
    for name, _, s, e, _ in tr.ops:
        ops[name] = ops.get(name, 0.0) + (e - s) * 1e-9
    idle: dict[str, float] = {}
    for span, ns in tr.idle_gaps():
        idle[span] = idle.get(span, 0.0) + ns * 1e-9
    top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k[:120], v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gaps]}


def _device(device: torch.device, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1, "memory_peak_bytes": int(peak)}
