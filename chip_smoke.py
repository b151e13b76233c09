#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py
(``--phases kernels`` runs the build and only the named phases, for a
quick check of the kernels, and ends with {"partial": [...]}; only the
full run proves the port and prints the "ok" line.  ``--ssd-tree SRC``
only times the SSD scan of the package under SRC, another tree's src/, at
the prefill buckets, to compare two commits in one call.)

Phases, each printing one JSON line:
  build    build the CUDA kernels with nvcc from the checkout's sources
  kernels  each kernel against its plain PyTorch version on the card, at
           the serving paths' shapes (qwen3-0.6b's, zamba2-7b's, llama3.2-
           3b's; flash also bidirectional at seamless-m4t-large-v2's encoder
           and cross-attention shapes) and at edge cases; kernel, plain and
           library times with CUDA events, each two ways (see Timer); the
           SSD backward at zamba2-7b's shape, from the forward's kept
           scratch and recomputing it, against its plain version and
           autograd of the plain forward, with the CUDA kernels one call
           starts; flash and paged refusing a gradient on the card
  path     at full width, f32, the same seeded weights on the CPU (plain
           versions) and on the card (kernels), a 200-token prompt and 8
           teacher-forced decode steps: qwen3-0.6b with 2 layers,
           zamba2-7b with 7 (one super-block of 6 Mamba2 layers and the
           shared attention block, and one tail layer), qwen2-moe-a2.7b
           and granite-moe-3b-a800m with 2, xlstm-125m with 2 (one pair),
           llava-next-mistral-7b with 2 after 576 seeded patch embeddings,
           and seamless-m4t-large-v2 with 2 + 2 over 200 seeded frames;
           then the engine's decode step as one CUDA graph: zamba2-7b (7
           layers) and qwen2-moe-a2.7b (2), bf16, 8 prefilled slots, 17
           steps eager and the same steps captured and replayed from
           copies of one cache, logits equal bit for bit
  train    the loss and every gradient at full width, f32, the same
           seeded weights on the CPU and on the card, 256 tokens:
           qwen3-0.6b (2 layers), zamba2-7b (7: the SSD forward and
           backward kernels), qwen2-moe-a2.7b (2), xlstm-125m (one pair),
           seamless-m4t-large-v2 (2 + 2 over 200 seeded frames, attending
           through sdpa: no flash launch under grad); the MoE experts'
           backward in bf16 against f32; then full-size
           qwen3-0.6b (bf16, remat) through repro_torch.launch.train's set-
           up: 12 steps of 8 x 512 tokens in 2 microbatches, a crash at step
           6, a restore from its checkpoint, the run finished, three steps
           on one batch (the loss must fall) and a profiled step
  serve    behind InferenceEngine with telemetry and mitigation, full width
           and depth, bf16, seeded weights: qwen3-0.6b serving 16 requests,
           then zamba2-7b serving 8
  families the same for the MoE and xLSTM families: qwen2-moe-a2.7b
           (full width, 6 of its 24 layers) serving 8 requests,
           xlstm-125m serving 8
  prefills each benchmark configuration of BENCHMARK.json at full size
           behind the engine its cells build, at each prefill bucket they
           use: eager prefills, then the bucket's CUDA graph captured and
           replayed, first token and cache row equal bit for bit; the
           device operations and host times of one prefill each way
  control  the DPU closed loop of examples/serve_with_dpu_telemetry.py at
           full width: qwen3-0.6b (bf16, seeded weights) from static
           batching, telemetry over the modeled wire into the DPU sidecar,
           traced; held to the same loop on the CPU (every batch, report,
           sidecar report and incident equal); then alternating runs under
           dpu and instant control for the loop's host cost
  launch   python -m repro_torch.launch.serve on the card and with
           --device cpu: equal printed lines and reports
  quickstart  examples/torch_quickstart.py's steps, through its functions:
           full-size llama3.2-3b (bf16, seeded weights) serves its ten
           requests with telemetry, held to the same run on the CPU;
           tp_straggler injected in the simulator, detected and attributed
           as the golden fixture says; hot_replica's loop off and on; the
           smoke sweep (python -m repro_torch.sim.sweep --smoke in a child
           process beside the card work) with its gate, its cells and the
           golden fixture's smoke scenarios; the port's linter clean (its
           first line gives numpy's version)
  examples the four examples/torch_*.py as a user runs them, at their own
           size, on the card (their default device) and with --device cpu:
           the same printed lines (wall-clock lines by their form, losses
           within 1e-3), the quickstart's and the serve example's exact
           flash and paged launches, train_100m --full --steps 8 twice in
           one checkpoint directory (the second run resumes, bit for bit),
           and the drill-down on one row per runbook table, each detected
           as the golden fixture says.  The simulator runs on the host
           whatever the device: each distinct scenario runs once in the
           process (the quickstart phase's and the golden check's runs
           serve the examples)
  dist     the distribution layer (child processes: this process keeps no
           process group): full-size qwen3-0.6b trained through
           repro_torch.launch.train with --mesh 1,1 (MeshRules over a
           one-rank NCCL group, DTensor parameters) and without it, each
           step's loss equal within 2e-2 and both ms/step; full-width
           qwen3-0.6b prefill of 1024 tokens and 8 decode steps with
           shard=MeshRules against NOSHARD, logits within 2e-2 and the same
           flash and paged launches; the paged kernel's log-sum-exp output
           on the serve case's 8 slots, each sequence cut in two slices and
           merged against one whole call, and the whole call timed with and
           without it; the dry-run and roofline of the three hill-climb
           cells on a 16x16 fake mesh (host counts over meta tensors, no
           card)
Then the per-kernel summary line, the card's name and power limit as
nvidia-smi gives them, and as the last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failed check raises and the script exits non-zero.  Without a CUDA card,
or without the package beside it, it exits non-zero and prints no result.
This script imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import math
import os
import random
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (dense): the bound of each kernel
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
SSD_TOL = 2e-4      # the JAX package's own SSD scan tolerance
# the SSD backward: each gradient to this fraction of its largest magnitude;
# da looser, as a sum over the chunk of differences of cumulative decays
# that reach -1e3 (ssd_scan.py's _cumsum note)
SSD_BWD_TOL = 1e-4
SSD_BWD_DA_TOL = 1e-3
TRAIN_TOL = 1e-3    # train path: loss and each gradient, card against CPU
# The hybrid's gradients, card against CPU, are a sanity bound only, on
# each tensor's normwise error ||d|| / ||g||: through seven full-width
# Mamba2 layers with random weights, the two devices' f32 sum orders move
# the early layers' gradients by several percent in that norm, with the
# plain versions on the card as with the kernels (the train case reports
# both).  What the kernels change is held apart: their gradients against
# the plain versions' on the same card, to TRAIN_TOL of each tensor's max.
HYBRID_TRAIN_TOL = 0.15
SSD_BUCKETS = (64, 128, 256, 512, 1024)   # the engine's prefill buckets

REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:137",
    "paged_attention": "src/repro/kernels/paged_attention.py:128",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:88",
    # the gradient of the same function: the TPU kernel has no backward,
    # the JAX package differentiates its jnp form (ssm.py:ssd_chunked)
    "ssd_scan_bwd": "src/repro/kernels/ssd_scan.py:88",
}
REPLACES_FN = {
    "flash_attention": "src/repro/kernels/flash_attention.py:"
                       "flash_attention_kernel",
    "paged_attention": "src/repro/kernels/paged_attention.py:"
                       "paged_attention_kernel",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:ssd_scan_kernel",
    "ssd_scan_bwd": "jax.grad of src/repro/models/ssm.py:ssd_chunked",
}
SOURCE = {
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "paged_attention": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan.cu",
    "ssd_scan_bwd": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ----------------------------------------------------------------------
# timing
# ----------------------------------------------------------------------

class Timer:
    """Mean time of one call in ms, from CUDA events around each call,
    taken two ways on the same calls.

    ``__call__`` returns the events' time with each call enqueued as it
    comes (the script's yardstick from the start): where a call is shorter
    than its host cost, the device waits for the host between the events,
    so this reads host launch latency plus device time.
    ``last_device_ms`` times the same calls after the device was first held
    busy (~1 ms of spin per call), so the host has enqueued every call
    before the first runs and the events time the device's work alone.
    ``last_host_ms`` is the mean host time to enqueue one call.  With
    ``flush``, a 64 MiB write between calls evicts the 50 MB L2, so a call
    that the real path makes on cold data is timed cold."""

    SPIN_CYCLES_PER_CALL = 2_000_000

    def __init__(self, torch) -> None:
        self.torch = torch
        self.scratch = torch.empty(64 << 20, dtype=torch.uint8,
                                   device="cuda")
        self.last_device_ms = self.last_host_ms = None

    def __call__(self, fn, iters: int = 20, warmup: int = 3,
                 flush: bool = False) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        ms, _ = self._events(fn, iters, flush)
        torch.cuda._sleep(self.SPIN_CYCLES_PER_CALL * iters)
        self.last_device_ms, self.last_host_ms = self._events(fn, iters,
                                                              flush)
        return ms

    def _events(self, fn, iters: int, flush: bool) -> tuple[float, float]:
        torch = self.torch
        pairs = []
        host = 0.0
        for _ in range(iters):
            if flush:
                self.scratch.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            t0 = time.perf_counter()
            fn()
            host += time.perf_counter() - t0
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return (sum(a.elapsed_time(b) for a, b in pairs) / iters,
                host / iters * 1e3)

    def into(self, row: dict, prefix: str, fn, **kw) -> None:
        """``row[prefix + "ms"]`` and ``row[prefix + "device_ms"]``."""
        row[prefix + "ms"] = self(fn, **kw)
        row[prefix + "device_ms"] = self.last_device_ms


def bound(flops: float, nbytes: float, dtype: str) -> tuple[float, str]:
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ----------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ----------------------------------------------------------------------

def max_err(torch, got, want, dtype: str, tol: float | None = None
            ) -> float:
    check(bool(torch.isfinite(got).all()), "kernel output not finite")
    g, w = got.float(), want.float()
    tol = TOL[dtype] if tol is None else tol
    bad = (g - w).abs() > tol + tol * w.abs()
    check(not bool(bad.any()),
          f"kernel disagrees with plain version beyond {tol}: max |d| "
          f"{float((g - w).abs().max())}")
    return float((g - w).abs().max())


def flash_q_rows(torch, b: int, s: int, hq: int) -> int:
    """q rows per CTA that the bf16 kernel's shape rule picks: 128 once
    128-row CTAs alone fill every SM, else 64."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return 128 if b * hq * -(-s // 128) >= sms else 64


def flash_case(torch, ops, timer, gen, *, b, s, hq, hkv, d, window,
               dtype, time_it, skv=None, causal=True):
    """q (b, s, hq, d) against k/v (b, skv, hkv, d), skv = s by default;
    ``causal=False`` is the encoder's and the cross-attention's mode."""
    from repro_torch.kernels.flash_attention import flash_attention_plain
    import torch.nn.functional as F
    dt = getattr(torch, dtype)
    skv = s if skv is None else skv
    q = torch.randn((b, s, hq, d), generator=gen, device="cuda").to(dt)
    k, v = (torch.randn((b, skv, hkv, d), generator=gen, device="cuda")
            .to(dt) for _ in range(2))
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    row = {"b": b, "s": s, "hq": hq, "hkv": hkv, "d": d, "window": window,
           "dtype": dtype, "max_abs_err": max_err(torch, got, want, dtype)}
    if skv != s or not causal:
        row.update(skv=skv, causal=causal)
    if dtype == "bfloat16":
        row["q_rows"] = flash_q_rows(torch, b, s, hq)
    if time_it:
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        timer.into(row, "", lambda: ops.flash_attention(q, k, v,
                                                        causal=causal))
        row["host_ms"] = timer.last_host_ms
        timer.into(row, "plain_", lambda: flash_attention_plain(
            q, k, v, causal=causal), iters=5)
        timer.into(row, "library_", lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, enable_gqa=True))
        pairs = s * (s + 1) // 2 if causal else s * skv
        flops = 4.0 * d * hq * b * pairs
        nbytes = sum(x.numel() * x.element_size() for x in (q, k, v, got))
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes, dtype)
    return row


def paged_case(torch, ops, timer, gen, *, b, page, per_seq, hq, hkv, d,
               lengths, permute, dtype, time_it):
    from repro_torch.kernels.paged_attention import paged_attention_plain
    import torch.nn.functional as F
    dt = getattr(torch, dtype)
    n_pages = b * per_seq
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(dt)
    kp, vp = (torch.randn((n_pages, page, hkv, d), generator=gen,
                          device="cuda").to(dt) for _ in range(2))
    ids = torch.arange(n_pages, dtype=torch.int32, device="cuda")
    if permute:
        ids = ids[torch.randperm(n_pages, generator=gen, device="cuda")]
    table = ids.view(b, per_seq).contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    got = ops.paged_attention(q, kp, vp, table, lens)
    want = paged_attention_plain(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    row = {"b": b, "page": page, "per_seq": per_seq, "hq": hq, "hkv": hkv,
           "d": d, "lengths": lengths, "permuted": permute, "dtype": dtype,
           "max_abs_err": max_err(torch, got, want, dtype)}
    if time_it:
        # the library yardstick reads the same cache as dense slots
        kd = kp.view(b, per_seq * page, hkv, d).transpose(1, 2)
        vd = vp.view(b, per_seq * page, hkv, d).transpose(1, 2)
        qd = q[:, :, None, :]
        pos = torch.arange(per_seq * page, device="cuda")
        mask = (pos[None, :] < lens[:, None].long())[:, None, None, :]
        timer.into(row, "", lambda: ops.paged_attention(q, kp, vp, table,
                                                        lens), flush=True)
        row["host_ms"] = timer.last_host_ms
        timer.into(row, "plain_", lambda: paged_attention_plain(
            q, kp, vp, table, lens), iters=5, flush=True)
        timer.into(row, "library_", lambda: F.scaled_dot_product_attention(
            qd, kd, vd, attn_mask=mask, enable_gqa=True), flush=True)
        live = sum(lengths)
        elt = q.element_size()
        flops = 4.0 * d * hq * live
        nbytes = (2 * live * hkv * d * elt + 2 * q.numel() * elt
                  + table.numel() * 4 + lens.numel() * 4)
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes, dtype)
    return row


def ssd_work(b, l, h, p, n, init: bool) -> tuple[float, float]:
    """FLOP and bytes the SSD scan needs on these shapes: C B^T once per
    batch and chunk (B and C are shared by the heads), G x, C S^T and
    x^T B per head, lower triangles only, a ragged last chunk as long as
    it is; every input read once and every output written once.  Its bound
    takes the f32 peak (PEAK_FLOPS["float32"]): the kernel's products are
    IEEE f32 FMAs."""
    flops = 0.0
    for c0 in range(0, l, 128):
        lc = min(128, l - c0)
        tri = lc * (lc + 1) / 2
        flops += b * tri * n * 2
        flops += b * h * (tri * p * 2 + 2 * lc * n * p * 2)
    states = (2 if init else 1) * b * h * p * n
    nbytes = 4.0 * (2 * b * l * h * p + b * l * h + 2 * b * l * n + states)
    return flops, nbytes


def ssd_inputs(torch, gen, b, l, h, p, n, init):
    """Inputs as a Mamba2 layer makes them: dt = softplus(N(0, 1)), the
    log-decay a = -dt * linspace(1, 16, h), x = N(0, 1) * dt, B and C
    N(0, 1), and an initial state N(0, 1) or None."""
    dt = torch.nn.functional.softplus(
        torch.randn((b, l, h), generator=gen, device="cuda"))
    a = -dt * torch.linspace(1.0, 16.0, h, device="cuda")
    x = torch.randn((b, l, h, p), generator=gen, device="cuda") \
        * dt[..., None]
    B, C = (torch.randn((b, l, n), generator=gen, device="cuda")
            for _ in range(2))
    s0 = (torch.randn((b, h, p, n), generator=gen, device="cuda")
          if init else None)
    return x, a, B, C, s0


def ssd_case(torch, ops, timer, gen, *, b, l, h, p, n, init, time_it):
    """``ssd_inputs``; y and the final state against the plain version."""
    from repro_torch.kernels.ssd_scan import ssd_plan, ssd_scan_plain
    x, a, B, C, s0 = ssd_inputs(torch, gen, b, l, h, p, n, init)
    y, final = ops.ssd_scan(x, a, B, C, s0)
    y_want, final_want = ssd_scan_plain(x, a, B, C, s0)
    torch.cuda.synchronize()
    plan = ssd_plan(b, l, h, p, torch.cuda.get_device_properties(
        0).multi_processor_count)
    row = {"b": b, "l": l, "h": h, "p": p, "n": n, "init_state": init,
           "dtype": "float32", "heads_per_cta": plan.heads,
           "p_split": plan.split,
           "max_abs_err": max(max_err(torch, y, y_want, "float32", SSD_TOL),
                              max_err(torch, final, final_want, "float32",
                                      SSD_TOL)),
           "max_abs_err_state": float((final - final_want).abs().max())}
    if time_it:
        timer.into(row, "", lambda: ops.ssd_scan(x, a, B, C, s0))
        row["host_ms"] = timer.last_host_ms
        timer.into(row, "plain_", lambda: ssd_scan_plain(x, a, B, C, s0),
                   iters=5)
        # no single PyTorch call is the scan
        row["library_ms"] = row["library_device_ms"] = None
        flops, nbytes = ssd_work(b, l, h, p, n, init)
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes, "float32")
    return row


def ssd_bwd_work(b, l, h, p, n, init: bool, dfinal: bool,
                 saved: bool = False) -> tuple[float, float]:
    """FLOP and bytes the SSD scan's gradients need on these shapes.  The
    whole function (``saved`` False, from x, a, B, C and dy): C B^T once per
    batch and chunk; per head and chunk the lower triangles of dy x^T, G^T
    dy, ds B and ds^T C, and five (chunk x p x n) products (the chunk's own
    state, which the state before the next chunk needs, loc, dy prev, x dS
    and B dS^T); every input (x, a, B, C, dy and the states) read once and
    every gradient written once.  From the forward's scratch (``saved``, as
    training calls it): neither C B^T nor the chunk's own state, and the
    scratch (states before each chunk, cumulative decays, C B^T) read in
    place of a."""
    flops = 0.0
    for c0 in range(0, l, 128):
        lc = min(128, l - c0)
        tri = lc * (lc + 1) / 2
        flops += 0 if saved else b * tri * n * 2
        flops += b * h * (tri * (2 * p + 2 * n) * 2
                          + (4 if saved else 5) * lc * n * p * 2)
    # dinit written, dfinal read, and without the scratch init read
    states = b * h * p * n * ((1 if init else 0) + (1 if dfinal else 0))
    nbytes = 4.0 * (3 * b * l * h * p + b * l * h + 4 * b * l * n + states)
    if saved:
        chunks = -(-l // 128)
        nbytes += 4.0 * chunks * b * (h * p * n + h * 128 + 36 * 256)
    else:
        nbytes += 4.0 * (b * l * h + (b * h * p * n if init else 0))
    return flops, nbytes


def bwd_kernels_per_call(torch, fn, n: int = 5) -> dict:
    """The CUDA kernels one call of ``fn`` starts, by name: launches and
    device ms a call, from ``torch.profiler``'s trace of ``n`` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out: dict[str, dict] = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and "ssd_" in e.key:
            name = re.search(r"ssd_\w+", e.key).group()
            k = out.setdefault(name, {"launches": 0.0, "device_ms": 0.0})
            k["launches"] += e.count / n
            k["device_ms"] += getattr(e, "self_device_time_total", getattr(
                e, "self_cuda_time_total", 0.0)) / n / 1e3
    return out


def ssd_bwd_case(torch, ops, timer, gen, *, b, l, h, p, n, init, dfinal,
                 time_it):
    """``ssd_inputs`` with dy N(0, 1) and, with ``dfinal``, the final
    state's gradient N(0, 1): the CUDA backward from the CUDA forward's
    scratch (as training calls it) against ``ssd_scan_bwd_plain`` and
    against autograd of ``ssd_scan_plain``, both on the card, each gradient
    to SSD_BWD_TOL of its largest (da to SSD_BWD_DA_TOL); the same backward
    recomputing the scratch must give the same gradients bit for bit, and
    the forward's scratch must hold what the plain version's does (to
    SSD_TOL of each part's largest)."""
    from repro_torch.kernels.ssd_scan import (scratch_views, ssd_bwd_plan,
                                              ssd_scan_bwd_cuda,
                                              ssd_scan_bwd_plain,
                                              ssd_scan_cuda, ssd_scan_plain,
                                              ssd_scratch_plain)
    x, a, B, C, s0 = ssd_inputs(torch, gen, b, l, h, p, n, init)
    dy = torch.randn((b, l, h, p), generator=gen, device="cuda")
    df = (torch.randn((b, h, p, n), generator=gen, device="cuda")
          if dfinal else None)
    _, _, scratch = ssd_scan_cuda(x, a, B, C, s0, keep_scratch=True)
    got = ssd_scan_bwd_cuda(x, a, B, C, s0, dy, df, scratch=scratch)
    again = ssd_scan_bwd_cuda(x, a, B, C, s0, dy, df)
    plain = ssd_scan_bwd_plain(x, a, B, C, s0, dy, df)
    ins = [t.clone().requires_grad_() if t is not None else None
           for t in (x, a, B, C, s0)]
    y, final = ssd_scan_plain(*ins)
    loss = (y * dy).sum() + ((final * df).sum() if dfinal else 0)
    auto = torch.autograd.grad(loss, [t for t in ins if t is not None])
    auto = list(auto) + ([None] if s0 is None else [])
    torch.cuda.synchronize()
    heads = ssd_bwd_plan(b, l, h, torch.cuda.get_device_properties(
        0).multi_processor_count)
    row = {"b": b, "l": l, "h": h, "p": p, "n": n, "init_state": init,
           "dfinal": dfinal, "dtype": "float32", "heads_per_cta": heads,
           "groups": -(-h // heads)}
    for g1, g2 in zip(got, again):
        check((g1 is None and g2 is None) or bool(torch.equal(g1, g2)),
              f"SSD backward at {row}: the forward's scratch and the "
              "recomputed one give other gradients")
    scratch_errs = {}
    for name, part, want in zip(
            ("prev", "cs", "cb"), scratch_views(scratch, b, l, h, p, n),
            scratch_views(ssd_scratch_plain(x, a, B, C, s0), b, l, h, p, n)):
        scale = float(want.abs().max()) or 1.0
        err = float((part - want).abs().max()) / scale
        check(err <= SSD_TOL, f"SSD forward scratch {name} at {row} off by "
              f"{err} of its max from the plain version's")
        scratch_errs[name] = err
    row["scratch_rel_err"] = scratch_errs
    errs = {}
    for name, g, want, want2 in zip(("dx", "da", "dB", "dC", "dinit"), got,
                                    plain, auto):
        if want is None:
            check(g is None, f"SSD backward gave {name} without a state")
            continue
        check(bool(torch.isfinite(g).all()), f"SSD backward {name} not "
              "finite")
        scale = float(want.abs().max()) or 1.0
        tol = SSD_BWD_DA_TOL if name == "da" else SSD_BWD_TOL
        e1 = float((g - want).abs().max())
        e2 = float((g - want2).abs().max())
        check(e1 <= tol * scale and e2 <= tol * scale,
              f"SSD backward {name} at {row}: {e1} from the plain "
              f"backward, {e2} from autograd of the plain forward, max "
              f"{scale}")
        errs[name] = {"max_abs_err": e1, "autograd_err": e2, "max": scale}
    row["errors"] = errs
    row["max_abs_err"] = max(e["max_abs_err"] for e in errs.values())
    if time_it:
        timer.into(row, "", lambda: ssd_scan_bwd_cuda(
            x, a, B, C, s0, dy, df, scratch=scratch))
        row["host_ms"] = timer.last_host_ms
        timer.into(row, "recompute_", lambda: ssd_scan_bwd_cuda(
            x, a, B, C, s0, dy, df))
        timer.into(row, "plain_", lambda: ssd_scan_bwd_plain(
            x, a, B, C, s0, dy, df), iters=3)
        # no single PyTorch call is the scan's backward
        row["library_ms"] = row["library_device_ms"] = None
        row["cuda_kernels_per_call"] = bwd_kernels_per_call(
            torch, lambda: ssd_scan_bwd_cuda(x, a, B, C, s0, dy, df,
                                             scratch=scratch))
        row["cuda_kernels_per_call_recompute"] = bwd_kernels_per_call(
            torch, lambda: ssd_scan_bwd_cuda(x, a, B, C, s0, dy, df))
        # the call's own work (from the scratch) at the f32 FMA rate, the
        # same at the 3xTF32 rate (three TF32 products a product), its
        # bytes, and the whole function's at the FMA rate
        flops, nbytes = ssd_bwd_work(b, l, h, p, n, init, dfinal,
                                     saved=True)
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes, "float32")
        row["bound_fma_ms"] = flops / PEAK_FLOPS["float32"] * 1e3
        row["bound_tf32x3_ms"] = 3 * flops / PEAK_FLOPS["tf32"] * 1e3
        row["bound_bytes_ms"] = nbytes / PEAK_BYTES_PER_S * 1e3
        whole, _ = ssd_bwd_work(b, l, h, p, n, init, dfinal)
        row["bound_fma_whole_ms"] = whole / PEAK_FLOPS["float32"] * 1e3
        row["gflop"] = flops / 1e9
        row["gflop_whole"] = whole / 1e9
    return row


def refuses_grad(torch, ops) -> dict:
    """Flash and paged attention on the card raise when asked to record a
    gradient (they have no backward kernel), and run under no_grad."""
    q = torch.randn((1, 64, 4, 64), device="cuda", requires_grad=True)
    pages = torch.randn((4, 16, 2, 64), device="cuda")
    table = torch.arange(4, dtype=torch.int32, device="cuda").view(1, 4)
    lens = torch.tensor([40], dtype=torch.int32, device="cuda")
    calls = {"flash_attention": lambda: ops.flash_attention(q, q, q),
             "paged_attention": lambda: ops.paged_attention(
                 q[:, 0], pages, pages, table, lens)}
    out = {}
    for name, call in calls.items():
        try:
            call()
            raised = None
        except RuntimeError as e:
            raised = str(e)
        check(raised is not None and "no backward" in raised,
              f"{name} on the card did not refuse a gradient: {raised}")
        with torch.no_grad():
            call()
        out[name] = raised
    torch.cuda.synchronize()
    return out


def phase_kernels(torch, ops, timer) -> dict:
    from repro_torch.kernels.paged_attention import paged_plan
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    flash = []
    # serving path: one prefill of each bucket, qwen3-0.6b heads, bf16
    for s in (64, 128, 256, 512, 1024):
        flash.append(flash_case(torch, ops, timer, gen, b=1, s=s, hq=16,
                                hkv=8, d=128, window=0, dtype="bfloat16",
                                time_it=True))
        flash[-1]["model"] = "qwen3-0.6b"
    flash[-1]["main"] = True        # the largest bucket stands for flash
    for kw in (dict(b=1, s=200, hq=16, hkv=8, d=128, window=0),   # ragged
               dict(b=2, s=256, hq=16, hkv=8, d=128, window=32),  # window
               dict(b=2, s=192, hq=8, hkv=2, d=64, window=0),     # G = 4
               dict(b=1, s=130, hq=4, hkv=4, d=120, window=0),    # D = 120
               # S not a multiple of either q block, windows that cross
               # the 128-key KV blocks, D = 120 with a window
               dict(b=1, s=333, hq=8, hkv=4, d=128, window=100),
               dict(b=2, s=203, hq=4, hkv=2, d=120, window=70),
               # enough heads for 128-row CTAs: at D = 64 (one box), and
               # at D = 120 with a window crossing the KV blocks
               dict(b=4, s=500, hq=16, hkv=4, d=64, window=0),
               dict(b=4, s=333, hq=16, hkv=4, d=120, window=100)):
        for dtype in ("bfloat16", "float32"):
            flash.append(flash_case(torch, ops, timer, gen, dtype=dtype,
                                    time_it=False, **kw))
    # bf16 at every head dim the tensor-core kernel pads or splits: one
    # 64-wide box (64), two with zero-filled columns (112, 120), two (128)
    for d in (64, 112, 120, 128):
        flash.append(flash_case(torch, ops, timer, gen, b=1, s=257, hq=8,
                                hkv=2, d=d, window=0, dtype="bfloat16",
                                time_it=False))
    paged = []
    rng = random.Random(0)
    # serving path: 8 slots x 2048 positions in pages of 16, qwen3 heads,
    # identity table as the engine uses, lengths as mid-run slots hold
    serve_lens = sorted(rng.randrange(64, 1153) for _ in range(8))
    paged.append(paged_case(torch, ops, timer, gen, b=8, page=16,
                            per_seq=128, hq=16, hkv=8, d=128,
                            lengths=serve_lens, permute=False,
                            dtype="bfloat16", time_it=True))
    paged[-1]["main"] = True
    paged[-1]["model"] = "qwen3-0.6b"
    # zamba2-7b's shared attention block: MHA (G = 1), D = 112, bf16, at
    # every prefill bucket and at the serve case's decode cache
    hq = hkv = 32
    d = 112
    for s in (64, 128, 256, 512, 1024):
        flash.append(flash_case(torch, ops, timer, gen, b=1, s=s, hq=hq,
                                hkv=hkv, d=d, window=0, dtype="bfloat16",
                                time_it=True))
        flash[-1]["model"] = "zamba2-7b"
    zamba_lens = sorted(rng.randrange(64, 1089) for _ in range(8))
    paged.append(paged_case(torch, ops, timer, gen, b=8, page=16,
                            per_seq=128, hq=hq, hkv=hkv, d=d,
                            lengths=zamba_lens, permute=False,
                            dtype="bfloat16", time_it=True))
    paged[-1]["model"] = "zamba2-7b"
    edge = [2048, 0, 1, 17, 333, 1024, 2047, 16]   # length 0, page + 1
    split = paged_plan(8, 2, 16, 128, 128, 16).split
    # exactly one split, one split + 1 (a second split of one token), two
    # splits + 1, the full capacity (every split), 1 and 0
    split_lens = [split, split + 1, 2 * split + 1, 2048, 1, 0]
    for dtype in ("bfloat16", "float32"):
        paged.append(paged_case(torch, ops, timer, gen, b=6, page=16,
                                per_seq=128, hq=32, hkv=2, d=128,
                                lengths=split_lens, permute=True,
                                dtype=dtype, time_it=False))   # G = 16
        paged.append(paged_case(torch, ops, timer, gen, b=8, page=16,
                                per_seq=128, hq=16, hkv=8, d=128,
                                lengths=edge, permute=True, dtype=dtype,
                                time_it=False))
        paged.append(paged_case(torch, ops, timer, gen, b=3, page=32,
                                per_seq=4, hq=8, hkv=2, d=64,
                                lengths=[128, 3, 33], permute=True,
                                dtype=dtype, time_it=False))
    # bidirectional (causal=False) at the encoder's and the cross-
    # attention's shapes: seamless-m4t-large-v2's MHA 16 heads of D = 64
    # over 200 source frames (encoder Sq = Skv; cross-attention at a 64-
    # token prefill and at a decode step), and Sq = 333 over Skv = 1000 at
    # GQA 16/4, D = 128, where both q-block variants run
    for s, skv in ((200, 200), (64, 200), (1, 200)):
        for dtype in ("bfloat16", "float32"):
            flash.append(flash_case(torch, ops, timer, gen, b=1, s=s,
                                    skv=skv, hq=16, hkv=16, d=64, window=0,
                                    causal=False, dtype=dtype,
                                    time_it=False))
    for b in (1, 4):
        for dtype in ("bfloat16", "float32"):
            flash.append(flash_case(torch, ops, timer, gen, b=b, s=333,
                                    skv=1000, hq=16, hkv=4, d=128, window=0,
                                    causal=False, dtype=dtype,
                                    time_it=False))
    check({r["q_rows"] for r in flash if r.get("causal") is False
           and "q_rows" in r} == {64, 128},
          "flash causal=False cases miss a q-block variant")
    # the seamless decode step's cross-attention, timed against SDPA
    flash.append(flash_case(torch, ops, timer, gen, b=1, s=1, skv=200,
                            hq=16, hkv=16, d=64, window=0, causal=False,
                            dtype="bfloat16", time_it=True))
    flash[-1]["model"] = "seamless-m4t-large-v2"
    # every variant of the bf16 kernel ran: one or two 64-column boxes of
    # D, 64- or 128-row CTAs, each picked by the shape rule
    variants = {(r["d"] > 64, r["q_rows"]) for r in flash if "q_rows" in r}
    check(variants == {(x, y) for x in (False, True) for y in (64, 128)},
          f"flash bf16 cases cover only the variants {sorted(variants)}")
    ssd = []
    # zamba2-7b's Mamba2 layers: b = 1, 112 heads, p = n = 64, f32, one
    # scan per prefill bucket with a state, as the engine calls it; the
    # largest bucket stands for the kernel
    for l in SSD_BUCKETS:
        ssd.append(ssd_case(torch, ops, timer, gen, b=1, l=l, h=112, p=64,
                            n=64, init=True, time_it=True))
        ssd[-1]["model"] = "zamba2-7b"
    ssd[-1]["main"] = True
    for kw in (dict(b=1, l=2048, h=112, p=64, n=64, init=True),  # max_seq
               dict(b=1, l=200, h=112, p=64, n=64, init=True),   # ragged
               dict(b=2, l=256, h=3, p=32, n=16, init=True),     # small
               dict(b=1, l=384, h=112, p=64, n=64, init=False)):
        ssd.append(ssd_case(torch, ops, timer, gen, time_it=False, **kw))
    # every plan the shape rule picks ran: 1, 2 and 4 heads per CTA, p
    # whole and in halves
    heads = {r["heads_per_cta"] for r in ssd}
    splits = {r["p_split"] for r in ssd}
    check(heads == {1, 2, 4} and splits == {1, 2},
          f"SSD cases cover only heads per CTA {sorted(heads)} and p "
          f"splits {sorted(splits)}")
    # llama3.2-3b in the quickstart's engine: its prompts' 64-token bucket
    # (G = 3), and decode over its 4 slots' 128-position ring in pages of 16
    flash.append(flash_case(torch, ops, timer, gen, b=1, s=64, hq=24, hkv=8,
                            d=128, window=0, dtype="bfloat16", time_it=True))
    flash[-1]["model"] = "llama3.2-3b"
    llama_lens = sorted(rng.randrange(9, 43) for _ in range(4))
    paged.append(paged_case(torch, ops, timer, gen, b=4, page=16, per_seq=8,
                            hq=24, hkv=8, d=128, lengths=llama_lens,
                            permute=False, dtype="bfloat16", time_it=True))
    paged[-1]["model"] = "llama3.2-3b"
    # the examples' reduced llama3.2-3b and qwen3-0.6b (4/2 heads of 32,
    # f32: the SIMT kernels): a prompt's 64-token bucket, and decode over 4
    # slots' 128-position ring in pages of 16, full where the ring wraps
    flash.append(flash_case(torch, ops, timer, gen, b=1, s=64, hq=4, hkv=2,
                            d=32, window=0, dtype="float32", time_it=False))
    paged.append(paged_case(torch, ops, timer, gen, b=4, page=16, per_seq=8,
                            hq=4, hkv=2, d=32, lengths=[9, 40, 100, 128],
                            permute=False, dtype="float32", time_it=False))
    # the SSD backward at zamba2-7b's shape: at the train case's 256 steps
    # (phase_train), then at the largest bucket with an initial state and
    # the final state's gradient, then without either, as training calls
    # it (the main row); ragged; small heads and dims
    bwd = [ssd_bwd_case(torch, ops, timer, gen, b=1, l=256, h=112, p=64,
                        n=64, init=False, dfinal=False, time_it=True)]
    bwd[-1]["model"] = "zamba2-7b"
    bwd[-1]["train_case_shape"] = True
    for init in (True, False):
        bwd.append(ssd_bwd_case(torch, ops, timer, gen, b=1, l=1024, h=112,
                                p=64, n=64, init=init, dfinal=init,
                                time_it=True))
        bwd[-1]["model"] = "zamba2-7b"
    bwd[-1]["main"] = True
    for kw in (dict(b=1, l=200, h=112, p=64, n=64, init=False, dfinal=True),
               dict(b=2, l=256, h=3, p=32, n=16, init=True, dfinal=False),
               dict(b=1, l=100, h=4, p=8, n=4, init=True, dfinal=True)):
        bwd.append(ssd_bwd_case(torch, ops, timer, gen, time_it=False, **kw))
    return {"flash_attention": flash, "paged_attention": paged,
            "ssd_scan": ssd, "ssd_scan_bwd": bwd,
            "refuse_grad": refuses_grad(torch, ops)}


# ----------------------------------------------------------------------
# phase 3: the model path, kernels on the card against plain on the CPU
# ----------------------------------------------------------------------

def kernel_launches(cfg, prefills: int, steps: int) -> dict[str, int]:
    """Launches one model's serving path must make: flash per attention
    layer (or shared-block application) and prefill, paged per attention
    layer and decode step, the SSD scan per Mamba2 layer and prefill.  An
    encoder-decoder's prefill also runs flash in every encoder layer and in
    every decoder layer's cross-attention, which runs it at every decode
    step too; xLSTM runs no kernel."""
    if cfg.family == "ssm":
        return dict.fromkeys(REPLACES, 0)
    if cfg.family == "hybrid":
        attn, mamba = cfg.n_layers // cfg.attn_every, cfg.n_layers
    else:
        attn, mamba = cfg.n_layers, 0
    flash = attn * prefills
    if cfg.family == "encdec":
        flash += (cfg.enc_layers + cfg.n_layers) * prefills \
            + cfg.n_layers * steps
    return {"flash_attention": flash, "paged_attention": attn * steps,
            "ssd_scan": mamba * prefills, "ssd_scan_bwd": 0}


def path_case(torch, ops, arch: str, n_layers: int, enc_layers: int = 0,
              frontend: int = 0) -> dict:
    """The same seeded f32 weights on the CPU (plain versions) and on the
    card (kernels): a 200-token prompt in the 256 bucket (after ``frontend``
    seeded N(0, 1) patch embeddings for a VLM, or over that many seeded
    frames for an encoder-decoder), then 8 teacher-forced decode steps;
    logits must agree to 1e-3.  ``n_layers`` (and ``enc_layers``) cut the
    depth; the width is the registry's."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model
    from repro_torch.models.model import Model
    cut = {"n_layers": n_layers}
    if enc_layers:
        cut["enc_layers"] = enc_layers
    cfg = dataclasses.replace(ARCHS[arch], **cut, dtype="float32",
                              name=f"{arch}-{n_layers}l-f32")
    cpu = build_model(cfg, device="cpu", seed=1)
    # the card's copy of the CPU weights (drawn once)
    net = type(cpu.decoder)(cfg, torch.device("cuda"))
    net.load_state_dict(cpu.decoder.state_dict())
    models = {"cpu": cpu, "cuda": Model(cfg, net, torch.device("cuda"))}
    rng = random.Random(1)
    prompt = [rng.randrange(cfg.vocab) for _ in range(200)]
    toks = torch.zeros((1, 256), dtype=torch.int32)
    toks[0, -200:] = torch.tensor(prompt, dtype=torch.int32)
    forced = [[rng.randrange(cfg.vocab)] for _ in range(8)]
    front = (torch.randn((1, frontend, cfg.d_model),
                         generator=torch.Generator().manual_seed(2))
             if frontend else None)
    ops.reset_launch_counts()
    logits = {}
    for name, m in models.items():
        cache = m.init_cache(1, 2048, src_len=frontend)
        out, cache = m.prefill(toks.to(m.device), cache, frontend=None
                               if front is None else front.to(m.device))
        steps = [out.float().cpu()]
        for t in forced:
            out, cache = m.decode_step(
                torch.tensor([t], dtype=torch.int32, device=m.device), cache)
            steps.append(out.float().cpu())
        logits[name] = torch.stack(steps)
    counts = ops.launch_counts()
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    check(bool(torch.isfinite(logits["cuda"]).all()), f"{arch} path "
          "logits not finite")
    check(err <= 1e-3, f"{arch} path logits differ from the CPU by {err} "
          "> 1e-3")
    want = kernel_launches(cfg, prefills=1, steps=len(forced))
    check(counts == want, f"{arch} path launches {counts}, want {want}")
    row = {"model": arch, "family": cfg.family, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype, "prompt": 200,
           "bucket": 256, "decode_steps": len(forced),
           "max_abs_logit_err": err, "launches": counts}
    if enc_layers:
        row["enc_layers"] = enc_layers
    if frontend:
        row["frontend"] = frontend
    if cfg.is_moe:
        row["capacity_factor"] = cfg.capacity_factor
    del cpu, net, models
    torch.cuda.empty_cache()
    return row


def graph_case(torch, ops, arch: str, n_layers: int, steps: int = 16
               ) -> dict:
    """Full width, bf16, seeded weights, ``n_layers`` layers, 8 slots
    prefilled through an engine; from copies of that cache, ``steps`` + 1
    greedy decode steps of ``serving.engine.decode_body`` run eagerly, and
    the same steps with the first one captured (``capture_step``) and the
    rest replayed from the graph.  Logits equal bit for bit (else the
    largest gap, with the tokens still equal), the same launches counted,
    and each way's host time a step (each step waited for)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model
    from repro_torch.serving import (EngineConfig, InferenceEngine,
                                     ServeRequest)
    from repro_torch.serving.engine import capture_step, decode_body
    cfg = dataclasses.replace(ARCHS[arch], n_layers=n_layers)
    model = build_model(cfg, device="cuda", seed=3)
    eng = InferenceEngine(model, EngineConfig(
        max_slots=8, max_seq=2048, page_size=16, n_pages=1024,
        telemetry=False))
    rng = random.Random(3)
    for i, n in enumerate([50, 64, 120, 200, 256, 333, 512, 1000]):
        eng.submit(ServeRequest(i, 0.0, [rng.randrange(cfg.vocab)
                                         for _ in range(n)], steps + 1))
    eng._admit_loop()
    first = [eng._slot_next_token[s] for s in range(8)]
    runs = {}
    for way in ("eager", "graph"):
        cache = {k: v.clone() if isinstance(v, torch.Tensor) else v
                 for k, v in eng.slot_cache.items()}
        tokens = torch.tensor(first, dtype=torch.int32,
                              device="cuda")[:, None]
        nxt = torch.zeros(8, dtype=torch.int64, device="cuda")
        ptrs = {k: v.data_ptr() for k, v in cache.items()
                if isinstance(v, torch.Tensor)}

        def body():
            return decode_body(model, tokens, cache, nxt)
        ops.reset_launch_counts()
        logits, toks, secs = [], [], []
        graph = None
        for i in range(steps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if way == "eager":
                out = body()
            elif graph is None:
                out, graph = capture_step(body, model.device)
                check(graph is not None, f"{arch}: the step was not "
                      "captured (it waited for the device)")
            else:
                out = graph.replay()
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            logits.append(out.float().clone())
            toks.append(nxt.clone())
            tokens.copy_(nxt[:, None])
        check(ptrs == {k: v.data_ptr() for k, v in cache.items()
                       if isinstance(v, torch.Tensor)},
              f"{arch}: a cache tensor moved in the {way} steps")
        runs[way] = {"logits": torch.stack(logits), "tokens":
                     torch.stack(toks), "launches": ops.launch_counts(),
                     "ms_per_step": sorted(secs[1:])[steps // 2] * 1e3}
    a, b = runs["eager"], runs["graph"]
    equal = torch.equal(a["logits"], b["logits"])
    gap = float((a["logits"] - b["logits"]).abs().max())
    check(bool(torch.isfinite(b["logits"]).all()), f"{arch}: replayed "
          "logits not finite")
    check(equal or torch.equal(a["tokens"], b["tokens"]), f"{arch}: "
          f"replayed steps differ from eager ones (max |d| {gap}) and "
          "so do their tokens")
    check(a["launches"] == b["launches"], f"{arch}: launches "
          f"{b['launches']} replayed, {a['launches']} eager")
    want = kernel_launches(cfg, 0, steps + 1)
    check(a["launches"] == want, f"{arch}: launches {a['launches']}, "
          f"want {want}")
    del eng, model, runs
    gc.collect()
    torch.cuda.empty_cache()
    return {"model": arch, "layers": n_layers, "dtype": cfg.dtype,
            "slots": 8, "steps": steps + 1, "bit_equal": equal,
            "max_abs_gap": gap, "tokens_equal": torch.equal(a["tokens"],
                                                            b["tokens"]),
            "launches": a["launches"],
            "eager_ms_per_step": a["ms_per_step"],
            "replayed_ms_per_step": b["ms_per_step"]}


def prefill_graph_case(torch, config: str, seed: int = 2147483901
                       ) -> dict:
    """One benchmark configuration (``bench/configs/<config>.json``) at
    full size, its weights drawn as the benchmark draws them, behind the
    engine its cells build (the one with the longest ``max_seq``), at each
    prefill bucket its cells use: a prompt that fills the bucket prefilled
    eagerly four times, then captured and replayed four times.  Each
    replay's first token and the slot's cache row equal the eager ones bit
    for bit.  Per bucket: the CUDA kernels, copies and sets one eager
    prefill and one replay put on the device (``torch.profiler``), and
    each way's median host time of ``prefill.enqueue`` and of the whole
    prefill, which ends waiting for its first token; and the memory that
    the engine's pool of prefill graphs holds."""
    from bench.cell import build, buckets, load
    from repro_torch.models.model import CACHE_BATCH_AXIS
    from repro_torch.obs import HOST_SPANS
    from repro_torch.serving import ServeRequest
    from torch.profiler import ProfilerActivity, profile
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = [load(w["name"]) for w in spec["workloads"]
             if w["config"] == config]
    mix = max((c.mix for c in cells), key=lambda m: m["max_seq"])
    device = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    model, eng = build(cells[0].config, mix, seed, device)
    sizes = sorted({b for c in cells for b in buckets(
        c.mix, eng.sched.cfg.prefill_buckets)})
    capture = eng._capture_prefill
    rng = random.Random(seed)

    def prefill(rid: int, prompt: list) -> tuple[float, float]:
        torch.cuda.synchronize()
        t0 = time.perf_counter_ns()
        eng._prefill(0, ServeRequest(rid, 0.0, prompt, 4))
        t1 = time.perf_counter_ns()
        enq = [s for s in HOST_SPANS.within(t0, t1)
               if s.name == "prefill.enqueue"]
        return (enq[0].end - enq[0].start) * 1e-6, (t1 - t0) * 1e-6

    def row() -> dict:
        return {k: eng.slot_cache[k].select(a, 0).clone()
                for k, a in CACHE_BATCH_AXIS.items() if k in eng.slot_cache}

    def device_ops(rid: int, prompt: list) -> int:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            prefill(rid, prompt)
        return sum(e.count for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA"))

    rows = []
    for bucket in sizes:
        prompt = [rng.randrange(model.cfg.vocab) for _ in range(bucket)]
        eng._capture_prefill = None
        eager = [prefill(i, prompt) for i in range(4)]
        want_tok, want_row = eng._slot_next_token[0], row()
        eager_ops = device_ops(4, prompt)
        eng._capture_prefill = capture
        prefill(5, prompt)                         # the capture
        captured = eng._prefills.get(bucket) is not None
        replayed, equal = [], True
        for i in range(4):
            replayed.append(prefill(6 + i, prompt))
            got = row()
            equal &= eng._slot_next_token[0] == want_tok and all(
                torch.equal(got[k], want_row[k]) for k in got)
        replay_ops = device_ops(10, prompt)

        def median(runs, i):
            return sorted(r[i] for r in runs)[len(runs) // 2]
        rows.append({"bucket": bucket, "captured": captured,
                     "bit_equal": equal,
                     "eager_device_ops": eager_ops,
                     "replay_device_ops": replay_ops,
                     "eager_enqueue_ms": median(eager[1:], 0),
                     "replay_enqueue_ms": median(replayed, 0),
                     "eager_prefill_ms": median(eager[1:], 1),
                     "replay_prefill_ms": median(replayed, 1)})
    peak = torch.cuda.max_memory_allocated() / 1e9
    # what the engine's prefill graphs hold: the segments of their pool
    pool = tuple(capture.keywords["pool"])
    pool_gb = sum(seg["total_size"] for seg in
                  torch.cuda.memory._snapshot()["segments"]
                  if tuple(seg.get("segment_pool_id", ())) == pool) / 1e9
    eng.slot_cache = None
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    return {"config": config, "cells": [c.name for c in cells],
            "max_seq": mix["max_seq"], "buckets": rows, "peak_gb": peak,
            "prefill_pool_gb": pool_gb}


def phase_prefills(torch) -> dict:
    configs = json.loads((ROOT / "BENCHMARK.json").read_text())["configs"]
    cases = []
    for c in configs:
        cases.append(prefill_graph_case(torch, c["name"]))
        emit({"prefill_case": cases[-1]})     # before the checks
    for case in cases:
        for row in case["buckets"]:
            check(row["captured"], f"{case['config']}: bucket "
                  f"{row['bucket']} was not captured (its prefill waited)")
            check(row["bit_equal"], f"{case['config']}: a replayed prefill "
                  f"of bucket {row['bucket']} differs from the eager one")
    return {"cases": cases}


def phase_path(torch, ops) -> dict:
    cases = [path_case(torch, ops, "qwen3-0.6b", 2),
             # one super-block (6 Mamba2 layers + the shared block) and a
             # one-layer tail
             path_case(torch, ops, "zamba2-7b", 7),
             # the registry's capacity factor 1.25: at the 256 bucket an
             # expert takes 21 pairs (qwen2) and the 56 left-pad tokens
             # overflow theirs, so drops bind
             path_case(torch, ops, "qwen2-moe-a2.7b", 2),
             path_case(torch, ops, "granite-moe-3b-a800m", 2),
             path_case(torch, ops, "xlstm-125m", 2),           # one pair
             path_case(torch, ops, "llava-next-mistral-7b", 2,
                       frontend=576),
             path_case(torch, ops, "seamless-m4t-large-v2", 2,
                       enc_layers=2, frontend=200)]
    # one CUDA graph a decode step against the same steps run eagerly, at
    # the benchmark's two configurations (bf16) cut to the depths above
    graphs = [graph_case(torch, ops, "zamba2-7b", 7),
              graph_case(torch, ops, "qwen2-moe-a2.7b", 2)]
    return {"cases": cases, "graphs": graphs}


# ----------------------------------------------------------------------
# phase 4: training, the card against the CPU, then full-size qwen3-0.6b
# ----------------------------------------------------------------------

TRAIN_FULL = ["--arch", "qwen3-0.6b", "--full-config", "--steps", "12",
              "--batch", "8", "--seq", "512", "--micro", "2", "--seed", "0"]
TRAIN_CRASH_AT = 6


def train_launches(cfg) -> dict[str, int]:
    """Launches one loss and gradient of ``cfg`` make: training attends
    through sdpa (no flash, as the JAX package trains), every Mamba2 layer
    scans forward once, and once more where ``remat`` recomputes it in the
    backward, and runs the SSD backward once."""
    mamba = cfg.n_layers if cfg.family == "hybrid" else 0
    return {**dict.fromkeys(REPLACES, 0),
            "ssd_scan": mamba * (2 if cfg.remat else 1),
            "ssd_scan_bwd": mamba}


class plain_ssd_on_card:
    """Within it, ``ops.ssd_scan`` runs the SSD scan's plain versions on CUDA
    tensors (forward and backward), so a comparison on the card isolates
    what the kernels change."""

    def __init__(self, ops) -> None:
        self.ops = ops

    def __enter__(self):
        from repro_torch.kernels import ssd_scan
        self.saved = (self.ops.ssd_scan_cuda, self.ops.ssd_scan_bwd_cuda)
        self.ops.ssd_scan_cuda = ssd_scan.ssd_scan_plain
        self.ops.ssd_scan_bwd_cuda = ssd_scan.ssd_scan_bwd_plain

    def __exit__(self, *exc) -> None:
        self.ops.ssd_scan_cuda, self.ops.ssd_scan_bwd_cuda = self.saved


def rel_errs(torch, got: dict, want: dict, norm: bool = False
             ) -> tuple[float, str]:
    """The worst gradient's max |got - want| over its largest |want|, or,
    with ``norm``, ||got - want|| over ||want||."""
    worst = (0.0, "")
    for k, w in want.items():
        g = got[k].float().cpu()
        check(bool(torch.isfinite(g).all()), f"gradient of {k} not finite")
        w = w.float().cpu()
        if norm:
            err = float((g - w).norm()) / (float(w.norm()) or 1.0)
        else:
            err = float((g - w).abs().max()) / (float(w.abs().max()) or 1.0)
        worst = max(worst, (err, k))
    return worst


def train_case(torch, ops, arch: str, n_layers: int, b: int = 1,
               s: int = 256, enc_layers: int = 0, frontend: int = 0) -> dict:
    """The same seeded f32 weights on the CPU (plain versions) and on the
    card (kernels), the registry's width and activation checkpointing, one
    batch of b x s seeded tokens (and, for an encoder-decoder, ``frontend``
    seeded N(0, 1) frames over ``enc_layers`` encoder layers): the loss and
    every parameter's gradient must agree to TRAIN_TOL of the CPU's (each
    gradient to that fraction of its largest magnitude), with the card's
    exact kernel launches (no flash: training attends through sdpa).  The
    hybrid's gradients are held to the plain versions' on the card at
    TRAIN_TOL, and to the CPU's only within HYBRID_TRAIN_TOL (normwise)."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model
    from repro_torch.models.model import Model
    cut = {"n_layers": n_layers}
    if enc_layers:
        cut["enc_layers"] = enc_layers
    cfg = dataclasses.replace(ARCHS[arch], **cut, dtype="float32",
                              name=f"{arch}-{n_layers}l-f32")
    cpu = build_model(cfg, device="cpu", seed=1)
    net = type(cpu.decoder)(cfg, torch.device("cuda"))
    net.load_state_dict(cpu.decoder.state_dict())
    models = {"cpu": cpu, "cuda": Model(cfg, net, torch.device("cuda"))}
    rng = random.Random(3)
    toks = torch.tensor([[rng.randrange(cfg.vocab) for _ in range(s)]
                         for _ in range(b)], dtype=torch.int32)
    labels = torch.cat([toks[:, 1:], torch.full((b, 1), -1,
                                                dtype=torch.int32)], 1)
    batch = {"tokens": toks, "labels": labels}
    if frontend:
        batch["frontend"] = torch.randn(
            (b, frontend, cfg.d_model),
            generator=torch.Generator().manual_seed(2))

    def loss_and_grads(m):
        params = dict(m.decoder.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        loss = m.loss(batch)
        grads = torch.autograd.grad(loss, list(params.values()))
        return float(loss.detach()), dict(zip(params, grads))

    cpu_loss, cpu_g = loss_and_grads(cpu)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    card_loss, card_g = loss_and_grads(models["cuda"])
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    card_s = time.perf_counter() - t0
    check(math.isfinite(card_loss), f"{arch} train loss not finite")
    loss_err = abs(card_loss - cpu_loss)
    check(loss_err <= TRAIN_TOL * max(1.0, abs(cpu_loss)),
          f"{arch} train loss {card_loss} on the card, {cpu_loss} on the "
          "CPU")
    hybrid = cfg.family == "hybrid"
    worst = rel_errs(torch, card_g, cpu_g)
    if hybrid:
        normwise = rel_errs(torch, card_g, cpu_g, norm=True)
        check(normwise[0] <= HYBRID_TRAIN_TOL, f"{arch}: gradient of "
              f"{normwise[1]} off by {normwise[0]} (normwise) on the card")
    else:
        check(worst[0] <= TRAIN_TOL, f"{arch}: gradient of {worst[1]} off "
              f"by {worst[0]} of its max on the card")
    want = train_launches(cfg)
    check(counts == want, f"{arch} train launches {counts}, want {want}")
    row = {"model": arch, "family": cfg.family, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "dtype": cfg.dtype, "remat": cfg.remat,
           "batch": b, "seq": s, "loss_cpu": cpu_loss, "loss_card": card_loss,
           "loss_err": loss_err, "worst_grad_rel_err": worst[0],
           "worst_grad": worst[1], "params": len(cpu_g),
           "card_s": card_s, "launches": counts}
    if enc_layers:
        row.update(enc_layers=enc_layers, frontend=frontend)
    if hybrid:
        with plain_ssd_on_card(ops):
            plain_loss, plain_g = loss_and_grads(models["cuda"])
        kern = rel_errs(torch, card_g, plain_g)
        plain = rel_errs(torch, plain_g, cpu_g)
        row.update(normwise_vs_cpu=normwise[0],
                   normwise_worst=normwise[1])
        check(kern[0] <= TRAIN_TOL and abs(card_loss - plain_loss)
              <= TRAIN_TOL * max(1.0, abs(plain_loss)),
              f"{arch}: with the kernels the gradient of {kern[1]} is off "
              f"by {kern[0]} of its max from the plain versions on the card")
        row.update(kernels_vs_plain_on_card=kern[0],
                   kernels_vs_plain_worst=kern[1],
                   plain_on_card_vs_cpu=plain[0],
                   plain_on_card_vs_cpu_worst=plain[1])
        del plain_g
    del cpu, net, models, cpu_g, card_g
    gc.collect()
    torch.cuda.empty_cache()
    return row


def moe_bf16_grads(torch) -> dict:
    """The routed experts' backward through ``F.grouped_mm`` on the card in
    bf16 (CUTLASS's grouped GEMM) against f32 (the per-group fallback) on
    the same bf16-rounded weights and input: qwen2-moe-a2.7b's widths, 512
    tokens.  Both route alike (the router is f32 on the same values);
    gradients of x and of the expert weights to 3e-2 of their largest."""
    from repro_torch.configs import ARCHS
    from repro_torch.models.moe import MoE, moe_fwd
    cfg = ARCHS["qwen2-moe-a2.7b"]
    gen = torch.Generator().manual_seed(4)
    grads = {}
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dtype)
        moe = MoE(c, torch.device("cuda"))
        gen.manual_seed(4)
        with torch.no_grad():
            for p in moe.parameters():
                w = torch.randn(p.shape, generator=gen) / math.sqrt(
                    p.shape[-2])
                p.copy_(w.to(torch.bfloat16).float())
        x = (torch.randn((2, 256, cfg.d_model), generator=gen)
             .to(torch.bfloat16).to(getattr(torch, dtype)).cuda()
             .requires_grad_())
        wts = torch.randn((2, 256, cfg.d_model), generator=gen).cuda()
        ps = [x, moe.w_gate, moe.w_up, moe.w_down]
        for p in ps[1:]:
            p.requires_grad_(True)
        out, aux = moe_fwd(moe, c, x)
        loss = (out.float() * wts).sum() + aux
        grads[dtype] = [g.float() for g in torch.autograd.grad(loss, ps)]
    errs = {}
    for name, g, want in zip(("x", "w_gate", "w_up", "w_down"),
                             grads["bfloat16"], grads["float32"]):
        rel = float((g - want).abs().max()) / float(want.abs().max())
        check(rel <= 3e-2, f"MoE bf16 gradient of {name} off by {rel} of "
              "its max from f32")
        errs[name] = rel
    return {"model": cfg.name, "tokens": 512, "rel_err_bf16_vs_f32": errs}


def train_full(torch, ops) -> dict:
    """Full-size qwen3-0.6b, bf16, activation checkpointing, through
    ``repro_torch.launch.train``'s own set-up (``setup``: seeded weights,
    ``pack_documents`` behind the ``Prefetcher``, the ``Trainer``): 12
    steps of batch 8 x 512 tokens in 2 microbatches, with a checkpoint at
    step 6 (and one kept); a crash injected at step 6, a new trainer that
    restores step 6 exactly and finishes the run.  Then three steps on one
    batch at lr 1e-3 (the loss must fall: the reference's memorisation
    check) and the profile of two steps."""
    import shutil
    from repro_torch.data import DataConfig, SyntheticCorpus, pack_documents
    from repro_torch.launch import train as launch
    from repro_torch.training import AdamWConfig
    ckdir = ROOT / "build" / "train_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    args = launch.parse_args(TRAIN_FULL + ["--ckpt", str(ckdir)])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()

    def start():
        trainer, data = launch.setup(args)
        trainer.tcfg = dataclasses.replace(trainer.tcfg, ckpt_every=6,
                                           ckpt_keep=1)
        return trainer, data

    first, data = start()
    setup_s = time.perf_counter() - t0
    try:
        first.run(data, crash_at=TRAIN_CRASH_AT)
        raise AssertionError("the injected crash did not happen")
    except RuntimeError as e:
        check("injected failure" in str(e), f"train crashed: {e}")
    check(first.step == TRAIN_CRASH_AT, f"crashed at step {first.step}")
    trainer, data = start()
    t1 = time.perf_counter()
    check(trainer.maybe_restore() and trainer.step == TRAIN_CRASH_AT,
          f"restore gave step {trainer.step}")
    restore_s = time.perf_counter() - t1
    check(all(torch.equal(trainer.params[k], p)
              for k, p in first.params.items()),
          "restored weights differ from the crashed run's")
    check(all(torch.equal(trainer.opt_state[s_][k], first.opt_state[s_][k])
              for s_ in ("m", "v") for k in first.params),
          "restored moments differ from the crashed run's")
    hist = trainer.run(data)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    run_s = time.perf_counter() - t0
    check(trainer.step == args.steps, f"trained to step {trainer.step}")
    runs = first.history + hist
    check(all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
              for h in runs), "full-size train: loss not finite")
    cfg = trainer.model.cfg
    want = train_launches(cfg)
    check(counts == want, f"full-size train launches {counts}, want {want}")
    # the warm steps of each trainer (each one's first step is its warm-up)
    secs = sorted(h["sec"] for h in first.history[1:] + hist[1:])
    step_s = secs[len(secs) // 2]
    n_params = sum(p.numel() for p in trainer.params.values())
    tokens = args.batch * args.seq
    del first
    gc.collect()
    # memorisation: three steps on one batch at lr 1e-3
    trainer.tcfg = dataclasses.replace(
        trainer.tcfg, optimizer=AdamWConfig(lr=1e-3, warmup_steps=1))
    batch = trainer._microbatch(next(pack_documents(SyntheticCorpus(
        DataConfig(vocab=cfg.vocab, seq_len=args.seq, batch=args.batch,
                   seed=5)), 1)))
    memo = [float(trainer._train_step(batch)[0]) for _ in range(3)]
    check(all(math.isfinite(x) for x in memo) and memo[-1] < memo[0],
          f"full-size train: the loss on one batch did not fall: {memo}")
    profile = profile_calls(torch, lambda: trainer._train_step(batch), 2)
    peak = torch.cuda.max_memory_allocated() / 2**30
    disk = shutil.disk_usage(ROOT)
    shutil.rmtree(ckdir, ignore_errors=True)
    out = {"model": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
           "remat": cfg.remat, "params": n_params, "argv": TRAIN_FULL,
           "ckpt_every": 6, "crash_at": TRAIN_CRASH_AT,
           "losses": [h["loss"] for h in runs],
           "grad_norms": [h["grad_norm"] for h in runs],
           "lrs": [h["lr"] for h in runs],
           "step_secs": [h["sec"] for h in runs],
           "memorise_losses": memo, "setup_s": setup_s,
           "restore_s": restore_s, "run_s": run_s,
           "ms_per_step": step_s * 1e3, "tokens_per_step": tokens,
           "tokens_per_s": tokens / step_s,
           "model_flop_share": 6.0 * n_params * tokens / step_s
           / PEAK_FLOPS["bfloat16"],
           "peak_mem_gib": peak, "disk_free_gb": disk.free / 1e9,
           "launches": counts, "profile": profile}
    del trainer, batch
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_train(torch, ops) -> dict:
    """The training path: five families at full width with the depth cut,
    the card against the CPU; the MoE experts' bf16 backward; full-size
    qwen3-0.6b through the launcher's set-up."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = [train_case(torch, ops, "qwen3-0.6b", 2),
             # one super-block (6 Mamba2 layers + the shared block) and a
             # one-layer tail: the SSD forward and backward kernels
             train_case(torch, ops, "zamba2-7b", 7),
             train_case(torch, ops, "qwen2-moe-a2.7b", 2),
             train_case(torch, ops, "xlstm-125m", 2),        # one pair
             # the encoder's self-attention and the cross-attention
             # through sdpa, as the path case over 200 seeded frames
             train_case(torch, ops, "seamless-m4t-large-v2", 2,
                        enc_layers=2, frontend=200)]
    return {"cases": cases, "moe_bf16": moe_bf16_grads(torch),
            "full": train_full(torch, ops)}


# ----------------------------------------------------------------------
# phase 5: serve each model at full size behind the engine
# ----------------------------------------------------------------------

def profile_calls(torch, fn, n: int) -> dict:
    """Host time per call of ``fn`` without and with ``torch.profiler``,
    and, from the profiled run, the device time per call summed over the
    CUDA kernels, the busy share (device time over the unprofiled host
    time), the kernels that take the most device time, and the SSD scan's
    kernels (names that begin ``ssd_``; one scan starts several) summed
    into one item."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_prof_ms = (time.perf_counter() - t0) / n * 1e3
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    device_ms = sum(dev_us(e) for e in kernels) / n / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:8]
    ssd = [e for e in kernels if "ssd_" in e.key]
    ssd_ms: dict[str, float] = {}
    for e in ssd:
        name = re.search(r"ssd_\w+", e.key).group()
        ssd_ms[name] = ssd_ms.get(name, 0.0) + dev_us(e) / n / 1e3
    return {"calls": n, "host_ms": wall_ms, "host_ms_profiled": wall_prof_ms,
            "device_ms": device_ms,
            "busy_share": device_ms / wall_ms if wall_ms else None,
            "kernel_launches": sum(e.count for e in kernels) / n,
            "top": [{"kernel": e.key[:70], "ms": dev_us(e) / n / 1e3,
                     "launches": e.count / n} for e in top],
            "ssd": {"ms": sum(dev_us(e) for e in ssd) / n / 1e3,
                    "kernel_launches": sum(e.count for e in ssd) / n,
                    "kernels": ssd_ms}}


def timed(fn, spent: dict, calls: dict, name: str):
    """``fn``, adding its host time to ``spent[name]`` and one to
    ``calls[name]`` at each call; an engine step or prefill ends in a
    device-to-host copy, so the host clock covers its device work."""
    def inner(*args):
        s = time.perf_counter()
        out = fn(*args)
        spent[name] += time.perf_counter() - s
        calls[name] += 1
        return out
    return inner


def checked(torch, fn, finite: list):
    """``fn``, appending one device flag per call to ``finite``: whether
    its logits are all finite (read once, at the end of a run).  On the
    card the engine replays a bucket's prefill from a CUDA graph, which a
    wrapper on ``Model.prefill`` sees only at the bucket's warm-up, whose
    flag it takes, and capture, which runs nothing, so no flag is taken
    there; a replay equals the eager prefill bit for bit (the
    ``prefills`` phase)."""
    def inner(*args, **kw):
        out = fn(*args, **kw)
        if not torch.cuda.is_current_stream_capturing():
            finite.append(torch.isfinite(out[0]).all())
        return out
    return inner


def checked_steps(torch, eng, finite: list) -> None:
    """After each of ``eng``'s decode steps, one device flag appended to
    ``finite``: whether the step's logits are all finite.  On the card the
    step replays one CUDA graph, which a wrapper on ``Model.decode_step``
    sees only at its capture, so the flag is taken after the step."""
    step = eng._step

    def inner():
        step()
        finite.append(torch.isfinite(eng.step_logits).all())
    eng._step = inner


def moe_step_weights(torch, cfg, step, tokens: list[int]) -> dict:
    """The expert weights one decode step reads: the step run once on
    ``tokens`` (one per slot) with each MoE layer's routing read back (top-
    k of the router's softmax over the layer's input; a decode step drops
    nothing, so every chosen expert runs), against what a dispatch over
    every expert would read."""
    from repro_torch.models import moe
    chosen = []
    inner = moe.moe_fwd

    def counting(p, cfg_, x, group_size=moe.MOE_GROUP, **kw):
        probs = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ p.router,
                              dim=-1)
        chosen.append(torch.topk(probs, cfg_.top_k, dim=-1).indices
                      .unique().numel())
        return inner(p, cfg_, x, group_size, **kw)

    moe.moe_fwd = counting
    try:
        step(torch.tensor(tokens, dtype=torch.int32, device="cuda")[:, None])
    finally:
        moe.moe_fwd = inner
    expert = 3 * cfg.d_model * cfg.expert_d_ff * 2        # bf16 bytes
    return {"distinct_experts_per_layer": chosen,
            "expert_weight_gb": sum(chosen) * expert / 1e9,
            "all_experts_weight_gb": len(chosen) * cfg.n_experts * expert
            / 1e9}


def serve_case(torch, ops, arch: str, lens: list[int], new_tokens: tuple,
               seed: int = 0, profile_prefill: int = 1024,
               n_layers: int | None = None) -> dict:
    """Full-size ``arch`` (its depth cut to ``n_layers`` when given), bf16,
    seeded weights, behind the engine with telemetry and mitigation: one
    request per prompt length in ``lens`` with ``new_tokens`` (a range) new
    tokens each; then the profile of a decode step of all 8 slots and of a
    ``profile_prefill``-token prefill."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model
    from repro_torch.serving import (EngineConfig, InferenceEngine,
                                     ServeRequest)
    cfg = ARCHS[arch]
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=seed)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    eng = InferenceEngine(model, EngineConfig(
        max_slots=8, max_seq=2048, page_size=16, n_pages=1024,
        telemetry=True, mitigate=True))
    rng = random.Random(seed)
    reqs = [ServeRequest(req_id=i, arrival=i * 0.004,
                         prompt=[rng.randrange(cfg.vocab) for _ in range(n)],
                         max_new_tokens=rng.randrange(*new_tokens))
            for i, n in enumerate(lens)]

    finite = []
    spent = {"prefill": 0.0, "decode": 0.0}
    calls = dict.fromkeys(spent, 0)
    prefill, decode_step = model.prefill, model.decode_step
    model.prefill = checked(torch, model.prefill, finite)
    eng._prefill = timed(eng._prefill, spent, calls, "prefill")
    eng._step = timed(eng._step, spent, calls, "decode")
    checked_steps(torch, eng, finite)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rep = eng.run(reqs, max_steps=4000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    prefills, steps = eng.stats["prefills"], rep["steps"]
    check(rep["completed"] == len(reqs), f"{arch}: completed "
          f"{rep['completed']} of {len(reqs)}")
    check(rep["tokens"] == sum(r.max_new_tokens for r in reqs),
          f"{arch}: token count mismatch")
    want = kernel_launches(cfg, prefills, steps)
    check(counts == want, f"{arch}: launches {counts}, want {want} for "
          f"{prefills} prefills and {steps} steps")
    check(bool(torch.stack(finite).all()), f"{arch}: serve logits not "
          "finite")
    # where a decode step of all 8 slots and a prefill spend their time
    # (after the run; these launches are not counted above)
    toks = torch.zeros((8, 1), dtype=torch.int32, device=model.device)
    prompt = torch.zeros((1, profile_prefill), dtype=torch.int32,
                         device=model.device)
    profiled = {
        "decode_step": profile_calls(
            torch, lambda: decode_step(toks, eng.slot_cache), 5),
        f"prefill_{profile_prefill}": profile_calls(
            torch, lambda: prefill(prompt, model.init_cache(1, 2048)), 2)}
    if cfg.is_moe:
        profiled["moe_decode_weights"] = moe_step_weights(
            torch, cfg, lambda t: decode_step(t, eng.slot_cache),
            [eng._slot_next_token.get(s, 0) for s in range(8)])
    tel = rep["telemetry"]
    out = {"model": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
           "params": sum(p.numel() for p in model.decoder.parameters()),
           "requests": len(reqs), "completed": rep["completed"],
           "prefills": prefills, "steps": steps, "tokens": rep["tokens"],
           "buckets": sorted({eng.sched.bucket_len(n) for n in lens}),
           "init_s": init_s, "wall_s": wall,
           "prefill_s": spent["prefill"], "decode_s": spent["decode"],
           "ms_per_decode_step": spent["decode"] / steps * 1e3,
           "ms_per_prefill": spent["prefill"] / prefills * 1e3,
           "tokens_per_s_wall": rep["tokens"] / wall,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "launches": counts, "events": tel["events"],
           "findings_by_row": tel["findings_by_row"],
           "actions": [a for _, a, _ in tel["actions"]],
           "profile": profiled}
    # the model sits in reference cycles (the engine and its plane's
    # controller, the checked wrappers): collect them now, so the next
    # case's peak memory is its own
    del eng, model, prefill, decode_step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_serve(torch, ops) -> dict:
    # qwen3-0.6b: 16 requests over every prefill bucket 64-1024, 16-128
    # new tokens each
    qwen = serve_case(torch, ops, "qwen3-0.6b",
                      [64, 90, 128, 180, 256, 333, 512, 700, 1000, 77, 150,
                       240, 400, 800, 999, 64], (16, 129))
    # zamba2-7b: 8 requests (one per slot) over every bucket, 16-64 new
    # tokens each
    zamba = serve_case(torch, ops, "zamba2-7b",
                       [50, 64, 120, 200, 256, 333, 512, 1000], (16, 65))
    return {"cases": [qwen, zamba]}


MOE_SERVE_LAYERS = 6    # qwen2-moe-a2.7b's serve case: depth cut from 24


def phase_families(torch, ops) -> dict:
    """The families beyond dense and hybrid at full width behind the
    engine: qwen2-moe-a2.7b (MoE; 6 of its 24 layers, 4.05 B parameters:
    drawing all 14.3 B on the host took ~120 s of the script's time limit,
    12 layers ~69 s)
    serving 8 requests over every prefill bucket, and xlstm-125m at full
    size serving 8 in the 64-256 buckets (its recurrences run a Python step
    per token and cell, so a long prefill is host-bound; its prefill is
    profiled at 256 tokens)."""
    moe = serve_case(torch, ops, "qwen2-moe-a2.7b",
                     [50, 64, 120, 200, 256, 333, 512, 1000], (16, 65),
                     n_layers=MOE_SERVE_LAYERS)
    xlstm = serve_case(torch, ops, "xlstm-125m",
                       [40, 64, 90, 128, 150, 200, 230, 256], (16, 65),
                       profile_prefill=256)
    return {"cases": [moe, xlstm]}


# ----------------------------------------------------------------------
# phase 5: the DPU closed loop at full width
# ----------------------------------------------------------------------

WALL_CLOCK = ("ns_per_event", "ns_per_event_by_detector")
# examples/torch_serve_with_dpu_telemetry.py's engine; its workload is the
# example's make_requests (16 requests at t=0 with 8-token prompts, 200 new
# tokens for every fourth, over max_seq 128: the ring wraps, 4 for the rest)
LOOP = dict(max_slots=4, max_seq=128, n_pages=256, telemetry=True,
            mitigate=True)


def without_wall_clock(rep: dict) -> dict:
    return {**rep, "telemetry": {k: v for k, v in rep["telemetry"].items()
                                 if k not in WALL_CLOCK}}


def loop_run(torch, model, observe: bool = False, **kw) -> dict:
    """The example's workload through one engine from static batching, with
    ``LOOP`` updated by ``kw``.  The host clock times every decode step and
    prefill (each ends in a device-to-host copy) and every telemetry flush
    (the hand-off to the plane or to the sidecar, and the sidecar's
    advance: the loop's host cost).  With ``observe``, also what the loop
    observed (every batch into the sidecar, its report, the tracer's
    counters and incidents) and one finite flag per prefill and step."""
    from repro_torch.core.events import BATCH_COLUMNS
    from repro_torch.serving import EngineConfig, InferenceEngine
    eng = InferenceEngine(model, EngineConfig(**{**LOOP, **kw}))
    eng.sched.set_continuous(False)
    reqs = examples()["serve"].make_requests(model.cfg)
    spent = {"prefill": 0.0, "decode": 0.0, "flush": 0.0}
    calls = dict.fromkeys(spent, 0)
    eng._prefill = timed(eng._prefill, spent, calls, "prefill")
    eng._step = timed(eng._step, spent, calls, "decode")
    eng._flush_telemetry = timed(eng._flush_telemetry, spent, calls, "flush")
    sink, finite = [], []
    if observe:
        model.prefill = checked(torch, model.prefill, finite)
        checked_steps(torch, eng, finite)
        if eng.dpu is not None:
            observe_batch = eng.dpu.observe_batch

            def tap(batch):      # the wire's input, as the engine sent it
                sink.append({c: getattr(batch, c).tolist()
                             for c in BATCH_COLUMNS})
                observe_batch(batch)
            eng.dpu.observe_batch = tap
    t0 = time.perf_counter()
    rep = eng.run(reqs, max_steps=800)
    wall = time.perf_counter() - t0
    if observe:
        del model.prefill
    check(rep["completed"] == len(reqs), f"control loop on "
          f"{model.device}: completed {rep['completed']} of {len(reqs)}")
    check(rep["tokens"] == sum(r.max_new_tokens for r in reqs),
          f"control loop on {model.device}: token count mismatch")
    tel = rep["telemetry"]
    out = {"report": rep, "eng": eng, "finite": finite,
           "times": {"control": eng.cfg.control, "steps": rep["steps"],
                     "wall_s": wall,
                     "ms_per_decode_step": spent["decode"] / rep["steps"]
                     * 1e3,
                     "ms_per_prefill": spent["prefill"] / calls["prefill"]
                     * 1e3,
                     "ms_per_flush": spent["flush"] / calls["flush"] * 1e3,
                     "flushes": calls["flush"],
                     "ns_per_event": tel["ns_per_event"],
                     "ns_per_event_by_detector":
                         tel["ns_per_event_by_detector"]}}
    if observe:
        out["observed"] = {
            "report": without_wall_clock(rep), "sink": sink,
            "dpu": eng.dpu.report() if eng.dpu is not None else None,
            "counters": eng.tracer.counters if eng.tracer else None,
            "incidents": eng.tracer.reports() if eng.tracer else None}
    return out


def phase_control(torch, ops) -> dict:
    """The closed loop on the card, held to the same loop on the CPU, then
    the loop's host cost under dpu and instant control in alternating
    runs."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model
    cfg = ARCHS["qwen3-0.6b"]
    model = build_model(cfg, device="cuda", seed=0)
    # the CPU's loop: the reduced model with the full model's vocabulary,
    # so the D2H events (4 bytes a logit) are the card's sizes too
    small = build_model(dataclasses.replace(cfg.reduced(), vocab=cfg.vocab),
                        device="cpu", seed=0)
    ops.reset_launch_counts()
    card = loop_run(torch, model, observe=True, control="dpu", trace=True)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    eng = card["eng"]
    prefills, steps = eng.stats["prefills"], card["report"]["steps"]
    want = kernel_launches(cfg, prefills, steps)
    check(counts == want, f"control loop: launches {counts}, want {want} "
          f"for {prefills} prefills and {steps} steps")
    check(bool(torch.stack(card["finite"]).all()), "control loop: logits "
          "not finite")
    cpu = loop_run(torch, small, observe=True, control="dpu", trace=True)
    for key, got in card["observed"].items():
        check(got == cpu["observed"][key], f"control loop: {key} on the "
              "card differs from the CPU's")
    actions = [a for _, a, _ in card["report"]["telemetry"]["actions"]]
    sidecar = eng.dpu.report()
    check("inflight_remap" in actions, f"control loop: actions {actions} "
          "lack inflight_remap")
    check(sidecar["commands"]["applied"] >= 1, "control loop: no command "
          "applied through the bus")
    static = loop_run(torch, small, mitigate=False)
    check(steps < static["report"]["steps"], f"control loop: {steps} "
          f"steps, static batching {static['report']['steps']}")
    # the loop's host cost: dpu and instant control in alternating runs
    runs = [loop_run(torch, model, control=c)["times"]
            for c in ("instant", "dpu", "dpu", "instant", "instant", "dpu")]
    cost = {}
    for metric in ("ms_per_decode_step", "ms_per_prefill", "ms_per_flush",
                   "ns_per_event"):
        by = {c: [r[metric] for r in runs if r["control"] == c]
              for c in ("dpu", "instant")}
        # resolved only where every run of one control reads above every
        # run of the other
        cost[metric] = {**by, "resolved": min(by["dpu"]) > max(
            by["instant"]) or max(by["dpu"]) < min(by["instant"])}
    out = {"model": cfg.name, "layers": cfg.n_layers, "dtype": cfg.dtype,
           "engine": {**LOOP, "control": "dpu", "trace": True,
                      "static_batching": True},
           "requests": len(examples()["serve"].make_requests(cfg)),
           "completed": card["report"]["completed"], "prefills": prefills,
           "steps": steps, "static_steps_cpu": static["report"]["steps"],
           "tokens": card["report"]["tokens"], "launches": counts,
           "events": card["report"]["telemetry"]["events"],
           "findings_by_row": card["report"]["telemetry"]["findings_by_row"],
           "actions": card["report"]["telemetry"]["actions"],
           "sidecar": sidecar, "tracer_counters": eng.tracer.counters,
           # simulated seconds; an engine run has no fault start, so the
           # TTM phases are null and the milestones and span times say
           # where the loop's time went
           "incidents_sim_s": [
               {"incident_id": r["incident_id"], "row": r["row"],
                "closed": r["closed"], "ttm": r["ttm"],
                "milestones": r["milestones"],
                "timeline": [(e["ts"], e["phase"], e["name"])
                             for e in r["timeline"]]}
               for r in eng.tracer.reports()],
           "checked_run": card["times"], "runs": runs, "host_cost": cost}
    del card, cpu, eng, model
    torch.cuda.empty_cache()
    return out


# ----------------------------------------------------------------------
# phase 6: the serve launcher on the card and on the CPU
# ----------------------------------------------------------------------

def phase_launch() -> dict:
    """``python -m repro_torch.launch.serve`` as a user runs it (the card
    is its default device), and with ``--device cpu``: both must serve
    24/24 and print the same lines and report, wall-clock keys aside."""
    args = ["--arch", "qwen3-0.6b", "--requests", "24", "--rate", "200",
            "--report"]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(SRC)] + ([os.environ["PYTHONPATH"]]
                      if os.environ.get("PYTHONPATH") else []))}
    runs = {}
    for device, extra in (("cuda", []), ("cpu", ["--device", "cpu"])):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", *args,
             *extra], cwd=ROOT, env=env, capture_output=True, text=True,
            timeout=600)
        check(proc.returncode == 0, f"launcher on {device} exited "
              f"{proc.returncode}: {proc.stderr[-3000:]}")
        head, _, body = proc.stdout.partition("\n{")
        rep = json.loads("{" + body)
        lines = head.splitlines()
        check(len(lines) == 2 and "24/24 done" in lines[0]
              and lines[1].startswith("[telemetry]"),
              f"launcher on {device} printed {lines}")
        check(rep["completed"] == 24, f"launcher on {device}: completed "
              f"{rep['completed']} of 24")
        runs[device] = {"seconds": time.perf_counter() - t0,
                        "lines": lines, "report": without_wall_clock(rep),
                        "ns_per_event": rep["telemetry"]["ns_per_event"]}
    check(runs["cuda"]["lines"] == runs["cpu"]["lines"],
          "launcher: the card's printed lines differ from the CPU's")
    check(runs["cuda"]["report"] == runs["cpu"]["report"],
          "launcher: the card's report differs from the CPU's")
    return {"argv": args, "lines": runs["cuda"]["lines"],
            "steps": runs["cuda"]["report"]["steps"],
            "events": runs["cuda"]["report"]["telemetry"]["events"],
            **{f"{d}_seconds": r["seconds"] for d, r in runs.items()}}


# ----------------------------------------------------------------------
# phase 7: the quickstart's whole pipeline, through examples/torch_quickstart
# ----------------------------------------------------------------------

GOLDEN = ROOT / "tests" / "golden" / "scenario_findings.json"
#: the golden fixture's seven metrics (tests/regen_golden.py)
GOLDEN_METRICS = {
    "completed": lambda m: m.completed, "tokens_out": lambda m: m.tokens_out,
    "first_finding_ts": lambda m: m.first_finding_ts,
    "p50_latency": lambda m: m.p(0.5), "p99_latency": lambda m: m.p(0.99),
    "p50_ttft": lambda m: m.p_ttft(0.5), "p99_ttft": lambda m: m.p_ttft(0.99)}
_EXAMPLES: dict = {}


def examples() -> dict:
    """examples/torch_*.py as modules, imported once.  The simulator runs
    on the host whatever device an example names, and gives the same
    result for the same arguments: so every run of it in this process
    (the examples', the quickstart phase's steps and the golden fixture's
    check) goes through one ``shared_run_scenario``, which runs each
    distinct scenario once."""
    if not _EXAMPLES:
        import inspect

        from repro_torch import sim
        sys.path.insert(0, str(ROOT / "examples"))
        import torch_pathology_drilldown
        import torch_quickstart
        import torch_serve_with_dpu_telemetry
        import torch_train_100m
        run, runs = sim.run_scenario, {}
        sig = inspect.signature(run)

        def shared_run_scenario(*args, **kw):
            bound = sig.bind(*args, **kw)
            bound.apply_defaults()
            key = repr(bound.arguments)
            if key not in runs:
                runs[key] = run(*args, **kw)
            return runs[key]
        for mod in (torch_quickstart, torch_pathology_drilldown):
            mod.run_scenario = shared_run_scenario
        _EXAMPLES.update(
            quickstart=torch_quickstart,
            serve=torch_serve_with_dpu_telemetry, train=torch_train_100m,
            drilldown=torch_pathology_drilldown,
            run_scenario=shared_run_scenario, scenario_runs=runs)
    return _EXAMPLES


def quickstart_serve(torch, model) -> dict:
    """Step 2: ``torch_quickstart.serve`` on its engine (telemetry and
    mitigation); every decode step and prefill timed on the host clock,
    every prefill's and every step's logits checked finite."""
    tq = examples()["quickstart"]
    eng = tq.engine(model)
    spent = {"prefill": 0.0, "decode": 0.0}
    calls = dict.fromkeys(spent, 0)
    finite = []
    model.prefill = checked(torch, model.prefill, finite)
    eng._prefill = timed(eng._prefill, spent, calls, "prefill")
    eng._step = timed(eng._step, spent, calls, "decode")
    checked_steps(torch, eng, finite)
    t0 = time.perf_counter()
    rep = tq.serve(eng)
    wall = time.perf_counter() - t0
    del model.prefill
    check(bool(torch.stack(finite).all()), f"quickstart on {model.device}: "
          "logits not finite")
    tel = rep["telemetry"]
    n = len(tq.requests(model.cfg.vocab))
    check(rep["completed"] == n, f"quickstart on {model.device}: "
          f"completed {rep['completed']} of {n}")
    check(tel["findings"] == 0, f"quickstart on {model.device}: healthy "
          f"serve gave {tel['findings']} findings")
    prefills, steps = eng.stats["prefills"], rep["steps"]
    return {"report": without_wall_clock(rep), "prefills": prefills,
            "steps": steps, "tokens": rep["tokens"], "requests": n,
            "engine": {k: getattr(eng.cfg, k) for k in (
                "max_slots", "max_seq", "n_pages", "page_size")},
            "buckets": sorted({eng.sched.bucket_len(len(r.prompt))
                               for r in tq.requests(model.cfg.vocab)}),
            "wall_s": wall,
            "ms_per_decode_step": spent["decode"] / steps * 1e3,
            "ms_per_prefill": spent["prefill"] / prefills * 1e3,
            "tokens_per_s_wall": rep["tokens"] / wall}


def golden_outcome(m, plane) -> dict:
    return {"findings": [[f.name, f.node, f.ts, f.severity, f.score]
                         for f in plane.findings],
            "metrics": {k: fn(m) for k, fn in GOLDEN_METRICS.items()}}


def quickstart_sim(golden: dict) -> dict:
    """Steps 3 and 4, ``torch_quickstart.pathology`` and ``hot_replica``:
    tp_straggler detected and attributed as the golden fixture says, then
    hot_replica's loop off and on (the mitigated run acts, lowers p99 and
    completes no fewer)."""
    tq = examples()["quickstart"]
    t0 = time.perf_counter()
    sc, m, plane = tq.pathology()
    got = golden_outcome(m, plane)
    check(got == {k: golden["tp_straggler"][k] for k in got}, "tp_straggler: "
          "findings or metrics differ from the golden fixture")
    first = next(f for f in got["findings"] if f[0] == "tp_straggler")
    att = next((a for a in plane.attributions
                if a.primary.name == "tp_straggler"), None)
    check(att is not None, "tp_straggler: no attribution names it primary")
    straggler = {"injected_node": sc.fault.straggler_node,
                 "finding": first, "locus": att.locus, "node": att.node,
                 "confidence": att.confidence,
                 "detect_latency_s": m.first_finding_ts - sc.fault.start,
                 "seconds": time.perf_counter() - t0}
    t0 = time.perf_counter()
    _, off_m, on_m, on_plane = tq.hot_replica()
    off = {"p99_latency": off_m.p(0.99), "completed": off_m.completed}
    on = {"actions": [a.action for a in on_plane.actions],
          "p99_latency": on_m.p(0.99), "completed": on_m.completed}
    check(len(on["actions"]) >= 1, "hot_replica: the mitigated run took no "
          "action")
    check(on["p99_latency"] < off["p99_latency"], f"hot_replica: p99 "
          f"{off['p99_latency']} -> {on['p99_latency']} did not fall")
    check(on["completed"] >= off["completed"], f"hot_replica: completions "
          f"{off['completed']} -> {on['completed']} fell")
    return {"tp_straggler": straggler,
            "hot_replica": {"off": off, "on": on,
                            "seconds": time.perf_counter() - t0}}


SWEEP_JSON = ROOT / "build" / "sweep_smoke.json"


def start_smoke_sweep() -> subprocess.Popen:
    """Step 5: ``python -m repro_torch.sim.sweep --smoke`` as a user runs
    it, with 4 workers, in a child process (its workers fork, which this
    process must not: it holds a CUDA context), started at once so that it
    runs beside the phase's work on the card; it writes its cells to
    ``SWEEP_JSON``."""
    SWEEP_JSON.unlink(missing_ok=True)
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.sim.sweep", "--smoke",
         "--workers", "4", "--json", str(SWEEP_JSON)], cwd=ROOT,
        env=src_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def smoke_sweep(sweep: subprocess.Popen, golden: dict) -> dict:
    """Each smoke scenario's findings and metrics against the golden
    fixture (in this process), then the sweep's gate (hit rate 1.0, no
    false positive, one valid incident per fault cell, its exit code 0)
    and each of its cells against the golden fixture, the counts
    included."""
    from repro_torch.sim import SCENARIOS
    from repro_torch.sim.sweep import SMOKE_SCENARIOS
    run_scenario = examples()["run_scenario"]
    t0 = time.perf_counter()
    for name in SMOKE_SCENARIOS:
        sc = SCENARIOS[name]
        m, plane, _ = run_scenario(sc.fault, sc.params, sc.workload)
        check(golden_outcome(m, plane) == {k: golden[name][k] for k in (
            "findings", "metrics")}, f"smoke scenario {name}: findings "
            "or metrics differ from the golden fixture")
    golden_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, err = sweep.communicate(timeout=600)
    wait_s = time.perf_counter() - t0
    check(sweep.returncode == 0, f"smoke sweep exited {sweep.returncode}: "
          f"{err[-3000:]}")
    payload = json.loads(SWEEP_JSON.read_text())
    summary, cells = payload["summary"], payload["cells"]
    check(summary["hit_rate"] == 1.0, f"smoke sweep: hit rate "
          f"{summary['hit_rate']}")
    check(summary["healthy_false_positives"] == 0, f"smoke sweep: "
          f"{summary['healthy_false_positives']} false positives")
    check(not summary["incident_problems"], f"smoke sweep: incident "
          f"problems {summary['incident_problems']}")
    check([c["scenario"] for c in cells] == list(SMOKE_SCENARIOS),
          f"smoke sweep: cells {[c['scenario'] for c in cells]}")
    for c in cells:
        want = golden[c["scenario"]]
        counts: dict[str, int] = {}
        for f in want["findings"]:
            counts[f[0]] = counts.get(f[0], 0) + 1
        cell = {k: c[k] for k in ("findings", "completed", "tokens_out",
                                  "p99_latency", "p99_ttft")}
        check(cell == {"findings": counts, **{
            k: want["metrics"][k] for k in cell if k != "findings"}},
            f"smoke sweep: cell {c['scenario']} differs from the golden "
            "fixture")
    return {"scenarios": len(cells), "hit_rate": summary["hit_rate"],
            "false_positives": summary["healthy_false_positives"],
            "incidents": summary["incidents"], "events": summary["events"],
            "workers": summary["workers"], "sweep_s": summary["wall_s"],
            "golden_s": golden_s, "wait_s": wait_s}


def phase_quickstart(torch, ops) -> dict:
    """examples/torch_quickstart.py's four steps, the model at full size on
    the card, then the smoke sweep and the port's linter."""
    import numpy
    from repro_torch.configs import ARCHS
    from repro_torch.lint import run_lint
    from repro_torch.models import build_model
    emit({"phase": "quickstart", "numpy": numpy.__version__,
          "started": True})
    sweep = start_smoke_sweep()
    cfg = ARCHS[examples()["quickstart"].ARCH]
    t0 = time.perf_counter()
    model = build_model(cfg, device="cuda", seed=0)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    # the CPU's run: the reduced model with the full model's vocabulary, so
    # the prompts and the D2H events are the card's too
    small = build_model(dataclasses.replace(cfg.reduced(), vocab=cfg.vocab),
                        device="cpu", seed=0)
    ops.reset_launch_counts()
    card = quickstart_serve(torch, model)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    want = kernel_launches(cfg, card["prefills"], card["steps"])
    check(counts == want, f"quickstart: launches {counts}, want {want} for "
          f"{card['prefills']} prefills and {card['steps']} steps")
    cpu = quickstart_serve(torch, small)
    check(card["report"] == cpu["report"], "quickstart: the card's report "
          "differs from the CPU's")
    params = sum(p.numel() for p in model.decoder.parameters())
    del model
    torch.cuda.empty_cache()
    golden = json.loads(GOLDEN.read_text())["scenarios"]
    sim = quickstart_sim(golden)
    sweep = smoke_sweep(sweep, golden)
    t0 = time.perf_counter()
    lint = run_lint(ROOT)
    check(not lint.unsuppressed, "repro_torch.lint: "
          + "; ".join(f.format() for f in lint.unsuppressed))
    rep = card["report"]
    return {"numpy": numpy.__version__, "model": cfg.name,
            "layers": cfg.n_layers, "d_model": cfg.d_model,
            "heads": [cfg.n_heads, cfg.n_kv_heads], "d_ff": cfg.d_ff,
            "vocab": cfg.vocab, "dtype": cfg.dtype, "params": params,
            "init_s": init_s,
            **{k: card[k] for k in ("engine", "requests")},
            "completed": rep["completed"],
            "tokens_per_step": rep["tokens_per_step"],
            "events": rep["telemetry"]["events"],
            "findings": rep["telemetry"]["findings"],
            "launches": counts,
            **{k: card[k] for k in ("prefills", "steps", "tokens", "buckets",
                                    "wall_s", "ms_per_decode_step",
                                    "ms_per_prefill", "tokens_per_s_wall")},
            "cpu_wall_s": cpu["wall_s"], **sim, "smoke_sweep": sweep,
            "lint": {"files": lint.files_scanned, "unsuppressed": 0,
                     "suppressed": len(lint.suppressed),
                     "seconds": time.perf_counter() - t0}}


# ----------------------------------------------------------------------
# phase 8: the four examples/torch_*.py as a user runs them
# ----------------------------------------------------------------------

#: one runbook row per table (3a, 3b, 3c, 3d, 3e, dpu, mon), as
#: tests/torch_examples.py's DRILL_ROWS
DRILL_ROWS = ("early_completion_skew", "decode_early_stop_skew",
              "tp_straggler", "hierarchical_routing_skew",
              "hbm_bandwidth_cliff", "dpu_saturation", "telemetry_blackout")
TRAIN_FULL_ARGV = ["--full", "--steps", "8"]
TRAIN_LOSS_TOL = 1e-3
NO_LAUNCH = dict.fromkeys(REPLACES, 0)


def example_run(torch, ops, main, argv: list[str]) -> dict:
    """``main(argv)`` of an example, its printed lines captured and its
    launches counted from 0."""
    import contextlib
    import io
    out = io.StringIO()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    torch.cuda.synchronize()
    return {"lines": out.getvalue().splitlines(), "result": result,
            "launches": ops.launch_counts(),
            "seconds": time.perf_counter() - t0}


def card_and_cpu(torch, ops, main, name: str, argv: list[str],
                 cpu_argv: list[str] | None = None) -> tuple[dict, dict]:
    """An example on the card (its default device) with ``argv``, and with
    ``cpu_argv`` (default: ``argv``) and ``--device cpu``; the CPU's run
    launches no kernel."""
    card = example_run(torch, ops, main, argv)
    cpu = example_run(torch, ops, main,
                      (argv if cpu_argv is None else cpu_argv)
                      + ["--device", "cpu"])
    check(cpu["launches"] == NO_LAUNCH, f"{name} on the CPU launched "
          f"{cpu['launches']}")
    return card, cpu


def engine_launches(cfg, engines) -> dict[str, int]:
    """The launches the engines' prefills and steps must make."""
    out = dict(NO_LAUNCH)
    for eng in engines:
        for k, v in kernel_launches(cfg, eng.stats["prefills"],
                                    eng.stats["steps"]).items():
            out[k] += v
    return out


def examples_serving(torch, ops, name: str) -> dict:
    """The quickstart or the serve example on the card and the CPU: the
    same printed lines, the card's model on the card, exact launches."""
    main = examples()[name].main
    card, cpu = card_and_cpu(torch, ops, main, name, [])
    check(card["lines"] == cpu["lines"], f"{name}: the card printed "
          f"{card['lines']}, the CPU {cpu['lines']}")
    engines = card["result"]
    engines = engines if isinstance(engines, list) else [engines]
    check(all(e.model.device.type == "cuda" for e in engines),
          f"{name}: the default device is not the card")
    want = engine_launches(engines[0].model.cfg, engines)
    check(card["launches"] == want, f"{name}: launches "
          f"{card['launches']}, want {want}")
    return {"lines": card["lines"], "launches": card["launches"],
            "prefills": sum(e.stats["prefills"] for e in engines),
            "steps": [e.stats["steps"] for e in engines],
            "seconds": card["seconds"], "cpu_seconds": cpu["seconds"]}


def loss_line(hist: list[dict]) -> str:
    return (f"step {hist[0]['step']}: loss {hist[0]['loss']:.3f}  ->  "
            f"step {hist[-1]['step']}: loss {hist[-1]['loss']:.3f}")


def examples_train(torch, ops) -> dict:
    """torch_train_100m.py at its default size on the card and the CPU (the
    same lines, the losses to 1e-3, the mean step time's form), then
    ``--full --steps 8`` twice in one checkpoint directory: the second run
    resumes with the first run's weights and moments, bit for bit."""
    import shutil
    main = examples()["train"].main
    ckdir = ROOT / "build" / "examples_ckpt"
    shutil.rmtree(ckdir, ignore_errors=True)
    dirs = {d: str(ckdir / d) for d in ("cuda", "cpu", "full")}
    card, cpu = card_and_cpu(torch, ops, main, "train_100m",
                             ["--ckpt", dirs["cuda"]],
                             ["--ckpt", dirs["cpu"]])
    hist = {d: r["result"].history for d, r in (("cuda", card),
                                                ("cpu", cpu))}
    losses = {d: [h["loss"] for h in hs] for d, hs in hist.items()}
    check(card["result"].model.device.type == "cuda",
          "train_100m: the default device is not the card")
    check(card["launches"] == NO_LAUNCH, f"train_100m launched "
          f"{card['launches']}: training attends through sdpa")
    check(len(losses["cuda"]) == len(losses["cpu"]) == 40,
          f"train_100m: {len(losses['cuda'])} steps on the card, "
          f"{len(losses['cpu'])} on the CPU")
    loss_err = max(abs(a - b) / max(1.0, abs(b)) for a, b in zip(
        losses["cuda"], losses["cpu"]))
    check(loss_err <= TRAIN_LOSS_TOL, f"train_100m: losses differ by "
          f"{loss_err} between the card and the CPU")
    mean = re.compile(r"mean step time \d+\.\d{3}s, checkpoints in (.*)")
    for d, r in (("cuda", card), ("cpu", cpu)):
        lines = r["lines"]
        check(len(lines) == 3 and lines[0] == card["lines"][0]
              and lines[1] == loss_line(hist[d])
              and mean.fullmatch(lines[2])
              and mean.fullmatch(lines[2])[1] == dirs[d],
              f"train_100m on {d} printed {lines}")
    first = example_run(torch, ops, main,
                        TRAIN_FULL_ARGV + ["--ckpt", dirs["full"]])
    again = example_run(torch, ops, main,
                        TRAIN_FULL_ARGV + ["--ckpt", dirs["full"]])
    shutil.rmtree(ckdir, ignore_errors=True)
    tr, tr2 = first["result"], again["result"]
    full = [h["loss"] for h in tr.history]
    check(len(full) == 8 and all(map(math.isfinite, full))
          and full[-1] < full[0], f"train_100m --full: losses {full}")
    check(first["launches"] == again["launches"] == NO_LAUNCH,
          "train_100m --full launched a kernel")
    check(again["lines"] == [first["lines"][0],
                             "resumed from checkpoint at step 8"],
          f"train_100m --full again printed {again['lines']}")
    same = all(torch.equal(tr.params[k], tr2.params[k]) for k in tr.params)
    same &= all(torch.equal(tr.opt_state[m][k], tr2.opt_state[m][k])
                for m in ("m", "v", "error_buf") for k in tr.params)
    check(same and int(tr2.opt_state["step"]) == 8, "train_100m --full: "
          "the resumed state differs from the saved one")
    sec = sorted(h["sec"] for h in tr.history[1:])
    return {"lines": card["lines"], "losses": losses["cuda"],
            "loss_err": loss_err, "seconds": card["seconds"],
            "cpu_seconds": cpu["seconds"],
            "full": {"argv": TRAIN_FULL_ARGV, "lines": first["lines"],
                     "resumed": again["lines"], "losses": full,
                     "params": sum(p.numel() for p in tr.params.values()),
                     "ms_per_step_median": sec[len(sec) // 2] * 1e3,
                     "seconds": first["seconds"],
                     "resume_seconds": again["seconds"]}}


def examples_drilldown(torch, ops) -> dict:
    """torch_pathology_drilldown.py on one row per runbook table, on the
    card and with --device cpu: the same lines, the row's detector fires,
    and its first finding is the golden fixture's."""
    main = examples()["drilldown"].main
    from repro_torch.core.runbooks import BY_ID
    golden = json.loads(GOLDEN.read_text())["scenarios"]
    out = {"rows": {}, "seconds": 0.0, "cpu_seconds": 0.0}
    for row in DRILL_ROWS:
        card, cpu = card_and_cpu(torch, ops, main, row, [row])
        check(card["lines"] == cpu["lines"], f"drill-down {row}: the card "
              f"printed {card['lines']}, the CPU {cpu['lines']}")
        check(card["launches"] == NO_LAUNCH, f"drill-down {row} launched "
              f"{card['launches']}")
        _, node, ts, severity, score = next(
            f for f in golden[BY_ID[row].scenario]["findings"]
            if f[0] == row)
        want = (f"detected   : t={ts:.2f}s severity={severity} "
                f"node={node} score={score:.1f}")
        check(want in card["lines"] and not any(
            "did not fire" in ln for ln in card["lines"]),
            f"drill-down {row}: printed {card['lines']}, want {want!r}")
        out["rows"][row] = {"table": BY_ID[row].table, "detected": want,
                            "seconds": card["seconds"]}
        out["seconds"] += card["seconds"]
        out["cpu_seconds"] += cpu["seconds"]
    return out


def phase_examples(torch, ops) -> dict:
    """The four examples' ``main`` as a user runs them, on the card (their
    default device) and with --device cpu in this process."""
    quick = examples_serving(torch, ops, "quickstart")
    serve = examples_serving(torch, ops, "serve")
    launches = {k: quick["launches"][k] + serve["launches"][k]
                for k in REPLACES}
    return {"quickstart": quick, "serve_with_dpu_telemetry": serve,
            "train_100m": examples_train(torch, ops),
            "pathology_drilldown": examples_drilldown(torch, ops),
            "launches": launches,
            "scenario_runs": len(examples()["scenario_runs"])}


# ----------------------------------------------------------------------

def time_ssd_tree(src: Path) -> int:
    """The SSD scan of the package under ``src`` (another tree's src/, such
    as a parent commit unpacked beside this checkout) at zamba2-7b's prefill
    buckets, with the kernels phase's inputs, check and Timer; one JSON
    line.  Two trees compare only when timed in one call on one card."""
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import ops
    from repro_torch.kernels.ssd_scan import ssd_scan_plain
    timer = Timer(torch)
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for l in SSD_BUCKETS:
        x, a, B, C, s0 = ssd_inputs(torch, gen, 1, l, 112, 64, 64, True)
        y, final = ops.ssd_scan(x, a, B, C, s0)
        y_want, final_want = ssd_scan_plain(x, a, B, C, s0)
        torch.cuda.synchronize()
        row = {"l": l, "max_abs_err": max(
            max_err(torch, y, y_want, "float32", SSD_TOL),
            max_err(torch, final, final_want, "float32", SSD_TOL))}
        timer.into(row, "", lambda: ops.ssd_scan(x, a, B, C, s0))
        row["host_ms"] = timer.last_host_ms
        rows.append(row)
    emit({"ssd_tree": str(src), "gpu": smi_line(), "rows": rows})
    return 0


# ----------------------------------------------------------------------
# phase 8: the distribution layer
# ----------------------------------------------------------------------

DIST_TRAIN = ["--full-config", "--arch", "qwen3-0.6b", "--steps", "4",
              "--batch", "8", "--seq", "512", "--micro", "2"]
STEP_RE = re.compile(r"step\s+(\d+) loss (\S+) gnorm (\S+) (\d+) ms")


def src_env() -> dict:
    return {**os.environ, "PYTHONPATH": os.pathsep.join(
        [str(SRC)] + ([os.environ["PYTHONPATH"]]
                      if os.environ.get("PYTHONPATH") else []))}


def dist_train() -> dict:
    """launch.train with --mesh 1,1 and without: the same losses."""
    runs = {}
    for tag, extra in (("mesh", ["--mesh", "1,1"]), ("plain", [])):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *DIST_TRAIN,
             *extra], cwd=ROOT, env=src_env(), capture_output=True,
            text=True, timeout=600)
        check(proc.returncode == 0, f"train {tag} exited "
              f"{proc.returncode}: {proc.stderr[-3000:]}")
        steps = [(int(m[1]), float(m[2]), float(m[3]), int(m[4]))
                 for m in STEP_RE.finditer(proc.stdout)]
        check(len(steps) == 4, f"train {tag} printed {proc.stdout}")
        runs[tag] = {"losses": [s[1] for s in steps],
                     "grad_norms": [s[2] for s in steps],
                     "ms_per_step": [s[3] for s in steps],
                     "seconds": time.perf_counter() - t0}
    for a, b in zip(runs["mesh"]["losses"], runs["plain"]["losses"]):
        check(math.isfinite(a) and abs(a - b) <= 2e-2 * abs(b),
              f"sharded loss {a} against unsharded {b}")
    return runs


def dist_serve_child() -> dict:
    """In a child process: full-width qwen3-0.6b, bf16, seeded weights;
    prefill 2 x 1024 tokens and 8 decode steps unsharded, then the same
    model distributed over a one-rank mesh with shard=MeshRules."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ARCHS
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import start_group
    from repro_torch.models import build_model
    from repro_torch.parallel.sharding import (NOSHARD, MeshRules,
                                               distribute_model, full)
    cfg = ARCHS["qwen3-0.6b"]
    model = build_model(cfg, device="cuda", seed=0)
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, cfg.vocab, (2, 1024), generator=gen)
    steps = torch.randint(0, cfg.vocab, (8, 2, 1), generator=gen)
    start_group("cuda")
    rules = MeshRules(init_device_mesh("cuda", (1, 1),
                                       mesh_dim_names=("data", "model")))
    out = {}
    for tag, shard in (("plain", NOSHARD), ("mesh", rules)):
        if shard is rules:
            distribute_model(model, rules)
        cache = model.init_cache(2, 2048, page_size=16)
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = model.prefill(prompt.cuda(), cache, shard=shard)
        got = [full(logits).float()]
        for t in range(8):
            logits, cache = model.decode_step(steps[t].cuda(), cache,
                                              shard=shard)
            got.append(full(logits).float())
        torch.cuda.synchronize()
        out[tag] = {"logits": torch.cat(got, 1), "launches":
                    ops.launch_counts(),
                    "seconds": time.perf_counter() - t0}
    a, b = out["mesh"]["logits"], out["plain"]["logits"]
    check(bool(torch.isfinite(a).all()), "sharded logits not finite")
    err = float((a - b).abs().max())
    check(bool(((a - b).abs() <= 2e-2 + 2e-2 * b.abs()).all()),
          f"sharded logits differ from unsharded: max |d| {err}")
    check(out["mesh"]["launches"] == out["plain"]["launches"],
          f"launches {out['mesh']['launches']} against "
          f"{out['plain']['launches']}")
    want = kernel_launches(cfg, 1, 8)
    check(out["plain"]["launches"] == want,
          f"launches {out['plain']['launches']}, want {want}")
    torch.distributed.destroy_process_group()
    return {"max_abs_err": err, "launches": out["mesh"]["launches"],
            "plain_seconds": out["plain"]["seconds"],
            "mesh_seconds": out["mesh"]["seconds"]}


def dist_lse(torch, ops, timer, kern: dict | None) -> dict:
    """The paged kernel's log-sum-exp: the serve case's 8 slots (qwen3
    heads, 2048 positions in pages of 16), each sequence cut at a page
    boundary into two slices attended apart with their local lengths and
    merged, against one whole call; in bf16 and f32.  The whole call is
    timed with and without the output."""
    rng = random.Random(0)
    lens = sorted(rng.randrange(64, 1153) for _ in range(8))
    b, page, per_seq, hq, hkv, d = 8, 16, 128, 16, 8, 128
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        q = torch.randn((b, hq, d), generator=gen, device="cuda").to(dt)
        kp, vp = (torch.randn((b * per_seq, page, hkv, d), generator=gen,
                              device="cuda").to(dt) for _ in range(2))
        table = torch.arange(b * per_seq, dtype=torch.int32,
                             device="cuda").view(b, per_seq)
        lengths = torch.tensor(lens, dtype=torch.int32, device="cuda")
        whole = ops.paged_attention(q, kp, vp, table, lengths)
        o, lse = ops.paged_attention(q, kp, vp, table, lengths,
                                     return_lse=True)
        check(bool(torch.equal(o, whole)), "the log-sum-exp call changed "
              "the output")
        half = per_seq // 2
        parts = []
        for lo in (0, half):
            sub = table[:, lo:lo + half].contiguous()
            loc = torch.clamp(lengths - lo * page, 0, half * page).to(
                torch.int32)
            parts.append(ops.paged_attention(q, kp, vp, sub, loc,
                                             return_lse=True))
        (o0, l0), (o1, l1) = parts
        top = torch.maximum(l0, l1)
        w0, w1 = torch.exp(l0 - top), torch.exp(l1 - top)
        merged = (o0.float() * w0[..., None] + o1.float() * w1[..., None]) \
            / (w0 + w1)[..., None]
        err = max_err(torch, merged, whole, dtype, TOL[dtype])
        lse_err = float((torch.logaddexp(l0, l1) - lse).abs().max())
        check(lse_err <= 1e-4 * float(lse.abs().max()) + 1e-4,
              f"merged log-sum-exp off by {lse_err}")
        row = {"dtype": dtype, "lengths": lens, "max_abs_err": err,
               "lse_err": lse_err}
        if dtype == "bfloat16":
            timer.into(row, "whole_", lambda: ops.paged_attention(
                q, kp, vp, table, lengths), flush=True)
            timer.into(row, "lse_", lambda: ops.paged_attention(
                q, kp, vp, table, lengths, return_lse=True), flush=True)
            row["lse_over_whole"] = row["lse_device_ms"] / \
                row["whole_device_ms"]
            check(row["lse_over_whole"] <= 1.03, f"the log-sum-exp output "
                  f"costs {row['lse_over_whole']:.3f}x the whole call")
            if kern is not None:
                main = next(r for r in kern["paged_attention"]
                            if r.get("main"))
                row["kernels_phase_device_ms"] = main["device_ms"]
                row["lse_over_kernels_phase"] = row["lse_device_ms"] / \
                    main["device_ms"]
        rows.append(row)
    return {"cases": rows}


def phase_dist(torch, ops, timer, kern: dict | None) -> dict:
    # the dry-run needs no card: it runs beside the card's cases
    out_dir = ROOT / "build" / "dist_hillclimb"
    if out_dir.exists():
        for f in out_dir.glob("*.json"):
            f.unlink()
    t_dry = time.perf_counter()
    dry = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.hillclimb", "--base-only",
         "--out", str(out_dir)], cwd=ROOT, env=src_env(),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        train = dist_train()
        train["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--dist-child"],
            cwd=ROOT, env=src_env(), capture_output=True, text=True,
            timeout=600)
        check(proc.returncode == 0, f"sharded serving exited "
              f"{proc.returncode}: {proc.stderr[-3000:]}")
        serve = json.loads(proc.stdout.strip().splitlines()[-1])
        serve["seconds"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lse = dist_lse(torch, ops, timer, kern)
        lse["seconds"] = time.perf_counter() - t0
        stdout, stderr = dry.communicate(timeout=600)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
    check(dry.returncode == 0, f"hillclimb exited {dry.returncode}: "
          f"{stderr[-3000:]}")
    cells = []
    for f in sorted(out_dir.glob("*.json")):
        rec = json.loads(f.read_text())
        check(rec.get("ok") and rec["flops_per_device"] > 0,
              f"dry-run cell {f.name}: {rec.get('error')}")
        check(rec["calibration_check"]["flops_per_device"]["rel_diff"]
              == 0.0, f"{f.name}: the calibration misses the count")
        cells.append({k: rec[k] for k in (
            "arch", "shape", "mesh", "lower_s", "flops_per_device",
            "bytes_per_device", "collective_bytes",
            "collective_bytes_by_axis", "memory", "roofline",
            "calibration_check")})
    check(len(cells) == 3, f"dry-run wrote {len(cells)} cells")
    return {"train": train, "serve": serve, "lse": lse,
            "dryrun": {"host_counts_on_meta_tensors": True,
                       "seconds": time.perf_counter() - t_dry,
                       "cells": cells}}


PHASES = ("kernels", "path", "train", "serve", "families", "prefills",
          "control", "launch", "quickstart", "examples", "dist")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated phases to run after the build "
                         f"(default: all of {', '.join(PHASES)}; the "
                         "kernels summary needs all)")
    ap.add_argument("--ssd-tree", metavar="SRC", type=Path,
                    help="only time the SSD scan of the package under SRC "
                         "(another tree's src/) at the prefill buckets")
    ap.add_argument("--dist-child", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.ssd_tree:
        return time_ssd_tree(args.ssd_tree.resolve())
    phases = args.phases.split(",")
    if not set(phases) <= set(PHASES):
        ap.error(f"unknown phase in {phases}")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels import build, ops
    if args.dist_child:
        build.build()
        emit(dist_serve_child())
        return 0

    t0 = time.perf_counter()
    smi = smi_line()
    build.build()
    ptxas = {name: [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, log in build.build_logs.items()}
    emit({"phase": "build", "nvcc": build.nvcc_version(), "gpu": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "seconds": time.perf_counter() - t0, "ptxas": ptxas})

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if "kernels" in phases:
        t0 = time.perf_counter()
        kern = phase_kernels(torch, ops, Timer(torch))
        emit({"phase": "kernels", "gpu": smi,
              "seconds": time.perf_counter() - t0, **kern})
    if "path" in phases:
        t0 = time.perf_counter()
        path = phase_path(torch, ops)
        emit({"phase": "path", "seconds": time.perf_counter() - t0, **path})
    if "train" in phases:
        t0 = time.perf_counter()
        train = phase_train(torch, ops)
        emit({"phase": "train", "gpu": smi,
              "seconds": time.perf_counter() - t0, **train})
    if "serve" in phases:
        t0 = time.perf_counter()
        serve = phase_serve(torch, ops)
        emit({"phase": "serve", "gpu": smi,
              "seconds": time.perf_counter() - t0, **serve})
    if "families" in phases:
        t0 = time.perf_counter()
        families = phase_families(torch, ops)
        emit({"phase": "families", "gpu": smi,
              "seconds": time.perf_counter() - t0, **families})
    if "prefills" in phases:
        t0 = time.perf_counter()
        pre = phase_prefills(torch)
        emit({"phase": "prefills", "gpu": smi,
              "seconds": time.perf_counter() - t0, **pre})
    if "control" in phases:
        t0 = time.perf_counter()
        control = phase_control(torch, ops)
        emit({"phase": "control", "gpu": smi,
              "seconds": time.perf_counter() - t0, **control})
    if "launch" in phases:
        t0 = time.perf_counter()
        launch = phase_launch()
        emit({"phase": "launch", "gpu": smi,
              "seconds": time.perf_counter() - t0, **launch})
    if "quickstart" in phases:
        t0 = time.perf_counter()
        quick = phase_quickstart(torch, ops)
        emit({"phase": "quickstart", "gpu": smi,
              "seconds": time.perf_counter() - t0, **quick})
    if "examples" in phases:
        t0 = time.perf_counter()
        exa = phase_examples(torch, ops)
        emit({"phase": "examples", "gpu": smi,
              "seconds": time.perf_counter() - t0, **exa})
    if "dist" in phases:
        t0 = time.perf_counter()
        dist = phase_dist(torch, ops, Timer(torch),
                          kern if "kernels" in phases else None)
        emit({"phase": "dist", "gpu": smi,
              "seconds": time.perf_counter() - t0, **dist})
    if tuple(phases) != PHASES:
        # a partial run proves nothing about the port: no "ok" line
        print(smi, flush=True)
        emit({"partial": phases, "device": device})
        return 0

    # launches on the main paths: each kernel's count summed over the
    # serve and families cases, the control loop, the quickstart's serve,
    # the examples and the training runs (each run's counts were set to 0
    # just before it)
    runs = (serve["cases"] + families["cases"] + [control, quick, exa]
            + train["cases"] + [train["full"], dist["serve"]])
    launches = {name: sum(c["launches"][name] for c in runs)
                for name in REPLACES}
    summary = []
    for name in REPLACES:
        rows = kern[name]
        main_row = next(r for r in rows if r.get("main"))
        timed = [r for r in rows if "model" in r and "ms" in r]
        # the last timed row of each model is its serve shape (flash: the
        # largest prefill bucket)
        by_model = {r["model"]: {k: r[k] for k in (
            "ms", "device_ms", "plain_ms", "plain_device_ms", "library_ms",
            "library_device_ms", "bound_ms", "bound_by")} for r in timed}
        summary.append({
            "name": name, "route": "cuda", "source": SOURCE[name],
            "replaces": REPLACES[name], "replaces_fn": REPLACES_FN[name],
            "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            **{k: v for k, v in main_row.items() if k.startswith("bound_")},
            "ms": main_row["ms"], "kernel_ms": main_row["ms"],
            "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "device_ms": main_row["device_ms"],
            "plain_device_ms": main_row["plain_device_ms"],
            "library_device_ms": main_row["library_device_ms"],
            "main_shape_of": main_row["model"], "by_model": by_model,
            "timed": [{k: r[k] for k in r if k not in (
                "max_abs_err", "main", "lengths")} for r in timed]})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": device})
    return 0


if __name__ == "__main__":
    sys.exit(main())
