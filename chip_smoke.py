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
           the serving paths' shapes (qwen3-0.6b's and zamba2-7b's) and at
           edge cases; kernel, plain and library times with CUDA events,
           each two ways (see Timer)
  path     at full width, f32, the same seeded weights on the CPU (plain
           versions) and on the card (kernels), a 200-token prompt and 8
           teacher-forced decode steps: qwen3-0.6b with 2 layers, and
           zamba2-7b with 7 (one super-block of 6 Mamba2 layers and the
           shared attention block, and one tail layer)
  serve    behind InferenceEngine with telemetry and mitigation, full width
           and depth, bf16, seeded weights: qwen3-0.6b serving 16 requests,
           then zamba2-7b serving 8
  control  the DPU closed loop of examples/serve_with_dpu_telemetry.py at
           full width: qwen3-0.6b (bf16, seeded weights) from static
           batching, telemetry over the modeled wire into the DPU sidecar,
           traced; held to the same loop on the CPU (every batch, report,
           sidecar report and incident equal); then alternating runs under
           dpu and instant control for the loop's host cost
  launch   python -m repro_torch.launch.serve on the card and with
           --device cpu: equal printed lines and reports
  quickstart  examples/quickstart.py's whole pipeline with the port: full-
           size llama3.2-3b (bf16, seeded weights) serves its ten requests
           with telemetry, held to the same run on the CPU; tp_straggler
           injected in the simulator, detected and attributed as the golden
           fixture says; hot_replica's loop off and on; the smoke sweep's
           gate and the golden fixture's smoke scenarios; the port's linter
           clean (its first line gives numpy's version)
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
import json
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
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
SSD_TOL = 2e-4      # the JAX package's own SSD scan tolerance
SSD_BUCKETS = (64, 128, 256, 512, 1024)   # the engine's prefill buckets

REPLACES = {
    "flash_attention": "src/repro/kernels/flash_attention.py:137",
    "paged_attention": "src/repro/kernels/paged_attention.py:128",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:88",
}
REPLACES_FN = {
    "flash_attention": "src/repro/kernels/flash_attention.py:"
                       "flash_attention_kernel",
    "paged_attention": "src/repro/kernels/paged_attention.py:"
                       "paged_attention_kernel",
    "ssd_scan": "src/repro/kernels/ssd_scan.py:ssd_scan_kernel",
}
SOURCE = {
    "flash_attention": "src/repro_torch/kernels/csrc/flash_attention.cu",
    "paged_attention": "src/repro_torch/kernels/csrc/paged_attention.cu",
    "ssd_scan": "src/repro_torch/kernels/csrc/ssd_scan.cu",
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
               dtype, time_it):
    from repro_torch.kernels.flash_attention import flash_attention_plain
    import torch.nn.functional as F
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device="cuda")
               .to(dt) for h in (hq, hkv, hkv))
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    want = flash_attention_plain(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    row = {"b": b, "s": s, "hq": hq, "hkv": hkv, "d": d, "window": window,
           "dtype": dtype, "max_abs_err": max_err(torch, got, want, dtype)}
    if dtype == "bfloat16":
        row["q_rows"] = flash_q_rows(torch, b, s, hq)
    if time_it:
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        timer.into(row, "", lambda: ops.flash_attention(q, k, v, causal=True))
        row["host_ms"] = timer.last_host_ms
        timer.into(row, "plain_", lambda: flash_attention_plain(
            q, k, v, causal=True), iters=5)
        timer.into(row, "library_", lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True))
        pairs = s * (s + 1) // 2
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
    flash[-1]["model"] = QUICKSTART_ARCH
    llama_lens = sorted(rng.randrange(9, 43) for _ in range(4))
    paged.append(paged_case(torch, ops, timer, gen, b=4, page=16, per_seq=8,
                            hq=24, hkv=8, d=128, lengths=llama_lens,
                            permute=False, dtype="bfloat16", time_it=True))
    paged[-1]["model"] = QUICKSTART_ARCH
    return {"flash_attention": flash, "paged_attention": paged,
            "ssd_scan": ssd}


# ----------------------------------------------------------------------
# phase 3: the model path, kernels on the card against plain on the CPU
# ----------------------------------------------------------------------

def kernel_launches(cfg, prefills: int, steps: int) -> dict[str, int]:
    """Launches one model's serving path must make: flash per attention
    layer (or shared-block application) and prefill, paged per attention
    layer and decode step, the SSD scan per Mamba2 layer and prefill."""
    if cfg.family == "hybrid":
        attn, mamba = cfg.n_layers // cfg.attn_every, cfg.n_layers
    else:
        attn, mamba = cfg.n_layers, 0
    return {"flash_attention": attn * prefills,
            "paged_attention": attn * steps, "ssd_scan": mamba * prefills}


def path_case(torch, ops, arch: str, n_layers: int) -> dict:
    """The same seeded f32 weights on the CPU (plain versions) and on the
    card (kernels): a 200-token prompt in the 256 bucket, then 8
    teacher-forced decode steps; logits must agree to 1e-3."""
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(ARCHS[arch], n_layers=n_layers,
                              dtype="float32",
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
    ops.reset_launch_counts()
    logits = {}
    for dev, m in models.items():
        cache = m.init_cache(1, 2048)
        out, cache = m.prefill(toks.to(dev), cache)
        steps = [out.float().cpu()]
        for t in forced:
            out, cache = m.decode_step(
                torch.tensor([t], dtype=torch.int32, device=dev), cache)
            steps.append(out.float().cpu())
        logits[dev] = torch.stack(steps)
    counts = ops.launch_counts()
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    check(bool(torch.isfinite(logits["cuda"]).all()), f"{arch} path "
          "logits not finite")
    check(err <= 1e-3, f"{arch} path logits differ from the CPU by {err} "
          "> 1e-3")
    want = kernel_launches(cfg, prefills=1, steps=len(forced))
    check(counts == want, f"{arch} path launches {counts}, want {want}")
    return {"model": arch, "layers": cfg.n_layers, "d_model": cfg.d_model,
            "dtype": cfg.dtype, "prompt": 200, "bucket": 256,
            "decode_steps": len(forced), "max_abs_logit_err": err,
            "launches": counts}


def phase_path(torch, ops) -> dict:
    cases = [path_case(torch, ops, "qwen3-0.6b", 2),
             # one super-block (6 Mamba2 layers + the shared block) and a
             # one-layer tail
             path_case(torch, ops, "zamba2-7b", 7)]
    torch.cuda.empty_cache()
    return {"cases": cases}


# ----------------------------------------------------------------------
# phase 4: serve each model at full size behind the engine
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
    its logits are all finite (read once, at the end of a run)."""
    def inner(*args):
        out = fn(*args)
        finite.append(torch.isfinite(out[0]).all())
        return out
    return inner


def serve_case(torch, ops, arch: str, lens: list[int], new_tokens: tuple,
               seed: int = 0) -> dict:
    from repro_torch.configs import ARCHS
    from repro_torch.models import build_model
    from repro_torch.serving import (EngineConfig, InferenceEngine,
                                     ServeRequest)
    cfg = ARCHS[arch]
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
    model.decode_step = checked(torch, model.decode_step, finite)
    eng._prefill = timed(eng._prefill, spent, calls, "prefill")
    eng._step = timed(eng._step, spent, calls, "decode")
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
    # where a decode step of all 8 slots and a 1024-token prefill spend
    # their time (after the run; these launches are not counted above)
    toks = torch.zeros((8, 1), dtype=torch.int32, device=model.device)
    prompt = torch.zeros((1, 1024), dtype=torch.int32, device=model.device)
    profiled = {
        "decode_step": profile_calls(
            torch, lambda: decode_step(toks, eng.slot_cache), 5),
        "prefill_1024": profile_calls(
            torch, lambda: prefill(prompt, model.init_cache(1, 2048)), 2)}
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
    del eng, model, prefill, decode_step
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


# ----------------------------------------------------------------------
# phase 5: the DPU closed loop at full width
# ----------------------------------------------------------------------

WALL_CLOCK = ("ns_per_event", "ns_per_event_by_detector")
# examples/serve_with_dpu_telemetry.py's engine
LOOP = dict(max_slots=4, max_seq=128, n_pages=256, telemetry=True,
            mitigate=True)


def example_requests(vocab: int) -> list:
    """The example's workload: 16 requests at t=0 with 8-token prompts, 200
    new tokens for every fourth (over max_seq 128: the ring wraps) and 4
    for the others."""
    from repro_torch.serving import ServeRequest
    rng = random.Random(7)
    return [ServeRequest(req_id=i, arrival=0.0,
                         prompt=[rng.randrange(vocab) for _ in range(8)],
                         max_new_tokens=200 if i % 4 == 0 else 4)
            for i in range(16)]


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
    counters and incidents) and one finite flag per model call."""
    from repro_torch.core.events import BATCH_COLUMNS
    from repro_torch.serving import EngineConfig, InferenceEngine
    eng = InferenceEngine(model, EngineConfig(**{**LOOP, **kw}))
    eng.sched.set_continuous(False)
    reqs = example_requests(model.cfg.vocab)
    spent = {"prefill": 0.0, "decode": 0.0, "flush": 0.0}
    calls = dict.fromkeys(spent, 0)
    eng._prefill = timed(eng._prefill, spent, calls, "prefill")
    eng._step = timed(eng._step, spent, calls, "decode")
    eng._flush_telemetry = timed(eng._flush_telemetry, spent, calls, "flush")
    sink, finite = [], []
    if observe:
        model.prefill = checked(torch, model.prefill, finite)
        model.decode_step = checked(torch, model.decode_step, finite)
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
        del model.prefill, model.decode_step
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
           "requests": len(example_requests(cfg.vocab)),
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
# phase 7: the quickstart's whole pipeline
# ----------------------------------------------------------------------

QUICKSTART_ARCH = "llama3.2-3b"
# examples/quickstart.py's engine
QUICKSTART_ENGINE = dict(max_slots=4, max_seq=128, n_pages=128, page_size=16)
GOLDEN = ROOT / "tests" / "golden" / "scenario_findings.json"
#: the golden fixture's seven metrics (tests/regen_golden.py)
GOLDEN_METRICS = {
    "completed": lambda m: m.completed, "tokens_out": lambda m: m.tokens_out,
    "first_finding_ts": lambda m: m.first_finding_ts,
    "p50_latency": lambda m: m.p(0.5), "p99_latency": lambda m: m.p(0.99),
    "p50_ttft": lambda m: m.p_ttft(0.5), "p99_ttft": lambda m: m.p_ttft(0.99)}


def quickstart_requests(vocab: int) -> list:
    """The quickstart's ten requests: 8-31 prompt tokens drawn from the
    whole vocabulary, 4-11 new tokens, one every 3 ms."""
    from repro_torch.serving import ServeRequest
    rng = random.Random(0)
    return [ServeRequest(
        req_id=i, arrival=i * 0.003,
        prompt=[rng.randrange(vocab) for _ in range(rng.randrange(8, 32))],
        max_new_tokens=rng.randrange(4, 12)) for i in range(10)]


def quickstart_serve(torch, model) -> dict:
    """Step 2: the ten requests through the quickstart's engine, with
    telemetry and mitigation; every decode step and prefill timed on the
    host clock, every model call's logits checked finite."""
    from repro_torch.serving import EngineConfig, InferenceEngine
    eng = InferenceEngine(model, EngineConfig(**QUICKSTART_ENGINE))
    reqs = quickstart_requests(model.cfg.vocab)
    spent = {"prefill": 0.0, "decode": 0.0}
    calls = dict.fromkeys(spent, 0)
    finite = []
    eng._prefill = timed(eng._prefill, spent, calls, "prefill")
    eng._step = timed(eng._step, spent, calls, "decode")
    model.prefill = checked(torch, model.prefill, finite)
    model.decode_step = checked(torch, model.decode_step, finite)
    t0 = time.perf_counter()
    rep = eng.run(reqs)
    wall = time.perf_counter() - t0
    del model.prefill, model.decode_step
    check(bool(torch.stack(finite).all()), f"quickstart on {model.device}: "
          "logits not finite")
    tel = rep["telemetry"]
    check(rep["completed"] == len(reqs), f"quickstart on {model.device}: "
          f"completed {rep['completed']} of {len(reqs)}")
    check(tel["findings"] == 0, f"quickstart on {model.device}: healthy "
          f"serve gave {tel['findings']} findings")
    prefills, steps = eng.stats["prefills"], rep["steps"]
    return {"report": without_wall_clock(rep), "prefills": prefills,
            "steps": steps, "tokens": rep["tokens"],
            "buckets": sorted({eng.sched.bucket_len(len(r.prompt))
                               for r in reqs}),
            "wall_s": wall,
            "ms_per_decode_step": spent["decode"] / steps * 1e3,
            "ms_per_prefill": spent["prefill"] / prefills * 1e3,
            "tokens_per_s_wall": rep["tokens"] / wall}


def golden_outcome(m, plane) -> dict:
    return {"findings": [[f.name, f.node, f.ts, f.severity, f.score]
                         for f in plane.findings],
            "metrics": {k: fn(m) for k, fn in GOLDEN_METRICS.items()}}


def quickstart_sim(golden: dict) -> dict:
    """Steps 3 and 4 on the port's simulator: tp_straggler detected and
    attributed as the golden fixture says, then hot_replica's loop off and
    on (the mitigated run acts, lowers p99 and completes no fewer)."""
    from repro_torch.sim import SCENARIOS, run_scenario
    t0 = time.perf_counter()
    sc = SCENARIOS["tp_straggler"]
    m, plane, _ = run_scenario(sc.fault, sc.params, sc.workload)
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
    sc = SCENARIOS["hot_replica"]
    runs = {}
    for mitigate in (False, True):
        m, plane, _ = run_scenario(dataclasses.replace(sc.fault), sc.params,
                                   sc.workload, mitigate=mitigate)
        runs[mitigate] = {"actions": [a.action for a in plane.actions],
                          "p99_latency": m.p(0.99),
                          "completed": m.completed}
    off, on = runs[False], runs[True]
    check(len(on["actions"]) >= 1, "hot_replica: the mitigated run took no "
          "action")
    check(on["p99_latency"] < off["p99_latency"], f"hot_replica: p99 "
          f"{off['p99_latency']} -> {on['p99_latency']} did not fall")
    check(on["completed"] >= off["completed"], f"hot_replica: completions "
          f"{off['completed']} -> {on['completed']} fell")
    return {"tp_straggler": straggler,
            "hot_replica": {"off": off, "on": on,
                            "seconds": time.perf_counter() - t0}}


def smoke_sweep(golden: dict) -> dict:
    """Step 5: ``python -m repro_torch.sim.sweep --smoke``'s grid in this
    process (one worker: a fork would copy the CUDA context) and its gate;
    then each smoke scenario's findings and metrics against the golden
    fixture, the cells' counts included."""
    from repro_torch.sim import SCENARIOS, SweepConfig, run_scenario, run_sweep
    from repro_torch.sim.sweep import SMOKE_SCENARIOS
    t0 = time.perf_counter()
    report = run_sweep(SweepConfig(scenarios=SMOKE_SCENARIOS, seeds=(0,),
                                   workers=1, trace=True))
    sweep_s = time.perf_counter() - t0
    problems = report.incident_problems()
    check(report.hit_rate() == 1.0, f"smoke sweep: hit rate "
          f"{report.hit_rate()}")
    check(report.false_positives() == 0, f"smoke sweep: "
          f"{report.false_positives()} false positives")
    check(not problems, f"smoke sweep: incident problems {problems}")
    t0 = time.perf_counter()
    for r in report.results:
        want = golden[r.scenario]
        counts: dict[str, int] = {}
        for f in want["findings"]:
            counts[f[0]] = counts.get(f[0], 0) + 1
        cell = {"findings": r.findings, "completed": r.completed,
                "tokens_out": r.tokens_out, "p99_latency": r.p99_latency,
                "p99_ttft": r.p99_ttft}
        check(cell == {"findings": counts, **{
            k: want["metrics"][k] for k in cell if k != "findings"}},
            f"smoke sweep: cell {r.scenario} differs from the golden fixture")
        sc = SCENARIOS[r.scenario]
        m, plane, _ = run_scenario(sc.fault, sc.params, sc.workload)
        check(golden_outcome(m, plane) == {k: want[k] for k in (
            "findings", "metrics")}, f"smoke scenario {r.scenario}: findings "
            "or metrics differ from the golden fixture")
    return {"scenarios": len(report.results), "hit_rate": report.hit_rate(),
            "false_positives": report.false_positives(),
            "incidents": sum(len(r.incidents) for r in report.results),
            "events": report.events, "sweep_s": sweep_s,
            "golden_s": time.perf_counter() - t0}


def phase_quickstart(torch, ops) -> dict:
    """examples/quickstart.py's four steps with the port, the model at full
    size on the card, then the smoke sweep and the port's linter."""
    import numpy
    from repro_torch.configs import ARCHS
    from repro_torch.lint import run_lint
    from repro_torch.models import build_model
    emit({"phase": "quickstart", "numpy": numpy.__version__,
          "started": True})
    cfg = ARCHS[QUICKSTART_ARCH]
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
    sweep = smoke_sweep(golden)
    t0 = time.perf_counter()
    lint = run_lint(ROOT)
    check(not lint.unsuppressed, "repro_torch.lint: "
          + "; ".join(f.format() for f in lint.unsuppressed))
    rep = card["report"]
    return {"numpy": numpy.__version__, "model": cfg.name,
            "layers": cfg.n_layers, "d_model": cfg.d_model,
            "heads": [cfg.n_heads, cfg.n_kv_heads], "d_ff": cfg.d_ff,
            "vocab": cfg.vocab, "dtype": cfg.dtype, "params": params,
            "init_s": init_s, "engine": QUICKSTART_ENGINE,
            "requests": len(quickstart_requests(cfg.vocab)),
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


PHASES = ("kernels", "path", "serve", "control", "launch", "quickstart")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated phases to run after the build "
                         f"(default: all of {', '.join(PHASES)}; the "
                         "kernels summary needs all)")
    ap.add_argument("--ssd-tree", metavar="SRC", type=Path,
                    help="only time the SSD scan of the package under SRC "
                         "(another tree's src/) at the prefill buckets")
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
    if "serve" in phases:
        t0 = time.perf_counter()
        serve = phase_serve(torch, ops)
        emit({"phase": "serve", "gpu": smi,
              "seconds": time.perf_counter() - t0, **serve})
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
    if tuple(phases) != PHASES:
        # a partial run proves nothing about the port: no "ok" line
        print(smi, flush=True)
        emit({"partial": phases, "device": device})
        return 0

    # launches on the main paths: each kernel's count summed over the
    # serve cases, the control loop and the quickstart's serve (each run's
    # counts were set to 0 just before it)
    launches = {name: sum(c["launches"][name]
                          for c in serve["cases"] + [control, quick])
                for name in kern}
    summary = []
    for name, rows in kern.items():
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
