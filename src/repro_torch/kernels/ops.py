"""Entry points for the kernels: one decision, made by where the tensors
lie.

A CUDA tensor goes to the hand-written Hopper kernel, which launches or
raises.  A CPU tensor goes to the kernel's plain PyTorch version.  There is
no fallback from one to the other.  A meta tensor (the dry-run's shapes,
no data) goes to the plain version too: asking for ``meta`` is asking for
shapes and op counts, not for a fallback; any other device raises.  Both
sides check their arguments the same way (the CUDA wrapper checks its own,
once, as it is on the decode step's host-bound path), so the CPU tests hold
the model to what the kernels take.

The SSD scan is differentiable: ``ssd_scan`` goes through one
``torch.autograd.Function`` whose forward and backward are the two CUDA
kernels for CUDA tensors and the two plain versions for CPU tensors.  B/C
groups and a state wider than the kernel's tile take the same kernels,
exactly by linearity (``ssd_scan``): each group's heads become a batch row
of their own, and the state's columns split into parts of at most
``MAX_DIM``, whose outputs add.  Flash
and paged attention have no backward kernel: on the card they raise when
asked to record a gradient, rather than give one without the attention.

``meta_region``, when the dry-run's op counter sets it, wraps each call on
meta tensors: the counter books the kernel's bytes (its inputs read once,
its outputs written once) rather than the plain version's intermediates.

``launch_counts`` reads how many times each kernel was launched, and
``reset_launch_counts`` sets them to zero, so a run can show that its path
went through the kernels; ``add_launch_counts`` books the launches of a
replayed CUDA graph, which calls no wrapper.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import (
    check_flash_args,
    flash_attention_cuda,
    flash_attention_plain,
)
from repro_torch.kernels.paged_attention import (
    check_paged_args,
    paged_attention_cuda,
    paged_attention_plain,
)
from repro_torch.kernels.ssd_scan import (
    CHUNK,
    MAX_DIM,
    check_ssd_args,
    check_ssd_bwd_args,
    ssd_scan_bwd_cuda,
    ssd_scan_bwd_plain,
    ssd_scan_cuda,
    ssd_scan_plain,
)

KERNELS = {"flash_attention": flash_attention_cuda,
           "paged_attention": paged_attention_cuda,
           "ssd_scan": ssd_scan_cuda,
           "ssd_scan_bwd": ssd_scan_bwd_cuda}


# set by launch.dryrun's counter: name, input tensors -> a context manager
# yielding a callback that takes the outputs
meta_region = None


def _plain(name: str, inputs: tuple, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, inside ``meta_region`` on meta tensors."""
    if meta_region is None or inputs[0].device.type != "meta":
        return fn(*args, **kwargs)
    with meta_region(name, inputs) as done:
        out = fn(*args, **kwargs)
        done(out)
    return out


def _refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """A kernel without a backward must not drop its term from a gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{name} has no backward kernel: its CUDA path "
                           "cannot record a gradient (call it under "
                           "torch.no_grad(), or train through sdpa)")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D)."""
    if q.device.type == "cuda":
        _refuse_grad("flash attention", q, k, v)
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    check_flash_args(q, k, v)
    if q.device.type in ("cpu", "meta"):
        return _plain("flash_attention", (q, k, v), flash_attention_plain,
                      q, k, v, causal=causal, window=window)
    raise ValueError(f"no flash attention for device {q.device}")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_table: torch.Tensor,
                    lengths: torch.Tensor, return_lse: bool = False):
    """q: (B, Hq, D); k/v_pages: (P, page, Hkv, D); block_table
    (B, per_seq) int32; lengths (B,) int32 -> (B, Hq, D), and with
    ``return_lse`` each head's log-sum-exp of its scaled scores (B, Hq) f32
    (-inf at length 0), by which slices of one sequence merge."""
    if q.device.type == "cuda":
        _refuse_grad("paged attention", q, k_pages, v_pages)
        return paged_attention_cuda(q, k_pages, v_pages, block_table,
                                    lengths, return_lse)
    check_paged_args(q, k_pages, v_pages, block_table, lengths)
    if q.device.type in ("cpu", "meta"):
        return _plain("paged_attention", (q, k_pages, v_pages, block_table,
                                          lengths), paged_attention_plain,
                      q, k_pages, v_pages, block_table, lengths, return_lse)
    raise ValueError(f"no paged attention for device {q.device}")


class SsdScan(torch.autograd.Function):
    """(y, final) = SSD(x, a, B, C, init_state) with its backward; both
    halves run on the inputs' device (kernels on the card, plain versions
    on the CPU).  The forward keeps its scratch (the state before each
    chunk, each chunk's cumulative decay and C B^T) for the backward, which
    then runs no forward pass; under activation checkpointing the scratch
    is made again with the layer's recomputed forward.  An unused final
    state passes no gradient (None) to the backward."""

    @staticmethod
    def forward(ctx, x, a, B, C, init_state, chunk):
        fwd = ssd_scan_cuda if x.device.type == "cuda" else ssd_scan_plain
        ctx.set_materialize_grads(False)
        y, final, scratch = _plain("ssd_scan", (x, a, B, C), fwd, x, a, B,
                                   C, init_state, chunk, keep_scratch=True)
        ctx.save_for_backward(x, a, B, C, init_state, scratch)
        ctx.chunk = chunk
        return y, final

    @staticmethod
    def backward(ctx, dy, dfinal):
        x, a, B, C, init_state, scratch = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if dfinal is not None:
            dfinal = dfinal.contiguous()
        if x.device.type == "cuda":
            grads = ssd_scan_bwd_cuda(x, a, B, C, init_state, dy, dfinal,
                                      ctx.chunk, scratch=scratch)
        else:
            check_ssd_bwd_args(x, dy, dfinal)
            grads = _plain("ssd_scan_bwd", (x, a, B, C, dy),
                           ssd_scan_bwd_plain, x, a, B, C, init_state, dy,
                           dfinal, ctx.chunk, scratch=scratch)
        return (*grads, None)


def ssd_scan(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, init_state: torch.Tensor | None = None,
             chunk: int = CHUNK) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (b, l, h, p); a: (b, l, h) log-decay; B/C: (b, l, n), or (b, l,
    G, n) with head i reading group i // (h / G); init_state (b, h, p, n)
    or None; all f32 -> y (b, l, h, p), final state (b, h, p, n),
    differentiable in every input."""
    if x.device.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"no SSD scan for device {x.device}")
    if B.dim() == 4 or B.shape[-1] > MAX_DIM:
        return _ssd_grouped(x, a, B, C, init_state, chunk)
    if x.device.type != "cuda":
        check_ssd_args(x, a, B, C, init_state, chunk)
    return SsdScan.apply(x, a, B, C, init_state, chunk)


def _ssd_grouped(x, a, B, C, init_state, chunk):
    """``ssd_scan`` with G B/C groups or a state n > ``MAX_DIM``, through
    the one-group kernel: group g's h / G heads form batch row (b, g), and
    n splits into equal parts of at most ``MAX_DIM`` columns; the parts'
    outputs add and their final states join."""
    b, l, h, p = x.shape
    if B.dim() == 3:
        B, C = B[:, :, None], C[:, :, None]
    g, n = B.shape[2:]
    parts = -(-n // MAX_DIM)
    if h % g or n % parts:
        raise ValueError(f"{h} heads over {g} B/C groups, state {n} in "
                         f"{parts} parts: need whole heads and columns")
    hg, w = h // g, n // parts

    def rows(t):      # (b, l, g, ...) -> (b g, l, ...)
        return t.transpose(1, 2).reshape(b * g, l, *t.shape[3:]).contiguous()

    xg = rows(x.reshape(b, l, g, hg, p))
    ag = rows(a.reshape(b, l, g, hg))
    Bg, Cg = rows(B), rows(C)
    sg = None if init_state is None else init_state.reshape(b * g, hg, p, n)
    y, finals = 0, []
    for i in range(parts):
        cols = slice(i * w, (i + 1) * w)
        yi, fi = ssd_scan(xg, ag, Bg[..., cols].contiguous(),
                          Cg[..., cols].contiguous(),
                          None if sg is None else sg[..., cols].contiguous(),
                          chunk)
        y = y + yi
        finals.append(fi)
    y = y.reshape(b, g, l, hg, p).transpose(1, 2).reshape(b, l, h, p)
    return y, torch.cat(finals, dim=-1).reshape(b, h, p, n)


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def add_launch_counts(counts: dict[str, int]) -> None:
    """Add ``counts`` (launches by kernel name, negative to take back) to
    the launch counts."""
    for name, n in counts.items():
        KERNELS[name].launches += n
