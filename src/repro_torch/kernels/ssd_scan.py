"""Mamba2 SSD chunk scan on Hopper: the prefill kernel's wrapper, its
host-side plan and its plain PyTorch version.

``ssd_scan_cuda`` launches ``csrc/ssd_scan.cu``: the reference's four steps
as three CUDA kernels on one stream (two for a single chunk), every chunk
and head in parallel: each chunk's cumulative decay and own state, with
C B^T once per batch and chunk; the short recurrence across chunks; the
outputs.  ``ssd_plan`` picks the heads per CTA and the p split from the
shape and the SM count alone.  ``ssd_scan_plain`` is the same function in
plain PyTorch: the JAX model's chunked form (``ssd_chunked``) with its sum
order, padding a ragged length to whole chunks as ``mamba2_fwd`` does.
Both take an initial state and return the final one, which
prefill-with-state needs.  Callers go through ``ops.ssd_scan``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import build

CHUNK = 128       # steps per chunk: the kernel's compile-time tile
MAX_DIM = 64      # head dim p and state dim n: shared-memory tiles
SCAN_BLOCK = 16   # block of the reference's cumulative sum (see _cumsum)
MAX_HEADS = 4     # heads per CTA of the output pass
CB_FLOATS = 36 * 256  # one chunk's C B^T, as the output pass's threads hold it


def check_ssd_args(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, init_state: torch.Tensor | None = None,
                   chunk: int = CHUNK) -> None:
    """Raise on anything the kernel does not take."""
    if x.dim() != 4 or a.dim() != 3 or B.dim() != 3 or C.shape != B.shape:
        raise ValueError(f"need x (b,l,h,p), a (b,l,h), B/C (b,l,n); got "
                         f"{tuple(x.shape)}, {tuple(a.shape)}, "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    b, l, h, p = x.shape
    n = B.shape[-1]
    if tuple(a.shape) != (b, l, h) or tuple(B.shape[:2]) != (b, l):
        raise ValueError(f"x {tuple(x.shape)}, a {tuple(a.shape)} and B "
                         f"{tuple(B.shape)} differ in batch, length or "
                         "heads")
    if init_state is not None and tuple(init_state.shape) != (b, h, p, n):
        raise ValueError(f"init_state {tuple(init_state.shape)}, need "
                         f"{(b, h, p, n)}")
    for name, dim in (("head dim p", p), ("state dim n", n)):
        if dim % 4 or not 0 < dim <= MAX_DIM:
            raise ValueError(f"{name} {dim} unsupported: need a multiple "
                             f"of 4, at most {MAX_DIM}")
    if chunk != CHUNK:
        raise ValueError(f"chunk {chunk} unsupported: the kernel scans "
                         f"chunks of {CHUNK}")
    tensors = [x, a, B, C] + ([init_state] if init_state is not None
                              else [])
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("SSD scan inputs must be float32; got "
                        f"{[str(t.dtype) for t in tensors]}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("SSD scan inputs on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("SSD scan inputs must be contiguous")


# ----------------------------------------------------------------------
# plain version: the JAX model's ssd_chunked
# ----------------------------------------------------------------------

def _cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive f32 cumulative sum over the last axis, with the additions
    in the order the JAX reference makes them on the CPU: XLA rewrites a
    long cumulative sum into blocks of 16 summed in sequence, plus the
    exclusive cumulative sum of the block totals (the same rule, again).

    The order matters: a decay's segment sum exp(cs_i - cs_j) is a
    difference of two cumulative sums that reach -1e3 within a chunk, so
    one rounding of cs moves the factor by ~1e-4.  The CUDA kernel adds in
    this order too (``torch.cumsum`` adds in another, in f64 on the CPU)."""
    n = x.shape[-1]
    if n <= SCAN_BLOCK:
        acc = x[..., 0]
        out = [acc]
        for i in range(1, n):
            acc = acc + x[..., i]
            out.append(acc)
        return torch.stack(out, dim=-1)
    pad = (-n) % SCAN_BLOCK
    xp = torch.nn.functional.pad(x, (0, pad))
    inner = _cumsum(xp.reshape(*x.shape[:-1], -1, SCAN_BLOCK))
    outer = _cumsum(inner[..., -1])
    excl = torch.nn.functional.pad(outer[..., :-1], (1, 0))
    return (inner + excl[..., None]).reshape(xp.shape)[..., :n]


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x: (..., T) -> (..., T, T) lower-triangular segment sums, -inf above
    the diagonal (masked before any exp)."""
    t = x.shape[-1]
    csum = _cumsum(x)
    s = csum[..., :, None] - csum[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))
    return s.masked_fill(~mask, -torch.inf)


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                C: torch.Tensor, chunk: int,
                init_state: torch.Tensor | None = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Minimal SSD over whole chunks (l a multiple of ``chunk``).

    x: (b, l, h, p) per-head inputs (dt folded in); a: (b, l, h) log-decay;
    B/C: (b, l, n) shared across heads.  Returns y (b, l, h, p) and the
    final state (b, h, p, n).
    """
    b, l, h, p = x.shape
    n = B.shape[-1]
    nc = l // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    ac = a.reshape(b, nc, chunk, h).permute(0, 3, 1, 2)        # (b,h,c,L)
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)

    a_cum = _cumsum(ac)                                         # (b,h,c,L)
    # 1) intra-chunk (diagonal blocks)
    Lmat = torch.exp(_segsum(ac))                               # (b,h,c,L,L)
    scores = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", scores[:, None] * Lmat, xc)
    # 2) per-chunk final states
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)           # (b,h,c,L)
    states = torch.einsum("bhcln,bclhp->bchpn",
                          Bc[:, None] * decay_states[..., None], xc)
    # 3) inter-chunk recurrence over chunks
    chunk_decay = torch.exp(a_cum[..., -1])                     # (b,h,c)
    carry = (init_state if init_state is not None
             else x.new_zeros((b, h, p, n)))
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, :, c, None, None] + states[:, c]
    prev = torch.stack(prev, dim=1)                             # (b,c,h,p,n)
    # 4) inter-chunk contribution to outputs
    out_decay = torch.exp(a_cum).permute(0, 2, 3, 1)            # (b,c,L,h)
    y_off = torch.einsum("bcln,bchpn->bclhp", Cc, prev) \
        * out_decay[..., None]
    y = (y_diag + y_off).reshape(b, l, h, p)
    return y, carry


def ssd_scan_plain(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, init_state: torch.Tensor | None = None,
                   chunk: int = CHUNK) -> tuple[torch.Tensor, torch.Tensor]:
    """``ssd_chunked`` on any length: pads to whole chunks with a = 0 and
    x = 0 (the state passes through padded steps unchanged), then cuts y
    back to l.  Returns y (b, l, h, p) and the final state (b, h, p, n)."""
    l = x.shape[1]
    pad = (-l) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        a = torch.nn.functional.pad(a, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, pad))
    y, final = ssd_chunked(x, a, B, C, chunk, init_state)
    return y[:, :l], final


# ----------------------------------------------------------------------
# the CUDA kernel
# ----------------------------------------------------------------------

@dataclass(frozen=True)
class SsdPlan:
    """How the output pass cuts the work: one CTA per (batch, chunk, group
    of ``heads`` heads, part of p), p cut into ``split`` equal parts."""
    heads: int
    split: int


SETUP = 0.5  # a CTA's set-up (its chunk's C, C B^T and cs), in heads


@functools.lru_cache(maxsize=64)
def ssd_plan(b: int, l: int, h: int, p: int, sms: int) -> SsdPlan:
    """The plan from the shape and the SM count alone.  The output pass
    runs one CTA per SM at a time, so a plan costs the busiest SM's waves
    of CTAs times what one CTA does: its heads, over the p split, plus its
    set-up.  The cheapest plan wins; among equals, p whole and more heads
    per CTA (the chunk's C and C B^T loaded for more heads)."""
    chunks = -(-l // CHUNK)
    best = None
    for split in (1, 2):
        if p % (4 * split):
            continue
        for heads in (MAX_HEADS, 2, 1):
            ctas = b * chunks * -(-h // heads) * split
            cost = -(-ctas // sms) * (heads / split + SETUP)
            if best is None or cost < best[0]:
                best = (cost, SsdPlan(heads, split))
    return best[1]


_sm_counts: dict[int, int] = {}


def _sm_count(index: int) -> int:
    n = _sm_counts.get(index)
    if n is None:
        n = torch.cuda.get_device_properties(index).multi_processor_count
        _sm_counts[index] = n
    return n


def _library() -> ctypes.CDLL:
    lib = build.library("ssd_scan")
    fn = lib.repro_ssd_scan
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def ssd_scan_cuda(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                  C: torch.Tensor, init_state: torch.Tensor | None = None,
                  chunk: int = CHUNK) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA kernels on the current stream; never synchronises.
    One call counts as one launch (it starts three CUDA kernels, two
    for a single chunk).

    x: (b, l, h, p); a: (b, l, h); B/C: (b, l, n); init_state (b, h, p, n)
    or None for zeros; all f32 -> y (b, l, h, p), final state (b, h, p, n).
    """
    check_ssd_args(x, a, B, C, init_state, chunk)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan_cuda needs CUDA tensors, got "
                         f"{x.device}")
    tensors = (x, B, C) if init_state is None else (x, B, C, init_state)
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("SSD scan x, B, C and init_state must be 16-byte "
                         "aligned (the kernel copies 16 bytes at a time)")
    b, l, h, p = x.shape
    n = B.shape[-1]
    y = torch.empty_like(x)
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if final.numel() == 0:
        return y, final
    index = x.device.index
    plan = ssd_plan(b, l, h, p, _sm_count(index))
    chunks = -(-l // CHUNK)
    # scratch, one allocation: each chunk's state as S^T (then the state
    # before it), each chunk's cumulative log-decay, each chunk's C B^T;
    # every part a multiple of 16 bytes
    sizes = (b * chunks * h * n * p, b * chunks * h * CHUNK,
             b * chunks * CB_FLOATS)
    scratch = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    states = scratch.data_ptr()
    cs = states + 4 * sizes[0]
    cb = cs + 4 * sizes[1]
    # a device guard as torch.cuda.device is, at a third of its host cost
    with torch.cuda._DeviceGuard(index):
        fn = _library().repro_ssd_scan
        status = fn(x.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(),
                    None if init_state is None else init_state.data_ptr(),
                    y.data_ptr(), final.data_ptr(), states, cs, cb, b, l, h,
                    p, n, plan.heads, plan.split,
                    build.current_stream(index))
    if status != 0:
        raise RuntimeError(f"SSD scan kernel launch failed: CUDA error "
                           f"{status}")
    ssd_scan_cuda.launches += 1
    return y, final


ssd_scan_cuda.launches = 0
