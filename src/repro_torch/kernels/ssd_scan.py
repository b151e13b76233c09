"""Mamba2 SSD chunk scan on Hopper: the prefill kernel's wrapper, its
host-side plan and its plain PyTorch version, and the same for its
backward.

``ssd_scan_cuda`` launches ``csrc/ssd_scan.cu``: the reference's four steps
as three CUDA kernels on one stream (two for a single chunk), every chunk
and head in parallel: each chunk's cumulative decay and own state, with
C B^T once per batch and chunk; the short recurrence across chunks; the
outputs.  ``ssd_plan`` picks the heads per CTA and the p split from the
shape and the SM count alone.  ``ssd_scan_plain`` is the same function in
plain PyTorch: the JAX model's chunked form (``ssd_chunked``) with its sum
order, padding a ragged length to whole chunks as ``mamba2_fwd`` does.
Both take an initial state and return the final one, which
prefill-with-state needs; with ``keep_scratch`` both also return the
forward's scratch (the state before each chunk, each chunk's cumulative
decay and C B^T, in the kernels' layouts: ``scratch_views``).

``ssd_scan_bwd_cuda`` launches ``csrc/ssd_scan_bwd.cu`` on that scratch,
kept from the forward, or, given none, after running the forward's first
two passes again.  ``ssd_bwd_plan`` picks its heads per CTA from the shape
and the SM count.  ``ssd_scan_bwd_plain`` computes the same gradients in
plain PyTorch, pass by pass as the kernels do, from the scratch of
``ssd_scratch_plain`` or recomputing it.  Callers go through
``ops.ssd_scan``, whose ``torch.autograd.Function`` runs the forward and
the backward of one device and hands the forward's scratch to the backward.
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
                   chunk: int = CHUNK, keep_scratch: bool = False):
    """``ssd_chunked`` on any length: pads to whole chunks with a = 0 and
    x = 0 (the state passes through padded steps unchanged), then cuts y
    back to l.  Returns y (b, l, h, p) and the final state (b, h, p, n),
    and with ``keep_scratch`` also ``ssd_scratch_plain``'s scratch."""
    l = x.shape[1]
    xp, ap, Bp, Cp = _pad_chunks(chunk, x, a, B, C)
    y, final = ssd_chunked(xp, ap, Bp, Cp, chunk, init_state)
    if keep_scratch:
        return y[:, :l], final, ssd_scratch_plain(x, a, B, C, init_state,
                                                  chunk)
    return y[:, :l], final


def _pad_chunks(chunk: int, *tensors: torch.Tensor) -> list[torch.Tensor]:
    """Pad each tensor's axis 1 (the steps) to whole chunks with zeros."""
    pad = (-tensors[0].shape[1]) % chunk
    if not pad:
        return list(tensors)
    return [torch.nn.functional.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
            for t in tensors]


def _reverse_cumsum(x: torch.Tensor) -> torch.Tensor:
    """out[..., t] = sum of x[..., i] for i >= t, over the last axis."""
    return x.flip(-1).cumsum(-1).flip(-1)


# C B^T of a chunk as the kernels keep it: pair (r, q <= r) of thread (ty,
# tx) of a 16 x 16 layout holds C_i . B_j for i = ty + 16 r, j = tx + 16 q,
# at (r (r + 1) / 2 + q) * 256 + 16 ty + tx; pairs q > r (j > i) are not kept
CB_PAIRS = [(r, q) for r in range(8) for q in range(r + 1)]


def _pack_cb(cb: torch.Tensor) -> torch.Tensor:
    """(b, c, 128, 128) -> (b, c, CB_FLOATS) in the kernels' order."""
    b, c = cb.shape[:2]
    t = cb.reshape(b, c, 8, 16, 8, 16).permute(0, 1, 2, 4, 3, 5)
    r, q = (torch.tensor(v, device=cb.device) for v in zip(*CB_PAIRS))
    return t[:, :, r, q].reshape(b, c, CB_FLOATS)


def _unpack_cb(packed: torch.Tensor) -> torch.Tensor:
    """(b, c, CB_FLOATS) -> (b, c, 128, 128), zero where j // 16 > i // 16
    (masked by every use: j > i)."""
    b, c = packed.shape[:2]
    t = packed.new_zeros((b, c, 8, 8, 16, 16))
    r, q = (torch.tensor(v, device=packed.device) for v in zip(*CB_PAIRS))
    t[:, :, r, q] = packed.reshape(b, c, len(CB_PAIRS), 16, 16)
    return t.permute(0, 1, 2, 4, 3, 5).reshape(b, c, CHUNK, CHUNK)


def scratch_sizes(b: int, l: int, h: int, p: int, n: int
                  ) -> tuple[int, int, int]:
    """Floats of the forward's scratch parts: the states (b, chunks, h, n,
    p), the cumulative decays (b, chunks, h, 128), C B^T (b, chunks,
    CB_FLOATS); each a multiple of 16 bytes."""
    chunks = -(-l // CHUNK)
    return (b * chunks * h * n * p, b * chunks * h * CHUNK,
            b * chunks * CB_FLOATS)


def scratch_views(scratch: torch.Tensor, b: int, l: int, h: int, p: int,
                  n: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The forward's scratch as (prev, cs, cb): the state before each chunk
    as S^T (b, chunks, h, n, p), each chunk's cumulative log-decay (b,
    chunks, h, 128) and each chunk's C B^T (b, chunks, CB_FLOATS)."""
    sizes = scratch_sizes(b, l, h, p, n)
    if (scratch.dim() != 1 or scratch.numel() != sum(sizes)
            or scratch.dtype != torch.float32):
        raise ValueError(f"SSD scratch {tuple(scratch.shape)} "
                         f"{scratch.dtype}, need ({sum(sizes)},) float32 "
                         f"for {(b, l, h, p, n)}")
    chunks = -(-l // CHUNK)
    prev, cs, cb = scratch.split(sizes)
    return (prev.view(b, chunks, h, n, p), cs.view(b, chunks, h, CHUNK),
            cb.view(b, chunks, CB_FLOATS))


def _chunked(chunk: int, x, a, B, C, *more):
    """Padded to whole chunks and cut into them: x and the ``more`` (b, c,
    L, h, p), a (b, h, c, L), B and C (b, c, L, n)."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    xp, ap, Bp, Cp, *mp = _pad_chunks(chunk, x, a, B, C, *more)
    nc = xp.shape[1] // chunk
    return ([xp.reshape(b, nc, chunk, h, p),
             ap.reshape(b, nc, chunk, h).permute(0, 3, 1, 2),
             Bp.reshape(b, nc, chunk, n), Cp.reshape(b, nc, chunk, n)]
            + [t.reshape(b, nc, chunk, h, p) for t in mp])


def _states_before(xc: torch.Tensor, Bc: torch.Tensor, cs: torch.Tensor,
                   init_state: torch.Tensor | None) -> torch.Tensor:
    """The state before each chunk (b, c, h, p, n), from each chunk's own
    state x^T (B w), w = exp(total - cs), carried across the chunks."""
    b, nc, _, h, p = xc.shape
    n = Bc.shape[-1]
    total = cs[..., -1]                                          # (b,h,c)
    w = torch.exp(total[..., None] - cs)
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, w, xc)
    carry = (init_state if init_state is not None
             else xc.new_zeros((b, h, p, n)))
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * torch.exp(total[:, :, c, None, None]) + states[:, c]
    return torch.stack(prev, dim=1)


def ssd_scratch_plain(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                      C: torch.Tensor, init_state: torch.Tensor | None = None,
                      chunk: int = CHUNK) -> torch.Tensor:
    """The forward's scratch that the backward reads, in the kernels'
    layout (``scratch_views``), computed as ``ssd_scan_bwd_plain`` computes
    it when it is given none."""
    xc, ac, Bc, Cc = _chunked(chunk, x, a, B, C)
    cs = _cumsum(ac)                                             # (b,h,c,L)
    prev = _states_before(xc, Bc, cs, init_state)
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    return torch.cat([prev.transpose(-1, -2).reshape(-1),
                      cs.permute(0, 2, 1, 3).reshape(-1),
                      _pack_cb(cb).reshape(-1)])


def ssd_scan_bwd_plain(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                       C: torch.Tensor, init_state: torch.Tensor | None,
                       dy: torch.Tensor, dfinal: torch.Tensor | None,
                       chunk: int = CHUNK,
                       scratch: torch.Tensor | None = None):
    """Gradients of ``ssd_scan_plain``'s (y, final) with respect to (x, a,
    B, C, init_state), given dy (b, l, h, p) and dfinal (b, h, p, n) or
    None (the final state unused), and the forward's scratch or None (then
    it is computed again).  Returns (dx, da, dB, dC, dinit); dinit is None
    without an initial state.

    The steps of ``csrc/ssd_scan_bwd.cu`` (its first kernel takes steps 1
    and 2, its second step 3, its third step 4), each here over every chunk
    and head at once, with cs the chunk's cumulative log-decay, w =
    exp(total - cs), prev_c the state before chunk c and G[i, j] = (C_i .
    B_j) exp(cs_i - cs_j) for j <= i:
      0. the forward's cs, prev and C B^T: its scratch, or again;
      1. each chunk's own gradient of the state before it, from its
         outputs: loc_c = (dy exp(cs))^T C;
      2. the recurrence across chunks in reverse: dS_c (the gradient of
         the state after chunk c) = g, then g = loc_c + g exp(total_c),
         from g = dfinal; the last g is dinit;
      3. per chunk and head: dx = G^T dy + w (B dS^T); dscore = (dy x^T)
         exp(segsum); dC_h = dscore B + exp(cs) (dy prev); dB_h = dscore^T
         C + w (x dS); the gradient of cs, which a reverse cumulative sum
         within the chunk turns into da;
      4. dB and dC summed over the heads."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    L = chunk
    xc, ac, Bc, Cc, dyc = _chunked(L, x, a, B, C, dy)
    nc = xc.shape[1]

    # 0) the forward's cumulative decay, the state before each chunk and
    #    C B^T
    if scratch is None:
        cs = _cumsum(ac)                                         # (b,h,c,L)
        prev = _states_before(xc, Bc, cs, init_state)            # (b,c,h,p,n)
        cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    else:
        prev_t, cs, cb = scratch_views(scratch, b, l, h, p, n)
        prev = prev_t.transpose(-1, -2)
        cs = cs.permute(0, 2, 1, 3)
        cb = _unpack_cb(cb)
    total = cs[..., -1]                                          # (b,h,c)
    w = torch.exp(total[..., None] - cs)
    ecs = torch.exp(cs)

    # 1) each chunk's own gradient of the state before it
    loc = torch.einsum("bclhp,bhcl,bcln->bchpn", dyc, ecs, Cc)
    # 2) the recurrence across chunks, in reverse
    g = dfinal if dfinal is not None else x.new_zeros((b, h, p, n))
    dS = [None] * nc
    for c in reversed(range(nc)):
        dS[c] = g
        g = loc[:, c] + g * torch.exp(total[:, :, c, None, None])
    dS = torch.stack(dS, dim=1)                                  # (b,c,h,p,n)
    dinit = g if init_state is not None else None

    # 3) each chunk and head
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool, device=x.device))
    seg = (cs[..., :, None] - cs[..., None, :]).masked_fill(~tri, -torch.inf)
    E = torch.exp(seg)                                           # (b,h,c,L,L)
    cb = cb[:, None]                                             # (b,1,c,L,L)
    G = cb * E
    dscore = torch.einsum("bcihp,bcjhp->bhcij", dyc, xc) * E
    M = dscore * cb                         # dG * G: d(cs_i - cs_j) terms
    dx = (torch.einsum("bhcij,bcihp->bcjhp", G, dyc)
          + torch.einsum("bhcj,bcjn,bchpn->bcjhp", w, Bc, dS))
    U = torch.einsum("bcihp,bchpn->bcihn", dyc, prev)
    V = torch.einsum("bcjhp,bchpn->bcjhn", xc, dS)
    ecs_t = ecs.permute(0, 2, 3, 1)[..., None]                   # (b,c,L,h,1)
    w_t = w.permute(0, 2, 3, 1)[..., None]
    dC_h = torch.einsum("bhcij,bcjn->bcihn", dscore, Bc) + ecs_t * U
    dB_h = torch.einsum("bhcij,bcin->bcjhn", dscore, Cc) + w_t * V
    wdw = w * torch.einsum("bcjn,bcjhn->bhcj", Bc, V)
    dcs = (M.sum(-1) - M.sum(-2)
           + ecs * torch.einsum("bcin,bcihn->bhci", Cc, U) - wdw)
    dcs[..., -1] += wdw.sum(-1) + torch.exp(total) * torch.einsum(
        "bchpn,bchpn->bhc", dS, prev)
    da = _reverse_cumsum(dcs).permute(0, 2, 3, 1).reshape(b, nc * L, h)

    # 4) dB and dC over the heads
    dB = dB_h.sum(dim=3).reshape(b, nc * L, n)
    dC = dC_h.sum(dim=3).reshape(b, nc * L, n)
    return (dx.reshape(b, nc * L, h, p)[:, :l], da[:, :l], dB[:, :l],
            dC[:, :l], dinit)


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


def _bwd_library() -> ctypes.CDLL:
    lib = build.library("ssd_scan_bwd")
    fn = lib.repro_ssd_scan_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check_cuda(x: torch.Tensor, *tensors: torch.Tensor | None) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the SSD scan kernels need CUDA tensors, got "
                         f"{x.device}")
    if any(t is not None and t.data_ptr() % 16 for t in (x,) + tensors):
        raise ValueError("SSD scan x, B, C, the states and dy must be "
                         "16-byte aligned (the kernels copy 16 bytes at a "
                         "time)")


def _forward(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, init_state: torch.Tensor | None,
             y: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """Run ``csrc/ssd_scan.cu`` on the current stream: all three passes
    into ``y``, or, with ``y`` None, the first two alone.  Returns the final
    state (b, h, p, n) and the scratch (``scratch_views``): after the
    passes, the state before each chunk, each chunk's cumulative log-decay
    and its C B^T."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    final = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    index = x.device.index
    plan = ssd_plan(b, l, h, p, _sm_count(index))
    # one allocation: each chunk's state as S^T (then the state before it),
    # each chunk's cumulative log-decay, each chunk's C B^T
    sizes = scratch_sizes(b, l, h, p, n)
    scratch = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    states = scratch.data_ptr()
    cs = states + 4 * sizes[0]
    cb = cs + 4 * sizes[1]
    # a device guard as torch.cuda.device is, at a third of its host cost
    with torch.cuda._DeviceGuard(index):
        fn = _library().repro_ssd_scan
        status = fn(x.data_ptr(), a.data_ptr(), B.data_ptr(), C.data_ptr(),
                    None if init_state is None else init_state.data_ptr(),
                    None if y is None else y.data_ptr(), final.data_ptr(),
                    states, cs, cb, b, l, h, p, n, plan.heads, plan.split,
                    build.current_stream(index))
    if status != 0:
        raise RuntimeError(f"SSD scan kernel launch failed: CUDA error "
                           f"{status}")
    return final, scratch


def ssd_scan_cuda(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                  C: torch.Tensor, init_state: torch.Tensor | None = None,
                  chunk: int = CHUNK, keep_scratch: bool = False):
    """Launch the CUDA kernels on the current stream; never synchronises.
    One call counts as one launch (it starts three CUDA kernels, two
    for a single chunk).

    x: (b, l, h, p); a: (b, l, h); B/C: (b, l, n); init_state (b, h, p, n)
    or None for zeros; all f32 -> y (b, l, h, p), final state (b, h, p, n),
    and with ``keep_scratch`` the forward's scratch for the backward.
    """
    check_ssd_args(x, a, B, C, init_state, chunk)
    _check_cuda(x, B, C, init_state)
    b, l, h, p = x.shape
    n = B.shape[-1]
    y = torch.empty_like(x)
    if b * h * p * n == 0:
        final = torch.empty((b, h, p, n), dtype=torch.float32,
                            device=x.device)
        scratch = x.new_empty(0)
    else:
        final, scratch = _forward(x, a, B, C, init_state, y)
        ssd_scan_cuda.launches += 1
    return (y, final, scratch) if keep_scratch else (y, final)


ssd_scan_cuda.launches = 0


def check_ssd_bwd_args(x: torch.Tensor, dy: torch.Tensor,
                       dfinal: torch.Tensor | None) -> None:
    """Raise on a dy or dfinal the backward does not take (the forward's
    inputs are checked by ``check_ssd_args``)."""
    b, l, h, p = x.shape
    if tuple(dy.shape) != tuple(x.shape):
        raise ValueError(f"dy {tuple(dy.shape)}, need {tuple(x.shape)}")
    grads = [dy] + ([dfinal] if dfinal is not None else [])
    if dfinal is not None and (dfinal.dim() != 4
                               or tuple(dfinal.shape[:3]) != (b, h, p)):
        raise ValueError(f"dfinal {tuple(dfinal.shape)}, need (b, h, p, n) "
                         f"with (b, h, p) = {(b, h, p)}")
    if any(t.dtype != torch.float32 or t.device != x.device
           or not t.is_contiguous() for t in grads):
        raise ValueError("dy and dfinal must be contiguous float32 on the "
                         "inputs' device")


BWD_SETUP = 0.25  # a backward CTA's set-up (B, C, dB, dC), in heads


@functools.lru_cache(maxsize=64)
def ssd_bwd_plan(b: int, l: int, h: int, sms: int) -> int:
    """Heads per CTA of the backward's chunk pass, from the shape and the SM
    count alone.  That pass runs one CTA per SM at a time, each CTA its
    heads in turn, so a plan costs the busiest SM's waves of CTAs times
    what one CTA does: its heads plus its set-up.  The cheapest wins; among
    equals, more heads per CTA (fewer partial sums of dB and dC)."""
    chunks = -(-l // CHUNK)
    best = None
    for heads in range(1, h + 1):
        ctas = b * chunks * -(-h // heads)
        cost = -(-ctas // sms) * (heads + BWD_SETUP)
        if best is None or cost <= best[0]:
            best = (cost, heads)
    return best[1]


def ssd_scan_bwd_cuda(x: torch.Tensor, a: torch.Tensor, B: torch.Tensor,
                      C: torch.Tensor, init_state: torch.Tensor | None,
                      dy: torch.Tensor, dfinal: torch.Tensor | None,
                      chunk: int = CHUNK,
                      scratch: torch.Tensor | None = None):
    """Gradients of ``ssd_scan_cuda``'s (y, final) on the current stream;
    never synchronises.  ``scratch`` is the forward's (``keep_scratch``) on
    these inputs; given None, the forward's first two passes run again
    first.  One call counts as one launch: the three kernels of
    ``csrc/ssd_scan_bwd.cu`` (the state gradients across the chunks in
    reverse, each chunk and group of heads, the sum of dB and dC over the
    groups; two with a single group).  Arguments and results are
    ``ssd_scan_bwd_plain``'s."""
    check_ssd_args(x, a, B, C, init_state, chunk)
    check_ssd_bwd_args(x, dy, dfinal)
    _check_cuda(x, B, C, init_state, dy, dfinal)
    b, l, h, p = x.shape
    n = B.shape[-1]
    dx, da = torch.empty_like(x), torch.empty_like(a)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dinit = torch.empty((b, h, p, n), dtype=torch.float32, device=x.device)
    if l == 0 or b * h * p * n == 0:
        dinit = (dfinal.clone() if dfinal is not None
                 else torch.zeros_like(dinit))
        return (dx, da, dB.zero_(), dC.zero_(),
                dinit if init_state is not None else None)
    if scratch is None:
        _, scratch = _forward(x, a, B, C, init_state, None)
    elif scratch.device != x.device:
        raise ValueError("SSD scratch on another device than the inputs")
    prev, cs, cb = scratch_views(scratch, b, l, h, p, n)
    index = x.device.index
    heads = ssd_bwd_plan(b, l, h, _sm_count(index))
    groups = -(-h // heads)
    chunks = prev.shape[1]
    # each chunk's state gradient (S^T layout), then, with more than one
    # group, each group's dB and dC before their sum
    sizes = (b * chunks * h * n * p,) + ((b * l * groups * n,) * 2
                                         if groups > 1 else ())
    work = torch.empty(sum(sizes), dtype=torch.float32, device=x.device)
    gs = work.data_ptr()
    dbg = dcg = None
    if groups > 1:
        dbg = gs + 4 * sizes[0]
        dcg = dbg + 4 * sizes[1]
    with torch.cuda._DeviceGuard(index):
        fn = _bwd_library().repro_ssd_scan_bwd
        status = fn(x.data_ptr(), B.data_ptr(), C.data_ptr(), dy.data_ptr(),
                    None if dfinal is None else dfinal.data_ptr(),
                    prev.data_ptr(), cs.data_ptr(), cb.data_ptr(),
                    dx.data_ptr(), da.data_ptr(), dB.data_ptr(),
                    dC.data_ptr(), dinit.data_ptr(), gs, dbg, dcg, b, l, h,
                    p, n, heads, build.current_stream(index))
    if status != 0:
        raise RuntimeError(f"SSD scan backward kernel launch failed: CUDA "
                           f"error {status}")
    ssd_scan_bwd_cuda.launches += 1
    return dx, da, dB, dC, dinit if init_state is not None else None


ssd_scan_bwd_cuda.launches = 0
