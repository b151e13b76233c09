"""Paged decode attention on Hopper: the decode kernel's wrapper, its
host-side plan and its plain PyTorch version.

``paged_attention_cuda`` launches ``csrc/paged_attention.cu``: a grid over
(KV head, sequence, split), each CTA serving the G query heads of its KV
head over one split of ``split`` tokens, read in chunks whose page tiles
are all in flight at once (cp.async); each CTA writes a partial (m, l, acc)
and the last CTA of a (sequence, KV head) merges them in the same launch;
asked for it (``return_lse``), the launch also writes each head's
log-sum-exp (B, Hq) f32, so that slices of a sequence merge exactly.
``paged_plan`` fixes the split and the scratch from the cache's capacity
alone (no read of ``lengths``).  ``paged_attention_plain`` is the same
function in plain PyTorch (``ref.paged_attention_ref``); the CPU path and
the on-card comparison use it.  Callers go through ``ops.paged_attention``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPE_CODES, check_head_dim
from repro_torch.kernels.ref import paged_attention_ref as paged_attention_plain

MAX_GROUP = 16   # query heads per KV head: accumulators per thread
CHUNK = 128      # tokens the kernel loads at once in bf16 (half in f32)
MIN_SPLIT = 128  # tokens per split, at least
MAX_SPLITS = 64  # splits per sequence, at most


@dataclass(frozen=True)
class PagedPlan:
    """How one launch cuts the work: ``n_splits`` splits of ``split``
    tokens per sequence; f32 scratch ``partial_shape`` = (B, Hkv, n_splits,
    G, D + 2), each head's unnormalised acc[D] then its m and l; and one
    int32 counter per (sequence, KV head)."""
    split: int
    n_splits: int
    partial_shape: tuple[int, int, int, int, int]
    counters: int


@functools.lru_cache(maxsize=64)
def paged_plan(b: int, hkv: int, g: int, d: int, per_seq: int,
               page: int) -> PagedPlan:
    """The plan from the cache's capacity (``per_seq * page`` tokens), G
    and D alone: both dtypes share it, as the partials are f32.  Splits of
    MIN_SPLIT tokens, grown (in whole chunks) where the capacity would need
    more than MAX_SPLITS."""
    capacity = per_seq * page
    split = max(MIN_SPLIT, -(-capacity // MAX_SPLITS))
    split = -(-split // CHUNK) * CHUNK
    n_splits = max(1, -(-capacity // split))
    return PagedPlan(split, n_splits, (b, hkv, n_splits, g, d + 2), b * hkv)


def check_paged_args(q: torch.Tensor, k_pages: torch.Tensor,
                     v_pages: torch.Tensor, block_table: torch.Tensor,
                     lengths: torch.Tensor) -> None:
    """Raise on anything the kernel does not take.  The table's page ids
    are not checked against the pool (that would need a device sync)."""
    if q.dim() != 3 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"need q (B,Hq,D), k/v_pages (P,page,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k_pages.shape)}, "
                         f"{tuple(v_pages.shape)}")
    b, hq, d = q.shape
    hkv = k_pages.shape[2]
    if k_pages.shape[3] != d or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit pages "
                         f"{tuple(k_pages.shape)}")
    check_head_dim(d)
    if hq // hkv > MAX_GROUP:
        raise ValueError(f"{hq // hkv} query heads per kv head; the kernel "
                         f"takes at most {MAX_GROUP}")
    if block_table.dim() != 2 or block_table.shape[0] != b \
            or tuple(lengths.shape) != (b,):
        raise ValueError(f"need block_table (B,per_seq), lengths (B,); got "
                         f"{tuple(block_table.shape)}, "
                         f"{tuple(lengths.shape)}")
    if q.dtype not in DTYPE_CODES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(f"need bfloat16 or float32 alike; got {q.dtype}, "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    if block_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_table and lengths must be int32")
    tensors = (q, k_pages, v_pages, block_table, lengths)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("paged attention inputs on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged attention inputs must be contiguous")


def _library() -> ctypes.CDLL:
    lib = build.library("paged_attention")
    fn = lib.repro_paged_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


# one zeroed counter buffer per device: the kernel leaves it zeroed, so no
# launch clears it between calls (one stream at a time uses it).  A buffer
# outgrown is kept: a captured CUDA graph may still launch on it.
_counters: dict[torch.device, list[torch.Tensor]] = {}


def _counter_buffer(device: torch.device, n: int) -> torch.Tensor:
    bufs = _counters.setdefault(device, [])
    if not bufs or bufs[-1].numel() < n:
        bufs.append(torch.zeros(max(n, 1024), dtype=torch.int32,
                                device=device))
    return bufs[-1]


def paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, block_table: torch.Tensor,
                         lengths: torch.Tensor, return_lse: bool = False):
    """Launch the CUDA kernel on the current stream; never synchronises.

    q: (B, Hq, D); k/v_pages: (P, page, Hkv, D); block_table (B, per_seq)
    int32; lengths (B,) int32 -> (B, Hq, D) in q's dtype, and with
    ``return_lse`` each head's log-sum-exp of its scaled scores (B, Hq) f32
    (-inf at length 0) beside it.
    """
    check_paged_args(q, k_pages, v_pages, block_table, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("k/v_pages must start on 16-byte boundaries "
                         "(16-byte cp.async)")
    b, hq, d = q.shape
    _, page, hkv, _ = k_pages.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, hq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    per_seq = block_table.shape[1]
    plan = paged_plan(b, hkv, hq // hkv, d, per_seq, page)
    partials = torch.empty(plan.partial_shape, dtype=torch.float32,
                           device=q.device)
    counters = _counter_buffer(q.device, plan.counters)
    # a device guard as torch.cuda.device is, at a third of its host cost
    with torch.cuda._DeviceGuard(q.device.index):
        fn = _library().repro_paged_attention
        status = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    block_table.data_ptr(), lengths.data_ptr(),
                    out.data_ptr(), partials.data_ptr(),
                    counters.data_ptr(),
                    lse.data_ptr() if return_lse else None,
                    b, hq, hkv, d, page, per_seq,
                    plan.split, plan.n_splits, DTYPE_CODES[q.dtype],
                    build.current_stream(q.device.index))
    if status != 0:
        raise RuntimeError(f"paged attention kernel launch failed: CUDA "
                           f"error {status}")
    paged_attention_cuda.launches += 1
    return (out, lse) if return_lse else out


paged_attention_cuda.launches = 0
