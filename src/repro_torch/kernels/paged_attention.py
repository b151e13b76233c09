"""Paged decode attention on Hopper: the decode kernel's wrapper and its
plain PyTorch version.

``paged_attention_cuda`` launches ``csrc/paged_attention.cu`` (one CTA per
sequence and KV head serving that group's G query heads, online softmax in
f32 over 64-token tiles read through the block table, each tile's loads
issued together).
``paged_attention_plain`` is the same function in plain PyTorch
(``ref.paged_attention_ref``); the CPU path and the on-card comparison use
it.  Callers go through ``ops.paged_attention``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention import DTYPE_CODES, check_head_dim
from repro_torch.kernels.ref import paged_attention_ref as paged_attention_plain

MAX_GROUP = 16   # query heads per KV head: accumulators per thread


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
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def paged_attention_cuda(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, block_table: torch.Tensor,
                         lengths: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; never synchronises.

    q: (B, Hq, D); k/v_pages: (P, page, Hkv, D); block_table (B, per_seq)
    int32; lengths (B,) int32 -> (B, Hq, D) in q's dtype.
    """
    check_paged_args(q, k_pages, v_pages, block_table, lengths)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    b, hq, d = q.shape
    _, page, hkv, _ = k_pages.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        fn = _library().repro_paged_attention
        status = fn(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                    block_table.data_ptr(), lengths.data_ptr(),
                    out.data_ptr(), b, hq, hkv, d, page,
                    block_table.shape[1], DTYPE_CODES[q.dtype],
                    torch.cuda.current_stream().cuda_stream)
    if status != 0:
        raise RuntimeError(f"paged attention kernel launch failed: CUDA "
                           f"error {status}")
    paged_attention_cuda.launches += 1
    return out


paged_attention_cuda.launches = 0
