"""Flash attention on Hopper: the prefill kernel's wrapper and its plain
PyTorch version.

``flash_attention_cuda`` launches ``csrc/flash_attention.cu``: for bf16 a
tensor-core kernel (one CTA per batch * q-head and q block of 64 rows, or
of 128 once such CTAs alone fill every SM; TMA loads of Q and of a ring of
K/V stages, both products on wgmma, online softmax in f32 registers); for
f32 an exact f32 SIMT kernel.
Causal and window bounds cut the KV loop of both.  ``flash_attention_plain``
is the same function in plain PyTorch (``ref.flash_attention_ref``); the CPU
path and the on-card comparison use it.  Callers go through
``ops.flash_attention``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref as flash_attention_plain

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_head_dim(d: int) -> None:
    if d % 8 or not 0 < d <= 128:
        raise ValueError(f"head dim {d} unsupported: need a multiple of 8, "
                         "at most 128")


def check_flash_args(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> None:
    """Raise on anything the kernel does not take."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B,Sq,Hq,D), k/v (B,Skv,Hkv,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, hq, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head dim")
    if hq % k.shape[2]:
        raise ValueError(f"{hq} query heads not a multiple of {k.shape[2]} "
                         "kv heads")
    check_head_dim(d)
    if q.dtype not in DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"need bfloat16 or float32 alike; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v on different devices")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")


def _library() -> ctypes.CDLL:
    lib = build.library("flash_attention")
    fn = lib.repro_flash_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0
                         ) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream; never synchronises.

    q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D) in q's dtype.
    """
    check_flash_args(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got "
                         f"{q.device}")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("bf16 q, k, v must start on 16-byte boundaries "
                         "(TMA)")
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if skv == 0:
        raise ValueError("no keys: k and v are empty")
    # a device guard as torch.cuda.device is, at a third of its host cost
    with torch.cuda._DeviceGuard(q.device.index):
        status = _library().repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
            skv, hq, hkv, d, int(causal), int(window), DTYPE_CODES[q.dtype],
            build.current_stream(q.device.index))
    if status != 0:
        raise RuntimeError(f"flash attention kernel launch failed: error "
                           f"{status} (CUDA error, or 1000 + the CUresult "
                           "of a tensor map)")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
