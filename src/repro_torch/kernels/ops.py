"""Entry points for the attention kernels: one decision, made by where the
tensors lie.

A CUDA tensor goes to the hand-written Hopper kernel, which launches or
raises.  A CPU tensor goes to the kernel's plain PyTorch version.  There is
no fallback from one to the other.  Both sides check their arguments the
same way, so the CPU tests hold the model to what the kernels take.

``launch_counts`` reads how many times each kernel was launched, and
``reset_launch_counts`` sets them to zero, so a run can show that its path
went through the kernels.
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

KERNELS = {"flash_attention": flash_attention_cuda,
           "paged_attention": paged_attention_cuda}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D)."""
    check_flash_args(q, k, v)
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window)
    raise ValueError(f"no flash attention for device {q.device}")


def paged_attention(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, block_table: torch.Tensor,
                    lengths: torch.Tensor) -> torch.Tensor:
    """q: (B, Hq, D); k/v_pages: (P, page, Hkv, D); block_table
    (B, per_seq) int32; lengths (B,) int32 -> (B, Hq, D)."""
    check_paged_args(q, k_pages, v_pages, block_table, lengths)
    if q.device.type == "cuda":
        return paged_attention_cuda(q, k_pages, v_pages, block_table,
                                    lengths)
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, block_table,
                                     lengths)
    raise ValueError(f"no paged attention for device {q.device}")


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
