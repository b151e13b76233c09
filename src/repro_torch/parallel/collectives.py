"""Gradient compression with error feedback, and microbatched gradient
accumulation: the JAX package's ``parallel/collectives.py``.

Each microbatch's gradient may be cast to bf16 before it joins the f32
accumulator, the rounding error kept in an f32 buffer and added to the next
gradient (error feedback), as a data-parallel reduction in bf16 would halve
its bytes.  Gradients are dicts of tensors named as the model's parameters.
"""

from __future__ import annotations

import torch


def compress_with_feedback(grads: dict[str, torch.Tensor],
                           error_buf: dict[str, torch.Tensor]
                           ) -> tuple[dict, dict]:
    """bf16 compression with error feedback.  Returns (compressed grads
    [bf16], new error buffer [f32 residual])."""
    comp, err = {}, {}
    for k, g in grads.items():
        gf = g.float() + error_buf[k]
        gc = gf.to(torch.bfloat16)
        comp[k] = gc
        err[k] = gf - gc.float()
    return comp, err


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    """f32 zeros placed as ``p`` (a DTensor's zeros are sharded as it)."""
    return torch.zeros_like(p, dtype=torch.float32,
                            memory_format=torch.contiguous_format)


def init_error_buf(params: dict[str, torch.Tensor]) -> dict:
    return {k: _zeros_f32(p) for k, p in params.items()}


def accumulate_grads(loss_fn, params: dict[str, torch.Tensor], microbatches,
                     *, compress: bool = False, error_buf=None):
    """Gradient accumulation over microbatches, one ``torch.autograd.grad``
    each: ``loss_fn(batch)`` is differentiated with respect to ``params``
    (tensors that require grad).  ``microbatches``: a dict whose entries
    have the microbatch on axis 0.  Returns (mean loss, mean gradients
    [f32], error buffer)."""
    n_micro = next(iter(microbatches.values())).shape[0]
    names = list(params)
    acc = {k: _zeros_f32(p) for k, p in params.items()}
    if error_buf is None:
        error_buf = init_error_buf(params)
    loss_sum = None
    for i in range(n_micro):
        loss = loss_fn({k: v[i] for k, v in microbatches.items()})
        grads = dict(zip(names, torch.autograd.grad(
            loss, [params[k] for k in names])))
        if compress:
            grads, error_buf = compress_with_feedback(grads, error_buf)
        for k in names:
            acc[k] += grads[k].float()
        loss = loss.detach().float()
        loss_sum = loss if loss_sum is None else loss_sum + loss
    grads = {k: a / n_micro for k, a in acc.items()}
    return loss_sum / n_micro, grads, error_buf
