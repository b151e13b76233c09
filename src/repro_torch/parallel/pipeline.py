"""GPipe-style pipeline parallelism over the 'pod' axis.

Inter-pod links are the slow tier of a multi-pod system, which is exactly
where pipeline parallelism belongs: each pod holds a contiguous block of
layers (a stage); microbatches stream through stages with activations
handed off to the next stage over the axis's process group
(``batch_isend_irecv``).

This is the selectable alternative to pure DP over 'pod' (the dry-run
default).  The schedule is 1F1B-flush (GPipe): with M microbatches and P
stages, bubble fraction = (P-1)/(M+P-1).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def pipeline_forward(stage_fn, stage_params, x_micro: torch.Tensor, *,
                     mesh, axis: str = "pod") -> torch.Tensor:
    """Run microbatches through pipeline stages laid out on ``axis``.

    stage_fn: (params_slice, x) -> x        one stage's computation
    stage_params: this rank's stage's parameters (its slice of the
        stages' stacked parameters: stage = its coordinate on ``axis``)
    x_micro: (n_micro, mb, ...) microbatched input (the same on every rank)
    Returns (n_micro, mb, ...) outputs, the same on every rank: the last
    stage's, all-reduced over the axis (earlier stages contribute zeros),
    as the reference's psum does.  n_micro + n_stages - 1 steps; at step t
    stage s runs microbatch t - s when that is one.
    """
    group = mesh.get_group(axis)
    n_stages = mesh.size(mesh.mesh_dim_names.index(axis))
    stage = mesh.get_local_rank(axis)
    ranks = dist.get_process_group_ranks(group)
    n_micro = x_micro.shape[0]
    buf = torch.zeros_like(x_micro[0])
    outs = torch.zeros_like(x_micro)
    for t in range(n_micro + n_stages - 1):
        x_in = x_micro[t] if stage == 0 and t < n_micro else buf
        live = 0 <= t - stage < n_micro
        y = stage_fn(stage_params, x_in) if live else torch.zeros_like(buf)
        if live and stage == n_stages - 1:
            outs[t - stage] = y
        # hand off to the next stage (a ring: the last stage's output goes
        # to stage 0, which ignores it)
        if n_stages > 1:
            nxt = torch.empty_like(buf)
            ops = [dist.P2POp(dist.isend, y.contiguous(),
                              ranks[(stage + 1) % n_stages], group),
                   dist.P2POp(dist.irecv, nxt,
                              ranks[(stage - 1) % n_stages], group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            buf = nxt
    if n_stages > 1:
        dist.all_reduce(outs, group=group)
    return outs


def bubble_fraction(n_stages: int, n_micro: int) -> float:
    return (n_stages - 1) / (n_micro + n_stages - 1)
