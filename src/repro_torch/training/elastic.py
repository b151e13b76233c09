"""Elastic scaling / node-failure handling.

Policy for a 1000+-node deployment (documented + mechanically tested at
small scale):

  1. A node failure surfaces as a collective timeout (or, earlier, as the
     telemetry plane's 'early_stop_skew_across_nodes' / 'tp_straggler'
     findings -- the paper's detectors give ADVANCE warning of degrading
     nodes before hard failure).
  2. The coordinator drops the failed hosts, rebuilds the mesh with a
     smaller DP extent (TP degree is preserved -- it's the intra-pod axis),
     and reshards the latest checkpoint onto the new mesh.
  3. Global batch is preserved by raising grad-accumulation microbatches
     (token-identical training) or shrunk deliberately (throughput mode).

``remesh`` implements step 2's mechanics on DTensors: each tensor is
gathered whole on the old mesh (every rank of the old mesh takes part) and
distributed onto the new mesh, a subset of the ranks, with the new rules'
placements; DTensor does not redistribute across meshes.  A rank outside
the new mesh gets None for every tensor.
"""

from __future__ import annotations

from dataclasses import dataclass

from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.parallel.sharding import MeshRules, mesh_axes, placements


@dataclass
class RemeshPlan:
    old_shape: dict
    new_shape: dict
    dp_scale: float           # new/old data-parallel extent
    micro_scale: int          # grad-accum multiplier to keep global batch


def plan_remesh(old_mesh, failed_nodes: int, hosts_per_data: int = 1
                ) -> RemeshPlan:
    """Drop failed hosts from the 'data' axis; keep 'model' intact."""
    old = mesh_axes(old_mesh)
    new = dict(old)
    lost = failed_nodes * hosts_per_data
    if old["data"] - lost < 1:
        raise ValueError("not enough healthy hosts to continue")
    new["data"] = old["data"] - lost
    dp_scale = new["data"] / old["data"]
    micro_scale = -(-old["data"] // new["data"])   # ceil
    return RemeshPlan(old, new, dp_scale, micro_scale)


def remesh(state: dict, old_rules: MeshRules, new_mesh, fsdp: bool = True
           ) -> tuple[dict, MeshRules]:
    """Reshard a {name: tensor} dict (params or optimizer moments, named as
    the model's parameters) onto a new, smaller mesh.  Every rank of the old
    mesh calls it; ``new_mesh`` is None on a rank that the new mesh leaves
    out."""
    new_rules = MeshRules(new_mesh, fsdp=fsdp) if new_mesh is not None \
        else None
    whole = {k: v.full_tensor() if isinstance(v, DTensor) else v
             for k, v in state.items()}
    if new_rules is None:
        return {k: None for k in state}, None
    specs = new_rules.param_specs(whole)
    out = {k: distribute_tensor(t.to(new_mesh.device_type), new_mesh,
                                placements(new_mesh, specs[k]),
                                src_data_rank=None)
           for k, t in whole.items()}
    return out, new_rules
