"""Sharding rules: logical parameter/activation/cache layouts -> PartitionSpec,
and those specs as ``DeviceMesh`` placements of DTensors.

Mesh axes: ('data', 'model') single-pod, ('pod', 'data', 'model') multi-pod.
  - batch dims shard over ('pod', 'data')           [DP across pods]
  - attention heads / d_ff / vocab over 'model'     [TP]
  - params additionally over 'data' when fsdp=True  [FSDP / ZeRO]
  - KV caches shard the *sequence* dim over 'model' (robust for GQA where
    n_kv_heads < TP degree; decode attention over the sharded sequence is a
    distributed softmax, below)
  - MoE experts shard over 'model'                  [EP == TP axis]

``fit()`` drops any axis that does not divide a dim, so the same rules serve
every (arch x shape) cell -- e.g. batch=1 long-context decode simply loses
its batch sharding instead of failing.  ``P`` is a tuple, so a spec compares
equal to the JAX package's ``PartitionSpec`` under ``tuple()``.

The port runs these rules on DTensors: ``distribute_model`` makes every
parameter a DTensor with ``param_specs``' placements, the model's entry
points distribute their inputs by ``batch_specs`` / ``cache_specs``, and
``MeshRules.act`` is the counterpart of ``with_sharding_constraint``: it
redistributes an activation to the spec's placements (a Partial sum becomes
an all-reduce, a sharded dim an all-gather).  Where two mesh axes shard one
dim, as ('pod', 'data') does, their order in the spec is their order in the
mesh, so that DTensor splits the dim as XLA does (``placements`` asserts
it).

GSPMD propagates a sharding through every op; DTensor needs a strategy for
each op, and places the result by its own rules between the constrained
points.  These sites have none (or none that keeps the reference's layout)
and run on each rank's local shards through ``local_map``, in the layout
named, with the collectives each adds:
  - attention (training's ``sdpa``, prefill's flash kernel, the encoder's
    and the cross-attention): q/k/v batch over DP and heads over 'model'
    when both head counts divide it, else heads whole.  The view of the
    column-parallel q/k/v to heads all-gathers the columns first where a
    shard would split a head (qwen3's Hkv*hd = 1024 over 16 ranks);
  - the KV cache write (ring slots, prefill and decode) and ``kpos``: the
    cache's own layout, sequence over 'model'; the new k/v are replicated
    over 'model' first (an all-gather of heads);
  - decode attention over the sequence-sharded cache: each rank attends its
    slice (the paged kernel with its log-sum-exp output on its local
    lengths clamp(pos + 1 - r * S_local, 0, S_local), or a masked softmax
    on the CPU's SWA path) and the slices merge by log-sum-exp over
    'model': one all-reduce max of (B, Hq, s) and one all-reduce sum of
    (B, s, Hq, D + 1) a layer, never an all-gather of KV;
  - the MoE dispatch (sort, top-k, cumsum): tokens batch over DP, experts
    over 'model' in the reference's (G, E, C, d) 'moe_inner' layout (each
    rank runs its experts' capacity slots), then one all-reduce sum of
    (B, S, d) over 'model'; the aux loss averages over DP (all-reduce);
  - the SSD scan (cumsum, triangles) and the Mamba2 decode update: heads
    over 'model' when they divide it; B/C replicated (an all-gather of the
    column-parallel in_proj's output);
  - the xLSTM recurrences (mLSTM and sLSTM steps): batch over DP, heads
    whole, the states all-gathered from their cache layout and written back
    as local slices;
  - the loss: logits stay vocab-sharded; the log-sum-exp and the label's
    logit reduce over 'model' (all-reduces of (B, S)), never gathering V.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Any, Callable

import torch
import torch.distributed._functional_collectives as funcol
from torch import nn
from torch.distributed.tensor import (
    DTensor,
    Partial,
    Placement,
    Replicate,
    Shard,
    distribute_tensor,
)
from torch.distributed.tensor.experimental import (
    implicit_replication,
    local_map,
)
from torch.utils import _pytree as pytree


class P(tuple):
    """A partition spec: one entry per dim, None, an axis name, or a tuple of
    axis names."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def mesh_axes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (or of anything whose ``shape``
    is already that mapping, as the JAX package's meshes are)."""
    if isinstance(mesh.shape, dict):
        return dict(mesh.shape)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    shape = mesh_axes(mesh)
    n = 1
    for a in axes:
        n *= shape[a]
    return n


def fit(mesh, shape: tuple[int, ...], spec: tuple) -> P:
    """Drop axes that don't divide their dim; returns a valid spec."""
    sizes = mesh_axes(mesh)
    fixed = []
    for dim, axes in zip(shape, spec):
        if axes is None:
            fixed.append(None)
            continue
        cand = (axes,) if isinstance(axes, str) else tuple(axes)
        kept = []
        size = dim
        for a in cand:
            if a in sizes and size % sizes[a] == 0:
                kept.append(a)
                size //= sizes[a]
        fixed.append(tuple(kept) if len(kept) > 1 else
                     (kept[0] if kept else None))
    # trailing dims beyond spec -> replicated
    fixed += [None] * (len(shape) - len(fixed))
    return P(*fixed)


def placements(mesh, spec: tuple) -> tuple[Placement, ...]:
    """A spec as DTensor placements, one per mesh dim: ``Shard(d)`` on each
    mesh dim that names tensor dim d, ``Replicate()`` elsewhere."""
    names = list(mesh.mesh_dim_names)
    out: list[Placement] = [Replicate()] * len(names)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [names.index(a) for a in axes]
        assert idx == sorted(idx), (
            f"spec {spec}: axes {axes} of dim {dim} must follow the mesh's "
            f"order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


def _leaf_keys(name: str) -> list[str]:
    """A parameter's module path without its layer indices: the JAX leaf's
    keys (``layers.3.moe.shared.w_up`` -> layers, moe, shared, w_up)."""
    return [k for k in name.split(".") if not k.isdigit()]


class NoSharder:
    """Default no-op sharder: every hook is the identity or the plain call,
    so the unsharded path runs exactly the ops it ran before the hooks."""

    sharded = False

    def act(self, x, kind: str):
        return x

    def context(self):
        return contextlib.nullcontext()

    def local(self, fn: Callable, args: tuple, in_specs, out_specs,
              grads=None):
        return fn(*args)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor):
        return table[tokens.long()]

    def write(self, dst: torch.Tensor, src: torch.Tensor) -> None:
        """``dst.copy_(src)``: a state written in place."""
        dst.copy_(src)

    def heads(self, t: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
        """``t.reshape(shape)``: the last dim split into (heads, head
        dim)."""
        return t.reshape(shape)

    def const(self, t: torch.Tensor) -> torch.Tensor:
        """A tensor made on every rank alike (positions)."""
        return t


NOSHARD = NoSharder()


@dataclass
class MeshRules(NoSharder):
    """Bound to a mesh; produces specs for params/acts/caches/batches and
    places tensors by them.

    Optimization variants:
      seq_parallel -- residual-stream activations shard their sequence dim
        over 'model' (Korthikanti-style sequence parallelism): the
        per-layer TP combine becomes reduce-scatter (+ all-gather before
        qkv) instead of a full all-reduce.
      decode_2d -- weight-stationary decode sharding: FFN weights live 2D
        over (data x model) and are NEVER gathered; the tiny decode
        activations move instead (vs ZeRO-inference all-gathering the
        whole model every step).
    """

    mesh: Any
    fsdp: bool = True
    seq_parallel: bool = False
    decode_2d: bool = False

    sharded = True

    @property
    def batch_axes(self):
        return (("pod", "data") if "pod" in mesh_axes(self.mesh)
                else ("data",))

    @property
    def fsdp_axis(self):
        return "data" if self.fsdp else None

    # ------------------------------------------------------------------
    # activation constraints (Sharder protocol for the model stacks)
    # ------------------------------------------------------------------

    def act_spec(self, shape: tuple[int, ...], kind: str) -> P | None:
        """The spec ``act`` constrains a tensor of ``shape`` to (None: no
        constraint)."""
        ba = self.batch_axes
        if len(shape) == 3:
            if kind == "logits":
                return fit(self.mesh, shape, (ba, None, "model"))
            if self.seq_parallel and kind == "act" and shape[1] > 1:
                return fit(self.mesh, shape, (ba, "model", None))
            if self.decode_2d and kind == "ffn_in" and shape[1] == 1:
                # weight-stationary FFN: move the (tiny) decode activation
                # onto the weights' 'data' shards; weights never move
                return fit(self.mesh, shape, (None, None, "data"))
            return fit(self.mesh, shape, (ba, None, None))
        if len(shape) == 4 and kind == "moe_inner":
            # (G, E, C, d): groups over DP, experts over TP (EP)
            return fit(self.mesh, shape, (ba, "model", None, None))
        if len(shape) == 5 and kind == "attn_logits" and shape[3] == 1:
            # decode logits (B, Hkv, G, 1, S): the kv/seq dim on the TP
            # axis -- distributed softmax over the seq-sharded cache
            return fit(self.mesh, shape, (ba, None, None, None, "model"))
        return None

    def act(self, x, kind: str):
        spec = self.act_spec(tuple(x.shape), kind)
        if spec is None or not isinstance(x, DTensor):
            return x
        return x.redistribute(self.mesh, placements(self.mesh, spec))

    # ------------------------------------------------------------------
    # parameter specs
    # ------------------------------------------------------------------

    def param_specs(self, params) -> dict[str, P]:
        """{name: spec} for a module's ``named_parameters()`` (or a dict of
        tensors named as them): the JAX package's leaf spec of each, its
        stacked leading dims dropped (the port keeps layers unstacked)."""
        if isinstance(params, nn.Module):
            params = dict(params.named_parameters())
        return {name: self._leaf_spec(_leaf_keys(name), tuple(arr.shape))
                for name, arr in params.items()}

    def _leaf_spec(self, keys: list[str], shape: tuple[int, ...]) -> P:
        fs = self.fsdp_axis
        name = keys[-1] if keys else ""
        in_moe = "moe" in keys and "shared" not in keys
        nd = len(shape)
        if nd == 0:
            return P()
        if self.decode_2d:
            # weight-stationary decode: never gather weights; FFN 2D
            # over (data x model), attention column/row over model only
            spec2d = self._decode_2d_spec(name, in_moe, nd)
            if spec2d is not None:
                lead = nd - len(spec2d)
                return fit(self.mesh, shape,
                           (None,) * max(lead, 0) + spec2d[:nd])
        if name in ("scale", "A_log", "D", "dt_bias", "f_bias", "bias"):
            trailing = (None,) * 1
        elif name == "embed":
            trailing = ("model", fs)
        elif name == "lm_head":
            trailing = (fs, "model")
        elif in_moe and name in ("w_gate", "w_up"):
            trailing = ("model", fs, None)       # experts over TP axis
        elif in_moe and name == "w_down":
            trailing = ("model", None, fs)
        elif in_moe and name == "router":
            trailing = (None, None)
        elif name in ("wq", "wk", "wv", "w_gate", "w_up", "in_proj",
                      "w_x", "w_i", "w_f"):
            trailing = (fs, "model")             # column parallel
        elif name in ("wo", "w_down", "out_proj", "w_o"):
            trailing = ("model", fs)             # row parallel
        elif name == "r_h":
            trailing = ("model", None, None)
        else:
            trailing = (None,) * min(nd, 2)
        lead = nd - len(trailing)
        spec = (None,) * max(lead, 0) + trailing[:nd]
        return fit(self.mesh, shape, spec)

    @staticmethod
    def _decode_2d_spec(name: str, in_moe: bool, nd: int):
        """Weight-stationary decode layouts (None = fall through)."""
        if name in ("w_gate", "w_up") and not in_moe:
            # contracting dim over 'data' (pairs with the ffn_in activation
            # constraint), output over 'model' -- never gathered
            return ("data", "model")
        if name == "w_down" and not in_moe:
            # row-parallel over 'model'; output dim replicated over data so
            # the batch-sharded residual consumer never gathers the weight
            return ("model", None)
        if in_moe and name in ("w_gate", "w_up"):
            return ("model", "data", None)
        if in_moe and name == "w_down":
            return ("model", None, "data")
        if name in ("wq", "wk", "wv", "in_proj", "w_x", "w_i", "w_f"):
            return (None, "model")
        if name in ("wo", "out_proj", "w_o"):
            return ("model", None)
        if name == "embed":
            return ("model", None)
        if name == "lm_head":
            return (None, "model")
        return None

    def param_shardings(self, params) -> dict[str, tuple[Placement, ...]]:
        return self.shardings_of(self.param_specs(params))

    # ------------------------------------------------------------------
    # batch / cache specs
    # ------------------------------------------------------------------

    def batch_specs(self, batch: Any) -> Any:
        ba = self.batch_axes

        def leaf(arr):
            if not isinstance(arr, torch.Tensor):
                return None
            return fit(self.mesh, tuple(arr.shape),
                       (ba,) + (None,) * (arr.dim() - 1))

        return pytree.tree_map(leaf, batch)

    def cache_specs(self, cache: dict) -> dict:
        """KV/state cache layouts (leading layer-stack dims replicated).
        The port's per-row ``pos`` (B,) and ``kpos`` (B, kv_len) put their
        rows over DP, and ``kpos``'s slots over 'model' as k/v's."""
        ba = self.batch_axes
        out = {}
        for name, arr in cache.items():
            if not isinstance(arr, torch.Tensor):
                out[name] = None
                continue
            shape = tuple(arr.shape)
            nd = len(shape)
            if nd == 0:      # pos scalar
                spec = P()
            elif name in ("k", "v"):
                # (L, B, S, Hkv, hd) or (n_super, B, S, Hkv, hd):
                # batch over DP, SEQUENCE over TP (robust to Hkv < TP)
                spec = fit(self.mesh, shape, (None, ba, "model", None, None))
            elif name == "kpos":
                spec = fit(self.mesh, shape, (ba, "model"))
            elif name == "pos":
                spec = fit(self.mesh, shape, (ba,))
            elif name == "enc_out":  # (B, S_src, d)
                spec = fit(self.mesh, shape, (ba, None, None))
            elif name in ("ssm", "ssm_tail"):
                # (..., B, H, P, N): heads over TP
                spec = fit(self.mesh, shape,
                           (None,) * (nd - 4) + (ba, "model", None, None))
            elif name.startswith("mlstm"):
                # (n_pairs, B, h, dh[, dh]) -- shard dh
                if nd >= 4:
                    spec = fit(self.mesh, shape, (None, ba, None, "model")
                               + (None,) * (nd - 4))
                else:
                    spec = fit(self.mesh, shape, (None, ba, None))
            elif name.startswith("slstm"):    # (n_pairs, B, d)
                spec = fit(self.mesh, shape, (None, ba, "model"))
            else:
                spec = fit(self.mesh, shape,
                           ((None,) + (ba,) + (None,) * (nd - 2))[:nd])
            out[name] = spec
        return out

    def shardings_of(self, specs: Any) -> Any:
        """Specs -> placements on this mesh, leaf by leaf."""
        return pytree.tree_map(
            lambda s: placements(self.mesh, s), specs,
            is_leaf=lambda x: isinstance(x, P))

    # ------------------------------------------------------------------
    # placing tensors, and the local sites
    # ------------------------------------------------------------------

    def context(self):
        """Plain tensors made inside (masks, constants) join DTensors as
        replicated.  That holds in the forward only: a plain tensor that a
        differentiable op saves for its backward must be a DTensor already
        (``const``)."""
        return implicit_replication()

    def const(self, t):
        """A tensor made on every rank alike, as a replicated DTensor."""
        return DTensor.from_local(t, self.mesh,
                                  [Replicate()] * self.mesh.ndim,
                                  run_check=False)

    def distribute(self, tensors: Any, specs: Any) -> Any:
        """Each tensor of a tree (the same on every rank) as a DTensor with
        its spec, cut locally (no communication); a DTensor is
        redistributed."""

        def place(t, spec):
            if not isinstance(t, torch.Tensor) or spec is None:
                return t
            pl = placements(self.mesh, spec)
            if isinstance(t, DTensor):
                return t.redistribute(self.mesh, pl)
            return distribute_tensor(t, self.mesh, pl, src_data_rank=None)

        return pytree.tree_map(place, tensors, specs,
                               is_leaf=lambda x: x is None)

    def embed(self, table, tokens):
        """Vocab-parallel lookup on local shards: each rank takes the rows
        of its vocab slice (zeros for the others' tokens), a Partial sum
        over 'model' that the next ``act`` all-reduces; the table is never
        gathered over 'model'."""
        tspec = fit(self.mesh, tuple(table.shape), ("model", None))
        kspec = fit(self.mesh, tuple(tokens.shape), (self.batch_axes, None))
        v_l = table.shape[0] // axis_size(self.mesh, tspec[0])
        off = self.axis_index("model") * v_l if tspec[0] else 0

        def look(table, tokens):
            t = tokens.long() - off
            inside = (t >= 0) & (t < v_l)
            rows = table[torch.clamp(t, 0, v_l - 1)]
            return torch.where(inside[..., None], rows, 0)

        out = self.mixed(kspec + (None,), partial=("model",) if tspec[0]
                         else ())
        grad = self.mixed(tspec, partial=_axes(kspec[0]))
        return self.local(look, (table, tokens), (tspec, kspec), out,
                          grads=(grad, None))

    def mixed(self, spec, partial=()) -> tuple[Placement, ...]:
        """``spec``'s placements with ``Partial()`` (a sum) on the mesh
        axes named in ``partial`` that the spec does not shard."""
        pl = list(placements(self.mesh, spec))
        for i, name in enumerate(self.mesh.mesh_dim_names):
            if name in partial and not pl[i].is_shard():
                pl[i] = Partial()
        return tuple(pl)

    def write(self, dst, src) -> None:
        """A state written in place, ``src`` first placed as ``dst``."""
        if isinstance(dst, DTensor) and isinstance(src, DTensor):
            src = src.redistribute(dst.device_mesh, dst.placements)
        dst.copy_(src)

    def heads(self, t, shape):
        """The split of the last dim into (heads, head dim), after an
        all-gather of that dim on the mesh dims whose shards would split a
        head (DTensor cannot view such a shard)."""
        if isinstance(t, DTensor):
            last, n = t.dim() - 1, shape[-2]
            pl = list(t.placements)
            parts = [i for i, p in enumerate(pl) if p.is_shard(last)]
            size = 1
            for i in parts:
                size *= t.device_mesh.size(i)
            if n % size:
                for i in parts:
                    pl[i] = Replicate()
                t = t.redistribute(t.device_mesh, pl)
        return t.reshape(shape)

    def spec_placements(self, shape, spec) -> tuple[Placement, ...]:
        return placements(self.mesh, fit(self.mesh, tuple(shape), spec))

    def local(self, fn: Callable, args: tuple, in_specs, out_specs,
              grads=None):
        """``fn`` on each rank's local shards: every DTensor argument is
        redistributed to its spec (fitted to its shape: an axis that does
        not divide is dropped), every other argument passed as it is, and
        each output wrapped as a DTensor with its entry of ``out_specs``: a
        spec (``P``, already fitted to the output's global shape) or a
        tuple of placements (for a ``Partial`` output).  ``grads``: per
        argument, the placements of its local gradient where they are not
        its input placements -- a weight replicated over the batch axes
        gets a partial gradient from each rank's rows (``mixed``)."""
        in_pl = tuple(
            self.spec_placements(a.shape, s)
            if isinstance(a, DTensor) and s is not None else None
            for a, s in zip(args, in_specs))
        def one(s):
            return list(placements(self.mesh, s) if isinstance(s, P) else s)

        single = isinstance(out_specs, P) or isinstance(out_specs[0],
                                                         Placement)
        out_pl = one(out_specs) if single else tuple(map(one, out_specs))
        grad_pl = None
        if grads is not None:
            grad_pl = tuple(g if g is not None else p
                            for g, p in zip(grads, in_pl))
        def run(*local_args):
            return fn(*(_ContiguousGrad.apply(a) if isinstance(
                a, torch.Tensor) and a.requires_grad else a
                for a in local_args))

        return local_map(run, out_placements=out_pl, in_placements=in_pl,
                         in_grad_placements=grad_pl, device_mesh=self.mesh,
                         redistribute_inputs=True)(*args)

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on a mesh axis."""
        return self.mesh.get_local_rank(axis)

    def reduce(self, t: torch.Tensor, op: str, axis: str) -> torch.Tensor:
        """All-reduce a local tensor over one mesh axis (``op`` 'sum' or
        'max'); nothing on an axis of one rank."""
        if mesh_axes(self.mesh)[axis] == 1:
            return t
        return funcol.all_reduce(
            t, op, (self.mesh, self.mesh.mesh_dim_names.index(axis)))


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose backward makes the gradient contiguous: a local
    site's input gradient leaves ``local_map`` as a DTensor that the
    backward of a view upstream must be able to view."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _axes(entry) -> tuple[str, ...]:
    """The axis names of one spec entry."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def distribute_model(model, rules: MeshRules):
    """Make every parameter of ``model`` (a ``Model`` or a module) a DTensor
    with ``rules.param_specs``' placements, cut locally from the full
    weights every rank holds (the same seed gives the same weights).
    Returns the model."""
    net = getattr(model, "decoder", model)
    specs = rules.param_specs(net)
    for name, spec in specs.items():
        mod_name, _, leaf = name.rpartition(".")
        mod = net.get_submodule(mod_name) if mod_name else net
        p = mod._parameters[leaf]
        dt = distribute_tensor(p.detach(), rules.mesh,
                               placements(rules.mesh, spec),
                               src_data_rank=None)
        mod._parameters[leaf] = nn.Parameter(dt,
                                             requires_grad=p.requires_grad)
    return model


def full(t: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a DTensor (a collective: every rank calls it), a
    plain tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t
