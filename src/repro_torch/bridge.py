"""Parameters between the JAX package and the port, both ways.

``params_from_jax(cfg, tree)`` takes the JAX model's parameter pytree with
its leaves as numpy arrays (``jax.tree.map(np.asarray, params)``).  Every
family's tree has ``embed``, ``ln_f`` and (untied) ``lm_head`` beside its
stacks, whose leaves carry leading stack axes: ``layers`` (dense, MoE,
VLM; an expert leaf is ``(L, E, ...)``), ``blocks`` (hybrid super-block,
layer in it) and ``tail``, ``encoder`` and ``decoder`` (encoder-decoder,
with ``ln_enc``), ``pairs`` (xLSTM).  One slice of a stacked leaf maps to
one tensor: ``layers/attn/wq[l]`` -> ``layers[l].attn.wq``,
``layers/moe/w_gate[l]`` -> ``layers[l].moe.w_gate`` (E, d, f),
``blocks/mamba/in_proj[i, j]`` -> ``blocks[i][j].mamba.in_proj``.  Dense
weights keep the JAX layout ``(in, out)``: the port computes ``x @ w`` as
the JAX package does, with no transpose.

``params_to_jax(model)`` is the inverse: the JAX tree, each stack's slices
stacked back, its leaves numpy arrays (bf16 weights as exact f32: numpy has
no bfloat16).  ``to_jax_tree`` and ``from_jax_tree`` do the same for any
dict of tensors named as the port's parameters (the optimizer's moments), so
a checkpoint holds the JAX tree's leaves in its order.  ``leaf_ranks``
gives each parameter its JAX leaf's rank, stack axes included, which the
optimizer's weight decay reads.

This module imports no JAX; the caller converts the leaves to numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, is_xlstm, net_type, resolve_device


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, path + "."))
        else:
            out[path] = val
    return out


def _stacks(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """The leading (stacked) axes of each top-level entry of the tree."""
    if cfg.family == "hybrid":
        n_super, n_tail = divmod(cfg.n_layers, cfg.attn_every)
        return {"blocks": (n_super, cfg.attn_every), "tail": (n_tail,)}
    if cfg.family == "encdec":
        return {"encoder": (cfg.enc_layers,), "decoder": (cfg.n_layers,)}
    if is_xlstm(cfg):
        return {"pairs": (cfg.n_layers // 2,)}
    return {"layers": (cfg.n_layers,)}


def from_jax_tree(cfg: ModelConfig, tree: dict) -> dict[str, np.ndarray]:
    """A JAX parameter tree (or one shaped like it) as numpy arrays named as
    the port's parameters, each stack cut into its slices."""
    stacks = _stacks(cfg)
    out = {}
    for path, leaf in _flatten(tree).items():
        arr = np.asarray(leaf)
        top, _, rest = path.partition(".")
        if top not in stacks:
            out[path] = arr
            continue
        axes = stacks[top]
        if tuple(arr.shape[:len(axes)]) != axes:
            raise ValueError(f"{path}: leading axes "
                             f"{tuple(arr.shape[:len(axes)])}, config has "
                             f"{axes}")
        for idx in np.ndindex(*axes):
            out[".".join([top, *map(str, idx), rest])] = arr[idx]
    return out


def _jax_leaf(cfg: ModelConfig, name: str) -> tuple[str, tuple[int, ...]]:
    """A port parameter's JAX leaf (dotted path) and its index in the
    leaf's stack axes: ``blocks.0.5.mamba.D`` -> (``blocks.mamba.D``,
    (0, 5))."""
    top, _, rest = name.partition(".")
    axes = _stacks(cfg).get(top)
    if axes is None:
        return name, ()
    parts = rest.split(".")
    return (".".join([top, *parts[len(axes):]]),
            tuple(int(i) for i in parts[:len(axes)]))


def to_jax_tree(cfg: ModelConfig, named: dict[str, torch.Tensor]) -> dict:
    """Tensors named as the port's parameters -> the JAX tree of numpy
    arrays: each stack's slices stacked back on its leading axes (f32 for
    a bfloat16 tensor, exactly)."""
    stacks = _stacks(cfg)
    flat: dict[str, np.ndarray] = {}
    for name, t in named.items():
        arr = t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 \
            else t.detach().cpu().numpy()
        path, idx = _jax_leaf(cfg, name)
        if not idx:
            flat[path] = arr
            continue
        if path not in flat:
            axes = stacks[path.partition(".")[0]]
            flat[path] = np.empty(axes + arr.shape, arr.dtype)
        flat[path][idx] = arr
    tree: dict = {}
    for path, arr in flat.items():
        *heads, last = path.split(".")
        node = tree
        for key in heads:
            node = node.setdefault(key, {})
        node[last] = arr
    return tree


def leaf_ranks(cfg: ModelConfig,
               named: dict[str, torch.Tensor]) -> dict[str, int]:
    """Each parameter's JAX leaf rank: its own rank plus its stack's axes
    (a stacked norm scale (L, d) has rank 2, the hybrid's ``A_log`` (n_super,
    attn_every, h) rank 3; ``ln_f`` and the hybrid's shared block keep
    their own)."""
    stacks = _stacks(cfg)
    return {name: len(stacks.get(name.partition(".")[0], ())) + t.dim()
            for name, t in named.items()}


def params_to_jax(model: Model) -> dict:
    """The model's parameters as the JAX package's tree of numpy arrays."""
    return to_jax_tree(model.cfg, dict(model.decoder.named_parameters()))


def params_from_jax(cfg: ModelConfig, tree: dict,
                    device: str | torch.device = "cuda") -> Model:
    """Build the port's model with the JAX package's weights."""
    dev = resolve_device(device)
    net = net_type(cfg)(cfg, dev)
    params = dict(net.named_parameters())
    arrays = from_jax_tree(cfg, tree)
    for name, arr in arrays.items():
        if name not in params:
            raise KeyError(f"JAX leaf {name!r} has no parameter in the port")
        p = params[name]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX shape {tuple(arr.shape)}, port "
                             f"shape {tuple(p.shape)}")
        # via f32: exact for f32 and bf16 leaves alike
        with torch.no_grad():
            p.copy_(torch.from_numpy(np.array(arr, np.float32)))
    missing = sorted(set(params) - set(arrays))
    if missing:
        raise KeyError(f"no JAX leaf for {missing}")
    return Model(cfg, net, dev)
