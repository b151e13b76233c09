"""Parameters from the JAX package into the port.

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


def params_from_jax(cfg: ModelConfig, tree: dict,
                    device: str | torch.device = "cuda") -> Model:
    """Build the port's model with the JAX package's weights."""
    dev = resolve_device(device)
    net = net_type(cfg)(cfg, dev)
    stacks = _stacks(cfg)
    params = dict(net.named_parameters())
    filled = set()

    def put(name: str, arr: np.ndarray) -> None:
        if name not in params:
            raise KeyError(f"JAX leaf {name!r} has no parameter in the port")
        p = params[name]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: JAX shape {tuple(arr.shape)}, port "
                             f"shape {tuple(p.shape)}")
        # via f32: exact for f32 and bf16 leaves alike
        p.copy_(torch.from_numpy(np.array(arr, np.float32)))
        filled.add(name)

    for path, leaf in _flatten(tree).items():
        arr = np.asarray(leaf)
        top, _, rest = path.partition(".")
        if top not in stacks:
            put(path, arr)
            continue
        axes = stacks[top]
        if tuple(arr.shape[:len(axes)]) != axes:
            raise ValueError(f"{path}: leading axes "
                             f"{tuple(arr.shape[:len(axes)])}, config has "
                             f"{axes}")
        for idx in np.ndindex(*axes):
            put(".".join([top, *map(str, idx), rest]), arr[idx])
    missing = sorted(set(params) - filled)
    if missing:
        raise KeyError(f"no JAX leaf for {missing}")
    return Model(cfg, net, dev)
