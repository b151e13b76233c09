"""Parameters from the JAX package into the port.

``params_from_jax(cfg, tree)`` takes the JAX model's parameter pytree with
its leaves as numpy arrays (``jax.tree.map(np.asarray, params)``).  Dense:
``embed``, ``ln_f``, optionally ``lm_head``, and ``layers`` whose leaves
carry a leading layer axis.  Hybrid: ``embed``, ``shared``, ``ln_f``,
``lm_head``, ``blocks`` whose leaves carry two leading axes (super-block,
layer in it) and optionally ``tail`` with one.  One slice of a stacked leaf
maps to one tensor: ``layers/attn/wq[l]`` -> ``layers[l].attn.wq``,
``blocks/mamba/in_proj[i, j]`` -> ``blocks[i][j].mamba.in_proj``.  Dense
weights keep the JAX layout ``(in, out)``: the port computes ``x @ w`` as
the JAX package does, with no transpose.

This module imports no JAX; the caller converts the leaves to numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, resolve_device
from repro_torch.models.transformer import Decoder, Hybrid


def _flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(_flatten(val, path + "."))
        else:
            out[path] = val
    return out


def params_from_jax(cfg: ModelConfig, tree: dict,
                    device: str | torch.device = "cuda") -> Model:
    """Build the port's model with the JAX package's weights."""
    dev = resolve_device(device)
    if cfg.family == "hybrid":
        net = Hybrid(cfg, dev)
        n_super, n_tail = divmod(cfg.n_layers, cfg.attn_every)
        stacks = {"blocks": (n_super, cfg.attn_every), "tail": (n_tail,)}
    else:
        net = Decoder(cfg, dev)
        stacks = {"layers": (cfg.n_layers,)}
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
