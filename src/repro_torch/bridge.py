"""Parameters from the JAX package into the port.

``params_from_jax(cfg, tree)`` takes the JAX decoder's parameter pytree with
its leaves as numpy arrays (``jax.tree.map(np.asarray, params)``): a dict
with ``embed``, ``ln_f``, optionally ``lm_head``, and ``layers`` whose
leaves carry a leading layer axis.  One leaf maps to one tensor; slice
``l`` of a layer-stacked leaf goes to layer ``l``.  Module names mirror the
pytree paths (``layers/attn/wq`` -> ``layers[l].attn.wq``).  Dense weights
keep the JAX layout ``(in, out)``: the port computes ``x @ w`` as the JAX
package does, with no transpose.

This module imports no JAX; the caller converts the leaves to numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import Model, resolve_device
from repro_torch.models.transformer import Decoder


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
    dec = Decoder(cfg, dev)
    params = dict(dec.named_parameters())
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
        if path.startswith("layers."):
            stacked = np.asarray(leaf)
            if stacked.shape[0] != cfg.n_layers:
                raise ValueError(f"{path}: {stacked.shape[0]} layers, "
                                 f"config has {cfg.n_layers}")
            rest = path[len("layers."):]
            for l in range(cfg.n_layers):
                put(f"layers.{l}.{rest}", stacked[l])
        else:
            put(path, np.asarray(leaf))
    missing = sorted(set(params) - filled)
    if missing:
        raise KeyError(f"no JAX leaf for {missing}")
    return Model(cfg, dec, dev)
