"""bf16 checkpoints between the JAX package and the port, on the CPU.

- The JAX package's ``checkpoint.save`` writes a bfloat16 leaf as its raw
  bits (``|V2``, manifest dtype ``"bfloat16"``).  The port's Trainer
  restores such a checkpoint bit for bit: every bf16 parameter has the
  same bits as the JAX Trainer's, the f32 AdamW moments and ``step`` are
  equal.
- The port writes a bf16 model's weights as their exact f32 values; the
  JAX package's ``restore`` reads them as f32 leaves equal to the bf16
  values.

Model: ``ARCHS["qwen3-0.6b"].reduced()`` with ``dtype="bfloat16"``, one
step of 2 microbatches of 4 x 32 tokens.
"""

import dataclasses
import json
import os
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.data import DataConfig, SyntheticCorpus, pack_documents  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.training import TrainConfig as JTrainConfig  # noqa: E402
from repro.training import Trainer as JTrainer  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training.optimizer import adamw_init as jadamw_init  # noqa: E402
from repro_torch.bridge import params_to_jax, to_jax_tree  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import TrainConfig, Trainer  # noqa: E402

ARCH = "qwen3-0.6b"
KW = dict(steps=1, n_micro=2, ckpt_every=1)


def _cfgs():
    return (dataclasses.replace(JARCHS[ARCH].reduced(), dtype="bfloat16"),
            dataclasses.replace(ARCHS[ARCH].reduced(), dtype="bfloat16"))


def _batches(cfg, n: int = 2):
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, batch=4, seed=1)
    return list(pack_documents(SyntheticCorpus(dc), n))


def _f32_bits(tree) -> dict:
    """Every leaf of a tree as the bits of its f32 value, keyed by path."""
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(path): np.asarray(
        jnp.asarray(leaf, jnp.float32)).view(np.uint32)
        for path, leaf in leaves}


def test_port_trainer_restores_a_reference_bf16_checkpoint_bit_for_bit():
    jcfg, cfg = _cfgs()
    jm = jax_build_model(jcfg)
    with tempfile.TemporaryDirectory() as d:
        jtr = JTrainer(jm, jm.init(jax.random.key(0)),
                       JTrainConfig(ckpt_dir=d, **KW))
        jtr.run(_batches(jcfg))
        step = jckpt.latest_step(d)
        path = os.path.join(d, f"step_{step:08d}")
        with open(os.path.join(path, "index.json")) as f:
            leaves = {leaf["key"]: leaf for leaf in json.load(f)["leaves"]}
        embed = leaves["params/embed"]
        assert embed["dtype"] == "bfloat16"
        assert np.load(os.path.join(path, embed["file"])).dtype == "V2"
        tr = Trainer(build_model(cfg, device="cpu", seed=3),
                     TrainConfig(ckpt_dir=d, **KW))
        assert tr.maybe_restore() and tr.step == step == 1
    assert all(p.dtype == torch.bfloat16 for p in tr.params.values())
    got, want = _f32_bits(params_to_jax(tr.model)), _f32_bits(jtr.params)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    for k in ("m", "v"):
        got = _f32_bits(to_jax_tree(cfg, tr.opt_state[k]))
        want = _f32_bits(jtr.opt_state[k])
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_array_equal(got[key], want[key],
                                          err_msg=f"{k}{key}")
    assert int(tr.opt_state["step"]) == int(jtr.opt_state["step"]) == 1


def test_reference_restores_a_port_bf16_checkpoint_as_exact_f32():
    jcfg, cfg = _cfgs()
    jm = jax_build_model(jcfg)
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(build_model(cfg, device="cpu", seed=0),
                     TrainConfig(ckpt_dir=d, **KW))
        tr.run(_batches(cfg))
        params = jm.init(jax.random.key(0))
        like = {"params": params, "opt": jadamw_init(params)}
        state = jckpt.restore(d, jckpt.latest_step(d), like)
    assert jax.tree.structure(state) == jax.tree.structure(like)
    assert int(state["opt"]["step"]) == 1
    want = _f32_bits(params_to_jax(tr.model))
    leaves = jax.tree_util.tree_flatten_with_path(state["params"])[0]
    assert len(leaves) == len(want)
    for path, leaf in leaves:
        key = jax.tree_util.keystr(path)
        assert leaf.dtype == np.float32, key
        bits = leaf.view(np.uint32)
        assert not (bits & 0xFFFF).any(), f"{key}: not a bf16 value"
        np.testing.assert_array_equal(bits, want[key], err_msg=key)
