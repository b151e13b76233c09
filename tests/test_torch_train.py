"""The port's ``Model.forward`` / ``Model.loss`` and their gradients against
the JAX package on the CPU, for every registry architecture (reduced), with
the JAX weights carried over by ``bridge.params_from_jax`` and one batch
made with numpy from a seed (tokens, labels with masked positions, a
frontend for the VLM and the encoder-decoder).

Tolerances: logits and loss 1e-4, aux 1e-5, each gradient 1e-4 of its
largest magnitude; the hybrid 1e-3 for all but aux, as its serving logits
(tests/test_torch_hybrid.py: the SSD's cumulative decays reach -1e2 and
Mamba2 layers amplify rounding).  Measured here: gradients within 2.5e-6
of their max and logits 1.5e-6, the hybrid's 1.1e-4 and 1.7e-5.  The JAX
gradient tree reaches the port's names through ``params_from_jax``
itself."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.bridge import (  # noqa: E402
    leaf_ranks,
    params_from_jax,
    params_to_jax,
)
from repro_torch.configs import ARCHS  # noqa: E402

TOL = 1e-4
HYBRID_TOL = 1e-3
AUX_TOL = 1e-5

# every architecture of the registry; granite-moe once more at capacity
# factor 1.0, where the groups drop pairs; qwen3 and zamba2 once more with
# activation checkpointing
CASES = [(a, {}) for a in sorted(ARCHS)] + [
    ("granite-moe-3b-a800m", {"capacity_factor": 1.0}),
    ("qwen3-0.6b", {"remat": True}),
    ("zamba2-7b", {"remat": True})]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def batch_for(cfg, seed: int = 1, b: int = 2, s: int = 24) -> dict:
    """tokens, labels (the tokens shifted, the last position and a few
    random ones masked with -1) and, for a VLM or an encoder-decoder, the
    frontend's embeddings, all numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels = np.concatenate([toks[:, 1:], np.full((b, 1), -1, np.int32)], 1)
    labels[rng.random((b, s)) < 0.1] = -1
    batch = {"tokens": toks, "labels": labels}
    if cfg.family == "encdec":
        batch["frontend"] = rng.standard_normal(
            (b, 16, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["frontend"] = rng.standard_normal(
            (b, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    return batch


def _models(arch: str, over: dict):
    jcfg = dataclasses.replace(JARCHS[arch].reduced(), **over)
    tcfg = dataclasses.replace(ARCHS[arch].reduced(), **over)
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.key(0))
    tm = params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                         device="cpu")
    return jm, params, tm


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                 1e-30)


@pytest.mark.parametrize("arch,over", CASES,
                         ids=[a + "".join(f"-{k}" for k in o)
                              for a, o in CASES])
def test_forward_loss_and_grads_match_jax(arch, over):
    jm, params, tm = _models(arch, over)
    batch = batch_for(tm.cfg)
    tol = HYBRID_TOL if tm.cfg.family == "hybrid" else TOL

    def loss_and_out(p, b):
        logits, aux = jm.forward(p, b)
        return jm.loss(p, b), (logits, aux)

    (jloss, (jlogits, jaux)), jgrads = jax.jit(jax.value_and_grad(
        loss_and_out, has_aux=True))(params, batch)

    for p in tm.decoder.parameters():
        p.requires_grad_(True)
    logits, aux = tm.forward(batch)
    loss = tm.loss(batch)
    loss.backward()
    assert logits.shape == jlogits.shape
    assert _rel(logits.detach(), jlogits) <= tol
    assert abs(float(aux.detach()) - float(jaux)) <= AUX_TOL
    assert abs(float(loss.detach()) - float(jloss)) <= tol * max(1.0, abs(
        float(jloss)))
    if tm.cfg.is_moe:
        assert float(aux.detach()) > 0   # the router's losses count

    want = dict(params_from_jax(tm.cfg, jax.tree.map(np.asarray, jgrads),
                                device="cpu").decoder.named_parameters())
    worst = max((_rel(p.grad, want[name].detach()), name)
                for name, p in tm.decoder.named_parameters())
    assert worst[0] <= tol, f"{arch}: gradient of {worst[1]} off by " \
        f"{worst[0]} of its max"


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-7b", "xlstm-125m",
                                  "seamless-m4t-large-v2"])
def test_params_to_jax_inverts_params_from_jax(arch):
    """The reverse bridge gives back the JAX tree, leaf for leaf, stacks
    rebuilt; ``leaf_ranks`` counts each parameter's stack axes."""
    jm, params, tm = _models(arch, {})
    back = params_to_jax(tm)
    want = jax.tree.map(np.asarray, params)
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for got, leaf in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(got, leaf)
    ranks = leaf_ranks(tm.cfg, dict(tm.decoder.named_parameters()))
    jax_ranks = jax.tree.map(np.ndim, params)
    for name, p in tm.decoder.named_parameters():
        leaf = jax_ranks
        for key in _jax_keys(tm.cfg, name):
            leaf = leaf[key]
        assert ranks[name] == leaf, name


def _jax_keys(cfg, name: str) -> list[str]:
    """The JAX tree keys of a port parameter's leaf (its stack indices
    dropped)."""
    from repro_torch.bridge import _jax_leaf
    return _jax_leaf(cfg, name)[0].split(".")
