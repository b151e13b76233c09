"""The port's AdamW and bf16 gradient compression against the JAX package's
on the CPU: one ``adamw_update`` from identical parameters (bridged from
the JAX tree), gradients and moments made with numpy from a seed, then the
new parameters, moments, step and metrics compared leaf for leaf after the
reverse bridge.

Cases: f32 and bf16 parameters, clipping binding (|g| > clip) and not, a
step in the warmup and one in the cosine decay, and the hybrid, whose
layer-stacked 1-D leaves (norm scales, ``A_log``, ``D``, ``dt_bias``) are
decayed as the reference's rank >= 2 rule decays them, while ``ln_f`` and
the shared block's norms are not.

Tolerance 1e-6 (absolute and relative) on every f32 number; bf16
parameters (the f32 result rounded to bf16) and compression are compared
bit for bit."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.parallel import collectives as JC  # noqa: E402
from repro.training import optimizer as JO  # noqa: E402
from repro_torch.bridge import (  # noqa: E402
    from_jax_tree,
    leaf_ranks,
    params_from_jax,
    to_jax_tree,
)
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.parallel import collectives as TC  # noqa: E402
from repro_torch.training import optimizer as TO  # noqa: E402

TOL = 1e-6
OPT = dict(lr=1e-3, warmup_steps=100, total_steps=1000)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(arch: str, dtype: str):
    jcfg = dataclasses.replace(JARCHS[arch].reduced(), dtype=dtype)
    tcfg = dataclasses.replace(ARCHS[arch].reduced(), dtype=dtype)
    params = jax_build_model(jcfg).init(jax.random.key(0))
    tm = params_from_jax(tcfg, jax.tree.map(np.asarray, params),
                         device="cpu")
    return tcfg, params, tm


def _tree_like(params, rng, fn):
    return jax.tree.map(lambda p: fn(rng, p.shape).astype(np.float32),
                        params)


def _close_trees(got: dict, want, tol=TOL, bf16=False):
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        w = np.asarray(w)
        if bf16 and w.dtype != np.float32:
            np.testing.assert_array_equal(np.asarray(g, np.float32),
                                          w.astype(np.float32))
        else:
            np.testing.assert_allclose(np.asarray(g, np.float32),
                                       w.astype(np.float32), atol=tol,
                                       rtol=tol)


@pytest.mark.parametrize("arch,dtype,clip,step", [
    ("qwen3-0.6b", "float32", False, 0),
    ("qwen3-0.6b", "float32", True, 0),
    ("qwen3-0.6b", "float32", False, 499),
    ("qwen3-0.6b", "float32", True, 499),
    ("qwen3-0.6b", "bfloat16", False, 499),
    ("qwen3-0.6b", "bfloat16", True, 0),
    ("zamba2-7b", "float32", True, 499),
    ("granite-moe-3b-a800m", "float32", False, 499)])
def test_one_adamw_update_matches_jax(arch, dtype, clip, step):
    tcfg, params, tm = _setup(arch, dtype)
    rng = np.random.default_rng(step + 7 * clip)
    # |g| ~ 1e-2 per element: the global norm is above 1 with hundreds of
    # thousands of elements; scaled down 1e4 it is below
    grads = _tree_like(params, rng, lambda r, s: r.standard_normal(s)
                       * (1e-2 if clip else 1e-6))
    m = _tree_like(params, rng, lambda r, s: r.standard_normal(s) * 1e-3)
    v = _tree_like(params, rng, lambda r, s: r.random(s) * 1e-5)
    ocfg = JO.AdamWConfig(**OPT)
    jstate = {"m": m, "v": v, "step": jnp.asarray(step, jnp.int32)}
    jparams, jnew, jmet = jax.jit(
        lambda g, s, p: JO.adamw_update(ocfg, g, s, p))(grads, jstate,
                                                        params)
    assert (float(jmet["grad_norm"]) > ocfg.clip_norm) == clip

    named = dict(tm.decoder.named_parameters())
    tens = lambda tree: {k: torch.from_numpy(np.array(a)) for k, a in  # noqa: E731
                         from_jax_tree(tcfg, tree).items()}
    state = {"m": tens(m), "v": tens(v),
             "step": torch.tensor(step, dtype=torch.int32)}
    met = TO.adamw_update(TO.AdamWConfig(**OPT), tens(grads), state, named,
                          leaf_ranks(tcfg, named))
    assert int(state["step"]) == step + 1 == int(jnew["step"])
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(met[key]), float(jmet[key]),
                                   rtol=TOL)
    _close_trees(to_jax_tree(tcfg, state["m"]), jnew["m"])
    _close_trees(to_jax_tree(tcfg, state["v"]), jnew["v"])
    _close_trees(to_jax_tree(tcfg, named), jparams,
                 bf16=dtype == "bfloat16")


def test_decay_follows_the_stacked_rank():
    """With zero gradients and moments the update is the decay alone: a
    hybrid parameter moves iff its JAX leaf has rank >= 2."""
    tcfg, params, tm = _setup("zamba2-7b", "float32")
    named = dict(tm.decoder.named_parameters())
    with torch.no_grad():
        for p in named.values():      # no parameter at 0 (dt_bias is)
            p.add_(0.5)
    before = {k: p.detach().clone() for k, p in named.items()}
    ranks = leaf_ranks(tcfg, named)
    zeros = {k: torch.zeros_like(p) for k, p in named.items()}
    state = TO.adamw_init(named)
    TO.adamw_update(TO.AdamWConfig(**OPT), zeros, state, named, ranks)
    moved = {k for k in named if not torch.equal(named[k], before[k])}
    assert moved == {k for k, r in ranks.items() if r >= 2}
    for name in ("blocks.0.0.ln.scale", "blocks.0.0.mamba.A_log",
                 "blocks.0.0.mamba.D", "blocks.0.0.mamba.dt_bias"):
        assert named[name].dim() == 1 and name in moved
    for name in ("ln_f.scale", "shared.ln1.scale"):
        assert name not in moved


def test_schedule_matches_jax():
    ocfg = JO.AdamWConfig(**OPT)
    steps = np.array([0, 1, 50, 99, 100, 101, 500, 999, 1000, 1500],
                     np.int32)
    want = np.asarray(jax.vmap(lambda s: JO.schedule(ocfg, s))(steps))
    got = TO.schedule(TO.AdamWConfig(**OPT), torch.from_numpy(steps))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=0)


def test_compression_matches_jax_bit_for_bit():
    rng = np.random.default_rng(3)
    shapes = {"a": (64, 33), "b": {"c": (7,), "d": (3, 5, 8)}}
    grads = jax.tree.map(lambda s: (rng.standard_normal(s) * 10.0 ** rng
                                    .integers(-8, 3, s)).astype(np.float32),
                         shapes, is_leaf=lambda x: isinstance(x, tuple))
    ebuf = jax.tree.map(lambda g: (rng.standard_normal(g.shape) * 1e-4)
                        .astype(np.float32), grads)
    jc, je = JC.compress_with_feedback(grads, ebuf)
    flat = lambda tree: dict(zip(["a", "b.c", "b.d"], jax.tree.leaves(  # noqa: E731
        tree)))
    tc, te = TC.compress_with_feedback(
        {k: torch.from_numpy(v) for k, v in flat(grads).items()},
        {k: torch.from_numpy(v) for k, v in flat(ebuf).items()})
    for k, want in flat(jc).items():
        assert tc[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tc[k].view(torch.int16).numpy(),
            np.asarray(want).view(np.int16))
    for k, want in flat(je).items():
        np.testing.assert_array_equal(te[k].numpy().view(np.int32),
                                      np.asarray(want).view(np.int32))
    zero = TC.init_error_buf({"w": torch.ones(3, 2, dtype=torch.bfloat16)})
    assert zero["w"].dtype == torch.float32 and not zero["w"].any()
