"""The port's MoE layer and MoE decoder against the JAX package on the CPU,
with the JAX weights carried over by ``bridge.params_from_jax``, on
``qwen2-moe-a2.7b`` (routed plus shared experts) and
``granite-moe-3b-a800m`` (routed only), reduced.

Tolerances: ``moe_fwd``'s output and aux loss 1e-5 (f32; the products and
the combine sum in another order); whole-model logits 1e-4, as the dense
decoder's (tests/test_torch_model.py).  Drop semantics are compared with
drops binding: a tight capacity factor, the registry's 1.25 with a ragged
tail, and 1.0 in prefills and in the engine.

Grouping: the JAX package's engine decodes by mapping its one-sequence
model over the slots, so each slot's token is a group of its own (capacity
k, dropless).  The port decodes every slot in one call and must group per
row; ``test_decode_groups_each_row_alone`` shows that grouping the slots
together would drop tokens, and the engine case would then fail."""

import dataclasses
import functools
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models.moe import moe_fwd as jax_moe_fwd  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models.moe import moe_fwd, moe_per_row  # noqa: E402
from test_torch_engine import engine_parity  # noqa: E402

MOE_TOL = 1e-5
MODEL_TOL = 1e-4
MOE_ARCHS = ("qwen2-moe-a2.7b", "granite-moe-3b-a800m")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes side by side; one intra-op
    thread each keeps torch's many small CPU ops from oversubscribing the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@functools.cache
def _models(arch, capacity_factor=8.0):
    """(JAX config, JAX model, params, port model) of the reduced arch
    (the weights do not depend on the capacity factor)."""
    jcfg = JARCHS[arch].reduced(capacity_factor=capacity_factor)
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.key(0))
    tm = params_from_jax(ARCHS[arch].reduced(capacity_factor=capacity_factor),
                         jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, jm, params, tm


def _layer0(arch, capacity_factor):
    jcfg, _, params, tm = _models(arch, capacity_factor)
    jp = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
    return jcfg, jp, tm.cfg, tm.decoder.layers[0].moe


MOE_CASES = {           # capacity factor, group size, (B, S)
    "dropless": (8.0, 1024, (2, 40)),
    "tight": (0.5, 1024, (2, 40)),
    "ragged_tail": (1.25, 24, (2, 40)),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_fwd_matches_jax(arch, case):
    cf, group_size, (b, s) = MOE_CASES[case]
    jcfg, jp, cfg, moe = _layer0(arch, cf)
    x = np.random.default_rng(len(case)).standard_normal(
        (b, s, jcfg.d_model), dtype=np.float32)
    want, want_aux = jax_moe_fwd(jp, jcfg, jnp.asarray(x),
                                 group_size=group_size)
    got, got_aux = moe_fwd(moe, cfg, torch.from_numpy(x),
                           group_size=group_size)
    assert got.shape == (b, s, jcfg.d_model) and got.dtype == torch.float32
    _close(got, want, MOE_TOL)
    _close(got_aux, want_aux, MOE_TOL)
    if case == "tight":
        # drops bind: lifting the capacity moves the reference's output
        dropless, _ = jax_moe_fwd(
            jp, dataclasses.replace(jcfg, capacity_factor=8.0),
            jnp.asarray(x), group_size=group_size)
        assert float(np.abs(np.asarray(want)
                            - np.asarray(dropless)).max()) > 1e-3


def test_decode_groups_each_row_alone():
    """Eight rows of one token each at capacity factor 1.0: per row (the
    reference's vmapped decode) every pair is kept; grouped together the
    eight tokens share a capacity of k per expert and some are dropped."""
    jcfg, jp, cfg, moe = _layer0("qwen2-moe-a2.7b", 1.0)
    x = np.random.default_rng(7).standard_normal((8, 1, jcfg.d_model),
                                                 dtype=np.float32)
    want = jax.vmap(lambda r: jax_moe_fwd(jp, jcfg, r[None])[0][0])(
        jnp.asarray(x))
    got, _ = moe_per_row(moe, cfg, torch.from_numpy(x))
    _close(got, want, MOE_TOL)
    together, _ = moe_fwd(moe, cfg, torch.from_numpy(x))
    assert float((together - got).abs().max()) > 1e-3


@pytest.mark.parametrize("s", [40, 1100])
def test_per_row_groups_pad_each_row(s):
    """Rows longer than a group, ragged: each row padded at its own end,
    as the reference pads one sequence."""
    jcfg, jp, cfg, moe = _layer0("granite-moe-3b-a800m", 1.25)
    group = 16 if s == 40 else 1024
    x = np.random.default_rng(s).standard_normal((2, s, jcfg.d_model),
                                                 dtype=np.float32)
    want = jax.vmap(lambda r: jax_moe_fwd(jp, jcfg, r[None],
                                          group_size=group)[0][0])(
        jnp.asarray(x))
    got, _ = moe_per_row(moe, cfg, torch.from_numpy(x), group)
    _close(got, want, MOE_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bridge_maps_every_moe_leaf(arch):
    jcfg, _, params, tm = _models(arch)
    n_jax = sum(np.asarray(x).size for x in jax.tree.leaves(params))
    assert n_jax == sum(p.numel() for p in tm.decoder.parameters())
    moe = tm.decoder.layers[1].moe
    _close(moe.w_down.numpy(), params["layers"]["moe"]["w_down"][1], 0)
    _close(moe.router.numpy(), params["layers"]["moe"]["router"][1], 0)
    assert moe.router.dtype == torch.float32
    assert (moe.shared is not None) == (jcfg.n_shared_experts > 0)
    if moe.shared is not None:
        _close(moe.shared.w_up.numpy(),
               params["layers"]["moe"]["shared"]["w_up"][1], 0)
    assert not hasattr(tm.decoder.layers[0], "mlp")


# ----------------------------------------------------------------------
# the model: prefill, then decode steps of rows at their own positions
# ----------------------------------------------------------------------

@pytest.mark.parametrize("capacity_factor", [8.0, 1.0])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_prefill_and_decode_match_vmapped_jax(arch, capacity_factor):
    """Three prompts prefilled one by one (each its own group: at factor
    1.0 the left padding and the prompt compete for capacity), then six
    decode steps of the three rows in one call against the JAX decode
    mapped over the rows."""
    jcfg, jm, params, tm = _models(arch, capacity_factor)
    rng = np.random.default_rng(11)
    jpre = jax.jit(jm.prefill)
    jcaches, tcaches = [], []
    for n in (9, 24, 40):
        toks = np.zeros((1, 64), np.int32)
        toks[0, -n:] = rng.integers(0, jcfg.vocab, n)
        jl, jc = jpre(params, jnp.asarray(toks), jm.init_cache(1, 128))
        tl, tc = tm.prefill(torch.from_numpy(toks), tm.init_cache(1, 128))
        _close(tl, jl, MODEL_TOL)
        jcaches.append(jc)
        tcaches.append(tc)
    jstack = jax.tree.map(lambda *a: jnp.stack(a), *jcaches)
    tstack = {k: torch.cat([c[k] for c in tcaches], dim=0 if k in
                           ("kpos", "pos") else 1)
              for k in ("k", "v", "kpos", "pos")}
    tstack["page_size"] = 16
    step = jax.jit(jax.vmap(lambda t, c: jm.decode_step(params, t, c)))
    for _ in range(6):
        t = rng.integers(0, jcfg.vocab, (3, 1)).astype(np.int32)
        jl, jstack = step(jnp.asarray(t)[:, None], jstack)
        tl, tstack = tm.decode_step(torch.from_numpy(t), tstack)
        _close(tl, np.asarray(jl)[:, 0], MODEL_TOL)
    for key in ("k", "v"):
        _close(tstack[key], np.asarray(jstack[key])[:, :, 0]
               .transpose(1, 0, 2, 3, 4), MODEL_TOL)
    np.testing.assert_array_equal(tstack["pos"].numpy(),
                                  np.asarray(jstack["pos"]))


def test_no_cache_forward_groups_rows_together():
    """Without a cache the decoder groups all rows' tokens, as the JAX
    package's ``decoder_fwd`` does: logits of every position to 1e-4 at
    factor 1.0, where that grouping drops pairs."""
    jcfg, jm, params, tm = _models("granite-moe-3b-a800m", 1.0)
    toks = np.random.default_rng(3).integers(0, jcfg.vocab, (2, 24)) \
        .astype(np.int32)
    want, _ = jax.jit(jm.forward)(params, {"tokens": jnp.asarray(toks)})
    got, _, _ = tm.decoder(torch.from_numpy(toks))
    _close(got, want, MODEL_TOL)


# ----------------------------------------------------------------------
# the engine: 8 slots, capacity factor 1.0
# ----------------------------------------------------------------------

def _moe_requests(vocab):
    rng = random.Random(3)
    return [(i, i * 0.002, [rng.randrange(vocab)
                            for _ in range(rng.randrange(8, 60))],
             rng.randrange(4, 20)) for i in range(12)]


def test_engine_matches_jax():
    """Eight slots decoding together at capacity factor 1.0: the reports,
    every telemetry batch and the loop's state equal the JAX engine's, the
    logits of every call (teacher-forced) to 1e-4."""
    jcfg, jm, params, tm = _models("qwen2-moe-a2.7b", 1.0)
    workload = ("qwen2-moe-a2.7b",
                dict(max_slots=8, max_seq=128, n_pages=256, page_size=16),
                False, _moe_requests(jcfg.vocab), 300)
    pairs = engine_parity(jm, params, tm, workload)
    assert sum(got.shape[0] == 8 for got, _ in pairs) > 10   # decode steps
    for got, want in pairs:
        _close(got, want, MODEL_TOL)
