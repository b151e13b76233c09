"""The port's VLM, encoder-decoder and xLSTM families against the JAX
package on the CPU, with the JAX weights carried over by
``bridge.params_from_jax``: ``llava-next-mistral-7b`` (its 576 patch
embeddings reduced to 16), ``seamless-m4t-large-v2`` (2 + 2 layers, 16
source frames) and ``xlstm-125m`` (one mLSTM/sLSTM pair), reduced; and the
full-size configurations of every new family built on the meta device.

Tolerances: logits and caches 1e-4, as the dense decoder's
(tests/test_torch_model.py); each xLSTM cell 1e-4 on the same input and
state.  The xLSTM stack does not amplify rounding as the hybrid does (its
gates are sigmoid-bounded and its stabiliser keeps every exponent <= 0), so
the whole model is held to 1e-4 too.  Engine: reports, every telemetry
batch and the loop's state exactly equal to the JAX engine's, logits of
every call (teacher-forced) to 1e-4."""

import functools
import math
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.bridge import _flatten, _stacks, params_from_jax  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models.model import CACHE_BATCH_AXIS, net_type  # noqa: E402
from test_torch_engine import engine_parity  # noqa: E402

MODEL_TOL = 1e-4
CELL_TOL = 1e-4
NEW_ARCHS = ("qwen2-moe-a2.7b", "granite-moe-3b-a800m",
             "llava-next-mistral-7b", "seamless-m4t-large-v2", "xlstm-125m")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes side by side; one intra-op
    thread each keeps torch's many small CPU ops from oversubscribing the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=MODEL_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@functools.cache
def _models(arch):
    """(JAX config, JAX model, params, port model) of the reduced arch."""
    jcfg = JARCHS[arch].reduced()
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.key(0))
    tm = params_from_jax(ARCHS[arch].reduced(),
                         jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, jm, params, tm


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape,
                                                       dtype=np.float32)


def _prefill_and_decode(arch, prompt, frontend, steps=6, max_seq=128):
    """Prefill (with ``frontend``) and decode steps on both sides; logits of
    every call to 1e-4.  Returns both final caches."""
    jcfg, jm, params, tm = _models(arch)
    rng = np.random.default_rng(len(prompt))
    toks = np.asarray([prompt], np.int32)
    src = 0 if frontend is None else frontend.shape[1]
    jc = jm.init_cache(1, max_seq, src_len=src) \
        if jcfg.family == "encdec" else jm.init_cache(1, max_seq)
    tc = tm.init_cache(1, max_seq, src_len=src)
    jfront = None if frontend is None else jnp.asarray(frontend)
    tfront = None if frontend is None else torch.from_numpy(frontend)
    jl, jc = jax.jit(jm.prefill)(params, jnp.asarray(toks), jc,
                                 frontend=jfront)
    tl, tc = tm.prefill(torch.from_numpy(toks), tc, frontend=tfront)
    assert tuple(tl.shape) == tuple(jl.shape)
    _close(tl, jl)
    jdec = jax.jit(jm.decode_step)
    for _ in range(steps):
        t = rng.integers(0, jcfg.vocab, (1, 1)).astype(np.int32)
        jl, jc = jdec(params, jnp.asarray(t), jc)
        tl, tc = tm.decode_step(torch.from_numpy(t), tc)
        _close(tl, jl)
    return tc, jc


def _prompt(arch, n, seed=0):
    vocab = JARCHS[arch].reduced().vocab
    return list(np.random.default_rng(seed).integers(0, vocab, n))


# ----------------------------------------------------------------------
# VLM and encoder-decoder
# ----------------------------------------------------------------------

def test_vlm_prefill_with_patch_embeddings_and_decode():
    arch = "llava-next-mistral-7b"
    jcfg, *_ = _models(arch)
    assert jcfg.frontend_tokens == 16
    prefix = _normal(1, (1, jcfg.frontend_tokens, jcfg.d_model))
    tc, jc = _prefill_and_decode(arch, _prompt(arch, 24), prefix)
    # the ring and the position cover the patches and the tokens
    assert int(tc["pos"][0]) == int(jc["pos"]) == 16 + 24 + 6
    for key in ("k", "v"):
        _close(tc[key], jc[key])
    np.testing.assert_array_equal(tc["kpos"].numpy()[0],
                                  np.asarray(jc["kpos"]))


def test_vlm_without_a_frontend_is_the_dense_stack():
    _prefill_and_decode("llava-next-mistral-7b",
                        _prompt("llava-next-mistral-7b", 20), None)


@pytest.mark.parametrize("frames", [16, 0])
def test_encdec_prefill_with_frames_and_decode(frames):
    """16 seeded frames; and zero frames, where the reference's cross-
    attention softmax over an empty axis gives zeros."""
    arch = "seamless-m4t-large-v2"
    jcfg, *_ = _models(arch)
    assert (jcfg.enc_layers, jcfg.n_layers) == (2, 2)
    src = _normal(2, (1, frames, jcfg.d_model))
    tc, jc = _prefill_and_decode(arch, _prompt(arch, 24), src)
    assert tuple(tc["enc_out"].shape) == (1, frames, jcfg.d_model)
    _close(tc["enc_out"], jc["enc_out"])
    for key in ("k", "v"):
        _close(tc[key], jc[key])


def test_cross_attention_over_no_frames_is_zeros():
    _, _, _, tm = _models("seamless-m4t-large-v2")
    layer = tm.decoder.decoder[0]
    x = torch.from_numpy(_normal(3, (2, 5, tm.cfg.d_model)))
    out = TL.attention_fwd(layer.xattn, tm.cfg, x, torch.arange(5),
                           kv_source=x[:, :0])
    assert out.shape == (2, 5, tm.cfg.d_model) and not bool(out.any())


def test_encdec_cache_without_enc_out_prefills():
    """The reference's dispatch: a decode step on a cache with no
    ``enc_out`` runs prefill, which needs the frontend."""
    _, _, _, tm = _models("seamless-m4t-large-v2")
    cache = tm.init_cache(1, 64, src_len=4)
    del cache["enc_out"]
    with pytest.raises(ValueError, match="frontend"):
        tm.decode_step(torch.zeros((1, 1), dtype=torch.int32), cache)


# ----------------------------------------------------------------------
# xLSTM: each cell, then the stack
# ----------------------------------------------------------------------

def _pair0(params):
    return jax.tree.map(lambda a: a[0], params["pairs"])


@pytest.mark.parametrize("cell", ["mlstm", "slstm"])
def test_xlstm_cell_matches_jax(cell):
    """A 12-token slab from zero states, then 5 more from the states it
    left (the JAX cell's own states on both sides), one token at a time
    at the end as decode runs it."""
    jcfg, _, params, tm = _models("xlstm-125m")
    jp = _pair0(params)[cell]
    port = getattr(tm.decoder.pairs[0], cell)
    jfwd = getattr(JS, f"{cell}_fwd")
    tfwd = getattr(TS, f"{cell}_fwd")
    x = _normal(4, (2, 17, jcfg.d_model))
    want, jstate = jfwd(jp, jcfg, jnp.asarray(x[:, :12]))
    got, tstate = tfwd(port, tm.cfg, torch.from_numpy(x[:, :12]))
    _close(got, want, CELL_TOL)
    for g, w in zip(tstate, jstate):
        _close(g, w, CELL_TOL)
    for lo, hi in ((12, 16), (16, 17)):
        state = tuple(torch.from_numpy(np.array(s)) for s in jstate)
        want, jstate = jfwd(jp, jcfg, jnp.asarray(x[:, lo:hi]), jstate)
        got, tstate = tfwd(port, tm.cfg, torch.from_numpy(x[:, lo:hi]),
                           state)
        _close(got, want, CELL_TOL)
        for g, w in zip(tstate, jstate):
            _close(g, w, CELL_TOL)


def test_xlstm_prefill_and_decode_match_jax():
    tc, jc = _prefill_and_decode("xlstm-125m", _prompt("xlstm-125m", 40),
                                 None, steps=8)
    for i, name in enumerate(TS.MLSTM_STATE):
        _close(tc[name], jc["mlstm"][i])
    for i, name in enumerate(TS.SLSTM_STATE):
        _close(tc[name], jc["slstm"][i])
    assert int(tc["pos"][0]) == int(jc["pos"]) == 48


def _xlstm_requests(vocab):
    rng = random.Random(5)
    return [(i, i * 0.003, [rng.randrange(vocab)
                            for _ in range(rng.randrange(8, 40))],
             rng.randrange(4, 16)) for i in range(8)]


def test_xlstm_engine_matches_jax():
    jcfg, jm, params, tm = _models("xlstm-125m")
    workload = ("xlstm-125m",
                dict(max_slots=4, max_seq=128, n_pages=128, page_size=16),
                False, _xlstm_requests(jcfg.vocab), 300)
    for got, want in engine_parity(jm, params, tm, workload):
        _close(got, want)


# ----------------------------------------------------------------------
# caches, seeded weights, full-size structure
# ----------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-0.6b", "zamba2-7b", *NEW_ARCHS])
def test_init_cache_keys_and_batch_axes(arch):
    cfg = ARCHS[arch].reduced()
    m = build_model(cfg, device="cpu", seed=0)
    cache = m.init_cache(3, 64, 16, src_len=5)
    tensors = set(cache) - {"page_size"}
    assert tensors <= set(CACHE_BATCH_AXIS)
    for key in tensors:
        assert cache[key].shape[CACHE_BATCH_AXIS[key]] == 3, key
    if cfg.family == "encdec":
        assert cache["enc_out"].shape == (3, 5, cfg.d_model)
        assert cache["enc_out"].dtype == cache["k"].dtype
    if cfg.family == "ssm":
        n_pairs, h, d = cfg.n_layers // 2, cfg.n_heads, cfg.d_model
        dh = d // h
        assert tensors == set(TS.MLSTM_STATE + TS.SLSTM_STATE) | {"pos"}
        assert cache["mlstm_C"].shape == (n_pairs, 3, h, dh, dh)
        assert cache["mlstm_n"].shape == (n_pairs, 3, h, dh)
        assert cache["mlstm_m"].shape == (n_pairs, 3, h)
        for name in TS.SLSTM_STATE:
            assert cache[name].shape == (n_pairs, 3, d)
        for name in ("mlstm_m", "slstm_m"):
            assert bool((cache[name] == -1e30).all())
        assert all(cache[k].dtype == torch.float32 for k in tensors - {"pos"})
    else:
        assert {"k", "v", "kpos", "pos"} <= tensors


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_build_model_draws_every_weight_at_the_reference_scale(arch):
    """Every weight of two or more axes, experts' and the sLSTM's recurrent
    ones included, is drawn N(0, 1/fan_in) with fan_in its next-to-last
    axis (the embedding N(0, 0.02)); none is left at zero; the 1-D
    parameters are the reference's constants."""
    cfg = ARCHS[arch].reduced()
    net = build_model(cfg, device="cpu", seed=1).decoder
    for name, p in net.named_parameters():
        if p.dim() < 2:
            continue
        std = 0.02 if name == "embed" else 1.0 / math.sqrt(p.shape[-2])
        ratio = float(p.float().std()) / std
        assert abs(ratio - 1) < 0.02 + 4 / math.sqrt(p.numel()), \
            (name, ratio)
    if cfg.is_moe:
        assert tuple(net.layers[0].moe.w_down.shape) == (
            cfg.n_experts, cfg.expert_d_ff, cfg.d_model)
    if cfg.family == "ssm":
        d = cfg.d_model
        pair = net.pairs[0]
        assert bool((pair.mlstm.f_bias == 3.0).all())
        bias = pair.slstm.bias
        assert bool((bias[2 * d:3 * d] == 3.0).all())
        assert not bool(bias[:2 * d].any()) and not bool(bias[3 * d:].any())
        assert pair.slstm.r_h.dtype == torch.float32


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_full_size_stack_has_the_reference_leaves(arch):
    """The full-size configuration built on the meta device: one parameter
    per slice of every stacked leaf of the reference's tree
    (``jax.eval_shape`` of its init), of the same shape and dtype."""
    cfg = ARCHS[arch]
    jm = jax_build_model(JARCHS[arch])
    tree = jax.eval_shape(jm.init, jax.random.key(0))
    stacks = _stacks(cfg)
    want = {}
    for path, leaf in _flatten(tree).items():
        top, _, rest = path.partition(".")
        axes = stacks.get(top, ())
        assert tuple(leaf.shape[:len(axes)]) == axes, path
        for idx in np.ndindex(*axes):
            name = ".".join([top, *map(str, idx), rest]) if axes else path
            want[name] = (tuple(leaf.shape[len(axes):]), str(leaf.dtype))
    net = net_type(cfg)(cfg, torch.device("meta"))
    got = {name: (tuple(p.shape), str(p.dtype).replace("torch.", ""))
           for name, p in net.named_parameters()}
    assert got == want
