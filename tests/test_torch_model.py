"""The port's dense layers, decoder and Model against the JAX package on the
CPU, with the JAX weights carried over by ``bridge.params_from_jax``.

Layer functions hold to 2e-5 (f32, one op each).  Whole-model logits and
caches hold to 1e-4: two layers of f32 sums are taken in another order, and
the port's prefill and decode attention run the kernels' plain versions
where the JAX package runs ``sdpa`` over the masked cache."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.transformer import ring_info as jax_ring_info  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import build_model, layers as TL  # noqa: E402
from repro_torch.models.transformer import ring_info  # noqa: E402

TOL = 2e-5
MODEL_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes side by side; one intra-op
    thread each keeps torch's many small CPU ops from oversubscribing the
    cores (its spinning worker threads slow every process down)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def qwen():
    jcfg = JARCHS["qwen3-0.6b"].reduced()
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.key(0))
    tree = jax.tree.map(np.asarray, params)
    tm = params_from_jax(ARCHS["qwen3-0.6b"].reduced(), tree, device="cpu")
    return jcfg, jm, params, tm


def test_bridge_maps_every_leaf(qwen):
    jcfg, _, params, tm = qwen
    n_jax = sum(np.asarray(x).size for x in jax.tree.leaves(params))
    n_port = sum(p.numel() for p in tm.decoder.parameters())
    assert n_jax == n_port
    _close(tm.decoder.layers[1].attn.wk.numpy(),
           np.asarray(params["layers"]["attn"]["wk"][1]), 0)
    with pytest.raises((KeyError, ValueError)):
        bad = jax.tree.map(np.asarray, params)
        bad["layers"]["mlp"]["w_up"] = bad["layers"]["mlp"]["w_up"][:, :4]
        params_from_jax(ARCHS["qwen3-0.6b"].reduced(), bad, device="cpu")


def test_cuda_without_a_card_is_an_error():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        build_model(ARCHS["qwen3-0.6b"].reduced(), device="cuda")


def test_rmsnorm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 128), dtype=np.float32) * 3
    scale = rng.standard_normal(128, dtype=np.float32)
    _close(TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6),
           JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6))


@pytest.mark.parametrize("batched", [False, True])
def test_apply_rope(batched):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 4, 32), dtype=np.float32)
    pos = np.arange(7, dtype=np.int32) + 100
    if batched:
        pos = np.stack([pos, pos + 37])
    _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))


@pytest.mark.parametrize("mask_kind", ["none", "causal", "per_row"])
def test_sdpa(mask_kind):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 6, 8, 32), dtype=np.float32)
    k = rng.standard_normal((2, 10, 2, 32), dtype=np.float32)
    v = rng.standard_normal((2, 10, 2, 32), dtype=np.float32)
    if mask_kind == "none":
        tm = jm = None
    elif mask_kind == "causal":
        m = np.array(JL._causal_mask(6, 10, 0, 4))
        tm, jm = torch.from_numpy(m), jnp.asarray(m)
    else:
        m = rng.random((2, 6, 10)) < 0.7
        m[:, :, 0] = True
        tm, jm = torch.from_numpy(m), jnp.asarray(m)[:, None, None]
    _close(TL.sdpa(*(torch.from_numpy(a) for a in (q, k, v)), tm),
           JL.sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jm))


def test_mlp(qwen):
    _, _, params, tm = qwen
    x = np.random.default_rng(3).standard_normal((2, 5, 128),
                                                 dtype=np.float32)
    jp = jax.tree.map(lambda a: a[0], params["layers"]["mlp"])
    _close(TL.mlp_fwd(tm.decoder.layers[0].mlp, torch.from_numpy(x)),
           JL.mlp_fwd(jp, jnp.asarray(x)))


# ----------------------------------------------------------------------
# attention_fwd: every branch
# ----------------------------------------------------------------------

def _attention_both(qwen, s, pos, max_seq, fill, use_kernel=False):
    """Run layer 0's attention on both sides.  ``fill`` tokens were written
    before (positions 0..fill-1, same for both rows); ``pos`` is the first
    new position.  Returns (port out, jax out, port cache, jax cache)."""
    jcfg, _, params, tm = qwen
    cfg = tm.cfg
    rng = np.random.default_rng(s * 100 + pos)
    b, hkv, hd = 2, cfg.n_kv_heads, cfg.hd
    x = rng.standard_normal((b, s, cfg.d_model), dtype=np.float32)
    attn = tm.decoder.layers[0].attn
    jp = jax.tree.map(lambda a: a[0], params["layers"]["attn"])
    if max_seq is None:
        positions = np.arange(s, dtype=np.int32)
        out_t = TL.attention_fwd(attn, cfg, torch.from_numpy(x),
                                 torch.from_numpy(positions),
                                 use_kernel=use_kernel)
        out_j, _ = jax.jit(lambda p, x, pos: JL.attention_fwd(
            p, jcfg, x, pos))(jp, jnp.asarray(x), jnp.asarray(positions))
        return out_t, out_j, None, None
    ck = rng.standard_normal((b, max_seq, hkv, hd), dtype=np.float32)
    cv = rng.standard_normal((b, max_seq, hkv, hd), dtype=np.float32)
    kpos = np.full(max_seq, -1, np.int32)
    kpos[:fill] = np.arange(fill)
    ring_j, _ = jax_ring_info(jnp.int32(pos), s, max_seq, jnp.asarray(kpos))
    ring_j.pop("shard")
    out_j, cache_j = jax.jit(lambda p, x, kv: JL.attention_fwd(
        p, jcfg, x, kv["q_pos"], kv_cache=kv))(
        jp, jnp.asarray(x),
        {"k": jnp.asarray(ck), "v": jnp.asarray(cv), **ring_j})
    ring_t, _ = ring_info(torch.full((b,), pos, dtype=torch.int32), s,
                          max_seq, torch.from_numpy(np.stack([kpos] * b)),
                          fresh=pos == 0, page_size=16)
    kv = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy()),
          **ring_t}
    out_t = TL.attention_fwd(attn, cfg, torch.from_numpy(x),
                             ring_t["q_pos"], kv_cache=kv)
    return out_t, out_j, kv, cache_j


@pytest.mark.parametrize("branch,s,pos,max_seq,fill", [
    ("fresh_prefill_flash", 20, 0, 64, 0),
    ("decode_paged", 1, 20, 64, 20),
    ("decode_paged_wrapped", 1, 100, 64, 64),
    ("prefill_at_pos_sdpa", 5, 20, 64, 20),
    ("in_slab_flash", 80, 0, 64, 0),
])
def test_attention_cache_branches(qwen, branch, s, pos, max_seq, fill):
    out_t, out_j, kv, cache_j = _attention_both(qwen, s, pos, max_seq, fill)
    _close(out_t, out_j, MODEL_TOL)
    _close(kv["k"], cache_j["k"], MODEL_TOL)
    _close(kv["v"], cache_j["v"], MODEL_TOL)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_attention_no_cache(qwen, use_kernel):
    out_t, out_j, _, _ = _attention_both(qwen, 24, 0, None, 0, use_kernel)
    _close(out_t, out_j, MODEL_TOL)


# ----------------------------------------------------------------------
# Model: prefill + decode steps, logits and caches
# ----------------------------------------------------------------------

def _run_both(arch, prompt_len, max_seq, steps, seed=0):
    jcfg = JARCHS[arch].reduced()
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.key(seed))
    tm = params_from_jax(ARCHS[arch].reduced(), jax.tree.map(np.asarray,
                                                             params),
                         device="cpu")
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, jcfg.vocab, (1, prompt_len)).astype(np.int32)
    jpre = jax.jit(jm.prefill)
    jdec = jax.jit(jm.decode_step)
    jl, jc = jpre(params, jnp.asarray(toks), jm.init_cache(1, max_seq))
    tl, tc = tm.prefill(torch.from_numpy(toks), tm.init_cache(1, max_seq))
    pairs = [(tl, jl)]
    for _ in range(steps):
        t = rng.integers(0, jcfg.vocab, (1, 1)).astype(np.int32)
        jl, jc = jdec(params, jnp.asarray(t), jc)
        tl, tc = tm.decode_step(torch.from_numpy(t), tc)
        pairs.append((tl, jl))
    for got, want in pairs:
        assert tuple(got.shape) == tuple(want.shape)
        _close(got, want, MODEL_TOL)
    for key in ("k", "v"):
        _close(tc[key], jc[key], MODEL_TOL)
    np.testing.assert_array_equal(tc["kpos"].numpy()[0], np.asarray(jc["kpos"]))
    assert int(tc["pos"][0]) == int(jc["pos"])
    return tc


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "llama3.2-3b"])
def test_prefill_and_decode_match_jax(arch):
    _run_both(arch, prompt_len=24, max_seq=64, steps=8)


def test_decode_wraps_the_ring():
    cache = _run_both("qwen3-0.6b", prompt_len=16, max_seq=64, steps=80)
    assert int(cache["pos"][0]) == 96


def test_bucket_at_least_max_seq_takes_the_in_slab_branch():
    cache = _run_both("qwen3-0.6b", prompt_len=64, max_seq=32, steps=8)
    assert int(cache["pos"][0]) == 72


def test_per_row_positions_match_vmapped_jax(qwen):
    """Two rows at different positions in one batched decode call, as the
    engine runs its slots, against the JAX decode vmapped over rows."""
    jcfg, jm, params, tm = qwen
    rng = np.random.default_rng(5)
    lens = (10, 27)
    jcaches, tcaches = [], []
    jpre = jax.jit(jm.prefill)
    for n in lens:
        toks = rng.integers(0, jcfg.vocab, (1, n)).astype(np.int32)
        _, jc = jpre(params, jnp.asarray(toks), jm.init_cache(1, 64))
        _, tc = tm.prefill(torch.from_numpy(toks), tm.init_cache(1, 64))
        jcaches.append(jc)
        tcaches.append(tc)
    jstack = jax.tree.map(lambda *a: jnp.stack(a), *jcaches)
    tstack = {k: torch.cat([c[k] for c in tcaches], dim=0 if k in
                           ("kpos", "pos") else 1)
              for k in ("k", "v", "kpos", "pos")}
    tstack["page_size"] = 16
    step = jax.jit(jax.vmap(lambda t, c: jm.decode_step(params, t, c)))
    for _ in range(3):
        t = rng.integers(0, jcfg.vocab, (2, 1)).astype(np.int32)
        jl, jstack = step(jnp.asarray(t)[:, None], jstack)
        tl, tstack = tm.decode_step(torch.from_numpy(t), tstack)
        _close(tl, np.asarray(jl)[:, 0], MODEL_TOL)
    np.testing.assert_array_equal(tstack["pos"].numpy(),
                                  np.asarray(jstack["pos"]))
