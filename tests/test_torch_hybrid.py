"""The port's zamba2 hybrid (Mamba2 backbone + one shared attention block)
against the JAX package on the CPU, with the JAX weights carried over by
``bridge.params_from_jax``, on ``zamba2-7b`` reduced to 5 layers: two
super-blocks of two Mamba2 layers, each followed by the shared block, and
one tail layer.

Tolerances, and why the whole model is held to 1e-3 and each layer to 1e-4:

- Layer by layer (``LAYER_TOL`` = 1e-4): every Mamba2 layer, every
  application of the shared block and every cache entry it writes (states,
  k, v), each fed the JAX model's own input to that layer, on every call of
  a prefill (one chunk, two chunks, in-slab, no cache) and decode steps.
- Whole model (``MODEL_TOL`` = 1e-3, the JAX package's own tolerance for
  its hybrid's cached path against its full forward, tests/test_models.py):
  logits of every call and the Mamba2 states.  Each Mamba2 layer of this
  random-init model multiplies the rounding differences of its input by
  3-5 (a decay exp(dt * A), A up to 16, turns a small relative error of dt
  into a larger one of the state), so two f32 implementations that agree
  to ~1e-5 per layer drift apart through the stack: on a 200-token prompt
  the JAX model's logits sit 1.2e-3 and the port's 6.8e-4 from a float64
  run of the port with the same weights, and port and JAX differ by up to
  2.6e-4.  The shared block's KV cache, read after four such layers, is
  held layer by layer only.
- Engine: reports and every telemetry batch exactly equal to the JAX
  engine's on the workloads of tests/test_torch_engine.py, logits of every
  call (teacher-forced tokens, as there) to ``MODEL_TOL``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models.transformer import ring_info as jax_ring_info  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.model import CACHE_BATCH_AXIS  # noqa: E402
from repro_torch.models.transformer import ring_info  # noqa: E402
from repro_torch.serving import EngineConfig, InferenceEngine  # noqa: E402
from repro_torch.serving import ServeRequest  # noqa: E402
from test_torch_engine import WORKLOADS, engine_parity  # noqa: E402

LAYER_TOL = 1e-4
MODEL_TOL = 1e-3
ARCH = "zamba2-7b"
N_LAYERS = 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes side by side; one intra-op
    thread each keeps torch's many small CPU ops from oversubscribing the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=LAYER_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.fixture(scope="module")
def hybrid():
    jcfg = JARCHS[ARCH].reduced(n_layers=N_LAYERS)
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.key(0))
    tm = params_from_jax(ARCHS[ARCH].reduced(n_layers=N_LAYERS),
                         jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, jm, params, tm


def test_config_has_super_blocks_and_a_tail(hybrid):
    jcfg, _, params, tm = hybrid
    assert divmod(jcfg.n_layers, jcfg.attn_every) == (2, 1)
    assert len(tm.decoder.blocks) == 2 and len(tm.decoder.tail) == 1
    assert all(len(b) == jcfg.attn_every for b in tm.decoder.blocks)


def test_bridge_maps_every_hybrid_leaf(hybrid):
    jcfg, _, params, tm = hybrid
    n_jax = sum(np.asarray(x).size for x in jax.tree.leaves(params))
    n_port = sum(p.numel() for p in tm.decoder.parameters())
    assert n_jax == n_port
    net = tm.decoder
    _close(net.blocks[1][0].mamba.in_proj.numpy(),
           params["blocks"]["mamba"]["in_proj"][1, 0], 0)
    _close(net.blocks[0][1].mamba.A_log.numpy(),
           params["blocks"]["mamba"]["A_log"][0, 1], 0)
    _close(net.tail[0].mamba.out_proj.numpy(),
           params["tail"]["mamba"]["out_proj"][0], 0)
    _close(net.shared.attn.wk.numpy(), params["shared"]["attn"]["wk"], 0)
    _close(net.lm_head.numpy(), params["lm_head"], 0)
    cfg = ARCHS[ARCH].reduced(n_layers=N_LAYERS)
    tree = jax.tree.map(np.asarray, params)
    bad = jax.tree.map(lambda a: a, tree)
    bad["blocks"]["mamba"]["D"] = bad["blocks"]["mamba"]["D"][:1]
    with pytest.raises(ValueError):
        params_from_jax(cfg, bad, device="cpu")
    extra = jax.tree.map(lambda a: a, tree)
    extra["shared"]["bogus"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError):
        params_from_jax(cfg, extra, device="cpu")
    missing = jax.tree.map(lambda a: a, tree)
    del missing["tail"]
    with pytest.raises(KeyError):
        params_from_jax(cfg, missing, device="cpu")


def test_seeded_build_matches_the_reference_scheme():
    cfg = ARCHS[ARCH].reduced(n_layers=N_LAYERS)
    m = build_model(cfg, device="cpu", seed=3)
    again = build_model(cfg, device="cpu", seed=3)
    for (name, p), (_, q) in zip(m.decoder.named_parameters(),
                                 again.decoder.named_parameters()):
        assert torch.equal(p, q), name
    mamba = m.decoder.blocks[0][0].mamba
    _close(mamba.A_log.numpy(), np.log(np.linspace(1, 16, cfg.ssm_heads)),
           1e-6)
    assert bool((mamba.D == 1).all()) and not bool(mamba.dt_bias.any())
    w = mamba.in_proj.detach()
    assert abs(float(w.std()) * cfg.d_model ** 0.5 - 1) < 0.05
    cache = m.init_cache(3, 64)
    assert set(cache) == {"k", "v", "kpos", "pos", "ssm", "ssm_tail",
                          "page_size"}
    for key in set(cache) - {"page_size"}:
        assert cache[key].shape[CACHE_BATCH_AXIS[key]] == 3, key
    assert cache["k"].shape == (2, 3, 64, cfg.n_kv_heads, cfg.hd)
    assert cache["ssm"].dtype == torch.float32


# ----------------------------------------------------------------------
# whole model: prefill, then decode steps
# ----------------------------------------------------------------------

CASES = {               # prompt length, max_seq
    "one_chunk": (24, 64),
    "two_chunks": (200, 256),       # the scan carries a state across chunks
    "in_slab": (64, 32),            # bucket >= max_seq
}


def _tokens(rng, jcfg, n):
    return rng.integers(0, jcfg.vocab, (1, n)).astype(np.int32)


@pytest.mark.parametrize("case", sorted(CASES))
def test_prefill_and_decode_match_jax(hybrid, case):
    jcfg, jm, params, tm = hybrid
    prompt, max_seq = CASES[case]
    rng = np.random.default_rng(prompt)
    toks = _tokens(rng, jcfg, prompt)
    jl, jc = jax.jit(jm.prefill)(params, jnp.asarray(toks),
                                 jm.init_cache(1, max_seq))
    tl, tc = tm.prefill(torch.from_numpy(toks), tm.init_cache(1, max_seq))
    pairs = [(tl, jl)]
    jdec = jax.jit(jm.decode_step)
    for _ in range(8):
        t = _tokens(rng, jcfg, 1)
        jl, jc = jdec(params, jnp.asarray(t), jc)
        tl, tc = tm.decode_step(torch.from_numpy(t), tc)
        pairs.append((tl, jl))
    for got, want in pairs:
        assert tuple(got.shape) == tuple(want.shape)
        _close(got, want, MODEL_TOL)
    for key in ("ssm", "ssm_tail"):
        assert tuple(tc[key].shape) == tuple(jc[key].shape)
        _close(tc[key], jc[key], MODEL_TOL)
    assert tuple(tc["k"].shape) == tuple(jc["k"].shape)
    np.testing.assert_array_equal(tc["kpos"].numpy()[0],
                                  np.asarray(jc["kpos"]))
    assert int(tc["pos"][0]) == int(jc["pos"]) == prompt + 8


def test_no_cache_forward_matches_jax(hybrid):
    jcfg, jm, params, tm = hybrid
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab, (2, 24)).astype(np.int32)
    want, _ = jax.jit(lambda p, t: jm.forward(p, {"tokens": t}))(
        params, jnp.asarray(toks))
    got, _, cache = tm.decoder(torch.from_numpy(toks))
    assert cache is None
    _close(got, want, MODEL_TOL)


def test_rows_at_different_positions_match_vmapped_jax(hybrid):
    """Two rows prefilled apart and decoded in one batched call, as the
    engine runs its slots, against the JAX decode vmapped over rows."""
    jcfg, jm, params, tm = hybrid
    rng = np.random.default_rng(5)
    jcaches, tcaches = [], []
    for n in (10, 27):
        toks = _tokens(rng, jcfg, n)
        _, jc = jax.jit(jm.prefill)(params, jnp.asarray(toks),
                                    jm.init_cache(1, 64))
        _, tc = tm.prefill(torch.from_numpy(toks), tm.init_cache(1, 64))
        jcaches.append(jc)
        tcaches.append(tc)
    jstack = jax.tree.map(lambda *a: jnp.stack(a), *jcaches)
    tstack = {k: torch.cat([c[k] for c in tcaches], dim=axis)
              for k, axis in CACHE_BATCH_AXIS.items() if k in tcaches[0]}
    tstack["page_size"] = 16
    step = jax.jit(jax.vmap(lambda t, c: jm.decode_step(params, t, c)))
    for _ in range(3):
        t = rng.integers(0, jcfg.vocab, (2, 1)).astype(np.int32)
        jl, jstack = step(jnp.asarray(t)[:, None], jstack)
        tl, tstack = tm.decode_step(torch.from_numpy(t), tstack)
        _close(tl, np.asarray(jl)[:, 0], MODEL_TOL)
    _close(tstack["ssm"], np.asarray(jstack["ssm"])[:, :, :, 0]
           .transpose(1, 2, 0, 3, 4, 5), MODEL_TOL)
    np.testing.assert_array_equal(tstack["pos"].numpy(),
                                  np.asarray(jstack["pos"]))


# ----------------------------------------------------------------------
# layer by layer: each port layer fed the JAX model's input to it
# ----------------------------------------------------------------------

def _jax_layers(params, jcfg, tokens, cache):
    """The JAX package's hybrid forward (``hybrid_fwd``) unrolled with its
    own layer functions, recording every layer: (kind, index, input,
    output, what it writes to the cache).  ``cache`` None: no-cache path."""
    eps = jcfg.norm_eps
    x = params["embed"][tokens]
    s = tokens.shape[1]
    if cache is None:
        positions, ring = jnp.arange(s), None
    else:
        ring, _ = jax_ring_info(cache["pos"], s, cache["k"].shape[2],
                                cache["kpos"])
        ring.pop("shard")
        positions = ring["q_pos"]

    @jax.jit
    def mamba(lp, x, st):
        h = JL.rmsnorm(lp["ln"], x, eps)
        if cache is not None and s == 1:
            y, st = JS.mamba2_step(lp["mamba"], jcfg, h, st)
        else:
            y, st = JS.mamba2_fwd(lp["mamba"], jcfg, h, state=st)
        return x + y, st

    @jax.jit
    def shared_block(sp, x, kv):
        h = JL.rmsnorm(sp["ln1"], x, eps)
        a, nc = JL.attention_fwd(sp["attn"], jcfg, h, positions, kv_cache=kv)
        out = x + a
        return out + JL.mlp_fwd(sp["mlp"], JL.rmsnorm(sp["ln2"], out,
                                                      eps)), nc

    shared = params["shared"]
    rec = []
    n_super = jcfg.n_layers // jcfg.attn_every
    for i in range(n_super):
        for j in range(jcfg.attn_every):
            lp = jax.tree.map(lambda t: t[i, j], params["blocks"])
            st = None if cache is None else cache["ssm"][i, j]
            out, st = mamba(lp, x, st)
            rec.append(("mamba", (i, j), x, out, st))
            x = out
        kv = None if cache is None else {"k": cache["k"][i],
                                         "v": cache["v"][i], **ring}
        out, nc = shared_block(shared, x, kv)
        rec.append(("shared", i, x, out, nc))
        x = out
    for j in range(jcfg.n_layers % jcfg.attn_every):
        lp = jax.tree.map(lambda t: t[j], params["tail"])
        st = None if cache is None else cache["ssm_tail"][j]
        out, st = mamba(lp, x, st)
        rec.append(("tail", j, x, out, st))
        x = out
    return rec


def _port_layers_agree(tm, rec, cache, tokens):
    """Feed each port layer the JAX layer's input and compare its output
    and every cache entry it writes."""
    net = tm.decoder
    s = tokens.shape[1]
    ring = None
    if cache is not None:
        ring, _ = ring_info(
            torch.tensor([int(cache["pos"])], dtype=torch.int32), s,
            cache["k"].shape[2],
            torch.from_numpy(np.array(cache["kpos"])[None]),
            fresh=int(cache["pos"]) == 0, page_size=16)
    for kind, idx, x_in, want, written in rec:
        x_in = torch.from_numpy(np.array(x_in))
        if kind == "shared":
            if cache is None:
                got, _ = net.shared(x_in, torch.arange(s))
            else:
                kv = {"k": torch.from_numpy(np.array(cache["k"][idx])),
                      "v": torch.from_numpy(np.array(cache["v"][idx])),
                      **ring}
                got, _ = net.shared(x_in, ring["q_pos"], kv)
                _close(kv["k"], written["k"])
                _close(kv["v"], written["v"])
        else:
            layer = net.blocks[idx[0]][idx[1]] if kind == "mamba" \
                else net.tail[idx]
            if cache is None:
                got = layer(x_in)
            else:
                key = "ssm" if kind == "mamba" else "ssm_tail"
                state = torch.from_numpy(np.array(cache[key][idx]))
                got = layer(x_in, state)
                _close(state, written)
        _close(got, want)


@pytest.mark.parametrize("case", ["two_chunks", "in_slab", "no_cache"])
def test_every_layer_matches_jax_on_the_same_input(hybrid, case):
    jcfg, jm, params, tm = hybrid
    prompt, max_seq = CASES.get(case, (200, None))
    toks = _tokens(np.random.default_rng(prompt), jcfg, prompt)
    if case == "no_cache":
        rec = _jax_layers(params, jcfg, jnp.asarray(toks), None)
        _port_layers_agree(tm, rec, None, toks)
        return
    cache = jm.init_cache(1, max_seq)
    calls = [toks] + [_tokens(np.random.default_rng(i), jcfg, 1)
                      for i in range(2)]
    jdec = jax.jit(jm.decode_step)
    for n, t in enumerate(calls):
        rec = _jax_layers(params, jcfg, jnp.asarray(t), cache)
        _port_layers_agree(tm, rec, cache, t)
        step = jax.jit(jm.prefill) if n == 0 else jdec
        _, cache = step(params, jnp.asarray(t), cache)


# ----------------------------------------------------------------------
# engine
# ----------------------------------------------------------------------

@pytest.mark.parametrize("workload", sorted(WORKLOADS))
def test_engine_matches_jax(hybrid, workload):
    _, jm, params, tm = hybrid
    for got, want in engine_parity(jm, params, tm, workload):
        _close(got, want, MODEL_TOL)


def test_engine_writes_every_cache_tensor_into_its_slot(hybrid):
    _, _, _, tm = hybrid
    eng = InferenceEngine(tm, EngineConfig(max_slots=3, max_seq=64,
                                           n_pages=64, telemetry=False))
    eng.submit(ServeRequest(0, 0.0, [5] * 20, 2))
    eng._admit_loop()                         # one prefill, no decode step
    (slot,) = eng.sched.running
    cache = eng.slot_cache
    others = [s for s in range(3) if s != slot]
    assert int(cache["pos"][slot]) == 64      # the 64-token bucket
    assert not bool(cache["pos"][others].any())
    assert int((cache["kpos"][slot] >= 0).sum()) == 64
    for key, axis in CACHE_BATCH_AXIS.items():
        if key in ("pos", "kpos") or key not in cache:
            continue
        assert bool(cache[key].select(axis, slot).any()), key
        assert not bool(cache[key].index_select(
            axis, torch.tensor(others)).any()), key
