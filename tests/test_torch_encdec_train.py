"""The encoder-decoder's training forward attends through ``sdpa``, never
through the flash kernel, as the JAX package trains; serving keeps the
flash kernel.

On the card ``ops.flash_attention`` refuses an input that requires a
gradient (the kernel has no backward); on the CPU it runs its
differentiable plain version, so the refusal cannot show here by itself.
These tests make ``ops.flash_attention`` raise as the card does, whenever
an input requires a gradient under grad mode, and then run the reduced
``seamless-m4t-large-v2``'s ``Model.loss`` and gradients against
``jax.grad`` of the reference at the tolerances of
``tests/test_torch_train.py`` (loss 1e-4, each gradient 1e-4 of its
largest magnitude)."""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from test_torch_train import TOL, _models, _rel, batch_for  # noqa: E402

ARCH = "seamless-m4t-large-v2"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def flash_calls(monkeypatch):
    """``ops.flash_attention`` as the card's entry behaves under grad: it
    raises for an input that requires a gradient.  Returns the list of
    ``causal`` flags of the calls that ran."""
    real = ops.flash_attention
    calls = []

    def guarded(q, k, v, **kw):
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            raise RuntimeError("flash attention reached under grad")
        calls.append(kw.get("causal", True))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention", guarded)
    return calls


@pytest.mark.parametrize("over", [{}, {"remat": True}],
                         ids=["plain", "remat"])
def test_encdec_loss_and_grads_never_reach_flash(flash_calls, over):
    jm, params, tm = _models(ARCH, over)
    batch = batch_for(tm.cfg, seed=4)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm.loss))(params, batch)

    for p in tm.decoder.parameters():
        p.requires_grad_(True)
    loss = tm.loss(batch)
    loss.backward()
    assert flash_calls == []
    assert abs(float(loss.detach()) - float(jloss)) <= TOL * max(
        1.0, abs(float(jloss)))
    want = dict(params_from_jax(tm.cfg, jax.tree.map(np.asarray, jgrads),
                                device="cpu").decoder.named_parameters())
    worst = max((_rel(p.grad, want[name].detach()), name)
                for name, p in tm.decoder.named_parameters())
    assert worst[0] <= TOL, f"gradient of {worst[1]} off by {worst[0]}"


def test_encdec_serving_still_attends_through_flash(flash_calls):
    """Prefill and a decode step run under ``torch.no_grad()`` with the
    parameters requiring gradients: every encoder layer and every
    cross-attention goes through ``ops.flash_attention`` (bidirectional),
    the decoder's self-attention over the fresh slab too."""
    _, _, tm = _models(ARCH, {})
    for p in tm.decoder.parameters():
        p.requires_grad_(True)
    cfg = tm.cfg
    rng = np.random.default_rng(5)
    frames = torch.from_numpy(rng.standard_normal(
        (1, 16, cfg.d_model)).astype(np.float32))
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (1, 8))
                            .astype(np.int32))
    cache = tm.init_cache(1, 64, src_len=16)
    _, cache = tm.prefill(toks, cache, frontend=frames)
    prefill = list(flash_calls)
    assert prefill.count(False) == cfg.enc_layers + cfg.n_layers
    assert prefill.count(True) == cfg.n_layers
    tm.decode_step(toks[:, :1], cache)
    assert flash_calls[len(prefill):].count(False) == cfg.n_layers
