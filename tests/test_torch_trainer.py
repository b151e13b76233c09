"""The port's Trainer, checkpoints and training launcher against the JAX
package's on the CPU.

- Parity: reduced f32 qwen3-0.6b from bridged weights, 6 steps of 2
  microbatches, with and without bf16 compression, on the same packed
  batches: the history's loss, grad norm and lr to 1e-4, and the same
  telemetry events (kind, node, device, size) apart from their timestamps.
- The reference's ``TestTrainer`` and ``TestCheckpoint``
  (tests/test_serving_training.py) and its per-family
  ``test_train_step_reduces_loss_and_is_finite`` (tests/test_models.py)
  re-run on the port.
- Checkpoints both ways: the reference's ``checkpoint.restore`` reads the
  port Trainer's checkpoint and the port's Trainer resumes from the
  reference's; the loss on the restored weights agrees to 1e-5.
- ``python -m repro_torch.launch.train --device cpu`` prints the
  reference launcher's lines (numbers aside), resumes, and its loss falls.
"""

import contextlib
import io
import os
import re
import sys
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import ASSIGNED  # noqa: E402
from repro.data import DataConfig, SyntheticCorpus, pack_documents  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.training import TrainConfig as JTrainConfig  # noqa: E402
from repro.training import Trainer as JTrainer  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training.optimizer import adamw_init as jadamw_init  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.parallel import accumulate_grads, init_error_buf  # noqa: E402
from repro_torch.training import AdamWConfig, TrainConfig, Trainer  # noqa: E402
from repro_torch.training import checkpoint as ckpt  # noqa: E402
from repro_torch.training.optimizer import adamw_init, adamw_update  # noqa: E402
from test_torch_train import batch_for  # noqa: E402

TOL = 1e-4
CKPT_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Sink:
    """A telemetry plane that only keeps what it observes."""
    controller = None

    def __init__(self) -> None:
        self.events = []

    def observe(self, ev) -> None:
        self.events.append((int(ev.kind), ev.node, ev.device, ev.flow,
                            ev.size))


def _qwen():
    jcfg = JARCHS["qwen3-0.6b"].reduced()
    jm = jax_build_model(jcfg)
    params = jm.init(jax.random.key(0))
    tm = params_from_jax(ARCHS["qwen3-0.6b"].reduced(),
                         jax.tree.map(np.asarray, params), device="cpu")
    return jcfg, jm, params, tm


def _batches(cfg, n: int, batch: int = 4, seq: int = 32, seed: int = 1):
    dc = DataConfig(vocab=cfg.vocab, seq_len=seq, batch=batch, seed=seed)
    return list(pack_documents(SyntheticCorpus(dc), n))


@pytest.mark.parametrize("compress", [False, True])
def test_trainer_matches_the_reference(compress):
    jcfg, jm, params, tm = _qwen()
    batches = _batches(jcfg, 6)
    kw = dict(steps=6, n_micro=2, compress_grads=compress)
    jsink, tsink = Sink(), Sink()
    jhist = JTrainer(jm, params, JTrainConfig(**kw), plane=jsink).run(
        batches)
    trainer = Trainer(tm, TrainConfig(**kw), plane=tsink)
    thist = trainer.run(batches)
    assert [h["step"] for h in thist] == [h["step"] for h in jhist]
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose([h[key] for h in thist],
                                   [h[key] for h in jhist], rtol=TOL)
    assert tsink.events == jsink.events
    assert all({"sec", "straggler_z"} <= set(h) for h in thist)
    assert ("error_buf" in trainer.opt_state) == compress


class Controller:
    engine = None


def test_trainer_is_the_controllers_engine_and_applies_actions():
    plane = Sink()
    plane.controller = Controller()
    tr = Trainer(build_model(ARCHS["qwen3-0.6b"].reduced(), device="cpu"),
                 TrainConfig(steps=1), plane=plane)
    assert plane.controller.engine is tr
    assert tr.apply_action("rebalance_microbatches", 0, {})
    assert not tr.apply_action("inflight_remap", 0, {})
    assert all(p.requires_grad for p in tr.params.values())


# ----------------------------------------------------------------------
# the reference's TestTrainer, TestCheckpoint and train-step tests
# ----------------------------------------------------------------------

def test_crash_restart_resumes_and_trains():
    cfg = ARCHS["qwen3-0.6b"].reduced()
    dc = DataConfig(vocab=cfg.vocab, seq_len=32, batch=4, seed=1)
    with tempfile.TemporaryDirectory() as d:
        tcfg = TrainConfig(steps=6, n_micro=2, ckpt_dir=d, ckpt_every=2)
        tr = Trainer(build_model(cfg, device="cpu", seed=0), tcfg)
        with pytest.raises(RuntimeError):
            tr.run(pack_documents(SyntheticCorpus(dc), 20), crash_at=3)
        tr2 = Trainer(build_model(cfg, device="cpu", seed=9),
                      TrainConfig(steps=6, n_micro=2, ckpt_dir=d,
                                  ckpt_every=2))
        assert tr2.maybe_restore()
        assert tr2.step >= 2
        hist = tr2.run(pack_documents(SyntheticCorpus(dc), 20))
        assert tr2.step == 6
        assert all(np.isfinite(h["loss"]) for h in hist)


def test_compressed_grads_close_to_exact():
    cfg = ARCHS["xlstm-125m"].reduced()
    m = build_model(cfg, device="cpu", seed=0)
    params = dict(m.decoder.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (4, 16)).astype(np.int32))
    mb = {"tokens": toks.reshape(2, 2, 16), "labels": toks.reshape(2, 2, 16)}
    _, g_exact, _ = accumulate_grads(m.loss, params, mb, compress=False)
    _, g_comp, ebuf = accumulate_grads(m.loss, params, mb, compress=True,
                                       error_buf=init_error_buf(params))
    rel = [float((g_exact[k] - g_comp[k]).abs().max()
                 / (g_exact[k].abs().max() + 1e-9)) for k in params]
    assert max(rel) < 0.05
    # error feedback buffer holds the rounding residual
    assert any(float(e.abs().max()) > 0 for e in ebuf.values())


def test_checkpoint_roundtrip_and_gc():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.ones((4,), np.int32)}}
    with tempfile.TemporaryDirectory() as d:
        for s in (1, 2, 3, 4, 5):
            ckpt.save(d, s, tree, keep=2)
        assert ckpt.latest_step(d) == 5
        back = ckpt.restore(d, 5, tree)
        np.testing.assert_array_equal(back["a"], tree["a"])
        np.testing.assert_array_equal(back["b"]["c"], tree["b"]["c"])
        kept = [x for x in os.listdir(d) if x.startswith("step_")]
        assert len(kept) == 2   # GC keeps newest K
        # the same layout as the reference's: either reads the other's
        jback = jckpt.restore(d, 5, tree)
        np.testing.assert_array_equal(jback["b"]["c"], tree["b"]["c"])
        jckpt.save(d, 6, tree, keep=2)
        np.testing.assert_array_equal(ckpt.restore(d, 6, tree)["a"],
                                      tree["a"])


@pytest.mark.parametrize("arch", ASSIGNED)
def test_train_step_reduces_loss_and_is_finite(arch):
    cfg = ARCHS[arch].reduced()
    m = build_model(cfg, device="cpu", seed=0)
    batch = batch_for(cfg)
    batch["labels"] = batch["tokens"]
    params = dict(m.decoder.named_parameters())
    for p in params.values():
        p.requires_grad_(True)
    opt = adamw_init(params)
    ocfg = AdamWConfig(lr=1e-3, warmup_steps=1)
    losses = []
    for _ in range(3):
        loss = m.loss(batch)
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        adamw_update(ocfg, grads, opt, params)
        losses.append(float(loss.detach()))
    assert all(np.isfinite(l) for l in losses)
    assert losses[-1] < losses[0]        # same batch: must memorize


# ----------------------------------------------------------------------
# checkpoints between the packages
# ----------------------------------------------------------------------

def test_reference_restores_a_port_checkpoint():
    jcfg, jm, params, tm = _qwen()
    batches = _batches(jcfg, 3)
    with tempfile.TemporaryDirectory() as d:
        tr = Trainer(tm, TrainConfig(steps=2, n_micro=2, ckpt_dir=d,
                                     ckpt_every=2))
        tr.run(batches)
        like = {"params": params, "opt": jadamw_init(params)}
        state = jckpt.restore(d, jckpt.latest_step(d), like)
    assert int(state["opt"]["step"]) == 2
    assert jax.tree.structure(state) == jax.tree.structure(like)
    want = float(jm.loss(state["params"], batches[2]))
    with torch.no_grad():
        got = float(tm.loss(batches[2]))
    assert abs(got - want) <= CKPT_TOL * max(1.0, abs(want))


def test_port_resumes_from_a_reference_checkpoint():
    jcfg, jm, params, _ = _qwen()
    batches = _batches(jcfg, 3)
    with tempfile.TemporaryDirectory() as d:
        jtr = JTrainer(jm, params, JTrainConfig(steps=2, n_micro=2,
                                                ckpt_dir=d, ckpt_every=2))
        jtr.run(batches)
        tr = Trainer(build_model(ARCHS["qwen3-0.6b"].reduced(),
                                 device="cpu", seed=3),
                     TrainConfig(steps=2, n_micro=2, ckpt_dir=d))
        assert tr.maybe_restore() and tr.step == 2
    assert int(tr.opt_state["step"]) == 2
    want = float(jm.loss(jtr.params, batches[2]))
    with torch.no_grad():
        got = float(tr.model.loss(batches[2]))
    assert abs(got - want) <= CKPT_TOL * max(1.0, abs(want))


# ----------------------------------------------------------------------
# the launcher
# ----------------------------------------------------------------------

def _form(lines: list[str]) -> list[str]:
    return [re.sub(r"\d+(\.\d+)?(e[+-]\d+)?", "#", ln) for ln in lines]


def _printed(fn) -> list[str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        fn()
    return out.getvalue().splitlines()


def test_launcher_prints_the_reference_lines_and_trains(monkeypatch):
    args = ["--arch", "qwen3-0.6b", "--steps", "6", "--batch", "4",
            "--seq", "32"]
    from repro.launch import train as jlaunch
    monkeypatch.setattr(sys, "argv", ["train", *args])
    want = _printed(jlaunch.main)
    with tempfile.TemporaryDirectory() as d:
        got = _printed(lambda: tlaunch.main([*args, "--device", "cpu",
                                             "--ckpt", d]))
        again = _printed(lambda: tlaunch.main(
            [*args, "--device", "cpu", "--ckpt", d, "--steps", "8"]))
    assert _form(got) == _form(want)
    first, last = map(float, re.search(r"loss (\S+) -> (\S+)",
                                       got[-1]).groups())
    assert np.isfinite(last) and last < first
    assert again[1] == "[train] resumed at step 6"
    assert again[2].startswith("  step    6 ")
    with pytest.raises(SystemExit):
        tlaunch.parse_args(["--mesh", "4,2"])
