"""examples/torch_train_100m.py against examples/train_100m.py on the CPU,
at the default reduced size with ``--steps`` cut to ``STEPS``.

The JAX example runs unchanged as a script (``torch_examples.Reference``,
its Trainer's history kept) while the port's ``main`` runs with
``--device cpu`` on the reduced qwen3-0.6b made from the same init's
weights, each into a checkpoint directory of its own: every printed line
must be equal but the host's mean step time (its form only), and every
step's loss, grad norm and lr agree to 1e-4.  Then the port's example,
given the JAX example's directory, resumes from it.  Without a card, the
default ``--device cuda`` raises."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_examples import Reference, bridged, load, printed  # noqa: E402
from torch_examples import one_torch_thread, use_model  # noqa: E402,F401

STEPS = 12      # of the example's 40: the file's time budget
TOL = 1e-4
WALL_CLOCK = re.compile(r"^mean step time \d+\.\d{3}s, checkpoints in (.*)$")


def test_train_example_prints_the_reference_lines_and_losses(
        monkeypatch, tmp_path):
    ref_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    steps = ["--steps", str(STEPS)]
    tt = load("torch_train_100m")
    with Reference("train_100m", [*steps, "--ckpt", ref_dir],
                   keep_history=True) as ref:
        use_model(monkeypatch, tt, bridged("qwen3-0.6b"))
        trainers = []
        got = printed(lambda: trainers.append(tt.main(
            [*steps, "--ckpt", port_dir, "--device", "cpu"])))
        [want] = ref.lines()
    assert len(got) == len(want) == 3
    assert got[:2] == want[:2]
    assert WALL_CLOCK.match(got[2])[1] == port_dir
    assert WALL_CLOCK.match(want[2])[1] == ref_dir
    [jhist], thist = ref.histories, trainers[0].history
    assert [h["step"] for h in thist] == [h["step"] for h in jhist] \
        == list(range(STEPS))
    for key in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose([h[key] for h in thist],
                                   [h[key] for h in jhist], rtol=TOL,
                                   err_msg=key)
    # the JAX example's checkpoints: the port resumes from them
    use_model(monkeypatch, tt, bridged("qwen3-0.6b"))
    resumed = printed(lambda: tt.main(
        [*steps, "--ckpt", ref_dir, "--device", "cpu"]))
    assert resumed == [want[0], f"resumed from checkpoint at step {STEPS}"]


def test_train_example_without_a_card_the_default_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load("torch_train_100m").main(["--ckpt", str(tmp_path)])
    assert not list(tmp_path.iterdir())
