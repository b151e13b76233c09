"""examples/torch_serve_with_dpu_telemetry.py against
examples/serve_with_dpu_telemetry.py on the CPU.

The JAX example runs unchanged as a script (``torch_examples.Reference``).
The port's ``main`` runs with ``--device cpu`` on the reduced qwen3-0.6b
made from the same init's weights: every printed line must be equal
(steps, findings and actions of the static, mitigated and DPU-sidecar
loops, and the sidecar's report).  Without a card, the default
``--device cuda`` raises."""

import pytest

torch = pytest.importorskip("torch")

from torch_examples import Reference, bridged, load, printed  # noqa: E402
from torch_examples import one_torch_thread, use_model  # noqa: E402,F401


def test_serve_example_prints_the_reference_lines(monkeypatch):
    with Reference("serve_with_dpu_telemetry", []) as ref:
        ts = load("torch_serve_with_dpu_telemetry")
        use_model(monkeypatch, ts, bridged("qwen3-0.6b"))
        engines = []
        got = printed(lambda: engines.extend(ts.main(["--device", "cpu"])))
        [want] = ref.lines()
    assert got == want
    assert [e.stats["steps"] for e in engines] == [800, 455, 457]
    assert [e.cfg.control for e in engines][2] == "dpu"


def test_serve_example_without_a_card_the_default_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load("torch_serve_with_dpu_telemetry").main([])
