"""examples/torch_quickstart.py against examples/quickstart.py on the CPU.

The JAX example runs unchanged as a script (``torch_examples.Reference``).
The port's ``main`` runs with ``--device cpu`` on the reduced llama3.2-3b
made from the same init's weights (``torch_examples.bridged``): every
printed line must be equal (the served report, the tp_straggler finding
and its attribution, the hot-replica loop).  Without a card, the default
``--device cuda`` raises."""

import pytest

torch = pytest.importorskip("torch")

from torch_examples import Reference, bridged, load, printed  # noqa: E402
from torch_examples import one_torch_thread, use_model  # noqa: E402,F401


def test_quickstart_prints_the_reference_lines(monkeypatch):
    with Reference("quickstart", []) as ref:
        tq = load("torch_quickstart")
        use_model(monkeypatch, tq, bridged(tq.ARCH))
        engines = []
        got = printed(lambda: engines.append(tq.main(["--device", "cpu"])))
        [want] = ref.lines()
    assert got == want
    assert got[1].endswith(" 0 findings (healthy => 0)")
    assert engines[0].stats["prefills"] == 10


def test_quickstart_without_a_card_the_default_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load("torch_quickstart").main([])
