"""examples/torch_pathology_drilldown.py against
examples/pathology_drilldown.py on the CPU, on one runbook row per table
(``torch_examples.DRILL_ROWS``, the rows chip_smoke.py drills on the
card's machine).  The JAX example runs unchanged as a script, once per
row (``torch_examples.Reference``), while the port's ``main([row,
"--device", "cpu"])`` runs each row here: each row prints the same lines,
and its detector fires.  Without a card, the default ``--device cuda``
raises."""

import pytest

torch = pytest.importorskip("torch")

from torch_examples import DRILL_ROWS, Reference, load, printed  # noqa: E402


@pytest.fixture(scope="module")
def drills():
    """Each row's printed lines: (the JAX example's, the port's)."""
    with Reference("pathology_drilldown", *([r] for r in DRILL_ROWS)) as ref:
        td = load("torch_pathology_drilldown")
        got = [printed(lambda: td.main([r, "--device", "cpu"]))
               for r in DRILL_ROWS]
        want = ref.lines()
    return dict(zip(DRILL_ROWS, zip(want, got)))


@pytest.mark.parametrize("row", DRILL_ROWS)
def test_drilldown_prints_the_reference_lines(drills, row):
    want, got = drills[row]
    assert got == want
    assert any(ln.startswith("detected   : ") for ln in got)
    assert not any("did not fire" in ln for ln in got)


def test_drill_rows_cover_every_table():
    from repro_torch.core.runbooks import ALL_RUNBOOKS, BY_ID
    assert sorted(BY_ID[r].table for r in DRILL_ROWS) \
        == sorted({e.table for e in ALL_RUNBOOKS})


def test_drilldown_without_a_card_the_default_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load("torch_pathology_drilldown").main([DRILL_ROWS[0]])
