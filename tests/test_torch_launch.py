"""``python -m repro_torch.launch.serve --device cpu`` against the JAX
package's launcher on the same arguments: the printed ``[serve]`` and
``[telemetry]`` lines and the ``--report`` JSON must be equal, the
wall-clock keys of the report aside (the engine's report depends only on
the requests' lengths, not on the weights)."""

import json
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.launch import serve as jax_serve  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

WALL_CLOCK = ("ns_per_event", "ns_per_event_by_detector")
ARGV = {
    "readme": ["--arch", "qwen3-0.6b", "--requests", "24", "--rate", "200",
               "--report"],
    "static": ["--requests", "16", "--rate", "1000", "--static-batching",
               "--report"],
    "llama_no_mitigate": ["--arch", "llama3.2-3b", "--requests", "8",
                          "--no-mitigate", "--seed", "3", "--report"],
    "qwen2_moe": ["--arch", "qwen2-moe-a2.7b", "--requests", "12",
                  "--report"],
    "granite_moe": ["--arch", "granite-moe-3b-a800m", "--requests", "8",
                    "--slots", "8", "--seed", "1", "--report"],
    "xlstm": ["--arch", "xlstm-125m", "--requests", "8", "--report"],
}


def _run(main, argv, extra, monkeypatch, capsys) -> tuple[list, dict]:
    monkeypatch.setattr(sys, "argv", ["serve"] + argv + extra)
    main()
    out = capsys.readouterr().out
    head, _, body = out.partition("\n{")
    rep = json.loads("{" + body)
    rep["telemetry"] = {k: v for k, v in rep["telemetry"].items()
                        if k not in WALL_CLOCK}
    return head.splitlines(), rep


@pytest.mark.parametrize("case", sorted(ARGV))
def test_launcher_matches_reference(case, monkeypatch, capsys):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = _run(serve.main, ARGV[case], ["--device", "cpu"], monkeypatch,
                   capsys)
    finally:
        torch.set_num_threads(n)
    want = _run(jax_serve.main, ARGV[case], [], monkeypatch, capsys)
    assert got == want
    lines, rep = got
    assert [ln.split(" ")[0] for ln in lines] == ["[serve]", "[telemetry]"]
    assert rep["completed"] == int(ARGV[case][ARGV[case].index(
        "--requests") + 1])


def test_launcher_runs_on_the_card_by_default(monkeypatch):
    """Without ``--device`` the model is asked for on CUDA: with no card
    that is an error, never a quiet fall back to the CPU."""
    monkeypatch.setattr(sys, "argv", ["serve", "--requests", "1"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main()
