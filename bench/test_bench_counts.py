"""The work counts come from the reference module that each configuration
names: the full configurations' counts and the readers' values on fixed
readouts are pinned to what the yardstick read before the counts moved
into the modules, and an architecture enters through new files alone."""

import json
import textwrap

import numpy as np
import pytest
import torch

from bench import check, work
from bench.cell import ROOT, reference
from bench.loop import Iteration
from bench.readout import Readout, reader
from bench.trace import Trace
from bench.traffic import Request

MS = 1_000_000
READERS = ("mfu_pct", "paged_attention_roofline", "flash_attention_roofline",
           "ssd_scan_roofline")

# weights per token, attention applications, token_flops(c, 700, True),
# prompt_flops(c, 700), step_flops(c, 64, 20000); then the four readers on
# ``fixed``
PINNED = {
    "zamba2-7b": (
        8_984_141_824, 13, 18_476_752_896, 12_727_798_272_000,
        1_177_890_258_944,
        (2.2355958099952815, 26.053847299156384, 22.78696501492537,
         28.555184525373136)),
    "qwen2-moe-a2.7b": (
        2_066_546_688, 24, 4_893_048_832, 2_942_025_465_856,
        308_279_246_848,
        (0.5462797401388608, 27.486382099935103, 24.03899605970149, None)),
}


def config(name: str) -> dict:
    return json.loads((ROOT / "bench" / "configs" / f"{name}.json")
                      .read_text())


def fixed(run: dict, ref) -> Readout:
    """Twelve iterations of 0.1 s on 64 slots, a prefill of a 256 bucket in
    every third, the first six traced: 23 ms of paged kernel, 0.25 ms of
    flash, 6 ms of the SSD scan's three kernels."""
    its = [Iteration(k * 0.1, (k + 1) * 0.1, running=60 + k % 4,
                     context=17000 + 331 * k, lengths=17060 + 331 * k,
                     prefills=[(256, 190 + k, 0.08)] if k % 3 == 0 else [])
           for k in range(12)]
    ops = [("paged_split_kernel<bf16>", "kernel", 0, 23 * MS, 1),
           ("flash_tc_kernel", "kernel", 23 * MS, 23 * MS + 250_000, 2),
           ("ssd_chunk_states", "kernel", 24 * MS, 27 * MS, 3),
           ("ssd_state_pass", "kernel", 27 * MS, 28 * MS, 4),
           ("ssd_chunk_output", "kernel", 28 * MS, 30 * MS, 5)]
    return Readout(run, {"slots": 64, "max_seq": 768}, 30.0, 0.0, 1.2, its,
                   [], trace=Trace((0, 1200 * MS), ops=ops), traced=its[:6],
                   reference=ref)


@pytest.mark.parametrize("name", sorted(PINNED))
def test_counts_and_readers_unchanged(name):
    cfg = config(name)
    ref = reference(cfg)
    c = ref.counts(cfg["run"])
    weights, apps, token, prompt, step, reads = PINNED[name]
    assert c.weights == weights
    assert sum(a[0] for a in c.attention) == apps
    assert work.token_flops(c, 700, True) == token
    assert work.prompt_flops(c, 700) == prompt
    assert work.step_flops(c, 64, 20000) == step
    ro = fixed(cfg["run"], ref)
    assert tuple(reader(m)(ro) for m in READERS) == reads


def test_ssd_work_unchanged_at_zamba2s_prefill():
    assert work.ssd_work(1, 1024, 112, 64, 64, True) \
        == (2_834_366_464, 63_373_312)


def test_every_configuration_names_its_reference():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        ref = reference(cfg)
        assert (ROOT / cfg["reference"]).is_relative_to(ROOT / "bench")
        assert isinstance(ref.counts(cfg["run"]), work.Counts)


ARCH = '''
"""qwen2-moe's layers under counts of its own: twice the weights, half of
the KV heads, one further FLOP a token."""
from bench.reference import moe
from bench.work import Counts

CALLS = []


def forward(run, params, tokens, **kw):
    CALLS.append(tokens.shape)
    return moe.forward(run, params, tokens, **kw)


def logits(run, params, x):
    return moe.logits(run, params, x)


def counts(run):
    c = moe.counts(run)
    n, hq, hkv, hd = c.attention[0]
    return Counts(weights=c.weights * 2, head=c.head,
                  attention=((n, hq, hkv // 2, hd),), other_flops=1.0)
'''


def test_a_new_architecture_enters_as_files(tmp_path):
    """A module and a configuration outside ``bench/``: the check runs the
    module's forward, and the work readers take its counts."""
    from bench.tiny import run_sizes
    from bench.weights import fill
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.model import net_type
    (tmp_path / "arch.py").write_text(ARCH)
    run = run_sizes("moe")
    (tmp_path / "arch.json").write_text(json.dumps(
        {"run": run, "reference": "arch.py"}))
    cfg = json.loads((tmp_path / "arch.json").read_text())
    ref = reference(cfg, root=tmp_path)
    c = ref.counts(run)
    moe = reference({"reference": "bench/reference/moe.py"})
    assert c.weights == 2 * moe.counts(run).weights

    mc = ModelConfig(**run)
    net = fill(net_type(mc)(mc, torch.device("cpu")), 3, torch.device("cpu"))
    params = dict(net.named_parameters())
    req = Request(0, 0, np.arange(1, 21), 4, bucket=32, tokens=[5, 7, 9])
    got = check.gaps(run, ref, params, [req])
    assert ref.CALLS and len(got) == 1 and got[0].shape == (3,)

    ro = fixed(run, ref)
    flops = 0.0
    for it in ro.window():
        flops += sum(work.prompt_flops(c, n) for _, n, _ in it.prefills)
        flops += work.step_flops(c, it.running, it.context)
    assert reader("mfu_pct")(ro) == pytest.approx(
        flops / (1.2 * work.PEAK_FLOPS["bfloat16"]) * 100)
    assert reader("mfu_pct")(ro) > reader("mfu_pct")(fixed(run, moe))
    n, hq, hkv, hd = c.attention[0]
    bound = n * sum(work.bound_s(*work.paged_work(
        it.lengths, 64, hq, hkv, hd, 768 // 16), "bfloat16")
        for it in ro.traced)
    assert reader("paged_attention_roofline")(ro) == pytest.approx(
        bound / 0.023 * 100)
    assert reader("ssd_scan_roofline")(ro) is None


def test_ssd_roofline_silent_without_ssd_layers(tmp_path):
    (tmp_path / "dense.py").write_text(textwrap.dedent('''
        from bench.work import Counts

        def counts(run):
            return Counts(weights=10, head=4, attention=((2, 4, 2, 16),))
        '''))
    ref = reference({"reference": str(tmp_path / "dense.py")})
    ro = fixed({}, ref)
    assert reader("ssd_scan_roofline")(ro) is None
    assert reader("paged_attention_roofline")(ro) > 0
