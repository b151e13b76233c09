"""The port's nemotron_h stack (``models.transformer.NemotronH``: Mamba2
with a conv and B/C groups, a sigmoid-routed relu² MoE holding a share of
its experts, GQA without RoPE) against the plain float32 reference of the
benchmark (``bench/reference/nemotron_h.py``) on the CPU, at the
configuration file's ``run`` reduced to the pattern ``MEM*E``.  The JAX
package has no such model.

Tolerances: the port and the reference are two float32 computations of
the same function, which differ in their sums' order only (the chunked SSD
scan against the reference's, the sort-and-grouped-matmul dispatch against
one expert at a time); at this size their logits agree to ~1e-5, so they
are held to ``TOL`` = 1e-4, and a layer alone to 1e-5."""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from bench.cell import reference  # noqa: E402
from bench.weights import fill  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ssd_scan import ssd_scan_plain  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.models.model import CACHE_BATCH_AXIS, net_type  # noqa: E402
from repro_torch.models.moe import MoE, moe_fwd, moe_per_row  # noqa: E402
from repro_torch.obs import EXPERT_STEPS  # noqa: E402
from repro_torch.serving import EngineConfig, InferenceEngine  # noqa: E402
from repro_torch.serving import ServeRequest  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "bench" / "configs" / "nemotron-3-nano.json")
                    .read_text())
REF = reference(CONFIG)
TOL = 1e-4
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test processes run side by side; one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small(**over) -> ModelConfig:
    return ModelConfig(**CONFIG["run"]).reduced(**over)


def build(cfg: ModelConfig, seed: int = 5, bias: float = 0.0) -> Model:
    """Weights drawn as the benchmark draws them; each router's correction
    bias N(0, bias^2)."""
    net = fill(net_type(cfg)(cfg, CPU), seed, CPU, CONFIG["dt_init"])
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith("router_bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * bias)
    return Model(cfg, net, CPU)


def ref_logits(model: Model, tokens: torch.Tensor) -> torch.Tensor:
    run = dataclasses.asdict(model.cfg)
    params = dict(model.decoder.named_parameters())
    return REF.logits(run, params, REF.forward(run, params, tokens))


@pytest.fixture(scope="module")
def model():
    return build(small(), bias=0.5)


def _tokens(cfg, b, length, seed=3):
    return torch.randint(0, cfg.vocab, (b, length),
                         generator=torch.Generator().manual_seed(seed))


def test_the_reduced_config_keeps_every_mixer():
    cfg = small()
    assert cfg.layer_pattern == "MEM*E" and cfg.n_layers == 5
    assert cfg.n_held * 2 == cfg.n_experts and cfg.ssm_groups > 1
    full = ModelConfig(**CONFIG["run"])
    assert full.moe_layers == 23 and full.n_held == 64
    assert (full.d_inner, full.ssm_heads) == (4096, 64)
    # the EP2 share: 16.9 B parameters held of the published 31.6 B
    assert round(full.param_count() / 1e8) == 169
    assert full.active_param_count() < full.param_count()
    whole = dataclasses.replace(full, experts_held=0)
    assert round(whole.param_count() / 1e9, 1) == 31.6


def test_prefill_then_decode_against_the_reference(model):
    toks = _tokens(model.cfg, 2, 40)
    cache = model.init_cache(2, 64, 16)
    logits, cache = model.prefill(toks[:, :24], cache)
    got = [logits[:, 0]]
    for t in range(24, 39):
        logits, cache = model.decode_step(toks[:, t:t + 1], cache)
        got.append(logits[:, 0])
    want = ref_logits(model, toks)[:, 23:39]
    torch.testing.assert_close(torch.stack(got, 1), want, atol=TOL,
                               rtol=TOL)


def test_a_split_at_every_position_carries_conv_and_ssm_state(model):
    """Prefill j tokens, decode the rest: each split's logits are the full
    forward's, so the conv state and the SSM state carry exactly the
    prefix."""
    n = 12
    toks = _tokens(model.cfg, 1, n, seed=8)
    want = ref_logits(model, toks)[0]
    for j in range(1, n):
        cache = model.init_cache(1, 32, 16)
        logits, cache = model.prefill(toks[:, :j], cache)
        got = [logits[0, 0]]
        for t in range(j, n):
            logits, cache = model.decode_step(toks[:, t:t + 1], cache)
            got.append(logits[0, 0])
        torch.testing.assert_close(torch.stack(got), want[j - 1:], atol=TOL,
                                   rtol=TOL, msg=f"split at {j}")


def _layer(cfg: ModelConfig, seed: int = 9, bias: float = 0.0) -> MoE:
    layer = MoE(cfg, CPU)
    layer.embed = torch.nn.Parameter(torch.empty(1, 1), requires_grad=False)
    fill(layer, seed, CPU)
    with torch.no_grad():
        layer.router_bias.copy_(torch.randn(
            cfg.n_experts, generator=torch.Generator().manual_seed(seed))
            * bias)
    return layer


def _params(layer: MoE) -> dict:
    return {k: v for k, v in layer.named_parameters() if k != "embed"}


def test_sigmoid_routing_with_a_correction_bias():
    cfg = small()
    run = dataclasses.asdict(cfg)
    layer = _layer(cfg, bias=1.0)
    h = torch.randn(2, 30, cfg.d_model,
                    generator=torch.Generator().manual_seed(2))
    want = REF.moe(h, _params(layer), run)
    torch.testing.assert_close(moe_per_row(layer, cfg, h)[0], want,
                               atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(moe_fwd(layer, cfg, h)[0], want, atol=1e-5,
                               rtol=1e-5)
    # the bias moves the choice, not the gates' scores
    unbiased = dict(_params(layer), router_bias=torch.zeros(cfg.n_experts))
    assert not torch.equal(REF.route(h, unbiased, run)[0],
                           REF.route(h, _params(layer), run)[0])


def test_two_expert_shares_add_up_to_the_uncut_layer():
    """Each chip of EP2 holds half of the experts; their outputs, with the
    shared expert counted once, add up to the whole layer's."""
    whole_cfg = small(experts_held=0)
    e = whole_cfg.n_experts
    whole = _layer(whole_cfg, bias=0.7)
    h = torch.randn(2, 20, whole_cfg.d_model,
                    generator=torch.Generator().manual_seed(4))
    want = REF.moe(h, _params(whole), dataclasses.asdict(whole_cfg))
    shared = whole.shared(h)
    cfg = small(experts_held=e // 2)
    parts = []
    for first in (0, e // 2):
        # a chip holds experts 0 .. E/2 - 1: the second one's ids are the
        # whole layer's with the halves swapped
        ids = torch.arange(e).roll(-first)
        share = MoE(cfg, CPU)
        with torch.no_grad():
            for name, p in share.named_parameters():
                src = _params(whole)[name]
                if name == "router":
                    src = src[:, ids]
                elif name == "router_bias":
                    src = src[ids]
                elif name in ("w_up", "w_down"):
                    src = src[ids[:e // 2]]
                p.copy_(src)
        parts.append(moe_per_row(share, cfg, h)[0])
    torch.testing.assert_close(parts[0] + parts[1] - shared, want,
                               atol=1e-5, rtol=1e-5)
    assert not torch.allclose(parts[0], want, atol=1e-3)


def test_no_pair_drops_at_the_largest_bucket():
    """Every token of a 1,024-token prefill picks expert 0, at the
    published E, k and capacity factor: the capacity takes them all."""
    cfg = dataclasses.replace(small(), n_experts=CONFIG["run"]["n_experts"],
                              top_k=CONFIG["run"]["top_k"],
                              capacity_factor=CONFIG["run"]
                              ["capacity_factor"], experts_held=64)
    layer = _layer(cfg)
    with torch.no_grad():
        layer.router_bias[0] = 100.0
    h = torch.randn(1, 1024, cfg.d_model,
                    generator=torch.Generator().manual_seed(6))
    idx, _ = REF.route(h, _params(layer), dataclasses.asdict(cfg))
    assert bool((idx == 0).any(-1).all())
    got = moe_per_row(layer, cfg, h)[0]
    torch.testing.assert_close(got, REF.moe(h, _params(layer),
                                            dataclasses.asdict(cfg)),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("b,l,h,p,n,g", [(1, 256, 64, 16, 128, 8),
                                         (2, 150, 8, 16, 128, 4),
                                         (1, 70, 4, 8, 32, 2)])
def test_grouped_scan_against_the_plain_scan(b, l, h, p, n, g):
    """B/C groups and a state past the kernel's 64 columns go through the
    one-group scan; each group's heads against ``ssd_scan_plain``."""
    gen = torch.Generator().manual_seed(l)
    x = torch.randn(b, l, h, p, generator=gen)
    a = -torch.rand(b, l, h, generator=gen) * 0.3
    B = torch.randn(b, l, g, n, generator=gen) * 0.3
    C = torch.randn(b, l, g, n, generator=gen) * 0.3
    s0 = torch.randn(b, h, p, n, generator=gen)
    y, final = ops.ssd_scan(x, a, B, C, s0)
    hg = h // g
    for i in range(g):
        heads = slice(i * hg, (i + 1) * hg)
        yi, fi = ssd_scan_plain(x[:, :, heads].contiguous(),
                                a[:, :, heads].contiguous(),
                                B[:, :, i].contiguous(),
                                C[:, :, i].contiguous(),
                                s0[:, heads].contiguous())
        torch.testing.assert_close(y[:, :, heads], yi, atol=1e-5,
                                   rtol=1e-5)
        torch.testing.assert_close(final[:, heads], fi, atol=1e-6,
                                   rtol=1e-6)


def _served(engine):
    """Each request's served tokens, as the engine hands them on: the
    prefill's, then each step's."""
    served: dict[int, list] = {}
    prefill, record = engine._prefill, engine._record_tokens

    def tap_prefill(slot, req):
        prefill(slot, req)
        served[req.req_id] = [engine._slot_next_token[slot]]

    def tap_record(slots, nxt):
        for s in slots:
            req = engine.sched.running[s]
            if req.tokens_out + 1 < req.max_new_tokens:
                served[req.req_id].append(nxt[s])
        record(slots, nxt)
    engine._prefill, engine._record_tokens = tap_prefill, tap_record
    return served


def test_the_engine_serves_the_reference(model):
    eng = InferenceEngine(model, EngineConfig(max_slots=3, max_seq=128,
                                              n_pages=64, control="dpu"))
    served = _served(eng)
    reqs = [ServeRequest(i, 0.002 * i, list(range(3 + i, 23 + 5 * i)),
                         4 + i) for i in range(5)]
    rep = eng.run(reqs)
    assert rep["completed"] == len(reqs)
    for r in reqs:
        bucket = eng.sched.bucket_len(len(r.prompt))
        seq = [0] * (bucket - len(r.prompt)) + r.prompt + served[r.req_id]
        lg = ref_logits(model, torch.tensor([seq[:-1]]))[0, bucket - 1:]
        picked = lg.gather(-1, torch.tensor(served[r.req_id])[:, None])
        assert len(served[r.req_id]) == r.max_new_tokens
        assert float((lg.max(-1).values - picked[:, 0]).max()) <= TOL


def test_engine_writes_every_cache_tensor_into_its_slot(model):
    eng = InferenceEngine(model, EngineConfig(max_slots=3, max_seq=64,
                                              n_pages=64, telemetry=False))
    eng.submit(ServeRequest(0, 0.0, [5] * 20, 2))
    eng._admit_loop()                         # one prefill, no decode step
    (slot,) = eng.sched.running
    cache = eng.slot_cache
    others = torch.tensor([s for s in range(3) if s != slot])
    assert {"ssm_state", "conv_state", "k", "v"} <= set(cache)
    for key, axis in CACHE_BATCH_AXIS.items():
        if key in ("pos", "kpos") or key not in cache:
            continue
        assert bool(cache[key].select(axis, slot).any()), key
        assert not bool(cache[key].index_select(axis, others).any()), key


def _inputs(model, cfg):
    """Hooks that keep each MoE layer's normed input of the last call."""
    seen = []
    if cfg.layer_pattern:
        norms = [layer.ln for c, layer in zip(cfg.layer_pattern,
                                              model.decoder.layers)
                 if c == "E"]
    else:
        norms = [layer.ln2 for layer in model.decoder.layers]
    for i, norm in enumerate(norms):
        norm.register_forward_hook(
            lambda mod, args, out, i=i: seen.append((i, out.detach())))
    return seen, norms


def _host_counts(h, router, bias, cfg):
    """Pairs per held expert of each token of h, routed on the host."""
    logits = h.reshape(-1, h.shape[-1]).float() @ router
    scores = torch.sigmoid(logits) if cfg.router == "sigmoid" \
        else torch.softmax(logits, -1)
    idx = torch.topk(scores + bias, cfg.top_k, -1).indices
    return torch.bincount(idx[idx < cfg.n_held], minlength=cfg.n_held)


@pytest.mark.parametrize("arch", ["nemotron", "qwen2-moe-a2.7b"])
def test_counters_equal_a_host_count_of_the_routing(arch, model):
    if arch == "nemotron":
        m = model
    else:
        from repro_torch.configs import ARCHS
        from repro_torch.models import build_model
        m = build_model(ARCHS[arch].reduced(), device="cpu", seed=2)
    cfg = m.cfg
    eng = InferenceEngine(m, EngineConfig(max_slots=3, max_seq=64,
                                          n_pages=64, telemetry=False))
    seen, norms = _inputs(m, cfg)
    moe = [n for n in m.decoder.modules() if isinstance(n, MoE)]
    for i in range(3):
        eng.submit(ServeRequest(i, 0.0, [7 + i] * (10 + i), 6))
    eng._admit_loop()
    for _ in range(4):
        seen.clear()
        before = len(EXPERT_STEPS._ring)
        eng._step()
        assert len(EXPERT_STEPS._ring) == before + 1
        step = EXPERT_STEPS._ring[-1]
        counts = eng.slot_cache["expert_counts"]
        assert counts.shape == (cfg.moe_layers, cfg.n_held)
        assert len(seen) == cfg.moe_layers
        for layer, h in seen:
            bias = getattr(moe[layer], "router_bias", 0.0)
            want = _host_counts(h, moe[layer].router, bias, cfg)
            assert torch.equal(counts[layer], want), layer
        assert step.pairs == int(counts.sum()) > 0
        if cfg.n_held == cfg.n_experts:       # every slot's k choices
            assert step.pairs == 3 * cfg.top_k * cfg.moe_layers
        assert step.touched == int((counts > 0).sum())
        assert step.held == cfg.moe_layers * cfg.n_held
    assert np.isfinite(float(eng.step_logits.float().abs().max()))
