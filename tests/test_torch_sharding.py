"""The port's sharding rules (``repro_torch.parallel.sharding``) against the
JAX package's (``repro.parallel.sharding``), in process: both rule sets run
on a duck-typed mesh (a namespace whose ``shape`` maps axis names to
sizes), which is all ``fit``, ``param_specs``, ``batch_specs`` and
``cache_specs`` read.  The port's spec of a parameter is the reference's
leaf spec with its stacked leading dims dropped; the port's per-row ``pos``
and ``kpos`` are the one known difference in the caches."""

import itertools
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.parallel import sharding as JS  # noqa: E402
from repro_torch.bridge import _jax_leaf  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.model import Model  # noqa: E402
from repro_torch.parallel import sharding as TS  # noqa: E402

MESHES = {"2x4": {"data": 2, "model": 4},
          "2x2x2": {"pod": 2, "data": 2, "model": 2}}
RULES = {"fsdp": dict(fsdp=True), "nofsdp": dict(fsdp=False),
         "decode_2d": dict(decode_2d=True, fsdp=False)}


def _mesh(name):
    return SimpleNamespace(shape=dict(MESHES[name]))


# ----------------------------------------------------------------------
# fit
# ----------------------------------------------------------------------

SPECS = [("data", "model"), (("data", "model"), None), ("model", "data"),
         (None, "model"), ("model",), (("pod", "data"), None, "model"),
         ("pod", ("data", "model")), (None, None)]
SHAPES_GRID = [(1, 64), (8, 64), (6, 12), (6, 2), (16, 8, 4), (4, 6, 8),
               (2, 1), (32, 32, 32)]


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_fit_matches_the_reference_over_a_grid(mesh):
    m = _mesh(mesh)
    n = 0
    for shape, spec in itertools.product(SHAPES_GRID, SPECS):
        spec = spec[:len(shape)]
        want = JS.fit(m, shape, spec)
        got = TS.fit(m, shape, spec)
        assert isinstance(got, tuple)
        assert tuple(got) == tuple(want), (shape, spec)
        n += 1
    assert n == len(SHAPES_GRID) * len(SPECS)


@pytest.mark.parametrize("shape,spec,want", [
    # the reference's four cases (test_sharding_dryrun.py, TestFit)
    ((1, 64), (("data",), "model"), (None, "model")),
    ((8, 64), (("data", "model"), None), (("data", "model"), None)),
    ((6, 12), ("data", "model"), ("data", "model")),
    ((6, 2), ("data", "model"), ("data", None)),
])
def test_fit_reference_cases(shape, spec, want):
    got = TS.fit(_mesh("2x4"), shape, spec)
    assert got == TS.P(*want)
    assert tuple(got) == tuple(PartitionSpec(*want))


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard
    mesh = SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    assert TS.placements(mesh, TS.P(("pod", "data"), None, "model")) == (
        Shard(0), Shard(0), Shard(2))
    assert TS.placements(mesh, TS.P(None, "data")) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(AssertionError):
        TS.placements(mesh, TS.P(("data", "pod"), None))


# ----------------------------------------------------------------------
# param_specs
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def trees():
    """Each arch's reduced config: the reference's parameter shapes and the
    port's parameters on the meta device."""
    out = {}
    for arch in sorted(ARCHS):
        jcfg = JARCHS[arch].reduced()
        jparams = jax.eval_shape(jax_build_model(jcfg).init,
                                 jax.random.key(0))
        net = build_model(ARCHS[arch].reduced(), device="meta").decoder
        out[arch] = (jparams, dict(net.named_parameters()))
    return out


def _flat_specs(tree):
    flat = {}
    for path, spec in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]:
        keys = [getattr(k, "key", getattr(k, "idx", None)) for k in path]
        flat[".".join(str(k) for k in keys)] = spec
    return flat


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_param_specs_match_the_reference(trees, mesh, rules):
    m = _mesh(mesh)
    jr = JS.MeshRules(m, **RULES[rules])
    tr = TS.MeshRules(m, **RULES[rules])
    checked = 0
    for arch, (jparams, named) in trees.items():
        cfg = ARCHS[arch].reduced()
        want = _flat_specs(jr.param_specs(jparams))
        got = tr.param_specs(named)
        assert set(got) == set(named)
        for name, spec in got.items():
            path, idx = _jax_leaf(cfg, name)
            ref = want[path]
            assert tuple(spec) == tuple(ref)[len(idx):], (arch, name)
            checked += 1
    assert checked > 250


# ----------------------------------------------------------------------
# input_specs, batch_specs, cache_specs
# ----------------------------------------------------------------------

# the port's xLSTM states, by the reference's tuple entry
XLSTM = {"mlstm_C": ("mlstm", 0), "mlstm_n": ("mlstm", 1),
         "mlstm_m": ("mlstm", 2), "slstm_c": ("slstm", 0),
         "slstm_n": ("slstm", 1), "slstm_h": ("slstm", 2),
         "slstm_m": ("slstm", 3)}
PER_ROW = ("pos", "kpos", "page_size")


def _ref_entry(tree, name):
    if name in XLSTM:
        key, i = XLSTM[name]
        return tree[key][i]
    return tree[name]


CELLS = [(a, s) for a in sorted(ARCHS) for s in sorted(SHAPES)]


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_the_reference(arch, shape):
    jspec = jax_build_model(JARCHS[arch]).input_specs(JSHAPES[shape])
    tspec = Model(ARCHS[arch], None, torch.device("meta")).input_specs(
        SHAPES[shape])
    assert set(tspec) == set(jspec)
    dt = {"bfloat16": jnp.bfloat16, "float32": jnp.float32,
          "int32": jnp.int32}
    for key in tspec:
        if key == "cache":
            want = {k for k in jspec[key] if k not in ("mlstm", "slstm")}
            got = set(tspec[key]) - set(XLSTM) - set(PER_ROW)
            assert got == want - set(PER_ROW)
            entries = [(k, v, _ref_entry(jspec[key], k))
                       for k, v in tspec[key].items() if k not in PER_ROW]
            b = SHAPES[shape].global_batch
            assert tuple(tspec[key]["pos"].shape) == (b,)
            if "kpos" in tspec[key]:
                assert tspec[key]["kpos"].shape[0] == b
        elif key == "batch":
            assert set(tspec[key]) == set(jspec[key])
            entries = [(k, v, jspec[key][k]) for k, v in tspec[key].items()]
        else:
            entries = [(key, tspec[key], jspec[key])]
        for name, got, want in entries:
            assert got.device.type == "meta"
            assert tuple(got.shape) == tuple(want.shape), (key, name)
            assert dt[str(got.dtype).split(".")[1]] == want.dtype, name


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_and_cache_specs_match_the_reference(mesh):
    m = _mesh(mesh)
    jr, tr = JS.MeshRules(m), TS.MeshRules(m)
    n = 0
    for arch, shape in CELLS:
        jspec = jax_build_model(JARCHS[arch]).input_specs(JSHAPES[shape])
        tspec = Model(ARCHS[arch], None,
                      torch.device("meta")).input_specs(SHAPES[shape])
        if "batch" in tspec:
            want = jr.batch_specs(jspec["batch"])
            got = tr.batch_specs(tspec["batch"])
            for k in got:
                assert tuple(got[k]) == tuple(want[k]), (arch, shape, k)
                n += 1
            continue
        want = jr.cache_specs(jspec["cache"])
        got = tr.cache_specs(tspec["cache"])
        for k, spec in got.items():
            if k in PER_ROW:
                continue
            assert tuple(spec) == tuple(_ref_entry(want, k)), (arch, shape,
                                                               k)
            n += 1
        for k in ("tokens", "frontend"):
            if k in tspec:
                assert tuple(tr.batch_specs({k: tspec[k]})[k]) == tuple(
                    jr.batch_specs({k: jspec[k]})[k])
    assert n > 100


def test_per_row_cache_entries_follow_k_and_v():
    """The port's own layouts: ``pos`` rows over DP, ``kpos`` rows over DP
    and slots over 'model', as k/v's batch and sequence."""
    tr = TS.MeshRules(_mesh("2x4"))
    spec = Model(ARCHS["qwen3-0.6b"], None, torch.device("meta")).input_specs(
        SHAPES["decode_32k"])
    got = tr.cache_specs(spec["cache"])
    assert got["pos"] == TS.P("data")
    assert got["kpos"] == TS.P("data", "model")
    assert got["k"] == TS.P(None, "data", "model", None, None)
    assert got["page_size"] is None


def test_act_specs_match_the_reference(monkeypatch):
    """The spec each ``act`` constrains to: the reference's constraint is
    read by standing in for ``with_sharding_constraint``."""
    seen = []
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, s: seen.append(s) or x)
    monkeypatch.setattr(JS, "NamedSharding", lambda mesh, spec: spec)
    m = _mesh("2x4")
    for kw in RULES.values():
        jr, tr = JS.MeshRules(m, **kw), TS.MeshRules(m, **kw)
        for shape, kind in [((8, 16, 64), "act"), ((8, 1, 64), "ffn_in"),
                            ((8, 16, 512), "logits"), ((8, 1, 64), "act"),
                            ((4, 8, 6, 64), "moe_inner"),
                            ((8, 2, 2, 1, 64), "attn_logits")]:
            seen.clear()
            jr.act(jax.ShapeDtypeStruct(shape, jnp.float32), kind)
            assert tuple(tr.act_spec(shape, kind)) == tuple(seen[0]), (
                shape, kind, kw)
