"""The port's per-architecture config modules and its dataclasses against
the JAX package's.

Each ``repro_torch.configs.<arch>.CONFIG`` equals the reference's by
``tests/torch_parity.py::plain``.  Every dataclass that both packages
define in a module of the same path has the same fields, in the same
order, with the same defaults: a positional call or a keyword that works
on one package works alike on the other."""

import dataclasses
import importlib
from pathlib import Path

import pytest

pytest.importorskip("torch")

from torch_parity import plain  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
ARCH_MODULES = sorted(p.stem for p in (REF / "configs").glob("*.py")
                      if p.stem not in ("__init__", "registry"))
#: modules of the same path in both packages
SHARED = sorted(p.relative_to(PORT).with_suffix("").as_posix()
                .replace("/", ".") for p in PORT.rglob("*.py")
                if (REF / p.relative_to(PORT)).is_file()
                and p.name != "__main__.py")
#: the one shared dataclass that is not a copy: the port's ``Model`` also
#: holds its torch modules and their device, where the reference passes its
#: params pytree apart.  The reference's fields come first, as they are.
EXTENDED = {("models.model", "Model"): ("decoder", "device")}


@pytest.mark.parametrize("arch", ARCH_MODULES)
def test_arch_module_config_equals_the_reference(arch):
    ref = importlib.import_module(f"repro.configs.{arch}").CONFIG
    port = importlib.import_module(f"repro_torch.configs.{arch}").CONFIG
    assert plain(port) == plain(ref)
    from repro_torch.configs import ARCHS
    assert ARCHS[port.name] is port


def test_every_arch_module_is_ported():
    assert len(ARCH_MODULES) == 11
    assert sorted(p.stem for p in (PORT / "configs").glob("*.py")
                  if p.stem not in ("__init__", "registry")) == ARCH_MODULES


def _default(f: dataclasses.Field):
    if f.default is not dataclasses.MISSING:
        return ("default", plain(f.default))
    if f.default_factory is not dataclasses.MISSING:
        return ("factory", plain(f.default_factory()))
    return ("required",)


def _fields(cls) -> list[tuple]:
    return [(f.name, _default(f), f.init, f.kw_only)
            for f in dataclasses.fields(cls)]


def _dataclasses(module: str) -> dict:
    m = importlib.import_module(module)
    return {k: v for k, v in vars(m).items()
            if isinstance(v, type) and dataclasses.is_dataclass(v)
            and v.__module__ == module}


def test_engine_config_fields_equal_the_reference():
    from repro.serving.engine import EngineConfig as Ref
    from repro_torch.serving.engine import EngineConfig as Port
    assert _fields(Port) == _fields(Ref)
    names = [f.name for f in dataclasses.fields(Port)]
    assert names.index("greedy") == names.index("mitigate") + 1
    assert Port(greedy=True).greedy
    # a positional call past ``mitigate`` binds the same fields
    args = (4, 128, 16, 128, 0, True, False, True, "dpu")
    assert plain(Port(*args).control) == plain(Ref(*args).control) == "dpu"


@pytest.mark.parametrize("module", SHARED)
def test_shared_dataclasses_have_the_reference_fields(module):
    ref = _dataclasses(f"repro.{module}")
    port = _dataclasses(f"repro_torch.{module}")
    for name in sorted(ref.keys() & port.keys()):
        want = _fields(ref[name])
        extra = EXTENDED.get((module, name), ())
        got = _fields(port[name])
        assert got[:len(want)] == want, name
        assert [f[0] for f in got[len(want):]] == list(extra), name


def test_the_dataclass_scan_sees_the_shared_classes():
    seen = {name for module in SHARED
            for name in _dataclasses(f"repro_torch.{module}")}
    assert {"EngineConfig", "SimParams", "FaultSpec", "SimMetrics",
            "WorkloadSpec", "SweepConfig", "DataConfig", "DPUParams",
            "LintFinding", "ModelConfig"} <= seen
