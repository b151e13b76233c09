"""Helpers for the tests that hold the PyTorch port's numpy-only copies
(``repro_torch.dpu``, ``repro_torch.obs``, ``repro_torch.serving.router``)
against the JAX package's originals.

A parity test runs one scenario twice, once on each package, and compares
what ``plain`` makes of the results with ``==``: both sides are numpy, so
equality is exact."""

import dataclasses
import importlib
from collections import deque
from types import SimpleNamespace

PACKAGES = ("repro", "repro_torch")


def package(name: str, *modules: str) -> SimpleNamespace:
    """Every public name of ``name.<module>`` for each module, as one
    namespace, so a scenario reads the same on either package."""
    ns = {}
    for mod in modules:
        m = importlib.import_module(f"{name}.{mod}")
        ns.update({k: getattr(m, k) for k in dir(m) if not k.startswith("_")})
    return SimpleNamespace(**ns)


def plain(x):
    """``x`` as builtins, class names kept and the package dropped: two
    objects of the two packages' copies of a class compare equal when
    their fields do."""
    if isinstance(x, (bool, int, float, str, type(None))):
        return x
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, {f.name: plain(getattr(x, f.name))
                                   for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k if isinstance(k, (bool, int, float, str)) else
                repr(plain(k)): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple, deque)):
        return [plain(v) for v in x]
    if hasattr(x, "__dict__"):
        return (type(x).__name__, plain(vars(x)))
    raise TypeError(f"no plain form for {type(x).__name__}")


def batch_columns(batch) -> dict:
    """An EventBatch's columns and frame stamps as plain lists."""
    from repro.core.events import BATCH_COLUMNS
    out = {c: getattr(batch, c).tolist() for c in BATCH_COLUMNS}
    out["batch_seq"] = batch.batch_seq
    out["checksum"] = batch.checksum
    return out
