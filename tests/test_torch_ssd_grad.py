"""The SSD scan's backward against ``jax.grad`` of the JAX package's
``ssd_chunked``, on the CPU: ``ssd_scan_bwd_plain`` (the CUDA backward's
passes in plain PyTorch) and ``ops.ssd_scan``'s autograd ``Function``, on
inputs made with numpy from a seed as a Mamba2 layer makes them (dt =
softplus(N(0, 1)), a = -dt * linspace(1, 16, h)).

Tolerance: each gradient to 1e-5 of its largest magnitude; ``da`` to 1e-4
of its own, as it sums over a chunk differences of cumulative decays that
reach -1e2 to -1e3 (``ssd_scan._cumsum``'s note), each sensitive to one
rounding.  Measured here: at most 1.5e-7 of the max, da 8.8e-7.  The plain
backward against PyTorch's own autograd of the plain forward (the same
arithmetic, other sum orders) holds to 1e-5 of the largest."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.ssm import ssd_chunked  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    CHUNK,
    check_ssd_bwd_args,
    ssd_scan_bwd_cuda,
    ssd_scan_bwd_plain,
    ssd_scan_plain,
)

TOL = 1e-5
DA_TOL = 1e-4
NAMES = ("x", "a", "B", "C", "init_state")

# (b, l, h, p, n, initial state, final state's gradient)
CASES = [(2, 256, 3, 8, 4, True, True),      # two whole chunks
         (1, 200, 2, 16, 8, True, False),    # ragged: padded to 256
         (2, 130, 4, 4, 12, False, True),    # a 2-step second chunk
         (1, 128, 2, 8, 8, False, False)]    # one chunk, no state


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(b, l, h, p, n, init, dfinal, seed=0):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h))))
    ins = {"x": rng.standard_normal((b, l, h, p)) * dt[..., None],
           "a": -dt * np.linspace(1.0, 16.0, h),
           "B": rng.standard_normal((b, l, n)),
           "C": rng.standard_normal((b, l, n)),
           "init_state": (rng.standard_normal((b, h, p, n)) if init
                          else None)}
    dy = rng.standard_normal((b, l, h, p))
    df = rng.standard_normal((b, h, p, n)) if dfinal else None
    f32 = lambda v: None if v is None else v.astype(np.float32)  # noqa: E731
    return {k: f32(v) for k, v in ins.items()}, f32(dy), f32(df)


def _jax_grads(ins, dy, df):
    """jax.grad of sum(y dy) + sum(final dfinal) through ``ssd_chunked``,
    padded to whole chunks as ``mamba2_fwd`` pads."""
    l = ins["x"].shape[1]
    pad = (-l) % CHUNK
    has_init = ins["init_state"] is not None

    def f(x, a, B, C, s0):
        widths = lambda t: ((0, 0), (0, pad)) + ((0, 0),) * (t.ndim - 2)  # noqa: E731
        x, a, B, C = (jnp.pad(t, widths(t)) for t in (x, a, B, C))
        y, final = ssd_chunked(x, a, B, C, CHUNK, s0 if has_init else None)
        out = jnp.sum(y[:, :l] * dy)
        if df is not None:
            out = out + jnp.sum(final * df)
        return out

    s0 = ins["init_state"] if has_init else jnp.zeros(())
    grads = jax.grad(f, argnums=(0, 1, 2, 3, 4))(
        ins["x"], ins["a"], ins["B"], ins["C"], s0)
    return [np.asarray(g) for g in grads[:4]] + [
        np.asarray(grads[4]) if has_init else None]


def _check(got, want, tol_of=lambda name: DA_TOL if name == "a" else TOL):
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, f"d{name} given without an initial state"
            continue
        g = np.asarray(g.detach() if isinstance(g, torch.Tensor) else g)
        scale = max(float(np.abs(w).max()), 1e-30)
        err = float(np.abs(g - w).max()) / scale
        assert err <= tol_of(name), f"d{name}: {err} of its max"


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_plain_backward_matches_jax_grad(case):
    ins, dy, df = _inputs(*case)
    want = _jax_grads(ins, dy, df)
    t = {k: None if v is None else torch.from_numpy(v)
         for k, v in ins.items()}
    got = ssd_scan_bwd_plain(*(t[k] for k in NAMES), torch.from_numpy(dy),
                             None if df is None else torch.from_numpy(df))
    _check(got, want)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_autograd_function_matches_jax_grad(case):
    """``ops.ssd_scan`` differentiated by autograd: an unused final state
    sends no gradient; no kernel launches on the CPU."""
    ins, dy, df = _inputs(*case, seed=1)
    want = _jax_grads(ins, dy, df)
    t = {k: None if v is None else torch.from_numpy(v).requires_grad_()
         for k, v in ins.items()}
    ops.reset_launch_counts()
    y, final = ops.ssd_scan(*(t[k] for k in NAMES))
    loss = (y * torch.from_numpy(dy)).sum()
    if df is not None:
        loss = loss + (final * torch.from_numpy(df)).sum()
    loss.backward()
    _check([None if t[k] is None else t[k].grad for k in NAMES], want)
    assert set(ops.launch_counts().values()) == {0}


def test_plain_backward_matches_torch_autograd_of_plain_forward():
    ins, dy, df = _inputs(1, 300, 3, 8, 8, True, True, seed=2)
    t = {k: torch.from_numpy(v).requires_grad_() for k, v in ins.items()}
    y, final = ssd_scan_plain(*(t[k] for k in NAMES))
    ((y * torch.from_numpy(dy)).sum()
     + (final * torch.from_numpy(df)).sum()).backward()
    want = [t[k].grad.numpy() for k in NAMES]
    got = ssd_scan_bwd_plain(*(t[k].detach() for k in NAMES),
                             torch.from_numpy(dy), torch.from_numpy(df))
    _check(got, want, tol_of=lambda name: 1e-5)


def test_backward_refuses_what_the_kernel_does_not_take():
    ins, dy, df = _inputs(1, 64, 2, 8, 8, True, True)
    t = [torch.from_numpy(ins[k]) for k in NAMES]
    dy, df = torch.from_numpy(dy), torch.from_numpy(df)
    with pytest.raises(ValueError):       # the CUDA backward on the CPU
        ssd_scan_bwd_cuda(*t, dy, df)
    with pytest.raises(ValueError):       # dy of the wrong shape
        check_ssd_bwd_args(t[0], dy[:, :10], df)
    with pytest.raises(ValueError):       # dfinal of the wrong shape
        check_ssd_bwd_args(t[0], dy, df[:, :1])
    with pytest.raises(ValueError):       # dy of another dtype
        check_ssd_bwd_args(t[0], dy.double(), None)
