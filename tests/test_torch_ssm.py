"""The port's SSD scan and Mamba2 layer on the CPU against the JAX package.

``ops.ssd_scan`` on CPU tensors runs the kernel's plain version
(``ssd_scan_plain``, the JAX model's chunked form).  It is held against the
JAX package's Pallas kernel in interpret mode, its sequential oracle
``ssd_scan_ref`` and its ``ssd_chunked``, at the JAX tests' 2e-4
(tests/test_kernels.py); with an initial state, the final state too.  The
Mamba2 layer (``mamba2_fwd`` with and without a state, ``mamba2_step``)
holds to 1e-4, with the JAX weights carried over by the bridge.  Inputs are
made with numpy from a seed.  The CUDA kernel runs only on the card, where
chip_smoke.py holds it against the same plain version."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import ARCHS as JARCHS  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_kernel  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    _cumsum,
    ssd_scan_cuda,
)
from repro_torch.models import ssm as TS  # noqa: E402

SSD_TOL = 2e-4      # tests/test_kernels.py's tolerance for the SSD scan
MODEL_TOL = 1e-4    # one Mamba2 layer, f32, sums in another order


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes side by side; one intra-op
    thread each keeps torch's many small CPU ops from oversubscribing the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _inputs(seed, b, l, h, p, n, init=False, decay=0.1):
    """The JAX tests' inputs: x, B, C ~ N(0, 1), a = -|N(0, 1)| * decay."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, h, p), dtype=np.float32)
    a = (-np.abs(rng.standard_normal((b, l, h))) * decay).astype(np.float32)
    B = rng.standard_normal((b, l, n), dtype=np.float32)
    C = rng.standard_normal((b, l, n), dtype=np.float32)
    s0 = rng.standard_normal((b, h, p, n), dtype=np.float32) if init \
        else None
    return x, a, B, C, s0


def _port(x, a, B, C, s0=None):
    y, final = ops.ssd_scan(*(torch.from_numpy(t) for t in (x, a, B, C)),
                            init_state=None if s0 is None
                            else torch.from_numpy(s0))
    assert y.dtype == torch.float32 and y.shape == x.shape
    assert final.shape == (x.shape[0], x.shape[2], x.shape[3], B.shape[2])
    return y.numpy(), final.numpy()


def _jax_chunked(x, a, B, C, s0=None, chunk=128):
    """ssd_chunked on whole chunks, padded as mamba2_fwd pads."""
    l = x.shape[1]
    pad = (-l) % chunk
    padded = [np.pad(t, [(0, 0), (0, pad)] + [(0, 0)] * (t.ndim - 2))
              for t in (x, a, B, C)]
    y, final = JS.ssd_chunked(*(jnp.asarray(t) for t in padded), chunk,
                              None if s0 is None else jnp.asarray(s0))
    return np.asarray(y)[:, :l], np.asarray(final)


# the sweep: l (one chunk, half a chunk, ragged, three chunks) x (p, n) x b;
# the interpret-mode Pallas kernel joins on the b = 2 cases
SWEEP = [(l, p, n, b) for l in (64, 128, 200, 384)
         for p, n in ((32, 16), (64, 64)) for b in (1, 2)]


@pytest.mark.parametrize("l,p,n,b", SWEEP)
def test_plain_matches_jax_kernel_oracle_and_model(l, p, n, b):
    x, a, B, C, _ = _inputs(l + p + b, b, l, 3, p, n)
    y, final = _port(x, a, B, C)
    want_ref, final_ref = jref.ssd_scan_ref(*(jnp.asarray(t)
                                              for t in (x, a, B, C)))
    _close(y, want_ref, SSD_TOL)
    _close(final, final_ref, SSD_TOL)
    want_model, final_model = _jax_chunked(x, a, B, C)
    _close(y, want_model, SSD_TOL)
    _close(final, final_model, SSD_TOL)
    if b == 2:
        want_kernel, _ = ssd_scan_kernel(*(jnp.asarray(t)
                                           for t in (x, a, B, C)),
                                         interpret=True)
        _close(y, want_kernel, SSD_TOL)


@pytest.mark.parametrize("l,p,n", [(64, 32, 16), (200, 64, 64),
                                   (384, 32, 16)])
def test_initial_state_carries_to_the_final_state(l, p, n):
    x, a, B, C, s0 = _inputs(l + 7, 2, l, 3, p, n, init=True)
    y, final = _port(x, a, B, C, s0)
    want_ref, final_ref = jref.ssd_scan_ref(
        *(jnp.asarray(t) for t in (x, a, B, C)), init_state=jnp.asarray(s0))
    _close(y, want_ref, SSD_TOL)
    _close(final, final_ref, SSD_TOL)
    want_model, final_model = _jax_chunked(x, a, B, C, s0)
    _close(y, want_model, SSD_TOL)
    _close(final, final_model, SSD_TOL)
    port_ref, port_final = ref.ssd_scan_ref(*(torch.from_numpy(t)
                                              for t in (x, a, B, C, s0)))
    _close(y, port_ref, SSD_TOL)
    _close(final, port_final, SSD_TOL)
    # scanning in two halves from the carried state is the same scan
    y1, mid = _port(x[:, :l // 2].copy(), a[:, :l // 2].copy(),
                    B[:, :l // 2].copy(), C[:, :l // 2].copy(), s0)
    y2, end = _port(x[:, l // 2:].copy(), a[:, l // 2:].copy(),
                    B[:, l // 2:].copy(), C[:, l // 2:].copy(), mid)
    _close(np.concatenate([y1, y2], axis=1), want_ref, SSD_TOL)
    _close(end, final_ref, SSD_TOL)


def test_model_like_decays_match_the_model_chunked_form():
    """Decays as the hybrid's layers make them (a = -softplus(N) *
    linspace(1, 16)): cumulative sums reach -1e3 in a chunk, where the
    reference's own order of additions matters (``_cumsum``)."""
    rng = np.random.default_rng(11)
    b, l, h, p, n = 1, 384, 8, 32, 16
    x, _, B, C, s0 = _inputs(12, b, l, h, p, n, init=True)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    a = (-dt * np.linspace(1.0, 16.0, h)).astype(np.float32)
    y, final = _port(x * dt[..., None], a, B, C, s0)
    want, final_want = _jax_chunked(x * dt[..., None], a, B, C, s0)
    _close(y, want, SSD_TOL)
    _close(final, final_want, SSD_TOL)


@pytest.mark.parametrize("n", [5, 16, 17, 128, 300])
def test_cumsum_adds_in_the_reference_order(n):
    """Bit for bit the JAX reference's cumulative sum on the CPU."""
    x = (-np.abs(np.random.default_rng(n).standard_normal((3, n)))
         * 30).astype(np.float32)
    want = np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=-1))(x))
    np.testing.assert_array_equal(_cumsum(torch.from_numpy(x)).numpy(),
                                  want)


def test_sequential_oracle_matches_jax_oracle():
    x, a, B, C, s0 = _inputs(3, 2, 40, 3, 8, 4, init=True)
    y, final = ref.ssd_scan_ref(*(torch.from_numpy(t)
                                  for t in (x, a, B, C, s0)))
    want, final_want = jref.ssd_scan_ref(
        *(jnp.asarray(t) for t in (x, a, B, C)), init_state=jnp.asarray(s0))
    _close(y, want, 2e-5)
    _close(final, final_want, 2e-5)


# ----------------------------------------------------------------------
# Mamba2 layer
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def zamba():
    jcfg = JARCHS["zamba2-7b"].reduced(n_layers=5)
    params = jax_build_model(jcfg).init(jax.random.key(0))
    tm = params_from_jax(ARCHS["zamba2-7b"].reduced(n_layers=5),
                         jax.tree.map(np.asarray, params), device="cpu")
    jp = jax.tree.map(lambda t: t[1, 0], params["blocks"]["mamba"])
    return jcfg, jp, tm.cfg, tm.decoder.blocks[1][0].mamba


@pytest.mark.parametrize("l,with_state", [(64, False), (200, False),
                                          (200, True)])
def test_mamba2_fwd_matches_jax(zamba, l, with_state):
    jcfg, jp, cfg, layer = zamba
    rng = np.random.default_rng(l)
    u = rng.standard_normal((2, l, cfg.d_model), dtype=np.float32)
    st = (rng.standard_normal((2, cfg.ssm_heads, cfg.ssm_head_dim,
                               cfg.ssm_state), dtype=np.float32)
          if with_state else None)
    jy, jst = jax.jit(lambda p, u, s: JS.mamba2_fwd(p, jcfg, u, state=s))(
        jp, jnp.asarray(u), None if st is None else jnp.asarray(st))
    ty, tst = TS.mamba2_fwd(layer, cfg, torch.from_numpy(u),
                            None if st is None else torch.from_numpy(st))
    _close(ty, jy, MODEL_TOL)
    _close(tst, jst, MODEL_TOL)


def test_mamba2_step_matches_jax(zamba):
    jcfg, jp, cfg, layer = zamba
    rng = np.random.default_rng(9)
    st = rng.standard_normal((3, cfg.ssm_heads, cfg.ssm_head_dim,
                              cfg.ssm_state), dtype=np.float32)
    jst, tst = jnp.asarray(st), torch.from_numpy(st)
    step = jax.jit(lambda p, u, s: JS.mamba2_step(p, jcfg, u, s))
    for _ in range(4):
        u = rng.standard_normal((3, 1, cfg.d_model), dtype=np.float32)
        jy, jst = step(jp, jnp.asarray(u), jst)
        ty, tst = TS.mamba2_step(layer, cfg, torch.from_numpy(u), tst)
        _close(ty, jy, MODEL_TOL)
        _close(tst, jst, MODEL_TOL)


def test_mamba_parameters_start_as_the_reference():
    cfg = ARCHS["zamba2-7b"].reduced()
    layer = TS.Mamba2(cfg, torch.device("cpu"))
    want = JS.mamba2_init(jax.random.key(0), JARCHS["zamba2-7b"].reduced())
    for name in ("A_log", "D", "dt_bias"):
        got = getattr(layer, name)
        assert got.dtype == torch.float32
        _close(got.detach().numpy(), want[name], 1e-6)


# ----------------------------------------------------------------------
# what the kernel does not take
# ----------------------------------------------------------------------

def _args(b=1, l=8, h=2, p=8, n=4):
    return [torch.zeros(b, l, h, p), torch.zeros(b, l, h),
            torch.zeros(b, l, n), torch.zeros(b, l, n)]


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "state_dim", "chunk",
                                 "a_shape", "init_shape", "contiguous",
                                 "rank"])
def test_ssd_rejects_what_the_kernel_does_not_take(bad):
    x, a, B, C = _args()
    kw = {}
    if bad == "dtype":
        x = x.double()
    elif bad == "head_dim":
        x = torch.zeros(1, 8, 2, 6)
    elif bad == "state_dim":
        B = C = torch.zeros(1, 8, 68)
    elif bad == "chunk":
        kw["chunk"] = 64
    elif bad == "a_shape":
        a = torch.zeros(1, 8, 3)
    elif bad == "init_shape":
        kw["init_state"] = torch.zeros(1, 2, 4, 8)
    elif bad == "contiguous":
        x = torch.zeros(1, 2, 8, 8).transpose(1, 2)
    else:
        B = C = torch.zeros(8, 4)
    with pytest.raises((ValueError, TypeError)):
        ops.ssd_scan(x, a, B, C, **kw)
    with pytest.raises((ValueError, TypeError)):
        ssd_scan_cuda(x, a, B, C, **kw)


def test_ssd_cuda_wrapper_refuses_cpu_tensors():
    before = ssd_scan_cuda.launches
    with pytest.raises(ValueError):
        ssd_scan_cuda(*_args())
    with pytest.raises(ValueError):
        ssd_scan_cuda(*_args(), init_state=torch.zeros(1, 2, 8, 4))
    assert ssd_scan_cuda.launches == before == 0
