"""The chunk-parallel SSD scan (csrc/ssd_scan.cu) on the CPU: its host-side
plan, and a plain PyTorch emulation of what its CUDA kernels compute, pass
by pass and tile by tile, held against the JAX package.

1. the chunk pass, one CTA per (batch, chunk, group of heads): each head's
   cumulative log-decay, added as the kernel adds it (8 lanes each sum a
   block of 16 in sequence, then every lane adds the 8 block totals in
   sequence), and the chunk's own state as S^T (n, p) = B^T (x w), w =
   exp(total - cs), from that chunk's data alone; one more CTA per chunk
   makes C B^T for every head.  A single chunk needs no pass across chunks:
   the state before it is the initial state, and the chunk pass writes the
   final state init exp(total) + S itself;
2. the state pass across chunks: prev[c] = carry; carry = carry
   exp(total_c) + states[c], from the initial state;
3. the output pass, one CTA per (batch, chunk, group of heads, part of p):
   per head G = C B^T * exp(segsum) masked before the exp, and y = G x +
   exp(cs) (C prev^T) on the part's columns, rows past a ragged end not
   stored.

The emulation runs under every plan the kernel takes (1, 2 or 4 heads per
CTA, p whole or in halves) and must meet the JAX package's SSD tolerance
(2e-4, tests/test_kernels.py) against its sequential oracle
``ssd_scan_ref``, its model's ``ssd_chunked`` and the interpret-mode Pallas
``ssd_scan_kernel``.  The kernel's products are IEEE f32 FMAs summed in
order; the emulation's are f32 products summed in PyTorch's order, which
the tolerance covers.  The CUDA kernels run only on the card, where
chip_smoke.py holds them against the plain version."""

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ssd_scan import ssd_scan_kernel  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro_torch.kernels.ssd_scan import (  # noqa: E402
    CHUNK,
    MAX_HEADS,
    SCAN_BLOCK,
    SETUP,
    SsdPlan,
    _cumsum,
    ssd_plan,
)

SSD_TOL = 2e-4      # tests/test_kernels.py's tolerance for the SSD scan
H100_SMS = 132

# every plan the kernel takes: heads per CTA x p split
PLANS = [SsdPlan(hg, sp) for hg in (1, 2, MAX_HEADS) for sp in (1, 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=SSD_TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# ----------------------------------------------------------------------
# the emulation
# ----------------------------------------------------------------------

def lane_cumsum(a: torch.Tensor) -> torch.Tensor:
    """(..., CHUNK) -> cumulative sums as the kernel's warp adds them: lane
    k < 8 sums steps 16k .. 16k + 15 in sequence; every lane adds the block
    totals in sequence, lane k keeping the sum of those before its block;
    then each lane adds that to its 16 values."""
    blocks = a.reshape(*a.shape[:-1], CHUNK // SCAN_BLOCK, SCAN_BLOCK)
    run = torch.zeros_like(blocks[..., 0])
    inner = []
    for i in range(SCAN_BLOCK):
        run = run + blocks[..., i]
        inner.append(run)
    inner = torch.stack(inner, dim=-1)
    excl, mine = torch.zeros_like(run[..., 0]), []
    for k in range(CHUNK // SCAN_BLOCK):
        mine.append(excl)
        excl = excl + run[..., k]
    mine = torch.stack(mine, dim=-1)
    return (inner + mine[..., None]).reshape(a.shape)


def _chunk_tile(t: torch.Tensor, bi: int, c: int, l: int) -> torch.Tensor:
    """Steps c*CHUNK .. +CHUNK of batch bi, missing steps as zeros (the
    kernel's zero-filled copies)."""
    c0 = c * CHUNK
    lc = min(CHUNK, l - c0)
    tile = torch.zeros((CHUNK, *t.shape[2:]), dtype=t.dtype)
    tile[:lc] = t[bi, c0:c0 + lc]
    return tile


def chunk_states(x, a, B, bi, c, h):
    """The chunk pass for one head (batch bi, chunk c, head h): (cs (L,),
    S^T (n, p)) from that chunk's steps only; x is scaled by w in place
    before the product."""
    l = x.shape[1]
    xt = _chunk_tile(x, bi, c, l)[:, h]              # (L, p)
    at = _chunk_tile(a, bi, c, l)[:, h]              # (L,)
    Bt = _chunk_tile(B, bi, c, l)                    # (L, n)
    cs = lane_cumsum(at)
    w = torch.exp(cs[-1] - cs)
    return cs, Bt.T @ (xt * w[:, None])              # (n, p)


def chunk_cb(B, C, bi, c):
    """The chunk pass's extra CTA: C B^T (L, L) of chunk c, once for all
    heads."""
    l = B.shape[1]
    return _chunk_tile(C, bi, c, l) @ _chunk_tile(B, bi, c, l).T


def state_pass(states, cs, init):
    """Pass 2: states (b, nc, h, n, p), cs (b, nc, h, L), init (b, h, p, n)
    or None -> prev (b, nc, h, n, p), final (b, h, p, n)."""
    b, nc, h, n, p = states.shape
    carry = (init.transpose(-1, -2) if init is not None
             else torch.zeros((b, h, n, p)))
    prev = torch.empty_like(states)
    for c in range(nc):
        prev[:, c] = carry
        carry = carry * torch.exp(cs[:, c, :, -1])[..., None, None] \
            + states[:, c]
    return prev, carry.transpose(-1, -2)


def chunk_output(x, C, cb, cs, prev, y, bi, c, h0, heads, part, split):
    """The output pass for one CTA: each head of the group on the part's
    p columns, written into y (rows past a ragged end not)."""
    l, h, p = x.shape[1], x.shape[2], x.shape[3]
    ps = p // split
    cols = slice(part * ps, (part + 1) * ps)
    lc = min(CHUNK, l - c * CHUNK)
    Ct = _chunk_tile(C, bi, c, l)
    lower = torch.tril(torch.ones((CHUNK, CHUNK), dtype=torch.bool))
    for hh in range(h0, min(h0 + heads, h)):
        csh = cs[bi, c, hh]
        seg = (csh[:, None] - csh[None, :]).masked_fill(~lower, -torch.inf)
        G = cb[bi, c] * torch.exp(seg)               # masked before exp
        xt = _chunk_tile(x, bi, c, l)[:, hh, cols]
        out = G @ xt + torch.exp(csh)[:, None] * (Ct @ prev[bi, c, hh][:,
                                                                       cols])
        rows = slice(c * CHUNK, c * CHUNK + lc)
        assert torch.isnan(y[bi, rows, hh, cols]).all(), "written twice"
        y[bi, rows, hh, cols] = out[:lc]


def kernel_emulation(x, a, B, C, init=None, plan=SsdPlan(1, 1)):
    """The passes over the grids the kernel launches.  Scratch and y start
    as NaN, so a read of anything no pass wrote would show."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    nc = -(-l // CHUNK)
    states = torch.full((b, nc, h, n, p), float("nan"))
    cs = torch.full((b, nc, h, CHUNK), float("nan"))
    cb = torch.full((b, nc, CHUNK, CHUNK), float("nan"))
    for bi in range(b):
        for c in range(nc):
            cb[bi, c] = chunk_cb(B, C, bi, c)
            for hh in range(h):
                cs[bi, c, hh], states[bi, c, hh] = chunk_states(x, a, B, bi,
                                                                c, hh)
    if nc == 1:   # the chunk pass writes prev (init) and the final state
        s0 = init if init is not None else torch.zeros((b, h, p, n))
        final = s0 * torch.exp(cs[:, 0, :, -1])[..., None, None] \
            + states[:, 0].transpose(-1, -2)
        prev = s0.transpose(-1, -2)[:, None]
    else:
        prev, final = state_pass(states, cs, init)
    y = torch.full_like(x, float("nan"))
    for bi in range(b):
        for c in range(nc):
            for h0 in range(0, h, plan.heads):
                for part in range(plan.split):
                    chunk_output(x, C, cb, cs, prev, y, bi, c, h0,
                                 plan.heads, part, plan.split)
    return y, final


# ----------------------------------------------------------------------
# inputs and the JAX side
# ----------------------------------------------------------------------

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


def _jax_chunked(x, a, B, C, s0=None):
    """ssd_chunked on whole chunks, padded as mamba2_fwd pads."""
    l = x.shape[1]
    pad = (-l) % CHUNK
    padded = [np.pad(t, [(0, 0), (0, pad)] + [(0, 0)] * (t.ndim - 2))
              for t in (x, a, B, C)]
    y, final = JS.ssd_chunked(*(jnp.asarray(t) for t in padded), CHUNK,
                              None if s0 is None else jnp.asarray(s0))
    return np.asarray(y)[:, :l], np.asarray(final)


def _emulate_all_plans(x, a, B, C, s0=None):
    """The emulation under every plan the shape admits; all must agree to
    the last bit (a plan moves work between CTAs, not the arithmetic)."""
    t = [torch.from_numpy(v) for v in (x, a, B, C)]
    init = None if s0 is None else torch.from_numpy(s0)
    p = x.shape[3]
    outs = [kernel_emulation(*t, init, plan) for plan in PLANS
            if p % (4 * plan.split) == 0]
    for y, final in outs[1:]:
        torch.testing.assert_close(y, outs[0][0], rtol=0, atol=0)
        torch.testing.assert_close(final, outs[0][1], rtol=0, atol=0)
    y, final = outs[0]
    assert torch.isfinite(y).all() and torch.isfinite(final).all()
    return y.numpy(), final.numpy()


# ----------------------------------------------------------------------
# against the JAX package
# ----------------------------------------------------------------------

# l (half a chunk, one, ragged, three) x (p, n) x b, as test_torch_ssm.py;
# the interpret-mode Pallas kernel joins on the b = 2 cases
SWEEP = [(l, p, n, b) for l in (64, 128, 200, 384)
         for p, n in ((32, 16), (64, 64)) for b in (1, 2)]


@pytest.mark.parametrize("l,p,n,b", SWEEP)
def test_emulation_matches_jax_oracle_model_and_kernel(l, p, n, b):
    x, a, B, C, _ = _inputs(l + p + b, b, l, 3, p, n)
    y, final = _emulate_all_plans(x, a, B, C)
    want_ref, final_ref = jref.ssd_scan_ref(*(jnp.asarray(t)
                                              for t in (x, a, B, C)))
    _close(y, want_ref)
    _close(final, final_ref)
    want_model, final_model = _jax_chunked(x, a, B, C)
    _close(y, want_model)
    _close(final, final_model)
    if b == 2:
        want_kernel, _ = ssd_scan_kernel(*(jnp.asarray(t)
                                           for t in (x, a, B, C)),
                                         interpret=True)
        _close(y, want_kernel)


@pytest.mark.parametrize("l,p,n", [(64, 32, 16), (200, 64, 64),
                                   (384, 32, 16)])
def test_emulation_carries_the_initial_state(l, p, n):
    x, a, B, C, s0 = _inputs(l + 7, 2, l, 3, p, n, init=True)
    y, final = _emulate_all_plans(x, a, B, C, s0)
    want_ref, final_ref = jref.ssd_scan_ref(
        *(jnp.asarray(t) for t in (x, a, B, C)), init_state=jnp.asarray(s0))
    _close(y, want_ref)
    _close(final, final_ref)
    want_model, final_model = _jax_chunked(x, a, B, C, s0)
    _close(y, want_model)
    _close(final, final_model)


def test_emulation_with_model_like_decays():
    """Decays as the hybrid's layers make them (a = -softplus(N) *
    linspace(1, 16)): cumulative sums reach -1e3 in a chunk, where the
    order of additions in cs matters."""
    rng = np.random.default_rng(11)
    b, l, h, p, n = 1, 384, 8, 32, 16
    x, _, B, C, s0 = _inputs(12, b, l, h, p, n, init=True)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    a = (-dt * np.linspace(1.0, 16.0, h)).astype(np.float32)
    xd = x * dt[..., None]
    y, final = _emulate_all_plans(xd, a, B, C, s0)
    want, final_want = _jax_chunked(xd, a, B, C, s0)
    _close(y, want)
    _close(final, final_want)


# ----------------------------------------------------------------------
# the passes' own properties
# ----------------------------------------------------------------------

@pytest.mark.parametrize("scale", [0.1, 30.0])
def test_lane_cumsum_is_the_reference_cumsum_bit_for_bit(scale):
    a = torch.from_numpy((-np.abs(np.random.default_rng(3).standard_normal(
        (5, CHUNK))) * scale).astype(np.float32))
    torch.testing.assert_close(lane_cumsum(a), _cumsum(a), rtol=0, atol=0)


@pytest.mark.parametrize("l,c", [(384, 1), (200, 1), (384, 0), (384, 2)])
def test_a_chunk_state_reads_only_its_own_chunk(l, c):
    """Every step outside chunk c is NaN: its cs and state stay finite and
    equal to those from clean inputs."""
    x, a, B, _, _ = _inputs(5, 2, l, 3, 32, 16)
    clean = [torch.from_numpy(t) for t in (x, a, B)]
    dirty = [t.clone() for t in clean]
    outside = torch.ones(l, dtype=torch.bool)
    outside[c * CHUNK:(c + 1) * CHUNK] = False
    for t in dirty:
        t[:, outside] = float("nan")
    for bi in range(2):
        for hh in range(3):
            cs, st = chunk_states(*dirty, bi, c, hh)
            cs_want, st_want = chunk_states(*clean, bi, c, hh)
            assert torch.isfinite(st).all() and torch.isfinite(cs).all()
            torch.testing.assert_close(st, st_want, rtol=0, atol=0)
            torch.testing.assert_close(cs, cs_want, rtol=0, atol=0)


def test_state_pass_is_the_sequential_recurrence():
    """prev[c] is the state entering chunk c (the oracle's final state
    after the first c chunks), and the last carry the final state."""
    x, a, B, C, s0 = _inputs(8, 1, 384, 2, 8, 4, init=True)
    t = [torch.from_numpy(v) for v in (x, a, B)]
    per = [[chunk_states(*t, 0, c, hh) for hh in range(2)] for c in range(3)]
    cs = torch.stack([torch.stack([s[0] for s in row]) for row in per])[None]
    states = torch.stack([torch.stack([s[1] for s in row])
                          for row in per])[None]
    prev, final = state_pass(states, cs, torch.from_numpy(s0))
    _close(prev[:, 0].transpose(-1, -2).numpy(), s0, 0)
    for c in (1, 2):
        _, entering = jref.ssd_scan_ref(
            *(jnp.asarray(v[:, :c * CHUNK]) for v in (x, a, B, C)),
            init_state=jnp.asarray(s0))
        _close(prev[:, c].transpose(-1, -2).numpy(), entering)
    _, final_ref = jref.ssd_scan_ref(*(jnp.asarray(v) for v in (x, a, B, C)),
                                     init_state=jnp.asarray(s0))
    _close(final.numpy(), final_ref)


# ----------------------------------------------------------------------
# the plan
# ----------------------------------------------------------------------

def _cost(plan, b, l, h, sms):
    """Head-times on the busiest SM: whole waves of one CTA per SM, each
    CTA its heads over the p split plus its set-up."""
    ctas = b * -(-l // CHUNK) * -(-h // plan.heads) * plan.split
    return -(-ctas // sms) * (plan.heads / plan.split + SETUP)


def test_plan_reads_the_shape_and_the_sm_count_alone():
    assert list(inspect.signature(ssd_plan).parameters) == ["b", "l", "h",
                                                            "p", "sms"]
    # zamba2-7b's Mamba2 layers (112 heads of p = 64) at each prefill
    # bucket and at max_seq, on an H100's 132 SMs
    want = {64: SsdPlan(1, 1), 128: SsdPlan(1, 1), 256: SsdPlan(2, 1),
            512: SsdPlan(4, 1), 1024: SsdPlan(4, 1), 2048: SsdPlan(2, 1)}
    for l, plan in want.items():
        assert ssd_plan(1, l, 112, 64, H100_SMS) == plan
    # few heads and chunks: p in halves fills more SMs
    assert ssd_plan(2, 256, 3, 32, H100_SMS) == SsdPlan(1, 2)
    # the same shape on cards of other SM counts
    assert ssd_plan(1, 1024, 112, 64, 1000) == SsdPlan(1, 1)
    assert ssd_plan(1, 64, 112, 64, 1000) == SsdPlan(1, 2)


@pytest.mark.parametrize("sms", [1, 16, 132, 264, 4096])
def test_plan_is_the_cheapest_the_kernel_takes(sms):
    for b in (1, 2, 8):
        for l in (1, 64, 129, 1024, 2048):
            for h in (1, 3, 9, 112):
                for p in (4, 12, 32, 64):
                    plan = ssd_plan(b, l, h, p, sms)
                    assert plan in PLANS
                    assert p % (4 * plan.split) == 0
                    valid = [q for q in PLANS if p % (4 * q.split) == 0]
                    assert _cost(plan, b, l, h, sms) == min(
                        _cost(q, b, l, h, sms) for q in valid)
