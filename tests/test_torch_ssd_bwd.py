"""The SSD scan's redesigned backward (csrc/ssd_scan_bwd.cu) on the CPU:
its host-side plan, the forward's scratch it reads, a plain PyTorch
emulation of what its kernels compute, and the precision a tensor-core
version of its products would keep.

1. The plan: ``ssd_bwd_plan`` gives every shape of the tests and of
   chip_smoke.py (h = 112, 4, 3, 1; l = 100, 200, 256, 1024) a valid
   grouping of the heads, the cheapest by its own cost.
2. The saved scratch: ``ssd_scratch_plain`` lays out the state before each
   chunk (S^T), each chunk's cumulative decay and C B^T (the pairs each
   thread holds) as the CUDA forward does; gradients from it equal the
   recomputed ones bit for bit, and ``ops.ssd_scan``'s autograd function,
   which keeps it from the forward, matches ``jax.grad``.
3. The emulation: the state gradients across the chunks in reverse as
   ``ssd_bwd_states`` takes them, then per chunk and group of heads as
   ``ssd_bwd_chunk`` runs, C B^T read through the threads' pairs of the
   packed scratch, the triangles cut where each thread's two runs of four
   rows start and end, dB and dC summed over a group's heads and then over
   the groups, da by one warp's lanes of four steps; against
   ``ssd_scan_bwd_plain`` and ``jax.grad`` of ``ssd_chunked``, each
   gradient to 1e-5 of its largest magnitude (da 1e-4,
   tests/test_torch_ssd_grad.py's tolerances).
4. 3xTF32: every product of the backward with each operand split into hi
   (its low 13 mantissa bits cleared, TF32) and lo = the rest (cleared
   likewise), summed as hi.hi + hi.lo + lo.hi in f32, at zamba2-7b's width
   (h = 112, p = n = 64) over two chunks: within 1e-4 of each gradient's
   largest magnitude (da 1e-3) of ``ssd_scan_bwd_plain`` and of
   ``jax.grad``, the card's tolerances (chip_smoke.py).  Plain TF32 (hi.hi
   alone) misses them, which the test shows too."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as S  # noqa: E402
from test_torch_ssd_grad import NAMES, _inputs, _jax_grads  # noqa: E402

H100_SMS = 132
TOL = 1e-5
DA_TOL = 1e-4
CARD_TOL = 1e-4       # chip_smoke.py's SSD_BWD_TOL
CARD_DA_TOL = 1e-3    # and SSD_BWD_DA_TOL

# (b, l, h): every backward shape of the tests and of chip_smoke.py
PLAN_SHAPES = [(b, l, h) for b in (1, 2) for l in (100, 200, 256, 1024)
               for h in (112, 4, 3, 1)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(v):
    return None if v is None else torch.from_numpy(v)


def _rel_errs(got, want):
    """Each gradient's max |got - want| over its largest |want|."""
    out = {}
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, f"d{name} given without an initial state"
            continue
        g = np.asarray(g.detach() if isinstance(g, torch.Tensor) else g)
        w = np.asarray(w)
        out[name] = float(np.abs(g - w).max()) / max(float(np.abs(w).max()),
                                                     1e-30)
    return out


def _assert_within(errs, tol, da_tol):
    for name, err in errs.items():
        assert err <= (da_tol if name == "a" else tol), \
            f"d{name}: {err} of its max"


# ----------------------------------------------------------------------
# 1. the plan
# ----------------------------------------------------------------------

def _cost(heads, b, l, h, sms):
    ctas = b * -(-l // S.CHUNK) * -(-h // heads)
    return -(-ctas // sms) * (heads + S.BWD_SETUP)


@pytest.mark.parametrize("sms", [1, 16, H100_SMS, 264, 4096])
def test_bwd_plan_groups_every_head_at_the_least_cost(sms):
    for b, l, h in PLAN_SHAPES:
        heads = S.ssd_bwd_plan(b, l, h, sms)
        groups = -(-h // heads)
        assert 1 <= heads <= h
        assert (groups - 1) * heads < h <= groups * heads  # none empty
        assert _cost(heads, b, l, h, sms) == min(
            _cost(k, b, l, h, sms) for k in range(1, h + 1))


def test_bwd_plan_at_zamba2_shapes():
    # l = 1024: 8 chunks x 16 groups of 7 heads fill 128 of 132 SMs once;
    # the train case's l = 256: 2 chunks x 56 groups of 2
    assert S.ssd_bwd_plan(1, 1024, 112, H100_SMS) == 7
    assert S.ssd_bwd_plan(1, 256, 112, H100_SMS) == 2
    assert S.ssd_bwd_plan(1, 200, 112, H100_SMS) == 2
    # few heads: one per CTA
    assert S.ssd_bwd_plan(2, 256, 3, H100_SMS) == 1
    assert S.ssd_bwd_plan(1, 100, 4, H100_SMS) == 1


# ----------------------------------------------------------------------
# 2. the saved scratch
# ----------------------------------------------------------------------

CASES = [(2, 256, 3, 8, 4, True, True),      # two whole chunks
         (1, 200, 2, 16, 8, True, False),    # ragged: padded to 256
         (1, 100, 4, 8, 4, True, True),      # one ragged chunk
         (1, 128, 2, 8, 8, False, False)]    # one chunk, no state


def test_cb_pairs_are_the_threads_pairs():
    """Pair (r, q) of thread (ty, tx) at (r (r + 1) / 2 + q) * 256 + 16 ty
    + tx holds C_i . B_j, i = ty + 16 r, j = tx + 16 q; unpacking gives
    back every pair j // 16 <= i // 16 and zeros above."""
    cb = torch.randn(1, 2, 128, 128)
    packed = S._pack_cb(cb)
    for r, q, ty, tx in [(0, 0, 0, 0), (3, 1, 5, 9), (7, 7, 15, 15),
                         (7, 0, 2, 11)]:
        at = (r * (r + 1) // 2 + q) * 256 + 16 * ty + tx
        assert packed[0, 1, at] == cb[0, 1, ty + 16 * r, tx + 16 * q]
    blocks = torch.arange(128) // 16
    kept = blocks[None, :] <= blocks[:, None]
    assert torch.equal(S._unpack_cb(packed), cb * kept)


@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_saved_scratch_gives_the_recomputed_gradients(case):
    ins, dy, df = _inputs(*case, seed=3)
    args = [_t(ins[k]) for k in NAMES]
    b, l, h, p = args[0].shape
    n = args[2].shape[-1]
    scratch = S.ssd_scratch_plain(*args)
    prev, cs, cb = S.scratch_views(scratch, b, l, h, p, n)
    chunks = -(-l // S.CHUNK)
    assert prev.shape == (b, chunks, h, n, p)
    assert cs.shape == (b, chunks, h, S.CHUNK)
    assert cb.shape == (b, chunks, S.CB_FLOATS)
    y, final, kept = S.ssd_scan_plain(*args, keep_scratch=True)
    assert torch.equal(kept, scratch)
    saved = S.ssd_scan_bwd_plain(*args, _t(dy), _t(df), scratch=scratch)
    again = S.ssd_scan_bwd_plain(*args, _t(dy), _t(df))
    for g1, g2 in zip(saved, again):
        assert (g1 is None and g2 is None) or torch.equal(g1, g2)
    _assert_within(_rel_errs(saved, _jax_grads(ins, dy, df)), TOL, DA_TOL)
    with pytest.raises(ValueError):
        S.scratch_views(scratch[:-4], b, l, h, p, n)


def test_autograd_function_keeps_the_forwards_scratch(monkeypatch):
    """``ops.ssd_scan``'s backward gets the forward's scratch (no forward
    pass again) and matches ``jax.grad``."""
    ins, dy, df = _inputs(1, 300, 3, 8, 8, True, True, seed=4)
    seen = []
    real = S.ssd_scan_bwd_plain

    def spy(*args, scratch=None, **kw):
        seen.append(scratch)
        return real(*args, scratch=scratch, **kw)

    monkeypatch.setattr(ops, "ssd_scan_bwd_plain", spy)
    t = {k: torch.from_numpy(v).requires_grad_() for k, v in ins.items()}
    y, final = ops.ssd_scan(*(t[k] for k in NAMES))
    ((y * _t(dy)).sum() + (final * _t(df)).sum()).backward()
    assert len(seen) == 1 and seen[0] is not None
    assert torch.equal(seen[0], S.ssd_scratch_plain(
        *(t[k].detach() for k in NAMES)))
    _assert_within(_rel_errs([t[k].grad for k in NAMES],
                             _jax_grads(ins, dy, df)), TOL, DA_TOL)


# ----------------------------------------------------------------------
# 3. the kernels' passes, emulated
# ----------------------------------------------------------------------

def _pair_index():
    """(36, 256) row and column of each packed pair, as a thread reads
    it: ``in[(r (r + 1) / 2 + q) * 256 + tid]``."""
    tid = torch.arange(256)
    rows, cols = [], []
    for r, q in S.CB_PAIRS:
        rows.append(tid // 16 + 16 * r)
        cols.append(tid % 16 + 16 * q)
    return torch.stack(rows), torch.stack(cols)


def _run_start(L=128):
    """First row of the run of four each row belongs to: a thread's lo run
    4 a .. + 4 and hi run 124 - 4 a .. + 4 both start at a multiple of 4."""
    return 4 * (torch.arange(L) // 4)


def _chunk_pass(xc, dyc, Bc, Cc, cs, prev, dS, cbp, Lc, heads):
    """One chunk of ``ssd_bwd_chunk`` for every group: returns dx (L, h, p),
    dcs (h, L) and each group's dB, dC (groups, L, n).  xc/dyc (L, h, p);
    Bc/Cc (L, n); cs (h, L); prev/dS (h, p, n); cbp (CB_FLOATS,)."""
    L, h, p = xc.shape
    rows, cols = _pair_index()
    cb = torch.zeros(L, L)
    cb[rows, cols] = cbp.view(len(S.CB_PAIRS), 256)
    start = _run_start(L)
    steps = torch.arange(L)
    # lower_tile: row j sums i from its run's start to Lc; upper_tile: row
    # i sums j from 0 to its run's end, cut at Lc
    lower = (steps[None, :] >= start[:, None]) & (steps[None, :] < Lc)
    upper = (steps[None, :] < torch.clamp(start + 4, max=Lc)[:, None])
    tri = steps[None, :] <= steps[:, None]
    dx = torch.zeros(L, h, p)
    dcs = torch.zeros(h, L)
    dBg, dCg = [], []
    for h0 in range(0, h, heads):
        dBa = torch.zeros(L, Bc.shape[1])
        dCa = torch.zeros(L, Bc.shape[1])
        for hd in range(h0, min(h0 + heads, h)):
            x, dy, c_s = xc[:, hd], dyc[:, hd], cs[hd]
            total = c_s[-1]
            ecs, w = torch.exp(c_s), torch.exp(total - c_s)
            U = dy @ prev[hd]
            V = x @ dS[hd]
            dCa = dCa + ecs[:, None] * U
            dBa = dBa + w[:, None] * V
            dxh = w[:, None] * (Bc @ dS[hd].T)
            E = torch.exp((c_s[:, None] - c_s[None, :]).masked_fill(
                ~tri, -torch.inf))
            ds = (dy @ x.T) * E
            G = cb * E
            M = ds * cb
            # a thread's rows of G^T and ds^T start where its run starts;
            # entries above the diagonal inside a run are zero
            assert not G.T[~lower & tri.T].any()
            dx[:, hd] = dxh + (G.T * lower) @ dy
            dBa = dBa + (ds.T * lower) @ Cc
            dCa = dCa + (ds * upper) @ Bc
            wdw = w * (Bc * V).sum(1)
            dcs[hd] = (M.sum(1) - M.sum(0)) + ecs * (Cc * U).sum(1) - wdw
            dcs[hd, -1] += wdw.sum() + torch.exp(total) * (dS[hd]
                                                            * prev[hd]).sum()
        dBg.append(dBa)
        dCg.append(dCa)
    return dx, dcs, torch.stack(dBg), torch.stack(dCg)


def _warp_reverse_cumsum(dcs):
    """chunk_da's order: lane k sums its steps 4 k .. + 4 from the last,
    then adds the sum of every later lane."""
    v = dcs.reshape(*dcs.shape[:-1], 32, 4)
    own = v.flip(-1).cumsum(-1).flip(-1)
    later = own[..., 0].flip(-1).cumsum(-1).flip(-1)
    later = torch.nn.functional.pad(later[..., 1:], (0, 1))
    return (own + later[..., None]).reshape(dcs.shape)


def _emulate(x, a, B, C, s0, dy, df, heads):
    """The kernels of csrc/ssd_scan_bwd.cu on the forward's scratch."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    L = S.CHUNK
    scratch = S.ssd_scratch_plain(x, a, B, C, s0)
    prev_t, cs, cbp = S.scratch_views(scratch, b, l, h, p, n)
    nc = cs.shape[1]
    xc, _, Bc, Cc, dyc = S._chunked(L, x, a, B, C, dy)
    # ssd_bwd_states: loc^T (n, p) per chunk and head, and the recurrence
    # in reverse
    loc_t = torch.einsum("bcin,bchi,bcihp->bchnp", Cc, torch.exp(cs), dyc)
    g = (df.transpose(-1, -2) if df is not None
         else torch.zeros(b, h, n, p))
    dS_t = torch.empty_like(loc_t)
    for c in reversed(range(nc)):
        dS_t[:, c] = g
        g = loc_t[:, c] + g * torch.exp(cs[:, c, :, -1])[..., None, None]
    dinit = g.transpose(-1, -2) if s0 is not None else None
    # ssd_bwd_chunk for each chunk and group; ssd_bwd_group_sum
    dx = torch.zeros(b, nc * L, h, p)
    da = torch.zeros(b, nc * L, h)
    dB = torch.zeros(b, nc * L, n)
    dC = torch.zeros(b, nc * L, n)
    for bi in range(b):
        for c in range(nc):
            rows = slice(c * L, (c + 1) * L)
            out = _chunk_pass(xc[bi, c], dyc[bi, c], Bc[bi, c], Cc[bi, c],
                              cs[bi, c], prev_t[bi, c].transpose(-1, -2),
                              dS_t[bi, c].transpose(-1, -2), cbp[bi, c],
                              min(L, l - c * L), heads)
            dx[bi, rows] = out[0]
            da[bi, rows] = _warp_reverse_cumsum(out[1]).T
            dB[bi, rows] = out[2].sum(0)
            dC[bi, rows] = out[3].sum(0)
    return dx[:, :l], da[:, :l], dB[:, :l], dC[:, :l], dinit


@pytest.mark.parametrize("heads", [1, 2, 3])
@pytest.mark.parametrize("case", CASES, ids=lambda c: "x".join(map(str, c)))
def test_emulated_kernels_match_plain_and_jax(case, heads):
    ins, dy, df = _inputs(*case, seed=5)
    args = [_t(ins[k]) for k in NAMES]
    got = _emulate(*args, _t(dy), _t(df), heads)
    plain = S.ssd_scan_bwd_plain(*args, _t(dy), _t(df))
    _assert_within(_rel_errs(got, [None if v is None else v.numpy()
                                   for v in plain]), TOL, DA_TOL)
    _assert_within(_rel_errs(got, _jax_grads(ins, dy, df)), TOL, DA_TOL)


# ----------------------------------------------------------------------
# 4. 3xTF32
# ----------------------------------------------------------------------

def _tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 -> TF32 as the tensor cores read it: the low 13 mantissa bits
    cleared."""
    return (t.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split_einsum(eq: str, A: torch.Tensor, Bm: torch.Tensor,
                  terms: int) -> torch.Tensor:
    """einsum of two f32 operands from their TF32 parts: hi.hi, + hi.lo +
    lo.hi with ``terms`` = 3, in f32."""
    ah, bh = _tf32(A), _tf32(Bm)
    out = torch.einsum(eq, ah, bh)
    if terms == 3:
        al, bl = _tf32(A - ah), _tf32(Bm - bh)
        out = out + torch.einsum(eq, ah, bl) + torch.einsum(eq, al, bh)
    return out


def _bwd_split(x, a, B, C, s0, dy, df, terms):
    """``ssd_scan_bwd_plain`` with each of its products (dy x^T, G^T dy, ds
    B, ds^T C, loc, dy prev, x dS, B dS^T) taken from TF32 parts; C B^T and
    the states come from the forward's scratch in f32, every elementwise
    step in f32."""
    b, l, h, p = x.shape
    n = B.shape[-1]
    L = S.CHUNK
    mm = lambda eq, u, v: _split_einsum(eq, u, v, terms)  # noqa: E731
    xc, _, Bc, Cc, dyc = S._chunked(L, x, a, B, C, dy)
    nc = xc.shape[1]
    prev_t, cs, cbp = S.scratch_views(S.ssd_scratch_plain(x, a, B, C, s0),
                                      b, l, h, p, n)
    prev = prev_t.transpose(-1, -2)                         # (b,c,h,p,n)
    cs = cs.permute(0, 2, 1, 3)                             # (b,h,c,L)
    cb = S._unpack_cb(cbp)[:, None]                         # (b,1,c,L,L)
    total = cs[..., -1]
    w, ecs = torch.exp(total[..., None] - cs), torch.exp(cs)
    ecs_t = ecs.permute(0, 2, 3, 1)[..., None]              # (b,c,L,h,1)
    w_t = w.permute(0, 2, 3, 1)[..., None]
    loc = mm("bclhp,bcln->bchpn", dyc * ecs_t, Cc)
    g = df if df is not None else x.new_zeros((b, h, p, n))
    dS = [None] * nc
    for c in reversed(range(nc)):
        dS[c] = g
        g = loc[:, c] + g * torch.exp(total[:, :, c, None, None])
    dS = torch.stack(dS, dim=1)
    tri = torch.tril(torch.ones((L, L), dtype=torch.bool))
    E = torch.exp((cs[..., :, None] - cs[..., None, :]).masked_fill(
        ~tri, -torch.inf))
    G = cb * E
    ds = mm("bcihp,bcjhp->bhcij", dyc, xc) * E
    M = ds * cb
    W = mm("bcjn,bchpn->bcjhp", Bc, dS)
    dx = mm("bhcij,bcihp->bcjhp", G, dyc) + w_t * W
    U = mm("bcihp,bchpn->bcihn", dyc, prev)
    V = mm("bcjhp,bchpn->bcjhn", xc, dS)
    dC = (mm("bhcij,bcjn->bcin", ds, Bc)
          + (ecs_t * U).sum(3))
    dB = (mm("bhcij,bcin->bcjn", ds, Cc)
          + (w_t * V).sum(3))
    wdw = w * torch.einsum("bcjn,bcjhn->bhcj", Bc, V)
    dcs = (M.sum(-1) - M.sum(-2)
           + ecs * torch.einsum("bcin,bcihn->bhci", Cc, U) - wdw)
    dcs[..., -1] += wdw.sum(-1) + torch.exp(total) * torch.einsum(
        "bchpn,bchpn->bhc", dS, prev)
    da = S._reverse_cumsum(dcs).permute(0, 2, 3, 1).reshape(b, nc * L, h)
    dinit = g if s0 is not None else None
    return (dx.reshape(b, nc * L, h, p)[:, :l], da[:, :l],
            dB.reshape(b, nc * L, n)[:, :l], dC.reshape(b, nc * L, n)[:, :l],
            dinit)


@pytest.fixture(scope="module")
def zamba2_width():
    """zamba2-7b's Mamba2 width over two chunks, with both states: the
    inputs, jax.grad and the plain backward."""
    ins, dy, df = _inputs(1, 256, 112, 64, 64, True, True, seed=6)
    args = [_t(ins[k]) for k in NAMES]
    plain = S.ssd_scan_bwd_plain(*args, _t(dy), _t(df))
    return (ins, dy, df, args, _jax_grads(ins, dy, df),
            [None if v is None else v.numpy() for v in plain])


def test_3xtf32_products_hold_the_cards_tolerance(zamba2_width):
    ins, dy, df, args, jax_g, plain = zamba2_width
    got = _bwd_split(*args, _t(dy), _t(df), terms=3)
    _assert_within(_rel_errs(got, plain), CARD_TOL, CARD_DA_TOL)
    _assert_within(_rel_errs(got, jax_g), CARD_TOL, CARD_DA_TOL)


def test_plain_tf32_products_miss_it(zamba2_width):
    """hi.hi alone (TF32) is off by more than the tolerance: the split's
    two cross terms are what keep it."""
    ins, dy, df, args, jax_g, plain = zamba2_width
    errs = _rel_errs(_bwd_split(*args, _t(dy), _t(df), terms=1), plain)
    assert max(e for name, e in errs.items() if name != "a") > CARD_TOL
