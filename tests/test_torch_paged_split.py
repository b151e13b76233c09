"""The split decode of the paged kernel (csrc/paged_attention.cu) on the CPU:
its host-side plan, and a plain PyTorch emulation of what the kernel
computes (each live split's softmax over chunks of its tokens, online
across chunks, then the merge of the partials, or the single split written
out directly), held against the JAX package's paged_attention_ref.

The kernel runs only on the card (chip_smoke.py holds it against the plain
version there); these tests show on the CPU that its split-and-combine
arithmetic is the function the reference computes, at the f32 tolerance of
tests/test_torch_kernels.py."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels.paged_attention import (  # noqa: E402
    CHUNK,
    MAX_SPLITS,
    MIN_SPLIT,
    PagedPlan,
    paged_plan,
)

F32_CHUNK = CHUNK // 2   # tokens the kernel loads at once in f32

F32_TOL = 2e-5      # both sides compute in f32; only the summation order differs


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def split_emulation(q, k_pages, v_pages, block_table, lengths, split,
                    n_splits, chunk=F32_CHUNK):
    """What the kernel computes, in plain PyTorch and f32.  A grid cell
    (KV head, sequence, split) past the length does nothing; a live split
    reads only its own tokens' rows through the table, a chunk at a time,
    with one softmax step per chunk, online across chunks; a sequence of
    one live split is written out by it, otherwise the partials (acc, m,
    l) go to scratch and are merged with weights exp(m_s - M).  Scratch the
    kernel never writes holds NaN here, so a read of it would show."""
    b, hq, d = q.shape
    _, page, hkv, _ = k_pages.shape
    g = hq // hkv
    capacity = block_table.shape[1] * page
    scale = 1.0 / math.sqrt(d)
    out = torch.full((b, hq, d), float("nan"))
    part = torch.full((b, hkv, n_splits, g, d + 2), float("nan"))
    for bi in range(b):
        n = min(max(int(lengths[bi]), 0), capacity)
        if n == 0:
            out[bi] = 0.0
            continue
        n_live = -(-n // split)
        assert n_live <= n_splits
        qg = q[bi].float().view(hkv, g, d)
        for sp in range(n_live):
            t0, t1 = sp * split, min(sp * split + split, n)
            m = torch.full((hkv, g), -math.inf)
            l = torch.zeros((hkv, g))
            acc = torch.zeros((hkv, g, d))
            for a in range(t0, t1, chunk):
                toks = torch.arange(a, min(a + chunk, t1))
                pages = block_table[bi, toks // page].long()
                kt = k_pages[pages, toks % page].float()   # (n, hkv, d)
                vt = v_pages[pages, toks % page].float()
                s = torch.einsum("hgd,nhd->hgn", qg, kt) * scale
                m_new = torch.maximum(m, s.amax(-1))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[..., None] + torch.einsum(
                    "hgn,nhd->hgd", p, vt)
                m = m_new
            if n_live == 1:
                out[bi] = (acc / l[..., None]).reshape(hq, d)
            else:
                part[bi, :, sp, :, :d] = acc
                part[bi, :, sp, :, d] = m
                part[bi, :, sp, :, d + 1] = l
        if n_live > 1:
            live = part[bi, :, :n_live]                    # (hkv, s, g, d+2)
            big_m = live[..., d].amax(1, keepdim=True)
            w = torch.exp(live[..., d] - big_m)            # (hkv, s, g)
            big_l = (live[..., d + 1] * w).sum(1)
            merged = (live[..., :d] * w[..., None]).sum(1) / big_l[..., None]
            out[bi] = merged.reshape(hq, d)
    return out.to(q.dtype)


def _inputs(seed, b, page, per_seq, hq, hkv, d, lengths, permute=True):
    rng = np.random.default_rng(seed)
    n_pages = b * per_seq
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    kp = rng.standard_normal((n_pages, page, hkv, d), dtype=np.float32)
    vp = rng.standard_normal((n_pages, page, hkv, d), dtype=np.float32)
    ids = rng.permutation(n_pages) if permute else np.arange(n_pages)
    table = ids.reshape(b, per_seq).astype(np.int32)
    return q, kp, vp, table, np.asarray(lengths, np.int32)


def _check(arrs, split, n_splits, chunk=F32_CHUNK):
    q, kp, vp, table, lens = arrs
    got = split_emulation(*(torch.from_numpy(x) for x in arrs), split,
                          n_splits, chunk).numpy()
    want = np.asarray(jref.paged_attention_ref(
        *(jnp.asarray(x) for x in arrs)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    for i, n in enumerate(lens):
        if n == 0:
            assert not got[i].any()


# the sweep of test_torch_kernels.py (TestPagedAttention): capacity 128, so
# the kernel's own plan is one split; splits of 32 tokens exercise the
# merge on the same inputs
PAGED = [
    (page, per_seq, hq, hkv, [page * per_seq, 3, page + 1])
    for page, per_seq in ((16, 8), (32, 4)) for hq, hkv in ((4, 4), (8, 2))
] + [
    (16, 8, 4, 2, [1, 2]),
    (16, 8, 8, 2, [0, 17, 128]),
]


@pytest.mark.parametrize("split", ["plan", 32])
@pytest.mark.parametrize("page,per_seq,hq,hkv,lengths", PAGED)
def test_split_emulation_matches_jax_on_the_paged_sweep(
        page, per_seq, hq, hkv, lengths, split):
    d = 64
    b = len(lengths)
    plan = paged_plan(b, hkv, hq // hkv, d, per_seq, page)
    if split == "plan":
        split, n_splits = plan.split, plan.n_splits
    else:
        n_splits = -(-per_seq * page // split)
    _check(_inputs(page + hq + b, b, page, per_seq, hq, hkv, d, lengths),
           split, n_splits)


# capacity 24 pages of 16 = 384 tokens: three splits of the kernel's own
# 128; lengths 0, 1, exactly a split, a split + 1, the full capacity, and
# one that leaves an empty trailing split; G = Hq / Hkv of 1, 2, 4 and 16
@pytest.mark.parametrize("hq,hkv,d", [(4, 4, 64), (4, 2, 128), (8, 2, 112),
                                      (16, 1, 64)])
def test_split_emulation_matches_jax_at_the_split_edges(hq, hkv, d):
    page, per_seq = 16, 24
    lengths = [0, 1, 128, 129, 384, 200]
    plan = paged_plan(len(lengths), hkv, hq // hkv, d, per_seq, page)
    assert (plan.split, plan.n_splits) == (128, 3)
    _check(_inputs(hq * d, len(lengths), page, per_seq, hq, hkv, d,
                   lengths), plan.split, plan.n_splits)
    # the f32 kernel reads a split of 128 in two chunks of 64: also with
    # chunks of 16 (eight online steps per split)
    _check(_inputs(hq * d, len(lengths), page, per_seq, hq, hkv, d,
                   lengths), plan.split, plan.n_splits, chunk=16)


def test_split_emulation_reads_no_page_past_the_length():
    page, per_seq, hq, hkv, d = 16, 24, 8, 2, 64
    lengths = [130, 1, 0]
    q, kp, vp, table, lens = _inputs(3, 3, page, per_seq, hq, hkv, d,
                                     lengths)
    poisoned = table.copy()
    for i, n in enumerate(lengths):
        poisoned[i, -(-n // page):] = 1 << 30    # would fail to index
    plan = paged_plan(3, hkv, hq // hkv, d, per_seq, page)
    got = split_emulation(*(torch.from_numpy(x) for x in (
        q, kp, vp, poisoned, lens)), 64, -(-per_seq * page // 64)).numpy()
    want = np.asarray(jref.paged_attention_ref(
        *(jnp.asarray(x) for x in (q, kp, vp, table, lens))))
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    assert plan.n_splits == 3


@pytest.mark.parametrize("per_seq,page,split,n_splits", [
    (128, 16, 128, 16),         # the serving engine's 8 x 2048 slots
    (8, 16, 128, 1),            # capacity one split
    (129, 16, 128, 17),         # a ragged last split
    (512, 16, 128, 64),         # MAX_SPLITS splits of MIN_SPLIT
    (1024, 16, 256, 64),        # beyond: the split grows, in whole chunks
    (1000, 17, 384, 45),
    (4, 25, 128, 1),
])
def test_plan_comes_from_the_capacity_alone(per_seq, page, split, n_splits):
    plan = paged_plan(8, 4, 2, 128, per_seq, page)
    assert plan == PagedPlan(split, n_splits, (8, 4, n_splits, 2, 130), 32)
    assert plan.split % CHUNK == 0 and plan.split >= MIN_SPLIT
    assert plan.n_splits <= MAX_SPLITS
    assert plan.split * plan.n_splits >= per_seq * page
    # the same plan for every G and D but the scratch's last two axes
    other = paged_plan(8, 4, 16, 64, per_seq, page)
    assert (other.split, other.n_splits) == (split, n_splits)
    assert other.partial_shape == (8, 4, n_splits, 16, 66)
