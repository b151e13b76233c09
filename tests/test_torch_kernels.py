"""The port's attention entry points on the CPU (their plain PyTorch
versions) against the JAX package's Pallas kernels run in interpret mode and
its jnp oracles, on the shape sweeps of tests/test_kernels.py.

Inputs are made with numpy from a seed and fed to both sides.  The CUDA
kernels themselves run only on the card (chip_smoke.py holds them against
these same plain versions there)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_kernel  # noqa: E402
from repro.kernels.paged_attention import paged_attention_kernel  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

F32_TOL = 2e-5      # both sides compute in f32; only the summation order differs
BF16_TOL = 3e-2     # tests/test_kernels.py's bf16 tolerance


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The suite runs several test processes side by side; one intra-op
    thread each keeps torch's many small CPU ops from oversubscribing the
    cores (its spinning worker threads slow every process down)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _normal(rng, shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _to_jax(x, dtype):
    return jnp.asarray(x, dtype)


def _to_torch(x, dtype):
    return torch.from_numpy(x).to(dtype)


def _flash_case(seed, b, s, hq, hkv, d, window, bf16, interpret):
    rng = np.random.default_rng(seed)
    q, k, v = (_normal(rng, (b, s, h, d)) for h in (hq, hkv, hkv))
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 \
        else (jnp.float32, torch.float32)
    jq, jk, jv = (_to_jax(x, jdt) for x in (q, k, v))
    got = ops.flash_attention(*(_to_torch(x, tdt) for x in (q, k, v)),
                              causal=True, window=window)
    assert got.dtype == tdt and got.shape == (b, s, hq, d)
    got = got.float().numpy()
    tol = BF16_TOL if bf16 else F32_TOL
    wants = [jref.flash_attention_ref(jq, jk, jv, causal=True,
                                      window=window)]
    if interpret:
        wants.append(flash_attention_kernel(jq, jk, jv, causal=True,
                                            window=window, interpret=True))
    for want in wants:
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


# the sweep of TestFlashAttention: (s, d, hq, hkv, window, bf16); the
# interpret-mode kernel (seconds per shape) joins the oracle on a cover of
# the sweep: every s, d, head layout, window, ragged S and bf16
FLASH = (
    [(s, d, hq, hkv, 0, False,
      (s, d, hq) in ((128, 64, 4), (192, 120, 8), (256, 128, 4)))
     for s in (128, 192, 256) for d in (64, 120, 128)
     for hq, hkv in ((4, 4), (8, 2))]
    + [(256, 64, 4, 4, w, False, w == 100) for w in (32, 100, 200)]
    + [(128, 64, 4, 2, 0, True, True),          # bf16
       (200, 64, 4, 4, 0, False, True)]          # ragged S
)


@pytest.mark.parametrize("s,d,hq,hkv,window,bf16,interpret", FLASH)
def test_flash_attention_matches_jax(s, d, hq, hkv, window, bf16, interpret):
    b = 1 if window or s == 200 else 2
    _flash_case(s * 1000 + d + hq + window, b, s, hq, hkv, d, window, bf16,
                interpret)


# bidirectional attention (causal=False) with Sq != Skv, as the encoder
# (Sq = Skv) and the cross-attention (prefill Sq < Skv, decode Sq = 1) call
# it: (sq, skv, hq, hkv, d, bf16)
FLASH_BIDIRECTIONAL = [
    (200, 200, 4, 4, 64, False),
    (64, 200, 4, 4, 64, False),
    (1, 200, 4, 4, 64, False),
    (130, 333, 8, 2, 128, False),
    (300, 70, 8, 2, 120, False),
    (64, 200, 4, 4, 64, True),
]


@pytest.mark.parametrize("sq,skv,hq,hkv,d,bf16", FLASH_BIDIRECTIONAL)
def test_flash_bidirectional_matches_jax(sq, skv, hq, hkv, d, bf16):
    rng = np.random.default_rng(sq * 1000 + skv + d)
    q = _normal(rng, (2, sq, hq, d))
    k, v = (_normal(rng, (2, skv, hkv, d)) for _ in range(2))
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 \
        else (jnp.float32, torch.float32)
    got = ops.flash_attention(*(_to_torch(x, tdt) for x in (q, k, v)),
                              causal=False)
    assert got.dtype == tdt and got.shape == (2, sq, hq, d)
    jq, jk, jv = (_to_jax(x, jdt) for x in (q, k, v))
    tol = BF16_TOL if bf16 else F32_TOL
    for want in (jref.flash_attention_ref(jq, jk, jv, causal=False),
                 flash_attention_kernel(jq, jk, jv, causal=False,
                                        interpret=True)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=tol, rtol=tol)


def _paged_inputs(seed, b, page, per_seq, hq, hkv, d, n_pages, lengths,
                  permute):
    rng = np.random.default_rng(seed)
    q = _normal(rng, (b, hq, d))
    kp = _normal(rng, (n_pages, page, hkv, d))
    vp = _normal(rng, (n_pages, page, hkv, d))
    ids = rng.permutation(n_pages) if permute else np.arange(n_pages)
    table = ids[:b * per_seq].reshape(b, per_seq).astype(np.int32)
    return q, kp, vp, table, np.asarray(lengths, np.int32)


# the sweep of TestPagedAttention: (page, per_seq, hq, hkv, n_pages,
# lengths, permuted table, interpret-mode kernel too)
PAGED = [
    (page, per_seq, hq, hkv, 64, [page * per_seq, 3, page + 1], True,
     (page, hq) in ((16, 8), (32, 4)))
    for page, per_seq in ((16, 8), (32, 4)) for hq, hkv in ((4, 4), (8, 2))
] + [
    (16, 8, 4, 2, 32, [1, 2], False, False),      # short sequences
    (16, 8, 8, 2, 32, [0, 17, 128], False, True),  # length 0 -> zeros
]


@pytest.mark.parametrize(
    "page,per_seq,hq,hkv,n_pages,lengths,permute,interpret", PAGED)
def test_paged_attention_matches_jax(page, per_seq, hq, hkv, n_pages,
                                     lengths, permute, interpret):
    d = 64
    arrs = _paged_inputs(page + hq + len(lengths), len(lengths), page,
                         per_seq, hq, hkv, d, n_pages, lengths, permute)
    q, kp, vp, table, lens = arrs
    got = ops.paged_attention(torch.from_numpy(q), torch.from_numpy(kp),
                              torch.from_numpy(vp), torch.from_numpy(table),
                              torch.from_numpy(lens)).numpy()
    jargs = [jnp.asarray(x) for x in arrs]
    wants = [jref.paged_attention_ref(*jargs)]
    if interpret:
        wants.append(paged_attention_kernel(*jargs, interpret=True))
    for want in wants:
        np.testing.assert_allclose(got, np.asarray(want), atol=F32_TOL,
                                   rtol=F32_TOL)
    if 0 in lengths:
        assert not got[lengths.index(0)].any()


def test_plain_versions_are_the_ref_oracles():
    from repro_torch.kernels import flash_attention, paged_attention, ref
    assert flash_attention.flash_attention_plain is ref.flash_attention_ref
    assert paged_attention.paged_attention_plain is ref.paged_attention_ref


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "groups",
                                 "contiguous"])
def test_flash_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 8, 4, 64)
    k = torch.zeros(1, 8, 2, 64)
    if bad == "dtype":
        q, k = q.half(), k.half()
    elif bad == "head_dim":
        q, k = torch.zeros(1, 8, 4, 60), torch.zeros(1, 8, 2, 60)
    elif bad == "groups":
        k = torch.zeros(1, 8, 3, 64)
    else:
        q = torch.zeros(1, 4, 8, 64).transpose(1, 2)
    with pytest.raises((ValueError, TypeError)):
        ops.flash_attention(q, k, k.clone())


@pytest.mark.parametrize("bad", ["table_dtype", "lengths_shape", "group"])
def test_paged_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(2, 4, 64)
    kp = torch.zeros(8, 16, 2, 64)
    table = torch.zeros(2, 4, dtype=torch.int32)
    lens = torch.zeros(2, dtype=torch.int32)
    if bad == "table_dtype":
        table = table.long()
    elif bad == "lengths_shape":
        lens = torch.zeros(3, dtype=torch.int32)
    else:
        q = torch.zeros(2, 34, 64)
        kp = torch.zeros(8, 16, 2, 64)
    with pytest.raises((ValueError, TypeError)):
        ops.paged_attention(q, kp, kp.clone(), table, lens)


def test_cuda_wrappers_refuse_cpu_tensors():
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.paged_attention import paged_attention_cuda
    q = torch.zeros(1, 8, 2, 64)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, q, q)
    with pytest.raises(ValueError):
        paged_attention_cuda(torch.zeros(1, 2, 64),
                             torch.zeros(1, 16, 2, 64),
                             torch.zeros(1, 16, 2, 64),
                             torch.zeros(1, 1, dtype=torch.int32),
                             torch.ones(1, dtype=torch.int32))
    assert ops.launch_counts() == {"flash_attention": 0,
                                   "paged_attention": 0, "ssd_scan": 0,
                                   "ssd_scan_bwd": 0}
