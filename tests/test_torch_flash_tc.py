"""The arithmetic of the bf16 tensor-core flash kernel (csrc/flash_attention.cu,
tc::flash_tc_kernel) emulated in plain PyTorch on the CPU, held against the
plain version at the kernel's tolerance.

The kernel multiplies bf16 q and k into f32 scores, runs the online softmax
in base 2 over blocks of BK keys (read from the kernel's source), rounds P
to bf16 for the P V product and accumulates in f32; the JAX package's
reference (repro.kernels.ref.flash_attention_ref) keeps P in f32.  These
tests show, before any card time is spent, that this design stays within
chip_smoke.py's bf16 tolerance of 2e-2 at both serving models' heads at
S = 1024 and at D = 120 with a window."""

import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels.ref import _repeat_kv  # noqa: E402

BF16_TOL = 2e-2     # chip_smoke.py's TOL["bfloat16"]: |d| <= tol + tol |want|

KERNEL_SRC = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
              / "kernels" / "csrc" / "flash_attention.cu")


def _tc_block_keys() -> int:
    """Keys per KV block of the tensor-core kernel: tc::BK in its source."""
    src = KERNEL_SRC.read_text()
    tc = src[src.index("namespace tc {"):]
    return int(re.search(r"constexpr int BK = (\d+);", tc).group(1))


BK = _tc_block_keys()


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tc_emulation(q, k, v, *, causal=True, window=0, p_dtype=torch.bfloat16):
    """q: (B, Sq, Hq, D), k/v: (B, Skv, Hkv, D) -> (B, Sq, Hq, D) in q's
    dtype, computed as the tensor-core kernel does (P rounded to
    ``p_dtype`` for P V)."""
    b, sq, hq, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    qf = q.float().transpose(1, 2)                             # (B,H,Sq,D)
    kf = _repeat_kv(k, hq // hkv).float().transpose(1, 2)
    vf = _repeat_kv(v, hq // hkv).float().transpose(1, 2)
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    rows = torch.arange(sq)[:, None]
    m = torch.full((b, hq, sq), -math.inf)
    l = torch.zeros((b, hq, sq))
    acc = torch.zeros((b, hq, sq, d))
    for k0 in range(0, skv, BK):
        cols = torch.arange(k0, min(k0 + BK, skv))[None, :]
        s = qf @ kf[:, :, k0:k0 + BK].transpose(-1, -2) * scale_log2
        ok = torch.ones((sq, cols.shape[1]), dtype=torch.bool)
        if causal:
            ok &= cols <= rows
        if window > 0:
            ok &= cols > rows - window
        s = s.masked_fill(~ok, -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        base = torch.where(m_new == -math.inf, 0.0, m_new)
        alpha = torch.exp2(m - base)
        p = torch.exp2(s - base[..., None])
        l = l * alpha + p.sum(-1)                 # the f32 probabilities
        pv = p.to(p_dtype).float() @ vf[:, :, k0:k0 + BK]
        acc = acc * alpha[..., None] + pv         # P rounded to bf16
        m = m_new
    out = torch.where(l[..., None] > 0, acc / l[..., None], 0.0)
    return out.transpose(1, 2).to(q.dtype)


def _bf16(rng, shape):
    return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)
                            ).to(torch.bfloat16)


def jax_reference(q, k, v, *, window):
    """The JAX package's reference on the same values, in q's dtype, back
    as an f32 tensor."""
    dt = jnp.bfloat16 if q.dtype == torch.bfloat16 else jnp.float32
    jq, jk, jv = (jnp.asarray(x.float().numpy()).astype(dt)
                  for x in (q, k, v))
    out = jref.flash_attention_ref(jq, jk, jv, causal=True, window=window)
    return torch.from_numpy(np.array(out.astype(jnp.float32)))


def test_block_is_the_kernels():
    assert BK == 128


@pytest.mark.parametrize("s,hq,hkv,d,window", [
    (1024, 16, 8, 128, 0),      # qwen3-0.6b's heads, the largest bucket
    (1024, 32, 32, 112, 0),     # zamba2-7b's shared attention block
    (333, 4, 2, 120, 100),      # D = 120 (zero-padded in shared memory)
])
def test_tensor_core_numerics_meet_the_bf16_tolerance(s, hq, hkv, d, window):
    rng = np.random.default_rng(s + d)
    q, k, v = (_bf16(rng, (1, s, h, d)) for h in (hq, hkv, hkv))
    got = tc_emulation(q, k, v, window=window).float()
    want = jax_reference(q, k, v, window=window)
    assert torch.isfinite(got).all()
    # the share of the tolerance each element uses: within it, and the
    # rounding of P is really there but uses well under half of it
    used = (got - want).abs() / (BF16_TOL + BF16_TOL * want.abs())
    assert 0 < float(used.max()) < 0.5, float(used.max())


def test_emulation_without_rounding_is_the_plain_version():
    """The same blocked online softmax in base 2 with P kept in f32 is the
    reference to f32 rounding: the emulation's one departure from it is P
    in bf16."""
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 300, h, 64),
                                                    dtype=np.float32))
               for h in (4, 2, 2))
    got = tc_emulation(q, k, v, window=140, p_dtype=torch.float32)
    want = jax_reference(q, k, v, window=140)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5,
                               rtol=2e-5)
