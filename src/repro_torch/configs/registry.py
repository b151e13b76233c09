"""Architecture registry: the 10 assigned configs (exact published specs)
plus the paper-family baseline.  Select with ``--arch <id>``.

Sources are noted per config ([hf:...] / [arXiv:...] as assigned).
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig
from repro_torch.models.model import ShapeSpec

# ----------------------------------------------------------------------
# shape cells (identical across LM archs, per the assignment)
# ----------------------------------------------------------------------

SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# reduced shapes for CPU smoke tests
SMOKE_SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 64, 2),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 64, 2),
    "decode_32k": ShapeSpec("decode_32k", "decode", 64, 2),
    "long_500k": ShapeSpec("long_500k", "decode", 128, 1),
}


ARCHS: dict[str, ModelConfig] = {}


def _reg(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


# --- dense -------------------------------------------------------------

# [hf:mistralai/Mistral-Large-Instruct-2407; unverified]
MISTRAL_LARGE = _reg(ModelConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8,
    d_ff=28672, vocab=32768, head_dim=128, rope_theta=1e6,
))

# llama+mistral mix, SWA [arXiv:2401.16818; unverified]
H2O_DANUBE = _reg(ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8,
    d_ff=10240, vocab=32000, swa_window=4096, rope_theta=1e4,
    subquadratic=True,   # SWA bounds the KV cache -> long_500k runnable
))

# qk_norm, GQA [hf:Qwen/Qwen3-8B; hf]
QWEN3 = _reg(ModelConfig(
    name="qwen3-0.6b", family="dense",
    n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=3072, vocab=151936, head_dim=128, qk_norm=True,
    rope_theta=1e6, tie_embeddings=True,
))

# small llama3 [hf:meta-llama/Llama-3.2-1B; unverified]
LLAMA32 = _reg(ModelConfig(
    name="llama3.2-3b", family="dense",
    n_layers=28, d_model=3072, n_heads=24, n_kv_heads=8,
    d_ff=8192, vocab=128256, rope_theta=5e5,
))

# --- MoE ---------------------------------------------------------------

# 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
QWEN2_MOE = _reg(ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=151936,
    n_experts=60, top_k=4, n_shared_experts=4, expert_d_ff=1408,
))

# 40 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
GRANITE_MOE = _reg(ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab=49155,
    n_experts=40, top_k=8, n_shared_experts=0, expert_d_ff=512,
))

# --- audio encoder-decoder ----------------------------------------------

# enc-dec, multimodal [arXiv:2308.11596; hf]
SEAMLESS = _reg(ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206, frontend="audio",
))

# --- VLM -----------------------------------------------------------------

# anyres tiling [hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]
LLAVA = _reg(ModelConfig(
    name="llava-next-mistral-7b", family="vlm",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, rope_theta=1e6,
    frontend="vision", frontend_tokens=576,   # one 24x24 patch grid tile
))

# --- hybrid (Mamba2 + shared attention) ----------------------------------

# Mamba2 + shared attn blocks [arXiv:2411.15242; unverified]
ZAMBA2 = _reg(ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000, ssm_state=64, ssm_head_dim=64,
    attn_every=6, subquadratic=True,
))

# --- xLSTM ---------------------------------------------------------------

# sLSTM + mLSTM blocks [arXiv:2405.04517; unverified]
XLSTM = _reg(ModelConfig(
    name="xlstm-125m", family="ssm", xlstm=True,
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304, subquadratic=True,
))

# --- paper-family baseline (Table 1: LLaMA-2 7B class) -------------------

PAPER_BASELINE = _reg(ModelConfig(
    name="paper-llama2-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32,
    d_ff=11008, vocab=32000, rope_theta=1e4,
))


ASSIGNED: tuple[str, ...] = (
    "mistral-large-123b", "h2o-danube-3-4b", "qwen3-0.6b", "llama3.2-3b",
    "qwen2-moe-a2.7b", "granite-moe-3b-a800m", "seamless-m4t-large-v2",
    "llava-next-mistral-7b", "zamba2-7b", "xlstm-125m",
)


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; have {sorted(ARCHS)}")
    return ARCHS[name]


def cells(include_skipped: bool = True) -> list[tuple[str, str, str]]:
    """All (arch, shape, status) dry-run cells.

    status: 'run' or 'skip:<reason>'. long_500k runs only for bounded-state
    archs (SSM/hybrid/SWA); full-attention archs are skipped per assignment.
    """
    out = []
    for arch in ASSIGNED:
        cfg = ARCHS[arch]
        for shape in SHAPES:
            status = "run"
            if shape == "long_500k" and not cfg.subquadratic:
                status = ("skip:full-attention arch; 512k dense KV per "
                          "sequence is itself the paper's kv-transfer "
                          "pathology")
            if shape in ("decode_32k", "long_500k") \
                    and not cfg.supports_decode:
                status = "skip:no decode step"
            if status == "run" or include_skipped:
                out.append((arch, shape, status))
    return out
