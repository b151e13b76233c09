"""Model configuration — one dataclass covers all ten assigned families.

Families: dense (llama/mistral/qwen), moe (shared+routed experts), encdec
(seamless audio), vlm (llava backbone + patch stub), hybrid (zamba2 =
Mamba2 backbone + shared attention block), ssm (xLSTM).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | encdec | vlm | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    qk_norm: bool = False
    swa_window: int = 0          # 0 = full attention; >0 = sliding window
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    expert_d_ff: int = 0
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    router_z_coef: float = 1e-3
    # --- encoder-decoder ---
    enc_layers: int = 0
    # --- hybrid / ssm ---
    ssm_state: int = 0           # Mamba2 state dim N
    ssm_head_dim: int = 64       # Mamba2 P
    ssm_expand: int = 2
    attn_every: int = 0          # zamba2: shared attn block every k layers
    xlstm: bool = False
    slstm_every: int = 2         # xLSTM: sLSTM block every k layers (rest mLSTM)
    # --- modality frontend stubs ---
    frontend: str = "none"       # none | vision | audio
    frontend_tokens: int = 0     # patch/frame embeddings per example
    # --- numerics / misc ---
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    # --- shape support ---
    supports_decode: bool = True
    subquadratic: bool = False   # may run long_500k
    remat: bool = True           # activation checkpointing in train_step
    # Unroll layer loops instead of lax.scan.  Used by the roofline
    # calibration: XLA cost_analysis counts while-loop bodies ONCE, so we
    # lower small unrolled variants and extrapolate exact per-layer terms.
    unroll_layers: bool = False
    # Dispatch full-sequence attention through kernels/ops.py (Pallas flash
    # kernel on TPU; pure-jnp oracle elsewhere).
    use_kernels: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def param_count(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        d, hd = self.d_model, self.hd
        n_q = self.n_heads * hd
        n_kv = self.n_kv_heads * hd
        attn = d * n_q + 2 * d * n_kv + n_q * d
        if self.family == "ssm" and self.xlstm:
            per_layer = 4 * d * d + 2 * d  # qkv+out proj + gates (approx)
            layers = self.n_layers * per_layer
        elif self.family == "hybrid":
            di, N, H = self.d_inner, self.ssm_state, self.ssm_heads
            mamba = (d * (2 * di + 2 * N + H)   # in_proj
                     + di * d                    # out_proj
                     + 2 * H)                    # A_log, D
            shared_blocks = attn + 3 * d * self.d_ff
            layers = self.n_layers * mamba + shared_blocks
        elif self.is_moe:
            router = d * self.n_experts
            experts = self.n_experts * 3 * d * self.expert_d_ff
            shared = 3 * d * (self.n_shared_experts * self.expert_d_ff)
            layers = self.n_layers * (attn + router + experts + shared)
        else:
            mlp = 3 * d * self.d_ff
            layers = self.n_layers * (attn + mlp)
            if self.enc_layers:
                # encoder layers + decoder cross-attention
                layers += self.enc_layers * (attn + mlp)
                layers += self.n_layers * attn
        embed = self.vocab * d * (1 if self.tie_embeddings else 2)
        return int(layers + embed)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed top-k + shared)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        hd = self.hd
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
            + self.n_heads * hd * d
        router = d * self.n_experts
        routed = self.top_k * 3 * d * self.expert_d_ff
        shared = 3 * d * (self.n_shared_experts * self.expert_d_ff)
        layers = self.n_layers * (attn + router + routed + shared)
        embed = self.vocab * d * (1 if self.tie_embeddings else 2)
        return int(layers + embed)

    def reduced(self, **overrides) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""
        small = dict(
            n_layers=min(self.n_layers, 2 if not self.attn_every else 4),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 2,
            head_dim=32,
            d_ff=256 if self.d_ff else 0,
            vocab=512,
            n_experts=min(self.n_experts, 8),
            top_k=min(self.top_k, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            expert_d_ff=64 if self.n_experts else 0,
            # effectively dropless at smoke scale so prefill/decode match
            # the full forward exactly (capacity drops are T-dependent)
            capacity_factor=8.0,
            enc_layers=min(self.enc_layers, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32,
            attn_every=2 if self.attn_every else 0,
            frontend_tokens=min(self.frontend_tokens, 16),
            swa_window=min(self.swa_window, 64) if self.swa_window else 0,
            name=self.name + "-smoke",
            dtype="float32",
            remat=False,
        )
        small.update(overrides)
        return replace(self, **small)
