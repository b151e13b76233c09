"""Model configuration — one dataclass covers all ten assigned families.

Families: dense (llama/mistral/qwen), moe (shared+routed experts), encdec
(seamless audio), vlm (llava backbone + patch stub), hybrid (zamba2 =
Mamba2 backbone + shared attention block), ssm (xLSTM).  The port adds
nemotron_h: a stack built from ``layer_pattern``, one pre-norm mixer with a
residual per layer (Mamba2 with its conv and B/C groups, a sigmoid-routed
relu² MoE that may hold a share of its experts, or attention).

The fields after ``use_kernels`` are the port's own (the JAX package has no
such model); their defaults leave every other family as it was.
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
    # --- port-only: layer-pattern stacks (nemotron_h) ---
    # one character a layer: M Mamba2, E MoE, * attention; "" otherwise.
    # Attention without RoPE where rope_theta is 0.
    layer_pattern: str = ""
    mamba_heads: int = 0         # Mamba2 heads; 0 -> d_inner // ssm_head_dim
    ssm_groups: int = 1          # B/C groups; head i reads group i // (H / G)
    conv_kernel: int = 0         # causal conv taps over x, B, C; 0: none
    # Mamba2's published tail: y * silu(z), then RMSNorm over each B/C
    # group's channels, and D times the raw x; False: zamba2's (RMSNorm
    # over di before the gate, D times the dt-scaled x)
    gated_group_norm: bool = False
    expert_act: str = "swiglu"   # swiglu | relu2 (routed and shared experts)
    router: str = "softmax"      # softmax | sigmoid (top-k of score + bias)
    routed_scale: float = 1.0    # sigmoid gates' scale after normalising
    shared_d_ff: int = 0         # 0 -> n_shared_experts * expert_d_ff
    experts_held: int = 0        # routed experts 0 .. held - 1; 0: all

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        if self.mamba_heads:
            return self.mamba_heads * self.ssm_head_dim
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def n_held(self) -> int:
        """Routed experts whose weights this model holds: ids 0 ..
        ``n_held - 1``."""
        return self.experts_held or self.n_experts

    @property
    def shared_ff(self) -> int:
        return self.shared_d_ff or self.n_shared_experts * self.expert_d_ff

    @property
    def moe_layers(self) -> int:
        """Layers with routed experts."""
        if self.layer_pattern:
            return self.layer_pattern.count("E")
        return self.n_layers if self.is_moe else 0

    def _pattern_params(self, active: bool) -> int:
        """A layer-pattern stack's layers: Mamba2 (projections, conv, A_log
        and D), MoE (router, the held experts -- with ``active`` the top-k's
        share of them -- and the shared expert) and attention."""
        d, hd = self.d_model, self.hd
        di, n, h = self.d_inner, self.ssm_state, self.ssm_heads
        gn = self.ssm_groups * n
        mamba = (d * (2 * di + 2 * gn + h) + di * d + 2 * h
                 + self.conv_kernel * (di + 2 * gn))
        mats = 2 if self.expert_act == "relu2" else 3
        routed = (self.top_k * self.n_held / self.n_experts if active
                  else self.n_held)
        moe = (d * self.n_experts + routed * mats * d * self.expert_d_ff
               + mats * d * self.shared_ff)
        attn = 2 * d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
        per = {"M": mamba, "E": moe, "*": attn}
        return int(sum(per[c] for c in self.layer_pattern))

    def param_count(self) -> int:
        """Approximate parameter count (for roofline MODEL_FLOPS)."""
        d, hd = self.d_model, self.hd
        n_q = self.n_heads * hd
        n_kv = self.n_kv_heads * hd
        attn = d * n_q + 2 * d * n_kv + n_q * d
        if self.layer_pattern:
            layers = self._pattern_params(active=False)
        elif self.family == "ssm" and self.xlstm:
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
        """Active params per token (MoE: only routed top-k + shared; of
        held experts, the top-k's share that lands on them)."""
        if self.layer_pattern:
            embed = self.vocab * self.d_model * (
                1 if self.tie_embeddings else 2)
            return self._pattern_params(active=True) + embed
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
            # a pattern stack keeps every kind of mixer, a quarter of the
            # Mamba2 heads per B/C group and half of its experts held
            layer_pattern="MEM*E" if self.layer_pattern else "",
            mamba_heads=8 if self.mamba_heads else 0,
            ssm_groups=min(self.ssm_groups, 4),
            shared_d_ff=128 if self.shared_d_ff else 0,
            experts_held=min(self.experts_held, 4),
        )
        if self.layer_pattern:
            small["n_layers"] = len(small["layer_pattern"])
        small.update(overrides)
        return replace(self, **small)
