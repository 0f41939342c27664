"""Model configuration — one dataclass covers all 10 assigned families.

Heterogeneous stacks (hybrid) are expressed with ``block_pattern``: a
per-layer tag in {"attn", "mamba", "rwkv", "shared_attn"}. Homogeneous
stacks leave it empty (= all "attn"). All archs execute through the same
scan-over-layers trunk (models/transformer.py).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "ssm", "hybrid", "vlm", "audio", "moe"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                     # 0 -> d_model // num_heads

    # attention
    rope_theta: float = 10_000.0
    rotary_pct: float = 1.0               # chatglm3: 0.5 ("RoPE 2d")
    qkv_bias: bool = False                # qwen2.5
    attn_out_bias: bool = False
    window: int = 0                       # mixtral SWA
    causal: bool = True                   # hubert: False (encoder)
    prefix_tokens: int = 0                # paligemma: image prefix (prefix-LM)

    # ffn
    mlp_type: Literal["swiglu", "gelu"] = "swiglu"
    mlp_bias: bool = False                # starcoder2: True
    norm_type: Literal["rmsnorm", "layernorm"] = "rmsnorm"
    norm_eps: float = 1e-5

    # moe
    num_experts: int = 0
    experts_per_token: int = 0
    num_shared_experts: int = 0           # moonshot/moonlight-style
    router_aux_coef: float = 0.01

    # ssm / rwkv
    block_pattern: tuple[str, ...] = ()
    ssm_state: int = 0                    # mamba2 N
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    conv_width: int = 4
    shared_attn_period: int = 6           # zamba2: shared block cadence

    # embedding / scaling (minicpm mup-style knobs)
    tie_embeddings: bool = False
    emb_scale: float = 1.0
    logit_scale: float = 1.0
    residual_scale: float = 1.0

    # modality frontend stub: "tokens" or "embeddings" (audio/vlm)
    input_mode: Literal["tokens", "embeddings"] = "tokens"

    # locality features (the paper's technique, DESIGN.md §3)
    vocab_reorder: bool = False           # LOrder vocab permutation
    hot_vocab_fraction: float = 0.0       # hot slab size for hot_embed kernel
    moe_locality_sort: bool = True        # sorted (dropless) dispatch

    # training
    remat: bool = True
    remat_policy: str = "save_attn"       # "save_attn" | "full" (§Perf it.6)
    loss_chunk: int = 512                 # chunked softmax-xent (memory)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if not self.block_pattern:
            object.__setattr__(self, "block_pattern",
                               ("attn",) * self.num_layers)
        assert len(self.block_pattern) == self.num_layers
        assert self.num_heads % max(self.num_kv_heads, 1) == 0

    # ------------------------------------------------------------ derived
    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_encoder(self) -> bool:
        return not self.causal

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attn_positions(self) -> tuple[int, ...]:
        return tuple(i for i, b in enumerate(self.block_pattern)
                     if b in ("attn", "shared_attn"))

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the 500k long-context decode cell."""
        full_attn = any(b == "attn" and self.window == 0
                        for b in self.block_pattern)
        # shared_attn layers hold full caches but are O(few) per model —
        # hybrids qualify per the assignment ("run for SSM/hybrid").
        return not full_attn or self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (embedding + trunk + head)."""
        d, f, v, L = self.d_model, self.d_ff, self.vocab_size, self.num_layers
        hd, nh, nkv = self.head_dim, self.num_heads, self.num_kv_heads
        total = v * d                                 # embed
        if not self.tie_embeddings:
            total += d * v                            # head
        attn = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        ffn = (3 if self.mlp_type == "swiglu" else 2) * d * f
        if self.is_moe:
            ffn *= (self.num_experts + self.num_shared_experts)
            ffn += d * self.num_experts               # router
        mamba = (d * (2 * self.d_inner + 2 * self.ssm_state + self.ssm_heads)
                 + self.d_inner * d + 3 * self.ssm_heads)
        rwkv = 4 * d * d + d * self.d_ff + self.d_ff * d  # rkvg + out, ffn
        for b in self.block_pattern:
            total += 2 * d  # norms
            if b == "attn":
                total += attn + ffn
            elif b == "shared_attn":
                total += 0  # shared params counted once below
            elif b == "mamba":
                total += mamba          # mamba blocks carry no FFN
            elif b == "rwkv":
                total += rwkv
        if "shared_attn" in self.block_pattern:
            total += attn + ffn
        return total

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: only routed experts)."""
        if not self.is_moe:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        per_expert = (3 if self.mlp_type == "swiglu" else 2) * d * f
        dense_experts = self.experts_per_token + self.num_shared_experts
        inactive = (self.num_experts + self.num_shared_experts
                    - dense_experts) * per_expert * self.num_layers
        return self.param_count() - inactive
