"""moonshot-v1-16b-a3b [moe]: 48L d2048 16H (MHA kv=16) ff1408 v163840 —
64 experts top-6 + shared experts (moonlight/kimi-style fine-grained MoE).
[hf:moonshotai/Moonlight-16B-A3B; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=163_840,
    rope_theta=5e4,
    num_experts=64, experts_per_token=6,
    num_shared_experts=2,
    mlp_type="swiglu", norm_type="rmsnorm",
    vocab_reorder=True, hot_vocab_fraction=0.03,
    moe_locality_sort=True,
)
