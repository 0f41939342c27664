"""chatglm3-6b [dense]: 28L d4096 32H (GQA kv=2) ff13696 v65024 — RoPE 2d
(partial rotary on half the head dims), GQA. [arXiv:2406.12793; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b", family="dense",
    num_layers=28, d_model=4096, num_heads=32, num_kv_heads=2,
    d_ff=13696, vocab_size=65024,
    rotary_pct=0.5,            # chatglm's 2-D RoPE: rotate half the dims
    rope_theta=10_000.0,
    qkv_bias=True,             # chatglm: add_qkv_bias
    mlp_type="swiglu", norm_type="rmsnorm",
    vocab_reorder=True, hot_vocab_fraction=0.05,
)
