"""qwen2.5-3b [dense]: 36L d2048 16H (GQA kv=2) ff11008 v151936 — GQA with
QKV bias. [hf:Qwen/Qwen2.5-*; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b", family="dense",
    num_layers=36, d_model=2048, num_heads=16, num_kv_heads=2,
    d_ff=11008, vocab_size=151_936,
    rope_theta=1e6,
    qkv_bias=True,
    mlp_type="swiglu", norm_type="rmsnorm",
    tie_embeddings=True,
    vocab_reorder=True, hot_vocab_fraction=0.04,
)
