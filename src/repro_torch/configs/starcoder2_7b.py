"""starcoder2-7b [dense]: 32L d4608 36H (GQA kv=4) ff18432 v49152 — GQA,
RoPE, layernorm + biased GELU MLP. [arXiv:2402.19173; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b", family="dense",
    num_layers=32, d_model=4608, num_heads=36, num_kv_heads=4,
    d_ff=18432, vocab_size=49152,
    rope_theta=1e5,
    qkv_bias=True, attn_out_bias=True,
    mlp_type="gelu", mlp_bias=True, norm_type="layernorm",
    vocab_reorder=True, hot_vocab_fraction=0.08,   # code token skew is strong
)
