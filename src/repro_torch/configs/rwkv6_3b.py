"""rwkv6-3b [ssm]: 32L d2560 (attention-free) ff8960 v65536 — Finch,
data-dependent decay. [arXiv:2404.05892; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b", family="ssm",
    num_layers=32, d_model=2560,
    num_heads=40, num_kv_heads=40, head_dim=64,   # wkv heads of size 64
    d_ff=8960, vocab_size=65536,
    block_pattern=("rwkv",) * 32,
    norm_type="layernorm",
    vocab_reorder=True, hot_vocab_fraction=0.05,
)
