"""zamba2-1.2b [hybrid]: 38L d2048 32H (MHA kv=32) ff8192, ssm_state=64 —
Mamba2 backbone + shared attention block applied periodically.
[arXiv:2411.15242; hf]"""
from ..models.config import ModelConfig

_L = 38
_PERIOD = 6
_PATTERN = tuple(
    "shared_attn" if (i % _PERIOD == _PERIOD - 1) else "mamba"
    for i in range(_L)
)

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=_L, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32000,
    block_pattern=_PATTERN,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=64,
    shared_attn_period=_PERIOD,
    mlp_type="gelu",            # zamba2 shared block uses gelu MLP
    norm_type="rmsnorm",
    vocab_reorder=True, hot_vocab_fraction=0.05,
)
