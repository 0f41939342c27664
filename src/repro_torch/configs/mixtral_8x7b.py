"""mixtral-8x7b [moe]: 32L d4096 32H (GQA kv=8) ff14336 v32000 — 8 experts
top-2, sliding-window attention. [arXiv:2401.04088; hf]

Strongest fit for the paper's technique: token→expert routing is the
skewed bipartite access graph; locality-sorted dispatch is LOrder's
hot-first grouping (DESIGN.md §3.2)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    window=4096,                       # SWA — makes long_500k decodable
    rope_theta=1e6,
    num_experts=8, experts_per_token=2,
    mlp_type="swiglu", norm_type="rmsnorm",
    vocab_reorder=True, hot_vocab_fraction=0.1,
    moe_locality_sort=True,
)
