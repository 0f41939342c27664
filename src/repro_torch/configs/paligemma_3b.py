"""paligemma-3b [vlm]: gemma decoder 18L d2048 8H (MQA kv=1) ff16384
v257216 + SigLIP patch-embedding frontend (STUB: input_specs provides
precomputed patch embeddings as a 256-token prefix; prefix-LM attention).
[arXiv:2407.07726; hf]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
    head_dim=256,                       # gemma: 8 heads × 256
    d_ff=16384, vocab_size=257_216,
    prefix_tokens=256,                  # SigLIP patch embeddings (stub)
    mlp_type="swiglu",                  # gemma geglu = gated mlp
    norm_type="rmsnorm",
    emb_scale=2048 ** 0.5,              # gemma embedding scaling
    tie_embeddings=True,
    vocab_reorder=True, hot_vocab_fraction=0.02,
)
