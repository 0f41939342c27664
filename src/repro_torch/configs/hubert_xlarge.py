"""hubert-xlarge [audio]: 48L d1280 16H (MHA) ff5120 v504 — encoder-only
transformer backbone (w2v2 arch). Modality frontend (conv feature
extractor) is a STUB: input_specs provides precomputed frame embeddings.
Masked-unit prediction over 504 cluster targets. [arXiv:2106.07447]

Arch-applicability (DESIGN.md §4): continuous frame inputs and a 504-way
head have no skewed sparse lookup — the paper's reordering technique is
inapplicable; the arch is built without it.
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", family="audio",
    num_layers=48, d_model=1280, num_heads=16, num_kv_heads=16,
    d_ff=5120, vocab_size=504,
    causal=False,                      # encoder-only
    input_mode="embeddings",
    mlp_type="gelu", mlp_bias=True, norm_type="layernorm",
    rotary_pct=0.0,                    # hubert uses conv rel-pos (stubbed)
    vocab_reorder=False, hot_vocab_fraction=0.0,
)
