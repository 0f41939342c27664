"""minicpm-2b [dense]: 40L d2304 36H (MHA) ff5760 v122753 — llama-like with
mup-style scaling knobs and the WSD schedule. [arXiv:2404.06395; hf]"""
from ..models.config import ModelConfig

_DIM_BASE = 256  # minicpm dim_model_base

CONFIG = ModelConfig(
    name="minicpm-2b", family="dense",
    num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
    d_ff=5760, vocab_size=122_753,
    mlp_type="swiglu", norm_type="rmsnorm",
    tie_embeddings=True,
    emb_scale=12.0,                          # scale_emb
    logit_scale=_DIM_BASE / 2304,            # 1 / (d / dim_model_base)
    residual_scale=1.4 / 40 ** 0.5,          # scale_depth / sqrt(L)
    vocab_reorder=True, hot_vocab_fraction=0.05,
)

# WSD (warmup-stable-decay) is minicpm's training schedule; selected via
# TrainConfig.schedule="wsd" in train/optim.py.
SCHEDULE = "wsd"
