"""Architecture registry: ``--arch <id>`` resolution + smoke reductions."""
from __future__ import annotations

import dataclasses
import importlib

from ..models.config import ModelConfig

_MODULES = {
    "chatglm3-6b": "chatglm3_6b",
    "minicpm-2b": "minicpm_2b",
    "starcoder2-7b": "starcoder2_7b",
    "qwen2.5-3b": "qwen2_5_3b",
    "rwkv6-3b": "rwkv6_3b",
    "zamba2-1.2b": "zamba2_1_2b",
    "paligemma-3b": "paligemma_3b",
    "hubert-xlarge": "hubert_xlarge",
    "mixtral-8x7b": "mixtral_8x7b",
    "moonshot-v1-16b-a3b": "moonshot_v1_16b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_MODULES)}")
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return mod.CONFIG


def smoke_config(arch: str, *, layers: int = 4) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: small width/depth,
    few experts, tiny vocab — same block structure and code paths."""
    cfg = get_config(arch)
    pattern = cfg.block_pattern[:layers]
    if "shared_attn" in cfg.block_pattern and "shared_attn" not in pattern:
        pattern = pattern[:-1] + ("shared_attn",)
    kv = 4 if cfg.num_kv_heads >= cfg.num_heads else 1
    return dataclasses.replace(
        cfg,
        num_layers=layers,
        block_pattern=pattern,
        d_model=64, num_heads=4, num_kv_heads=kv, head_dim=16,
        d_ff=128,
        vocab_size=512,
        num_experts=min(cfg.num_experts, 4) if cfg.is_moe else 0,
        experts_per_token=min(cfg.experts_per_token, 2) if cfg.is_moe else 0,
        num_shared_experts=min(cfg.num_shared_experts, 1),
        prefix_tokens=4 if cfg.prefix_tokens else 0,
        window=8 if cfg.window else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=8,
        hot_vocab_fraction=0.125 if cfg.hot_vocab_fraction else 0.0,
        loss_chunk=16,
        remat=False,
    )
