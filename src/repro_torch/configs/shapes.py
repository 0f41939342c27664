"""Assigned input shapes (seq_len × global_batch) and per-cell input specs.

The PyTorch port of ``src/repro/configs/shapes.py``. `ShapeSpec`,
`SHAPES` and `cell_supported` are plain Python, copied as they are;
`input_specs` builds its stand-ins as tensors on the ``meta`` device
(a shape and a dtype, no storage) where the reference builds
``jax.ShapeDtypeStruct``s.

``decode_32k``/``long_500k`` lower ``serve_step`` (one token + a KV cache of
seq_len); ``train_4k`` lowers ``train_step``; ``prefill_32k`` lowers the
prefill forward. Skip rules (recorded in EXPERIMENTS.md):
* long_500k only for sub-quadratic archs (rwkv6, zamba2, mixtral-SWA);
* encoder-only archs (hubert) have no decode step.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(supported, reason-if-not) for one (arch × shape) cell."""
    if cfg.is_encoder and shape.kind == "decode":
        return False, "encoder-only arch has no decode step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "pure full-attention arch; 500k decode needs sub-quadratic attention"
    return True, ""


def _meta(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Meta-tensor stand-ins for every model input (no allocation). A
    decode cell's cache comes from ``init_cache(..., device="meta")``:
    the reference's leaves for every trunk (RWKV's and Mamba2's states,
    and a hybrid's shared attention cache, too)."""
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32
    if shape.kind == "decode":
        from ..models.transformer import init_cache
        cache = init_cache(cfg, b, s, device="meta")
        return {"tokens": _meta((b, 1), i32), "cache": cache}

    specs: dict = {}
    if cfg.input_mode == "embeddings":
        specs["embeds"] = _meta((b, s, cfg.d_model), torch.bfloat16)
        if shape.kind == "train":
            specs["targets"] = _meta((b, s), i32)
    else:
        if cfg.prefix_tokens > 0:
            specs["prefix"] = _meta((b, cfg.prefix_tokens, cfg.d_model),
                                    torch.bfloat16)
            specs["tokens"] = _meta((b, s - cfg.prefix_tokens), i32)
        else:
            specs["tokens"] = _meta((b, s), i32)
    return specs
