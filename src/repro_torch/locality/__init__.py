"""The paper's technique as first-class LM-framework features.

A copy of the JAX package's ``src/repro/locality/__init__.py``:

* ``vocab``   — LOrder over token co-occurrence graphs → embedding layout;
* ``moe``     — routing-locality analysis + expert-affinity placement.

``applies_to`` is the programmatic form used by launch scripts and tests.
"""
from __future__ import annotations

from ..models.config import ModelConfig


def applies_to(cfg: ModelConfig) -> dict:
    """Which locality features the paper's technique provides for ``cfg``."""
    return {
        "vocab_reorder": cfg.vocab_reorder and cfg.input_mode == "tokens",
        "hot_embed": cfg.hot_vocab_fraction > 0,
        "moe_locality_sort": cfg.is_moe and cfg.moe_locality_sort,
        "inapplicable": (not cfg.vocab_reorder) and not cfg.is_moe,
    }
