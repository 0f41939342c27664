"""Plain PyTorch versions of the hot/cold embedding gather (any device)."""
from __future__ import annotations

import torch


def embed_ref(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: the lookup the hot/cold split must reproduce."""
    return table[ids.long()]


def hot_gather_ref(ids: torch.Tensor, hot_slab: torch.Tensor) -> torch.Tensor:
    """Rows of the hot slab for ids < H, zeros for the others (the
    kernel's contract)."""
    h = hot_slab.shape[0]
    is_hot = ids < h
    rows = hot_slab[torch.where(is_hot, ids, 0).long()]
    return torch.where(is_hot[:, None], rows, 0.0)
