"""Hot/cold embedding lookup: the hot-slab kernel plus a plain cold overlay.

Rows ``[0, hot_size)`` of the table (after the vocab LOrder, the frequent
tokens) come from `hot_embed.hot_gather`; the tail is a plain torch gather
laid over the zeros the kernel leaves for cold ids, as the reference's
wrapper does in XLA (``src/repro/kernels/hot_embed/ops.py:27-32``). The
reference pads the ids to 512-id blocks for its TPU grid
(``ops.py:20-21``); the CUDA kernel takes any count, so the port drops the
padding. Both parts pass the table's gradient: the hot rows through
`hot_embed.hot_gather_grad`, the cold overlay through torch's own gather.
"""
from __future__ import annotations

import torch

from .hot_embed import hot_gather_grad


def hot_cold_lookup(ids: torch.Tensor, table: torch.Tensor,
                    hot_size: int) -> torch.Tensor:
    """``table[ids]`` for ids of any shape, with rows below ``hot_size``
    served by the kernel on the card (its plain version on the CPU)."""
    flat = ids.reshape(-1).to(torch.int32).contiguous()
    hot_rows = hot_gather_grad(flat, table[:hot_size])
    is_cold = flat >= hot_size
    # an all-hot table (hot_size == vocab) clips the placeholder index, as
    # the reference's take(mode="clip") does
    cold_idx = torch.where(is_cold, flat, hot_size).clamp(
        max=table.shape[0] - 1)
    cold_rows = torch.where(is_cold[:, None], table[cold_idx.long()], 0.0)
    return (hot_rows + cold_rows).reshape(*ids.shape, table.shape[1])
