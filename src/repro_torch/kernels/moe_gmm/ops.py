"""Grouped matmuls of the MoE FFN: the kernel on the card, its plain
version on the CPU.

* `ragged_dot` is the counterpart of ``jax.lax.ragged_dot`` as the
  reference's expert FFN calls it (``src/repro/models/moe.py:51-54``):
  groups of consecutive rows given by their sizes, rows past the sizes'
  total zero, bf16 operands giving a bf16 result. The reference's model
  computes it in XLA and never reaches its TPU kernel; the port computes
  it with the kernel. The group offsets are a cumulative sum on the
  device, so nothing is read back to the host. The kernel has no
  backward yet: on the card a call that autograd would differentiate
  raises (ROADMAP A8.5b); on the CPU autograd runs through the plain
  version.
* `grouped_matmul` keeps the reference wrapper's padded contract
  (``src/repro/kernels/moe_gmm/ops.py:12``): rows padded to ``TILE_M``
  per group, one expert id per row tile, a float32 result.
"""
from __future__ import annotations

import torch

from .moe_gmm import TILE_M, gmm


def _offsets(counts: torch.Tensor) -> torch.Tensor:
    offs = torch.zeros(counts.shape[0] + 1, dtype=torch.int32,
                       device=counts.device)
    offs[1:] = counts.cumsum(0)
    return offs


def ragged_dot(x: torch.Tensor, w: torch.Tensor,
               group_sizes: torch.Tensor) -> torch.Tensor:
    """x (M, K) rows sorted by group, w (E, K, N), group_sizes (E,) ->
    (M, N) in x's dtype: group e's rows times ``w[e]``, summed in float32
    and rounded once; rows past ``sum(group_sizes)`` are zero."""
    if (x.device.type == "cuda" and torch.is_grad_enabled()
            and (x.requires_grad or w.requires_grad)):
        # the kernel's output carries no autograd graph: training through
        # it would leave the experts' gradients silently at zero
        raise NotImplementedError(
            "the grouped matmul has no backward on the card yet: ROADMAP "
            "A8.5b")
    offs = _offsets(group_sizes.to(torch.int32))
    return gmm(x.contiguous(), w.contiguous(), offs, out_dtype=x.dtype)


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   tile_expert: torch.Tensor) -> torch.Tensor:
    """x (M, K) expert-sorted rows (M a multiple of TILE_M), w (E, K, N),
    tile_expert (M // TILE_M,) the expert of each row tile, in
    nondecreasing order as `moe_gmm.pad_groups` makes it -> (M, N)
    float32.

    Checks the map on the host (a sync on the card): this is the
    reference's test contract, not the model's path."""
    m, e = x.shape[0], w.shape[0]
    if m % TILE_M or tile_expert.shape != (m // TILE_M,):
        raise ValueError(f"x has {m} rows: tile_expert must be "
                         f"({m // TILE_M},) and M a multiple of {TILE_M}")
    te = tile_expert.long()
    if te.numel() and (int(te.min()) < 0 or int(te.max()) >= e
                       or bool((te[1:] < te[:-1]).any())):
        raise ValueError("tile_expert must be nondecreasing expert ids "
                         f"in [0, {e})")
    counts = torch.bincount(te, minlength=e) * TILE_M
    return gmm(x.contiguous(), w.contiguous(), _offsets(counts.to(
        torch.int32)), out_dtype=torch.float32)
