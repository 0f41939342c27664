"""Grouped matmuls of the MoE FFN: the kernel on the card, its plain
version on the CPU.

* `ragged_dot` is the counterpart of ``jax.lax.ragged_dot`` as the
  reference's expert FFN calls it (``src/repro/models/moe.py:51-54``):
  groups of consecutive rows given by their sizes, rows past the sizes'
  total zero, bf16 operands giving a bf16 result. The reference's model
  computes it in XLA and never reaches its TPU kernel; the port computes
  it with the kernel. The group offsets are a cumulative sum on the
  device, so nothing is read back to the host. Its backward
  (`_RaggedDot`) is two hand-written kernels: dX is `gmm` of dY times
  each ``w[e]ᵀ`` (the ``wgmma`` kernel reading the stack K-major, no
  transposed copy), dW is `tgmm`; each a float32 sum rounded once to its
  operand's dtype, as the plain version's autograd gives it. The CPU
  goes through the same Function with the plain versions.
* `grouped_matmul` keeps the reference wrapper's padded contract
  (``src/repro/kernels/moe_gmm/ops.py:12``): rows padded to ``TILE_M``
  per group, one expert id per row tile, a float32 result.
"""
from __future__ import annotations

import torch

from .moe_gmm import TILE_M, gmm, tgmm


def _offsets(counts: torch.Tensor) -> torch.Tensor:
    offs = torch.zeros(counts.shape[0] + 1, dtype=torch.int32,
                       device=counts.device)
    offs[1:] = counts.cumsum(0)
    return offs


class _RaggedDot(torch.autograd.Function):
    """`gmm` with its backward: dX = `gmm` (dY, wᵀ), dW = `tgmm` (x, dY);
    rows past the groups' total get a zero dX and add nothing to dW. On
    the card both take bfloat16 only and raise before any launch
    otherwise."""

    @staticmethod
    def forward(ctx, x, w, offs):
        ctx.save_for_backward(x, w, offs)
        return gmm(x, w, offs, out_dtype=x.dtype)

    @staticmethod
    def backward(ctx, dy):
        x, w, offs = ctx.saved_tensors
        dy = dy.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = gmm(dy, w, offs, out_dtype=x.dtype, w_transposed=True)
        if ctx.needs_input_grad[1]:
            dw = tgmm(x, dy, offs, out_dtype=w.dtype)
        return dx, dw, None


def ragged_dot(x: torch.Tensor, w: torch.Tensor,
               group_sizes: torch.Tensor) -> torch.Tensor:
    """x (M, K) rows sorted by group, w (E, K, N), group_sizes (E,) ->
    (M, N) in x's dtype: group e's rows times ``w[e]``, summed in float32
    and rounded once; rows past ``sum(group_sizes)`` are zero.
    Differentiable in x and w."""
    offs = _offsets(group_sizes.to(torch.int32))
    return _RaggedDot.apply(x.contiguous(), w.contiguous(), offs)


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
