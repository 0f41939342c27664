"""Plain PyTorch versions of the grouped matmul and of its weight
gradient (any device)."""
from __future__ import annotations

import torch


def gmm_ref(x: torch.Tensor, w: torch.Tensor,
            row_expert: torch.Tensor) -> torch.Tensor:
    """``out[i] = x[i] @ w[row_expert[i]]``, float32: the reference's dense
    per-row oracle. It gathers an (M, K, N) weight tensor, so it is for
    the tests' small shapes only."""
    return torch.einsum("mk,mkn->mn", x, w[row_expert.long()]).float()


def gmm_grouped_ref(x: torch.Tensor, w: torch.Tensor,
                    group_offsets: torch.Tensor,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's contract, one product per group: rows
    ``[offs[e], offs[e+1])`` of x times ``w[e]``, with both operands in
    float32 and the result rounded once to ``out_dtype``; rows at or past
    ``offs[E]`` are zero. Offsets past M are clipped to M.

    Reads the offsets on the host (a sync on the card)."""
    m, n = x.shape[0], w.shape[2]
    out = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    offs = group_offsets.clamp(0, m).tolist()
    for e in range(w.shape[0]):
        lo, hi = offs[e], offs[e + 1]
        if hi > lo:
            out[lo:hi] = x[lo:hi].float() @ w[e].float()
    return out.to(out_dtype)


def tgmm_grouped_ref(x: torch.Tensor, dy: torch.Tensor,
                     group_offsets: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The weight gradient of the grouped matmul, one product per group:
    ``out[e] = x[offs[e]:offs[e+1]]ᵀ @ dy[offs[e]:offs[e+1]]``, (E, K, N)
    from (M, K) x and (M, N) dy, with both operands in float32 and the
    result rounded once to ``out_dtype``. A group with no rows gives
    zeros; rows at or past ``offs[E]`` are ignored. Offsets past M are
    clipped to M.

    Reads the offsets on the host (a sync on the card)."""
    m, k, n = x.shape[0], x.shape[1], dy.shape[1]
    e = group_offsets.shape[0] - 1
    out = torch.zeros((e, k, n), dtype=torch.float32, device=x.device)
    offs = group_offsets.clamp(0, m).tolist()
    for g in range(e):
        lo, hi = offs[g], offs[g + 1]
        if hi > lo:
            out[g] = x[lo:hi].float().T @ dy[lo:hi].float()
    return out.to(out_dtype)


def gmm_splitk_ref(x: torch.Tensor, w: torch.Tensor,
                   group_offsets: torch.Tensor, kc: int,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The order of the split-K kernel (``moe_gmm.variant`` "splitk"): K
    cut into chunks of ``kc`` rows, each chunk's product summed in
    float32, the chunks' partial sums added in chunk order and the result
    rounded once to ``out_dtype``; rows at or past ``offs[E]`` are zero.
    Inside a chunk the kernel adds the products one by one, in K order; a
    float32 matmul takes its own order there.

    Reads the offsets on the host (a sync on the card)."""
    k = x.shape[1]
    total = None
    for k0 in range(0, max(k, 1), kc):
        part = gmm_grouped_ref(x[:, k0:k0 + kc], w[:, k0:k0 + kc],
                               group_offsets)
        total = part if total is None else total + part
    return total.to(out_dtype)
