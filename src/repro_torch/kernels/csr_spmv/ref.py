"""Plain PyTorch version of the csr_spmv kernel (runs on any device)."""
from __future__ import annotations

import torch


def csr_spmv_ref(t_indptr: torch.Tensor, t_indices: torch.Tensor,
                 val: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[v] = Σ_{u→v} w(u,v)·x[u] over the in-CSR arrays.

    The rows own edges ``[0, t_indptr[-1])``; ``t_indices``/``val`` may
    run longer (a row prefix of a larger CSR), and the tail is not read.
    """
    n = t_indptr.shape[0] - 1
    counts = (t_indptr[1:] - t_indptr[:-1]).long()
    t_dst = torch.repeat_interleave(
        torch.arange(n, device=t_indptr.device), counts)
    m = t_dst.shape[0]
    return torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(
        0, t_dst, x[t_indices[:m].long()] * val[:m])
