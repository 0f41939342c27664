"""SpMV operator bound to one graph's in-CSR, on one device."""
from __future__ import annotations

import torch

from ...device import resolve_device
from .csr_spmv import csr_spmv


class SpMV:
    """``y = SpMV(t_indptr, t_indices, weights)(x)``: the pull SpMV of one
    graph. The in-CSR is uploaded once; a call on CUDA launches the
    hand-written kernel, a call on the CPU runs its plain version."""

    def __init__(self, t_indptr, t_indices, weights=None, *,
                 device: str | torch.device | None = None):
        self.device = resolve_device(device)
        self.t_indptr = self._put(t_indptr, torch.int32)
        self.t_indices = self._put(t_indices, torch.int32)
        self.val = (torch.ones(self.t_indices.shape[0], dtype=torch.float32,
                               device=self.device)
                    if weights is None else self._put(weights, torch.float32))

    def _put(self, arr, dtype) -> torch.Tensor:
        return torch.as_tensor(arr).to(device=self.device,
                                       dtype=dtype).contiguous()

    def __call__(self, x) -> torch.Tensor:
        return csr_spmv(self.t_indptr, self.t_indices, self.val,
                        self._put(x, torch.float32))
