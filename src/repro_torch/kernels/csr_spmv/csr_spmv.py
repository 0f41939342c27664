"""Pull-mode CSR SpMV, PageRank's relaxation: the wrapper of a CUDA kernel.

Replaces the TPU kernel ``csr_spmv_pallas`` of the JAX package
(``src/repro/kernels/csr_spmv/csr_spmv.py:80-104``, ``pl.pallas_call`` at
``:88``). The CUDA source is ``repro_torch/csrc/csr_spmv.cu``: one warp per
destination row, lanes striding over the row's in-edges, a fixed shuffle
tree per row, so the sum order is fixed and no atomics are needed.

What bounds it on an H100: bytes. A call streams about ``8E + 8V`` bytes
(``t_indices`` and ``val`` per edge, ``t_indptr`` and ``y`` per row); the
``x[t_indices]`` gathers are random but ``x`` is one float per vertex, so
it stays in the 50 MB L2 up to ~12M vertices.

Why the TPU layout was dropped: the Pallas kernel packs the edge stream
into 512-row destination tiles padded to the densest tile. After LOrder
the hubs' in-edges crowd into the first tiles, and on a 2^20-vertex
power-law graph (13.5M edges) the packing grew to 218M slots, 16.2x the
edges. Reading the in-CSR rows as they are costs no padding at all.

On a CPU tensor the wrapper runs the plain version (`ref.csr_spmv_ref`);
on a CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from .ref import csr_spmv_ref

# Kernel launches since import (or since a caller last reset it). Only
# the CUDA branch below adds to it, once per launch.
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from .. import _build
        fn = _build.load("csr_spmv").csr_spmv_f32
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(t_indptr, t_indices, val, x) -> int:
    dev = x.device
    for name, t, dtype in (("t_indptr", t_indptr, torch.int32),
                           ("t_indices", t_indices, torch.int32),
                           ("val", val, torch.float32),
                           ("x", x, torch.float32)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, x on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D tensor")
    n = t_indptr.shape[0] - 1
    if n < 0:
        raise ValueError("t_indptr needs at least one entry")
    if val.shape != t_indices.shape:
        raise ValueError(f"val {tuple(val.shape)} does not match "
                         f"t_indices {tuple(t_indices.shape)}")
    if x.shape[0] != n:
        raise ValueError(f"x has {x.shape[0]} entries for {n} rows")
    return n


def csr_spmv(t_indptr: torch.Tensor, t_indices: torch.Tensor,
             val: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[v] = Σ_{e in row v} val[e]·x[t_indices[e]] over the in-CSR.

    int32 ``t_indptr`` (V+1,) and ``t_indices`` (E,), float32 ``val``
    (E,) and ``x`` (V,); returns float32 (V,). Launches on the current
    CUDA stream and does not synchronise.
    """
    global launches
    if x.device.type == "cpu":
        return csr_spmv_ref(t_indptr, t_indices, val, x)
    if x.device.type != "cuda":
        raise ValueError(f"csr_spmv runs on cpu or cuda, not {x.device}")
    n = _check(t_indptr, t_indices, val, x)
    y = torch.empty(n, dtype=torch.float32, device=x.device)
    if n == 0:
        return y
    fn = _kernel()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(t_indptr.data_ptr(), t_indices.data_ptr(), val.data_ptr(),
                x.data_ptr(), y.data_ptr(), n, stream)
    if rc != 0:
        raise RuntimeError(f"csr_spmv launch failed: CUDA error {rc}")
    launches += 1
    return y
