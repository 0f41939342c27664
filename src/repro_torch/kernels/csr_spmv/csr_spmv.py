"""Pull-mode CSR SpMV, PageRank's relaxation: the wrapper of a CUDA kernel.

Replaces the TPU kernel ``csr_spmv_pallas`` of the JAX package
(``src/repro/kernels/csr_spmv/csr_spmv.py:78-104``, ``pl.pallas_call`` at
``:88``). The CUDA source is ``repro_torch/csrc/csr_spmv.cu``: an
edge-balanced grid of a fixed number of blocks a SM, each streaming its
slice of the edge arrays and of the row ends through shared memory with
bulk (TMA) copies and walking their merge, 8 items a thread, with a fixed
segmented-scan tree; rows cut between blocks are summed in parts by a
second small kernel, in block order. The sum order is fixed and nothing
is added with an atomic, so a call repeats its bits.

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
on a CUDA tensor it launches the kernel or raises. `ref.csr_spmv_blocked_ref`
is a plain model of the kernel's partition, for the tests only.
"""
from __future__ import annotations

import ctypes

import torch

from .ref import csr_spmv_ref

# Kernel launches since import (or since a caller last reset it). Only
# the CUDA branch below adds to it, once per launch.
launches = 0

_lib = None
_blocks: dict[int, int] = {}   # card index -> blocks of the kernel's grid


def _kernel():
    global _lib
    if _lib is None:
        from .. import _build
        lib = _build.load("csr_spmv")
        p = ctypes.c_void_p
        lib.csr_spmv_f32.argtypes = [p] * 7 + [ctypes.c_int,
                                               ctypes.c_longlong,
                                               ctypes.c_int, p]
        lib.csr_spmv_f32.restype = ctypes.c_int
        lib.csr_spmv_blocks.argtypes = [ctypes.c_int]
        lib.csr_spmv_blocks.restype = ctypes.c_int
        _lib = lib
    return _lib


def blocks(index: int) -> int:
    """Blocks of the kernel's grid on card ``index``: a fixed number a SM,
    from the SM count alone. The workspace holds one partial sum and one
    row id for each."""
    count = _blocks.get(index)
    if count is None:
        count = _blocks[index] = _kernel().csr_spmv_blocks(index)
    return count


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
    if n == 0:
        return torch.empty(0, dtype=torch.float32, device=x.device)
    lib = _kernel()
    index = x.device.index
    nb = blocks(index)
    # One allocation: y, then the workspace of the blocks' open rows (a
    # partial sum and a row id a block), whose contents need not be set.
    out = torch.empty(n + 2 * nb, dtype=torch.float32, device=x.device)
    y = out[:n]
    work = out.data_ptr() + 4 * n
    args = (t_indptr.data_ptr(), t_indices.data_ptr(), val.data_ptr(),
            x.data_ptr(), y.data_ptr(), work, work + 4 * nb, n,
            t_indices.shape[0], nb, torch._C._cuda_getCurrentRawStream(index))
    if index == torch.cuda.current_device():
        rc = lib.csr_spmv_f32(*args)
    else:
        with torch.cuda.device(index):
            rc = lib.csr_spmv_f32(*args)
    if rc != 0:
        raise RuntimeError(f"csr_spmv launch failed: CUDA error {rc}")
    launches += 1
    return y
