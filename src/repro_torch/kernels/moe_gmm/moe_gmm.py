"""Grouped matmul over expert-sorted rows: the wrapper of a CUDA kernel.

Replaces the TPU kernel ``gmm_pallas`` of the JAX package
(``src/repro/kernels/moe_gmm/moe_gmm.py:42-65``, ``pl.pallas_call`` at
``:50``). The TPU kernel takes rows sorted by expert, each group padded
to 128-row tiles on the host (`pad_groups`), and picks each tile's expert
through a scalar-prefetched map. The CUDA source,
``repro_torch/csrc/moe_gmm.cu``, takes the groups as they are: an
``(E+1,)`` int32 tensor of row offsets on the card. One thread block
owns one (row tile, 128-column tile) and finds its expert and row range
from the offsets itself, so nothing is padded or read back to the host:
a decode step syncs with the host no more for it. Rows at or past
``offs[E]`` are written as zeros. Two kernels sit behind the one entry:

* bfloat16 operands (the model's path): ``mma.sync`` m16n8k16 with
  float32 accumulators, 128 x 128 output tiles over 32-deep K slices
  double-buffered with ``cp.async``; the result is written once, in
  float32 or rounded to bfloat16.
* float32 operands: float32 FMAs on the SIMT cores, 64 x 64 output
  tiles, K summed in order. The reference's float32 test cases need it;
  the model only calls bf16.

Each output element is summed in a fixed order without atomics, so two
runs give the same bits.

What bounds it on an H100: operations at prefill (moonshot-v1-16b-a3b at
32,768 tokens: 196,608 rows x 2048 x 1408 is 1.13e12 FLOPs against 2.3
GB moved), bytes at decode (24 rows read up to 24 experts' weights, 138
MB). This first version uses ``mma.sync`` without TMA or ``wgmma``.

On a CPU tensor the wrapper runs the plain version
(`ref.gmm_grouped_ref`); on a CUDA tensor it launches the kernel or
raises.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .ref import gmm_grouped_ref

TILE_M = 128

# Kernel launches since import (or since a caller last reset it). Only
# the CUDA branch below adds to it, once per launch.
launches = 0

_fns: dict = {}


def _kernel(dtype: torch.dtype):
    fn = _fns.get(dtype)
    if fn is None:
        from .. import _build
        lib = _build.load("moe_gmm")
        if dtype == torch.bfloat16:
            fn = lib.moe_gmm_bf16
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
                ctypes.c_void_p]
        else:
            fn = lib.moe_gmm_f32
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fns[dtype] = fn
    return fn


def _check(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor,
           out_dtype: torch.dtype) -> None:
    for name, t in (("w", w), ("group_offsets", offs)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"grouped matmul takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if w.dtype != x.dtype:
        raise TypeError(f"w is {w.dtype}, x is {x.dtype}")
    if offs.dtype != torch.int32:
        raise TypeError(f"group_offsets must be torch.int32, got "
                        f"{offs.dtype}")
    allowed = ((torch.float32, torch.bfloat16) if x.dtype == torch.bfloat16
               else (torch.float32,))
    if out_dtype not in allowed:
        raise TypeError(f"{x.dtype} operands give {allowed}, not {out_dtype}")
    if x.dim() != 2 or w.dim() != 3 or w.shape[1] != x.shape[1]:
        raise ValueError(f"x must be (M, K) and w (E, K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if offs.shape != (w.shape[0] + 1,):
        raise ValueError(f"group_offsets must be ({w.shape[0] + 1},), got "
                         f"{tuple(offs.shape)}")
    k, n = w.shape[1], w.shape[2]
    if k % 8 or n % 8:
        raise ValueError(f"K ({k}) and N ({n}) must be multiples of 8")
    for name, t in (("x", x), ("w", w), ("group_offsets", offs)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if x.numel() >= 2**31 or w.numel() >= 2**31 or \
            x.shape[0] * n >= 2**31:
        raise ValueError("x, w and the output must each hold fewer than "
                         "2^31 elements")


def gmm(x: torch.Tensor, w: torch.Tensor, group_offsets: torch.Tensor, *,
        out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(M, K) x rows sorted by group, (E, K, N) w and (E+1,) int32 row
    offsets -> (M, N) in ``out_dtype``: rows ``[offs[e], offs[e+1])``
    times ``w[e]``, summed in float32 and rounded once; rows at or past
    ``offs[E]`` are zero.

    ``offs[0]`` is 0 and the offsets do not decrease; offsets past M are
    clipped to M. x and w are both float32 (float32 out) or both bfloat16
    (float32 or bfloat16 out). K and N are multiples of 8. Launches on
    the current CUDA stream and does not synchronise.
    """
    global launches
    if x.device.type == "cpu":
        return gmm_grouped_ref(x, w, group_offsets, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"grouped matmul runs on cpu or cuda, not "
                         f"{x.device}")
    _check(x, w, group_offsets, out_dtype)
    m, k = x.shape
    e, _, n = w.shape
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    fn = _kernel(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if x.dtype == torch.bfloat16:
            rc = fn(x.data_ptr(), w.data_ptr(), group_offsets.data_ptr(),
                    out.data_ptr(), int(out_dtype == torch.float32), m, k,
                    n, e, stream)
        else:
            rc = fn(x.data_ptr(), w.data_ptr(), group_offsets.data_ptr(),
                    out.data_ptr(), m, k, n, e, stream)
    if rc != 0:
        raise RuntimeError(f"grouped matmul launch failed: CUDA error {rc}")
    launches += 1
    return out


def pad_groups(group_sizes: np.ndarray, tile_m: int = TILE_M):
    """Host helper: per-group padded offsets + per-tile expert map.

    Returns (padded_offsets (E+1,), tile_expert (T,), total_rows)."""
    padded = -(-group_sizes // tile_m) * tile_m
    padded = np.maximum(padded, 0)
    offs = np.zeros(len(group_sizes) + 1, np.int64)
    np.cumsum(padded, out=offs[1:])
    tile_expert = np.repeat(np.arange(len(group_sizes), dtype=np.int32),
                            padded // tile_m)
    if len(tile_expert) == 0:  # degenerate: no tokens at all
        tile_expert = np.zeros(1, np.int32)
        offs[1:] = tile_m
    return offs, tile_expert, int(offs[-1])
