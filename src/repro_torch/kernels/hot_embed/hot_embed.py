"""Hot-slab embedding gather: the wrapper of a CUDA kernel.

Replaces the TPU kernel ``hot_gather_pallas`` of the JAX package
(``src/repro/kernels/hot_embed/hot_embed.py:30-47``, ``pl.pallas_call`` at
``:37``). The CUDA source is ``repro_torch/csrc/hot_embed.cu``: one warp
per id, copying the row with 16-byte loads and stores when ``D % 4 == 0``,
zeros for an id at or past the slab. Results are exact copies.

What bounds it on an H100: bytes. A call reads the ids and the hot rows
it needs and writes ``N·D`` floats. The TPU kernel pinned the whole slab
in VMEM; here the 50 MB L2 plays that part, and it does not hold the
whole slab at minicpm-2b's width: 6,137 rows × 2304 × 4 B = 56.6 MB. A
Zipf stream of ids keeps re-reading the head of the slab, which stays in
L2; rows past what fits come from HBM at its rate, one 9.2 KB row per
miss. Nothing is lost for ids seen once, which cost one HBM read either
way.

On a CPU tensor the wrapper runs the plain version (`ref.hot_gather_ref`);
on a CUDA tensor it launches the kernel or raises.

`hot_gather_grad` is the same gather as an ``autograd.Function``: its
backward adds the output gradient's rows of hot ids into the slab's
gradient (an accumulating ``index_put_``, in float32: on the card it
sorts the ids and adds each row's duplicates in a fixed order, where
``index_add_`` adds in atomics, so a repeated step gives the same bits).
The reference's gradient of this lookup is XLA's scatter-add, the
transpose of its ``take``, outside any Pallas kernel (its Pallas kernel
has no VJP), so the backward is a library call here too, not a
hand-written kernel.
"""
from __future__ import annotations

import ctypes

import torch

from .ref import hot_gather_ref

# Kernel launches since import (or since a caller last reset it). Only
# the CUDA branch below adds to it, once per launch.
launches = 0

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from .. import _build
        fn = _build.load("hot_embed").hot_gather_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(ids: torch.Tensor, hot_slab: torch.Tensor) -> None:
    if ids.device != hot_slab.device:
        raise ValueError(f"ids are on {ids.device}, hot_slab on "
                         f"{hot_slab.device}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be torch.int32, got {ids.dtype}")
    if hot_slab.dtype != torch.float32:
        raise TypeError(f"hot_slab must be torch.float32, got "
                        f"{hot_slab.dtype}")
    if ids.dim() != 1 or not ids.is_contiguous():
        raise ValueError("ids must be a contiguous 1-D tensor")
    if hot_slab.dim() != 2 or not hot_slab.is_contiguous():
        raise ValueError("hot_slab must be a contiguous (H, D) tensor")
    if ids.numel() >= 2**31 or hot_slab.numel() >= 2**31:
        raise ValueError("ids and hot_slab must each hold fewer than 2^31 "
                         "elements")


def hot_gather(ids: torch.Tensor, hot_slab: torch.Tensor) -> torch.Tensor:
    """(N,) int32 ids and an (H, D) float32 slab -> (N, D) float32: row
    ``ids[i]`` of the slab where ``ids[i] < H``, zeros elsewhere.

    Ids are token ids, in ``[0, vocab)``. Launches on the current CUDA
    stream and does not synchronise.
    """
    global launches
    if ids.device.type == "cpu":
        return hot_gather_ref(ids, hot_slab)
    if ids.device.type != "cuda":
        raise ValueError(f"hot_gather runs on cpu or cuda, not {ids.device}")
    _check(ids, hot_slab)
    n = ids.shape[0]
    h, d = hot_slab.shape
    out = torch.empty((n, d), dtype=torch.float32, device=ids.device)
    if n == 0 or d == 0:
        return out
    fn = _kernel()
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        rc = fn(ids.data_ptr(), hot_slab.data_ptr(), out.data_ptr(), n, h, d,
                stream)
    if rc != 0:
        raise RuntimeError(f"hot_gather launch failed: CUDA error {rc}")
    launches += 1
    return out


class _HotGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ids, hot_slab):
        ctx.save_for_backward(ids)
        ctx.slab_shape = hot_slab.shape
        return hot_gather(ids, hot_slab)

    @staticmethod
    def backward(ctx, grad_out):
        (ids,) = ctx.saved_tensors
        grad = None
        if ctx.needs_input_grad[1]:
            grad = grad_out.new_zeros(ctx.slab_shape)
            hot = ids < ctx.slab_shape[0]
            grad.index_put_((ids[hot].long(),), grad_out[hot],
                            accumulate=True)
        return None, grad


def hot_gather_grad(ids: torch.Tensor, hot_slab: torch.Tensor) -> torch.Tensor:
    """`hot_gather` that passes the slab's gradient: the rows of the output
    gradient whose ids are hot, added into the slab's rows."""
    return _HotGather.apply(ids, hot_slab)
