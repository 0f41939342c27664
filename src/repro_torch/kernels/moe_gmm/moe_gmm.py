"""Grouped matmul over expert-sorted rows: the wrapper of a CUDA kernel.

Replaces the TPU kernel ``gmm_pallas`` of the JAX package
(``src/repro/kernels/moe_gmm/moe_gmm.py:42-65``, ``pl.pallas_call`` at
``:50``). The TPU kernel takes rows sorted by expert, each group padded
to 128-row tiles on the host (`pad_groups`), and picks each tile's expert
through a scalar-prefetched map. The CUDA source,
``repro_torch/csrc/moe_gmm.cu``, takes the groups as they are: an
``(E+1,)`` int32 tensor of row offsets on the card, which the kernels
read themselves, so nothing is padded or read back to the host: a decode
step syncs with the host no more for it. Rows at or past ``offs[E]`` are
written as zeros. Three kernels sit behind the one entry; `variant`
picks one for bfloat16 operands from ``(M, E, K, N)`` alone, never from
the offsets, and nothing falls back from one to another:

* ``"wgmma"``, bfloat16 at prefill-sized M, where operations bound it:
  a producer warp keeps TMA copies of 64-deep K slices of x and of the
  group's weight in a 4-stage shared-memory ring, and two consumer
  warpgroups multiply them with ``wgmma`` (m64n256k16, float32
  accumulators) into a 128 x 256 output tile inside one group. With
  ``w_transposed`` it takes w as (E, N, K) and multiplies by ``w[e]ᵀ``,
  read K-major straight from the stack (the backward's dX, with no
  transposed copy); that call takes this kernel at any M.
* ``"splitk"``, bfloat16 at decode-sized M (a decode step's 24 rows
  over 64 experts, at most 4 a group), where bytes bound it: each used expert's weight
  streams once, split along K into chunks (`splitk_plan`) so the grid
  fills the card; the chunks of one (group, 128-column tile) form a
  thread-block cluster, and its first block adds the chunks' float32
  partial sums in chunk order through distributed shared memory and
  rounds once. One launch, no workspace. `ref.gmm_splitk_ref` models
  that order in plain PyTorch.
* ``"simt"``, float32 operands: float32 FMAs on the SIMT cores. The
  reference's float32 test cases need it; the model only calls bf16.

`tgmm` is the weight gradient of the bf16 product, ``dW[e] = x_eᵀ dy_e``
over each group's rows, through a fourth kernel, ``"tgmm"``
(``gmm_bf16_tgmm``). No TPU kernel has it: the reference differentiates
``lax.ragged_dot`` in XLA (``src/repro/models/moe.py:51-54``). It is
the ``"wgmma"`` kernel's design turned on its side: TMA copies of 64-row
slices of x and dy (the reduction runs over the group's rows, in
ascending order) feed ``wgmma`` with xᵀ read MN-major from shared
memory, into a 128 x 256 tile of one group's dW with float32 sums,
rounded once: no atomics, no split over rows. Persistent blocks, one an
SM, walk the tiles heaviest group first, so one tile's epilogue overlaps
the next one's loads. `ops.ragged_dot`'s backward calls it for dW and
`gmm` for dX.

Each output element is summed in a fixed order without atomics, so a
repeated call gives the same bits. The two bf16 variants do not give the
same bits as each other (split-K adds the same exact products in another
order), and both are held to the plain version at rtol/atol 1e-4. A
bf16 result is the variant's float32 sum rounded once.

What bounds it on an H100: operations at prefill (moonshot-v1-16b-a3b at
32,768 tokens: 196,608 rows x 2048 x 1408 is 1.13e12 FLOPs against 2.3
GB moved), bytes at decode (24 rows read up to 24 experts' weights, 138
MB).
`tgmm` is bound by operations at a training microbatch (8,192 tokens x
top-6 = 49,152 rows: 2 x 49,152 x 2048 x 1408 = 2.8e11 FLOPs against
0.71 GB, over half of it the bf16 dW written once).

On a CPU tensor the wrapper runs the plain version
(`ref.gmm_grouped_ref`); on a CUDA tensor it launches a kernel or
raises.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from .ref import gmm_grouped_ref, tgmm_grouped_ref

TILE_M = 128
VARIANTS = ("wgmma", "splitk", "simt", "tgmm")

# bf16 calls with at most this many rows a group (M / E) take "splitk".
# The sweep of chip_smoke.py's phase 13 (PERF.md §6) put the crossover
# between 24 rows over 64 experts (split-K faster) and 48 (wgmma faster).
SPLITK_MAX_ROWS_PER_GROUP = 0.5
# split-K cuts K into as many chunks (at most 8, a portable cluster) as
# keep every block resident at once when min(M, E) groups have rows: 6
# blocks of 128 threads an SM (80 registers) on 132 SMs. Past one wave a
# decode step ran slower (PERF.md §6: gmm_ab.py's chunk sweep).
SPLITK_SLOTS = 132 * 6
SPLITK_MAX_CHUNKS = 8

# Kernel launches since import (or since a caller last reset them): of
# `gmm` in all, and of every kernel by variant (`tgmm`'s under "tgmm",
# not in `launches`). Only the CUDA branches below add to them, once per
# launch (one a call).
launches = 0
launches_by_variant = dict.fromkeys(VARIANTS, 0)


def variant(m: int, e: int, k: int, n: int) -> str:
    """The bfloat16 kernel for M rows over E groups of (K, N) weights:
    ``"splitk"`` up to `SPLITK_MAX_ROWS_PER_GROUP` rows a group (a decode
    step), else ``"wgmma"``. A function of the shapes alone (K and N do
    not move the crossover measured so far); it never reads a tensor."""
    return ("splitk" if m <= SPLITK_MAX_ROWS_PER_GROUP * max(e, 1)
            else "wgmma")


@functools.lru_cache(maxsize=256)
def splitk_plan(m: int, e: int, k: int, n: int) -> tuple[int, int]:
    """(chunks, kc) of the split-K variant: K in chunks of ``kc`` rows (a
    multiple of 8), as many as keep the blocks (one per 128 columns of a
    group's chunk) within `SPLITK_SLOTS` when min(M, E) groups have rows,
    with at least 64 K rows a chunk and at most `SPLITK_MAX_CHUNKS`."""
    tiles = max(1, min(m, e)) * -(-n // 128)
    s = min(max(1, SPLITK_SLOTS // tiles), max(1, k // 64),
            SPLITK_MAX_CHUNKS)
    kc = -(-k // s)
    kc = -(-kc // 8) * 8
    return -(-k // kc), kc


_fns: dict = {}


def _kernel(name: str):
    fn = _fns.get(name)
    if fn is None:
        from .. import _build
        lib = _build.load("moe_gmm")
        fn = getattr(lib, "moe_gmm_bf16_" + name if name != "simt"
                     else "moe_gmm_f32")
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = {"wgmma": [p] * 4 + [i] * 6 + [p],
                       "splitk": [p] * 4 + [i] * 7 + [p],
                       "simt": [p] * 4 + [i] * 4 + [p],
                       "tgmm": [p] * 4 + [i] * 5 + [p]}[name]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _check(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor,
           out_dtype: torch.dtype, w_t: bool) -> None:
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
    w_dims = "(E, N, K)" if w_t else "(E, K, N)"
    if x.dim() != 2 or w.dim() != 3 or w.shape[2 if w_t else 1] != x.shape[1]:
        raise ValueError(f"x must be (M, K) and w {w_dims}, got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if offs.shape != (w.shape[0] + 1,):
        raise ValueError(f"group_offsets must be ({w.shape[0] + 1},), got "
                         f"{tuple(offs.shape)}")
    k, n = x.shape[1], w.shape[1 if w_t else 2]
    if k % 8 or n % 8:
        raise ValueError(f"K ({k}) and N ({n}) must be multiples of 8")
    for name, t in (("x", x), ("w", w), ("group_offsets", offs)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if x.numel() >= 2**31 or w.numel() >= 2**31 or \
            x.shape[0] * n >= 2**31:
        raise ValueError("x, w and the output must each hold fewer than "
                         "2^31 elements")
    if w.shape[0] >= 65535:
        raise ValueError(f"at most 65,534 groups, got {w.shape[0]}")


def _pick(dtype: torch.dtype, m: int, e: int, k: int, n: int,
          forced: str | None, w_t: bool = False) -> str:
    if w_t:
        if dtype != torch.bfloat16:
            raise TypeError(f"a transposed expert stack takes bfloat16 "
                            f"operands, not {dtype}")
        if forced not in (None, "wgmma"):
            raise ValueError(f"a transposed expert stack takes 'wgmma', not "
                             f"{forced!r}")
        return "wgmma"
    if dtype != torch.bfloat16:
        if forced not in (None, "simt"):
            raise ValueError(f"{dtype} operands take the 'simt' kernel, not "
                             f"{forced!r}")
        return "simt"
    if forced is None:
        return variant(m, e, k, n)
    if forced not in ("wgmma", "splitk"):
        raise ValueError(f"bfloat16 operands take 'wgmma' or 'splitk', not "
                         f"{forced!r}")
    return forced


def _launch(fn, name: str, x, w, offs, out, m: int, k: int, n: int,
            e: int, w_t: bool) -> int:
    """One kernel call on the current stream of x's card (the current
    device); returns the C entry point's code."""
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    ptrs = (x.data_ptr(), w.data_ptr(), offs.data_ptr(), out.data_ptr())
    if name == "simt":
        return fn(*ptrs, m, k, n, e, stream)
    out_f32 = int(out.dtype == torch.float32)
    if name == "wgmma":
        return fn(*ptrs, out_f32, int(w_t), m, k, n, e, stream)
    return fn(*ptrs, out_f32, m, k, n, e, *splitk_plan(m, e, k, n), stream)


def gmm(x: torch.Tensor, w: torch.Tensor, group_offsets: torch.Tensor, *,
        out_dtype: torch.dtype = torch.float32,
        variant: str | None = None,
        w_transposed: bool = False) -> torch.Tensor:
    """(M, K) x rows sorted by group, (E, K, N) w and (E+1,) int32 row
    offsets -> (M, N) in ``out_dtype``: rows ``[offs[e], offs[e+1])``
    times ``w[e]``, summed in float32 and rounded once; rows at or past
    ``offs[E]`` are zero. With ``w_transposed`` w is (E, N, K) and the
    rows are multiplied by ``w[e]ᵀ``: on the card the ``"wgmma"`` kernel
    reads the stack K-major, at any M, for bfloat16 operands only.

    ``offs[0]`` is 0 and the offsets do not decrease; offsets past M are
    clipped to M. x and w are both float32 (float32 out) or both bfloat16
    (float32 or bfloat16 out). K and N are multiples of 8. Launches on
    the current CUDA stream and does not synchronise. ``variant`` forces
    one bfloat16 kernel (``"wgmma"`` or ``"splitk"``) for the tests and
    the kernel checks; the model never passes it.
    """
    global launches
    w_t = bool(w_transposed)
    if x.device.type == "cpu":
        if variant is not None:
            _pick(x.dtype, x.shape[0], w.shape[0], x.shape[1],
                  w.shape[1 if w_t else 2], variant, w_t)
        return gmm_grouped_ref(x, w.transpose(1, 2) if w_t else w,
                               group_offsets, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"grouped matmul runs on cpu or cuda, not "
                         f"{x.device}")
    _check(x, w, group_offsets, out_dtype, w_t)
    m, k = x.shape
    e, n = w.shape[0], w.shape[1 if w_t else 2]
    name = _pick(x.dtype, m, e, k, n, variant, w_t)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if m == 0 or n == 0:
        return out
    if k == 0 or e == 0:   # no products: every row is zero
        return out.zero_()
    fn = _kernel(name)
    idx = x.device.index
    if idx == torch.cuda.current_device():
        rc = _launch(fn, name, x, w, group_offsets, out, m, k, n, e, w_t)
    else:
        with torch.cuda.device(idx):
            rc = _launch(fn, name, x, w, group_offsets, out, m, k, n, e,
                         w_t)
    if rc < 0:
        raise RuntimeError(f"grouped matmul: cuTensorMapEncodeTiled refused "
                           f"a TMA tensor map (CUresult {-rc})")
    if rc != 0:
        raise RuntimeError(f"grouped matmul launch failed ({name}): CUDA "
                           f"error {rc}")
    launches += 1
    launches_by_variant[name] += 1
    return out


def _check_tgmm(x: torch.Tensor, dy: torch.Tensor, offs: torch.Tensor,
                out_dtype: torch.dtype) -> None:
    for name, t in (("dy", dy), ("group_offsets", offs)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.dtype != torch.bfloat16 or dy.dtype != torch.bfloat16:
        raise TypeError(f"the weight gradient kernel takes bfloat16 x and dy, "
                        f"not {x.dtype} and {dy.dtype}")
    if offs.dtype != torch.int32:
        raise TypeError(f"group_offsets must be torch.int32, got "
                        f"{offs.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"bfloat16 operands give float32 or bfloat16, not "
                        f"{out_dtype}")
    if x.dim() != 2 or dy.dim() != 2 or dy.shape[0] != x.shape[0]:
        raise ValueError(f"x must be (M, K) and dy (M, N), got "
                         f"{tuple(x.shape)} and {tuple(dy.shape)}")
    if offs.dim() != 1 or offs.shape[0] < 1:
        raise ValueError(f"group_offsets must be (E + 1,), got "
                         f"{tuple(offs.shape)}")
    k, n, e = x.shape[1], dy.shape[1], offs.shape[0] - 1
    if k % 8 or n % 8:
        raise ValueError(f"K ({k}) and N ({n}) must be multiples of 8")
    for name, t in (("x", x), ("dy", dy), ("group_offsets", offs)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if x.numel() >= 2**31 or dy.numel() >= 2**31 or e * k * n >= 2**31:
        raise ValueError("x, dy and the output must each hold fewer than "
                         "2^31 elements")
    if e >= 65535:
        raise ValueError(f"at most 65,534 groups, got {e}")


def tgmm(x: torch.Tensor, dy: torch.Tensor, group_offsets: torch.Tensor, *,
         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The weight gradient of `gmm`: (M, K) x and (M, N) dy, rows sorted
    by group, and (E+1,) int32 row offsets -> (E, K, N) in ``out_dtype``,
    ``out[e] = x[offs[e]:offs[e+1]]ᵀ @ dy[offs[e]:offs[e+1]]`` summed in
    float32 and rounded once. A group with no rows gives zeros; rows at
    or past ``offs[E]`` are ignored; offsets past M are clipped to M.

    On the card x and dy are bfloat16 (float32 or bfloat16 out) and K and
    N multiples of 8; float32 operands raise before any launch. Launches
    on the current CUDA stream and does not synchronise; with no rows (M
    0) there is nothing to multiply and the zeros need no launch. On CPU
    tensors it runs the plain version (`ref.tgmm_grouped_ref`), any float
    dtype.
    """
    if x.device.type == "cpu":
        return tgmm_grouped_ref(x, dy, group_offsets, out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"grouped matmul runs on cpu or cuda, not "
                         f"{x.device}")
    _check_tgmm(x, dy, group_offsets, out_dtype)
    m, k = x.shape
    n, e = dy.shape[1], group_offsets.shape[0] - 1
    out = torch.empty((e, k, n), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    if m == 0:   # no rows: a TMA map cannot span them
        return out.zero_()
    fn = _kernel("tgmm")
    with torch.cuda.device(x.device):
        stream = torch._C._cuda_getCurrentRawStream(x.device.index)
        rc = fn(x.data_ptr(), dy.data_ptr(), group_offsets.data_ptr(),
                out.data_ptr(), int(out_dtype == torch.float32), m, k, n, e,
                stream)
    if rc < 0:
        raise RuntimeError(f"grouped matmul (tgmm): cuTensorMapEncodeTiled "
                           f"refused a TMA tensor map (CUresult {-rc})")
    if rc != 0:
        raise RuntimeError(f"grouped matmul launch failed (tgmm): CUDA error "
                           f"{rc}")
    launches_by_variant["tgmm"] += 1
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
