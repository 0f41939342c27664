"""Flash attention (causal, sliding-window, prefix-LM or bidirectional):
the wrapper of a CUDA kernel.

q and the output are (BH, S, d); k and v are (BH / group, S, d), so that
``group`` query rows share one kv row: grouped-query attention, where
query row ``b·H + h`` reads kv row ``b·KV + h // group`` (``group = H /
KV``). ``group`` 1 is multi-head attention.

Replaces the TPU kernel ``flash_attention_pallas`` of the JAX package
(``src/repro/kernels/flash_attn/flash_attn.py:57-77``, ``pl.pallas_call``
at ``:66``). The CUDA source is ``repro_torch/csrc/flash_attn.cu``. Each
thread block owns one (bh, query tile) and walks, in a fixed order, the
key tiles its rows see: up to the diagonal for a causal call, up to the
prefix's last tile too with a prefix (prefix-LM: rows below ``prefix``
see every key below it), every tile for a non-causal call. The masks are
the port's ``models.layers._attn_mask``; the TPU kernel is causal only.
The online-softmax recurrence is the TPU kernel's ``_kernel`` (running
max and normaliser in float32). Three kernels sit behind the one entry
point, chosen by `variant` from the dtype and the head dim; none falls
back to another:

* ``"wgmma"``, bfloat16 at head dims 64, 80, 128 and 256 (the served
  models): a Hopper design. A producer warpgroup keeps TMA loads of K and
  V in a ring of shared-memory stages; two consumer warpgroups of 64
  query rows each run ``wgmma`` for QK^T (operands from shared memory)
  and for PV (P from registers, V from shared memory), 128-query by
  128-key tiles. Head dim 80 (hubert-xlarge) runs in 128-column tiles
  that TMA fills with zeros past column 80: QK^T stops at column 80, PV
  does 1.6 times d 80's work. Head dim 256 (paligemma-3b) runs in 64-key
  tiles, K and V in rings of two stages each beside Q's 64 KB, since a
  128-key stage would leave no room for a second one.
* ``"mma_sync"``, bfloat16 at head dims 16 and 32: warp-level
  ``mma.sync`` m16n8k16 products, 64-query by 64-key tiles.
* ``"simt"``, float32 at head dims 16, 32, 64 and 128: float32 FMAs on
  the SIMT cores, 32-query by 32-key tiles, four threads per query row.

Both bfloat16 kernels sum QK^T as exact products in float32. For PV the
float32 probabilities are split into a bf16 high and low part and both
are multiplied, so PV keeps about 16 bits of the probabilities'
mantissa, close to the float32 PV of the TPU kernel and of
`ref.attention_ref` (without ``round_p``); that costs 1.5 times a bf16
PV's operations.

Unlike the TPU kernel, which takes only ``S % 256 == 0``, the CUDA kernels
take any S: the tail tile is masked. The head dims of `HEAD_DIMS`
(bfloat16) and `F32_HEAD_DIMS` (float32) are compiled; any other raises.

What bounds it on an H100: operations, at long S. A causal call does
about ``2·BH·S²·d`` multiply-adds (a non-causal one twice that), against
``(2·BH + 2·BH / group)·S·d`` elements moved; at S = 32,768 and d = 64
that is far above the card's ridge point, and grouping kv heads changes
only the bytes. With the split PV the bf16 kernels do 1.5 times that.

On a CPU tensor the wrapper runs the plain version (`ref.attention_ref`),
which on bf16 rounds p to bf16 before PV as the reference's model path
(``layers._sdpa_chunked``) does; on a CUDA tensor it launches a kernel or
raises.

The backward (`flash_attention_bwd`, reached through `flash_attention_grad`,
an ``autograd.Function``) has no TPU counterpart: the reference trains by
XLA's autodiff of its plain chunked attention, and its Pallas kernel has no
VJP. The port's forward runs the kernel, whose output carries no autograd
graph, so the gradient is two more CUDA kernels in the same source, a dq
kernel (which also writes rowsum(dO·O) for the other) and a dk/dv kernel,
chosen by `bwd_variant`; neither variant falls back to the other:

* ``"wgmma"``, bfloat16 at head dims 64, 80, 128 and 256
  (``flash_bwd_dq_wgmma``, ``flash_bwd_dkdv_wgmma``): the forward's Hopper
  design (TMA ring, producer warpgroup, two consumer warpgroups, ``wgmma``
  with the transposed operands as MN-major descriptors). The dk/dv kernel's
  work item is a (query head, 128-key tile); under grouped-query attention
  each writes its float32 dK and dV and the last of a group's blocks to
  finish sums them in head order (a counter in device memory), so no float
  is summed with atomics and a result repeats bit for bit. At d 256
  (paligemma-3b) a warpgroup's 64 rows or keys would hold 64 x 256 float32
  sums, 128 registers a thread per matrix, and beside them S and dP (or
  their transposes) went past the 240 registers a consumer has; so a dq
  block takes 64 query rows and a dk/dv block 64 keys, both warpgroups see
  all of them and each owns half of the head dim (dQ, or dK and dV, for
  128 columns). One warpgroup computes S (with P), the other dP, each over
  the whole head dim; they swap the two float32 tiles through shared
  memory, both form dS alike, and each multiplies its half. Each product
  is issued once per 64 x 64 block; the sums keep the other head dims'
  order, so `ref.attention_bwd_tiled_ref` models d 256 too.
* ``"mma_sync"``, bfloat16 at head dims 16 and 32 (``flash_bwd_dq_bf16``,
  ``flash_bwd_dkdv_bf16``): warp-level ``mma.sync``; one dk/dv block owns a
  kv row's key tile and walks its group's heads in series.

Both take the forward's row log-sum-exp, which the forward kernels write
when asked (`flash_attention_lse`), and every mask of the forward, in
bfloat16 at the head dims of `BWD_HEAD_DIMS`; anything else (float32
above all) raises before any launch (ROADMAP A8.5c). P and dS are rounded
to bf16 as operands. What bounds them is operations: the five products of
the math are ``2·d·pairs`` FLOPs each (pairs the (row, key) pairs the mask
lets through), about 0.35 ms at (BH 32, S 4096, d 128) causal on the
card's 989 TFLOP/s, and the same at paligemma-3b's microbatch (BH 16, S
4096, d 256, with the prefix's 32,640 extra pairs a head: 3.45e11 FLOPs);
the two-kernel design recomputes S and dP once more (seven products) to
need no atomics. The plain version is `ref.attention_bwd_ref`;
`ref.attention_bwd_tiled_ref` models the ``wgmma`` kernels' tiles and sum
order.
"""
from __future__ import annotations

import ctypes

import torch

from .ref import attention_bwd_ref, attention_lse_ref, attention_ref

HEAD_DIMS = (16, 32, 64, 80, 128, 256)      # bfloat16
BWD_HEAD_DIMS = (16, 32, 64, 80, 128, 256)  # bfloat16, the backward
WGMMA_HEAD_DIMS = (64, 80, 128, 256)
BWD_WGMMA_HEAD_DIMS = (64, 80, 128, 256)
F32_HEAD_DIMS = (16, 32, 64, 128)
VARIANTS = ("wgmma", "mma_sync", "simt")
MASKS = ("causal", "prefix", "non_causal")

# Kernel launches since import (or since a caller last reset them), in all,
# by variant, by mask (causal without a prefix, causal with one,
# non-causal), those with grouped kv (group > 1) and those with a sliding
# window (causal, window > 0; counted under their `MASKS` kind as well).
# Only the CUDA branch below adds to them, once per launch.
launches = 0
launches_by_variant = dict.fromkeys(VARIANTS, 0)
launches_by_mask = dict.fromkeys(MASKS, 0)
launches_grouped = 0
launches_windowed = 0
# Backward launches, by kernel (two per `flash_attention_bwd` call on the
# card), by variant (`bwd_variant`: both kernels of a call count), by kv
# group (query rows a kv row; 1 is multi-head) and those with a sliding
# window (window > 0), both kernels of a call counted in each.
launches_bwd = {"dq": 0, "dkdv": 0}
launches_bwd_by_variant = {"wgmma": 0, "mma_sync": 0}
launches_bwd_by_group: dict[int, int] = {}
launches_bwd_windowed = 0


def variant(dtype: torch.dtype, head_dim: int) -> str:
    """The CUDA kernel that takes ``dtype`` at ``head_dim``: ``"wgmma"``
    for bfloat16 at 64, 80, 128 and 256, ``"mma_sync"`` for bfloat16 at 16
    and 32, ``"simt"`` for float32 at any of `F32_HEAD_DIMS`."""
    if dtype == torch.float32:
        if head_dim not in F32_HEAD_DIMS:
            raise ValueError(f"head dim {head_dim} is not one of "
                             f"{F32_HEAD_DIMS} (float32)")
        return "simt"
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"head dim {head_dim} is not one of {HEAD_DIMS}")
    if dtype == torch.bfloat16:
        return "wgmma" if head_dim in WGMMA_HEAD_DIMS else "mma_sync"
    raise TypeError(f"flash_attention takes float32 or bfloat16, got {dtype}")


def mask_kind(causal: bool, prefix: int) -> str:
    """The `MASKS` entry a call counts under."""
    if not causal:
        return "non_causal"
    return "prefix" if prefix > 0 else "causal"

_fns: dict = {}


# (bh, group, s, d, scale, window, causal, prefix, stream) after the pointers
_TAIL = [ctypes.c_int] * 4 + [ctypes.c_float] + [ctypes.c_int] * 3 + [
    ctypes.c_void_p]


def _bind(name: str, pointers: int):
    fn = _fns.get(name)
    if fn is None:
        from .. import _build
        fn = getattr(_build.load("flash_attn"), name)
        fn.argtypes = [ctypes.c_void_p] * pointers + _TAIL
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _kernel(dtype: torch.dtype):
    return _bind("flash_attn_bf16" if dtype == torch.bfloat16
                 else "flash_attn_f32", 5)


def _raise_on(rc: int, what: str) -> None:
    if rc < 0:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled refused a TMA "
                           f"tensor map (CUresult {-rc})")
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")


def kv_group(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """The query rows a kv row serves: ``BH / k.shape[0]``. Raises unless
    q is (BH, S, d) and k and v are (BH / group, S, d) for a whole
    group."""
    if q.dim() != 3:
        raise ValueError(f"q, k and v must be 3-D, got q of shape "
                         f"{tuple(q.shape)}")
    if k.shape != v.shape:
        raise ValueError(f"k has shape {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    bh, s, d = q.shape
    kvh = k.shape[0] if k.dim() == 3 else -1
    if k.shape[1:] != (s, d) or kvh < 0 or (bh % kvh if kvh else bh):
        raise ValueError(f"k and v must be (BH / group, S, d) for q of "
                         f"shape {tuple(q.shape)}, got {tuple(k.shape)}")
    return bh // kvh if kvh else 1


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """Raises on what no kernel takes; returns the kv group."""
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}, q is {q.dtype}")
    group = kv_group(q, k, v)
    # raises for a dtype or a head dim that no kernel takes
    variant(q.dtype, q.shape[2])
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if q.shape[0] * -(-q.shape[1] // 32) >= 2**31:
        raise ValueError("BH * ceil(S / 32) thread blocks must stay below "
                         "2^31")
    return group


def _mask_args(window: int, causal: bool, prefix: int) -> tuple[int, int]:
    """Checked (window, prefix): both 0 for a non-causal call."""
    if window < 0 or prefix < 0:
        raise ValueError(f"window ({window}) and prefix ({prefix}) must not "
                         f"be negative")
    return (window, prefix) if causal else (0, 0)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    sm_scale: float | None = None, window: int = 0,
                    causal: bool = True, prefix: int = 0) -> torch.Tensor:
    """Attention on (BH, S, d) q and (BH / group, S, d) k and v of one
    dtype (float32 or bfloat16), ``group = BH / k.shape[0]`` query rows to
    a kv row. Causal: row i sees keys j <= i, and every key below
    ``prefix`` when i < ``prefix``; keys with ``i - j >= window`` are
    masked when ``window > 0``. ``causal=False``: every row sees every key
    (``window`` and ``prefix`` are ignored). Returns (BH, S, d) in q's
    dtype. Launches on the current CUDA stream and does not synchronise.
    The kernel keeps PV in float32; the plain version on a CPU tensor
    rounds p to bf16 first when q is bf16, as the reference's model does.
    """
    window, prefix = _mask_args(window, causal, prefix)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, sm_scale=sm_scale, window=window,
                             causal=causal, prefix=prefix,
                             round_p=q.dtype == torch.bfloat16)
    return _forward(q, k, v, sm_scale, window, causal, prefix, False)[0]


def _forward(q, k, v, sm_scale, window, causal, prefix, with_lse: bool):
    """The forward kernel on CUDA tensors: (out, lse or None)."""
    global launches, launches_grouped, launches_windowed
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    group = _check(q, k, v)
    if with_lse and q.dtype != torch.bfloat16:
        raise NotImplementedError("the float32 kernel writes no log-sum-exp "
                                  "(no float32 backward): ROADMAP A8.5c")
    bh, s, d = q.shape
    scale = (d ** -0.5) if sm_scale is None else float(sm_scale)
    out = torch.empty_like(q)
    lse = (torch.empty((bh, s), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if bh == 0 or s == 0:
        return out, lse
    fn = _kernel(q.dtype)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                None if lse is None else lse.data_ptr(), bh, group, s, d,
                scale, int(window), int(bool(causal)), int(prefix), stream)
    _raise_on(rc, "flash_attention")
    launches += 1
    launches_by_variant[variant(q.dtype, d)] += 1
    launches_by_mask[mask_kind(causal, prefix)] += 1
    if group > 1:
        launches_grouped += 1
    if window > 0:
        launches_windowed += 1
    return out, lse


def check_backward(q: torch.Tensor) -> None:
    """Raises `NotImplementedError` unless the backward kernels take q's
    dtype and head dim (bfloat16 at `BWD_HEAD_DIMS`)."""
    bwd_variant(q.dtype, q.shape[-1])


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, sm_scale: float | None = None, window: int = 0,
                        causal: bool = True, prefix: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """`flash_attention`, and each row's log-sum-exp of its scaled,
    masked logits ((BH, S) float32, natural log), which the backward
    needs. On the card the forward kernel writes both; on a CPU tensor
    the plain versions compute them."""
    window, prefix = _mask_args(window, causal, prefix)
    if q.device.type == "cpu":
        kw = dict(sm_scale=sm_scale, window=window, causal=causal,
                  prefix=prefix)
        return (attention_ref(q, k, v, round_p=q.dtype == torch.bfloat16,
                              **kw), attention_lse_ref(q, k, **kw))
    return _forward(q, k, v, sm_scale, window, causal, prefix, True)


def bwd_variant(dtype: torch.dtype, head_dim: int) -> str:
    """The backward kernels that take ``dtype`` at ``head_dim``:
    ``"wgmma"`` for bfloat16 at 64, 80, 128 and 256, ``"mma_sync"`` for
    bfloat16 at 16 and 32; anything else (float32 above all) raises
    `NotImplementedError` (`check_backward`)."""
    if dtype != torch.bfloat16 or head_dim not in BWD_HEAD_DIMS:
        raise NotImplementedError(
            f"the flash backward takes bfloat16 at head dims "
            f"{BWD_HEAD_DIMS}, not {dtype} at {head_dim}: ROADMAP A8.5c")
    return "wgmma" if head_dim in BWD_WGMMA_HEAD_DIMS else "mma_sync"


# the wgmma kernels' `rows` are padded to whole 128-row tiles (a dq block
# at d 64-128; both kernels pad so at d 256 too)
_BWD_TILE = 128


def _dkdv_tile(d: int) -> tuple[int, int]:
    """(keys, partial width) of a ``wgmma`` dk/dv block at head dim ``d``:
    64 keys at d 256, whose two warpgroups each own 128 of the 256
    columns, else 128; the float32 partials are as wide as the kernel's
    tile (64 at d 64, 128 at d 80 and 128, 256 at d 256)."""
    return (64, 256) if d == 256 else (128, 64 if d == 64 else 128)


def backward_launches(q, k, v, o, lse, do, *, sm_scale: float | None = None,
                      window: int = 0, causal: bool = True, prefix: int = 0):
    """The backward on CUDA tensors, checked and set up but not launched:
    ``((dq, dk, dv), launch_dq, launch_dkdv)``, the outputs (empty until
    both have run, in that order, on the current stream) and one callable
    a kernel, each launching it once and counting it. Raises before any
    work on what the kernels do not take. BH and S must not be 0.
    `flash_attention_bwd` calls both; `chip_smoke.py` times each alone."""
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on cpu or cuda, not "
                         f"{q.device}")
    window, prefix = _mask_args(window, causal, prefix)
    kind = bwd_variant(q.dtype, q.shape[-1])
    group = _check(q, k, v)
    bh, s, d = q.shape
    for name, t, shape, dtype in (("o", o, q.shape, q.dtype),
                                  ("do", do, q.shape, q.dtype),
                                  ("lse", lse, (bh, s), torch.float32)):
        if (t.shape != shape or t.dtype != dtype or t.device != q.device
                or not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError(f"{name} must be a contiguous, 16-byte aligned "
                             f"{tuple(shape)} {dtype} tensor on {q.device}")
    if bh == 0 or s == 0:
        raise ValueError("backward_launches needs BH and S above 0")
    scale = (d ** -0.5) if sm_scale is None else float(sm_scale)
    dq, dk, dv = (torch.empty_like(q), torch.empty_like(k),
                  torch.empty_like(v))
    tail = (bh, group, s, d, scale, int(window), int(bool(causal)),
            int(prefix))
    f32 = dict(dtype=torch.float32, device=q.device)
    if kind == "wgmma":
        # lse·log2 e and rowsum(dO·O), padded to whole tiles
        rows = torch.empty((2, bh, -(-s // _BWD_TILE) * _BWD_TILE), **f32)
        # each head's float32 dK and dV a key tile, summed over the group
        # in head order by the group's last block (its counter)
        keys, width = _dkdv_tile(d)
        tiles = -(-s // keys)
        partial = torch.empty(bh * tiles * keys * 2 * width, **f32)
        counters = (torch.zeros((bh // group) * tiles, dtype=torch.int32,
                                device=q.device) if group > 1 else None)
        dq_args = ("flash_bwd_dq_wgmma", 8, q, k, v, o, do, lse, rows, dq)
        dkdv_args = ("flash_bwd_dkdv_wgmma", 9, q, k, v, do, rows, partial,
                     counters, dk, dv)
    else:
        delta = torch.empty((bh, s), **f32)
        dq_args = ("flash_bwd_dq", 8, q, k, v, o, do, lse, delta, dq)
        dkdv_args = ("flash_bwd_dkdv", 8, q, k, v, do, lse, delta, dk, dv)

    def launcher(which: str, name: str, pointers: int, *tensors):
        fn = _bind(name, pointers)

        def launch() -> None:
            global launches_bwd_windowed
            # the pointers from the tensors the closure holds, so that every
            # buffer the kernel writes lives as long as the launch can run
            ptrs = [None if t is None else t.data_ptr() for t in tensors]
            with torch.cuda.device(q.device):
                stream = torch.cuda.current_stream(q.device).cuda_stream
                rc = fn(*ptrs, *tail, stream)
            _raise_on(rc, name)
            launches_bwd[which] += 1
            launches_bwd_by_variant[kind] += 1
            launches_bwd_by_group[group] = (
                launches_bwd_by_group.get(group, 0) + 1)
            if window > 0:
                launches_bwd_windowed += 1
        return launch
    return ((dq, dk, dv), launcher("dq", *dq_args),
            launcher("dkdv", *dkdv_args))


def flash_attention_bwd(q, k, v, o, lse, do, *,
                        sm_scale: float | None = None, window: int = 0,
                        causal: bool = True, prefix: int = 0
                        ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of `flash_attention` at q, k, v, given its output ``o``,
    its ``lse`` (`flash_attention_lse`) and the output's gradient ``do``
    ((BH, S, d) like q); dk and dv are summed over the query heads that
    share a kv row. On the card: the dq kernel of `bwd_variant` (which
    also writes rowsum(dO·O) for the second kernel), then its dk/dv
    kernel, on the current stream, no synchronisation; a dtype or head dim
    they do not take raises before any launch. On a CPU tensor:
    `ref.attention_bwd_ref`.
    """
    window, prefix = _mask_args(window, causal, prefix)
    if q.device.type == "cpu":
        return attention_bwd_ref(q, k, v, o, lse, do, sm_scale=sm_scale,
                                 window=window, causal=causal, prefix=prefix)
    if q.device.type == "cuda" and (q.shape[0] == 0 or q.shape[1] == 0):
        check_backward(q)
        _check(q, k, v)
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    out, launch_dq, launch_dkdv = backward_launches(
        q, k, v, o, lse, do, sm_scale=sm_scale, window=window, causal=causal,
        prefix=prefix)
    launch_dq()
    launch_dkdv()
    return out


class _FlashAttention(torch.autograd.Function):
    """The forward kernel with its row log-sum-exp saved, and the backward
    kernels as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale, window, causal, prefix):
        o, lse = flash_attention_lse(q, k, v, sm_scale=sm_scale,
                                     window=window, causal=causal,
                                     prefix=prefix)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask = dict(sm_scale=sm_scale, window=window, causal=causal,
                        prefix=prefix)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do.contiguous(),
                                         **ctx.mask)
        return dq, dk, dv, None, None, None, None


def flash_attention_grad(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, sm_scale: float | None = None, window: int = 0,
                         causal: bool = True,
                         prefix: int = 0) -> torch.Tensor:
    """`flash_attention` that autograd differentiates through the backward
    kernels. Raises before any launch where they do not take the call
    (`check_backward`)."""
    check_backward(q)
    return _FlashAttention.apply(q, k, v, sm_scale, window, causal, prefix)
