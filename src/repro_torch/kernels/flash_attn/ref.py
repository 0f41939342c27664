"""Plain PyTorch version of flash attention: causal, sliding-window,
prefix-LM and bidirectional masks, queries in chunks."""
from __future__ import annotations

import torch

# queries a chunk: the reference's Q_CHUNK (src/repro/models/layers.py:23),
# so that no more than (BH, Q_CHUNK, S) logits exist at once
Q_CHUNK = 1024


def visible(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool = True,
            prefix: int = 0, window: int = 0) -> torch.Tensor:
    """(Q, K) boolean mask of the keys each query sees, the port's
    ``layers._attn_mask``: causal ``q >= k``, or both below ``prefix``
    (prefix-LM), then cut to ``q - k < window`` when ``window > 0``;
    non-causal, every key (``prefix`` and ``window`` are ignored)."""
    q, k = q_pos[:, None], k_pos[None, :]
    if not causal:
        return torch.ones(q.shape[0], k.shape[1], dtype=torch.bool,
                          device=q.device)
    mask = q >= k
    if prefix > 0:
        mask = mask | ((q < prefix) & (k < prefix))
    if window > 0:
        mask = mask & ((q - k) < window)
    return mask


def visible_pairs(s: int, *, causal: bool = True, prefix: int = 0,
                  window: int = 0) -> int:
    """The (row, key) pairs `visible` lets through over ``s`` rows and
    keys, one head, in closed form: what a kernel that skips the masked
    tiles must multiply. Rows at or past the prefix see ``min(i + 1, w)``
    keys (``w`` the window, or S without one); a row ``i`` below it sees
    the prefix's keys past ``i - w``. A causal window W over S >= W rows
    and no prefix: W(W + 1)/2 + (S - W)·W."""
    if not causal:
        return s * s
    p = min(prefix, s)
    w = min(window, s) if window > 0 else s

    def tri(n: int) -> int:
        return n * (n + 1) // 2 if n > 0 else 0

    def upto(n: int) -> int:    # sum of min(i + 1, w) over rows i < n
        return tri(min(n, w)) + max(0, n - w) * w
    return p * p - tri(p - w) + upto(s) - upto(p)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  sm_scale: float | None = None, window: int = 0,
                  causal: bool = True, prefix: int = 0,
                  round_p: bool = False) -> torch.Tensor:
    """q: (BH, S, d); k, v: (BH / group, S, d), each kv row serving
    ``group`` consecutive query rows (grouped-query attention; group 1 is
    multi-head); the mask of `visible`.

    Queries go `Q_CHUNK` at a time; each chunk's rows take their float32
    logits over every key, so a row's arithmetic does not depend on the
    chunk it sits in. The softmax is float32. PV
    runs in float32 (the flash kernel's arithmetic) or, with ``round_p``,
    on p rounded to bf16 against bf16 v, as the reference's chunked path
    (``layers._sdpa_chunked``) computes it. The result has q's dtype.
    """
    bh, s, d = q.shape
    group = bh // k.shape[0]
    if group > 1:
        k = k.repeat_interleave(group, dim=0)
        v = v.repeat_interleave(group, dim=0)
    scale = (d ** -0.5) if sm_scale is None else sm_scale
    k32 = k.float()
    vp = v.to(torch.bfloat16) if round_p else v.float()
    pos = torch.arange(s, device=q.device)
    chunk = max(1, min(Q_CHUNK, s))
    out = torch.empty_like(q)
    for i in range(0, s, chunk):
        rows = slice(i, i + chunk)
        logits = torch.einsum("bqd,bkd->bqk", q[:, rows].float(), k32) * scale
        mask = visible(pos[rows], pos, causal=causal, prefix=prefix,
                       window=window)
        p = torch.softmax(torch.where(mask[None], logits, -1e30), dim=-1)
        out[:, rows] = torch.einsum("bqk,bkd->bqd", p.to(vp.dtype),
                                    vp).to(q.dtype)
        del logits, p
    return out


def _expand(t: torch.Tensor, group: int) -> torch.Tensor:
    return t.repeat_interleave(group, dim=0) if group > 1 else t


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      sm_scale: float | None = None, window: int = 0,
                      causal: bool = True, prefix: int = 0) -> torch.Tensor:
    """(BH, S) float32: each row's log-sum-exp (natural log) of its scaled
    float32 logits over the keys `visible` lets it see, queries in chunks
    of `Q_CHUNK`."""
    bh, s, d = q.shape
    k32 = _expand(k, bh // k.shape[0]).float()
    scale = (d ** -0.5) if sm_scale is None else sm_scale
    pos = torch.arange(s, device=q.device)
    out = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    for i in range(0, s, max(1, min(Q_CHUNK, s))):
        rows = slice(i, i + Q_CHUNK)
        logits = torch.einsum("bqd,bkd->bqk", q[:, rows].float(), k32) * scale
        mask = visible(pos[rows], pos, causal=causal, prefix=prefix,
                       window=window)
        out[:, rows] = torch.logsumexp(
            torch.where(mask[None], logits, -1e30), dim=-1)
    return out


def attention_bwd_ref(q, k, v, o, lse, do, *, sm_scale: float | None = None,
                      window: int = 0, causal: bool = True, prefix: int = 0
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of attention at q (BH, S, d) and k, v (BH / group, S,
    d), from its output ``o``, its row log-sum-exp ``lse`` (BH, S) and the
    output's gradient ``do``: the flash backward's recompute, in float32,
    queries in chunks of `Q_CHUNK`. With s = scale·q·k, p = exp(s − lse)
    on the keys `visible` lets a row see (0 elsewhere), Δ = rowsum(dO·O)
    and dS = p·(dO·vᵀ − Δ): dV = pᵀdO, dK = scale·dSᵀq, dQ = scale·dS·k;
    dk and dv are summed over the ``group`` query rows of each kv row.
    Results in q's dtype."""
    bh, s, d = q.shape
    group = bh // k.shape[0]
    scale = (d ** -0.5) if sm_scale is None else sm_scale
    k32, v32 = _expand(k, group).float(), _expand(v, group).float()
    pos = torch.arange(s, device=q.device)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k32.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v32.shape, dtype=torch.float32, device=q.device)
    for i in range(0, s, max(1, min(Q_CHUNK, s))):
        rows = slice(i, i + Q_CHUNK)
        qc, doc = q[:, rows].float(), do[:, rows].float()
        logits = torch.einsum("bqd,bkd->bqk", qc, k32) * scale
        mask = visible(pos[rows], pos, causal=causal, prefix=prefix,
                       window=window)
        p = torch.where(mask[None], torch.exp(logits - lse[:, rows, None]),
                        0.0)
        delta = (doc * o[:, rows].float()).sum(-1, keepdim=True)
        ds = p * (torch.einsum("bqd,bkd->bqk", doc, v32) - delta)
        dv += torch.einsum("bqk,bqd->bkd", p, doc)
        dk += torch.einsum("bqk,bqd->bkd", ds, qc) * scale
        dq[:, rows] = torch.einsum("bqk,bkd->bqd", ds, k32) * scale
        del logits, p, ds
    if group > 1:
        dk = dk.reshape(-1, group, s, d).sum(1)
        dv = dv.reshape(-1, group, s, d).sum(1)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# the wgmma backward kernels' steps: 64 query rows (dk/dv) and 64 keys (dq)
BWD_STEP = 64


def attention_bwd_tiled_ref(q, k, v, o, lse, do, *,
                            sm_scale: float | None = None, window: int = 0,
                            causal: bool = True, prefix: int = 0
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """`attention_bwd_ref` in the ``wgmma`` backward kernels' arithmetic and
    sum order (``csrc/flash_attn.cu``, ``flash_bwd_dq_wgmma`` and
    ``flash_bwd_dkdv_wgmma``), for S small enough to hold (BH, S, S).

    p = exp2(s·scale·log2 e − lse·log2 e) on the pairs `visible` lets
    through, dS = p·(dO·vᵀ − Δ), both rounded to bf16 as operands, every
    sum float32: dQ accumulates dS·k over key steps of `BWD_STEP` in
    ascending order; each query head's float32 dK and dV partials
    accumulate dSᵀ·q and pᵀ·dO over query steps of `BWD_STEP` in ascending
    order (a step the mask keeps out adds exact zeros, as the kernel's
    skipped step adds nothing); then the ``group`` heads that share a kv
    row are summed in head order, ((h0 + h1) + h2) + ..., as the last block
    of a group does. At d 256 the kernels' blocks are 64 rows or keys with
    the head dim split between two warpgroups, which leaves every column's
    steps and sums as they are. Results in q's dtype."""
    bh, s, d = q.shape
    group = bh // k.shape[0]
    scale = (d ** -0.5) if sm_scale is None else sm_scale
    log2e = 1.4426950408889634
    q32, do32 = q.float(), do.float()
    k32, v32 = _expand(k, group).float(), _expand(v, group).float()
    pos = torch.arange(s, device=q.device)
    seen = visible(pos, pos, causal=causal, prefix=prefix, window=window)
    logits = torch.einsum("bqd,bkd->bqk", q32, k32)
    p = torch.where(seen[None], torch.exp2(
        logits * (scale * log2e) - (lse.float() * log2e)[..., None]), 0.0)
    delta = (do32 * o.float()).sum(-1, keepdim=True)
    ds = p * (torch.einsum("bqd,bkd->bqk", do32, v32) - delta)
    p16, ds16 = (t.to(torch.bfloat16).float() for t in (p, ds))
    dq = torch.zeros_like(q32)
    dk = torch.zeros_like(k32)
    dv = torch.zeros_like(v32)
    for i in range(0, s, BWD_STEP):
        cut = slice(i, i + BWD_STEP)
        dq += torch.einsum("bqk,bkd->bqd", ds16[:, :, cut], k32[:, cut])
        dk += torch.einsum("bqk,bqd->bkd", ds16[:, cut], q32[:, cut])
        dv += torch.einsum("bqk,bqd->bkd", p16[:, cut], do32[:, cut])
    dk, dv = (t.reshape(-1, group, s, d) for t in (dk, dv))
    dk_sum, dv_sum = dk[:, 0], dv[:, 0]
    for h in range(1, group):
        dk_sum, dv_sum = dk_sum + dk[:, h], dv_sum + dv[:, h]
    return ((dq * scale).to(q.dtype), (dk_sum * scale).to(k.dtype),
            dv_sum.to(v.dtype))
