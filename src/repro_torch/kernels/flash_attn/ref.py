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
