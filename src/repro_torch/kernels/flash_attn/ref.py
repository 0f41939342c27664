"""Plain PyTorch version of blocked causal / sliding-window attention."""
from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  sm_scale: float | None = None,
                  window: int = 0) -> torch.Tensor:
    """q: (BH, S, d); k, v: (BH / group, S, d), each kv row serving
    ``group`` consecutive query rows (grouped-query attention; group 1 is
    multi-head); causal; optional sliding window.

    Materialises the full (BH, S, S) float32 logits, takes the softmax in
    float32 and the PV product in float32; the result has q's dtype.
    """
    bh, s, d = q.shape
    group = bh // k.shape[0]
    if group > 1:
        k = k.repeat_interleave(group, dim=0)
        v = v.repeat_interleave(group, dim=0)
    scale = (d ** -0.5) if sm_scale is None else sm_scale
    logits = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    pos = torch.arange(s, device=q.device)
    qpos, kpos = pos[:, None], pos[None, :]
    mask = qpos >= kpos
    if window > 0:
        mask &= (qpos - kpos) < window
    logits = torch.where(mask[None], logits, -1e30)
    p = torch.exp(logits - logits.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)
