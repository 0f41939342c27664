"""RWKV6 ("Finch") block: attention-free, data-dependent decay.

The PyTorch port of ``src/repro/models/rwkv6.py``, function for function,
on parameter dicts as in `layers`: float32 masters, matmul inputs cast to
bf16 by `layers._dense`.

Time-mix: per-head wkv state S ∈ (H, K, V) with per-channel, per-token
decay w_t = exp(-exp(ŵ_t)) where ŵ_t comes from a low-rank MLP of the
input (the Finch contribution); the token-shift interpolation is
data-dependent too (`_ddlerp`). Channel-mix is the squared-ReLU FFN.

Prefill takes the chunked form (`_wkv_chunked`) when the sequence is a
multiple of ``WKV_CHUNK`` and the token scan (`_wkv_scan`) otherwise, as
the reference dispatches; decode is O(1) a token. The reference's scans
are XLA ``lax.scan``s, not Pallas kernels: here the chunked form does its
state-independent work batched over groups of chunks and keeps a Python
loop only for the state recurrence, one launch a chunk on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .layers import COMPUTE_DTYPE, _dense, _normal, carry_states, silu

LORA_DIM = 32
DDLERP_DIM = 32
WKV_CHUNK = 16
# float32 bytes of one group's (chunks, B, H, L, L, dh) decay tensor in
# `_wkv_chunked`: bounds the forward's working set at long sequences (at
# rwkv6-3b's 40 heads of 64 and batch 1, about 100 chunks a group). It
# bounds nothing under autograd, which saves every group's decay tensor
# and its product with k for the backward: all the chunks' worth of both
WKV_GROUP_BYTES = 1 << 28


def heads_of(cfg: ModelConfig) -> tuple[int, int]:
    """(wkv heads, head size), as the reference derives them."""
    d = cfg.d_model
    h = cfg.num_heads if cfg.num_heads > 0 else d // 64
    return h, d // h


def init_rwkv(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d = cfg.d_model
    h, dh = heads_of(cfg)
    dev = gen.device
    sc = d ** -0.5

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return {
        # ddlerp token-shift: base mus + low-rank data-dependent deltas
        "mu_base": zeros(5, d),
        "ddl_w1": _normal(gen, (d, 5 * DDLERP_DIM), sc),
        "ddl_w2": _normal(gen, (5, DDLERP_DIM, d), 0.01),
        # projections r, k, v, g + output
        "wr": _normal(gen, (d, d), sc),
        "wk": _normal(gen, (d, d), sc),
        "wv": _normal(gen, (d, d), sc),
        "wg": _normal(gen, (d, d), sc),
        "wo": _normal(gen, (d, d), sc),
        # decay: base + low-rank data-dependent (the v6 feature)
        "w_base": torch.full((d,), -6.0, dtype=torch.float32, device=dev),
        "dec_w1": _normal(gen, (d, LORA_DIM), sc),
        "dec_w2": _normal(gen, (LORA_DIM, d), 0.01),
        "u_bonus": zeros(h, dh),
        "ln_scale": torch.ones((d,), dtype=torch.float32, device=dev),
        # channel mix
        "cm_mu": zeros(2, d),
        "cm_k": _normal(gen, (d, cfg.d_ff), sc),
        "cm_v": _normal(gen, (cfg.d_ff, d), cfg.d_ff ** -0.5),
        "cm_r": _normal(gen, (d, d), sc),
    }


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as XLA computes it on a bf16 ``x``: ``1 / (1 +
    exp(-x))``, each step rounded to bf16 (as in `layers.silu`)."""
    return 1 / (1 + torch.exp(-x))


def _shifted(x: torch.Tensor, cache) -> torch.Tensor:
    """x_prev: the previous token's x, zero (prefill) or the cache's
    ``shift`` (decode) before the first."""
    if cache is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([cache["shift"][:, None].to(x.dtype), x[:, :-1]], 1)


def _ddlerp(p, x, x_prev):
    """Data-dependent token-shift for the 5 streams (r, k, v, g, w).

    The shared pre-mix is float32 (bf16 times the float32 ``mu_base``),
    computed as the reference's compiled program does: ``x_prev - x``
    unrounded, one fused multiply-add (``addcmul``)."""
    base = torch.addcmul(x.float(), x_prev.float() - x.float(),
                         p["mu_base"][0])
    lo = torch.tanh(_dense(base, p["ddl_w1"]))
    lo = lo.reshape(*lo.shape[:-1], 5, DDLERP_DIM)
    delta = torch.einsum("...sr,srd->...sd", lo.float(), p["ddl_w2"])
    mus = p["mu_base"] + delta                        # (B, T, 5, D)
    xx = x_prev - x
    return tuple(x + xx * mus[..., i, :].to(x.dtype) for i in range(5))


def _wkv_scan(r, k, v, w, u, h, dh):
    """Sequential wkv: S_t = diag(w_t)·S_{t-1} + k_t⊗v_t;
    y_t = r_t·(S_{t-1} + u·k_t⊗v_t). A Python loop over the tokens."""
    bsz, t, _ = r.shape
    rh, kh, vh, wh = (a.reshape(bsz, t, h, dh) for a in (r, k, v, w))
    s = r.new_zeros((bsz, h, dh, dh))
    ys = []
    for i in range(t):
        kv = kh[:, i, :, :, None] * vh[:, i, :, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", rh[:, i],
                               s + u[None, :, :, None] * kv))
        s = s * wh[:, i, :, :, None] + kv
    return torch.stack(ys, 1).reshape(bsz, t, h * dh), s


def _wkv_chunked(r, k, v, logw, u, h, dh, chunk: int = WKV_CHUNK):
    """Block-parallel wkv: the reference's chunked closed form,

      y_t = Σ_{j<t} (r_t ⊙ e^{c_{t-1}-c_j}) · k_j v_j
            + (r_t ⊙ u ⊙ k_t)·1 v_t + (r_t ⊙ e^{c_{t-1}}) · S_in

    with c the intra-chunk cumulative log-decay; every exponent is a
    suffix sum of log-decays, so ≤ 0. Everything but the carried state is
    computed batched over groups of chunks (``WKV_GROUP_BYTES`` bounds a
    group's (L, L, dh) decay tensor): the intra-chunk terms, the u bonus,
    each chunk's total decay e^{c_L} and its ΔS = Σ_j (k_j e^{c_L-c_j}) v_j.
    A Python loop (`carry_states`) then carries S' = S·e^{c_L} + ΔS over
    the chunks, keeping every chunk's entry state, and one batched
    product applies them.

    Nothing that autograd saves is written in place afterwards (the
    decay tensor's ``exp`` and its product with k are separate tensors,
    and each carried state is a new one), so the backward holds with and
    without remat."""
    bsz, t, _ = r.shape
    nc = t // chunk

    def to_chunks(x):  # (B, T, D) -> (NC, B, H, L, dh)
        return x.reshape(bsz, nc, chunk, h, dh).permute(1, 0, 3, 2, 4)

    rc, kc, vc, lwc = map(to_chunks, (r, k, v, logw))
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=r.device), diagonal=-1)
    y = r.new_empty((nc, bsz, h, chunk, dh))
    q_state = torch.empty_like(y)                    # r ⊙ e^{c_{t-1}}
    delta = r.new_empty((nc, bsz, h, dh, dh))        # each chunk's ΔS
    decay = r.new_empty((nc, bsz, h, dh))            # e^{c_L}
    per_chunk = bsz * h * chunk * chunk * dh * 4
    group = max(1, WKV_GROUP_BYTES // per_chunk)
    for g0 in range(0, nc, group):
        sl = slice(g0, min(g0 + group, nc))
        rr, kk, vv, lw = rc[sl], kc[sl], vc[sl], lwc[sl]
        cc = torch.cumsum(lw, dim=3)                 # inclusive
        cm1 = cc - lw                                # exclusive (c_{t-1})
        # intra-chunk pairs (j < t): exponent c_{t-1} - c_j <= 0
        dec = cm1[..., :, None, :] - cc[..., None, :, :]   # (., L, L, dh)
        dec = dec.masked_fill_(~tri[:, :, None], float("-inf")).exp()
        dec = dec * kk[..., None, :, :]
        att = (rr[..., :, None, :] @ dec.transpose(-1, -2))[..., 0, :]
        del dec
        yg = att @ vv
        # current-token bonus (u term)
        coeff = (rr * (u[None, None, :, None, :] * kk)).sum(-1)
        y[sl] = yg + coeff[..., None] * vv
        q_state[sl] = rr * torch.exp(cm1)
        # state update terms: S' = S·e^{c_L} + Σ_j (k_j e^{c_L - c_j}) v_j
        last = cc[..., -1:, :]
        delta[sl] = (kk * torch.exp(last - cc)).transpose(-1, -2) @ vv
        decay[sl] = torch.exp(last[..., 0, :])
    states = carry_states(delta, decay[..., None])   # entry states, S_fin
    # contribution of each chunk's carried state
    y += q_state @ torch.stack(states[:nc])
    return y.permute(1, 0, 3, 2, 4).reshape(bsz, t, h * dh), states[nc]


def _wkv_inputs(p, x, cache=None):
    """The time-mix's r, k, v (float32), its gate g (bf16) and the
    log-decay (float32, ≤ 0) for the wkv scan."""
    xr, xk, xv, xg, xw = _ddlerp(p, x, _shifted(x, cache))
    r = _dense(xr, p["wr"]).float()
    k = _dense(xk, p["wk"]).float()
    v = _dense(xv, p["wv"]).float()
    g = silu(_dense(xg, p["wg"]))
    # data-dependent decay (Finch): w = exp(-exp(w_base + lora(xw)))
    dec = p["w_base"] + _dense(torch.tanh(_dense(xw, p["dec_w1"])),
                               p["dec_w2"]).float()
    return r, k, v, g, -torch.exp(dec)


def apply_rwkv_timemix(p, x, cfg: ModelConfig, cache=None):
    """x: (B, S, D) bf16. cache: dict(shift=(B, D), wkv=(B, H, dh, dh))
    or None. Returns (out, new_cache); new_cache is None in prefill, and
    holds new tensors in decode (the caller writes them where it keeps
    the cache)."""
    bsz, s, d = x.shape
    h, dh = heads_of(cfg)
    r, k, v, g, logw = _wkv_inputs(p, x, cache)
    u = p["u_bonus"]

    if cache is None:
        if s % WKV_CHUNK == 0:
            y, _ = _wkv_chunked(r, k, v, logw, u, h, dh)
        else:       # ragged tails fall back to the token scan
            y, _ = _wkv_scan(r, k, v, torch.exp(logw), u, h, dh)
        new_cache = None
    else:
        rt, kt, vt, wt = (a.reshape(bsz, h, dh)
                          for a in (r, k, v, torch.exp(logw)))
        kv = kt[..., :, None] * vt[..., None, :]
        y = torch.einsum("bhk,bhkv->bhv", rt,
                         cache["wkv"] + u[None, :, :, None] * kv)
        y = y.reshape(bsz, 1, d)
        new_cache = {"shift": x[:, -1],
                     "wkv": cache["wkv"] * wt[..., None] + kv}

    # per-head groupnorm (RWKV's GroupNorm over heads), then the gate
    yh = y.reshape(bsz, s, h, dh).float()
    mu = yh.mean(-1, keepdim=True)
    var = ((yh - mu) ** 2).mean(-1, keepdim=True)
    yh = (yh - mu) * torch.rsqrt(var + 64e-5)
    y = (yh.reshape(bsz, s, d) * p["ln_scale"]).to(COMPUTE_DTYPE) * g
    return _dense(y, p["wo"]), new_cache


def apply_rwkv_channelmix(p, x, cfg: ModelConfig, cache=None):
    """The squared-ReLU FFN with its token shift; returns (out,
    new_cache) as `apply_rwkv_timemix` does."""
    new_cache = None if cache is None else {"shift": x[:, -1]}
    xx = _shifted(x, cache) - x
    xk = x + xx * p["cm_mu"][0].to(x.dtype)
    xr = x + xx * p["cm_mu"][1].to(x.dtype)
    kk = torch.square(torch.relu(_dense(xk, p["cm_k"])))
    out = sigmoid(_dense(xr, p["cm_r"])) * _dense(kk, p["cm_v"])
    return out, new_cache


def init_rwkv_cache(cfg: ModelConfig, batch: int, *,
                    device: torch.device | str) -> dict:
    d = cfg.d_model
    h, dh = heads_of(cfg)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"tm": {"shift": zeros(batch, d), "wkv": zeros(batch, h, dh, dh)},
            "cm": {"shift": zeros(batch, d)}}
