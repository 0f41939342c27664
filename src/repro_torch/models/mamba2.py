"""Mamba2 (SSD) block: zamba2's backbone.

The PyTorch port of ``src/repro/models/mamba2.py``, function for
function, on parameter dicts as in `layers`.

Chunked state-space-duality algorithm: within a chunk the recurrence is a
masked attention-like product, computed for every chunk in one batched
pass; across chunks a Python loop carries the (H, N, P) state, one launch
a chunk on the card (the reference's ``lax.scan``, not a Pallas kernel).
Single B/C group (ngroups=1), heads of size ``ssm_head_dim``, state size
N = ``cfg.ssm_state``.
"""
from __future__ import annotations

import torch

from .config import ModelConfig
from .layers import COMPUTE_DTYPE, _dense, _normal, carry_states, silu


def init_mamba(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    dev = gen.device
    in_dim = 2 * di + 2 * n + h          # z, x, B, C, dt
    return {
        "w_in": _normal(gen, (d, in_dim), d ** -0.5),
        "conv": _normal(gen, (cfg.conv_width, di + 2 * n), 0.2),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, dtype=torch.float32,
                                          device=dev)),
        "dt_bias": torch.zeros((h,), dtype=torch.float32, device=dev),
        "d_skip": torch.ones((h,), dtype=torch.float32, device=dev),
        "norm_scale": torch.ones((di,), dtype=torch.float32, device=dev),
        "w_out": _normal(gen, (di, d), di ** -0.5),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` as JAX writes it."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def _split_in(u, cfg: ModelConfig):
    di, n = cfg.d_inner, cfg.ssm_state
    return torch.split(u, [di, di + 2 * n, u.shape[-1] - 2 * di - 2 * n],
                       dim=-1)


def _causal_conv(xbc, conv_w, state=None):
    """Depthwise causal conv, width W, as the reference's shifted sum (a
    float32 result: bf16 taps times float32 weights). state: (B, W-1, C)
    carry for decode."""
    w = conv_w.shape[0]
    if state is None:
        pad = torch.zeros_like(xbc[:, : w - 1])
    else:
        pad = state.to(xbc.dtype)
    buf = torch.cat([pad, xbc], dim=1)
    s = xbc.shape[1]
    out = sum(buf[:, i: i + s] * conv_w[i] for i in range(w))
    return silu(out), buf[:, -(w - 1):]


def _gated_rmsnorm(y, z, scale, eps=1e-5):
    y = y * silu(z.float())
    var = (y ** 2).mean(-1, keepdim=True)
    return (y * torch.rsqrt(var + eps) * scale).to(COMPUTE_DTYPE)


def ssd_chunked(x, dt, b, c, a_log, chunk: int):
    """SSD scan. x: (B, T, H, P); dt: (B, T, H); b, c: (B, T, N). Returns
    (B, T, H, P) bf16.

    Recurrence: S_t = exp(-exp(a_log)·dt_t)·S_{t-1} + dt_t·x_t⊗b_t,
    y_t = S_t·c_t (per head). The intra-chunk products and each chunk's
    state contribution are batched over all chunks (heads leading, so each
    is one batched matmul); the loop over chunks (`carry_states`) carries
    only S' = S·e^{c_L} + S_chunk, keeping every chunk's entry state, each
    a new tensor: nothing that autograd saves is written in place
    afterwards, so the backward holds with and without remat."""
    bs, t, h, pdim = x.shape
    n = b.shape[-1]
    nc = t // chunk
    la = dt * -torch.exp(a_log)                     # (B, T, H) log-decay
    xs = x * dt[..., None]                          # dt-weighted input

    def chunks(v):  # (B, T, ...) -> (B, NC, L, ...)
        return v.reshape(bs, nc, chunk, *v.shape[2:])

    b_c, c_c = chunks(b.float()), chunks(c.float())             # (B,NC,L,N)
    xs_h = chunks(xs.float()).permute(0, 1, 3, 2, 4)           # (B,NC,H,L,P)
    cums = torch.cumsum(chunks(la.float()), dim=2).permute(0, 1, 3, 2)
    # (B, NC, H, L): cumulative log-decay within each chunk

    # intra-chunk (attention-like, lower triangular); mask BEFORE exp: the
    # upper triangle's exponents are positive and would overflow
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=x.device))
    dec = (cums[..., :, None] - cums[..., None, :]).masked_fill_(
        ~tri, -1e30).exp()                                     # (B,NC,H,L,L)
    cb = c_c @ b_c.transpose(-1, -2)                           # (B,NC,L,L)
    y = (dec * cb[:, :, None]) @ xs_h                          # (B,NC,H,L,P)
    del dec

    # chunk states: S_g = Σ_j exp(cums_last - cums_j) b_j ⊗ xs_j
    last = cums[..., -1:]                                      # (B,NC,H,1)
    s_chunk = (b_c.transpose(-1, -2)[:, :, None]
               @ (torch.exp(last - cums)[..., None] * xs_h)).transpose(0, 1)
    g_total = torch.exp(last[..., 0]).transpose(0, 1)          # (NC, B, H)
    states = carry_states(s_chunk, g_total[..., None, None])

    # the carried state's contribution: exp(cums_i) c_i · S_before
    s_before = torch.stack(states[:nc], 1)                     # (B,NC,H,N,P)
    y += torch.exp(cums)[..., None] * (c_c[:, :, None] @ s_before)
    return y.permute(0, 1, 3, 2, 4).reshape(bs, t, h, pdim).to(COMPUTE_DTYPE)


def _mixer_inputs(p, x, cfg: ModelConfig, conv_state=None):
    """The in-projection and the causal conv: (z, x heads (B, S, H, P)
    float32, dt (B, S, H), b, c (B, S, N), the new conv state)."""
    bsz, s, _ = x.shape
    n = cfg.ssm_state
    z, xbc, dt_raw = _split_in(_dense(x, p["w_in"]), cfg)
    dt = softplus(dt_raw.float() + p["dt_bias"])
    xbc, conv_state = _causal_conv(xbc, p["conv"], conv_state)
    xi, b, c = torch.split(xbc, [cfg.d_inner, n, n], dim=-1)
    xh = xi.reshape(bsz, s, cfg.ssm_heads, cfg.ssm_head_dim)
    return z, xh, dt, b, c, conv_state


def apply_mamba(p, x, cfg: ModelConfig, cache=None):
    """x: (B, S, D) bf16. cache: dict(conv=(B, W-1, C), ssd=(B, H, N, P))
    or None. Returns (out, new_cache); new_cache is None in prefill and
    holds new tensors in decode."""
    bsz, s, _ = x.shape
    z, xh, dt, b, c, conv_state = _mixer_inputs(
        p, x, cfg, None if cache is None else cache["conv"])
    if cache is None:
        # pad time to a chunk multiple (zero dt: padded steps are identity)
        pad = (-s) % cfg.ssm_chunk
        if pad:
            def padded(v):
                return torch.cat([v, v.new_zeros((bsz, pad, *v.shape[2:]))],
                                 dim=1)
            y = ssd_chunked(padded(xh), padded(dt), padded(b), padded(c),
                            p["a_log"], cfg.ssm_chunk)[:, :s]
        else:
            y = ssd_chunked(xh, dt, b, c, p["a_log"], cfg.ssm_chunk)
        y = y + xh * p["d_skip"][:, None]
        new_cache = None
    else:
        a = torch.exp(dt * -torch.exp(p["a_log"]))[:, 0]     # (B, H)
        s_new = (cache["ssd"] * a[..., None, None]
                 + b[:, 0].float()[:, None, :, None]
                 * (xh[:, 0] * dt[:, 0, :, None])[:, :, None, :])
        y = torch.einsum("bn,bhnp->bhp", c[:, 0].float(), s_new)
        y = (y + xh[:, 0] * p["d_skip"][:, None])[:, None]
        new_cache = {"conv": conv_state.to(cache["conv"].dtype),
                     "ssd": s_new}

    y = _gated_rmsnorm(y.reshape(bsz, s, cfg.d_inner), z, p["norm_scale"])
    return _dense(y, p["w_out"]), new_cache


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype=COMPUTE_DTYPE, *,
                     device: torch.device | str) -> dict:
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1,
                             cfg.d_inner + 2 * cfg.ssm_state), dtype=dtype,
                            device=device),
        "ssd": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_state,
                            cfg.ssm_head_dim), dtype=torch.float32,
                           device=device),
    }
