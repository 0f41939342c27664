"""Shared neural layers: norms, RoPE variants, attention, MLPs, embedding.

The PyTorch port of ``src/repro/models/layers.py``, function for function.

Conventions
-----------
* Layer functions are plain functions on tensors; ``p`` is any mapping of
  parameter names to tensors (a dict, or an ``nn.ParameterDict`` of the
  model). ``init_*`` functions draw on an explicit ``torch.Generator``.
* Master params float32; matmul inputs cast to ``COMPUTE_DTYPE`` (bf16) at
  every call, as the reference does.
* Prefill attention (``cache=None``) goes to the flash kernel on the card
  and to its plain version on the CPU (`flash_eligible`), with the
  config's mask (causal, sliding-window, prefix-LM or bidirectional);
  decode attention is the query-chunked plain version over the cache, as
  in the reference. The device decides how p meets V, in prefill and
  decode alike: the card keeps PV in float32 (the flash kernel's, and the
  TPU kernel's, arithmetic); the CPU rounds p to bf16 before PV, as the
  reference's forward and decode do (`_sdpa_chunked`).
* Decode paths take a cache entry and a position offset. The cache's K/V
  tensors are written in place (the reference returns new arrays).
* bf16 roundings follow the reference's compiled program: a Python
  float that scales a bf16 tensor is itself a bf16 constant there
  (`bf16_scalar`), and ``jax.nn.silu`` and ``jax.nn.gelu`` on bf16 round
  each step of their formulas (`silu`, `gelu`).

The reference's sequence-sharded decode (``_seq_shards``,
``_decode_attn_seqsharded``) belongs to the sharded mesh and is not
ported: a ``mesh=`` argument raises.
"""
from __future__ import annotations

import math

import torch

from ..kernels.flash_attn.flash_attn import HEAD_DIMS
from ..kernels.flash_attn.ops import attention
from ..kernels.hot_embed.ops import hot_cold_lookup
from .config import ModelConfig

COMPUTE_DTYPE = torch.bfloat16
Q_CHUNK = 1024


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "sharded attention (a mesh) is not ported yet: ROADMAP A8.8")


def _normal(gen: torch.Generator, shape, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=torch.float32) * scale


def bf16_scalar(v: float) -> float:
    """``v`` rounded to bf16: what a Python float becomes in the reference
    when it scales a bf16 array (JAX's weak typing keeps the array's
    dtype)."""
    return float(torch.tensor(v, dtype=torch.bfloat16))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA computes it on a bf16 ``x``: ``x · 1 / (1 +
    exp(-x))``, each step rounded to bf16 (``F.silu`` rounds once)."""
    return x * (1 / (1 + torch.exp(-x)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its default tanh form) as XLA computes it on a bf16
    ``x``: ``x · 0.5 (1 + tanh(c (x + k x³)))`` with ``c = √(2/π)`` and
    ``k = 0.044715`` in bf16, each step rounded to bf16."""
    c, k = bf16_scalar(math.sqrt(2 / math.pi)), bf16_scalar(0.044715)
    return x * (0.5 * (1 + torch.tanh(c * (x + k * x ** 3))))


def carry_states(delta: torch.Tensor, decay: torch.Tensor) -> list:
    """The chunked scans' state recurrence S_{c+1} = S_c·decay_c + delta_c
    from S_0 = 0, one ``addcmul`` a chunk (a Python loop: one launch a
    chunk on the card). ``delta``: (NC, ...); ``decay``: (NC, ...), each
    chunk's broadcast against its state. Returns [S_0, ..., S_NC], each a
    new tensor: nothing autograd saves is written afterwards, so the
    backward holds with and without remat. The chunks are taken by
    ``unbind``, whose backward stacks their gradients once (indexing
    ``delta[c]`` would build a zero gradient of all of ``delta`` a
    chunk)."""
    states = [torch.zeros_like(delta[0])]
    for d, g in zip(delta.unbind(0), decay.unbind(0)):
        states.append(torch.addcmul(d, states[-1], g))
    return states


def _dense(x, w, b=None):
    y = torch.matmul(x.to(COMPUTE_DTYPE), w.to(COMPUTE_DTYPE))
    if b is not None:
        y = y + b.to(COMPUTE_DTYPE)
    return y


# ------------------------------------------------------------------- norms
def init_norm(cfg: ModelConfig, d: int | None = None, *,
              device: torch.device | str):
    d = d or cfg.d_model
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm_type == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def apply_norm(p, x, cfg: ModelConfig):
    x32 = x.float()
    if cfg.norm_type == "layernorm":
        mu = x32.mean(-1, keepdim=True)
        var = ((x32 - mu) ** 2).mean(-1, keepdim=True)
        y = (x32 - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"] + p["bias"]
    else:
        var = (x32 ** 2).mean(-1, keepdim=True)
        y = x32 * torch.rsqrt(var + cfg.norm_eps) * p["scale"]
    return y.to(COMPUTE_DTYPE)


# -------------------------------------------------------------------- RoPE
def rope_frequencies(cfg: ModelConfig,
                     device: torch.device | str = "cpu") -> torch.Tensor:
    rot = int(cfg.head_dim * cfg.rotary_pct)
    rot -= rot % 2
    return 1.0 / (cfg.rope_theta ** (torch.arange(
        0, rot, 2, dtype=torch.float32, device=device) / rot))


def apply_rope(x, positions, cfg: ModelConfig):
    """x: (..., S, H, dh); positions: (..., S). Partial rotary supported
    (rotary_pct<1 rotates only the leading dims — chatglm3's 2-D RoPE).
    The rotation runs in float32 (bf16 x times float32 cos) and the result
    is cast back to x's dtype."""
    freqs = rope_frequencies(cfg, x.device)
    rot = 2 * freqs.shape[0]
    if rot == 0:
        return x
    angles = positions[..., :, None].float() * freqs      # (..., S, rot/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., : rot // 2], xr[..., rot // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return torch.cat([out.to(x.dtype), xp], -1)


# --------------------------------------------------------------- attention
def init_attention(gen: torch.Generator, cfg: ModelConfig):
    d, h, kv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    sc = d ** -0.5
    p = {
        "wq": _normal(gen, (d, h * dh), sc),
        "wk": _normal(gen, (d, kv * dh), sc),
        "wv": _normal(gen, (d, kv * dh), sc),
        "wo": _normal(gen, (h * dh, d), sc),
    }
    dev = gen.device
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((h * dh,), dtype=torch.float32, device=dev)
        p["bk"] = torch.zeros((kv * dh,), dtype=torch.float32, device=dev)
        p["bv"] = torch.zeros((kv * dh,), dtype=torch.float32, device=dev)
    if cfg.attn_out_bias:
        p["bo"] = torch.zeros((d,), dtype=torch.float32, device=dev)
    return p


def _attn_mask(q_pos, k_pos, cfg: ModelConfig, k_valid=None):
    """(..., Q, K) boolean mask from absolute positions."""
    q = q_pos[..., :, None]
    k = k_pos[..., None, :]
    if cfg.causal:
        mask = q >= k
        if cfg.prefix_tokens > 0:  # prefix-LM: bidirectional over the prefix
            mask = mask | ((q < cfg.prefix_tokens) & (k < cfg.prefix_tokens))
        if cfg.window > 0:
            mask = mask & ((q - k) < cfg.window)
    else:
        mask = torch.ones(torch.broadcast_shapes(q.shape, k.shape),
                          dtype=torch.bool, device=q.device)
    if k_valid is not None:
        mask = mask & k_valid[..., None, :]
    return mask


def _sdpa_chunked(q, k, v, q_pos, k_pos, cfg: ModelConfig, k_valid=None,
                  round_p: bool = True):
    """Query-chunked GQA attention. q: (B,S,H,dh); k,v: (B,T,KV,dh).

    Logits and softmax in float32. With ``round_p`` (the reference) the
    probabilities are rounded to bf16 for a bf16 PV; without, PV runs in
    float32 and the result is rounded once, as the flash kernel does. A
    decode step on the card takes the latter, after the kernel's prefill:
    at full width, rounding p in decode alone parts an MoE's decode
    routing from its forward's at 4 of 64 positions where float32 parts it
    at 2, as the reference's own decode parts from its forward
    (``tests/moe_routing_witness.py``)."""
    b, s, h, dh = q.shape
    kvh = cfg.num_kv_heads
    rep = h // kvh
    scale = dh ** -0.5
    qs = q.reshape(b, s, kvh, rep, dh)
    k32 = k.float()
    pv = COMPUTE_DTYPE if round_p else torch.float32
    vc = v.to(pv)

    def one_chunk(qc, qp):  # (B,C,KV,rep,dh), (C,)
        logits = torch.einsum("bcgrd,btgd->bgrct", qc.float(), k32) * scale
        mask = _attn_mask(qp, k_pos, cfg, k_valid)          # (C,T)
        logits = torch.where(mask[None, None, None], logits, -1e30)
        probs = torch.softmax(logits, dim=-1)
        return torch.einsum("bgrct,btgd->bcgrd", probs.to(pv),
                            vc).to(COMPUTE_DTYPE)

    chunk = min(Q_CHUNK, s)
    if s % chunk == 0 and s > chunk:
        out = torch.cat([one_chunk(qs[:, i:i + chunk], q_pos[i:i + chunk])
                         for i in range(0, s, chunk)], dim=1)
        return out.reshape(b, s, h, dh)
    return one_chunk(qs, q_pos).reshape(b, s, h, dh)


def flash_eligible(cfg: ModelConfig, device: torch.device | str) -> bool:
    """Whether prefill attention (``cache=None``) runs through
    `ops.attention` (the flash kernel on the card, its plain version on
    the CPU).

    The kernel takes every mask of `_attn_mask` (causal, sliding-window,
    prefix-LM and bidirectional), multi-head or grouped-query (each kv
    head serving ``num_heads / num_kv_heads`` query heads), at a head dim
    in `HEAD_DIMS`. On the CPU a config at another head dim takes the
    reference's chunked plain path; on the card it raises, since nothing
    there gives way to a plain version.
    """
    if cfg.head_dim in HEAD_DIMS:
        return True
    if torch.device(device).type == "cuda":
        raise NotImplementedError(
            f"{cfg.name}: the flash kernel does not take head dim "
            f"{cfg.head_dim} (it takes {HEAD_DIMS}) yet: ROADMAP A8.9b")
    return False


def apply_attention(p, x, cfg: ModelConfig, positions, cache=None,
                    mesh=None):
    """Returns (out, new_cache). cache=None -> full self-attention (prefill).

    cache: dict(k=(B,T,KV,dh), v=..., length=0-d int32 tensor) for decode;
    positions are absolute token positions of x's tokens. The cache's k and
    v are written in place and returned in ``new_cache``.
    """
    _no_mesh(mesh)
    b, s, d = x.shape
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _dense(x, p["wq"], p.get("bq")).reshape(b, s, h, dh)
    k = _dense(x, p["wk"], p.get("bk")).reshape(b, s, kv, dh)
    v = _dense(x, p["wv"], p.get("bv")).reshape(b, s, kv, dh)
    q = apply_rope(q, positions, cfg)
    k = apply_rope(k, positions, cfg)

    if cache is None:
        if flash_eligible(cfg, x.device):
            # (B·heads, S, dh); k and v keep their kv heads, so that a kv
            # row serves h / kv query rows (never expanded to h heads)
            def heads(t):
                return t.transpose(1, 2).reshape(-1, s, dh)
            of = attention(heads(q), heads(k), heads(v), window=cfg.window,
                           causal=cfg.causal, prefix=cfg.prefix_tokens)
            out = of.reshape(b, h, s, dh).transpose(1, 2)
        else:
            out = _sdpa_chunked(q, k, v, positions, positions, cfg)
        new_cache = None
    else:
        # decode step (s == 1). Sliding-window configs use a ring buffer of
        # size `window`; full-attention configs use a linear buffer.
        assert s == 1, "cached attention path is decode-only (s == 1)"
        t = cache["k"].shape[1]
        pos = positions[-1]
        ar = torch.arange(t, device=x.device)
        if cfg.window > 0 and t <= cfg.window:
            slot = (pos % t).long().reshape(1)
            k_pos = pos - ((slot - ar) % t)
            k_valid = k_pos >= 0
        else:
            # dynamic_update_slice_in_dim clamps its start so that the
            # update fits: once the shared length passes T - 1, every
            # write lands on the last slot
            slot = cache["length"].clamp(0, t - s).long().reshape(1)
            k_pos = ar
            k_valid = k_pos < cache["length"] + 1
        ck = cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
        cv = cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
        # p meets V as in the prefill on this device (`flash_attention`)
        out = _sdpa_chunked(q, ck, cv, positions, k_pos, cfg, k_valid,
                            round_p=x.device.type != "cuda")
        new_cache = {"k": ck, "v": cv, "length": cache["length"] + 1}

    out = _dense(out.reshape(b, s, h * dh), p["wo"], p.get("bo"))
    return out, new_cache


def init_attn_cache(cfg: ModelConfig, batch: int, max_len: int,
                    dtype=COMPUTE_DTYPE, *, device: torch.device | str):
    t = min(max_len, cfg.window) if cfg.window > 0 else max_len
    shape = (batch, t, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "length": torch.zeros((), dtype=torch.int32, device=device),
    }


# --------------------------------------------------------------------- MLP
def init_mlp(gen: torch.Generator, cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    sc_in, sc_out = d ** -0.5, f ** -0.5
    if cfg.mlp_type == "swiglu":
        return {
            "w_gate": _normal(gen, (d, f), sc_in),
            "w_up": _normal(gen, (d, f), sc_in),
            "w_down": _normal(gen, (f, d), sc_out),
        }
    p = {
        "w_in": _normal(gen, (d, f), sc_in),
        "w_out": _normal(gen, (f, d), sc_out),
    }
    if cfg.mlp_bias:
        p["b_in"] = torch.zeros((f,), dtype=torch.float32, device=gen.device)
        p["b_out"] = torch.zeros((d,), dtype=torch.float32, device=gen.device)
    return p


def apply_mlp(p, x, cfg: ModelConfig):
    if cfg.mlp_type == "swiglu":
        return _dense(silu(_dense(x, p["w_gate"]))
                      * _dense(x, p["w_up"]), p["w_down"])
    h = gelu(_dense(x, p["w_in"], p.get("b_in")))
    return _dense(h, p["w_out"], p.get("b_out"))


# --------------------------------------------------------------- embedding
def init_embedding(gen: torch.Generator, cfg: ModelConfig):
    p = {"table": _normal(gen, (cfg.vocab_size, cfg.d_model), 0.02)}
    if not cfg.tie_embeddings:
        p["head"] = _normal(gen, (cfg.d_model, cfg.vocab_size),
                            cfg.d_model ** -0.5)
    return p


def hot_vocab_size(cfg: ModelConfig) -> int:
    """Rows of the hot slab: the first ``hot_vocab_fraction`` of the
    (LOrder-permuted) vocabulary, at least one."""
    return max(1, int(cfg.vocab_size * cfg.hot_vocab_fraction))


def embed_tokens(p, ids, cfg: ModelConfig):
    """Rows of the table for ``ids``, scaled by ``emb_scale`` in float32
    and then cast to bf16. With a hot vocabulary the rows come through
    `hot_cold_lookup` (the hot-slab kernel on the card)."""
    if cfg.hot_vocab_fraction > 0:
        x = hot_cold_lookup(ids, p["table"], hot_vocab_size(cfg))
    else:
        x = p["table"][ids.long()]
    return (x * cfg.emb_scale).to(COMPUTE_DTYPE)


def lm_logits(p, x, cfg: ModelConfig):
    """bf16 logits; ``logit_scale`` (in bf16) is applied after the bf16
    product."""
    w = p["table"].T if cfg.tie_embeddings else p["head"]
    return _dense(x, w) * bf16_scalar(cfg.logit_scale)
