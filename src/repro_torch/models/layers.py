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

On a mesh (``mesh=``, ``launch/mesh.py``) `apply_attention` takes the
layer's params as `ShardedTensor`s laid out by ``param_specs`` and ``x``
as one tensor a shard, and computes Megatron-style over ``model``: each
shard projects with its own columns of ``wq``/``wk``/``wv`` (gathered
whole over ``data`` first, the FSDP gather), computes the heads its
``wq`` columns cover, and multiplies them by its rows of ``wo``; a psum
over ``model`` sums the partial outputs (`_apply_attention_sharded`).
Where a spec splits finer than a whole head (qwen2.5-3b's ``wk`` at
``model`` = 4 is half a kv head a shard), the shard all-gathers the
projected columns over ``model`` to the whole kv heads its q heads read.
A decode against a cache sharded on its sequence dim (kv heads that do
not divide ``model``, `_seq_shards`) runs `_decode_attn_seqsharded`: each
shard attends over its slice of the cache for every head, and the
partial softmaxes combine by ``pmax`` and ``psum`` over ``model``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core import dist
from ..kernels.flash_attn.flash_attn import HEAD_DIMS
from ..kernels.flash_attn.ops import attention
from ..kernels.hot_embed.ops import hot_cold_lookup
from .config import ModelConfig

COMPUTE_DTYPE = torch.bfloat16
Q_CHUNK = 1024


MODEL = "model"
DP_AXES = ("pod", "data")


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


def _prefill_attention(q, k, v, cfg: ModelConfig, positions):
    """Self-attention over the whole sequence: q (B,S,H,dh), k/v
    (B,S,KV,dh) -> (B,S,H,dh)."""
    b, s, h, dh = q.shape
    if flash_eligible(cfg, q.device):
        # (B·heads, S, dh); k and v keep their kv heads, so that a kv
        # row serves h / kv query rows (never expanded to h heads)
        def heads(t):
            return t.transpose(1, 2).reshape(-1, s, dh)
        of = attention(heads(q), heads(k), heads(v), window=cfg.window,
                       causal=cfg.causal, prefix=cfg.prefix_tokens)
        return of.reshape(b, h, s, dh).transpose(1, 2)
    return _sdpa_chunked(q, k, v, positions, positions, cfg)


def _cache_write(cache, k, v, cfg: ModelConfig, positions):
    """Writes one decode step's k/v (B,1,KV,dh) into ``cache`` in place.
    Sliding-window configs use a ring buffer of size ``window``,
    full-attention configs a linear buffer. Returns (k, v, k_pos,
    k_valid): the cache's tensors, each slot's position and whether it
    holds a key the step may read."""
    t = cache["k"].shape[1]
    pos = positions[-1]
    ar = torch.arange(t, device=k.device)
    if cfg.window > 0 and t <= cfg.window:
        slot = (pos % t).long().reshape(1)
        k_pos = pos - ((slot - ar) % t)
        k_valid = k_pos >= 0
    else:
        # dynamic_update_slice_in_dim clamps its start so that the
        # update fits: once the shared length passes T - 1, every
        # write lands on the last slot
        slot = cache["length"].clamp(0, t - 1).long().reshape(1)
        k_pos = ar
        k_valid = k_pos < cache["length"] + 1
    ck = cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
    cv = cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
    return ck, cv, k_pos, k_valid


def apply_attention(p, x, cfg: ModelConfig, positions, cache=None,
                    mesh=None):
    """Returns (out, new_cache). cache=None -> full self-attention (prefill).

    cache: dict(k=(B,T,KV,dh), v=..., length=0-d int32 tensor) for decode;
    positions are absolute token positions of x's tokens. The cache's k and
    v are written in place and returned in ``new_cache``.

    With ``mesh``: ``p`` maps names to `ShardedTensor`s, ``x`` is one
    tensor a shard and ``cache`` (if any) holds `ShardedTensor`s laid out
    by ``cache_specs``; the output is one tensor a shard
    (`_apply_attention_sharded`).
    """
    if mesh is not None:
        if not isinstance(x, (list, tuple)):
            raise TypeError("on a mesh x is one tensor a shard")
        return _apply_attention_sharded(p, x, cfg, positions, cache, mesh)
    b, s, d = x.shape
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = _dense(x, p["wq"], p.get("bq")).reshape(b, s, h, dh)
    k = _dense(x, p["wk"], p.get("bk")).reshape(b, s, kv, dh)
    v = _dense(x, p["wv"], p.get("bv")).reshape(b, s, kv, dh)
    q = apply_rope(q, positions, cfg)
    k = apply_rope(k, positions, cfg)

    if cache is None:
        out = _prefill_attention(q, k, v, cfg, positions)
        new_cache = None
    else:
        assert s == 1, "cached attention path is decode-only (s == 1)"
        ck, cv, k_pos, k_valid = _cache_write(cache, k, v, cfg, positions)
        # p meets V as in the prefill on this device (`flash_attention`)
        out = _sdpa_chunked(q, ck, cv, positions, k_pos, cfg, k_valid,
                            round_p=x.device.type != "cuda")
        new_cache = {"k": ck, "v": cv, "length": cache["length"] + 1}

    out = _dense(out.reshape(b, s, h * dh), p["wo"], p.get("bo"))
    return out, new_cache


# ------------------------------------------------------ attention on a mesh
def _seq_shards(mesh, cfg: ModelConfig, t: int) -> int:
    """Shards for a sequence-sharded KV cache: applies when kv heads do NOT
    divide the model axis (else heads shard), the cache length does, and
    there is no sliding window."""
    if mesh is None or MODEL not in getattr(mesh, "axis_names", ()):
        return 1
    n = mesh.shape[MODEL]
    if n > 1 and cfg.num_kv_heads % n != 0 and t % n == 0 \
            and cfg.window == 0:
        return n
    return 1


def split_over(st, dim: int, axis: str = MODEL) -> bool:
    """Whether `ShardedTensor` ``st`` splits ``dim`` over ``axis`` (of size
    more than 1)."""
    e = st.spec[dim]
    axes = e if isinstance(e, tuple) else (e,)
    return axis in axes and st.mesh.shape.get(axis, 1) > 1


def psum_model(values: list, mesh, split: bool = True) -> list:
    """``psum`` over ``model`` of one partial a shard (the Megatron sum after
    a row-split product); the values themselves when nothing was split."""
    return dist.psum(values, mesh, MODEL) if split else values


def _columns(locs: list, have: list, need: list, mesh) -> list:
    """Shard ``i``'s columns ``need[i]`` = [lo, hi) of an activation whose
    shard ``i`` holds columns ``have[i]``: its own when they cover them,
    else an all-gather over ``model`` first."""
    full, out = None, []
    for i, (t, (a, b), (lo, hi)) in enumerate(zip(locs, have, need)):
        if a <= lo and hi <= b:
            out.append(t if (a, b) == (lo, hi) else t[..., lo - a:hi - a])
        else:
            if full is None:
                full = dist.all_gather(locs, mesh, axis=MODEL)
            out.append(full[i][..., lo:hi])
    return out


def _local_heads(cfg: ModelConfig, h0: int, h1: int, g0: int, g1: int):
    """(config, kv index or None) for q heads [h0, h1) reading kv heads
    [g0, g1): the config with those head counts when each kv head serves
    an equal run of the q heads; else an MHA config and, for each q head,
    the kv head (from g0) to repeat for it."""
    rep = cfg.num_heads // cfg.num_kv_heads
    nh, ng = h1 - h0, g1 - g0
    idx = [hh // rep - g0 for hh in range(h0, h1)]
    if nh % ng == 0 and idx == [j // (nh // ng) for j in range(nh)]:
        return dataclasses.replace(cfg, num_heads=nh, num_kv_heads=ng), None
    return dataclasses.replace(cfg, num_heads=nh, num_kv_heads=nh), idx


def _apply_attention_sharded(p, xs, cfg: ModelConfig, positions, cache,
                             mesh):
    """`apply_attention` on a mesh. Shard ``i`` computes q heads [h0, h1),
    those its ``wq`` columns [a, b) cover (every head, for a sequence-
    sharded decode), reads the kv heads they map to, multiplies columns
    [a, b) of the heads' output by its rows of ``wo`` and sums over
    ``model``. In decode it writes the kv heads its cache slice holds."""
    h, kv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    rep = h // kv
    n = mesh.size
    seq = cache is not None and _seq_shards(
        mesh, cfg, cache["k"].shape[1]) > 1
    g = {name: st.gather(DP_AXES) for name, st in p.items()}

    def proj(w, bias):
        return [_dense(xs[i], g[w][i], g[bias][i] if bias in g else None)
                for i in range(n)]

    qcols = [p["wq"].bounds(i, 1) for i in range(n)]
    kcols = [p["wk"].bounds(i, 1) for i in range(n)]
    heads, reads, kvs = [], [], []
    for i, (a, b) in enumerate(qcols):
        h0, h1 = (0, h) if seq else (a // dh, -(-b // dh))
        g0, g1 = h0 // rep, (h1 - 1) // rep + 1
        heads.append((h0, h1))
        reads.append((g0, g1))
        if cache is not None:    # write every kv head the slice holds
            c0, c1 = cache["k"].bounds(i, 2)
            g0, g1 = min(g0, c0), max(g1, c1)
        kvs.append((g0, g1))
    q = _columns(proj("wq", "bq"), qcols,
                 [(h0 * dh, h1 * dh) for h0, h1 in heads], mesh)
    kcol = [(g0 * dh, g1 * dh) for g0, g1 in kvs]
    k = _columns(proj("wk", "bk"), kcols, kcol, mesh)
    v = _columns(proj("wv", "bv"), kcols, kcol, mesh)

    b, s = xs[0].shape[:2]
    pos = {d: positions.to(d) for d in mesh.distinct}
    outs, qs, ks, vs = [], [], [], []
    for i in range(n):
        pi = pos[mesh.devices[i]]
        (h0, h1), (g0, g1) = heads[i], kvs[i]
        qs.append(apply_rope(q[i].reshape(b, s, h1 - h0, dh), pi, cfg))
        ks.append(apply_rope(k[i].reshape(b, s, g1 - g0, dh), pi, cfg))
        vs.append(v[i].reshape(b, s, g1 - g0, dh))
    new_cache = None
    if seq:
        outs, new_cache = _decode_attn_seqsharded(
            [t.reshape(b, 1, kv, rep, dh) for t in qs], ks, vs, cache, cfg,
            mesh)
        outs = [o.reshape(b, s, h * dh) for o in outs]
    else:
        lengths = []
        for i in range(n):
            pi = pos[mesh.devices[i]]
            (h0, h1), (r0, r1), (g0, _) = heads[i], reads[i], kvs[i]
            lcfg, idx = _local_heads(cfg, h0, h1, r0, r1)

            def sel(t):    # the kv heads q heads [h0, h1) read
                t = t[:, :, r0 - g0:r1 - g0]
                return t if idx is None else t[:, :, idx]
            if cache is None:
                o = _prefill_attention(qs[i], sel(ks[i]), sel(vs[i]), lcfg,
                                       pi)
            else:
                local = {"k": cache["k"].shards[i],
                         "v": cache["v"].shards[i],
                         "length": cache["length"].shards[i]}
                ck, cv, k_pos, k_valid = _cache_write(local, ks[i], vs[i],
                                                      cfg, pi)
                o = _sdpa_chunked(qs[i], sel(ck), sel(cv), pi, k_pos, lcfg,
                                  k_valid, round_p=pi.device.type != "cuda")
                lengths.append(local["length"] + 1)
            outs.append(o.reshape(b, s, (h1 - h0) * dh))
        if cache is not None:
            new_cache = dict(cache, length=_like(cache["length"], lengths))
    wo = g["wo"]
    part = [torch.matmul(
        outs[i][..., a - heads[i][0] * dh:b_ - heads[i][0] * dh].to(
            COMPUTE_DTYPE), wo[i].to(COMPUTE_DTYPE))
        for i, (a, b_) in enumerate(qcols)]
    out = psum_model(part, mesh, split_over(p["wo"], 0))
    if "bo" in g:
        out = [o + g["bo"][i].to(COMPUTE_DTYPE) for i, o in enumerate(out)]
    return out, new_cache


def _like(st, shards: list):
    """A `ShardedTensor` with ``st``'s layout and new shards."""
    return type(st)(shards, st.spec, st.mesh, st.shape)


def _decode_attn_seqsharded(q, k_new, v_new, cache, cfg: ModelConfig, mesh):
    """One-token decode against a sequence-sharded KV cache.

    Each model shard owns a contiguous T/n slice of the cache: it writes
    the step's k/v into its slice only when the slot ``length - ax·tl``
    falls in it, computes float32 logits over its slice masked at ``kpos
    <= length``, and the partial softmaxes combine over ``model``:
    ``pmax`` of the row maxima, ``psum`` of the sums and of the
    numerators, divided by ``max(l, 1e-30)``. q: one (B,1,KV,rep,dh)
    tensor a shard (every head); k_new/v_new: (B,1,KV,dh); cache:
    `ShardedTensor`s ``k``/``v`` (B,T,KV,dh) split over ``model`` on T and
    ``length``. The batch keeps its split over the data axes. Returns (one
    (B,1,KV,rep,dh) bf16 output a shard, the new cache); the cache's
    tensors are written in place."""
    dh = q[0].shape[-1]
    scale = dh ** -0.5
    logits, vals, lengths = [], [], []
    for i in range(mesh.size):
        ck, cv = cache["k"].shards[i], cache["v"].shards[i]
        length = cache["length"].shards[i]
        ax = mesh.coords(i)[MODEL]
        tl = ck.shape[1]
        slot = length - ax * tl
        ok = (slot >= 0) & (slot < tl)
        idx = slot.clamp(0, tl - 1).long().reshape(1)
        for c, new in ((ck, k_new[i]), (cv, v_new[i])):
            c.index_copy_(1, idx, torch.where(ok, new.to(c.dtype),
                                              c.index_select(1, idx)))
        kpos = ax * tl + torch.arange(tl, device=ck.device)
        lg = torch.einsum("bqgrd,btgd->bgrqt", q[i].float(),
                          ck.float()) * scale
        logits.append(torch.where((kpos <= length)[None, None, None, None],
                                  lg, -1e30))
        vals.append(cv)
        lengths.append(length + 1)
    m = dist.pmax([lg.amax(-1) for lg in logits], mesh, MODEL)
    pv = [torch.exp(lg - mi[..., None]) for lg, mi in zip(logits, m)]
    l = dist.psum([t.sum(-1) for t in pv], mesh, MODEL)
    num = dist.psum([torch.einsum("bgrqt,btgd->bqgrd", t, cv.float())
                     for t, cv in zip(pv, vals)], mesh, MODEL)
    out = [(nu / torch.clamp(li, min=1e-30).permute(0, 3, 1, 2)[..., None]
            ).to(COMPUTE_DTYPE) for nu, li in zip(num, l)]
    return out, dict(cache, length=_like(cache["length"], lengths))


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


def apply_mlp(p, x, cfg: ModelConfig, mesh=None):
    """The MLP. With ``mesh`` (``p`` of `ShardedTensor`s, ``x`` one tensor
    a shard) each shard computes its own columns of the hidden layer (the
    weights gathered whole over ``data`` first) and its rows of the
    output product, and a psum over ``model`` sums them; the output bias
    is added after the sum."""
    if mesh is not None:
        return _apply_mlp_sharded(p, x, cfg, mesh)
    if cfg.mlp_type == "swiglu":
        return _dense(silu(_dense(x, p["w_gate"]))
                      * _dense(x, p["w_up"]), p["w_down"])
    h = gelu(_dense(x, p["w_in"], p.get("b_in")))
    return _dense(h, p["w_out"], p.get("b_out"))


def _apply_mlp_sharded(p, xs, cfg: ModelConfig, mesh):
    g = {name: st.gather(DP_AXES) for name, st in p.items()}
    n = mesh.size
    if cfg.mlp_type == "swiglu":
        part = [_dense(silu(_dense(xs[i], g["w_gate"][i]))
                       * _dense(xs[i], g["w_up"][i]), g["w_down"][i])
                for i in range(n)]
        return psum_model(part, mesh, split_over(p["w_down"], 0))
    part = [_dense(gelu(_dense(xs[i], g["w_in"][i],
                               g["b_in"][i] if "b_in" in g else None)),
                   g["w_out"][i]) for i in range(n)]
    out = psum_model(part, mesh, split_over(p["w_out"], 0))
    if "b_out" in g:
        out = [o + g["b_out"][i].to(COMPUTE_DTYPE) for i, o in enumerate(out)]
    return out


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
