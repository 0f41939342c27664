"""PyTorch port: the flash backward's ``wgmma`` kernels, modelled on the
CPU.

The kernels (``csrc/flash_attn.cu``, ``flash_bwd_dq_wgmma`` and
``flash_bwd_dkdv_wgmma``) run only on the card, where
tests/test_torch_cuda.py holds them to a float64 oracle. Here their plain
model, `ref.attention_bwd_tiled_ref` (P and dS rounded to bf16 as
operands, float32 sums over 64-row and 64-key steps, per-head dK and dV
partials summed over the group in head order), is held to the plain
backward, to ``jax.vjp`` of the reference's ``_sdpa_chunked`` and to
FlashAttention's own standard, at every mask and at group 1, 4, 9 and 16
(starcoder2-7b's and chatglm3-6b's, with a window that cuts), and at
head dim 256 (paligemma-3b's, whose dk/dv kernel splits the head dim
between its warpgroups: the same steps and sums per column) with
paligemma's grouping, 8 query rows over 1 kv row, and a prefix that ends
inside a 64-row step; and the variant dispatch by head dim is checked.
The tolerances, each with its reason:

* against `attention_bwd_ref` (the same recompute in float32, nothing
  rounded): 2e-2 relative and 2e-2 of the largest gradient, the card
  tests' kernel-against-plain standard; P and dS as bf16 operands part by
  up to 2^-8 of each product;
* against ``jax.vjp`` of ``_sdpa_chunked``: 3e-2 of the largest gradient,
  since the reference rounds p, dP and dV to bf16 in its own places;
* FlashAttention's standard: each gradient's max error against a float64
  autograd oracle at most 2x the plain bf16 path's, plus 1e-3.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.kernels.flash_attn import flash_attn as fa  # noqa: E402
from repro_torch.kernels.flash_attn.ref import (  # noqa: E402
    attention_bwd_ref, attention_bwd_tiled_ref, attention_lse_ref,
    attention_ref, visible)

MASKS = [dict(causal=True), dict(causal=True, window=48),
         dict(causal=True, prefix=70), dict(causal=False)]
MASK_IDS = ["causal", "window", "prefix", "bidirectional"]


def _inputs(bh, kv, s, d, seed):
    """bf16 q, k, v, dO from numpy normals, and the forward's bf16 o and
    float32 lse (the plain versions of `flash_attention_lse`)."""
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((bh, s, d)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((kv, s, d)).astype(
        np.float32)).to(torch.bfloat16) for _ in range(2))
    return q, k, v, do


def _forward(q, k, v, mask):
    return attention_ref(q, k, v, **mask), attention_lse_ref(q, k, **mask)


@pytest.mark.parametrize("mask", MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("bh,kv,s,d", [(4, 4, 150, 32), (8, 2, 150, 32),
                                       (4, 1, 40, 32), (8, 1, 150, 256),
                                       (18, 2, 150, 32), (16, 1, 150, 32)],
                         ids=["group1", "group4", "group4-s40",
                              "d256-group8", "group9", "group16"])
def test_tiled_model_matches_the_plain_backward(bh, kv, s, d, mask):
    """The model against `attention_bwd_ref` on the same o and lse: S
    across the kernels' 64- and 128-row tiles and below one step; at d
    256 paligemma-3b's 8 query rows over 1 kv row, S across its 64-key
    dk/dv and 64-row dq blocks, the prefix of 70 ending inside a step; at
    starcoder2-7b's group of 9 (over 2 kv rows, so that the second kv
    row's group starts mid-block) and chatglm3-6b's 16, the window of 48
    cutting rows past it."""
    q, k, v, do = _inputs(bh, kv, s, d, seed=s + bh)
    o, lse = _forward(q, k, v, mask)
    got = attention_bwd_tiled_ref(q, k, v, o, lse, do, **mask)
    want = attention_bwd_ref(q, k, v, o, lse, do, **mask)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.bfloat16
        top = float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), rtol=2e-2,
                                   atol=2e-2 * top)


def _jax_cfg(h, kv, d, mask):
    cfg = jax_smoke("qwen2.5-3b", layers=1)
    return dataclasses.replace(
        cfg, num_heads=h, num_kv_heads=kv, head_dim=d,
        causal=mask.get("causal", True), prefix_tokens=mask.get("prefix", 0),
        window=mask.get("window", 0))


@pytest.mark.parametrize("mask", MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("h,kv,d", [(4, 4, 32), (8, 2, 32), (8, 1, 256),
                                    (18, 2, 32), (16, 1, 32)],
                         ids=["group1", "group4", "d256-group8", "group9",
                              "group16"])
def test_tiled_model_matches_jax_vjp(h, kv, d, mask):
    """The model against ``jax.vjp`` of the reference's model attention
    (src/repro/models/layers.py, ``_sdpa_chunked``) on the same bf16
    values, one batch row, heads laid out as the port lays them out (row
    ``h`` of (H, S, d))."""
    s = 150
    q, k, v, do = _inputs(h, kv, s, d, seed=h + kv)
    o, lse = _forward(q, k, v, mask)
    got = attention_bwd_tiled_ref(q, k, v, o, lse, do, **mask)

    def bshd(t):   # (H, S, d) -> (1, S, H, d), float32 of the bf16 values
        return jnp.asarray(t.float().numpy().transpose(1, 0, 2)[None])
    pos = jnp.arange(s, dtype=jnp.int32)
    cfg = _jax_cfg(h, kv, d, mask)
    out, vjp = jax.vjp(lambda a, b, c: JL._sdpa_chunked(a, b, c, pos, pos,
                                                        cfg),
                       bshd(q), bshd(k), bshd(v))
    want = vjp(bshd(do).astype(out.dtype))
    for g, w in zip(got, want):
        w = torch.from_numpy(np.array(w, np.float32)[0].transpose(1, 0, 2))
        top = float(w.abs().max())
        torch.testing.assert_close(g.float(), w, rtol=0, atol=3e-2 * top)


def _plain_attention(q, k, v, mask):
    """Attention in the inputs' dtype throughout, k and v repeated per
    query row: in bf16 the plain bf16 path of FlashAttention's standard,
    in float64 its oracle."""
    bh, s, d = q.shape
    group = bh // k.shape[0]
    k, v = k.repeat_interleave(group, 0), v.repeat_interleave(group, 0)
    pos = torch.arange(s)
    logits = torch.einsum("bqd,bkd->bqk", q, k) * d ** -0.5
    p = torch.softmax(torch.where(visible(pos, pos, **mask)[None], logits,
                                  -1e30), dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v)


@pytest.mark.parametrize("mask", MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("bh,kv,d", [(4, 4, 64), (8, 2, 64), (8, 1, 256),
                                     (18, 2, 64), (16, 1, 64)],
                         ids=["group1", "group4", "d256-group8", "group9",
                              "group16"])
def test_tiled_model_holds_the_flashattention_standard(bh, kv, d, mask):
    """The model's dq, dk and dv (on the forward's bf16 o, as the kernels
    get it) each at most 2x, plus 1e-3, the max error of the plain bf16
    path against a float64 autograd oracle."""
    q, k, v, do = _inputs(bh, kv, 150, d, seed=7 * bh + kv)
    o, lse = _forward(q, k, v, mask)
    got = attention_bwd_tiled_ref(q, k, v, o, lse, do, **mask)
    grads = {}
    for dtype in (torch.float64, torch.bfloat16):
        leaves = [t.detach().to(dtype).requires_grad_(True)
                  for t in (q, k, v)]
        _plain_attention(*leaves, mask).backward(do.to(dtype))
        grads[dtype] = [t.grad.double() for t in leaves]
    for label, g, oracle, plain in zip("qkv", got, grads[torch.float64],
                                       grads[torch.bfloat16]):
        err = float((g.double() - oracle).abs().max())
        base = float((plain - oracle).abs().max())
        assert err <= 2 * base + 1e-3, (label, err, base)


@pytest.mark.parametrize("d,want", [(16, "mma_sync"), (32, "mma_sync"),
                                    (64, "wgmma"), (80, "wgmma"),
                                    (128, "wgmma"), (256, "wgmma")])
def test_backward_variant_by_head_dim(d, want):
    """bf16 at head dims 64, 80, 128 and 256 takes the ``wgmma`` kernels,
    16 and 32 the ``mma.sync`` ones; `check_backward` agrees."""
    assert fa.bwd_variant(torch.bfloat16, d) == want
    fa.check_backward(torch.zeros(1, 1, d, dtype=torch.bfloat16))


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64),
                                     (torch.float32, 256),
                                     (torch.bfloat16, 48)])
def test_backward_variant_refuses_what_no_kernel_takes(dtype, d):
    """float32 (ROADMAP A8.5c), at paligemma-3b's head dim 256 too, and a
    head dim no kernel is built for raise before any work."""
    with pytest.raises(NotImplementedError, match="A8.5c"):
        fa.bwd_variant(dtype, d)


def test_backward_launches_are_for_the_card():
    """`backward_launches` sets up kernel launches only: a CPU tensor
    raises before any work and counts nothing, while `flash_attention_bwd`
    on the same tensors runs the plain version."""
    q, k, v, do = _inputs(4, 2, 20, 64, seed=0)
    o, lse = _forward(q, k, v, {})
    def counts():
        return (dict(fa.launches_bwd), dict(fa.launches_bwd_by_variant),
                dict(fa.launches_bwd_by_group), fa.launches_bwd_windowed)
    before = counts()
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa.backward_launches(q, k, v, o, lse, do, window=8)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    for g, w in zip(got, attention_bwd_ref(q, k, v, o, lse, do)):
        torch.testing.assert_close(g, w)
    assert counts() == before
