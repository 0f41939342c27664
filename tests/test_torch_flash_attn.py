"""PyTorch port: causal attention agrees with the JAX package's flash kernel.

The same numpy q, k, v go through the JAX package's Pallas kernel
(``flash_attention_pallas``, run in interpret mode as
``tests/test_kernels.py:61-103`` runs it) and through the port's
`flash_attention` on the CPU, which runs the kernel's plain version
(`attention_ref`). The tolerances are the reference test's: float32 at
rtol 1e-3 / atol 2e-3 (the online softmax sums in another order), bf16
at 5e-2. Grouped-query cases give the Pallas kernel, which takes equal
heads only, k and v repeated per query row.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attn.flash_attn import \
    flash_attention_pallas  # noqa: E402
from repro.kernels.flash_attn.ref import \
    attention_ref as jax_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attn import flash_attn as tf  # noqa: E402
from repro_torch.kernels.flash_attn.ops import causal_attention  # noqa: E402
from repro_torch.kernels.flash_attn.ref import attention_ref  # noqa: E402

F32_TOL = dict(rtol=1e-3, atol=2e-3)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("bh,s,d", [(2, 256, 64), (1, 512, 128), (3, 256, 32)])
@pytest.mark.parametrize("window", [0, 128])
def test_matches_the_pallas_kernel(bh, s, d, window):
    q, k, v = _qkv((bh, s, d), 42)
    want = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=window,
        interpret=True))
    launches = tf.launches
    got = tf.flash_attention(*map(torch.from_numpy, (q, k, v)), window=window)
    assert tf.launches == launches  # the CPU runs the plain version
    assert got.dtype == torch.float32 and got.shape == (bh, s, d)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_bf16_matches_the_pallas_kernel():
    rng = np.random.default_rng(7)
    arrs = [rng.standard_normal((2, 256, 64)) for _ in range(3)]
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    want = np.asarray(flash_attention_pallas(jq, jk, jv, interpret=True),
                      np.float32)
    tq, tk, tv = (torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
                  for a in (jq, jk, jv))
    got = causal_attention(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("s,window", [(256, 0), (512, 128)])
def test_grouped_query_matches_the_pallas_kernel(group, s, window):
    """Grouped-query attention: 8 query rows, 8 / group kv rows. The
    Pallas kernel takes equal heads only, so it gets k and v repeated per
    query row; the port's `flash_attention` (its plain version here) takes
    the grouped k and v as they are. The reference test's float32
    tolerance."""
    bh, d = 8, 64
    rng = np.random.default_rng(group * 1000 + s)
    q = rng.standard_normal((bh, s, d)).astype(np.float32)
    k, v = (rng.standard_normal((bh // group, s, d)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(flash_attention_pallas(
        jnp.asarray(q), jnp.asarray(np.repeat(k, group, axis=0)),
        jnp.asarray(np.repeat(v, group, axis=0)), window=window,
        interpret=True))
    got = tf.flash_attention(*map(torch.from_numpy, (q, k, v)),
                             window=window)
    assert got.shape == (bh, s, d)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    via_ops = causal_attention(*map(torch.from_numpy, (q, k, v)),
                               window=window)
    assert torch.equal(via_ops, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [256, 512])
def test_head_dim_256_over_one_kv_row_matches_the_pallas_kernel(s, dtype):
    """paligemma-3b's attention shape, which the card runs through the
    Hopper kernel's 64-key tiles: 8 query rows over 1 kv row at head dim
    256, causal. The Pallas kernel gets k and v repeated per query row;
    the port's `flash_attention` (its plain version here) takes the one
    kv row. The reference test's tolerances: float32 at rtol 1e-3 / atol
    2e-3, bf16 at 5e-2."""
    bh, d = 8, 256
    rng = np.random.default_rng(s + 256)
    q = rng.standard_normal((bh, s, d)).astype(np.float32)
    k, v = (rng.standard_normal((1, s, d)).astype(np.float32)
            for _ in range(2))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    want = np.asarray(flash_attention_pallas(
        jq, jnp.repeat(jk, bh, axis=0), jnp.repeat(jv, bh, axis=0),
        interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(np.array(a, np.float32)).to(
        getattr(torch, dtype)) for a in (jq, jk, jv))
    launches = tf.launches
    got = tf.flash_attention(tq, tk, tv)
    assert tf.launches == launches  # the CPU runs the plain version
    assert got.dtype == tq.dtype and got.shape == (bh, s, d)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got.float().numpy(), want, **tol)


def test_kernel_takes_grouped_kv_and_refuses_the_rest():
    """k and v of (BH / group, S, d) for a whole group are taken (the
    group is BH / k.shape[0]); a kv count that does not divide BH, more
    kv rows than query rows, or k and v of different shapes are
    refused."""
    q = torch.zeros(8, 40, 64)
    for kvh in (8, 4, 2, 1):
        kv = torch.zeros(kvh, 40, 64)
        tf._check(q, kv, kv.clone())
        assert tf.kv_group(q, kv, kv) == 8 // kvh
    for kvh in (3, 5, 16):
        kv = torch.zeros(kvh, 40, 64)
        with pytest.raises(ValueError, match="BH / group"):
            tf._check(q, kv, kv)
    with pytest.raises(ValueError, match="shape"):
        tf._check(q, torch.zeros(2, 40, 64), torch.zeros(4, 40, 64))
    with pytest.raises(ValueError, match="BH / group"):
        tf._check(q, torch.zeros(2, 40, 32), torch.zeros(2, 40, 32))
    empty = torch.zeros(0, 40, 64)
    assert tf.kv_group(empty, empty, empty) == 1


@pytest.mark.parametrize("s,window,sm_scale", [(300, 0, None), (77, 16, 0.3)])
def test_any_length_matches_the_plain_reference(s, window, sm_scale):
    """A length that is no multiple of 256, which the Pallas kernel does
    not take: the port's plain version against the JAX package's, rtol
    1e-5 (the same float32 arithmetic, summed in another order)."""
    q, k, v = _qkv((2, s, 32), s)
    want = np.asarray(jax_attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sm_scale=sm_scale,
        window=window))
    got = attention_ref(*map(torch.from_numpy, (q, k, v)), sm_scale=sm_scale,
                        window=window)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_causality():
    """Future tokens must not influence the output
    (tests/test_kernels.py:89-103)."""
    q, k, v = _qkv((1, 256, 32), 3)
    o1 = causal_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    k[:, 200:], v[:, 200:] = 99.0, -99.0   # corrupt the future
    o2 = causal_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    np.testing.assert_allclose(o1[:, :200], o2[:, :200], rtol=1e-5, atol=1e-5)


def test_kernel_checks_its_operands():
    """What the CUDA kernels do not take is refused before a launch."""
    q = torch.zeros(2, 40, 64)
    tf._check(q, q.clone(), q.clone())
    tf._check(q.bfloat16(), q.bfloat16(), q.bfloat16())
    with pytest.raises(ValueError, match="head dim 48"):
        z = torch.zeros(2, 40, 48)
        tf._check(z, z, z)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tf._check(q.half(), q.half(), q.half())
    with pytest.raises(TypeError, match="k is"):
        tf._check(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="shape"):
        tf._check(q, q[:, :30].contiguous(), q)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros(2, 64, 40).transpose(1, 2)
        tf._check(t, t, t)
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        m = q.to("meta")
        tf.flash_attention(m, m, m)


@pytest.mark.parametrize("dtype,head_dim,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 16, "mma_sync"), (torch.bfloat16, 32, "mma_sync"),
    (torch.float32, 16, "simt"), (torch.float32, 32, "simt"),
    (torch.float32, 64, "simt"), (torch.float32, 128, "simt"),
    (torch.bfloat16, 80, "wgmma"), (torch.bfloat16, 256, "wgmma")])
def test_variant_follows_dtype_and_head_dim(dtype, head_dim, want):
    """The served bf16 head dims (64, 80, 128 and paligemma-3b's 256) take
    the Hopper kernel, the other bf16 ones the mma.sync kernel, float32
    the SIMT one (at 16, 32, 64 and 128 only); each is a named variant
    with its own launch count, and the CPU counts none."""
    assert tf.variant(dtype, head_dim) == want
    assert set(tf.launches_by_variant) == set(tf.VARIANTS)
    before = dict(tf.launches_by_variant)
    q = torch.zeros(1, 8, head_dim, dtype=dtype)
    tf.flash_attention(q, q, q)
    assert tf.launches_by_variant == before


@pytest.mark.parametrize("dtype,head_dim,error", [
    (torch.bfloat16, 48, ValueError), (torch.float32, 256, ValueError),
    (torch.float16, 64, TypeError), (torch.float32, 80, ValueError)])
def test_variant_refuses_what_no_kernel_takes(dtype, head_dim, error):
    with pytest.raises(error):
        tf.variant(dtype, head_dim)
