"""PyTorch port: the grouped matmul agrees with the JAX package.

The same numpy operands go through the JAX package's Pallas kernel
(``gmm_pallas``, run in interpret mode as ``tests/test_kernels.py`` runs
it) or ``jax.lax.ragged_dot`` (what the reference's expert FFN calls),
and through the port's wrappers on the CPU, which run the kernel's plain
version. Tolerances: float32 at the reference test's rtol/atol 1e-4 (the
same products summed in another order); bf16 within one bf16 unit of the
reference's value (both sum exact products in float32 and round once, and
two sums taken in different orders may round to neighbouring values).
The card's variant rule (`moe_gmm.variant`, a function of the shapes
alone) and the split-K variant's order of summation (`gmm_splitk_ref`,
held to both references at the float32 tolerance) are tested here too.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.moe_gmm import moe_gmm as J  # noqa: E402
from repro.kernels.moe_gmm.ref import gmm_ref as jax_gmm_ref  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm as T  # noqa: E402
from repro_torch.kernels.moe_gmm.ops import (grouped_matmul,  # noqa: E402
                                             ragged_dot)
from repro_torch.kernels.moe_gmm.ref import (gmm_grouped_ref,  # noqa: E402
                                             gmm_ref, gmm_splitk_ref)

TOL = dict(rtol=1e-4, atol=1e-4)   # tests/test_kernels.py:121


def _operands(gs, k, n, seed):
    offs, tile_expert, total = J.pad_groups(np.array(gs))
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((total, k)).astype(np.float32)
    w = (0.1 * rng.standard_normal((len(gs), k, n))).astype(np.float32)
    return x, w, tile_expert


@pytest.mark.parametrize("gs,k,n,seed", [
    ([128, 128, 128, 128], 128, 256, 0),
    ([100, 30, 0, 128], 128, 256, 0),
    ([0, 0, 5, 1], 128, 256, 0),
    ([512, 0, 0, 0], 128, 256, 0),
    ([128, 128], 384, 128, 1),          # test_gmm_k_accumulation
])
def test_grouped_matmul_matches_the_reference_kernel(gs, k, n, seed):
    """The cases of tests/test_kernels.py:106-138 through `grouped_matmul`
    and the per-row oracle, against ``gmm_pallas(interpret=True)``."""
    x, w, te = _operands(gs, k, n, seed)
    want = np.asarray(J.gmm_pallas(jnp.asarray(x), jnp.asarray(w),
                                   jnp.asarray(te), interpret=True))
    launches = T.launches
    got = grouped_matmul(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(te))
    assert T.launches == launches   # the CPU runs the plain version
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    rows = np.repeat(te, T.TILE_M)
    oracle = gmm_ref(torch.from_numpy(x), torch.from_numpy(w),
                     torch.from_numpy(rows))
    np.testing.assert_allclose(oracle.numpy(), want, **TOL)
    np.testing.assert_allclose(
        oracle.numpy(), np.asarray(jax_gmm_ref(jnp.asarray(x), jnp.asarray(w),
                                               jnp.asarray(rows))), **TOL)


def _bf16(a: np.ndarray):
    j = jnp.asarray(a, jnp.bfloat16)
    return j, torch.from_numpy(np.asarray(j, np.float32)).bfloat16()


def _within_one_bf16_unit(got: torch.Tensor, want) -> None:
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    mag = np.maximum(np.abs(w), np.finfo(np.float32).tiny)
    unit = 2.0 ** (np.floor(np.log2(mag)) - 7)   # bf16: 8 significant bits
    assert np.all(np.abs(g - w) <= unit), float(np.abs(g - w).max())


@pytest.mark.parametrize("sizes,m,k,n", [
    ([3, 0, 5, 2], 10, 64, 128),        # the smoke widths, a zero group
    ([0, 0, 7, 0], 12, 64, 128),        # rows past the total: zeros
    ([17, 40, 1, 0, 6], 64, 128, 64),   # the smoke down projection
    ([0, 0, 0], 5, 16, 8),              # no rows in any group
    ([200, 0, 56], 256, 40, 24),        # K, N multiples of 8, not of 16
])
def test_ragged_dot_matches_jax(sizes, m, k, n):
    rng = np.random.default_rng(sum(sizes) + m)
    jx, tx = _bf16(rng.standard_normal((m, k)))
    jw, tw = _bf16(0.2 * rng.standard_normal((len(sizes), k, n)))
    gs = np.array(sizes, np.int32)
    want = jax.lax.ragged_dot(jx, jw, jnp.asarray(gs))
    assert want.dtype == jnp.bfloat16
    got = ragged_dot(tx, tw, torch.from_numpy(gs))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    _within_one_bf16_unit(got, want)
    assert not got[int(gs.sum()):].any()
    f32 = ragged_dot(tx.float(), tw.float(), torch.from_numpy(gs))
    np.testing.assert_allclose(
        f32.numpy(), np.asarray(jax.lax.ragged_dot(
            jx.astype(jnp.float32), jw.astype(jnp.float32),
            jnp.asarray(gs))), **TOL)


def test_offsets_contract_matches_the_per_row_oracle():
    """`gmm` on (E+1,) offsets: rows of group e times ``w[e]``, rows past
    ``offs[E]`` zero, offsets past M clipped to M; bf16 operands give a
    bf16 result rounded once from the float32 sum."""
    rng = np.random.default_rng(4)
    m, k, n = 50, 32, 16
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, k, n)).astype(np.float32))
    offs = torch.tensor([0, 11, 11, 40], dtype=torch.int32)
    got = T.gmm(x, w, offs)
    row_expert = torch.repeat_interleave(torch.arange(3), torch.tensor(
        [11, 0, 29]))
    torch.testing.assert_close(got[:40], gmm_ref(x[:40], w, row_expert),
                               **TOL)
    assert not got[40:].any()
    clipped = T.gmm(x[:30], w, offs)
    torch.testing.assert_close(clipped, got[:30])
    xb, wb = x.bfloat16(), w.bfloat16()
    half = T.gmm(xb, wb, offs, out_dtype=torch.bfloat16)
    assert half.dtype == torch.bfloat16
    assert torch.equal(half, gmm_grouped_ref(xb, wb, offs).bfloat16())


@pytest.mark.parametrize("sizes", [
    [128, 0, 300, 1], [0, 0, 0], [], [5], [127, 129, 256]])
def test_pad_groups_equals_the_reference(sizes):
    gs = np.array(sizes, np.int64)
    want, got = J.pad_groups(gs), T.pad_groups(gs)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == want[1].dtype and got[2] == want[2]


def test_grouped_matmul_refuses_a_bad_tile_map():
    x = torch.zeros(256, 16)
    w = torch.zeros(2, 16, 8)
    with pytest.raises(ValueError, match="nondecreasing"):
        grouped_matmul(x, w, torch.tensor([1, 0], dtype=torch.int32))
    with pytest.raises(ValueError, match="nondecreasing"):
        grouped_matmul(x, w, torch.tensor([0, 2], dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple of 128"):
        grouped_matmul(x[:200], w, torch.tensor([0], dtype=torch.int32))


# ------------------------------------------------ the card's variant rule
# `moe_gmm.variant` picks the bf16 kernel on the card from (M, E, K, N)
# alone; these tests need no card.
SHAPES = [(2048, 1408), (1408, 2048), (64, 128), (136, 200)]


@pytest.mark.parametrize("e", [1, 4, 8, 64])
@pytest.mark.parametrize("k,n", SHAPES)
def test_variant_rule_is_monotone_in_m(e, k, n):
    picks = [T.variant(m, e, k, n) for m in range(0, 64 * e + 2)]
    picks += [T.variant(m, e, k, n) for m in (10_000, 196_608, 2**30)]
    assert set(picks) <= {"wgmma", "splitk"}
    first = picks.index("wgmma")
    assert all(p == "splitk" for p in picks[:first])
    assert all(p == "wgmma" for p in picks[first:])


@pytest.mark.parametrize("k,n", [(2048, 1408), (1408, 2048)])
def test_variant_rule_at_the_served_shapes(k, n):
    """moonshot-v1-16b-a3b: a decode step's 24 rows (4 slots x top-6)
    over 64 experts take split-K; the 32,768-token prefill's 196,608
    rows take wgmma."""
    assert T.variant(24, 64, k, n) == "splitk"
    assert T.variant(196_608, 64, k, n) == "wgmma"


def test_variant_rule_reads_no_tensor(monkeypatch):
    """The rule and the split-K plan take shapes only: with every way of
    reading a tensor's values poisoned, they still answer."""
    def poisoned(*args, **kwargs):
        raise AssertionError("the variant rule read a tensor")
    for name in ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
                 "__index__", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, poisoned)
    for m in (0, 1, 24, 512, 513, 4096, 196_608):
        for e in (1, 64):
            for k, n in SHAPES:
                assert T.variant(m, e, k, n) in ("wgmma", "splitk")
                chunks, kc = T.splitk_plan(m, e, k, n)
                assert chunks >= 1 and kc % 8 == 0


@pytest.mark.parametrize("m,e", [(1, 64), (24, 64), (24, 4), (512, 64),
                                 (1000, 64), (196_608, 64), (300, 3)])
@pytest.mark.parametrize("k,n", SHAPES + [(8, 8), (40, 24)])
def test_splitk_plan_covers_k_in_one_cluster(m, e, k, n):
    """K chunks of a multiple of 8 rows, none empty, at least 64 rows each
    when there are several, and at most 8: the chunks of one column tile
    form one portable thread-block cluster."""
    chunks, kc = T.splitk_plan(m, e, k, n)
    assert kc % 8 == 0 and kc > 0
    assert (chunks - 1) * kc < k <= chunks * kc   # no empty chunk
    assert 1 <= chunks <= T.SPLITK_MAX_CHUNKS == 8
    if chunks > 1:
        assert kc >= 64


def test_splitk_plan_at_the_decode_step():
    """24 rows over 64 experts: K is split, as far as the blocks of the
    (at most 24) used experts' 11 or 16 column tiles stay within one
    resident wave, `SPLITK_SLOTS`."""
    for k, n in ((2048, 1408), (1408, 2048)):
        chunks, kc = T.splitk_plan(24, 64, k, n)
        assert chunks > 1
        blocks = 24 * (n // 128) * chunks
        assert blocks <= T.SPLITK_SLOTS < blocks + 24 * (n // 128)


@pytest.mark.parametrize("sizes,m,k,n", [
    ([3, 0, 5, 2], 10, 64, 128),
    ([0, 0, 7, 0], 12, 2048, 64),       # rows past offs[E]: zeros
    ([1, 0, 0, 0], 1, 1408, 128),       # M = 1
    ([50, 100, 78], 228, 136, 200),     # K % 64, N % 128, a tile boundary
    ([0, 0, 0], 5, 16, 8),
])
def test_splitk_order_matches_the_references(sizes, m, k, n):
    """The split-K variant's order (K chunks of `splitk_plan` summed in
    float32, added in order, rounded once) against the one-matmul-a-group
    plain version and the JAX package's per-row oracle, at TOL."""
    rng = np.random.default_rng(m + k + n)
    jx, tx = _bf16(rng.standard_normal((m, k)))
    jw, tw = _bf16(k ** -0.5 * rng.standard_normal((len(sizes), k, n)))
    offs = torch.tensor(np.concatenate([[0], np.cumsum(sizes)]),
                        dtype=torch.int32)
    chunks, kc = T.splitk_plan(m, len(sizes), k, n)
    got = gmm_splitk_ref(tx, tw, offs, kc)
    assert got.dtype == torch.float32 and got.shape == (m, n)
    torch.testing.assert_close(got, gmm_grouped_ref(tx, tw, offs), **TOL)
    total = int(sum(sizes))
    assert not got[total:].any()
    rows = np.repeat(np.arange(len(sizes)), sizes).astype(np.int32)
    want = np.asarray(jax_gmm_ref(jx[:total].astype(jnp.float32),
                                  jw.astype(jnp.float32), jnp.asarray(rows)))
    np.testing.assert_allclose(got[:total].numpy(), want, **TOL)
    half = gmm_splitk_ref(tx, tw, offs, kc, torch.bfloat16)
    assert torch.equal(half, got.to(torch.bfloat16))
    if chunks > 1:   # the chunks are a real split, not one product
        assert kc < k


def test_gmm_takes_a_forced_variant_by_name_only():
    """``variant=`` names a kernel for the tests and the kernel checks; on
    the CPU the plain version runs all the same, and a name that no
    kernel has, or a bf16 variant for float32 operands, raises."""
    x = torch.ones(4, 8, dtype=torch.bfloat16)
    w = torch.ones(2, 8, 8, dtype=torch.bfloat16)
    offs = torch.tensor([0, 1, 4], dtype=torch.int32)
    launches = dict(T.launches_by_variant)
    want = T.gmm(x, w, offs)
    for v in ("wgmma", "splitk"):
        assert torch.equal(T.gmm(x, w, offs, variant=v), want)
    with pytest.raises(ValueError, match="'wgmma' or 'splitk'"):
        T.gmm(x, w, offs, variant="mma_sync")
    with pytest.raises(ValueError, match="'simt'"):
        T.gmm(x.float(), w.float(), offs, variant="wgmma")
    assert T.launches_by_variant == launches
