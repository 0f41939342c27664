"""PyTorch port: the grouped matmul agrees with the JAX package.

The same numpy operands go through the JAX package's Pallas kernel
(``gmm_pallas``, run in interpret mode as ``tests/test_kernels.py`` runs
it) or ``jax.lax.ragged_dot`` (what the reference's expert FFN calls),
and through the port's wrappers on the CPU, which run the kernel's plain
version. Tolerances: float32 at the reference test's rtol/atol 1e-4 (the
same products summed in another order); bf16 within one bf16 unit of the
reference's value (both sum exact products in float32 and round once, and
two sums taken in different orders may round to neighbouring values).
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
                                             gmm_ref)

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
