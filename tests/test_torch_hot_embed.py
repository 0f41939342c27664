"""PyTorch port: the hot/cold embedding gather agrees with the JAX package.

The same numpy ids and tables go through the JAX package's Pallas kernel
(``hot_gather_pallas`` / ``hot_cold_lookup(use_pallas=True)``, run in
interpret mode as ``tests/test_kernels.py`` runs it) and through the
port's `hot_cold_lookup` on the CPU, which runs the kernel's plain
version. Every row is a copy, so the two must be equal bit for bit.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.hot_embed.hot_embed import hot_gather_pallas  # noqa: E402
from repro.kernels.hot_embed.ops import \
    hot_cold_lookup as jax_lookup  # noqa: E402
from repro_torch.kernels.hot_embed import hot_embed as th  # noqa: E402
from repro_torch.kernels.hot_embed.ops import hot_cold_lookup  # noqa: E402
from repro_torch.kernels.hot_embed.ref import embed_ref  # noqa: E402


def _table(vocab: int, d: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (vocab, d)).astype(np.float32)


@pytest.mark.parametrize("vocab,hot,ids_shape", [
    (1000, 128, (4, 100)), (4096, 512, (512,)), (600, 600, (2, 7)),
])
def test_lookup_equals_the_reference_kernel(vocab, hot, ids_shape):
    """The cases of tests/test_kernels.py:142-152, exact."""
    table = _table(vocab, 32)
    ids = np.random.default_rng(0).integers(0, vocab, ids_shape).astype(
        np.int32)
    want = np.asarray(jax_lookup(jnp.asarray(ids), jnp.asarray(table), hot,
                                 use_pallas=True, interpret=True))
    launches = th.launches
    got = hot_cold_lookup(torch.from_numpy(ids), torch.from_numpy(table), hot)
    assert th.launches == launches  # the CPU runs the plain version
    assert got.shape == (*ids_shape, 32) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), table[ids])


@pytest.mark.parametrize("case", ["all_hot", "all_cold", "hot_is_vocab",
                                  "one_hot_row"])
def test_lookup_edge_cases(case):
    """All-hot ids (tests/test_kernels.py:155-162), all-cold ids, a slab
    that is the whole table, and a one-row slab: exact."""
    vocab, d = 64, 8
    table = np.arange(vocab * d, dtype=np.float32).reshape(vocab, d)
    ids, hot = {
        "all_hot": (np.arange(16), 32),
        "all_cold": (np.arange(32, 64)[::-1], 32),
        "hot_is_vocab": (np.array([0, 63, 5, 63, 1]), 64),
        "one_hot_row": (np.array([0, 1, 0, 63, 2]), 1),
    }[case]
    ids = ids.astype(np.int32)
    want = np.asarray(jax_lookup(jnp.asarray(ids), jnp.asarray(table), hot,
                                 use_pallas=True, interpret=True))
    got = hot_cold_lookup(torch.from_numpy(ids), torch.from_numpy(table), hot)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), table[ids])


def test_plain_gather_equals_the_pallas_kernel():
    """`hot_gather` on the CPU (the kernel's plain version) against
    ``hot_gather_pallas`` itself: hot rows copied, cold rows zero."""
    table = _table(900, 24, seed=3)
    ids = np.random.default_rng(3).integers(0, 900, 1024).astype(np.int32)
    slab = table[:100]
    want = np.asarray(hot_gather_pallas(jnp.asarray(ids), jnp.asarray(slab),
                                        interpret=True))
    got = th.hot_gather(torch.from_numpy(ids), torch.from_numpy(slab))
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[torch.from_numpy(ids >= 100)].any()
    np.testing.assert_array_equal(
        embed_ref(torch.from_numpy(ids), torch.from_numpy(table)).numpy(),
        table[ids])


def test_gather_checks_its_operands():
    """What the CUDA kernel does not take is refused before a launch."""
    ids = torch.zeros(4, dtype=torch.int32)
    slab = torch.zeros(8, 4)
    th._check(ids, slab)
    with pytest.raises(TypeError, match="int32"):
        th._check(ids.long(), slab)
    with pytest.raises(TypeError, match="float32"):
        th._check(ids, slab.double())
    with pytest.raises(ValueError, match="1-D"):
        th._check(ids.reshape(2, 2), slab)
    with pytest.raises(ValueError, match=r"\(H, D\)"):
        th._check(ids, slab.t())
    with pytest.raises(ValueError, match="runs on cpu or cuda"):
        th.hot_gather(ids.to("meta"), slab.to("meta"))
