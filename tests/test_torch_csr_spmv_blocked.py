"""PyTorch port: the CUDA SpMV's partition, modelled on the CPU.

`repro_torch.kernels.csr_spmv.ref.csr_spmv_blocked_ref` computes the
pull SpMV through the kernel's own partition: equal shares of the merged
sequence of row ends and edges a block (`block_ranges`), steps of
``tile`` items inside a block, rows cut at share and step boundaries,
and the parts of a row cut between blocks added in block order. It is
held to the JAX oracle (`repro.kernels.csr_spmv.ref`) and to the Pallas
kernel in interpret mode at rtol 1e-5 / atol 1e-4 (tests/test_csr_spmv.py)
on the same cases as tests/test_torch_csr_spmv.py, with shares of 4, 16
and 33 items so that most rows are cut, and on a hub row that crosses
more than 10 shares. The CUDA kernel is held to the same model on the
card (tests/test_torch_cuda.py).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.algos.graph_arrays import to_device as jax_upload  # noqa: E402
from repro.core.csr import from_edges  # noqa: E402
from repro.core.generators import powerlaw_community, rmat  # noqa: E402
from repro.kernels.csr_spmv.csr_spmv import (DST_TILE, csr_spmv_pallas,  # noqa: E402
                                             pack_edges)
from repro.kernels.csr_spmv.ref import csr_spmv_ref as jax_ref  # noqa: E402
from repro_torch.kernels.csr_spmv.ref import (block_ranges,  # noqa: E402
                                              csr_spmv_blocked_ref,
                                              csr_spmv_ref)

TOL = dict(rtol=1e-5, atol=1e-4)
SHARES = (4, 16, 33)        # merge items a block
TILE = 8                    # items a step, so steps cut rows too


def _in_csr(g):
    t = g.transpose
    return np.asarray(t.indptr, np.int32), np.asarray(t.indices, np.int32)


def _hub():
    """Vertex 0 takes 400 in-edges; the others a few each."""
    rng = np.random.default_rng(6)
    n = 60
    src = np.concatenate([rng.integers(0, n, 400), rng.integers(0, n, 90)])
    dst = np.concatenate([np.zeros(400, np.int64), rng.integers(1, n, 90)])
    return from_edges(n, src, dst)


def _case(name):
    """(t_indptr, t_indices, weights, x) as numpy, seeded."""
    rng = np.random.default_rng(0)
    weights = None
    if name.startswith("ragged"):
        g = {"ragged_plc": lambda: powerlaw_community(1500, avg_degree=6,
                                                      seed=0),
             "ragged_dense": lambda: powerlaw_community(700, avg_degree=20,
                                                        seed=1),
             "ragged_rmat": lambda: rmat(scale=9, edge_factor=4,
                                         seed=2)}[name]()
        ip, ix = _in_csr(g)
        weights = rng.random(len(ix)).astype(np.float32)
    elif name == "empty_rows":
        ip, ix = _in_csr(from_edges(DST_TILE + 88, [0, 1, 2],
                                    [5, 5, DST_TILE + 3]))
    elif name == "no_edges":
        ip, ix = _in_csr(from_edges(17, np.array([], np.int64),
                                    np.array([], np.int64)))
    elif name == "parallel_edges":
        ip, ix = _in_csr(from_edges(7, [0, 1, 2, 6, 6], [3, 3, 3, 0, 0]))
    elif name == "sentinels":
        g = powerlaw_community(600, avg_degree=8.0, seed=11)
        up = jax_upload(g, pad_to=(1024, 8192))
        ip = np.asarray(up.t_indptr, np.int32)
        ix = np.asarray(up.t_indices, np.int32)
        weights = np.asarray(up.edge_valid, np.float32)
    elif name == "hub":
        ip, ix = _in_csr(_hub())
        weights = rng.random(len(ix)).astype(np.float32)
    else:
        raise KeyError(name)
    x = rng.standard_normal(len(ip) - 1).astype(np.float32)
    w = np.ones(len(ix), np.float32) if weights is None else weights
    return ip.copy(), ix.copy(), w, x


CASES = ("ragged_plc", "ragged_dense", "ragged_rmat", "empty_rows",
         "no_edges", "parallel_edges", "sentinels", "hub")
_references: dict[str, tuple] = {}


def _references_of(name):
    """The JAX oracle and the interpret-mode Pallas kernel, once a case."""
    if name not in _references:
        ip, ix, w, x = _case(name)
        oracle = np.asarray(jax_ref(jnp.asarray(ip), jnp.asarray(ix),
                                    jnp.asarray(w), jnp.asarray(x)))
        src, dst_local, val, bpt, ntiles, n_pad = pack_edges(ip, ix, w)
        pallas = np.asarray(csr_spmv_pallas(
            jnp.asarray(src), jnp.asarray(dst_local), jnp.asarray(val),
            jnp.asarray(x), blocks_per_tile=bpt, num_tiles=ntiles,
            n_pad=n_pad, interpret=True))
        _references[name] = (oracle, pallas)
    return _references[name]


def _blocks(ip, items):
    n = len(ip) - 1
    return max(1, -(-(n + int(ip[-1]) - int(ip[0])) // items))


@pytest.mark.parametrize("items", SHARES)
@pytest.mark.parametrize("name", CASES)
def test_blocked_model_matches_reference(name, items):
    ip, ix, w, x = _case(name)
    tip, tix, tw, tx = map(torch.from_numpy, (ip, ix, w, x))
    got = csr_spmv_blocked_ref(tip, tix, tw, tx, _blocks(ip, items), TILE)
    assert got.dtype == torch.float32 and got.shape == (len(ip) - 1,)
    oracle, pallas = _references_of(name)
    np.testing.assert_allclose(got.numpy(), oracle, **TOL)
    np.testing.assert_allclose(got.numpy(), pallas, **TOL)
    # and the plain version the wrapper runs on the CPU
    np.testing.assert_allclose(got.numpy(),
                               csr_spmv_ref(tip, tix, tw, tx).numpy(), **TOL)


@pytest.mark.parametrize("items", SHARES)
def test_hub_crosses_more_than_ten_shares(items):
    ip, ix, w, x = _case("hub")
    begin, end = int(ip[0]), int(ip[1])    # vertex 0's in-edges
    ranges = block_ranges(torch.from_numpy(ip), _blocks(ip, items))
    crossed = [b for b, (lo, hi, _, _) in enumerate(ranges)
               if lo < end and hi > begin]
    assert len(crossed) > 10
    got = csr_spmv_blocked_ref(*map(torch.from_numpy, (ip, ix, w, x)),
                               _blocks(ip, items), TILE)
    want = (w[begin:end].astype(np.float64) * x[ix[begin:end]]).sum()
    np.testing.assert_allclose(float(got[0]), want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("blocks", [1, 3, 264, 5000])
@pytest.mark.parametrize("name", ["ragged_rmat", "empty_rows", "no_edges",
                                  "sentinels"])
def test_block_ranges_cut_the_merge_evenly(name, blocks):
    """The shares tile the edges and the rows without a gap, their sizes
    differ by one item at most, and each block's rows end inside its
    edges: no later than ``hi``, and no earlier than ``lo``."""
    ip = torch.from_numpy(_case(name)[0])
    ranges = block_ranges(ip, blocks)
    n = ip.numel() - 1
    assert ranges[0][0] == int(ip[0]) and ranges[0][2] == 0
    assert ranges[-1][1] == int(ip[-1]) and ranges[-1][3] == n
    sizes = [hi - lo + last - first for lo, hi, first, last in ranges]
    assert max(sizes) - min(sizes) <= 1
    for (lo, hi, first, last), nxt in zip(ranges, ranges[1:] + [None]):
        if nxt is not None:
            assert (hi, last) == (nxt[0], nxt[2])
        ends = ip[first + 1:last + 1]
        assert bool((ends <= hi).all())
        if first < last and first > 0:
            # the first row's end is past the previous block's last edge
            assert int(ends[0]) >= lo


def test_blocked_model_refuses_bad_sizes():
    ip, ix, w, x = map(torch.from_numpy, _case("parallel_edges"))
    with pytest.raises(ValueError, match="blocks"):
        block_ranges(ip, 0)
    with pytest.raises(ValueError, match="tile"):
        csr_spmv_blocked_ref(ip, ix, w, x, 2, 0)
