"""PyTorch port: the CSR SpMV of PageRank against the JAX package's.

The port's plain version (`repro_torch.kernels.csr_spmv.ref`) is what
the wrapper runs on a CPU tensor; it is held to the JAX oracle
(`repro.kernels.csr_spmv.ref`) and to the Pallas kernel in interpret
mode, at rtol 1e-5 / atol 1e-4 (tests/test_csr_spmv.py), on the same
cases: ragged rows, empty rows, no edges, sentinel edges with val=0.
PageRank through the SpMV is held to both packages' PageRank. The CUDA
kernel itself runs only where a card is present (and in chip_smoke.py).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.algos import kernels as JK  # noqa: E402
from repro.algos.graph_arrays import to_device as jax_upload  # noqa: E402
from repro.core.csr import from_edges  # noqa: E402
from repro.core.generators import powerlaw_community, rmat  # noqa: E402
from repro.kernels.csr_spmv.csr_spmv import (DST_TILE, csr_spmv_pallas,  # noqa: E402
                                             pack_edges)
from repro.kernels.csr_spmv.ref import csr_spmv_ref as jax_ref  # noqa: E402
from repro_torch.algos import kernels as TK  # noqa: E402
from repro_torch.algos.graph_arrays import from_numpy  # noqa: E402
from repro_torch.kernels.csr_spmv import csr_spmv as spmv_mod  # noqa: E402
from repro_torch.kernels.csr_spmv.ops import SpMV  # noqa: E402
from repro_torch.kernels.csr_spmv.ref import csr_spmv_ref  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-4)


def _operands(t_indptr, t_indices, weights, x):
    w = (np.ones(len(t_indices), np.float32) if weights is None
         else np.asarray(weights, np.float32))
    # private copies: torch.from_numpy wants writable arrays
    return (np.array(t_indptr, np.int32), np.array(t_indices, np.int32),
            w.copy(), np.array(x, np.float32))


def _port_vs_reference(t_indptr, t_indices, weights, x):
    """Port ref and CPU wrapper vs the JAX oracle and interpret Pallas."""
    ip, ix, w, xv = _operands(t_indptr, t_indices, weights, x)
    tip, tix, tw, tx = map(torch.from_numpy, (ip, ix, w, xv))
    got = csr_spmv_ref(tip, tix, tw, tx).numpy()
    assert got.dtype == np.float32 and got.shape == (len(ip) - 1,)
    launches = spmv_mod.launches
    np.testing.assert_array_equal(spmv_mod.csr_spmv(tip, tix, tw, tx).numpy(),
                                  got)
    assert spmv_mod.launches == launches  # a CPU tensor launches nothing
    want = np.asarray(jax_ref(jnp.asarray(ip), jnp.asarray(ix),
                              jnp.asarray(w), jnp.asarray(xv)))
    np.testing.assert_allclose(got, want, **TOL)
    src, dst_local, val, bpt, ntiles, n_pad = pack_edges(ip, ix, weights)
    pallas = np.asarray(csr_spmv_pallas(
        jnp.asarray(src), jnp.asarray(dst_local), jnp.asarray(val),
        jnp.asarray(xv), blocks_per_tile=bpt, num_tiles=ntiles,
        n_pad=n_pad, interpret=True))
    np.testing.assert_allclose(got, pallas, **TOL)
    return got


@pytest.mark.parametrize("gen,kw", [
    (powerlaw_community, dict(num_vertices=1500, avg_degree=6, seed=0)),
    (powerlaw_community, dict(num_vertices=700, avg_degree=20, seed=1)),
    (rmat, dict(scale=9, edge_factor=4, seed=2)),
])
def test_spmv_matches_reference_ragged(gen, kw):
    g = gen(**kw)
    t = g.transpose
    rng = np.random.default_rng(0)
    x = rng.standard_normal(g.num_vertices).astype(np.float32)
    w = rng.random(len(t.indices)).astype(np.float32)
    _port_vs_reference(t.indptr, t.indices, w, x)


def test_spmv_empty_rows_and_dangling_dst():
    g = from_edges(DST_TILE + 88, [0, 1, 2], [5, 5, DST_TILE + 3])
    t = g.transpose
    x = np.arange(g.num_vertices, dtype=np.float32) + 1.0
    y = _port_vs_reference(t.indptr, t.indices, None, x)
    assert y[5] == x[0] + x[1]
    assert y[DST_TILE + 3] == x[2]
    mask = np.ones(g.num_vertices, bool)
    mask[[5, DST_TILE + 3]] = False
    assert np.abs(y[mask]).sum() == 0.0


def test_spmv_no_edges():
    g = from_edges(17, np.array([], np.int64), np.array([], np.int64))
    t = g.transpose
    y = _port_vs_reference(t.indptr, t.indices, None,
                           np.ones(g.num_vertices, np.float32))
    assert np.abs(y).sum() == 0.0


def test_spmv_sub_tile_graph_parallel_edges():
    g = from_edges(7, [0, 1, 2, 6, 6], [3, 3, 3, 0, 0])
    t = g.transpose
    x = np.array([1, 2, 3, 4, 5, 6, 7], np.float32)
    y = _port_vs_reference(t.indptr, t.indices, None, x)
    assert y[3] == 6.0 and y[0] == 14.0  # parallel edges both counted


def test_spmv_sentinel_edges_contribute_zero():
    """Bucketed uploads pad the in-CSR with sentinel edges of value 0:
    the real prefix equals the unpadded product."""
    g = powerlaw_community(600, avg_degree=8.0, seed=11)
    exact = jax_upload(g)
    padded = jax_upload(g, pad_to=(1024, 8192))
    x = np.random.default_rng(3).random(1024).astype(np.float32)
    got = _port_vs_reference(padded.t_indptr, padded.t_indices,
                             np.asarray(padded.edge_valid, np.float32), x)
    want = _port_vs_reference(exact.t_indptr, exact.t_indices, None,
                              x[:g.num_vertices])
    np.testing.assert_allclose(got[:g.num_vertices], want, rtol=1e-6,
                               atol=1e-6)


def test_spmv_operator_bound_to_graph(plc_graph):
    t = plc_graph.transpose
    x = np.random.default_rng(4).random(plc_graph.num_vertices)
    op = SpMV(t.indptr, t.indices, device="cpu")
    want = np.asarray(jax_ref(jnp.asarray(t.indptr), jnp.asarray(t.indices),
                              jnp.ones(len(t.indices), jnp.float32),
                              jnp.asarray(x, jnp.float32)))
    np.testing.assert_allclose(op(x).numpy(), want, **TOL)


def test_wrapper_checks_operands():
    ip = torch.tensor([0, 1, 2], dtype=torch.int32)
    ix = torch.tensor([1, 0], dtype=torch.int32)
    val = torch.ones(2)
    x = torch.ones(2)
    assert spmv_mod._check(ip, ix, val, x) == 2
    with pytest.raises(TypeError, match="t_indices"):
        spmv_mod._check(ip, ix.long(), val, x)
    with pytest.raises(TypeError, match="x must be"):
        spmv_mod._check(ip, ix, val, x.double())
    with pytest.raises(ValueError, match="does not match"):
        spmv_mod._check(ip, ix, torch.ones(3), x)
    with pytest.raises(ValueError, match="entries for 2 rows"):
        spmv_mod._check(ip, ix, val, torch.ones(3))
    with pytest.raises(ValueError, match="contiguous"):
        spmv_mod._check(ip, ix, torch.ones(4)[::2], x)


@pytest.mark.parametrize("padded", [False, True], ids=["exact", "bucket"])
def test_pagerank_spmv_matches_both_packages(padded):
    g = powerlaw_community(800, avg_degree=8.0, seed=5)
    jg = jax_upload(g, pad_to=(1024, 16384) if padded else None)
    tg = from_numpy({k: None if v is None else np.asarray(v)
                     for k, v in jg._asdict().items()}, device="cpu")
    val = TK.spmv_values(tg)
    assert val.dtype == torch.float32 and val.shape == (tg.num_edges,)
    got = TK.pagerank_spmv(tg, val).numpy()
    # the port has one PageRank: its relaxation is the SpMV
    np.testing.assert_array_equal(TK.pagerank(tg).numpy(), got)
    # the served path runs the kernel on the real rows only
    np.testing.assert_array_equal(
        TK.pagerank_spmv(tg, val, num_rows=g.num_vertices).numpy(), got)
    if not padded:
        with pytest.raises(ValueError, match="bucketed"):
            TK.pagerank_spmv(tg, val, num_rows=g.num_vertices - 1)
    np.testing.assert_allclose(got, np.asarray(JK._pagerank(jg, 20, 0.85,
                                                            1e-6)),
                               rtol=1e-4, atol=1e-7)
    w = None if jg.edge_valid is None else np.asarray(jg.edge_valid,
                                                      np.float32)
    src, dst_local, pval, bpt, ntiles, n_pad = pack_edges(
        np.asarray(jg.t_indptr), np.asarray(jg.t_indices), w)
    want = np.asarray(JK.pagerank_spmv(
        jg, jnp.asarray(src), jnp.asarray(dst_local), jnp.asarray(pval),
        blocks_per_tile=bpt, num_tiles=ntiles, n_pad=n_pad, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-7)


def test_cuda_kernel_matches_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = powerlaw_community(5000, avg_degree=12.0, seed=9)
    t = g.transpose
    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    ip = torch.from_numpy(np.asarray(t.indptr, np.int32)).to(dev)
    ix = torch.from_numpy(np.asarray(t.indices, np.int32)).to(dev)
    val = torch.from_numpy(rng.random(len(t.indices), np.float32)).to(dev)
    x = torch.from_numpy(rng.random(g.num_vertices, np.float32)).to(dev)
    launches = spmv_mod.launches
    got = spmv_mod.csr_spmv(ip, ix, val, x)
    again = spmv_mod.csr_spmv(ip, ix, val, x)
    torch.cuda.synchronize()
    assert spmv_mod.launches == launches + 2
    assert torch.equal(got, again)  # fixed summation order: same bits
    torch.testing.assert_close(got, csr_spmv_ref(ip, ix, val, x),
                               rtol=1e-5, atol=1e-6)
