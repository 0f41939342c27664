"""PyTorch port: the six graph kernels agree with the JAX package's.

The same upload (the JAX package's `to_device`, carried across through
`repro_torch.algos.graph_arrays.from_numpy`) goes through
`repro.algos.kernels` and `repro_torch.algos.kernels` on the CPU, on
every conftest graph, unpadded and bucket-padded. BFS, SSSP, CC and
CC-SV must be bit-identical; PageRank is held to rtol 1e-4
(tests/test_algos.py) and BC to rtol 1e-3 (tests/test_parity_matrix.py):
float32 sums are taken in another order.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.algos import kernels as JK  # noqa: E402
from repro.algos.graph_arrays import to_device as jax_upload  # noqa: E402
from repro.core.csr import from_edges  # noqa: E402
from repro_torch.algos import kernels as TK  # noqa: E402
from repro_torch.algos.graph_arrays import from_numpy  # noqa: E402
from repro_torch.engine.backends import bucket_dims  # noqa: E402

PR_TOL = dict(rtol=1e-4, atol=1e-7)
BC_TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.fixture(params=[False, True], ids=["exact", "bucket"])
def pair(request, any_graph):
    """(graph, JAX upload, port upload of the same arrays, sources)."""
    g = any_graph
    pad = bucket_dims(g.num_vertices, g.num_edges) if request.param else None
    jg = jax_upload(g, pad_to=pad)
    tg = from_numpy({k: None if v is None else np.asarray(v)
                     for k, v in jg._asdict().items()}, device="cpu")
    rng = np.random.default_rng(g.num_vertices)
    srcs = np.unique(np.concatenate(
        [[0], rng.integers(0, g.num_vertices, 2)])).astype(np.int32)
    return g, jg, tg, srcs


def _np(t: torch.Tensor) -> np.ndarray:
    assert t.device.type == "cpu"
    return t.numpy()


def test_bfs_multi_bit_identical(pair):
    _, jg, tg, srcs = pair
    want = np.asarray(JK.bfs_multi(jg, jnp.asarray(srcs)))
    got = _np(TK.bfs_multi(tg, torch.from_numpy(srcs)))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_np(TK.bfs(tg, int(srcs[-1]))), want[-1])


def test_sssp_multi_bit_identical(pair):
    _, jg, tg, srcs = pair
    want = np.asarray(JK.sssp_multi(jg, jnp.asarray(srcs)))
    got = _np(TK.sssp_multi(tg, srcs))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(_np(TK.sssp(tg, int(srcs[0]))), want[0])


@pytest.mark.parametrize("name", ["cc_labelprop", "cc_shiloach_vishkin"])
def test_components_bit_identical(pair, name):
    _, jg, tg, _ = pair
    want = np.asarray(getattr(JK, name)(jg))
    got = _np(getattr(TK, name)(tg))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_pagerank_within_tolerance(pair):
    _, jg, tg, _ = pair
    want = np.asarray(JK.pagerank(jg))
    got = _np(TK.pagerank(tg))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **PR_TOL)
    if tg.vertex_valid is not None:  # padded vertices hold no rank
        assert not got[~_np(tg.vertex_valid)].any()


def test_bc_multi_within_tolerance(pair):
    _, jg, tg, srcs = pair
    want = np.asarray(JK.bc_multi(jg, jnp.asarray(srcs)))
    got = _np(TK.bc_multi(tg, srcs))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **BC_TOL)
    np.testing.assert_allclose(
        _np(TK.bc_single_source(tg, int(srcs[0]))),
        np.asarray(JK.bc_single_source(jg, jnp.int32(srcs[0]))), **BC_TOL)


def test_bc_multi_lanes_with_different_depths():
    """A path 0->1->...->9 plus an isolated pair: sources at different
    points give lanes whose BFS depth (fori_loop trip count) differs, so
    the (S, V) loops must stop each lane at its own level."""
    src = list(range(9)) + [10]
    dst = list(range(1, 10)) + [11]
    g = from_edges(12, src, dst)
    jg = jax_upload(g)
    tg = from_numpy({k: None if v is None else np.asarray(v)
                     for k, v in jg._asdict().items()}, device="cpu")
    srcs = np.array([0, 6, 10, 9], np.int32)
    depth = _np(TK.bfs_multi(tg, srcs))
    assert sorted(depth.max(axis=1).tolist()) == [0, 1, 3, 9]
    want = np.asarray(JK.bc_multi(jg, jnp.asarray(srcs)))
    got = _np(TK.bc_multi(tg, srcs))
    np.testing.assert_allclose(got, want, **BC_TOL)
    for i, s in enumerate(srcs):
        np.testing.assert_allclose(
            got[i], np.asarray(JK.bc_single_source(jg, jnp.int32(s))),
            **BC_TOL)


def test_bc_chunked_and_weighted(plc_graph):
    jg = jax_upload(plc_graph, pad_to=bucket_dims(plc_graph.num_vertices,
                                                  plc_graph.num_edges))
    tg = from_numpy({k: None if v is None else np.asarray(v)
                     for k, v in jg._asdict().items()}, device="cpu")
    srcs = np.array([5, 321, 1500, 7, 99], np.int32)
    np.testing.assert_allclose(_np(TK.bc(tg, srcs, chunk=2)),
                               np.asarray(JK.bc(jg, srcs, chunk=2)),
                               **BC_TOL)
    w = np.array([1.0, 1.0, 0.0, 1.0, 0.0], np.float32)  # 0 = padding lane
    np.testing.assert_allclose(
        _np(TK.bc_weighted(tg, srcs, w)),
        np.asarray(JK.bc_weighted(jg, jnp.asarray(srcs), jnp.asarray(w))),
        **BC_TOL)


@pytest.mark.parametrize("name", sorted(JK.KERNELS))
def test_kernels_table(tiny_graph, name):
    jg = jax_upload(tiny_graph)
    tg = from_numpy({k: np.asarray(v) for k, v in jg._asdict().items()
                     if v is not None}, device="cpu")
    want = np.asarray(JK.KERNELS[name](jg))
    got = _np(TK.KERNELS[name](tg))
    if name in ("pr", "bc"):
        np.testing.assert_allclose(got, want,
                                   **(PR_TOL if name == "pr" else BC_TOL))
    else:
        np.testing.assert_array_equal(got, want)
