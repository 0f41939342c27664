"""PyTorch port: the serving engine answers as the JAX package's does.

One `EngineSession` script — register, enqueue/flush, `update_graph`,
`refresh_hotness` — runs against `repro.engine` and `repro_torch.engine`
(``device="cpu"``) on an analytics graph. Results must be equal (exact
for the integer kernels, PR rtol 1e-4, BC rtol 1e-3), policy decisions
equal, and telemetry must carry the same keys but for the renamed
``pallas_pr`` -> ``spmv_pr``. The exact and bucketed legs of
tests/test_parity_matrix.py run through the port's ``submit`` against
the numpy oracles, and every PR the backend serves goes through the
SpMV wrapper.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.engine as jax_engine  # noqa: E402
import repro_torch.engine as torch_engine  # noqa: E402
from repro.core.baselines import (bc_baseline, bfs_baseline, cc_baseline,  # noqa: E402
                                  pagerank_baseline, sssp_baseline)
from repro_torch.algos import kernels as TK  # noqa: E402
from repro_torch.algos.graph_arrays import to_device  # noqa: E402
from repro_torch.engine.backends import SingleDeviceBackend  # noqa: E402

PR_TOL = dict(rtol=1e-4, atol=1e-7)
BC_TOL = dict(rtol=1e-3, atol=1e-3)
QUERIES = [("bfs", [5, 321]), ("sssp", [7, 1500]), ("bc", [5, 9, 40]),
           ("pr", None), ("cc", None), ("ccsv", None), ("bfs", [1500])]


def _script(engine, graph, **kw):
    """Register, serve, mutate, serve again; returns what it saw."""
    s = engine.EngineSession(redecide_min_queries=10**6, **kw)
    gid = s.register(graph, graph_id="g", expected_queries=256)
    futs = [s.enqueue(gid, k, src) for k, src in QUERIES]
    s.flush()
    before = [np.asarray(f.result()) for f in futs]
    rng = np.random.default_rng(7)
    add = rng.integers(0, graph.num_vertices, size=(40, 2))
    remove = np.stack([graph.edge_src[:10], graph.indices[:10]], axis=1)
    summary = s.update_graph(gid, add_edges=add, remove_edges=remove,
                             reorder="patch")
    after = [np.asarray(s.submit(gid, k, src)) for k, src in QUERIES]
    with pytest.raises(ValueError, match="not a search graph"):
        s.refresh_hotness(gid)
    # the two packages have their own PolicyDecision classes: compare
    # field by field
    decisions = [dataclasses.asdict(r.decision) for r in s.policy.history]
    telemetry = s.telemetry()
    s.close()
    return before + after, decisions, summary, telemetry


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + str(k))
        if isinstance(v, dict):
            out |= _keys(v, f"{prefix}{k}.")
    return out


@pytest.fixture(scope="module")
def both(plc_graph):
    return (_script(jax_engine, plc_graph),
            _script(torch_engine, plc_graph, device="cpu"))


def test_session_script_results_equal(both):
    (want, *_), (got, *_) = both
    kernels = [k for k, _ in QUERIES] * 2
    for k, w, g in zip(kernels, want, got):
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k == "pr":
            np.testing.assert_allclose(g, w, **PR_TOL)
        elif k == "bc":
            np.testing.assert_allclose(g, w, **BC_TOL)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_session_script_decisions_equal(both):
    (_, want, want_sum, _), (_, got, got_sum, _) = both
    assert got == want and len(got) >= 1
    assert got[0]["scheme"] == "lorder"
    # everything but the timings
    assert ({k: v for k, v in got_sum.items() if not k.endswith("seconds")}
            == {k: v for k, v in want_sum.items()
                if not k.endswith("seconds")})


def test_session_script_telemetry_keys(both):
    (*_, want), (*_, got) = both
    want_keys = {k.replace("pallas_pr", "spmv_pr") for k in _keys(want)}
    assert _keys(got) == want_keys
    single = got["executor"]["single"]
    assert single["spmv_pr"] is True  # PR always runs the SpMV
    assert got["executor"]["sharded"] is None


# ------------------------------------------- parity matrix, exact + bucketed
SOURCES = {"plc_graph": np.array([5, 321, 1500]),
           "tiny_graph": np.array([0, 3])}


@pytest.fixture(scope="module",
                params=[(c, g) for g in SOURCES for c in ("exact", "bucketed")],
                ids=[f"{g.split('_')[0]}-{c}" for g in SOURCES
                     for c in ("exact", "bucketed")])
def served(request):
    config, key = request.param
    graph = request.getfixturevalue(key)
    executor = torch_engine.BatchedExecutor(
        bucketing=config == "bucketed", device="cpu")
    session = torch_engine.EngineSession(executor=executor,
                                         redecide_min_queries=10**6)
    gid = session.register(graph, graph_id=f"m-{config}-{key}",
                           expected_queries=256)
    return graph, session, gid, SOURCES[key]


def test_matrix_traversals_exact(served):
    g, session, gid, srcs = served
    assert session.registry.get(gid).backend == "single"
    bfs = session.submit(gid, "bfs", srcs)
    sssp = np.asarray(session.submit(gid, "sssp", srcs), np.int64)
    weights = to_device(g, device="cpu").weights.numpy()
    for i, s in enumerate(srcs):
        np.testing.assert_array_equal(bfs[i], bfs_baseline(g, int(s)))
        np.testing.assert_array_equal(sssp[i],
                                      sssp_baseline(g, weights, int(s)))


def test_matrix_bc_pr(served):
    g, session, gid, srcs = served
    np.testing.assert_allclose(session.submit(gid, "bc", srcs).sum(axis=0),
                               bc_baseline(g, srcs), **BC_TOL)
    np.testing.assert_allclose(session.submit(gid, "pr"),
                               pagerank_baseline(g), **PR_TOL)


@pytest.mark.parametrize("kernel", ["cc", "ccsv"])
def test_matrix_components(served, kernel):
    g, session, gid, _ = served
    np.testing.assert_array_equal(session.submit(gid, kernel), cc_baseline(g))


# ------------------------------------------------------ PR through the SpMV
@pytest.mark.parametrize("bucketing", [False, True],
                         ids=["exact", "bucketed"])
def test_spmv_pr_on_cpu_serves_through_the_spmv_path(plc_graph, bucketing,
                                                     monkeypatch):
    """Handles and raw arrays alike: each PR iteration calls the SpMV
    wrapper (on a CUDA tensor it launches the kernel), bucketed handles
    on their real rows only."""
    calls = []

    def counted(t_indptr, t_indices, val, x):
        calls.append(t_indptr.shape[0] - 1)
        return spmv(t_indptr, t_indices, val, x)

    spmv = TK.csr_spmv
    monkeypatch.setattr(TK, "csr_spmv", counted)
    be = SingleDeviceBackend(bucketing=bucketing, device="cpu")
    h = be.prepare(plc_graph)
    assert h.spmv_val is not None
    out = be.run(h, "pr").numpy()
    np.testing.assert_allclose(out, pagerank_baseline(plc_graph), **PR_TOL)
    assert calls and set(calls) == {plc_graph.num_vertices}
    iters = len(calls)
    raw = be.run_arrays(h.arrays, "pr").numpy()
    assert len(calls) == 2 * iters and calls[-1] == h.arrays.num_vertices
    np.testing.assert_allclose(raw[:plc_graph.num_vertices], out,
                               rtol=1e-6, atol=1e-9)
    assert [k[0] for k in be._cache] == ["pr"]
    assert be.telemetry()["dispatches"] == 2
    assert be.telemetry()["spmv_pr"] is True


def test_backend_cache_mechanics(plc_graph, tiny_graph):
    be = SingleDeviceBackend(max_cached_executables=1, device="cpu")
    h1, h2 = be.prepare(plc_graph), be.prepare(tiny_graph)
    be.run(h1, "bfs", [0])
    be.run(h1, "bfs", [1, 2])
    be.run(h2, "bfs", [0])      # another bucket: evicts the first key
    be.run(h1, "bfs", [0])      # returns: a counted miss again
    assert (be.cache_hits, be.cache_misses, be.cache_evictions) == (1, 3, 2)
    assert be.sources_run == 5 and be.queries_run == 4
    with pytest.raises(ValueError, match="unknown kernel"):
        be.run(h1, "nope")
    with pytest.raises(ValueError, match="at least one source"):
        be.run(h1, "bfs", [])
    assert be.queries_run == 4


def test_unported_paths_raise(plc_graph):
    """The paths this test once found refused now work: knn without a
    SearchSpec still raises, and the sharded backend and its options
    (tests/test_torch_sharded.py) are served."""
    ex = torch_engine.BatchedExecutor(device="cpu")
    h = ex.prepare(plc_graph)
    # knn is ported (tests/test_torch_knn.py); a graph prepared without
    # a SearchSpec has nothing to search
    with pytest.raises(ValueError, match="search="):
        ex.run(h, "knn", np.zeros((1, 4), np.float32))
    hs = ex.prepare(plc_graph, backend="sharded")
    assert hs.backend == "sharded" and hs.shard_state is not None
    np.testing.assert_array_equal(ex.run(hs, "bfs", [5]).numpy(),
                                  ex.run(h, "bfs", [5]).numpy())
    s = torch_engine.EngineSession(num_shards=4, device="cpu")
    assert s.executor.sharded.mesh.devices == (torch.device("cpu"),) * 4
    s.close()
    host = torch_engine.BatchedExecutor(fused=False, device="cpu")
    assert host.sharded.fused is False


def test_profiler_hook_maps_to_torch_profiler(tmp_path):
    inert = torch_engine.ProfilerHook(None)
    assert not inert.enabled and not inert.start() and not inert.stop()
    with inert.step("bfs"):
        pass
    hook = torch_engine.ProfilerHook(tmp_path)
    assert hook.start() and hook.active and hook.error is None
    with hook.step("bfs", step_num=3):
        torch.ones(8).sum()
    assert hook.stop() and not hook.active and hook.error is None
    assert any(tmp_path.iterdir())  # a Chrome trace was written
