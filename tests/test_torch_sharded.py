"""PyTorch port: the sharded backend serves as the JAX package's does.

`EngineSession` places a graph whose working set exceeds
``device_budget_bytes`` on `ShardedBackend`; here its shards are 4 CPU
shards in this process (``num_shards=4, device="cpu"``). The six GAP
kernels and k-NN serve through it: the integer kernels bit for bit
against the reference's session (one host device there) and the numpy
oracles, PR rtol 1e-4 and BC 1e-3; k-NN ids and visits equal to the
port's single-device session's. Also: the runner factories, the per-
device bytes the placement reads, the ledger's gain discount, the
scheduler's per-request exchange deltas, the tracer's exchange spans,
``update_graph`` on a sharded placement, and the executor's routing.
The exchange ledger itself is held to the reference's in
tests/test_torch_dist.py.
"""
from __future__ import annotations

import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.engine as jax_engine  # noqa: E402
import repro_torch.engine as torch_engine  # noqa: E402
from repro.core.baselines import (bc_baseline, bfs_baseline, cc_baseline,  # noqa: E402
                                  pagerank_baseline, sssp_baseline)
from repro.core.generators import clustered_vectors  # noqa: E402
from repro.engine.backends import ShardedBackend as JaxShardedBackend  # noqa: E402
from repro.search import build_nsw_graph  # noqa: E402
from repro_torch.algos.graph_arrays import to_device  # noqa: E402
from repro_torch.engine.backends import (_RUNNER_FACTORIES, GLOBAL,  # noqa: E402
                                         MULTI_SOURCE)

PR_TOL = dict(rtol=1e-4, atol=1e-7)
BC_TOL = dict(rtol=1e-3, atol=1e-3)
KERNELS = ("bfs", "sssp", "bc", "pr", "cc", "ccsv")
SOURCES = np.array([5, 321, 1500])


def _session(engine=torch_engine, **kw):
    kw.setdefault("redecide_min_queries", 10**6)
    kw.setdefault("device_budget_bytes", 1024)   # everything sharded
    if engine is torch_engine:
        kw.setdefault("num_shards", 4)
        kw.setdefault("device", "cpu")
    return engine.EngineSession(**kw)


def _serve(session, graph, srcs=SOURCES, graph_id="g") -> dict:
    gid = session.register(graph, graph_id=graph_id, expected_queries=256)
    futs = {k: session.enqueue(gid, k, srcs if k in MULTI_SOURCE else None)
            for k in KERNELS}
    session.flush()
    return {k: np.asarray(f.result()) for k, f in futs.items()}


def _assert_equal(kernel, got, want):
    assert got.shape == want.shape and got.dtype == want.dtype, kernel
    if kernel == "pr":
        np.testing.assert_allclose(got, want, **PR_TOL)
    elif kernel == "bc":
        np.testing.assert_allclose(got, want, **BC_TOL)
    else:
        np.testing.assert_array_equal(got, want, err_msg=kernel)


# --------------------------------------------------------- the factories
def test_sharded_runner_factory_covers_every_served_kernel(plc_graph):
    assert set(torch_engine.SHARDED_KERNELS) == set(MULTI_SOURCE) | set(GLOBAL)
    assert set(_RUNNER_FACTORIES) == set(torch_engine.SHARDED_KERNELS)
    backend = torch_engine.ShardedBackend(num_shards=2, device="cpu")
    handle = backend.prepare(plc_graph)
    with pytest.raises(ValueError, match="unknown kernel"):
        backend.run(handle, "nope")
    assert backend.queries_run == 0  # rejected before anything counted
    with pytest.raises(ValueError, match="search="):
        backend.run(handle, "knn", np.zeros((1, 4), np.float32))


@pytest.mark.parametrize("num_shards", [1, 3, 4])
def test_per_device_bytes_is_the_references(plc_graph, rmat_graph,
                                            num_shards):
    """The placement reads this number: the reference's formula on the
    fullest shard of the same partition."""
    be = torch_engine.ShardedBackend(num_shards=num_shards, device="cpu")
    for g in (plc_graph, rmat_graph):
        want = JaxShardedBackend._per_device_bytes(
            types.SimpleNamespace(num_shards=num_shards), g)
        assert be.prepare(g).device_bytes == want


# ----------------------------------------------------------- the session
@pytest.fixture(scope="module")
def served(plc_graph):
    """Both packages' sessions over a sharded placement of plc_graph."""
    want_s, got_s = _session(jax_engine), _session()
    want, got = _serve(want_s, plc_graph), _serve(got_s, plc_graph)
    yield want_s, got_s, want, got
    want_s.close()
    got_s.close()


@pytest.mark.parametrize("kernel", KERNELS)
def test_session_serves_every_kernel_as_the_reference(served, plc_graph,
                                                      kernel):
    _, _, want, got = served
    _assert_equal(kernel, got[kernel], want[kernel])
    g = plc_graph
    if kernel == "bfs":
        for i, s in enumerate(SOURCES):
            np.testing.assert_array_equal(got["bfs"][i], bfs_baseline(g, s))
    elif kernel == "sssp":
        w = to_device(g, device="cpu").weights.numpy()
        for i, s in enumerate(SOURCES):
            np.testing.assert_array_equal(got["sssp"][i].astype(np.int64),
                                          sssp_baseline(g, w, s))
    elif kernel == "bc":
        np.testing.assert_allclose(got["bc"].sum(0), bc_baseline(g, SOURCES),
                                   **BC_TOL)
    elif kernel == "pr":
        np.testing.assert_allclose(got["pr"], pagerank_baseline(g), **PR_TOL)
    else:
        np.testing.assert_array_equal(got[kernel], cc_baseline(g))


def test_session_places_sharded_with_the_gain_discount(served):
    """The policy's decision, the ledger's discount and the telemetry's
    shape are the reference's; the port runs 4 shards."""
    want_s, got_s, _, _ = served
    want_e, got_e = (s.registry.get("g") for s in (want_s, got_s))
    assert got_e.backend == "sharded" and got_e.ledger.backend == "sharded"
    assert (dataclasses.asdict(got_e.decision)
            == dataclasses.asdict(want_e.decision))
    assert got_e.hot_prefix_fraction is not None
    assert got_e.ledger.gain_discount == want_e.ledger.gain_discount
    assert got_s.sharded_gain_discount < got_e.ledger.gain_discount < 1.0
    t = got_s.telemetry()
    sh = t["executor"]["sharded"]
    assert sh["num_shards"] == 4 and sh["fused"] is True
    assert sh["queries_run"] == 6 and sh["dispatches"] == 6
    assert t["executor"]["queries_run"] == 6
    assert sh["hot_prefix"]["steps_full"] > 0
    assert sh["hot_prefix"]["steps_hot"] > 0
    assert 0.0 < sh["hot_prefix"]["savings_fraction"] < 1.0
    # monotone kernels run thinned; pr/bc stay synchronous full-exchange
    # and ccsv aliases to the cc runner (one partition, one upload)
    assert {r["kernel"] for r in sh["hot_prefix"]["runners"]} == {
        "bfs", "sssp", "cc"}
    for r in sh["hot_prefix"]["runners"]:
        assert 0.0 < r["prefix_hit_rate"] <= 1.0
        assert 1 <= r["h_local"] < r["per_shard_vertices"] == 500
    assert set(got_e.handle.shard_state._runners) == {
        "bfs", "sssp", "bc", "pr", "cc"}
    want_t = want_s.telemetry()["executor"]["sharded"]
    assert set(sh) == set(want_t)
    assert set(sh["hot_prefix"]) == set(want_t["hot_prefix"])


@pytest.mark.parametrize("fused", [True, False])
def test_host_loop_books_a_dispatch_a_step(plc_graph, fused):
    """The engine's dispatch counter: one a query fused, one a step on
    the host loop; the answers the same bits either way."""
    s = _session(fused=fused)
    out = _serve(s, plc_graph)
    t = s.executor.sharded.telemetry()
    s.close()
    assert t["fused"] is fused
    steps = t["hot_prefix"]["steps"]
    assert t["dispatches"] == (t["queries_run"] if fused else steps)
    other = _session(fused=not fused)
    again = _serve(other, plc_graph)
    other.close()
    for k in KERNELS:
        np.testing.assert_array_equal(out[k], again[k])


@pytest.mark.parametrize("num_shards", [1, 2, 3])
def test_session_serves_tiny_graph_on_any_shard_count(tiny_graph,
                                                      num_shards):
    s = _session(num_shards=num_shards)
    got = _serve(s, tiny_graph, srcs=np.array([0, 3]))
    s.close()
    assert s.executor.sharded.num_shards == num_shards
    np.testing.assert_array_equal(got["bfs"][1], bfs_baseline(tiny_graph, 3))
    np.testing.assert_array_equal(got["cc"], cc_baseline(tiny_graph))
    np.testing.assert_allclose(got["pr"], pagerank_baseline(tiny_graph),
                               **PR_TOL)


# ----------------------------------------- scheduler, tracer, mutations
def test_sharded_requests_carry_exchange_deltas(plc_graph):
    """tests/test_scheduler.py:295 on the port's session: per-request
    deltas sum to the backend's aggregate."""
    session = _session()
    gid = session.register(plc_graph, expected_queries=256)
    assert session.registry.get(gid).backend == "sharded"
    f1 = session.enqueue(gid, "bfs", [0, 1])
    f2 = session.enqueue(gid, "cc")
    session.flush()
    for f in (f1, f2):
        ex = f.telemetry["exchange"]
        assert ex is not None and ex["steps"] > 0 and ex["dispatches"] == 1
    agg = session.executor.sharded.exchange_stats
    assert (f1.telemetry["exchange"]["steps"]
            + f2.telemetry["exchange"]["steps"]) == agg.steps
    assert (f1.telemetry["exchange"]["bytes_exchanged"]
            + f2.telemetry["exchange"]["bytes_exchanged"]
            == agg.bytes_exchanged)
    single = torch_engine.EngineSession(device="cpu")
    sid = single.register(plc_graph, expected_queries=256)
    fut = single.enqueue(sid, "bfs", [0])
    single.flush()
    assert fut.telemetry["exchange"] is None


def test_sharded_run_emits_exchange_spans(plc_graph):
    """tests/test_obs.py:272: one ``exchange`` span a step, nested in
    its launch, counted by ``engine_exchange_steps_total``."""
    session = _session()
    gid = session.register(plc_graph, "g")
    fut = session.enqueue(gid, "bfs", [0, 1])
    session.flush()
    fut.result()
    trace = session.tracer.to_chrome()
    torch_engine.validate_chrome_trace(trace)
    exchanges = [e for e in trace["traceEvents"]
                 if e.get("ph") == "X" and e["name"] == "exchange"]
    assert len(exchanges) == fut.telemetry["exchange"]["steps"] >= 1
    launch = next(e for e in trace["traceEvents"]
                  if e.get("ph") == "X" and e["name"] == "launch")
    lo, hi = launch["ts"], launch["ts"] + launch["dur"]
    for ex in exchanges:
        assert lo - 1e-2 <= ex["ts"] <= ex["ts"] + ex["dur"] <= hi + 1e-2
        assert ex["args"]["mode"] in ("full", "hot")
        assert ex["args"]["kernel"] == "bfs"
    assert {ex["args"]["mode"] for ex in exchanges} == {"full", "hot"}
    snap = session.metrics().snapshot()
    assert snap["counters"]["engine_exchange_steps_total"] == len(exchanges)


def test_update_graph_on_a_sharded_placement():
    """tests/test_mutations.py:343's sharded leg: after three deltas
    (patch, patch, full) the session answers as a fresh registration of
    the final graph does, and as the reference's session does."""
    from repro.core.generators import powerlaw_community
    g = powerlaw_community(400, avg_degree=8.0, seed=11, name="dyn")
    answers = []
    for engine in (torch_engine, jax_engine):
        rng = np.random.default_rng(8)
        s = _session(engine, async_full_reorder=False)
        gid = s.register(g, expected_queries=512)
        for tier in ("patch", "patch", "full"):
            e = s.registry.get(gid).graph
            pairs = np.stack([e.edge_src, e.indices], 1).astype(np.int64)
            remove = pairs[rng.choice(e.num_edges, 40, replace=False)]
            add = rng.integers(0, e.num_vertices, size=(50, 2))
            info = s.update_graph(gid, add_edges=add, remove_edges=remove,
                                  reorder=tier)
            assert info["tier"] == tier
        entry = s.registry.get(gid)
        assert entry.backend == "sharded" and entry.arrays is None
        fresh = _session(engine, async_full_reorder=False)
        fid = fresh.register(entry.graph, graph_id="fresh",
                             expected_queries=512)
        got = {}
        for k in KERNELS:
            srcs = [0, 17, 33] if k in MULTI_SOURCE else None
            got[k] = np.asarray(s.submit(gid, k, srcs))
            _assert_equal(k, got[k], np.asarray(fresh.submit(fid, k, srcs)))
        answers.append(got)
        s.close()
        fresh.close()
    for k in KERNELS:
        _assert_equal(k, answers[0][k], answers[1][k])


# ------------------------------------------------------------------ k-NN
def test_sharded_knn_equals_the_single_device_port():
    """Queries split by rows over 4 shards (5 real rows: the last shard
    gets pad lanes only): ids and summed visits equal the single-device
    session's, bit for bit, on integer-valued vectors; no exchange."""
    vecs, _ = clustered_vectors(240, dim=8, num_clusters=5, seed=1)
    vecs = np.round(vecs * 4).astype(np.float32)
    nsw = build_nsw_graph(vecs, k=8)
    rng = np.random.default_rng(3)
    queries = (vecs[rng.choice(240, 5, replace=False)] + 1).astype(np.float32)
    got = {}
    for placement in ("single", "sharded"):
        kw = {} if placement == "single" else dict(device_budget_bytes=1024)
        with _session(**{"device_budget_bytes": None, **kw}) as s:
            gid = s.register(nsw, "knn", vectors=vecs)
            e = s.registry.get(gid)
            assert e.backend == placement
            be = s.executor.backend(placement)
            ids, visits = be.run(e.handle, "knn", queries)
            got[placement] = (ids.numpy(), visits.numpy(),
                              s.submit(gid, "knn", queries))
            if placement == "sharded":
                assert be.last_run_exchange is None
                assert be.sources_run == 10 and be.queries_run == 2
                assert len(e.handle.shard_state.knn_operands) == 1
    for a, b in zip(got["sharded"], got["single"]):
        np.testing.assert_array_equal(a, b)
    assert (got["sharded"][0] >= 0).all()


# ------------------------------------------------------------ the executor
def test_executor_routes_and_sums_both_backends(plc_graph):
    ex = torch_engine.BatchedExecutor(num_shards=3, device="cpu")
    assert ex.telemetry()["sharded"] is None      # lazy: never built
    hs = ex.prepare(plc_graph, backend="sharded", hot_prefix_fraction=0.1)
    h1 = ex.prepare(plc_graph)
    assert (hs.backend, hs.hot_prefix_fraction, hs.arrays) == (
        "sharded", 0.1, None)
    assert ex.backend("sharded") is ex.sharded
    assert ex.sharded.mesh.devices == (torch.device("cpu"),) * 3
    np.testing.assert_array_equal(ex.run(hs, "bfs", [0, 7]).numpy(),
                                  ex.run(h1, "bfs", [0, 7]).numpy())
    np.testing.assert_array_equal(ex.run(hs, "cc").numpy(),
                                  ex.run(h1, "cc").numpy())
    assert (ex.queries_run, ex.sources_run) == (4, 4)
    t = ex.telemetry()
    assert t["sharded"]["queries_run"] == 2 and t["single"]["queries_run"] == 2
    with pytest.raises(ValueError, match="unknown backend"):
        ex.backend("nope")
