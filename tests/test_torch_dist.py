"""PyTorch port: core/dist.py answers as the JAX package's does.

The port's sharded graph engine is single-controller: one process, a
`Mesh` of devices (one per shard), per-shard tensors, and collectives as
functions over them. Here every shard lives on the CPU, in this process.
Its partitions equal the reference's; its BFS, SSSP and CC are bit for
bit the reference's single-device kernels for 1-4 shards, with the hot
prefix on and off, at every ``cold_every``; PR within rtol 1e-4 / atol
1e-7 and BC within rtol 1e-3; ``fused`` and the host loop agree bit for
bit; and `ExchangeStats.as_dict()` equals the reference's field by field
— in process against a one-device mesh, and in one subprocess against
the reference on 4 forced host devices
(`benchmarks.common.run_forced_four_devices`).
"""
from __future__ import annotations

import json
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from conftest import run_forced_four_devices  # noqa: E402
from repro.algos import kernels as JK  # noqa: E402
from repro.algos.graph_arrays import edge_weights, to_device  # noqa: E402
from repro.core import dist as JD  # noqa: E402
from repro.core.baselines import dbg_order  # noqa: E402
from repro.core.csr import from_edges  # noqa: E402
from repro.core.generators import powerlaw_community  # noqa: E402
from repro_torch.core import dist as TD  # noqa: E402

PR_TOL = dict(rtol=1e-4, atol=1e-7)
BC_TOL = dict(rtol=1e-3, atol=1e-3)
SOURCES = np.array([5, 321, 1500])
# (hot_prefix_fraction, cold_every), tests/test_fused_loops.py's matrix
EXCHANGE_CONFIGS = [(None, 1), (0.05, 1), (0.05, 4), (0.5, 1), (0.5, 4)]


def _mesh(n: int) -> TD.Mesh:
    return TD.make_mesh(n, device="cpu")


@pytest.fixture(scope="module")
def packed():
    """plc_graph with its hubs packed into the id prefix (DBG), the
    inverse permutation and the reference's upload of it."""
    g0 = powerlaw_community(2000, avg_degree=8.0, seed=3)
    perm = np.asarray(dbg_order(g0))
    g = g0.apply_permutation(perm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(len(perm))
    return g, inv, to_device(g, canonical_ids=inv)


def _want(kernel: str, ga, srcs=SOURCES) -> np.ndarray:
    """The reference's single-device kernel."""
    if kernel == "cc":
        return np.asarray(JK.cc_labelprop(ga))
    fn = {"bfs": JK.bfs, "sssp": JK.sssp}[kernel]
    return np.stack([np.asarray(fn(ga, jnp.int32(s))) for s in srcs])


def _run(kernel: str, g, mesh, inv=None, srcs=SOURCES, **kw):
    if kernel == "cc":
        run = TD.make_distributed_cc(g, mesh, **kw)
        return run, run().numpy()
    if kernel == "sssp":
        run = TD.make_distributed_sssp(g, mesh, canonical_ids=inv, **kw)
    else:
        run = TD.make_distributed_bfs(g, mesh, **kw)
    return run, run(srcs).numpy()


# ------------------------------------------------------------- partitions
@pytest.mark.parametrize("num_shards", [1, 2, 4, 7])
def test_partition_edges_round_trip(any_graph, num_shards):
    """No edge lost or invented, local dst indices reconstruct globals,
    and the padded arrays equal the reference's."""
    g = any_graph
    parts = TD.partition_edges(g, num_shards)
    for got, want in zip(parts, JD.partition_edges(g, num_shards)):
        np.testing.assert_array_equal(got, want)
    s_pad, d_pad, valid, per = parts
    assert valid.sum() == g.num_edges
    src_rt, dst_rt = [], []
    for i in range(num_shards):
        assert (0 <= d_pad[i][valid[i]]).all()
        assert (d_pad[i][valid[i]] < per).all()
        src_rt.append(s_pad[i][valid[i]])
        dst_rt.append(d_pad[i][valid[i]] + i * per)
    pairs = np.stack([np.concatenate(src_rt).astype(np.int64),
                      np.concatenate(dst_rt).astype(np.int64)], 1)
    order = np.lexsort((pairs[:, 1], pairs[:, 0]))
    np.testing.assert_array_equal(pairs[order], g.edge_multiset())


def test_partition_edges_empty_shards():
    """Every edge lands in shard 0 of 4: the others get none."""
    g = from_edges(40, [10, 11, 12], [0, 1, 2])
    s_pad, d_pad, valid, per = TD.partition_edges(g, 4)
    assert per == 10
    assert valid[0].sum() == 3 and valid[1:].sum() == 0


@pytest.mark.parametrize("seed,num_shards", [(1, 3), (2, 5), (3, 7)])
def test_partition_edges_weighted(seed, num_shards):
    """(src, dst, valid, values) equal the reference's and round-trip to
    the weighted edge multiset."""
    g = powerlaw_community(300 + 50 * seed, avg_degree=5.0, seed=seed)
    w = edge_weights(g.edge_src, g.indices)
    parts = TD.partition_edges(g, num_shards, edge_values=w)
    for got, want in zip(parts, JD.partition_edges(g, num_shards,
                                                   edge_values=w)):
        np.testing.assert_array_equal(got, want)
    s_pad, d_pad, valid, per, w_pad = parts
    got = np.concatenate([np.stack([s_pad[i][valid[i]],
                                    d_pad[i][valid[i]] + i * per,
                                    w_pad[i][valid[i]]], 1)
                          for i in range(num_shards)]).astype(np.int64)
    want = np.stack([g.edge_src, g.indices, w], 1).astype(np.int64)
    np.testing.assert_array_equal(
        got[np.lexsort(got.T[::-1])], want[np.lexsort(want.T[::-1])])


# ---------------------------------------------------------- exchange stats
def test_exchange_stats_accounting():
    """The same records give the reference's numbers."""
    got, want = TD.ExchangeStats(), JD.ExchangeStats()
    assert got.bytes_per_step == 0.0 and got.savings_fraction == 0.0
    for st in (got, want):
        st.record_full(100)
        st.record_hot(10, 100)
        st.record_hot(10, 100)
        st.record_dispatch()
        st.record_run(2, 1, 50, 5)
    assert got.as_dict() == want.as_dict()
    assert (got.steps_full, got.steps_hot) == (3, 3)
    assert got.bytes_exchanged == 225
    assert got.savings_fraction == pytest.approx(1 - 225 / 450)


def test_exchange_stats_snapshot_delta():
    st = TD.ExchangeStats()
    st.record_full(100)
    before = st.snapshot()
    st.record_full(50)
    st.record_hot(10, 50)
    run = st.delta(before)
    assert run.steps == 2 and run.bytes_exchanged == 60
    assert run.bytes_full_equivalent == 100
    assert run.savings_fraction == pytest.approx(0.4)
    assert st.steps == 3 and st.bytes_exchanged == 160
    assert st.delta(st.snapshot()).steps == 0


# ---------------------------------------------------- mesh and collectives
def test_make_mesh():
    assert _mesh(4).devices == (torch.device("cpu"),) * 4
    assert TD.make_mesh(device="cpu").shape == {"data": 1}
    assert TD.make_mesh(3, axis="x", device="cpu").shape == {"x": 3}
    with pytest.raises(ValueError, match="num_shards"):
        TD.make_mesh(0, device="cpu")
    if not torch.cuda.is_available():
        # the card is the default, and a missing one is an error
        with pytest.raises(RuntimeError, match="no CUDA"):
            TD.make_mesh(4)


def test_collectives():
    mesh = _mesh(3)
    slabs = [torch.arange(4, dtype=torch.int32).reshape(1, 4) + 10 * i
             for i in range(3)]
    full = TD.all_gather(slabs, mesh)
    assert all(f is full[0] for f in full)    # one device, one tensor
    np.testing.assert_array_equal(full[0].numpy(),
                                  np.concatenate([s.numpy() for s in slabs],
                                                 -1))
    hot = TD.all_gather(slabs, mesh, h_local=2)[0].numpy()
    np.testing.assert_array_equal(hot, [[0, 1, 10, 11, 20, 21]])
    vals = [torch.tensor(v) for v in (3, -1, 7)]
    assert int(TD.psum(vals, mesh)[2]) == 9
    assert int(TD.pmax(vals, mesh)[1]) == 7


# ------------------------------------------ min-relaxation, exact results
@pytest.mark.parametrize("kernel", ["bfs", "sssp", "cc"])
def test_hot_prefix_exact_and_saves_bytes_four_shards(packed, kernel):
    """4 CPU shards, hub-packed layout: the hot-prefix BFS/SSSP/CC equal
    the reference's single-device kernels bit for bit, as the full
    exchange does, while moving fewer bytes a step."""
    g, inv, ga = packed
    want = _want(kernel, ga)
    hot, full = TD.ExchangeStats(), TD.ExchangeStats()
    run_h, got_h = _run(kernel, g, _mesh(4), inv, hot_prefix_fraction=0.15,
                        cold_every=5, stats=hot)
    _, got_f = _run(kernel, g, _mesh(4), inv, stats=full)
    np.testing.assert_array_equal(got_h, want)
    np.testing.assert_array_equal(got_f, want)
    assert got_h.dtype == np.int32
    assert hot.steps_hot > 0 and hot.steps_full > 0
    assert 0.0 < hot.savings_fraction < 1.0
    assert (hot.bytes_hot / hot.steps_hot
            < full.bytes_full / full.steps_full)
    assert 0.0 < run_h.prefix_hit_rate <= 1.0
    assert run_h.h_local < run_h.per


@pytest.mark.parametrize("num_shards", [1, 2, 3, 4])
@pytest.mark.parametrize("graph", ["rmat_graph", "grid_graph", "ring_graph"])
def test_min_relax_exact_across_shard_counts(request, graph, num_shards):
    """BFS, SSSP and CC at every shard count, hot prefix on and off."""
    g = request.getfixturevalue(graph)
    ga = to_device(g)
    srcs = np.array([0, g.num_vertices // 2])
    for kernel in ("bfs", "sssp", "cc"):
        want = _want(kernel, ga, srcs)
        for f, c in ((None, 1), (0.2, 3)):
            _, got = _run(kernel, g, _mesh(num_shards), srcs=srcs,
                          hot_prefix_fraction=f, cold_every=c)
            np.testing.assert_array_equal(got, want, err_msg=kernel)


def test_min_relax_with_a_shard_of_no_edges():
    """Three of four shards own no edge: their slices stay as they
    started, the answers are still the reference's."""
    g = from_edges(40, [10, 11, 12, 0], [0, 1, 2, 3])
    ga = to_device(g)
    for kernel in ("bfs", "sssp", "cc"):
        for f in (None, 0.3):
            _, got = _run(kernel, g, _mesh(4), srcs=np.array([10, 0]),
                          hot_prefix_fraction=f, cold_every=2)
            np.testing.assert_array_equal(
                got, _want(kernel, ga, np.array([10, 0])), err_msg=kernel)


# ---------------------------------------------------------- PR and BC
@pytest.mark.parametrize("num_shards", [1, 3, 4])
def test_pagerank_and_bc_parity(plc_graph, num_shards):
    mesh = _mesh(num_shards)
    ga = to_device(plc_graph)
    run, devices = TD.make_distributed_pagerank(plc_graph, mesh)
    assert devices == mesh.devices
    got = run().numpy()
    assert got.dtype == np.float32 and got.shape == (plc_graph.num_vertices,)
    np.testing.assert_allclose(got, np.asarray(JK.pagerank(ga, num_iters=20)),
                               **PR_TOL)
    bc = TD.make_distributed_bc(plc_graph, mesh)(SOURCES).numpy()
    assert bc.dtype == np.float32
    want = np.asarray(JK.bc_multi(ga, jnp.asarray(SOURCES, jnp.int32)))
    np.testing.assert_allclose(bc, want, **BC_TOL)
    assert (bc[np.arange(3), SOURCES] == 0).all()


# ------------------------------------------------ fused against host loop
FUSED_SOURCES = np.array([0, 17, 203])
FUSED_CASES = ([(k, f, c) for k in ("bfs", "sssp", "cc")
                for f, c in EXCHANGE_CONFIGS]
               + [("pr", None, 1), ("bc", None, 1)])


def _factory_run(kernel, g, mesh, stats, fused, f=None, c=1):
    if kernel == "pr":
        return TD.make_distributed_pagerank(g, mesh, stats=stats,
                                            fused=fused)[0]()
    if kernel == "bc":
        return TD.make_distributed_bc(g, mesh, stats=stats,
                                      fused=fused)(FUSED_SOURCES)
    return _run(kernel, g, mesh, srcs=FUSED_SOURCES, hot_prefix_fraction=f,
                cold_every=c, stats=stats, fused=fused)[1]


@pytest.mark.parametrize("kernel,fraction,cold_every", FUSED_CASES,
                         ids=[f"{k}-f{f}-c{c}" for k, f, c in FUSED_CASES])
def test_fused_matches_host_loop(kernel, fraction, cold_every):
    """tests/test_fused_loops.py's differential: the same bits, the same
    exchange ledger; the dispatches booked as the reference books them
    (one a run fused, one a step on the host loop)."""
    g = powerlaw_community(400, avg_degree=6.0, seed=11)
    mesh = _mesh(4)
    sf, sh = TD.ExchangeStats(), TD.ExchangeStats()
    got = _factory_run(kernel, g, mesh, sf, True, fraction, cold_every)
    want = _factory_run(kernel, g, mesh, sh, False, fraction, cold_every)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    assert sf.snapshot()[:5] == sh.snapshot()[:5]
    assert sf.dispatches == 1 and sh.dispatches == sh.steps > 1


# ------------------------------------------ the ledger against the reference
def _ledger_matrix(D, g, inv, mesh) -> dict:
    """Every factory's `as_dict()` over the exchange configs and both
    ``fused`` values; ``D`` is either package's dist module."""
    out = {}
    srcs = SOURCES
    for fused in (True, False):
        for f, c in EXCHANGE_CONFIGS:
            kw = dict(hot_prefix_fraction=f, cold_every=c, fused=fused)
            runs = {
                "bfs": lambda st: D.make_distributed_bfs(
                    g, mesh, stats=st, **kw)(srcs),
                "sssp": lambda st: D.make_distributed_sssp(
                    g, mesh, canonical_ids=inv, stats=st, **kw)(srcs),
                "cc": lambda st: D.make_distributed_cc(
                    g, mesh, stats=st, **kw)(),
            }
            for name, go in runs.items():
                st = D.ExchangeStats()
                go(st)
                out[f"{name} f={f} c={c} fused={fused}"] = st.as_dict()
        st = D.ExchangeStats()
        D.make_distributed_pagerank(g, mesh, stats=st, fused=fused)[0]()
        out[f"pr fused={fused}"] = st.as_dict()
        st = D.ExchangeStats()
        D.make_distributed_bc(g, mesh, stats=st, fused=fused)(srcs)
        out[f"bc fused={fused}"] = st.as_dict()
    return out


def test_ledger_equals_reference_one_device(packed):
    """In process (one host device for jax): the step cadence, the
    termination step and the dispatches equal the reference's."""
    g, inv, _ = packed
    want = _ledger_matrix(JD, g, inv, jax.make_mesh((1,), ("data",)))
    got = _ledger_matrix(TD, g, inv, _mesh(1))
    assert got == want


def test_ledger_equals_reference_four_forced_devices(packed):
    """The reference's sharded BFS, SSSP, CC, PR and BC on 4 forced host
    devices print each `as_dict()`; the port's 4 CPU shards give the
    same, field by field (steps, full and hot, every byte count,
    savings, dispatches)."""
    prog = textwrap.dedent("""
        import json
        import numpy as np
        import jax
        assert jax.device_count() == 4, jax.devices()
        from repro.core import dist as JD
        from repro.core.baselines import dbg_order
        from repro.core.generators import powerlaw_community
        import test_torch_dist as T

        g0 = powerlaw_community(2000, avg_degree=8.0, seed=3)
        perm = np.asarray(dbg_order(g0))
        g = g0.apply_permutation(perm)
        inv = np.empty_like(perm); inv[perm] = np.arange(len(perm))
        mesh = jax.make_mesh((4,), ("data",))
        print("LEDGER " + json.dumps(T._ledger_matrix(JD, g, inv, mesh)))
    """)
    res = run_forced_four_devices(
        ["-c", "import sys; sys.path.insert(0, 'tests'); " + prog],
        timeout=300)
    assert res.returncode == 0, f"stdout={res.stdout}\nstderr={res.stderr}"
    line = next(x for x in res.stdout.splitlines()
                if x.startswith("LEDGER "))
    want = json.loads(line[len("LEDGER "):])
    g, inv, _ = packed
    got = _ledger_matrix(TD, g, inv, _mesh(4))
    assert set(got) == set(want)
    for key in want:
        assert got[key] == want[key], key
    # the hot prefix really thinned the exchange in this matrix
    assert want["sssp f=0.05 c=4 fused=True"]["steps_hot"] > 0
