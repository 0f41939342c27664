"""PyTorch port: k-NN beam search answers as the JAX package's does.

The port's batched `knn_search_multi` against the reference's vmapped
`knn_search_multi` on the same integer-valued corpora (exact float32
distance sums), ids and visit counts bit for bit, pad lanes masked; its
sort key against ``np.lexsort`` and its argmin against the first-minimum
rule; and the single-device cases of tests/test_search.py run on
``repro_torch.EngineSession(device="cpu")`` beside the reference's
session: the same ids, the host oracle's ids and visits, recall@10 of at
least 0.95, bit-identical ids across the identity, visitsort and patch
layouts.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.engine as jax_engine  # noqa: E402
import repro_torch.engine as torch_engine  # noqa: E402
from repro.algos import graph_arrays as jga  # noqa: E402
from repro.algos import kernels as JK  # noqa: E402
from repro.core.baselines import knn_search_baseline  # noqa: E402
from repro.core.generators import clustered_vectors  # noqa: E402
from repro.search import (SearchParams, build_nsw_graph, knn_brute_force,  # noqa: E402
                          medoid_entry, nsw_insert_deltas,
                          validate_search_graph)
from repro_torch.algos import graph_arrays as tga  # noqa: E402
from repro_torch.algos import kernels as TK  # noqa: E402
from repro_torch.engine.backends import bucket_dims  # noqa: E402
from repro_torch.search.serve import SearchParams as TorchSearchParams  # noqa: E402

K_OUT = 8
K_RET = 10
ENGINES = {"jax": jax_engine, "torch": torch_engine}


def _session(name, **kw):
    if name == "torch":
        kw["device"] = "cpu"
    return ENGINES[name].EngineSession(**kw)


def _params(name, **kw):
    return (TorchSearchParams if name == "torch" else SearchParams)(**kw)


@pytest.fixture(scope="module")
def corpus():
    vecs, _ = clustered_vectors(240, dim=8, num_clusters=5, seed=1)
    return vecs


@pytest.fixture(scope="module")
def nsw_graph(corpus):
    return build_nsw_graph(corpus, k=K_OUT)


def _queries(vecs, n=16, seed=0, jitter=0.01):
    rng = np.random.default_rng(seed)
    q = vecs[rng.integers(0, len(vecs), n)]
    return (q + rng.normal(0, jitter, q.shape)).astype(np.float32)


def _recall(got, oracle):
    k = oracle.shape[1]
    return float(np.mean([len(set(map(int, g)) & set(map(int, o))) / k
                          for g, o in zip(got, oracle)]))


# ------------------------------------------------------ kernel vs kernel
# (vertices, dim, k_out, beam, k_return, real lanes, padded lanes, bucketed)
KERNEL_CASES = [
    (150, 6, 6, 16, 8, 12, 16, False),
    (300, 4, 8, 8, 8, 5, 8, True),
    (120, 16, 4, 32, 10, 3, 4, False),
    (200, 3, 6, 12, 5, 9, 16, True),
]


@pytest.mark.parametrize("case", KERNEL_CASES,
                         ids=[f"n{c[0]}-d{c[1]}-k{c[2]}-b{c[3]}"
                              f"{'-bucketed' if c[7] else ''}"
                              for c in KERNEL_CASES])
def test_knn_search_multi_matches_reference_bit_for_bit(case):
    """Integer coordinates make every distance exact in float32, so the
    two packages' keys, ties and visits must agree exactly. The layout is
    a random relabelling (canon = original ids), and pad lanes repeat row
    0 with ``valid`` False, as `pad_queries` makes them."""
    n, dim, k_out, beam, k_ret, real, lanes, bucketed = case
    rng = np.random.default_rng(n + dim)
    vecs = rng.integers(0, 12, (n, dim)).astype(np.float32)
    g = build_nsw_graph(vecs, k=k_out)
    perm = rng.permutation(n)                   # perm[old] = new
    inv = np.argsort(perm)
    served = g.apply_permutation(perm)
    svecs, canon = vecs[inv], inv.astype(np.int32)
    entry = int(perm[medoid_entry(vecs)])
    queries = rng.integers(0, 12, (real, dim)).astype(np.float32)
    queries = np.concatenate([queries, np.repeat(queries[:1], lanes - real,
                                                 axis=0)])
    valid = np.arange(lanes) < real
    pad = bucket_dims(n, served.num_edges) if bucketed else None
    vb = pad[0] if pad else n
    pvecs = np.concatenate([svecs, np.zeros((vb - n, dim), np.float32)])
    pcanon = np.concatenate([canon, np.arange(n, vb, dtype=np.int32)])
    knobs = dict(k_out=k_out, beam_width=beam, k_return=k_ret,
                 max_steps=2 * beam + 32)

    want_ids, want_visits = jax.jit(functools.partial(
        JK.knn_search_multi, **knobs))(
        jga.to_device(served, pad_to=pad), jnp.asarray(pvecs),
        jnp.asarray(pcanon), jnp.int32(entry), jnp.asarray(queries),
        jnp.asarray(valid))
    got_ids, got_visits = TK.knn_search_multi(
        tga.to_device(served, pad_to=pad, device="cpu"),
        torch.from_numpy(pvecs), torch.from_numpy(pcanon), entry,
        torch.from_numpy(queries), torch.from_numpy(valid), **knobs)
    assert got_ids.dtype == torch.int32 and got_visits.dtype == torch.int32
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
    np.testing.assert_array_equal(got_visits.numpy(), np.asarray(want_visits))
    # pad lanes count nothing: the visits are the real lanes' alone
    only_real = TK.knn_search_multi(
        tga.to_device(served, pad_to=pad, device="cpu"),
        torch.from_numpy(pvecs), torch.from_numpy(pcanon), entry,
        torch.from_numpy(queries[:real]), torch.ones(real, dtype=torch.bool),
        **knobs)[1]
    assert torch.equal(only_real, got_visits)


def test_knn_search_single_query_matches_reference():
    rng = np.random.default_rng(11)
    vecs = rng.integers(0, 9, (90, 5)).astype(np.float32)
    g = build_nsw_graph(vecs, k=6)
    entry = medoid_entry(vecs)
    canon = np.arange(90, dtype=np.int32)
    knobs = dict(k_out=6, beam_width=12, k_return=6, max_steps=40)
    for q in rng.integers(0, 9, (4, 5)).astype(np.float32):
        want_ids, want_vis = JK.knn_search(
            jga.to_device(g), jnp.asarray(vecs), jnp.asarray(canon),
            jnp.int32(entry), jnp.asarray(q), **knobs)
        got_ids, got_vis = TK.knn_search(
            tga.to_device(g, device="cpu"), torch.from_numpy(vecs),
            torch.from_numpy(canon), entry, torch.from_numpy(q), **knobs)
        np.testing.assert_array_equal(got_ids.numpy(), np.asarray(want_ids))
        np.testing.assert_array_equal(got_vis.numpy(), np.asarray(want_vis))
        host_ids, host_vis = knn_search_baseline(g, vecs, q, entry,
                                                 beam_width=12, k_return=6,
                                                 max_steps=40)
        np.testing.assert_array_equal(got_ids.numpy(), host_ids)
        np.testing.assert_array_equal(got_vis.numpy(), host_vis)


# ---------------------------------------------------------- sort, argmin
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rank_key_sort_is_lexsort_with_sentinel_ties(seed):
    """One stable sort of ``bits·2³¹ + tie`` orders as ``np.lexsort((tie,
    bits))``: sentinel slots (both halves KNN_SENTINEL) tie with each
    other and keep their order, as do equal distances with equal ids."""
    rng = np.random.default_rng(seed)
    sent = TK.KNN_SENTINEL
    bits = rng.integers(0, 6, (7, 40)).astype(np.int32)
    tie = rng.integers(0, 4, (7, 40)).astype(np.int32)
    bits[:, ::3] = sent
    tie[:, ::3] = sent
    bits[:, 1::5] = 0x7F800000                     # +inf's bits
    bits[0] = sent                                  # a lane of sentinels
    tie[0] = sent
    keys = TK._rank_key(torch.from_numpy(bits), torch.from_numpy(tie))
    got = torch.sort(keys, dim=1, stable=True).indices.numpy()
    for row in range(bits.shape[0]):
        np.testing.assert_array_equal(
            got[row], np.lexsort((tie[row], bits[row])))


def test_dist_bits_order_like_the_floats():
    d = torch.tensor([0.0, 1e-30, 0.5, 1.0, 3.0e38, float("inf")])
    bits = TK._dist_bits(d)
    assert bits.dtype == torch.int32
    assert torch.equal(torch.sort(bits).indices, torch.arange(6))
    np.testing.assert_array_equal(bits.numpy(),
                                  d.numpy().view(np.int32))
    assert int(bits[-1]) < TK.KNN_SENTINEL


@pytest.mark.parametrize("seed", [0, 1])
def test_first_argmin_takes_the_first_minimum(seed):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 3, (50, 17)).astype(np.int32)
    vals[3] = TK.KNN_SENTINEL                       # all equal: index 0
    got = TK._first_argmin(torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(got, np.argmin(vals, axis=1))
    assert got[3] == 0


# ------------------------------------------------- engine round trips
def test_kernel_matches_host_oracle_bit_for_bit_integer_vectors():
    """tests/test_search.py:125 on both sessions."""
    rng = np.random.default_rng(4)
    vecs = rng.integers(0, 12, (150, 6)).astype(np.float32)
    g = build_nsw_graph(vecs, k=6)
    entry = medoid_entry(vecs)
    queries = rng.integers(0, 12, (12, 6)).astype(np.float32)
    got = {}
    for name in ENGINES:
        with _session(name) as s:
            gid = s.register(g, "int-knn", vectors=vecs,
                             search_params=_params(name, k_out=6,
                                                   beam_width=16,
                                                   k_return=8))
            assert s.registry.get(gid).decision.scheme == "original"
            got[name] = s.submit(gid, "knn", queries)
    np.testing.assert_array_equal(got["torch"], got["jax"])
    for q, row in zip(queries, got["torch"]):
        want, _ = knn_search_baseline(g, vecs, q, entry, beam_width=16,
                                      k_return=8)
        assert row.tolist() == want.tolist()


def test_visit_accounting_matches_host_and_masks_pad_lanes(corpus,
                                                           nsw_graph):
    """tests/test_search.py:146 on the port's session."""
    entry = medoid_entry(corpus)
    queries = _queries(corpus, n=5, seed=3)   # pads 5 -> 8 lanes
    with _session("torch") as s:
        gid = s.register(nsw_graph, "visits", vectors=corpus)
        s.submit(gid, "knn", queries)
        e = s.registry.get(gid)
    host_total = sum(int(knn_search_baseline(nsw_graph, corpus, q,
                                             entry)[1].sum())
                     for q in queries)
    assert e.visits_total == host_total       # pad lanes contribute 0
    assert e.visit_queries == 5
    assert e.visit_ewma is not None
    assert np.isclose(e.visit_ewma.sum(), host_total / 5)


def test_recall_at_10_through_engine(corpus, nsw_graph):
    """tests/test_search.py:164 on both sessions: the same ids, and
    recall@10 of at least 0.95 against the brute-force oracle."""
    queries = _queries(corpus, n=24, seed=0)
    oracle = knn_brute_force(corpus, queries, K_RET)
    got = {}
    for name in ENGINES:
        with _session(name) as s:
            gid = s.register(nsw_graph, "recall", vectors=corpus)
            got[name] = s.submit(gid, "knn", queries)
    assert got["torch"].shape == (24, K_RET)
    np.testing.assert_array_equal(got["torch"], got["jax"])
    assert _recall(got["torch"], oracle) >= 0.95


def test_bit_identity_across_layouts(corpus, nsw_graph):
    """tests/test_search.py:174 without its sharded leg: identical ids
    from the identity layout, the full visitsort reorder, the patch-tier
    repack and a cache hit, each equal to the reference session's."""
    queries = _queries(corpus, n=16, seed=5)
    seen = {}
    for name in ENGINES:
        with _session(name) as s:
            gid = s.register(nsw_graph, "bits", vectors=corpus)
            base = s.submit(gid, "knn", queries)
            r1 = s.refresh_hotness(gid)          # original -> visitsort
            assert (r1["tier"], r1["scheme"], r1["hotness_source"]) == (
                "full", "visitsort", "visits")
            assert np.array_equal(s.submit(gid, "knn", queries), base)
            r2 = s.refresh_hotness(gid)          # same decision -> patch
            assert r2["tier"] == "patch"
            assert s._c_patches.value == 1
            assert np.array_equal(s.submit(gid, "knn", queries), base)
            hits0 = s.result_cache.hits          # repeat rides the cache
            assert np.array_equal(s.submit(gid, "knn", queries), base)
            assert s.result_cache.hits == hits0 + 16
            assert s.result_cache.pinned_count == 0
            seen[name] = (base, r1["hot_prefix_len"], r2["hot_prefix_len"])
    np.testing.assert_array_equal(seen["torch"][0], seen["jax"][0])
    assert seen["torch"][1:] == seen["jax"][1:]


def test_refresh_hotness_sizes_prefix_from_visits(corpus, nsw_graph):
    """tests/test_search.py:205 on the port's session."""
    with _session("torch") as s:
        gid = s.register(nsw_graph, "prefix", vectors=corpus)
        e = s.registry.get(gid)
        assert e.probes.family == "search"
        assert e.decision.scheme == "original"   # no telemetry yet
        s.submit(gid, "knn", _queries(corpus, n=16, seed=6))
        r = s.refresh_hotness(gid)
        assert r["tier"] == "full"
        assert e.decision.reason.startswith("search family")
        expected = int(round(e.probes.visit_hub_fraction
                             * e.graph.num_vertices))
        assert e.hot_prefix_len == expected > 0
        assert e.probes.visit_gini > 0
        rec = s.policy.history[-1]
        assert rec.family == "search"
        assert s.policy.calibrator.count("visitsort", family="search") == 1


def test_update_graph_grows_search_graph(corpus, nsw_graph):
    """tests/test_search.py:224 on both sessions: the grown graph serves
    the same ids in both."""
    new_vecs, _ = clustered_vectors(30, dim=8, num_clusters=5, seed=9)
    nadd, add_e, rem_e = nsw_insert_deltas(nsw_graph, corpus, new_vecs)
    assert nadd == 30
    allv = np.concatenate([corpus, new_vecs])
    q2 = (new_vecs[:6] + 0.001).astype(np.float32)
    got = {}
    for name in ENGINES:
        with _session(name, async_full_reorder=False) as s:
            gid = s.register(nsw_graph, "grow", vectors=corpus)
            s.submit(gid, "knn", _queries(corpus, n=8, seed=7))
            info = s.update_graph(gid, add_edges=add_e, remove_edges=rem_e,
                                  add_vertices=nadd, vectors=new_vecs)
            assert info["vertices_added"] == 30
            e = s.registry.get(gid)
            assert e.graph.num_vertices == len(corpus) + 30
            assert len(e.perm) == len(e.inv_perm) == len(e.vectors) \
                == len(corpus) + 30
            assert validate_search_graph(e.graph) == K_OUT
            got[name] = s.submit(gid, "knn", q2)
            with pytest.raises(ValueError):
                s.update_graph(gid, add_vertices=2)      # vectors missing
            with pytest.raises(ValueError):
                s.update_graph(gid, add_vertices=2,
                               vectors=np.zeros((1, 8), np.float32))
    np.testing.assert_array_equal(got["torch"], got["jax"])
    assert _recall(got["torch"], knn_brute_force(allv, q2, K_RET)) >= 0.95


def test_register_and_enqueue_validation(corpus, nsw_graph, tiny_graph):
    """tests/test_search.py:253 on the port's session."""
    s = _session("torch")
    with pytest.raises(ValueError):
        s.register(nsw_graph, "bad-dim", vectors=corpus[:10])
    with pytest.raises(ValueError):          # k_out mismatch
        s.register(nsw_graph, "bad-k", vectors=corpus,
                   search_params=TorchSearchParams(k_out=4))
    with pytest.raises(ValueError):          # search_params without vectors
        s.register(tiny_graph, "no-vecs",
                   search_params=TorchSearchParams(k_out=2))
    gid = s.register(nsw_graph, "ok", vectors=corpus)
    with pytest.raises(ValueError):          # wrong query dimensionality
        s.enqueue(gid, "knn", np.ones((2, 3), np.float32))
    with pytest.raises(ValueError):          # empty batch
        s.enqueue(gid, "knn", np.empty((0, 8), np.float32))
    plain = s.register(tiny_graph, "plain")
    with pytest.raises(ValueError):          # knn needs a search graph
        s.enqueue(plain, "knn", np.ones((1, 8), np.float32))
    s.close()


def test_backend_keys_knn_as_the_reference(corpus, nsw_graph):
    """The LRU key of a knn run, and its counters: one query, one
    dispatch, the real (unpadded) lanes as sources."""
    with _session("torch") as s:
        gid = s.register(nsw_graph, "keys", vectors=corpus)
        s.submit(gid, "knn", _queries(corpus, n=5, seed=1))
        be = s.executor.single
        e = s.registry.get(gid)
        p = e.search_params
        v, ne = e.bucket_shape
        assert str(("knn", v, ne, 8, 8, p.k_out, p.beam_width, p.k_return,
                    p.max_steps)) in be.telemetry()["cached_keys"]
        assert (be.queries_run, be.sources_run,
                be.telemetry()["dispatches"]) == (1, 5, 1)
