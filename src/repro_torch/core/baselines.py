"""Comparison reordering schemes (paper §3): Sort, DBG, HubSort/HubCluster,
SOrder, NOrder and (windowed-greedy) GOrder, plus identity/random controls —
and host-side numpy *kernel baselines* (bottom of this module), the
independent oracles every execution backend is checked against
(tests/test_parity_matrix.py).

All schemes return ``perm`` with ``perm[old_id] = new_id``.
"""
from __future__ import annotations

import heapq

import numpy as np

from .csr import Graph
from .traversal import bfs_levels, bfs_order


# --------------------------------------------------------------- controls
def identity_order(g: Graph) -> np.ndarray:
    return np.arange(g.num_vertices, dtype=np.int64)


def random_order(g: Graph, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).permutation(g.num_vertices)


# ------------------------------------------------------------------- Sort
def sort_order(g: Graph) -> np.ndarray:
    """Full sort by degree descending (stable)."""
    by_deg = np.argsort(-g.degree.astype(np.int64), kind="stable")
    perm = np.empty(g.num_vertices, dtype=np.int64)
    perm[by_deg] = np.arange(g.num_vertices)
    return perm


# ------------------------------------------------------- HubSort / HubCluster
def hubsort_order(g: Graph, hot_threshold: float | None = None) -> np.ndarray:
    """Hot vertices first sorted by degree desc; cold keep original order."""
    hot = g.hot_mask(hot_threshold)
    hot_ids = np.nonzero(hot)[0]
    hot_ids = hot_ids[np.argsort(-g.degree[hot_ids].astype(np.int64), kind="stable")]
    cold_ids = np.nonzero(~hot)[0]
    perm = np.empty(g.num_vertices, dtype=np.int64)
    perm[np.concatenate([hot_ids, cold_ids])] = np.arange(g.num_vertices)
    return perm


def hubcluster_order(g: Graph, hot_threshold: float | None = None) -> np.ndarray:
    """Hot vertices first (original relative order); cold after (ditto)."""
    hot = g.hot_mask(hot_threshold)
    perm = np.empty(g.num_vertices, dtype=np.int64)
    perm[np.concatenate([np.nonzero(hot)[0], np.nonzero(~hot)[0]])] = \
        np.arange(g.num_vertices)
    return perm


# -------------------------------------------------------------------- DBG
def dbg_order(g: Graph, num_groups: int = 8) -> np.ndarray:
    """Degree-Based Grouping (paper §3.5): power-law degree bins, vertices
    keep original relative order within each bin; hotter bins get lower ids.

    Bin boundaries follow the power law: avg·2^k for k = num_groups-2 … 0,
    then the sub-average group.
    """
    deg = g.degree.astype(np.float64)
    avg = max(g.average_degree, 1.0)
    # group 0 = hottest. deg > avg*2^(G-2) -> 0, ..., deg > avg -> G-2, else G-1
    thresholds = avg * (2.0 ** np.arange(num_groups - 2, -1, -1))
    group = np.full(g.num_vertices, num_groups - 1, dtype=np.int64)
    for gi, t in enumerate(thresholds):
        group[(group == num_groups - 1) & (deg > t)] = gi
    order = np.argsort(group, kind="stable")  # stable keeps original order
    perm = np.empty(g.num_vertices, dtype=np.int64)
    perm[order] = np.arange(g.num_vertices)
    return perm


# ----------------------------------------------------------------- SOrder
def sorder_order(g: Graph, kappa: int = 2,
                 hot_threshold: float | None = 50.0) -> np.ndarray:
    """Structure-preserved reordering (paper §3.3).

    Hypernode = κ-hop BFS aggregate of adjacent *cold* unvisited vertices
    from a seed; emit hypernode members, then their hot neighbours, then
    their cold neighbours. Paper evaluation uses λ=50, κ=2.
    """
    thr = g.average_degree if hot_threshold is None else hot_threshold
    hot = g.degree > thr
    n = g.num_vertices
    assigned = np.zeros(n, dtype=bool)
    pieces: list[np.ndarray] = []
    for v in range(n):
        if assigned[v]:
            continue
        if hot[v]:  # hot seeds form singleton hypernodes
            assigned[v] = True
            pieces.append(np.array([v], dtype=np.int64))
            continue
        # grow hypernode over cold unassigned vertices only
        blocked = assigned | hot
        blocked[v] = False
        hyper = bfs_order(g, v, kappa, blocked)
        assigned[hyper] = True
        # neighbours of the hypernode, split hot-first
        nbrs = np.unique(g.frontier_neighbors(hyper))
        nbrs = nbrs[~assigned[nbrs]]
        hn, cn = nbrs[hot[nbrs]], nbrs[~hot[nbrs]]
        assigned[hn] = True
        assigned[cn] = True
        pieces.append(np.concatenate([hyper, hn, cn]))
    order = np.concatenate(pieces)
    perm = np.empty(n, dtype=np.int64)
    perm[order] = np.arange(n)
    return perm


# ----------------------------------------------------------------- NOrder
def norder_order(g: Graph, hot_threshold: float | None = None) -> np.ndarray:
    """Neighbourhood reordering (paper §3.4): first sort vertices by hotness
    descending; then BFS serially from each listed vertex (skipping visited);
    new ids follow traversal order. Two full traversals => ~2x reorder time.
    """
    n = g.num_vertices
    by_deg = np.argsort(-g.degree.astype(np.int64), kind="stable")
    assigned = np.zeros(n, dtype=bool)
    pieces: list[np.ndarray] = []
    for v in by_deg:
        if assigned[v]:
            continue
        pieces.append(bfs_order(g, int(v), None, assigned))
    order = np.concatenate(pieces)
    perm = np.empty(n, dtype=np.int64)
    perm[order] = np.arange(n)
    return perm


# ----------------------------------------------------------------- GOrder
def gorder_order(g: Graph, window: int = 8,
                 max_vertices: int = 1 << 17) -> np.ndarray:
    """Windowed-greedy GOrder (paper §3.2, Wei et al.).

    Greedy maximisation of F(φ) = Σ_{0<φ(v)-φ(u)<=ω} S(u,v) with
    S = #common in-neighbours + #direct edges, via a lazy-update max-heap.
    Deliberately expensive — that is the paper's point — so guarded by
    ``max_vertices``.
    """
    n = g.num_vertices
    if n > max_vertices:
        raise ValueError(f"GOrder guard: {n} > {max_vertices} vertices")
    gt = g.transpose  # in-neighbours
    und = g.undirected

    score = np.zeros(n, dtype=np.float64)  # score vs current window
    placed = np.zeros(n, dtype=bool)
    heap: list[tuple[float, int]] = []

    def bump(vs: np.ndarray, delta: float):
        if len(vs) == 0:
            return
        np.add.at(score, vs, delta)
        for v in np.unique(vs):
            if not placed[v]:
                heapq.heappush(heap, (-score[v], int(v)))

    def contributions(v: int) -> np.ndarray:
        """Vertices whose S(·,v) gets a +1 when v joins/leaves the window:
        direct neighbours (sibling term S_n) and out-neighbours' other
        in-neighbours (common in-neighbour term S_s)."""
        direct = und.neighbors(v)
        sibs = gt.frontier_neighbors(np.asarray(g.neighbors(v), dtype=np.int64))
        return np.concatenate([direct, sibs])

    start = int(np.argmax(g.degree))
    order = np.empty(n, dtype=np.int64)
    window_buf: list[int] = []
    heapq.heappush(heap, (-0.0, start))
    score[start] = 0.0
    seq = iter(np.argsort(-g.degree.astype(np.int64), kind="stable"))

    for pos in range(n):
        v = None
        while heap:
            negs, cand = heapq.heappop(heap)
            if placed[cand]:
                continue
            if -negs != score[cand]:
                continue  # stale entry
            v = cand
            break
        if v is None:  # disconnected remainder: next unplaced by degree
            for cand in seq:
                if not placed[cand]:
                    v = int(cand)
                    break
        placed[v] = True
        order[pos] = v
        window_buf.append(v)
        bump(contributions(v), +1.0)
        if len(window_buf) > window:
            old = window_buf.pop(0)
            bump(contributions(old), -1.0)

    perm = np.empty(n, dtype=np.int64)
    perm[order] = np.arange(n)
    return perm


# ------------------------------------------------- numpy kernel baselines
#
# Pure-host reference implementations of the six served kernels, written
# against a different execution model (python loops + np.ufunc.at) than
# the JAX kernels so parity failures implicate the device path, not a
# shared bug. BFS depths come from core.traversal.bfs_levels.


def bfs_baseline(g: Graph, source: int) -> np.ndarray:
    """(V,) hop depths, -1 unreached."""
    return bfs_levels(g, source)


def pagerank_baseline(g: Graph, damping: float = 0.85, iters: int = 20,
                      tol: float = 1e-6) -> np.ndarray:
    """(V,) PageRank, pull mode with uniform dangling redistribution."""
    n = g.num_vertices
    r = np.full(n, 1.0 / n)
    outdeg = np.maximum(g.out_degree.astype(np.float64), 1.0)
    t = g.transpose
    for _ in range(iters):
        contrib = r / outdeg
        summed = np.zeros(n)
        np.add.at(summed, t.edge_src, contrib[t.indices])
        dangling = r[g.out_degree == 0].sum()
        r_new = (1 - damping) / n + damping * (summed + dangling / n)
        if np.abs(r_new - r).sum() <= tol:
            return r_new
        r = r_new
    return r


def cc_baseline(g: Graph) -> np.ndarray:
    """(V,) component labels = min vertex id, union-find over symmetrized
    edges (the labeling cc_labelprop converges to)."""
    parent = np.arange(g.num_vertices)

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for u, v in zip(g.edge_src, g.indices):
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[max(ru, rv)] = min(ru, rv)
    return np.array([find(v) for v in range(g.num_vertices)])


def sssp_baseline(g: Graph, weights: np.ndarray, source: int) -> np.ndarray:
    """(V,) Bellman-Ford distances for the given out-CSR-aligned weights."""
    n = g.num_vertices
    INF = np.int64(2**31 - 1)
    dist = np.full(n, INF)
    dist[source] = 0
    for _ in range(n):
        du = dist[g.edge_src]
        cand = np.where(du == INF, INF, du + weights)
        new = dist.copy()
        np.minimum.at(new, g.indices, cand)
        if np.array_equal(new, dist):
            break
        dist = new
    return dist


def bc_baseline(g: Graph, sources) -> np.ndarray:
    """(V,) Brandes betweenness aggregated over ``sources`` (unweighted)."""
    n = g.num_vertices
    total = np.zeros(n)
    for s in sources:
        depth = bfs_levels(g, s)
        sigma = np.zeros(n)
        sigma[s] = 1.0
        maxl = depth.max()
        src, dst = g.edge_src, g.indices
        tree = (depth[dst] == depth[src] + 1) & (depth[src] >= 0)
        for lvl in range(maxl):
            m = tree & (depth[src] == lvl)
            np.add.at(sigma, dst[m], sigma[src[m]])
        delta = np.zeros(n)
        for lvl in range(maxl - 1, -1, -1):
            m = tree & (depth[src] == lvl)
            contrib = sigma[src[m]] / np.maximum(sigma[dst[m]], 1e-30) \
                * (1.0 + delta[dst[m]])
            np.add.at(delta, src[m], contrib)
        delta[s] = 0.0
        total += delta
    return total


def knn_search_baseline(g: Graph, vectors: np.ndarray, query: np.ndarray,
                        entry: int, beam_width: int = 32, k_return: int = 10,
                        max_steps: int | None = None
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Host beam search mirroring algos.kernels.knn_search in original-id
    space: same composite (float32-distance-bits, id) ranking keys, same
    bounded beam-and-merge, same visited accounting. Returns
    ``(ids (k_return,) int64 with -1 padding, visited (V,) bool)``.

    Distances are float32 like the kernel's; summation *order* may differ
    from XLA's, so exact key parity holds when coordinates are
    integer-valued (exact float32 sums) and is recall-level otherwise.
    """
    vecs = np.asarray(vectors, np.float32)
    q = np.asarray(query, np.float32)
    if max_steps is None:
        max_steps = 2 * beam_width + 32  # search.serve.default_max_steps

    def key(v):
        d = np.float32(((vecs[v] - q) ** 2).sum(dtype=np.float32))
        return (int(d.view(np.int32)), int(v))  # lexicographic, like jnp

    beam = [(key(entry), int(entry), False)]
    visited = np.zeros(g.num_vertices, dtype=bool)
    visited[entry] = True
    for _ in range(max_steps):
        frontier = [(k, v) for k, v, e in beam if not e]
        if not frontier:
            break
        _, best = min(frontier)
        beam = [(k, v, e or v == best) for k, v, e in beam]
        for w in map(int, g.neighbors(best)):
            if visited[w]:
                continue
            visited[w] = True
            beam.append((key(w), w, False))
        beam.sort(key=lambda t: t[0])
        del beam[beam_width:]
    ids = np.full(k_return, -1, dtype=np.int64)
    for i, (_, v, _) in enumerate(beam[:k_return]):
        ids[i] = v
    return ids, visited


# ---------------------------------------------------------------- registry
def reordering_registry() -> dict:
    """name -> callable(graph, **kw) for the benchmark harness."""
    from .lorder import lorder, lorder_v2
    return {
        "original": identity_order,
        "random": random_order,
        "sort": sort_order,
        "hubsort": hubsort_order,
        "hubcluster": hubcluster_order,
        "dbg": dbg_order,
        "sorder": sorder_order,
        "norder": norder_order,
        "gorder": gorder_order,
        "lorder": lorder,
        "lorder-v2": lorder_v2,
    }
