"""Search-graph builders: exact k-NN and NSW-style incremental insert.

Both emit a **fixed out-degree** CSR (every row exactly ``k`` slots) so
the beam-search kernel can gather neighbor rows with one
``lax.dynamic_slice`` and the graph rides the existing
``GraphArrays``/bucketing upload path unchanged. Rows with fewer than
``k`` real links are padded with self-loops — a self-loop is inert under
beam search (the owning vertex is already visited when its row is
expanded) — while *non-self* duplicates within a row are forbidden
(``validate_search_graph``) because visit accounting counts each
first-touch once per row scan.
"""
from __future__ import annotations

from collections import Counter

import numpy as np

from ..core.csr import Graph, from_edges


def _sq_dists(points: np.ndarray, q: np.ndarray) -> np.ndarray:
    """(N,) squared L2 distances in float64 (build-time precision; the
    serving kernel ranks in float32 — see algos.kernels.knn_search)."""
    d = points.astype(np.float64) - q.astype(np.float64)
    return np.einsum("nd,nd->n", d, d)


def medoid_entry(vectors: np.ndarray) -> int:
    """Vertex nearest the corpus centroid — the canonical entry point."""
    c = np.asarray(vectors, np.float64).mean(axis=0)
    return int(np.argmin(_sq_dists(np.asarray(vectors), c)))


def knn_brute_force(vectors: np.ndarray, queries: np.ndarray,
                    k: int) -> np.ndarray:
    """Exact (Q, k) nearest-neighbor ids, ties broken by vertex id — the
    recall ground truth every served result is scored against."""
    vecs = np.asarray(vectors, np.float64)
    out = np.empty((len(queries), k), dtype=np.int64)
    for i, q in enumerate(np.asarray(queries, np.float64)):
        d = _sq_dists(vecs, q)
        out[i] = np.argsort(d, kind="stable")[:k]
    return out


def build_knn_graph(vectors: np.ndarray, k: int,
                    name: str = "knn") -> Graph:
    """Brute-force exact k-NN graph (CI scale): each vertex points at its
    ``k`` nearest *other* vertices, ties broken by id."""
    vecs = np.asarray(vectors, np.float64)
    n = len(vecs)
    if not 0 < k < n:
        raise ValueError(f"need 0 < k < num_vectors, got k={k}, n={n}")
    dst = np.empty((n, k), dtype=np.int64)
    for v in range(n):
        d = _sq_dists(vecs, vecs[v])
        d[v] = np.inf
        dst[v] = np.argsort(d, kind="stable")[:k]
    src = np.repeat(np.arange(n, dtype=np.int64), k)
    return from_edges(n, src, dst.ravel(), name=name)


def _beam_search_rows(rows: list, vecs: np.ndarray, q: np.ndarray,
                      entry: int, beam_width: int) -> list[tuple[float, int]]:
    """Host best-first search over mutable adjacency rows (build-time only;
    the serving-path mirror lives in core.baselines.knn_search_baseline)."""
    dq = lambda v: float(_sq_dists(vecs[v][None], q)[0])
    beam = [(dq(entry), entry)]
    expanded: set[int] = set()
    visited = {entry}
    while True:
        frontier = [(d, v) for d, v in beam if v not in expanded]
        if not frontier:
            return beam
        _, v = min(frontier)
        expanded.add(v)
        for w in rows[v]:
            if w in visited:
                continue
            visited.add(w)
            beam.append((dq(w), w))
        beam.sort()
        del beam[beam_width:]


def _sqd(vecs: np.ndarray, a: int, b: int) -> float:
    d = vecs[a] - vecs[b]
    return float(d @ d)


def _diverse_k(vecs: np.ndarray, u: int, cands, k: int) -> list[int]:
    """HNSW-style select-neighbors heuristic (Malkov & Yashunin alg. 4):
    walk candidates nearest-first and keep one only if it is closer to
    ``u`` than to every neighbor already kept, backfilling with the
    nearest skipped. Plain keep-the-k-nearest would converge every row
    to the exact k-NN graph — which is *disconnected* across clusters;
    the diversity rule is what preserves the long-range edges greedy
    search needs to hop between them."""
    order = sorted({int(c) for c in cands} - {u},
                   key=lambda w: (_sqd(vecs, u, w), w))
    kept: list[int] = []
    skipped: list[int] = []
    for c in order:
        if len(kept) >= k:
            break
        dc = _sqd(vecs, u, c)
        if all(dc < _sqd(vecs, c, s) for s in kept):
            kept.append(c)
        else:
            skipped.append(c)
    kept += skipped[:k - len(kept)]
    return kept


def _nsw_connect(rows: dict, vecs: np.ndarray, new: int,
                 neighbors: list[int], k: int) -> None:
    """Link ``new`` -> ``neighbors`` and reverse-link each neighbor back,
    re-selecting overfull rows with the diversity heuristic so every row
    keeps exactly ``k`` slots (self-loop padded while underfull)."""
    rows[new] = list(neighbors) + [new] * (k - len(neighbors))
    for u in neighbors:
        row = [w for w in rows[u] if w != u]  # drop self-loop pads
        if new in row:
            continue
        row.append(new)
        if len(row) > k:
            row = _diverse_k(vecs, u, row, k)
        rows[u] = row + [u] * (k - len(row))


def _nsw_rows(vecs: np.ndarray, k: int, ef: int,
              start_rows: list | None = None,
              order=None) -> list:
    """Insert vertices per ``order`` (default: remaining ids ascending)
    into the rows of ``start_rows``; returns all rows id-ordered."""
    rows: dict[int, list] = dict(enumerate(start_rows or []))
    inserted = list(rows)
    if order is None:
        order = range(len(rows), len(vecs))
    for v in order:
        if not rows:
            rows[v] = [v] * k  # first vertex: all self-loops
            inserted.append(v)
            continue
        cands = _beam_search_rows(rows, vecs, vecs[v], inserted[0], ef)
        nbrs = _diverse_k(vecs, v, [w for _, w in cands], k)
        _nsw_connect(rows, vecs, v, nbrs, k)
        inserted.append(v)
    return [rows[i] for i in range(len(vecs))]


def build_nsw_graph(vectors: np.ndarray, k: int, ef: int | None = None,
                    name: str = "nsw") -> Graph:
    """NSW-style incremental-insert graph: each point is beam-searched
    against the already-inserted set and linked to its ``ef``-best
    candidates' top ``k``, with capped reverse links. Early inserts keep
    long-range edges, which is what makes greedy search navigable across
    clusters (Coleman et al. §2) — so insertion runs in a deterministic
    *shuffled* order: corpora often arrive cluster-sorted (e.g.
    `core.generators.clustered_vectors`), and inserting cluster-by-cluster
    leaves no early cross-cluster links for later reverse-link
    replacement to preserve."""
    vecs = np.asarray(vectors, np.float64)
    order = np.random.default_rng(7).permutation(len(vecs))
    rows = _nsw_rows(vecs, k, ef or 2 * k + 16, order=order)
    src = np.repeat(np.arange(len(rows), dtype=np.int64), k)
    return from_edges(len(rows), src, np.concatenate(
        [np.asarray(r, np.int64) for r in rows]), name=name)


def nsw_insert_deltas(g: Graph, vectors: np.ndarray,
                      new_vectors: np.ndarray, ef: int | None = None
                      ) -> tuple[int, np.ndarray, np.ndarray]:
    """Incremental NSW insert as an ``update_graph`` delta.

    Returns ``(add_vertices, add_edges, remove_edges)`` growing ``g``
    (built over ``vectors``) by ``new_vectors``, for
    ``session.update_graph(..., add_vertices=, add_edges=,
    remove_edges=, vectors=new_vectors)``.
    """
    k = validate_search_graph(g)
    vecs = np.concatenate([np.asarray(vectors, np.float64),
                           np.asarray(new_vectors, np.float64)])
    base = g.num_vertices
    grown = _nsw_rows(vecs, k, ef or 2 * k + 16,
                      start_rows=[list(map(int, g.neighbors(v)))
                                  for v in range(base)])
    added, removed = [], []
    for v in range(base, len(vecs)):
        added.extend((v, w) for w in grown[v])
    for u in range(base):  # multiset diff of each pre-existing row
        cb = Counter(map(int, g.neighbors(u)))
        ca = Counter(grown[u])
        for e, c in (ca - cb).items():
            added.extend([(u, e)] * c)
        for e, c in (cb - ca).items():
            removed.extend([(u, e)] * c)
    to_arr = lambda es: (np.asarray(es, np.int64).reshape(-1, 2)
                         if es else np.empty((0, 2), np.int64))
    return len(new_vectors), to_arr(added), to_arr(removed)


def validate_search_graph(g: Graph) -> int:
    """Check fixed out-degree and no duplicate non-self neighbors;
    returns the out-degree ``k``."""
    deg = g.out_degree
    if g.num_vertices == 0:
        raise ValueError("empty search graph")
    k = int(deg[0])
    if not np.all(deg == k) or k == 0:
        raise ValueError("search graph must have fixed nonzero out-degree, "
                         f"got degrees in [{deg.min()}, {deg.max()}]")
    for v in range(g.num_vertices):
        row = g.neighbors(v)
        real = row[row != v]
        if len(np.unique(real)) != len(real):
            raise ValueError(f"duplicate neighbors in row {v}")
    return k
