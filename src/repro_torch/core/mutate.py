"""Edge-delta mutation for CSR graphs (the dynamic-graph substrate).

Serving graphs mutate: edges appear and disappear under load. The CSR
container (`csr.Graph`) memoizes derived views (`out_degree`,
`transpose`, `undirected`, ...) via ``cached_property``, so mutating its
arrays in place would silently serve stale views. `apply_edge_delta`
therefore builds a **fresh** `Graph` for every delta — no cache can go
stale because no populated cache survives — while transplanting the
degree caches it can update in O(V + |delta|) (a bincount-free update,
the expensive O(E) recomputes stay lazy).

Removal semantics are multiset: each listed ``(src, dst)`` pair removes
exactly one occurrence of that edge, so parallel edges survive until
each copy is removed. Removing an edge that does not exist raises — a
mutation stream that believes in edges the graph doesn't have is a bug
upstream, not something to paper over.

The returned `MutationDelta` is the O(|delta|)-sized summary the engine's
incremental probe maintenance consumes (`engine/registry.py`): which
vertices changed degree and by how much, without touching the O(V)
degree arrays on the mutation path.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .csr import Graph, from_edges, ranges_to_indices


@dataclasses.dataclass(frozen=True)
class MutationDelta:
    """O(|delta|)-sized account of one applied edge delta."""

    added: int
    removed: int
    changed_vertices: np.ndarray   # vertex ids whose degree changed
    out_degree_delta: np.ndarray   # per changed vertex, may be 0
    in_degree_delta: np.ndarray
    degree_delta: np.ndarray       # out + in, aligned with changed_vertices
    vertices_added: int = 0        # vertex-set growth (ids appended at top)

    @property
    def edges_changed(self) -> int:
        return self.added + self.removed


def _as_edge_pairs(edges, num_vertices: int,
                   what: str) -> tuple[np.ndarray, np.ndarray]:
    """Normalize an edge list (k, 2) array / pair iterable; validate ids."""
    if edges is None:
        empty = np.empty(0, dtype=np.int64)
        return empty, empty
    arr = np.asarray(edges, dtype=np.int64)
    if arr.size == 0:
        empty = np.empty(0, dtype=np.int64)
        return empty, empty
    try:
        arr = arr.reshape(-1, 2)
    except ValueError:
        raise ValueError(f"{what} must be (k, 2) edge pairs, "
                         f"got shape {arr.shape}") from None
    if arr.size and (int(arr.min()) < 0 or int(arr.max()) >= num_vertices):
        raise ValueError(
            f"{what} endpoints must be in [0, {num_vertices}); got "
            f"[{int(arr.min())}, {int(arr.max())}]")
    return arr[:, 0].copy(), arr[:, 1].copy()


def _sparse_degree_delta(touched: np.ndarray, add: np.ndarray,
                         rem: np.ndarray) -> np.ndarray:
    """Per-``touched``-vertex count of ``add`` minus ``rem`` endpoints."""
    delta = np.zeros(len(touched), dtype=np.int64)
    if add.size:
        np.add.at(delta, np.searchsorted(touched, add), 1)
    if rem.size:
        np.subtract.at(delta, np.searchsorted(touched, rem), 1)
    return delta


def apply_edge_delta(g: Graph, add_edges=None, remove_edges=None,
                     add_vertices: int = 0) -> tuple[Graph, MutationDelta]:
    """Apply an edge delta; returns ``(fresh_graph, delta_summary)``.

    ``add_vertices`` grows the vertex set by that many ids, appended at
    the top of the id range — ``add_edges`` may then reference the new
    ids (the search workload's incremental NSW inserts arrive this way,
    `search.knn_graph.nsw_insert_deltas`). With ``add_vertices=0`` the
    vertex set is fixed — deltas add/remove *edges* between existing
    vertices (a graph can drain to edgeless and regrow). The fresh graph
    keeps the `Graph` CSR invariants (rows ascending, per-row neighbor
    lists sorted) and carries the original ``communities``/``name``.
    An empty delta returns ``g`` itself (every cached view still valid).
    """
    if add_vertices < 0:
        raise ValueError(f"add_vertices must be >= 0, got {add_vertices}")
    n = g.num_vertices + int(add_vertices)
    asrc, adst = _as_edge_pairs(add_edges, n, "add_edges")
    rsrc, rdst = _as_edge_pairs(remove_edges, n, "remove_edges")
    if asrc.size == 0 and rsrc.size == 0 and add_vertices == 0:
        touched = np.empty(0, dtype=np.int64)
        zero = np.empty(0, dtype=np.int64)
        return g, MutationDelta(0, 0, touched, zero, zero.copy(), zero.copy())
    if rsrc.size and (rsrc >= g.num_vertices).any():
        raise ValueError("remove_edges references newly added vertices")

    key = g.edge_src.astype(np.int64) * np.int64(n) + g.indices
    key = np.sort(key, kind="stable")  # defensive: manual CSRs may be ragged
    if rsrc.size:
        rkey = rsrc * np.int64(n) + rdst
        r_uniq, r_counts = np.unique(rkey, return_counts=True)
        left = np.searchsorted(key, r_uniq, side="left")
        right = np.searchsorted(key, r_uniq, side="right")
        short = r_counts > (right - left)
        if short.any():
            missing = [(int(k // n), int(k % n)) for k in r_uniq[short][:5]]
            raise ValueError(
                f"remove_edges lists edges the graph does not hold "
                f"(or more copies than it holds): {missing}"
                f"{' ...' if int(short.sum()) > 5 else ''}")
        drop = np.zeros(len(key), dtype=bool)
        drop[ranges_to_indices(left, r_counts)] = True
        key = key[~drop]
    new_src = np.concatenate([key // n, asrc])
    new_dst = np.concatenate([key % n, adst])
    # per-vertex metadata (communities) doesn't extend to grown ids
    comms = g.communities if add_vertices == 0 else None
    new_g = from_edges(n, new_src, new_dst, communities=comms, name=g.name)

    # transplant the degree caches in O(V + |delta|): the delta fully
    # describes every endpoint change, so the fresh graph never pays the
    # O(E) bincount that `in_degree` would lazily recompute
    grow = (0, int(add_vertices))
    out_deg = np.pad(np.asarray(g.out_degree, dtype=np.int64), grow)
    in_deg = np.pad(np.asarray(g.in_degree, dtype=np.int64), grow)
    if asrc.size:
        np.add.at(out_deg, asrc, 1)
        np.add.at(in_deg, adst, 1)
    if rsrc.size:
        np.subtract.at(out_deg, rsrc, 1)
        np.subtract.at(in_deg, rdst, 1)
    new_g.__dict__["out_degree"] = out_deg.astype(np.int32)
    new_g.__dict__["in_degree"] = in_deg.astype(np.int32)
    new_g.__dict__["degree"] = (out_deg + in_deg).astype(np.int32)

    touched = np.unique(np.concatenate([asrc, adst, rsrc, rdst]))
    out_delta = _sparse_degree_delta(touched, asrc, rsrc)
    in_delta = _sparse_degree_delta(touched, adst, rdst)
    total = out_delta + in_delta
    changed = total != 0
    delta = MutationDelta(int(asrc.size), int(rsrc.size),
                          touched[changed], out_delta[changed],
                          in_delta[changed], total[changed],
                          vertices_added=int(add_vertices))
    return new_g, delta


__all__ = ["MutationDelta", "apply_edge_delta"]
