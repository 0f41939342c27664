"""Compressed Sparse Row graph container (paper §2.2).

Graphs are stored as out-edge CSR (``indptr``, ``indices``) in numpy on the
host — reordering is host-side preprocessing, exactly as in real deployments
— with cached in-edge CSR (the transpose) for pull-mode kernels and lazy JAX
views for the compute layer.

Vertex relabeling semantics: ``perm[old_id] == new_id``. Applying a
permutation produces an isomorphic graph whose CSR arrays realize the new
memory layout; per-row neighbor lists are kept sorted (as CSR construction
would produce), matching the paper's Figure 2.2.1 layout.
"""
from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np


def ranges_to_indices(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Flatten [starts[i], starts[i]+counts[i]) ranges into one index array.

    Vectorized equivalent of ``np.concatenate([np.arange(s, s+c) ...])``.
    """
    starts = np.asarray(starts, dtype=np.int64)
    counts = np.asarray(counts, dtype=np.int64)
    nz = counts > 0
    starts, counts = starts[nz], counts[nz]
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    out = np.ones(total, dtype=np.int64)
    out[0] = starts[0]
    pos = np.cumsum(counts)[:-1]
    out[pos] = starts[1:] - (starts[:-1] + counts[:-1] - 1)
    return np.cumsum(out)


@dataclasses.dataclass
class Graph:
    """Directed multigraph in CSR (out-edge) form."""

    indptr: np.ndarray   # (V+1,) int64
    indices: np.ndarray  # (E,) int32 — destination vertex of each out-edge
    communities: np.ndarray | None = None  # optional ground-truth labels (V,)
    name: str = "graph"

    def __post_init__(self):
        self.indptr = np.asarray(self.indptr, dtype=np.int64)
        self.indices = np.asarray(self.indices, dtype=np.int32)

    # ------------------------------------------------------------------ sizes
    @property
    def num_vertices(self) -> int:
        return len(self.indptr) - 1

    @property
    def num_edges(self) -> int:
        return len(self.indices)

    # ---------------------------------------------------------------- degrees
    @cached_property
    def out_degree(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.int32)

    @cached_property
    def in_degree(self) -> np.ndarray:
        return np.bincount(self.indices, minlength=self.num_vertices).astype(np.int32)

    @cached_property
    def degree(self) -> np.ndarray:
        """Total degree (in+out) — the hotness basis (paper §2.1)."""
        return self.out_degree + self.in_degree

    @property
    def average_degree(self) -> float:
        """The paper's hotness threshold λ = avg degree (0.0 when V = 0)."""
        if self.num_vertices == 0:
            return 0.0
        return float(self.degree.mean())

    def hot_mask(self, threshold: float | None = None) -> np.ndarray:
        """Hot vertex := degree > threshold (default: average degree)."""
        thr = self.average_degree if threshold is None else threshold
        return self.degree > thr

    # ------------------------------------------------------------- structure
    @cached_property
    def edge_src(self) -> np.ndarray:
        """(E,) source vertex per edge (COO row), aligned with ``indices``."""
        return np.repeat(
            np.arange(self.num_vertices, dtype=np.int32), self.out_degree
        )

    @cached_property
    def transpose(self) -> "Graph":
        """In-edge CSR (for pull-mode kernels)."""
        order = np.argsort(self.indices, kind="stable")
        t_indices = self.edge_src[order]
        t_indptr = np.zeros(self.num_vertices + 1, dtype=np.int64)
        np.cumsum(
            np.bincount(self.indices, minlength=self.num_vertices),
            out=t_indptr[1:],
        )
        return Graph(t_indptr, t_indices, self.communities, self.name + ".T")

    @cached_property
    def undirected(self) -> "Graph":
        """Symmetrized view (u->v and v->u), dedup per row."""
        src = np.concatenate([self.edge_src, self.indices])
        dst = np.concatenate([self.indices, self.edge_src])
        return from_edges(self.num_vertices, src, dst, dedup=True,
                          communities=self.communities, name=self.name + ".sym")

    def neighbors(self, v: int) -> np.ndarray:
        return self.indices[self.indptr[v]:self.indptr[v + 1]]

    def frontier_neighbors(self, frontier: np.ndarray) -> np.ndarray:
        """All out-neighbors of a vertex frontier (vectorized, with repeats)."""
        starts = self.indptr[frontier]
        counts = self.indptr[frontier + 1] - starts
        return self.indices[ranges_to_indices(starts, counts)]

    # ------------------------------------------------------------ relabeling
    def apply_permutation(self, perm: np.ndarray) -> "Graph":
        """Return the isomorphic graph with vertex u renamed perm[u]."""
        perm = np.asarray(perm, dtype=np.int64)
        n = self.num_vertices
        assert perm.shape == (n,)
        inv = np.empty(n, dtype=np.int64)
        inv[perm] = np.arange(n, dtype=np.int64)

        deg = self.out_degree
        new_indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(deg[inv], out=new_indptr[1:])

        gather = ranges_to_indices(self.indptr[inv], deg[inv].astype(np.int64))
        new_indices = perm[self.indices[gather]].astype(np.int32)
        # keep per-row neighbor lists sorted, as fresh CSR construction would
        row = np.repeat(np.arange(n, dtype=np.int64), deg[inv])
        order = np.lexsort((new_indices, row))
        new_indices = new_indices[order]
        comm = None if self.communities is None else self.communities[inv]
        return Graph(new_indptr, new_indices, comm, self.name)

    def edge_multiset(self) -> np.ndarray:
        """Canonical sorted (src,dst) pairs — isomorphism-check helper."""
        pairs = np.stack([self.edge_src.astype(np.int64), self.indices.astype(np.int64)], 1)
        order = np.lexsort((pairs[:, 1], pairs[:, 0]))
        return pairs[order]


def from_edges(num_vertices: int, src, dst, *, dedup: bool = False,
               communities=None, name: str = "graph") -> Graph:
    """Build CSR from COO edge lists (drops self-loops if dedup)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    if dedup:
        keep = src != dst
        src, dst = src[keep], dst[keep]
        key = src * np.int64(num_vertices) + dst
        _, uniq = np.unique(key, return_index=True)
        src, dst = src[uniq], dst[uniq]
    order = np.argsort(src * np.int64(num_vertices) + dst, kind="stable")
    src, dst = src[order], dst[order]
    indptr = np.zeros(num_vertices + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=num_vertices), out=indptr[1:])
    return Graph(indptr, dst.astype(np.int32), communities, name)


def validate_permutation(perm: np.ndarray, n: int) -> bool:
    perm = np.asarray(perm)
    return perm.shape == (n,) and np.array_equal(np.sort(perm), np.arange(n))
