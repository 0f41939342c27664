"""Host-side (numpy) BFS primitives shared by the reordering schemes.

Reordering is preprocessing and runs on the host CPU in any real
deployment; these are vectorized level-synchronous BFS routines over CSR.
"""
from __future__ import annotations

import numpy as np

from .csr import Graph, ranges_to_indices


def bfs_levels(g: Graph, source: int, max_hops: int | None = None,
               blocked: np.ndarray | None = None) -> np.ndarray:
    """Level-synchronous BFS. Returns dist (V,), -1 = unreached.

    ``blocked`` — boolean mask of vertices BFS must not enter (used by the
    locality-formation pass to restrict to unassigned vertices).
    """
    n = g.num_vertices
    dist = np.full(n, -1, dtype=np.int32)
    if blocked is not None and blocked[source]:
        return dist
    dist[source] = 0
    frontier = np.array([source], dtype=np.int64)
    level = 0
    while frontier.size and (max_hops is None or level < max_hops):
        level += 1
        nbrs = g.frontier_neighbors(frontier)
        if nbrs.size == 0:
            break
        cand = np.unique(nbrs)
        new = cand[dist[cand] < 0]
        if blocked is not None:
            new = new[~blocked[new]]
        if new.size == 0:
            break
        dist[new] = level
        frontier = new
    return dist


def bfs_order(g: Graph, source: int, max_hops: int | None,
              assigned: np.ndarray) -> np.ndarray:
    """BFS discovery order from ``source``, restricted to unassigned vertices.

    Mutates ``assigned`` (marks every discovered vertex). Discovery order is
    level-by-level, within a level by ascending vertex id (deterministic,
    matching a serial CSR scan). Returns the discovered vertex ids in order,
    beginning with ``source``.
    """
    out = [np.array([source], dtype=np.int64)]
    assigned[source] = True
    frontier = out[0]
    level = 0
    while frontier.size and (max_hops is None or level < max_hops):
        level += 1
        nbrs = g.frontier_neighbors(frontier)
        if nbrs.size == 0:
            break
        cand = np.unique(nbrs)
        new = cand[~assigned[cand]]
        if new.size == 0:
            break
        assigned[new] = True
        out.append(new)
        frontier = new
    return np.concatenate(out)


def farthest_vertex(g: Graph, source: int) -> tuple[int, int]:
    """(vertex, eccentricity) of the farthest reachable vertex from source."""
    dist = bfs_levels(g, source)
    ecc = int(dist.max())
    return int(np.argmax(dist)), ecc
