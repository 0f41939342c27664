"""Diameter estimation (double-sweep BFS) and the paper's κ = D/2 rule.

The paper's headline structural observation (Table 5.2) is that the
optimal locality radius κ equals half the graph diameter ("κ is also
referred to as the radius"). Diameter is estimated with the standard iterated double-sweep
lower bound on the symmetrized graph — the same figure SNAP reports
(longest shortest path, effective on the largest component).
"""
from __future__ import annotations

import numpy as np

from .csr import Graph
from .traversal import bfs_levels, farthest_vertex


def estimate_diameter(g: Graph, sweeps: int = 4, seed: int = 0) -> int:
    """Iterated double-sweep BFS diameter lower bound (exact on trees)."""
    und = g.undirected
    if und.num_vertices == 0:
        return 0
    rng = np.random.default_rng(seed)
    # start from the highest-degree vertex (lands in the giant component)
    start = int(np.argmax(und.out_degree))
    best = 0
    for s in range(sweeps):
        far, ecc = farthest_vertex(und, start)
        best = max(best, ecc)
        if ecc == 0:
            break
        start = far
        if s >= 1:  # extra restarts from random vertices sharpen the bound
            dist = bfs_levels(und, int(rng.integers(und.num_vertices)))
            best = max(best, int(dist.max()))
    return int(best)


def two_sweep_diameter(g: Graph) -> int:
    """Single double-sweep diameter lower bound — the engine's cheap probe.

    Two BFS passes total (vs ``estimate_diameter``'s iterated sweeps plus
    random restarts): BFS from the highest-degree vertex, then BFS from the
    farthest vertex found. Within a few percent of the iterated bound on
    the paper's graph families at a fraction of the probe cost.
    """
    und = g.undirected
    if und.num_vertices == 0:
        return 0
    start = int(np.argmax(und.out_degree))
    far, ecc = farthest_vertex(und, start)
    if ecc == 0:
        return 0
    _, ecc2 = farthest_vertex(und, far)
    return int(max(ecc, ecc2))


def default_kappa(g: Graph, diameter: int | None = None) -> int:
    """κ = ⌈D / 2⌉ — the radius (paper Table 5.2)."""
    d = estimate_diameter(g) if diameter is None else diameter
    return max(1, (d + 1) // 2)
