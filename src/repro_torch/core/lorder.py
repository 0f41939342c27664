"""LOrder — the paper's locality-based reordering (Algorithms 1 & 2).

Pass 1 (locality formation, Alg. 1): scan vertices in original id order;
every unassigned vertex seeds a κ-hop BFS over unassigned vertices; all
discovered vertices join that seed's locality. Localities are disjoint and
complete. Per-locality hotness = number of hot members (degree > λ,
λ = average degree by default).

Pass 2 (id assignment, Alg. 2): sort localities by hotness descending;
within a locality, emit the seed first, then the hot members, then the cold
members — each group in BFS-discovery order. Hot-first contiguous blocks
give the temporal-locality win; BFS order inside each block preserves the
spatial/community structure.

v2: localities are "ground-truth communities" — the generator's community
labels when available, otherwise connected components (κ = ∞). Higher
reorder cost, better post-reorder locality (paper §1).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .csr import Graph
from .diameter import default_kappa
from .traversal import bfs_order


@dataclasses.dataclass
class LocalityInfo:
    """Diagnostics from pass 1 (consumed by tests and benchmarks)."""
    seeds: np.ndarray          # (L,) seed vertex per locality, formation order
    hotness: np.ndarray        # (L,) hot-member count per locality
    sizes: np.ndarray          # (L,)
    locality_id: np.ndarray    # (V,) locality index (formation order) per vertex
    kappa: int


def form_localities(g: Graph, kappa: int,
                    hot: np.ndarray) -> tuple[list[np.ndarray], LocalityInfo]:
    """Algorithm 1. Returns member lists (BFS discovery order) + diagnostics."""
    n = g.num_vertices
    assigned = np.zeros(n, dtype=bool)
    members: list[np.ndarray] = []
    seeds: list[int] = []
    locality_id = np.empty(n, dtype=np.int64)
    for v in range(n):
        if assigned[v]:
            continue
        order = bfs_order(g, v, kappa, assigned)
        locality_id[order] = len(members)
        members.append(order)
        seeds.append(v)
    hotness = np.array([int(hot[m].sum()) for m in members], dtype=np.int64)
    sizes = np.array([len(m) for m in members], dtype=np.int64)
    info = LocalityInfo(np.array(seeds, dtype=np.int64), hotness, sizes,
                        locality_id, kappa)
    return members, info


def assign_ids(members: list[np.ndarray], info: LocalityInfo,
               hot: np.ndarray) -> np.ndarray:
    """Algorithm 2. Returns perm with perm[old_id] = new_id."""
    # sort localities by hotness descending; stable => ties keep formation
    # order (the order Alg. 1 discovered them in)
    order = np.argsort(-info.hotness, kind="stable")
    n = int(info.locality_id.shape[0])
    perm = np.empty(n, dtype=np.int64)
    index = 0
    for li in order:
        m = members[li]
        seed, rest = m[:1], m[1:]
        h = hot[rest]
        block = np.concatenate([seed, rest[h], rest[~h]])
        perm[block] = np.arange(index, index + len(block))
        index += len(block)
    assert index == n
    return perm


def lorder(g: Graph, kappa: int | None = None,
           hot_threshold: float | None = None,
           return_info: bool = False):
    """LOrder v1 — κ-hop BFS localities (κ defaults to ⌈diameter/2⌉)."""
    if kappa is None:
        kappa = default_kappa(g)
    hot = g.hot_mask(hot_threshold)
    members, info = form_localities(g, kappa, hot)
    perm = assign_ids(members, info, hot)
    return (perm, info) if return_info else perm


def lorder_v2(g: Graph, hot_threshold: float | None = None,
              return_info: bool = False):
    """LOrder v2 — localities are ground-truth communities.

    Uses the generator's community labels when the graph carries them;
    otherwise falls back to connected components (κ = ∞ BFS sweeps).
    """
    hot = g.hot_mask(hot_threshold)
    n = g.num_vertices
    if g.communities is not None:
        labels = np.asarray(g.communities, dtype=np.int64)
        # member lists per community, in ascending vertex id (CSR scan order)
        order = np.argsort(labels, kind="stable")
        lab_sorted = labels[order]
        cuts = np.nonzero(np.diff(lab_sorted))[0] + 1
        members = np.split(order, cuts)
        seeds = np.array([m[0] for m in members], dtype=np.int64)
        hotness = np.array([int(hot[m].sum()) for m in members], dtype=np.int64)
        sizes = np.array([len(m) for m in members], dtype=np.int64)
        locality_id = np.empty(n, dtype=np.int64)
        for i, m in enumerate(members):
            locality_id[m] = i
        info = LocalityInfo(seeds, hotness, sizes, locality_id, kappa=-1)
    else:
        members, info = form_localities(g.undirected, kappa=n, hot=hot)
    perm = assign_ids(members, info, hot)
    return (perm, info) if return_info else perm
