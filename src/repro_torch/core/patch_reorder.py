"""Incremental hot-prefix patching of an existing permutation.

The patch tier of the dynamic-graph subsystem. After an edge delta,
re-running LOrder is O(V · κ-hop BFS) — far too expensive for the
request path. But Faldu et al. (*A Closer Look at Lightweight Graph
Reordering*) show hot sets are stable over time, and BOBA shows a
single-pass lightweight repack captures most of the locality win. So a
mutation *patches* the layout: one stable pass over the vertices in
their current served order, re-partitioned so the (possibly changed)
hot set is packed at the front of id space again.

Stability is the point — vertices keep their relative order within the
hot and cold groups, so the locality structure the full reorder built
(community blocks, hub clustering) survives the patch; only vertices
whose hotness flipped move across the boundary. O(V) time, no graph
traversal.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .csr import Graph


@dataclasses.dataclass(frozen=True)
class PatchInfo:
    """Account of one permutation patch."""

    promoted: int        # vertices newly packed into the hot prefix
    demoted: int         # vertices that fell out of the hot prefix
    moved: int           # vertices whose id changed at all
    hot_prefix_len: int  # new hot prefix length
    identity: bool       # True when the patch was a no-op


def patch_permutation(graph: Graph, perm: np.ndarray,
                      old_hot_prefix_len: int,
                      hot_mask: np.ndarray | None = None,
                      ) -> tuple[np.ndarray, np.ndarray, int, PatchInfo]:
    """Stable repack of ``perm`` so ``hot_mask`` fills the prefix.

    ``perm`` maps original vertex id -> served id (the engine's
    convention). ``hot_mask`` defaults to ``graph.hot_mask`` (degree >
    average degree λ) evaluated on the *mutated* graph. Returns
    ``(new_perm, new_inv_perm, hot_prefix_len, info)``; when the hot set
    already exactly fills the prefix the original ``perm`` is returned
    unchanged (``info.identity``), so callers can skip the re-upload
    decision on patches that turn out to be no-ops — though the engine
    still re-uploads because the *edges* changed even if ids did not.
    """
    n = graph.num_vertices
    perm = np.asarray(perm)
    if hot_mask is None:
        hot_mask = graph.hot_mask()
    hot_mask = np.asarray(hot_mask, dtype=bool)
    if perm.shape != (n,) or hot_mask.shape != (n,):
        raise ValueError(
            f"perm/hot_mask must have shape ({n},); got "
            f"{perm.shape} and {hot_mask.shape}")
    if n == 0:
        empty = np.empty(0, dtype=np.int32)
        return (perm.astype(np.int32), empty, 0,
                PatchInfo(0, 0, 0, 0, True))

    inv = np.empty(n, dtype=np.int64)           # served id -> original id
    inv[perm] = np.arange(n, dtype=np.int64)
    hot_in_order = hot_mask[inv]                # hotness along served order
    hot_len = int(hot_in_order.sum())
    if hot_in_order[:hot_len].all():
        # hot set already fills the prefix — stable repack is identity
        info = PatchInfo(0, 0, 0, hot_len, True)
        return perm.astype(np.int32), inv.astype(np.int32), hot_len, info

    new_order = np.concatenate([inv[hot_in_order], inv[~hot_in_order]])
    new_perm = np.empty(n, dtype=np.int32)
    new_perm[new_order] = np.arange(n, dtype=np.int32)
    new_inv = new_order.astype(np.int32)

    promoted = int((hot_mask & (perm >= old_hot_prefix_len)).sum())
    demoted = int((~hot_mask & (perm < old_hot_prefix_len)).sum())
    moved = int((new_perm != perm).sum())
    info = PatchInfo(promoted, demoted, moved, hot_len, False)
    return new_perm, new_inv, hot_len, info


__all__ = ["PatchInfo", "patch_permutation"]
