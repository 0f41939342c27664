"""MoE routing-locality diagnostics — LOrder's mechanism on expert dispatch.

The sorted dispatch itself lives in ``models/moe.py`` (it is the compute
path). This module provides the *analysis* side used by benchmarks and
tests:

* ``routing_graph`` — the token→expert bipartite access graph as a Graph,
  so the paper's skew metrics (hot fraction, edge concentration) apply
  verbatim to routing;
* ``dispatch_stats`` — contiguity/fragmentation metrics of sorted vs
  unsorted dispatch (blocks touched per expert, weight-stream bytes), the
  MoE analogue of cache-line statistics;
* ``expert_affinity_permutation`` — LOrder over the expert co-activation
  graph: experts that fire on the same tokens land on the same EP shard,
  reducing cross-shard all-to-all payload (used by the EP placement
  benchmark).
"""
from __future__ import annotations

import numpy as np

from ..core.csr import Graph, from_edges
from ..core.lorder import lorder


def routing_graph(experts: np.ndarray, num_experts: int,
                  num_tokens: int | None = None) -> Graph:
    """Bipartite token→expert graph (tokens then experts as vertex ids)."""
    experts = np.asarray(experts)
    t, k = experts.shape
    nt = t if num_tokens is None else num_tokens
    src = np.repeat(np.arange(t, dtype=np.int64), k)
    dst = nt + experts.reshape(-1).astype(np.int64)
    return from_edges(nt + num_experts, src, dst, name="moe-routing")


def dispatch_stats(experts: np.ndarray, num_experts: int,
                   tile_m: int = 128, d_model: int = 4096,
                   d_ff: int = 14336, bytes_per: int = 2) -> dict:
    """Weight-streaming cost of sorted vs unsorted dispatch.

    Unsorted: every assignment row gathers its expert's weights — the
    random property-array access of the paper. Sorted: each expert's
    weights stream once per contiguous group (plus tile padding).
    """
    flat = np.asarray(experts).reshape(-1)
    counts = np.bincount(flat, minlength=num_experts)
    w_bytes = 3 * d_model * d_ff * bytes_per           # swiglu: 3 mats
    # unsorted: switches of expert id along the token stream
    switches = int((np.diff(flat) != 0).sum()) + 1
    unsorted_bytes = switches * w_bytes
    # sorted: one stream per non-empty expert group
    nonempty = int((counts > 0).sum())
    sorted_bytes = nonempty * w_bytes
    tiles = int(np.ceil(counts / tile_m).sum())
    pad_rows = int(tiles * tile_m - counts.sum())
    return {
        "assignments": int(flat.size),
        "experts_hit": nonempty,
        "weight_bytes_unsorted": unsorted_bytes,
        "weight_bytes_sorted": sorted_bytes,
        "weight_stream_reduction": unsorted_bytes / max(sorted_bytes, 1),
        "row_tiles": tiles,
        "pad_fraction": pad_rows / max(tiles * tile_m, 1),
        "load_cv": float(counts.std() / max(counts.mean(), 1e-9)),
    }


def expert_coactivation_graph(experts: np.ndarray,
                              num_experts: int) -> Graph:
    """Expert co-activation graph: edge (e1, e2) per token routing to both."""
    experts = np.asarray(experts)
    t, k = experts.shape
    srcs, dsts = [], []
    for i in range(k):
        for j in range(k):
            if i != j:
                srcs.append(experts[:, i])
                dsts.append(experts[:, j])
    return from_edges(num_experts, np.concatenate(srcs).astype(np.int64),
                      np.concatenate(dsts).astype(np.int64),
                      name="expert-coact")


def expert_affinity_permutation(experts: np.ndarray, num_experts: int,
                                kappa: int = 1) -> np.ndarray:
    """LOrder over expert co-activation: perm[expert] = new slot. Experts
    that co-fire land adjacently → same EP shard under contiguous
    partitioning → top-k sets resolve on fewer shards."""
    g = expert_coactivation_graph(experts, num_experts)
    return np.asarray(lorder(g, kappa=kappa), dtype=np.int64)


def cross_shard_traffic(experts: np.ndarray, num_experts: int,
                        num_shards: int,
                        perm: np.ndarray | None = None) -> float:
    """Mean number of distinct EP shards each token's top-k set touches —
    proportional to all-to-all message count per token."""
    e = np.asarray(experts)
    if perm is not None:
        e = np.asarray(perm)[e]
    per = max(1, num_experts // num_shards)
    shards = e // per
    # distinct shards per row
    s = np.sort(shards, axis=1)
    distinct = 1 + (np.diff(s, axis=1) != 0).sum(axis=1)
    return float(distinct.mean())
