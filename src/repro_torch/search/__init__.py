"""Cache-efficient k-NN search serving (ROADMAP item 4).

Coleman et al. ("Graph Reordering for Cache-Efficient Near Neighbor
Search", PAPERS.md) show the paper's hot-prefix packing speeds greedy
beam search on k-NN graphs — except on search graphs out-degree is fixed
by construction, so the skew the reorder exploits lives in *visit
frequency*, observed from serving telemetry rather than read off the
degree distribution.

- ``knn_graph``: exact and NSW-style incremental search-graph builders
  (fixed out-degree CSR, rides the existing ``GraphArrays`` path).
- ``serve``: query digests, query padding, the served-order
  ``SearchSpec`` handed to backends, and the visit-ordered permutation
  used when ``hotness_source == "visits"``.
"""
from .knn_graph import (build_knn_graph, build_nsw_graph, knn_brute_force,
                        medoid_entry, nsw_insert_deltas, validate_search_graph)
from .serve import (SearchParams, SearchSpec, default_max_steps, pad_queries,
                    query_digest, visit_hot_mask, visit_order)

__all__ = [
    "build_knn_graph", "build_nsw_graph", "knn_brute_force", "medoid_entry",
    "nsw_insert_deltas", "validate_search_graph",
    "SearchParams", "SearchSpec", "default_max_steps", "pad_queries",
    "query_digest", "visit_hot_mask", "visit_order",
]
