"""Serving-side glue for the `knn_search` workload.

A k-NN query's "source" is a float32 vector, not a vertex id, so the
request plane needs three adapters: a **digest** that turns a query row
into the hashable int the result cache keys on, a **padding** rule that
rounds a query batch up to the compile-cache-friendly bucket shape, and
a **SearchSpec** carrying the served-order vector matrix + entry point
that backends thread into the kernel. The visit-ordered permutation for
``hotness_source == "visits"`` lives here too.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np


def default_max_steps(beam_width: int) -> int:
    """Expansion budget: beam refills stop paying off well before this."""
    return 2 * beam_width + 32


@dataclasses.dataclass(frozen=True)
class SearchParams:
    """Beam-search shape knobs, fixed per registered graph (they are
    static arguments of the compiled kernel)."""
    k_out: int
    beam_width: int = 32
    k_return: int = 10
    max_steps: int | None = None

    def __post_init__(self):
        if self.k_return > self.beam_width:
            raise ValueError("k_return must be <= beam_width")
        if self.max_steps is None:
            object.__setattr__(self, "max_steps",
                               default_max_steps(self.beam_width))


@dataclasses.dataclass(frozen=True)
class SearchSpec:
    """Layout-bound search state handed to ``backend.prepare``.

    ``vectors`` is the corpus in **served order** (row i = vector of
    served vertex i, padded rows at the bucketed tail are never read),
    ``entry`` the served id of the entry point, and ``canon`` the
    served->original id map whose values salt the kernel's composite
    sort keys — which is what makes results bit-identical across
    layouts and backends.
    """
    vectors: np.ndarray      # (V_pad, d) float32, served order
    entry: int               # served id of the entry vertex
    canon: np.ndarray        # (V_pad,) int32 served -> original
    params: SearchParams

    @property
    def dim(self) -> int:
        return int(self.vectors.shape[1])


def query_digest(query: np.ndarray) -> int:
    """Stable positive-int key for one float32 query row — what the
    result cache uses in place of an integer source id."""
    row = np.ascontiguousarray(query, dtype=np.float32)
    h = hashlib.blake2b(row.tobytes(), digest_size=8).digest()
    return int.from_bytes(h, "big") >> 1  # keep it non-negative


def pad_queries(queries: np.ndarray, multiple: int = 1
                ) -> tuple[np.ndarray, np.ndarray, int]:
    """Round a (S, d) query batch up to a power-of-two row count (also a
    multiple of ``multiple``, for sharded row splits). Returns
    ``(padded, valid_lane_mask, real_rows)``; pad lanes repeat row 0 and
    are excluded from visit accounting by the mask."""
    q = np.ascontiguousarray(queries, dtype=np.float32)
    s = len(q)
    target = max(multiple, 1 << (s - 1).bit_length())
    if target % multiple:
        target = ((target + multiple - 1) // multiple) * multiple
    if target > s:
        q = np.concatenate([q, np.repeat(q[:1], target - s, axis=0)])
    valid = np.zeros(target, dtype=bool)
    valid[:s] = True
    return q, valid, s


def visit_order(visits: np.ndarray) -> np.ndarray:
    """Hot-prefix permutation from observed visit counts: vertices with
    above-mean visits first, sorted by visits descending (stable), cold
    tail keeps original relative order — hubsort with telemetry standing
    in for degree. Returns ``perm[old_id] = new_id``."""
    v = np.asarray(visits, dtype=np.float64)
    hot = v > v.mean()
    hot_ids = np.nonzero(hot)[0]
    hot_ids = hot_ids[np.argsort(-v[hot_ids], kind="stable")]
    cold_ids = np.nonzero(~hot)[0]
    perm = np.empty(len(v), dtype=np.int64)
    perm[np.concatenate([hot_ids, cold_ids])] = np.arange(len(v))
    return perm


def visit_hot_mask(visits: np.ndarray) -> np.ndarray:
    """Hot set under visit telemetry (above-mean visits), the mask fed to
    ``patch_permutation`` when ``hotness_source == "visits"``."""
    v = np.asarray(visits, dtype=np.float64)
    return v > v.mean()
