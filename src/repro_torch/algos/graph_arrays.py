"""Device-side graph representation for the PyTorch graph kernels.

A `GraphArrays` tuple mirrors the GAP benchmark's working set: out-CSR,
in-CSR (transpose), COO views and degrees, all as torch tensors on one
device. The six kernels (BFS, PR, BC, SSSP, CC, CC-SV) consume this
structure; vertex relabeling (reordering) changes only the *content* of
these arrays, never the kernel code — exactly the paper's contract.

Dtypes follow the JAX package with x64 off: ids, degrees and weights are
int32, masks bool. Shape bucketing (engine/backends.py) uploads graphs
*padded* to a shared (V_bucket, E_bucket) shape; padded uploads carry
``vertex_valid`` / ``edge_valid`` masks and the kernels consult them, so
results on the real vertices are exact. Sentinel edges are self-loops on
the last *padded* vertex, which keeps them out of every real vertex's
adjacency even before masking.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from ..core.csr import Graph
from ..device import resolve_device


class GraphArrays(NamedTuple):
    indptr: torch.Tensor     # (V+1,) int32 out-CSR
    indices: torch.Tensor    # (E,)  int32 out-CSR neighbor (dst) ids
    src: torch.Tensor        # (E,)  int32 COO source per out-edge
    t_indptr: torch.Tensor   # (V+1,) int32 in-CSR
    t_indices: torch.Tensor  # (E,)  int32 in-CSR neighbor (src) ids
    t_dst: torch.Tensor      # (E,)  int32 COO dst per in-edge
    out_degree: torch.Tensor  # (V,) int32
    in_degree: torch.Tensor   # (V,) int32
    weights: torch.Tensor     # (E,) int32 edge weights aligned with out-CSR
    # Bucket-padding masks. None (the default) means "all real": the
    # kernels then skip masking entirely.
    vertex_valid: torch.Tensor | None = None  # (V,) bool, False = padding
    edge_valid: torch.Tensor | None = None    # (E,) bool, False = sentinel

    @property
    def num_vertices(self) -> int:
        return self.indptr.shape[0] - 1

    @property
    def num_edges(self) -> int:
        return self.indices.shape[0]

    @property
    def device(self) -> torch.device:
        return self.indptr.device


def edge_weights(src: np.ndarray, dst: np.ndarray,
                 canonical_ids: np.ndarray | None = None) -> np.ndarray:
    """Deterministic int weights in [1, 255] per canonical edge identity.

    Weights are a pure function of the edge's (src, dst) in *canonical*
    ids — the graph's own ids, or ``canonical_ids[v]`` mapping back to the
    original layout for a relabeled graph — so they are relabel-invariant
    and identical across execution backends.
    """
    h_src = np.asarray(src, dtype=np.int64)
    h_dst = np.asarray(dst, dtype=np.int64)
    if canonical_ids is not None:
        canon = np.asarray(canonical_ids, dtype=np.int64)
        h_src, h_dst = canon[h_src], canon[h_dst]
    # splitmix-style hash of canonical (src, dst) -> stable per-edge weight
    key = (h_src.astype(np.uint64) << np.uint64(32)) | h_dst.astype(np.uint64)
    key = (key ^ (key >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    key = (key ^ (key >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    key ^= key >> np.uint64(31)
    return (key % np.uint64(255)).astype(np.int32) + 1


_INT_FIELDS = ("indptr", "indices", "src", "t_indptr", "t_indices", "t_dst",
               "out_degree", "in_degree", "weights")


def from_numpy(fields: Mapping[str, np.ndarray],
               device: str | torch.device | None = None) -> GraphArrays:
    """Build `GraphArrays` from host arrays keyed by field name.

    Takes any mapping with the eleven field names (a ``_asdict()`` of
    either package's `GraphArrays` after ``np.asarray`` on each field);
    missing or None masks stay None. Ids are cast to int32, masks to bool.
    """
    dev = resolve_device(device)

    def put(arr, dtype):
        # a private host copy: the tensor never aliases the caller's array
        return torch.from_numpy(np.array(arr, dtype)).to(dev)

    out = {k: put(fields[k], np.int32) for k in _INT_FIELDS}
    for k in ("vertex_valid", "edge_valid"):
        v = fields.get(k)
        out[k] = None if v is None else put(v, np.bool_)
    return GraphArrays(**out)


def to_device(g: Graph, weight_seed: int = 17,
              canonical_ids: np.ndarray | None = None,
              pad_to: tuple[int, int] | None = None,
              device: str | torch.device | None = None) -> GraphArrays:
    """Upload a host Graph; deterministic int weights in [1, 255] for SSSP.

    ``pad_to=(num_v, num_e)`` uploads the graph padded to that bucket
    shape: extra vertices are isolated (degree 0, ``vertex_valid`` False),
    extra edges are self-loops on the last padded vertex (``edge_valid``
    False, weight 1). Kernels mask them out, so results restricted to the
    real ``[:V]`` prefix equal the unpadded run. When edges are padded
    there must be at least one padded vertex to host the sentinels —
    `engine.backends.bucket_dims` guarantees that.
    """
    dev = resolve_device(device)
    t = g.transpose
    src = g.edge_src.astype(np.int64)
    dst = g.indices.astype(np.int64)
    w = edge_weights(src, dst, canonical_ids)
    _ = weight_seed  # reserved; hash keeps weights relabel-invariant

    n, e = g.num_vertices, g.num_edges
    if pad_to is None:
        num_v, num_e = n, e
    else:
        num_v, num_e = pad_to
        if num_v < n or num_e < e:
            raise ValueError(f"pad_to {pad_to} smaller than graph ({n}, {e})")
        if num_e > e and num_v == n:
            raise ValueError("edge padding needs at least one padded vertex "
                             "to host sentinel self-loops")
    if (num_v, num_e) == (n, e):
        return from_numpy(dict(
            indptr=g.indptr, indices=g.indices, src=src,
            t_indptr=t.indptr, t_indices=t.indices, t_dst=t.edge_src,
            out_degree=g.out_degree, in_degree=g.in_degree, weights=w),
            dev)

    sentinel = num_v - 1  # always a padded vertex when sentinel edges exist

    def pad_v(arr, fill=0):
        out = np.full(num_v, fill, np.int32)
        out[:n] = arr
        return out

    def pad_e(arr, fill):
        out = np.full(num_e, fill, np.int32)
        out[:e] = arr
        return out

    def pad_ptr(ptr):
        # padded vertices own no real edges; the whole sentinel tail is
        # booked to the last padded vertex so the CSR stays monotone.
        out = np.full(num_v + 1, e, np.int64)
        out[:n + 1] = ptr
        out[num_v] = num_e
        return out.astype(np.int32)

    vertex_valid = np.zeros(num_v, bool)
    vertex_valid[:n] = True
    edge_valid = np.zeros(num_e, bool)
    edge_valid[:e] = True
    return from_numpy(dict(
        indptr=pad_ptr(g.indptr),
        indices=pad_e(g.indices, sentinel),
        src=pad_e(src, sentinel),
        t_indptr=pad_ptr(t.indptr),
        t_indices=pad_e(t.indices, sentinel),
        t_dst=pad_e(t.edge_src, sentinel),
        out_degree=pad_v(g.out_degree),
        in_degree=pad_v(g.in_degree),
        weights=pad_e(w, 1),
        vertex_valid=vertex_valid,
        edge_valid=edge_valid), dev)
