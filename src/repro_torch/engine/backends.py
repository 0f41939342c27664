"""Execution backends: where and in what shape a graph runs.

`SingleDeviceBackend` serves every graph on one device (a CUDA card by
default, the CPU when asked). Shape bucketing pads CSR uploads to
geometric (V_bucket, E_bucket) shapes with masked sentinel edges
(graph_arrays.to_device ``pad_to``; kernels consult the masks), so a
stream of graphs of ragged sizes shares a handful of upload shapes and
results on the real ``[:V]`` prefix stay exact. The executable cache of
the JAX package survives as a bounded LRU of per-(kernel, bucket)
callables with the same hit/miss/eviction counters; PyTorch runs
eagerly, so a miss builds a plain callable instead of compiling.

PageRank's pull relaxation always runs through the hand-written CUDA
SpMV (kernels/csr_spmv), raw `GraphArrays` included; on the CPU its
wrapper runs the plain version. The kernel reads the uploaded in-CSR
rows directly; no edge packing is built.

k-NN search graphs carry their vectors and canonical ids on the device
(`DeviceSearch`, padded to the vertex bucket); a ``knn`` run is one
batched beam search over the padded query lanes (`algos.kernels.
knn_search_multi`).

The sharded backend (edge partitions across devices) is not ported yet
(ROADMAP A7).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from collections import OrderedDict
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from ..algos import kernels as K
from ..algos.graph_arrays import GraphArrays, to_device
from ..core.csr import Graph
from ..device import resolve_device
from ..search.serve import SearchSpec, pad_queries
from .obs import MetricsRegistry, Tracer

# kernels taking a batch of sources -> (S, V) per-source rows
MULTI_SOURCE = ("bfs", "sssp", "bc")
# source-independent kernels -> (V,)
GLOBAL = ("pr", "cc", "ccsv")
# kernels whose "source" is a float32 vector, not a vertex id -> the
# per-source row is a (k_return,) id vector; runs also return (V,)
# visit counts (the reorder policy's hotness telemetry)
VECTOR_SOURCE = ("knn",)

_FNS = {
    "bfs": K.bfs_multi,
    "sssp": K.sssp_multi,
    "bc": K.bc_multi,
    "pr": K.pagerank_spmv,
    "cc": K.cc_labelprop,
    "ccsv": K.cc_shiloach_vishkin,
    "knn": K.knn_search_multi,
}


def build_kernel(kernel: str):
    try:
        return _FNS[kernel]
    except KeyError:
        raise ValueError(
            f"unknown kernel {kernel!r}; "
            f"have {MULTI_SOURCE + GLOBAL + VECTOR_SOURCE}") from None


def source_bucket(n: int) -> int:
    """Next power-of-two source-batch bucket (>= 1)."""
    return 1 << max(0, (n - 1).bit_length())


def pad_sources(sources, kernel: str) -> tuple[np.ndarray, int]:
    """Validate + pad a source batch to its power-of-two bucket.

    Returns ``(padded_sources, real_count)``. Raises *before* any cache
    or device work for an empty batch.
    """
    srcs = np.atleast_1d(np.asarray(sources, dtype=np.int32))
    if srcs.size == 0:
        raise ValueError(f"{kernel} needs at least one source")
    pad = source_bucket(srcs.size)
    padded = np.full(pad, srcs[0], np.int32)
    padded[:srcs.size] = srcs
    return padded, int(srcs.size)


# ------------------------------------------------------------------ buckets
def bucket_dims(num_vertices: int, num_edges: int, growth: float = 2.0,
                v_floor: int = 256, e_floor: int = 1024) -> tuple[int, int]:
    """Geometric (V_bucket, E_bucket) for shape sharing.

    Buckets grow by ``growth`` from the floors, so a stream of arbitrary
    graph sizes hits O(log V + log E) shapes per kernel. When edges need
    padding the vertex bucket is forced strictly above V so sentinel
    self-loops land on a *padded* vertex — that keeps them out of every
    real adjacency list and off the real in-CSR rows.
    """
    if growth <= 1.0:
        raise ValueError(f"growth must be > 1, got {growth}")

    def up(x: int, floor: int) -> int:
        b = floor
        while b < x:
            b = int(math.ceil(b * growth))
        return b

    e_b = up(num_edges, e_floor)
    v_min = num_vertices + 1 if e_b > num_edges else num_vertices
    v_b = up(v_min, v_floor)
    return v_b, e_b


def estimate_device_bytes(num_vertices: int, num_edges: int,
                          batch_sources: int = 0) -> int:
    """Device footprint of serving one graph (the placement input).

    CSR upload: int32 fields — 2x indptr (V+1), 5x edge-sized (indices,
    src, t_indices, t_dst, weights), 2x vertex-sized degrees — plus
    1-byte bool masks. ``batch_sources`` adds the query state: a
    multi-source launch of S sources holds an (S, V) int32 property
    matrix plus a same-shape relaxation/frontier buffer, ~8·S·V bytes.
    The formula is the JAX package's unchanged: it feeds the policy.
    """
    return (4 * (2 * (num_vertices + 1) + 5 * num_edges + 2 * num_vertices)
            + num_vertices + num_edges
            + 8 * batch_sources * num_vertices)


# ------------------------------------------------------------------- handle
@dataclasses.dataclass
class DeviceSearch:
    """Device-resident knn operands of one uploaded search graph.

    ``vectors``/``canon`` are the `SearchSpec` payloads padded to the
    handle's vertex bucket (padded rows are unreachable: sentinel edges
    never land in a real adjacency list, so the search cannot gather
    them). ``params`` are the beam knobs, fixed per graph.
    """

    vectors: torch.Tensor   # (V_bucket, d) float32, served order
    canon: torch.Tensor     # (V_bucket,) int32 served -> original
    entry: int              # served id of the entry vertex
    params: object          # search.serve.SearchParams
    dim: int


def _device_search(spec: SearchSpec, v_bucket: int,
                   device: torch.device) -> DeviceSearch:
    vecs = np.ascontiguousarray(spec.vectors, dtype=np.float32)
    canon = np.ascontiguousarray(spec.canon, dtype=np.int32)
    if v_bucket > len(vecs):
        vecs = np.concatenate(
            [vecs, np.zeros((v_bucket - len(vecs), vecs.shape[1]),
                            np.float32)])
        canon = np.concatenate(
            [canon, np.arange(len(canon), v_bucket, dtype=np.int32)])
    return DeviceSearch(torch.from_numpy(vecs).to(device),
                        torch.from_numpy(canon).to(device),
                        int(spec.entry), spec.params, int(vecs.shape[1]))


@dataclasses.dataclass
class GraphHandle:
    """What ``prepare`` returns and ``run`` consumes — one served graph.

    ``num_vertices``/``num_edges`` are the *real* sizes; ``bucket`` is the
    padded upload shape (equal to the real sizes when bucketing is off or
    the graph already sits on a bucket boundary). ``arrays`` is the
    device upload; ``spmv_val`` the PR SpMV edge values (in-CSR order, 0
    on sentinels), made once at upload; ``search`` the knn operands of a
    search graph.
    """

    backend: str
    num_vertices: int
    num_edges: int
    bucket: tuple[int, int]
    device_bytes: int
    arrays: GraphArrays | None = None
    spmv_val: torch.Tensor | None = None
    search: DeviceSearch | None = None


@runtime_checkable
class ExecutionBackend(Protocol):
    """Uniform surface the executor routes through."""

    name: str

    def prepare(self, graph: Graph,
                canonical_ids: np.ndarray | None = None) -> GraphHandle: ...

    def run(self, handle: GraphHandle, kernel: str,
            sources=None) -> torch.Tensor: ...

    def telemetry(self) -> dict: ...


def _backend_counters(metrics: MetricsRegistry, backend: str) -> dict:
    """The per-backend serving counters every backend keeps."""
    return {
        "queries": metrics.counter("engine_queries_total",
                                   "query batches executed",
                                   backend=backend),
        "sources": metrics.counter("engine_sources_total",
                                   "real (unpadded) sources executed",
                                   backend=backend),
        "prepared": metrics.counter("engine_graphs_prepared_total",
                                    "graphs uploaded/prepared",
                                    backend=backend),
        # one per query: the host call that runs the kernel's loop
        "dispatches": metrics.counter("engine_dispatches_total",
                                      "host->device kernel launches",
                                      backend=backend),
    }


# ------------------------------------------------------------- single device
class SingleDeviceBackend:
    """One device, bucketed uploads, a bounded cache of kernel callables.

    With ``max_cached_executables`` set, cache entries are evicted LRU
    once the cap is hit; evictions are counted in telemetry, and an
    evicted key that returns is a counted miss.
    """

    name = "single"

    def __init__(self, bucketing: bool = True, growth: float = 2.0,
                 v_floor: int = 256, e_floor: int = 1024,
                 max_cached_executables: int | None = None,
                 metrics: MetricsRegistry | None = None,
                 device: str | torch.device | None = None):
        if max_cached_executables is not None and max_cached_executables < 1:
            raise ValueError("max_cached_executables must be >= 1 or None")
        self.device = resolve_device(device)
        self.bucketing = bucketing
        self.growth = growth
        self.v_floor = v_floor
        self.e_floor = e_floor
        self.max_cached_executables = max_cached_executables
        self._cache: OrderedDict[tuple, object] = OrderedDict()
        self.metrics = metrics or MetricsRegistry()
        self.tracer: Tracer | None = None   # set by the owning session
        self._counters = _backend_counters(self.metrics, self.name)
        self._c_hits = self.metrics.counter(
            "engine_compile_cache_hits_total",
            "executable cache hits", backend=self.name)
        self._c_misses = self.metrics.counter(
            "engine_compile_cache_misses_total",
            "executable cache misses (compiles)", backend=self.name)
        self._c_evictions = self.metrics.counter(
            "engine_cache_evictions_total",
            "LRU executable evictions", backend=self.name)
        self._bucket_counts: dict[tuple[int, int], int] = {}

    @property
    def cache_hits(self) -> int:
        return self._c_hits.value

    @property
    def cache_misses(self) -> int:
        return self._c_misses.value

    @property
    def cache_evictions(self) -> int:
        return self._c_evictions.value

    @property
    def queries_run(self) -> int:
        return self._counters["queries"].value

    @property
    def sources_run(self) -> int:
        return self._counters["sources"].value

    @property
    def graphs_prepared(self) -> int:
        return self._counters["prepared"].value

    def _span(self, name: str, **args):
        return (self.tracer.span(name, **args) if self.tracer is not None
                else contextlib.nullcontext(args))

    def _sync(self, kernel: str, out):
        """The ``device_sync`` span: wait for the device to finish."""
        with self._span("device_sync", kernel=kernel):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        return out

    # -------------------------------------------------------------- prepare
    def prepare(self, graph: Graph,
                canonical_ids: np.ndarray | None = None,
                search: SearchSpec | None = None) -> GraphHandle:
        n, e = graph.num_vertices, graph.num_edges
        bucket = (bucket_dims(n, e, self.growth, self.v_floor, self.e_floor)
                  if self.bucketing else (n, e))
        arrays = to_device(graph, canonical_ids=canonical_ids,
                           pad_to=bucket if bucket != (n, e) else None,
                           device=self.device)
        self._counters["prepared"].inc()
        self._bucket_counts[bucket] = self._bucket_counts.get(bucket, 0) + 1
        ds = (_device_search(search, bucket[0], self.device)
              if search is not None else None)
        return GraphHandle(self.name, n, e, bucket,
                           estimate_device_bytes(*bucket), arrays=arrays,
                           spmv_val=K.spmv_values(arrays), search=ds)

    # ------------------------------------------------------------------ run
    def _cache_get(self, key: tuple, build):
        """Hit/miss-counted LRU lookup; ``build()`` makes the callable."""
        cached = self._cache.get(key)
        if cached is not None:
            self._c_hits.inc()
            self._cache.move_to_end(key)     # LRU: refresh recency
            return cached
        self._c_misses.inc()
        if self.tracer is not None:
            self.tracer.instant("compile_cache_miss", kernel=key[0],
                                key=str(key))
        cached = build()
        self._cache[key] = cached
        if (self.max_cached_executables is not None
                and len(self._cache) > self.max_cached_executables):
            self._cache.popitem(last=False)  # least recently used
            self._c_evictions.inc()
        return cached

    def _compiled(self, kernel: str, ga: GraphArrays):
        fn = build_kernel(kernel)
        # mask presence selects another kernel branch at equal shapes —
        # the key must not conflate them
        key = (kernel, ga.num_vertices, ga.num_edges,
               ga.vertex_valid is not None)
        return self._cache_get(key, lambda: fn)

    def run_arrays(self, ga: GraphArrays, kernel: str, sources=None, *,
                   spmv_val: torch.Tensor | None = None,
                   num_rows: int | None = None) -> torch.Tensor:
        """Execute against raw device arrays (no real-prefix slicing).

        PR relaxes through the CSR SpMV kernel (one launch per
        iteration); ``spmv_val``/``num_rows`` are its edge values and
        real row count when the caller holds them (a `GraphHandle`).
        """
        build_kernel(kernel)  # unknown kernel: raise before anything counts
        if kernel in GLOBAL:
            fn = self._compiled(kernel, ga)
            self._counters["queries"].inc()
            self._counters["dispatches"].inc()
            if kernel == "pr":
                val = K.spmv_values(ga) if spmv_val is None else spmv_val
                return self._sync(kernel, fn(ga, val, num_rows=num_rows))
            return self._sync(kernel, fn(ga))
        padded, real = pad_sources(sources, kernel)
        fn = self._compiled(kernel, ga)
        self._counters["queries"].inc()
        self._counters["dispatches"].inc()
        self._counters["sources"].inc(real)
        out = fn(ga, torch.from_numpy(padded).to(ga.device))
        return self._sync(kernel, out)[:real]

    def _run_knn(self, handle: GraphHandle, queries) -> tuple:
        """Beam search over the uploaded search graph: (S, d) queries ->
        ``((S, k_return) served ids, (V,) visit counts)``. Each beam
        parameterisation and padded batch has its own cache key, as in
        the reference."""
        ds = handle.search
        if ds is None:
            raise ValueError("knn_search needs a graph prepared with "
                             "search= (a SearchSpec); this handle has none")
        ga = handle.arrays
        p = ds.params
        padded, valid, real = pad_queries(queries)
        key = ("knn", ga.num_vertices, ga.num_edges, ds.dim, len(padded),
               p.k_out, p.beam_width, p.k_return, p.max_steps)
        fn = self._cache_get(key, lambda: build_kernel("knn"))
        self._counters["queries"].inc()
        self._counters["dispatches"].inc()
        self._counters["sources"].inc(real)
        ids, visits = fn(ga, ds.vectors, ds.canon, ds.entry,
                         torch.from_numpy(padded).to(self.device),
                         torch.from_numpy(valid).to(self.device),
                         k_out=p.k_out, beam_width=p.beam_width,
                         k_return=p.k_return, max_steps=p.max_steps)
        ids = self._sync("knn", ids)
        return ids[:real], visits[:handle.num_vertices]

    def run(self, handle: GraphHandle, kernel: str,
            sources=None) -> torch.Tensor:
        if kernel in VECTOR_SOURCE:
            return self._run_knn(handle, sources)
        out = self.run_arrays(handle.arrays, kernel, sources,
                              spmv_val=handle.spmv_val,
                              num_rows=handle.num_vertices)
        # slice the bucket padding back off: results live on [:V]
        return out[..., :handle.num_vertices]

    # ------------------------------------------------------------ telemetry
    def telemetry(self) -> dict:
        return {
            "compile_cache_hits": self.cache_hits,
            "compile_cache_misses": self.cache_misses,
            "cache_evictions": self.cache_evictions,
            "max_cached_executables": self.max_cached_executables,
            "cached_keys": sorted(str(k) for k in self._cache),
            "queries_run": self.queries_run,
            "sources_run": self.sources_run,
            "dispatches": self._counters["dispatches"].value,
            # the JAX package's pallas_pr switch; here PR always runs
            # the SpMV kernel
            "spmv_pr": True,
            "bucketing": {
                "enabled": self.bucketing,
                "graphs_prepared": self.graphs_prepared,
                "distinct_buckets": len(self._bucket_counts),
                "bucket_counts": {str(k): v
                                  for k, v in sorted(self._bucket_counts.items())},
            },
        }
