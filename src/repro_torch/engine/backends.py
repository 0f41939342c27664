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

`ShardedBackend` serves a graph whose working set exceeds the per-device
budget through `core.dist`'s edge-partitioned kernels — all six
(multi-source BFS/SSSP/BC, PageRank, CC, CC-SV) — over a 1-D mesh of
devices (every visible card by default; several shards may share one),
with an optional **hot-prefix exchange** (`hot_prefix_fraction`, a
policy decision derived from the hub-mass probe) that all-gathers only
the hot id prefix every step and the cold suffix every ``cold_every``
steps on the monotone kernels, exactness-preserving (core/dist.py).
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
    single-device upload; ``spmv_val`` the PR SpMV edge values (in-CSR
    order, 0 on sentinels), made once at upload; ``search`` the knn
    operands of a search graph. Sharded handles carry backend state in
    ``shard_state`` instead.
    """

    backend: str
    num_vertices: int
    num_edges: int
    bucket: tuple[int, int]
    device_bytes: int
    arrays: GraphArrays | None = None
    spmv_val: torch.Tensor | None = None
    search: DeviceSearch | None = None
    shard_state: object | None = None  # sharded handles: backend state
    hot_prefix_fraction: float | None = None  # sharded exchange policy


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


# ----------------------------------------------------------------- sharded
def _make_sharded_bfs(st):
    from ..core import dist
    return dist.make_distributed_bfs(
        st.graph, st.mesh, st.axis,
        hot_prefix_fraction=st.hot_prefix_fraction,
        cold_every=st.cold_every, stats=st.stats, fused=st.fused)


def _make_sharded_sssp(st):
    from ..core import dist
    return dist.make_distributed_sssp(
        st.graph, st.mesh, st.axis, canonical_ids=st.canonical_ids,
        hot_prefix_fraction=st.hot_prefix_fraction,
        cold_every=st.cold_every, stats=st.stats, fused=st.fused)


def _make_sharded_pr(st):
    from ..core import dist
    # synchronous power iteration: always a full exchange (core/dist.py)
    run, _ = dist.make_distributed_pagerank(st.graph, st.mesh, st.axis,
                                            stats=st.stats, fused=st.fused)
    return run


def _make_sharded_cc(st):
    from ..core import dist
    return dist.make_distributed_cc(
        st.graph, st.mesh, st.axis,
        hot_prefix_fraction=st.hot_prefix_fraction,
        cold_every=st.cold_every, stats=st.stats, fused=st.fused)


def _make_sharded_bc(st):
    from ..core import dist
    # level-synchronous float accumulation: always a full exchange
    return dist.make_distributed_bc(st.graph, st.mesh, st.axis,
                                    stats=st.stats, fused=st.fused)


# Every served kernel has a sharded runner factory — full six-kernel
# parity with the single-device backend. CC-SV shares the min-label
# runner: both converge to the min-id-per-component labeling, and the
# alias makes cc/ccsv share one cached runner (one edge partition, one
# upload) instead of building two identical ones.
_RUNNER_FACTORIES = {
    "bfs": _make_sharded_bfs,
    "sssp": _make_sharded_sssp,
    "bc": _make_sharded_bc,
    "pr": _make_sharded_pr,
    "cc": _make_sharded_cc,
    "ccsv": _make_sharded_cc,
}
_RUNNER_ALIASES = {"ccsv": "cc"}

SHARDED_KERNELS = tuple(_RUNNER_FACTORIES)


class _ShardedGraphState:
    """Per-graph device state for `ShardedBackend` (lazy kernel factories)."""

    def __init__(self, graph: Graph, mesh, axis: str,
                 canonical_ids: np.ndarray | None,
                 hot_prefix_fraction: float | None, cold_every: int,
                 stats, fused: bool = True,
                 search: SearchSpec | None = None):
        self.graph = graph
        self.mesh = mesh
        self.axis = axis
        self.canonical_ids = canonical_ids
        self.hot_prefix_fraction = hot_prefix_fraction
        self.cold_every = cold_every
        self.stats = stats
        self.fused = fused
        self._runners: dict[str, object] = {}
        # knn (query rows split over the shards) state: the host
        # SearchSpec and, built on the first knn run, the CSR, corpus and
        # canonical map once per distinct device of the mesh
        self.search = search
        self.knn_operands: dict | None = None

    def runner(self, kernel: str):
        kernel = _RUNNER_ALIASES.get(kernel, kernel)
        fn = self._runners.get(kernel)
        if fn is None:
            # unknown kernel names are rejected by build_kernel before we
            # get here, so a miss in the factory table is a parity bug
            assert kernel in _RUNNER_FACTORIES, (
                f"kernel {kernel!r} is served but has no sharded runner "
                f"factory; SHARDED_KERNELS = {SHARDED_KERNELS}")
            fn = _RUNNER_FACTORIES[kernel](self)
            self._runners[kernel] = fn
        return fn


class ShardedBackend:
    """Serve graphs beyond one device through core/dist edge partitions.

    Edges are 1-D partitioned by destination range over ``mesh[axis]``
    (every visible card by default, or ``num_shards`` shards on the
    devices `core.dist.make_mesh` picks for ``device``); vertex property
    state lives sharded and each traversal step all-gathers it — see
    core/dist.py for why reordering concentrates the *useful* payload of
    that collective. ``prepare``'s ``hot_prefix_fraction`` (a policy
    decision) turns on the hot-prefix exchange for the monotone kernels:
    only that fraction of each shard's slice is gathered per step, the
    cold suffix every ``cold_every`` steps. `telemetry()["hot_prefix"]`
    reports the exchanged-vs-full byte ledger and static prefix hit rates.
    """

    name = "sharded"

    def __init__(self, num_shards: int | None = None, axis: str = "data",
                 mesh=None, cold_every: int = 4,
                 metrics: MetricsRegistry | None = None,
                 fused: bool = True,
                 device: str | torch.device | None = None):
        from ..core.dist import ExchangeStats, make_mesh
        if mesh is None:
            mesh = make_mesh(num_shards, axis, device)
        self.mesh = mesh
        self.axis = axis
        self.num_shards = mesh.shape[axis]
        self.cold_every = cold_every
        # both values run the same host step loop (core/dist.py); fused
        # books one dispatch a query, the host loop one a step — the
        # reference's counts
        self.fused = fused
        self.metrics = metrics or MetricsRegistry()
        self.tracer: Tracer | None = None   # set by the owning session
        self._counters = _backend_counters(self.metrics, self.name)
        self._c_ex_steps = self.metrics.counter(
            "engine_exchange_steps_total",
            "sharded per-step collective exchanges")
        self._c_ex_bytes = self.metrics.counter(
            "engine_exchange_bytes_total",
            "bytes received per device across exchanges")
        self.exchange_stats = ExchangeStats()
        # exchange delta of the most recent run(): runs are serial, so a
        # snapshot/delta pair attributes collective bytes per query — the
        # scheduler copies this into each request's telemetry
        self.last_run_exchange: dict | None = None
        self._prefix_info: list[dict] = []

    @property
    def queries_run(self) -> int:
        return self._counters["queries"].value

    @property
    def sources_run(self) -> int:
        return self._counters["sources"].value

    @property
    def graphs_prepared(self) -> int:
        return self._counters["prepared"].value

    def prepare(self, graph: Graph,
                canonical_ids: np.ndarray | None = None,
                hot_prefix_fraction: float | None = None,
                search: SearchSpec | None = None) -> GraphHandle:
        n, e = graph.num_vertices, graph.num_edges
        state = _ShardedGraphState(graph, self.mesh, self.axis,
                                   canonical_ids, hot_prefix_fraction,
                                   self.cold_every, self.exchange_stats,
                                   fused=self.fused, search=search)
        self._counters["prepared"].inc()
        return GraphHandle(self.name, n, e, (n, e),
                           self._per_device_bytes(graph),
                           shard_state=state,
                           hot_prefix_fraction=hot_prefix_fraction)

    def _per_device_bytes(self, graph: Graph) -> int:
        """Resident graph bytes per device, from the *actual* partition.

        `partition_edges` splits by dst range and pads every shard to the
        fullest shard's edge count, so on skewed graphs the per-device
        footprint is set by the hub-heaviest range — the true histogram
        is O(E) on the host and cheap next to the upload. Counts the
        edge arrays (src, dst, valid, weights) and one int32 vertex
        property slice; per-query (S × per) state is not included. The
        formula is the JAX package's unchanged: the policy reads it.
        """
        per = -(-graph.num_vertices // self.num_shards)
        counts = np.bincount(np.asarray(graph.indices) // per,
                             minlength=self.num_shards)
        emax = int(counts.max()) if len(counts) else 0
        return emax * (4 + 4 + 1 + 4) + per * 4

    def _sync(self) -> None:
        for d in self.mesh.distinct:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def _run_knn(self, handle: GraphHandle, queries) -> tuple:
        """Query-parallel knn: the padded query rows are split evenly over
        the shards, the CSR arrays, vector corpus and canonical-id map
        are replicated once per distinct device, each shard runs the
        single-device beam search on its rows, and the shards' visit
        counts are summed. No per-step exchange (the graph is
        replicated), so ``last_run_exchange`` stays None for knn runs;
        the ids equal the single path's because every lane runs the same
        per-query search on the same operands."""
        from ..core.dist import psum
        st = handle.shard_state
        sp = st.search
        if sp is None:
            raise ValueError("knn_search needs a graph prepared with "
                             "search= (a SearchSpec); this handle has none")
        if st.knn_operands is None:
            vecs = np.ascontiguousarray(sp.vectors, dtype=np.float32)
            canon = np.ascontiguousarray(sp.canon, dtype=np.int32)
            st.knn_operands = {
                d: (to_device(st.graph, canonical_ids=st.canonical_ids,
                              device=d),
                    torch.from_numpy(vecs).to(d),
                    torch.from_numpy(canon).to(d))
                for d in self.mesh.distinct}
        padded, valid, real = pad_queries(queries, multiple=self.num_shards)
        rows = len(padded) // self.num_shards
        p = sp.params
        self._counters["queries"].inc()
        self._counters["dispatches"].inc()
        self._counters["sources"].inc(real)
        ids, visits = [], []
        for i, d in enumerate(self.mesh.devices):
            ga, vecs, canon = st.knn_operands[d]
            part = slice(i * rows, (i + 1) * rows)
            got, seen = K.knn_search_multi(
                ga, vecs, canon, int(sp.entry),
                torch.from_numpy(padded[part]).to(d),
                torch.from_numpy(valid[part]).to(d),
                k_out=p.k_out, beam_width=p.beam_width,
                k_return=p.k_return, max_steps=p.max_steps)
            ids.append(got.to(self.mesh.home))
            visits.append(seen)
        visits = psum(visits, self.mesh)[0]
        self._sync()
        self.last_run_exchange = None
        return torch.cat(ids)[:real], visits[:handle.num_vertices]

    def run(self, handle: GraphHandle, kernel: str,
            sources=None) -> torch.Tensor:
        build_kernel(kernel)  # unknown kernel: raise before anything counts
        if kernel in VECTOR_SOURCE:
            return self._run_knn(handle, sources)
        canon = _RUNNER_ALIASES.get(kernel, kernel)
        new_runner = canon not in handle.shard_state._runners
        runner = handle.shard_state.runner(kernel)
        if new_runner and getattr(runner, "hot_prefix_fraction",
                                  None) is not None:
            self._prefix_info.append({
                "kernel": canon,
                "hot_prefix_fraction": runner.hot_prefix_fraction,
                "h_local": runner.h_local,
                "per_shard_vertices": runner.per,
                "prefix_hit_rate": round(runner.prefix_hit_rate, 4),
            })
        self._counters["queries"].inc()
        before = self.exchange_stats.snapshot()
        # per-step exchange spans: while this run is live, every
        # ExchangeStats record emits one engine-track span covering the
        # step that ended at the collective — nested under the launch
        # span the session wraps around executor.run
        if self.tracer is not None:
            tracer = self.tracer
            last = {"t": tracer.clock.now()}

            def _exchange_span(mode: str, nbytes: int,
                               full_nbytes: int) -> None:
                now = tracer.clock.now()
                tracer.emit("exchange", last["t"], now,
                            args={"mode": mode, "bytes": nbytes,
                                  "bytes_full_equivalent": full_nbytes,
                                  "kernel": canon})
                last["t"] = now

            self.exchange_stats.span_sink = _exchange_span
        try:
            if kernel in GLOBAL:
                out = runner()[:handle.num_vertices]
            else:
                padded, real = pad_sources(sources, kernel)
                self._counters["sources"].inc(real)
                out = runner(padded)[:real, :handle.num_vertices]
            self._sync()
        finally:
            self.exchange_stats.span_sink = None
        delta = self.exchange_stats.delta(before)
        self._c_ex_steps.inc(delta.steps)
        self._c_ex_bytes.inc(delta.bytes_exchanged)
        self._counters["dispatches"].inc(delta.dispatches)
        self.last_run_exchange = delta.as_dict()
        return out

    def telemetry(self) -> dict:
        return {
            "num_shards": self.num_shards,
            "graphs_prepared": self.graphs_prepared,
            "queries_run": self.queries_run,
            "sources_run": self.sources_run,
            "fused": self.fused,
            "dispatches": self._counters["dispatches"].value,
            "hot_prefix": {
                **self.exchange_stats.as_dict(),
                "cold_every": self.cold_every,
                "runners": list(self._prefix_info),
            },
        }
