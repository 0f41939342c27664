"""Batched query executor: the routing facade over execution backends.

The serving-side answer to the paper's framing (section 4: the traversal
kernels whose cache behaviour reordering improves): the same kernels the
benchmarks time, run behind a cache of per-shape callables, with
multi-source queries batched into one (S, V) launch padded to
power-of-two source buckets. The mechanics live in `backends.py`.

`ShardedBackend` routes queries through `core.dist` edge-partitioned
kernels (all six: bfs/sssp/bc/pr/cc/ccsv, and knn split by query rows)
when a graph exceeds the per-device budget; the placement decision — and
the `hot_prefix_fraction` governing the sharded exchange — is the
policy's, see policy.py.

`BatchedExecutor.run` accepts either a `GraphHandle` from ``prepare``
(routed to the handle's backend) or raw `GraphArrays` (single-device
path, exact shapes).
"""
from __future__ import annotations

import torch

from ..algos.graph_arrays import GraphArrays
from ..core.csr import Graph
from .backends import (GLOBAL, MULTI_SOURCE, VECTOR_SOURCE, ExecutionBackend,
                       GraphHandle, ShardedBackend, SingleDeviceBackend)


class BatchedExecutor:
    """Runs kernels against prepared graph handles through their backend."""

    def __init__(self, single: SingleDeviceBackend | None = None,
                 num_shards: int | None = None, bucketing: bool = True,
                 max_cached_executables: int | None = None,
                 metrics=None, fused: bool = True,
                 device: str | torch.device | None = None):
        self.single = single or SingleDeviceBackend(
            bucketing=bucketing,
            max_cached_executables=max_cached_executables,
            metrics=metrics, device=device)
        # one registry spans the facade and both backends — a session
        # adopts it so every engine metric shares a namespace (obs.py)
        self.metrics = self.single.metrics
        self._num_shards = num_shards
        self._fused = fused
        self._sharded: ShardedBackend | None = None
        self._tracer = None

    @property
    def device(self) -> torch.device:
        return self.single.device

    @property
    def sharded(self) -> ShardedBackend:
        """Lazy: building a mesh is pointless until a graph needs one.
        Its shards go on the single backend's device: a named one holds
        them all, bare ``cuda`` spreads them over the visible cards."""
        if self._sharded is None:
            self._sharded = ShardedBackend(num_shards=self._num_shards,
                                           metrics=self.metrics,
                                           fused=self._fused,
                                           device=self.device)
            self._sharded.tracer = self._tracer
        return self._sharded

    @property
    def tracer(self):
        return self._tracer

    @tracer.setter
    def tracer(self, tracer) -> None:
        """Hand the session's tracer to both backends (for launch-internal
        spans: device_sync, cache misses, per-step exchanges)."""
        self._tracer = tracer
        self.single.tracer = tracer
        if self._sharded is not None:
            self._sharded.tracer = tracer

    def backend(self, name: str) -> ExecutionBackend:
        if name == "single":
            return self.single
        if name == "sharded":
            return self.sharded
        raise ValueError(f"unknown backend {name!r}; have single, sharded")

    # -------------------------------------------------------------- prepare
    def prepare(self, graph: Graph, backend: str = "single",
                canonical_ids=None,
                hot_prefix_fraction: float | None = None,
                search=None) -> GraphHandle:
        """Upload one graph through the named backend; returns its handle.

        ``hot_prefix_fraction`` only applies to the sharded backend (the
        single-device path has no per-step exchange to thin out).
        ``search`` (a `repro_torch.search.SearchSpec`) attaches the
        served-order vector corpus that makes the handle servable by
        ``knn_search``.
        """
        if backend == "sharded":
            return self.sharded.prepare(
                graph, canonical_ids=canonical_ids,
                hot_prefix_fraction=hot_prefix_fraction, search=search)
        return self.backend(backend).prepare(graph,
                                             canonical_ids=canonical_ids,
                                             search=search)

    # ------------------------------------------------------------------ run
    def run(self, target, kernel: str, sources=None) -> torch.Tensor:
        """Execute one query batch.

        Multi-source kernels return per-source rows ``(S, V)``; global
        kernels ignore ``sources`` and return ``(V,)``. Results are
        synchronised (serving latency = device latency) and sliced to the
        graph's real vertex count.
        """
        if isinstance(target, GraphHandle):
            return self.backend(target.backend).run(target, kernel, sources)
        if isinstance(target, GraphArrays):
            return self.single.run_arrays(target, kernel, sources)
        raise TypeError(f"expected GraphHandle or GraphArrays, "
                        f"got {type(target).__name__}")

    # ----------------------------------------------------------- telemetry
    @property
    def cache_hits(self) -> int:
        return self.single.cache_hits

    @property
    def cache_misses(self) -> int:
        return self.single.cache_misses

    @property
    def queries_run(self) -> int:
        sharded = self._sharded.queries_run if self._sharded else 0
        return self.single.queries_run + sharded

    @property
    def sources_run(self) -> int:
        sharded = self._sharded.sources_run if self._sharded else 0
        return self.single.sources_run + sharded

    def telemetry(self) -> dict:
        # cross-backend totals; the detail (cached keys, bucketing stats,
        # shard counts) lives per backend
        return {
            "compile_cache_hits": self.cache_hits,
            "compile_cache_misses": self.cache_misses,
            "queries_run": self.queries_run,
            "sources_run": self.sources_run,
            "single": self.single.telemetry(),
            "sharded": self._sharded.telemetry() if self._sharded else None,
        }


__all__ = ["GLOBAL", "MULTI_SOURCE", "VECTOR_SOURCE", "BatchedExecutor",
           "GraphHandle", "ShardedBackend", "SingleDeviceBackend"]
