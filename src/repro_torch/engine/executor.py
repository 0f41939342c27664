"""Batched query executor: the routing facade over execution backends.

The serving-side answer to the paper's framing (section 4: the traversal
kernels whose cache behaviour reordering improves): the same kernels the
benchmarks time, run behind a cache of per-shape callables, with
multi-source queries batched into one (S, V) launch padded to
power-of-two source buckets. The mechanics live in `backends.py`.

`BatchedExecutor.run` accepts either a `GraphHandle` from ``prepare``
(routed to the handle's backend) or raw `GraphArrays` (single-device
path, exact shapes). Only the single-device backend is ported so far;
the sharded one is ROADMAP A7.
"""
from __future__ import annotations

import torch

from ..algos.graph_arrays import GraphArrays
from ..core.csr import Graph
from .backends import (GLOBAL, MULTI_SOURCE, VECTOR_SOURCE, ExecutionBackend,
                       GraphHandle, SingleDeviceBackend)


class BatchedExecutor:
    """Runs kernels against prepared graph handles through their backend."""

    def __init__(self, single: SingleDeviceBackend | None = None,
                 num_shards: int | None = None, bucketing: bool = True,
                 max_cached_executables: int | None = None,
                 metrics=None, fused: bool | None = None,
                 device: str | torch.device | None = None):
        if num_shards is not None or fused is not None:
            # both configure the sharded backend
            raise NotImplementedError("sharded backend: ROADMAP A7")
        self.single = single or SingleDeviceBackend(
            bucketing=bucketing,
            max_cached_executables=max_cached_executables,
            metrics=metrics, device=device)
        # one registry spans the facade and its backends — a session
        # adopts it so every engine metric shares a namespace (obs.py).
        self.metrics = self.single.metrics
        self._tracer = None

    @property
    def device(self) -> torch.device:
        return self.single.device

    @property
    def sharded(self):
        raise NotImplementedError("sharded backend: ROADMAP A7")

    @property
    def tracer(self):
        return self._tracer

    @tracer.setter
    def tracer(self, tracer) -> None:
        """Hand the session's tracer to the backend (for launch-internal
        spans: device_sync, cache misses)."""
        self._tracer = tracer
        self.single.tracer = tracer

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

        ``hot_prefix_fraction`` only applies to the sharded backend.
        """
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
        return self.single.queries_run

    @property
    def sources_run(self) -> int:
        return self.single.sources_run

    def telemetry(self) -> dict:
        return {
            "compile_cache_hits": self.cache_hits,
            "compile_cache_misses": self.cache_misses,
            "queries_run": self.queries_run,
            "sources_run": self.sources_run,
            "single": self.single.telemetry(),
            "sharded": None,
        }


__all__ = ["GLOBAL", "MULTI_SOURCE", "VECTOR_SOURCE", "BatchedExecutor",
           "GraphHandle", "SingleDeviceBackend"]
