"""Graph analytics serving engine (docs/engine.md, docs/policy.md).

Turns the one-shot reproduction benchmarks into a serving system: a
registry of probed graphs, an adaptive reorder policy that decides *when*
and *how* to reorder from cheap structural probes plus expected query
volume, a compile-cached batched executor, and a session front-end with
an amortization ledger. The front door is a request plane
(scheduler.py, docs/scheduler.md): ``enqueue`` returns a `QueryFuture`,
and a micro-batch scheduler coalesces concurrent multi-source requests
into shared vmapped launches, dedupes global-kernel requests, and drains
in priority/deadline order — ``submit`` survives as enqueue + flush
sugar. The loop is closed: realized outcomes calibrate the policy's
per-scheme strengths (calibration.py), the scheduler's observed batch
shapes feed placement (policy.py), and the session re-decides —
re-reordering in place at flush boundaries — when realized traffic
diverges from the registration hint or a reorder provably cannot
amortize.

This is the PyTorch port of `repro.engine`: CUDA by default,
``device="cpu"`` on request; a sharded placement partitions the graph
over a mesh of shards on those devices (core/dist.py).
"""
from .backends import (SHARDED_KERNELS, VECTOR_SOURCE, ExecutionBackend,
                       GraphHandle, ShardedBackend, SingleDeviceBackend,
                       bucket_dims, estimate_device_bytes)
from .calibration import DEFAULT_PRIORS, SchemeStats, StrengthCalibrator
from .executor import BatchedExecutor
from .obs import (Clock, Counter, Gauge, Histogram, ManualClock,
                  MetricsRegistry, ProfilerHook, RateWindow, Tracer,
                  validate_chrome_trace)
from .policy import (AdmissionPolicy, PolicyDecision, PolicyRecord,
                     ReorderPolicy, decision_changed)
from .registry import (GraphProbes, GraphRegistry, degree_histogram,
                       gini_from_histogram, hub_stats_from_histogram,
                       probe_graph)
from .result_cache import ResultCache
from .scheduler import (AdmissionRejected, DeadlineExceeded,
                        MicroBatchScheduler, QueryFuture, Request,
                        canonical_component_labels)
from .session import AmortizationLedger, EngineSession

__all__ = [
    "AdmissionPolicy", "AdmissionRejected", "AmortizationLedger",
    "BatchedExecutor", "Clock", "Counter", "DEFAULT_PRIORS",
    "DeadlineExceeded", "EngineSession", "ExecutionBackend", "Gauge",
    "GraphHandle", "GraphProbes", "GraphRegistry", "Histogram",
    "ManualClock", "MetricsRegistry", "MicroBatchScheduler",
    "PolicyDecision", "PolicyRecord", "ProfilerHook", "QueryFuture",
    "RateWindow", "ReorderPolicy", "Request", "ResultCache",
    "SHARDED_KERNELS", "SchemeStats", "ShardedBackend",
    "SingleDeviceBackend", "StrengthCalibrator", "Tracer",
    "VECTOR_SOURCE", "bucket_dims",
    "canonical_component_labels", "decision_changed", "degree_histogram",
    "estimate_device_bytes", "gini_from_histogram",
    "hub_stats_from_histogram", "probe_graph", "validate_chrome_trace",
]
