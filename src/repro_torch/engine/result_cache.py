"""Cross-request result cache with GRASP-style hot-entry pinning.

The paper's premise is that hot vertices are few and hit constantly;
Faldu et al. (*Domain-Specialized Cache Management for Graph Analytics*,
PAPERS.md) sharpen it into a cache-management rule: results keyed on
hot vertices are precisely the reusable ones, and the hot set is stable
over time. The request plane already computes the artifact that tells
hot from cold — the reorder permutation packs hubs into a low-id prefix
— so the scheduler can cache per-source result rows and *pin* the ones
whose source lands inside the hot prefix while cold entries ride a
size-bounded LRU.

Keying: ``(graph_id, generation, kernel, source)``, with ``source =
GLOBAL_SOURCE`` (-1) for source-independent kernels (pr/cc/ccsv). The
layout ``generation`` is part of the key, so a re-decision *cannot*
serve a row computed under a replaced layout even before
``invalidate_graph`` reclaims the stale entries — invalidation is a
memory optimization, correctness rides on the key.

Thread-safe (one lock around the stores): the scheduler may be polled
from a background auto-flush thread. Metrics land in the session's
`MetricsRegistry` (``engine_result_cache_*``) so hit/miss/eviction
traffic and occupancy export through ``to_prometheus()`` like every
other engine signal (docs/observability.md).
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict

import numpy as np

from .obs import MetricsRegistry

# source id used to key results of source-independent (global) kernels;
# real sources are validated non-negative at enqueue so -1 cannot collide
GLOBAL_SOURCE = -1

Key = tuple[str, int, str, int]


class ResultCache:
    """Size-bounded LRU of per-source result rows + a pinned hot store.

    ``get``/``put`` move complete result rows (original-id space, exactly
    what a future resolves with), so a hit is a pure memory read — no
    launch, no translation. Pinned entries (hot-prefix sources, global
    kernels) never ride the LRU clock; cold entries evict
    least-recently-used once ``max_entries`` is reached. ``max_pinned``
    bounds the pinned store too (overflow demotes to the LRU) so a
    pathological hot prefix cannot grow memory without bound.
    """

    def __init__(self, max_entries: int = 4096,
                 max_pinned: int | None = None,
                 registry: MetricsRegistry | None = None,
                 max_age_s: float | None = None,
                 max_bytes: int | None = None,
                 clock=None):
        if max_entries < 1:
            raise ValueError("max_entries must be >= 1")
        if max_age_s is not None and max_age_s <= 0:
            raise ValueError("max_age_s must be > 0 or None")
        if max_bytes is not None and max_bytes < 1:
            raise ValueError("max_bytes must be >= 1 or None")
        self.max_entries = max_entries
        self.max_pinned = max_pinned if max_pinned is not None else max_entries
        # optional freshness bound: entries older than max_age_s seconds
        # (by `clock`, injectable for tests / the session's virtual clock)
        # read as misses and are reclaimed on touch. Applies to pinned
        # entries too — pinning exempts a row from LRU pressure, not from
        # going stale.
        self.max_age_s = max_age_s
        # optional byte bound on resident rows: cold entries evict LRU
        # until under it (pinned bytes count toward it; max_pinned is the
        # lever bounding those)
        self.max_bytes = max_bytes
        self._clock = clock if clock is not None else time.monotonic
        # stores hold (row, stamp, nbytes)
        self._lru: OrderedDict[Key, tuple] = OrderedDict()
        self._pinned: dict[Key, tuple] = {}
        self._bytes = 0
        self._lock = threading.Lock()
        m = registry or MetricsRegistry()
        self.metrics = m
        self._c_hits = m.counter("engine_result_cache_hits_total",
                                 "result rows served from memory")
        self._c_misses = m.counter("engine_result_cache_misses_total",
                                   "result lookups that needed a launch")
        self._c_evictions = m.counter("engine_result_cache_evictions_total",
                                      "cold entries dropped by the LRU")
        self._c_expired = m.counter("engine_result_cache_expired_total",
                                    "entries dropped past max_age_s")
        self._g_pinned = m.gauge("engine_result_cache_pinned",
                                 "hot-prefix entries resident (pinned)")
        self._g_entries = m.gauge("engine_result_cache_entries",
                                  "total cached result rows (occupancy)")
        self._g_bytes = m.gauge("engine_result_cache_bytes",
                                "resident result-row payload bytes")

    # ------------------------------------------------------------ counters
    @property
    def hits(self) -> int:
        return self._c_hits.value

    @property
    def misses(self) -> int:
        return self._c_misses.value

    @property
    def evictions(self) -> int:
        return self._c_evictions.value

    @property
    def expired(self) -> int:
        return self._c_expired.value

    @property
    def pinned_count(self) -> int:
        return len(self._pinned)

    @property
    def entries(self) -> int:
        return len(self._lru) + len(self._pinned)

    @property
    def resident_bytes(self) -> int:
        return self._bytes

    # ------------------------------------------------------------- core api
    @staticmethod
    def key(graph_id: str, generation: int, kernel: str,
            source: int = GLOBAL_SOURCE) -> Key:
        return (graph_id, int(generation), kernel, int(source))

    def _fresh(self, entry: tuple) -> bool:
        if self.max_age_s is None:
            return True
        return self._clock() - entry[1] <= self.max_age_s

    def get(self, graph_id: str, generation: int, kernel: str,
            source: int = GLOBAL_SOURCE) -> np.ndarray | None:
        """The cached row, or None (counts a hit or a miss either way).
        An entry past ``max_age_s`` reads as a miss and is reclaimed."""
        k = self.key(graph_id, generation, kernel, source)
        with self._lock:
            entry = self._pinned.get(k)
            store = self._pinned
            if entry is None:
                entry = self._lru.get(k)
                store = self._lru
                if entry is not None:
                    self._lru.move_to_end(k)       # refresh recency
            if entry is not None and not self._fresh(entry):
                del store[k]
                self._bytes -= entry[2]
                self._c_expired.inc()
                self._sync_gauges()
                entry = None
            if entry is None:
                self._c_misses.inc()
                return None
            self._c_hits.inc()
            return entry[0]

    def put(self, graph_id: str, generation: int, kernel: str,
            source: int, row: np.ndarray, pinned: bool = False) -> None:
        """Insert one result row; ``pinned`` keeps it off the LRU clock."""
        k = self.key(graph_id, generation, kernel, source)
        entry = (row, self._clock(), int(getattr(row, "nbytes", 0)))
        with self._lock:
            # an already-pinned key refreshes in place even at max_pinned —
            # otherwise the write is silently dropped and the stale row
            # stays pinned forever
            if pinned and (k in self._pinned
                           or len(self._pinned) < self.max_pinned):
                old = self._lru.pop(k, None) or self._pinned.get(k)
                if old is not None:
                    self._bytes -= old[2]
                self._pinned[k] = entry
                self._bytes += entry[2]
            elif k not in self._pinned:
                old = self._lru.pop(k, None)
                if old is not None:
                    self._bytes -= old[2]
                self._lru[k] = entry
                self._bytes += entry[2]
                while len(self._lru) > self.max_entries:
                    _, dropped = self._lru.popitem(last=False)
                    self._bytes -= dropped[2]
                    self._c_evictions.inc()
                if self.max_bytes is not None:
                    # evict cold LRU entries until under the byte bound;
                    # pinned bytes are untouchable here by design
                    while self._bytes > self.max_bytes and self._lru:
                        _, dropped = self._lru.popitem(last=False)
                        self._bytes -= dropped[2]
                        self._c_evictions.inc()
            self._sync_gauges()

    def invalidate_graph(self, graph_id: str) -> int:
        """Drop every entry of one graph (all generations); returns the
        count. Called on re-decision — the generation key already makes
        stale rows unreachable, this reclaims their memory."""
        with self._lock:
            doomed = [k for k in self._lru if k[0] == graph_id]
            for k in doomed:
                self._bytes -= self._lru.pop(k)[2]
            doomed_pinned = [k for k in self._pinned if k[0] == graph_id]
            for k in doomed_pinned:
                self._bytes -= self._pinned.pop(k)[2]
            self._sync_gauges()
            return len(doomed) + len(doomed_pinned)

    def clear(self) -> None:
        with self._lock:
            self._lru.clear()
            self._pinned.clear()
            self._bytes = 0
            self._sync_gauges()

    def _sync_gauges(self) -> None:
        self._g_pinned.set(len(self._pinned))
        self._g_entries.set(len(self._lru) + len(self._pinned))
        self._g_bytes.set(self._bytes)

    # ----------------------------------------------------------- telemetry
    def stats(self) -> dict:
        looked = self.hits + self.misses
        return {
            "entries": self.entries,
            "pinned": self.pinned_count,
            "max_entries": self.max_entries,
            "bytes": self.resident_bytes,
            "max_bytes": self.max_bytes,
            "max_age_s": self.max_age_s,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "expired": self.expired,
            "hit_rate": round(self.hits / looked, 4) if looked else 0.0,
        }


__all__ = ["GLOBAL_SOURCE", "ResultCache"]
