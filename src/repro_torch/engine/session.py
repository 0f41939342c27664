"""Session front-end: register graphs, enqueue/submit queries, telemetry.

``EngineSession`` ties the subsystem together: registration probes the
graph (registry), picks and applies a reordering *and a placement*
(policy: single-device bucketed upload, or sharded across devices when
the CSR footprint exceeds the device budget — see backends.py), uploads
the served layout through the chosen backend, and opens an amortization
ledger.

The primary query API is the **request plane** (scheduler.py):
``enqueue(...)`` returns a `QueryFuture` and nothing launches until a
flush boundary, where the `MicroBatchScheduler` coalesces pending
multi-source requests into one vmapped launch, deduplicates concurrent
global-kernel requests, and drains in priority/deadline order.
``submit`` remains as enqueue + flush sugar — the exact blocking
behaviour it always had, one request riding a one-element micro-batch.
Either way sources are translated into the served id space at launch
time, results are translated back (component-label *values* are
canonicalized to original vertex ids too — scheduler.py's
`canonical_component_labels`), and callers never see the internal layout
or the placement.

A registration-time decision is **not final**. The session tracks
realized query volume per graph, and when it diverges from the
registration hint past ``redecide_factor`` — or the ledger shows the
chosen reorder will never amortize (realized gain <= 0) — it re-runs the
policy with the updated volume and the calibrator's fitted strengths,
re-reorders in place, and resets the ledger. Re-decisions are capped,
logged, and visible in ``telemetry()`` (docs/policy.md walks the
lifecycle).

The ledger is deliberately conservative: reorder cost is *measured*;
per-query savings are *estimated* from the cache simulator's realized
miss-rate reduction applied to measured query wall time (wall time on
this host includes XLA overheads that dilute cache effects, so the
simulator ratio is the paper-faithful signal). benchmarks/engine.py
measures both layouts directly for the honest wall-clock version.
"""
from __future__ import annotations

import dataclasses
import math
import threading

import numpy as np

from ..cache.sim import estimate_miss_rate, scaled_config
from ..core.csr import Graph
from ..core.mutate import apply_edge_delta
from ..core.patch_reorder import patch_permutation
from ..search.knn_graph import medoid_entry, validate_search_graph
from ..search.serve import SearchParams, SearchSpec, visit_hot_mask
from .executor import MULTI_SOURCE, VECTOR_SOURCE, BatchedExecutor
from .obs import Clock, MetricsRegistry, ProfilerHook, Tracer
from .policy import (AdmissionPolicy, PolicyDecision, ReorderPolicy,
                     decision_changed)
from .registry import GraphEntry, GraphRegistry
from .result_cache import ResultCache
from .scheduler import (LABEL_KERNELS, MicroBatchScheduler, QueryFuture,
                        canonical_component_labels)


@dataclasses.dataclass
class AmortizationLedger:
    """Tracks whether one reorder has paid for itself yet.

    Placement changes the break-even math: on the sharded backend each
    traversal step pays an all-gather whose cost locality does not
    remove, so the miss-rate gain only applies to the compute fraction of
    a launch. ``gain_discount`` (< 1 for sharded graphs) scales the gain
    before savings are booked — sharded reorders take proportionally more
    queries to amortize, which is exactly what the re-decision trigger
    should see. The hot-prefix exchange shrinks exactly that collective
    cost, so a sharded graph serving with ``hot_prefix_fraction`` gets a
    *milder* discount: the base discount scaled by the fraction of
    full-exchange bytes still paid (`EngineSession._gain_discount`).
    """

    reorder_seconds: float
    realized_gain: float          # fractional miss-rate reduction
    queries_served: int = 0
    sources_served: int = 0
    query_seconds: float = 0.0
    estimated_saved_seconds: float = 0.0
    estimated_lost_seconds: float = 0.0
    backend: str = "single"
    gain_discount: float = 1.0    # fraction of the gain that reaches wall

    def record_query(self, num_sources: int, wall_seconds: float) -> None:
        self.queries_served += 1
        self.sources_served += num_sources
        self.query_seconds += wall_seconds
        # time this query would have cost on the original layout, assuming
        # wall ∝ property misses: t_before = t_after / (1 - gain)
        gain = min(self.realized_gain * self.gain_discount, 0.95)
        if gain > 0:
            self.estimated_saved_seconds += wall_seconds * gain / (1 - gain)
        elif gain < 0:
            # a regressing reorder must not book negative "savings" that
            # silently shrink the total — surface the loss on its own line
            self.estimated_lost_seconds += wall_seconds * -gain / (1 - gain)

    @property
    def regressed(self) -> bool:
        """True when the reorder made cache behaviour worse."""
        return self.realized_gain < 0

    @property
    def amortized(self) -> bool:
        return self.estimated_saved_seconds >= self.reorder_seconds

    @property
    def break_even_queries(self) -> float:
        """Queries needed to repay the reorder at the observed rate."""
        if self.queries_served == 0 or self.estimated_saved_seconds <= 0:
            return float("inf")
        per_query = self.estimated_saved_seconds / self.queries_served
        return self.reorder_seconds / per_query

    def as_dict(self) -> dict:
        # strict-JSON shape: a never-amortizing reorder reports
        # break_even_queries=None plus an explicit flag, never the
        # non-standard Infinity literal json.dumps would otherwise emit
        be = self.break_even_queries
        never = math.isinf(be)
        return {**dataclasses.asdict(self),
                "regressed": self.regressed,
                "amortized": self.amortized,
                "break_even_queries": None if never else be,
                "break_even_never": never}


@dataclasses.dataclass(frozen=True)
class _PendingSwap:
    """A completed async full reorder waiting for a flush boundary.

    ``token`` is the entry's mutation count when the reorder was
    scheduled: if the graph mutated again while LOrder ran, the perm
    describes a graph that no longer exists and the swap is discarded.
    """

    decision: PolicyDecision
    perm: np.ndarray
    reorder_seconds: float
    token: int
    trigger: str


class EngineSession:
    """enqueue(...) -> QueryFuture / submit(...) -> results (original ids)."""

    def __init__(self, policy: ReorderPolicy | None = None,
                 registry: GraphRegistry | None = None,
                 executor: BatchedExecutor | None = None,
                 cache_cfg=None,
                 redecide_factor: float = 4.0,
                 redecide_min_queries: int = 8,
                 max_redecisions: int = 3,
                 device_budget_bytes: int | None = None,
                 num_shards: int | None = None,
                 sharded_gain_discount: float = 0.5,
                 max_batch_sources: int | None = None,
                 max_delay: float | None = 0.25,
                 auto_flush_interval: float | None = None,
                 admission: AdmissionPolicy | None = None,
                 result_cache: "ResultCache | bool" = True,
                 result_cache_entries: int = 4096,
                 result_cache_max_age_s: float | None = None,
                 result_cache_max_bytes: int | None = None,
                 clock: Clock | None = None,
                 tracer: Tracer | None = None,
                 profiler_dir: str | None = None,
                 fused: bool = True,
                 probe_drift_threshold: float = 0.5,
                 async_full_reorder: bool = True,
                 device=None):
        # an explicitly supplied policy carries its own budget; the
        # session-level knob only configures the default policy
        self.policy = policy or ReorderPolicy(
            device_budget_bytes=device_budget_bytes)
        self.registry = registry or GraphRegistry()
        self.executor = executor or BatchedExecutor(num_shards=num_shards,
                                                    fused=fused,
                                                    device=device)
        self.cache_cfg = cache_cfg  # None = scaled_config per graph
        self.redecide_factor = redecide_factor
        self.redecide_min_queries = redecide_min_queries
        self.max_redecisions = max_redecisions
        self.sharded_gain_discount = sharded_gain_discount
        self.redecision_log: list[dict] = []
        # observability plane (obs.py): ONE clock every latency number is
        # read from, ONE metrics registry (adopted from the executor so
        # backend counters land in the same namespace), ONE tracer the
        # executor's backends share for launch-internal spans
        self.clock = clock or Clock()
        self.metrics_registry: MetricsRegistry = self.executor.metrics
        self.tracer = tracer or Tracer(clock=self.clock)
        self.executor.tracer = self.tracer
        self.profiler = ProfilerHook(profiler_dir)
        m = self.metrics_registry
        self._c_registered = m.counter("engine_graphs_registered_total",
                                       "graphs registered with the session")
        self._c_reorders = m.counter("engine_reorders_total",
                                     "policy decisions applied (incl. "
                                     "registration)")
        self._c_redecisions = m.counter("engine_redecisions_total",
                                        "re-decisions that replaced a layout")
        # dynamic-graph plane (update_graph): counters + async-swap state
        self.probe_drift_threshold = probe_drift_threshold
        self.async_full_reorder = async_full_reorder
        self._pending_swaps: dict[str, _PendingSwap] = {}
        self._reorder_threads: list[threading.Thread] = []
        self._c_mutations = m.counter("engine_mutations_total",
                                      "edge deltas applied via update_graph")
        self._c_edges_added = m.counter("engine_edges_added_total",
                                        "edges added across all mutations")
        self._c_edges_removed = m.counter("engine_edges_removed_total",
                                          "edges removed across all mutations")
        self._c_patches = m.counter("engine_patch_reorders_total",
                                    "incremental hot-prefix patches applied")
        self._c_swaps = m.counter("engine_layout_swaps_total",
                                  "async full reorders swapped in at a "
                                  "flush boundary")
        self._c_swaps_discarded = m.counter(
            "engine_layout_swaps_discarded_total",
            "async full reorders invalidated by a newer mutation")
        # cross-request result cache (result_cache.py): True builds one in
        # the session's metrics namespace, False disables it, or pass a
        # pre-configured ResultCache (its own metrics registry is kept)
        if isinstance(result_cache, ResultCache):
            self.result_cache: ResultCache | None = result_cache
        elif result_cache:
            self.result_cache = ResultCache(max_entries=result_cache_entries,
                                            registry=m,
                                            max_age_s=result_cache_max_age_s,
                                            max_bytes=result_cache_max_bytes,
                                            clock=self.clock.now)
        else:
            self.result_cache = None
        self.scheduler = MicroBatchScheduler(
            self, max_batch_sources=max_batch_sources,
            max_delay=max_delay, admission=admission)
        if auto_flush_interval is not None:
            self.scheduler.start_auto_flush(auto_flush_interval)

    def metrics(self) -> MetricsRegistry:
        """The session-wide metrics registry (``.snapshot()`` /
        ``.to_prometheus()`` — docs/observability.md has the catalog)."""
        return self.metrics_registry

    def start_profiler(self) -> bool:
        """Begin a ``torch.profiler`` trace (needs ``profiler_dir``)."""
        return self.profiler.start()

    def stop_profiler(self) -> bool:
        return self.profiler.stop()

    # ----------------------------------------------------------- lifecycle
    def close(self, drain: bool = True) -> None:
        """Stop the background auto-flush thread (if any), wait for any
        in-flight async full reorders, and, by default, drain every
        pending request so no future is left dangling (the drain's final
        flush also applies any completed layout swap)."""
        self.scheduler.stop_auto_flush()
        for t in self._reorder_threads:
            t.join(timeout=120.0)
        self._reorder_threads.clear()
        if drain:
            self.scheduler.drain()

    def __enter__(self) -> "EngineSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # on an exception path still tear the thread down, but don't let a
        # drain launch shadow the original error
        self.close(drain=exc_type is None)

    # ----------------------------------------------------------- register
    def register(self, graph: Graph, graph_id: str | None = None,
                 expected_queries: int = 64, vectors=None,
                 search_params: SearchParams | None = None) -> str:
        """Register a graph for serving; returns its id.

        Passing ``vectors`` (one float32 row per vertex) registers the
        graph as a **search graph** (``family="search"``): the graph must
        be a valid fixed-out-degree k-NN graph (`search.knn_graph`), the
        ``knn`` kernel becomes enqueueable against it, and the policy
        decides from *visit* telemetry rather than degree skew (degrees
        are uniform by construction — docs/search.md). ``search_params``
        defaults to ``SearchParams(k_out=<graph degree>)``; its ``k_out``
        must match the graph's fixed out-degree.
        """
        family = "analytics"
        if vectors is not None:
            vecs = np.ascontiguousarray(vectors, dtype=np.float32)
            if vecs.ndim != 2 or len(vecs) != graph.num_vertices:
                raise ValueError(
                    f"vectors must be ({graph.num_vertices}, d); got "
                    f"shape {vecs.shape}")
            k_out = validate_search_graph(graph)
            if search_params is None:
                search_params = SearchParams(k_out=k_out)
            elif search_params.k_out != k_out:
                raise ValueError(
                    f"search_params.k_out={search_params.k_out} but the "
                    f"graph's fixed out-degree is {k_out}")
            family = "search"
        elif search_params is not None:
            raise ValueError("search_params requires vectors=")
        with self.tracer.span("register", graph_id=graph_id or graph.name):
            with self.tracer.span("probe", graph_id=graph_id or graph.name):
                entry = self.registry.add(graph, graph_id, expected_queries,
                                          family=family)
            if family == "search":
                entry.vectors = vecs
                entry.search_params = search_params
                entry.entry_point = medoid_entry(vecs)
            decision = self.policy.decide(entry.probes, expected_queries)
            self._apply_decision(entry, decision)
        self._c_registered.inc()
        return entry.graph_id

    def _search_spec(self, entry: GraphEntry) -> SearchSpec | None:
        """Layout-bound SearchSpec for the entry's *current* permutation
        (None for analytics graphs). Built fresh on every (re)prepare so
        the served-order vector matrix always matches the layout."""
        if entry.vectors is None:
            return None
        return SearchSpec(
            vectors=np.ascontiguousarray(entry.vectors[entry.inv_perm]),
            entry=int(entry.perm[entry.entry_point]),
            canon=np.asarray(entry.inv_perm, dtype=np.int32),
            params=entry.search_params)

    def _visits_for(self, entry: GraphEntry) -> np.ndarray | None:
        """Visit EWMA padded to the current vertex count (update_graph
        may have grown the vertex set since telemetry last arrived)."""
        v = entry.visit_ewma
        if v is not None and len(v) < entry.graph.num_vertices:
            v = np.pad(v, (0, entry.graph.num_vertices - len(v)))
        return v

    def _apply_decision(self, entry: GraphEntry, decision: PolicyDecision,
                        perm: np.ndarray | None = None,
                        reorder_seconds: float | None = None) -> None:
        """Reorder ``entry.graph`` per ``decision`` and (re)build serving
        state: permutations, served layout, device arrays, policy record,
        fresh ledger. Used at registration, on re-decision, and (with a
        ``perm`` precomputed off the request path) when an async full
        reorder swaps in at a flush boundary.

        Bumps the entry's layout ``generation``: the scheduler stamps
        every served request with the generation whose perm translated
        it, and only re-decides at flush boundaries, so no in-flight
        future ever straddles this replacement.
        """
        entry.decision = decision
        entry.generation += 1
        if self.result_cache is not None:
            # the generation key already makes the old layout's rows
            # unreachable; this reclaims exactly the stale graph's memory
            self.result_cache.invalidate_graph(entry.graph_id)
        if perm is None:
            t0 = self.clock.now()
            with self.tracer.span("reorder", graph_id=entry.graph_id,
                                  scheme=decision.scheme,
                                  generation=entry.generation):
                perm = np.asarray(
                    self.policy.reorder_fn(
                        decision,
                        visits=self._visits_for(entry))(entry.graph))
            entry.reorder_seconds = self.clock.now() - t0
        else:
            perm = np.asarray(perm)
            # the reorder wall was paid off the request path; book it so
            # the ledger still amortizes against the true cost
            entry.reorder_seconds = (reorder_seconds
                                     if reorder_seconds is not None else 0.0)
        self._c_reorders.inc()
        self.metrics_registry.histogram(
            "engine_reorder_seconds", "wall cost of applying one decision",
            scheme=decision.scheme).observe(entry.reorder_seconds)

        entry.perm = perm
        inv = np.empty_like(perm)
        inv[perm] = np.arange(len(perm))
        entry.inv_perm = inv
        if decision.scheme == "original":
            # fast path: no reorder, no benefit to measure — skip the
            # (graph-sized) cache simulation entirely
            entry.served = entry.graph
            before = after = 0.0
        else:
            entry.served = entry.graph.apply_permutation(perm)
            cfg = self.cache_cfg or scaled_config(entry.graph)
            before = estimate_miss_rate(entry.graph, cfg)
            after = estimate_miss_rate(entry.served, cfg)
        # canonical_ids = inverse perm keeps SSSP edge weights identical to
        # the original layout, so served results match original-layout runs
        with self.tracer.span("prepare", graph_id=entry.graph_id,
                              backend=decision.backend):
            entry.handle = self.executor.prepare(
                entry.served, backend=decision.backend, canonical_ids=inv,
                hot_prefix_fraction=decision.hot_prefix_fraction,
                search=self._search_spec(entry))
        entry.backend = decision.backend
        entry.bucket_shape = entry.handle.bucket
        entry.hot_prefix_fraction = decision.hot_prefix_fraction
        # locality layouts pack hubs into a low-id prefix; identity/random
        # layouts have no hot prefix to pin result-cache entries against.
        # Visit-ordered layouts size the prefix from the *observed* hot
        # set rather than the (uniform, for search graphs) degree one.
        hot_frac = (entry.probes.visit_hub_fraction
                    if decision.hotness_source == "visits"
                    else entry.probes.hub_fraction)
        entry.hot_prefix_len = (
            0 if decision.scheme in ("original", "random")
            else int(round(hot_frac * entry.graph.num_vertices)))
        entry.arrays = entry.handle.arrays  # None when served sharded

        rec = self.policy.record(entry.graph_id, decision, before, after,
                                 entry.reorder_seconds,
                                 family=entry.probes.family)
        entry.ledger = AmortizationLedger(entry.reorder_seconds,
                                          rec.realized_gain,
                                          backend=decision.backend,
                                          gain_discount=self._gain_discount(
                                              decision))

    def _gain_discount(self, decision: PolicyDecision) -> float:
        """Fraction of the miss-rate gain booked as wall savings.

        Single-device serving books the full gain. Sharded serving books
        ``sharded_gain_discount`` — collectives dilute locality savings —
        but the hot-prefix exchange removes part of that collective cost:
        with fraction f gathered per step and a full exchange every k
        steps, roughly ``f + (1 - f)/k`` of the full-exchange bytes are
        still paid, and only that share of the dilution applies.
        """
        if decision.backend != "sharded":
            return 1.0
        base = self.sharded_gain_discount
        f = decision.hot_prefix_fraction
        if not f:
            return base
        k = max(self.executor.sharded.cold_every, 1)
        exchange_ratio = min(f + (1.0 - f) / k, 1.0)
        return round(1.0 - (1.0 - base) * exchange_ratio, 4)

    # ------------------------------------------------------ dynamic graphs
    def update_graph(self, graph_id: str, add_edges=None, remove_edges=None,
                     *, reorder: str = "auto", add_vertices: int = 0,
                     vectors=None) -> dict:
        """Apply an edge delta to a registered graph (the mutation API).

        Edges are ``(k, 2)`` original-id pairs; removal is multiset
        (each pair removes one occurrence, missing edges raise). The
        mutation runs under a scheduler **fence**: every in-flight
        request for this graph is served under its pre-mutation
        generation first, then the plane's lock is held while the CSR is
        rebuilt (`core.mutate`), probes refresh incrementally or fully
        past the drift threshold (`registry.apply_mutation`), the layout
        is **patched** — a stable O(V) hot-prefix repack
        (`core.patch_reorder`) instead of a full reorder — and the
        mutated CSR is re-uploaded/re-bucketed through the backend under
        a bumped generation (every result-cache row invalidated).

        ``reorder`` picks the tier:

        - ``"patch"`` — incremental patch only (the request-path cost).
        - ``"auto"`` (default) — patch now; if the refreshed probes flip
          the policy decision (`policy.decision_changed`), additionally
          run the full reorder *asynchronously* off the request path and
          swap it in at a later flush boundary.
        - ``"async"`` — patch now, always schedule the async full reorder.
        - ``"full"`` — synchronous full reorder (blocks for LOrder).

        ``add_vertices`` grows the vertex set by that many ids, appended
        at the top of the original id range (``add_edges`` may reference
        them). New vertices join the layout as a cold identity tail —
        the next patch or full reorder places them properly. For search
        graphs, ``vectors`` must supply the ``(add_vertices, d)`` rows of
        the new vertices (`search.knn_graph.nsw_insert_deltas` produces
        both halves of that delta).

        Returns a summary dict (tier, probe mode, generation, walls).
        """
        if reorder not in ("auto", "patch", "async", "full"):
            raise ValueError(f"unknown reorder tier {reorder!r}")
        entry = self.registry.get(graph_id)  # KeyError on unknown id
        new_vecs = None
        if entry.vectors is not None:
            d = entry.vectors.shape[1]
            if (vectors is None) != (add_vertices == 0):
                raise ValueError(
                    "search graphs take add_vertices= and vectors= "
                    "together (one vector row per new vertex)")
            if vectors is not None:
                new_vecs = np.ascontiguousarray(vectors, dtype=np.float32)
                if new_vecs.shape != (int(add_vertices), d):
                    raise ValueError(
                        f"vectors must be ({int(add_vertices)}, {d}); "
                        f"got shape {new_vecs.shape}")
        elif vectors is not None:
            raise ValueError("vectors= requires a search graph "
                             "(registered with vectors=)")
        t0 = self.clock.now()
        with self.scheduler.fence(graph_id):
            with self.tracer.span("mutate", graph_id=graph_id,
                                  tier=reorder):
                n_old = entry.graph.num_vertices
                new_graph, delta = apply_edge_delta(
                    entry.graph, add_edges, remove_edges,
                    add_vertices=add_vertices)
                if delta.edges_changed == 0 and delta.vertices_added == 0:
                    return {"graph_id": graph_id, "added": 0, "removed": 0,
                            "vertices_added": 0,
                            "tier": "noop", "probe_mode": "none",
                            "generation": entry.generation,
                            "full_reorder_scheduled": False,
                            "mutate_seconds": 0.0}
                # a full reorder computed against the pre-mutation graph
                # describes a layout for a graph that no longer exists
                if self._pending_swaps.pop(graph_id, None) is not None:
                    self._c_swaps_discarded.inc()
                probe_mode = self.registry.apply_mutation(
                    graph_id, new_graph, delta,
                    drift_threshold=self.probe_drift_threshold)
                if delta.vertices_added:
                    # grown ids join the layout as a cold identity tail
                    # (served ids n_old..n-1); both tiers below rebuild
                    # the served CSR from this extended permutation
                    tail = np.arange(n_old, new_graph.num_vertices)
                    entry.perm = np.concatenate(
                        [np.asarray(entry.perm, dtype=np.int64), tail])
                    entry.inv_perm = np.concatenate(
                        [np.asarray(entry.inv_perm, dtype=np.int64), tail])
                    if new_vecs is not None:
                        entry.vectors = np.concatenate(
                            [entry.vectors, new_vecs])
                self._c_mutations.inc()
                self._c_edges_added.inc(delta.added)
                self._c_edges_removed.inc(delta.removed)
                schedule_full, trigger, fresh = False, None, None
                if reorder == "full":
                    tier = "full"
                    volume = max(entry.queries_observed,
                                 entry.expected_queries)
                    self._apply_decision(
                        entry, self.policy.decide(entry.probes, volume))
                else:
                    tier = "patch"
                    self._apply_patch(entry)
                    if reorder == "async":
                        schedule_full, trigger = True, "requested"
                    elif reorder == "auto":
                        volume = max(entry.queries_observed,
                                     entry.expected_queries)
                        fresh = self.policy.decide(entry.probes, volume)
                        if decision_changed(entry.decision, fresh):
                            schedule_full = True
                            trigger = "decision-changed"
                if schedule_full:
                    self._schedule_full_reorder(entry, trigger,
                                                decision=fresh)
            wall = self.clock.now() - t0
            self.metrics_registry.histogram(
                "engine_mutate_seconds",
                "wall cost of one update_graph call (fence to return)",
                tier=tier).observe(wall)
        return {"graph_id": graph_id,
                "added": delta.added, "removed": delta.removed,
                "vertices_added": delta.vertices_added,
                "tier": tier, "probe_mode": probe_mode,
                "generation": entry.generation,
                "full_reorder_scheduled": schedule_full,
                "reorder_seconds": entry.reorder_seconds,
                "mutate_seconds": wall}

    def _apply_patch(self, entry: GraphEntry,
                     hot_mask: np.ndarray | None = None) -> None:
        """Incremental patch tier: stable hot-prefix repack + re-upload.

        Keeps the current decision; bumps the generation (invalidating
        every cached row); re-packs the newly-hot vertices into the hot
        prefix with one stable O(V) pass — no graph traversal, no cache
        simulation — and re-uploads/re-buckets the mutated CSR through
        the entry's backend. Identity/random layouts have no hot prefix
        to maintain, so they keep their permutation and only re-upload.
        ``hot_mask`` overrides the degree-based hot set — the visit
        telemetry path (`refresh_hotness`) passes ``visit_hot_mask``.
        """
        decision = entry.decision
        entry.generation += 1
        if self.result_cache is not None:
            self.result_cache.invalidate_graph(entry.graph_id)
        # reorder_seconds keeps `_apply_decision`'s semantics — the cost
        # of *computing the permutation* (here the stable O(V) repack, vs
        # the full tier's LOrder pass); the served rebuild and re-upload
        # are paid by both tiers and land in engine_mutate_seconds
        t0 = self.clock.now()
        with self.tracer.span("patch_reorder", graph_id=entry.graph_id,
                              scheme=decision.scheme,
                              generation=entry.generation):
            if entry.hot_prefix_len > 0:
                perm, inv, hot_len, _info = patch_permutation(
                    entry.graph, entry.perm, entry.hot_prefix_len,
                    hot_mask=hot_mask)
                entry.perm, entry.inv_perm = perm, inv
                entry.hot_prefix_len = hot_len
        entry.reorder_seconds = self.clock.now() - t0
        if decision.scheme == "original":
            entry.served = entry.graph
        else:
            entry.served = entry.graph.apply_permutation(entry.perm)
        with self.tracer.span("prepare", graph_id=entry.graph_id,
                              backend=decision.backend):
            entry.handle = self.executor.prepare(
                entry.served, backend=decision.backend,
                canonical_ids=entry.inv_perm,
                hot_prefix_fraction=decision.hot_prefix_fraction,
                search=self._search_spec(entry))
        entry.bucket_shape = entry.handle.bucket
        entry.arrays = entry.handle.arrays
        self._c_patches.inc()
        self.metrics_registry.histogram(
            "engine_reorder_seconds", "wall cost of applying one decision",
            scheme="patch").observe(entry.reorder_seconds)
        # the stable repack preserves the locality structure the full
        # reorder built, so the realized gain carries forward — now
        # amortizing against the patch's (tiny) cost, with no
        # graph-sized cache simulation on the mutation path
        prev = entry.ledger
        entry.ledger = AmortizationLedger(
            entry.reorder_seconds,
            prev.realized_gain if prev else 0.0,
            backend=decision.backend,
            gain_discount=prev.gain_discount if prev else 1.0)

    def _schedule_full_reorder(self, entry: GraphEntry, trigger: str,
                               decision: PolicyDecision | None = None) -> None:
        """Run the full reorder off the request path; the result becomes a
        `_PendingSwap` applied at the next flush boundary — unless the
        graph mutates again first (the token check discards it)."""
        token = entry.mutations
        graph = entry.graph          # immutable snapshot: mutations replace
        gid = entry.graph_id         # entry.graph, never modify it in place
        if decision is None:
            volume = max(entry.queries_observed, entry.expected_queries)
            decision = self.policy.decide(entry.probes, volume)
        visits = self._visits_for(entry)  # snapshot, like `graph`

        def _work():
            t0 = self.clock.now()
            with self.tracer.span("reorder", graph_id=gid,
                                  scheme=decision.scheme, background=True):
                perm = np.asarray(
                    self.policy.reorder_fn(decision, visits=visits)(graph))
            secs = self.clock.now() - t0
            with self.scheduler._lock:
                if entry.mutations != token:
                    self._c_swaps_discarded.inc()
                    return
                self._pending_swaps[gid] = _PendingSwap(
                    decision, perm, secs, token, trigger)

        if self.async_full_reorder:
            t = threading.Thread(target=_work, daemon=True,
                                 name=f"engine-reorder-{gid}")
            self._reorder_threads.append(t)
            t.start()
        else:
            # inline mode for deterministic tests/benchmarks: the swap
            # still waits for a flush boundary, only the reorder blocks
            _work()

    def _swap_pending_ids(self) -> list[str]:
        """Graphs holding a completed full reorder awaiting a flush."""
        return list(self._pending_swaps)

    def _apply_pending_swap(self, entry: GraphEntry) -> bool:
        """Flush-boundary hook (scheduler): swap in a completed async full
        reorder, or discard it if a newer mutation invalidated it."""
        swap = self._pending_swaps.pop(entry.graph_id, None)
        if swap is None:
            return False
        if swap.token != entry.mutations:
            self._c_swaps_discarded.inc()
            return False
        with self.tracer.span("swap_layout", graph_id=entry.graph_id,
                              scheme=swap.decision.scheme,
                              trigger=swap.trigger):
            self._apply_decision(entry, swap.decision, perm=swap.perm,
                                 reorder_seconds=swap.reorder_seconds)
        self._c_swaps.inc()
        return True

    # ---------------------------------------------- visit-driven hotness
    def refresh_hotness(self, graph_id: str) -> dict:
        """Fold accumulated visit telemetry back into a search layout.

        Search graphs have uniform out-degree, so their skew lives in
        *observed visit frequency* (docs/search.md). Every ``knn`` launch
        folds per-vertex visit counts into the entry's EWMA; this call
        closes the loop: it recomputes the visit-skew probes
        (`registry.refresh_visit_probes`), re-runs the policy, and

        - applies the new decision when it changed (typically
          ``original`` -> ``visitsort`` once enough skew accumulates);
        - otherwise re-packs the hot prefix against the *observed* hot
          set via the patch tier (``patch_permutation`` with
          ``visit_hot_mask``) — the steady-state drift correction, one
          stable O(V) pass, no reorder;
        - does nothing without telemetry or a hot prefix.

        Runs under the scheduler fence so in-flight requests are served
        under their pre-refresh generation. Returns a summary dict.
        """
        entry = self.registry.get(graph_id)
        if entry.vectors is None:
            raise ValueError(f"{graph_id!r} is not a search graph "
                             "(register with vectors=)")
        with self.scheduler.fence(graph_id):
            probes = self.registry.refresh_visit_probes(graph_id)
            volume = max(entry.queries_observed, entry.expected_queries)
            decision = self.policy.decide(probes, volume)
            if decision_changed(entry.decision, decision):
                tier = "full"
                with self.tracer.span("refresh_hotness", graph_id=graph_id,
                                      tier=tier,
                                      new_scheme=decision.scheme):
                    self._apply_decision(entry, decision)
            elif entry.visit_ewma is not None and entry.hot_prefix_len > 0:
                tier = "patch"
                with self.tracer.span("refresh_hotness", graph_id=graph_id,
                                      tier=tier):
                    self._apply_patch(
                        entry,
                        hot_mask=visit_hot_mask(self._visits_for(entry)))
            else:
                tier = "noop"
        return {"graph_id": graph_id, "tier": tier,
                "scheme": entry.decision.scheme,
                "hotness_source": entry.decision.hotness_source,
                "generation": entry.generation,
                "hot_prefix_len": entry.hot_prefix_len,
                "visit_queries": entry.visit_queries,
                "visit_gini": entry.probes.visit_gini,
                "reason": entry.decision.reason}

    # -------------------------------------------------------- re-decision
    def _maybe_redecide(self, entry: GraphEntry) -> dict | None:
        """Re-run the policy when realized traffic contradicts the hint.

        Triggers: (a) realized volume exceeds the hint by
        ``redecide_factor``; (b) the ledger shows the reorder will never
        amortize (realized gain <= 0). The new decision uses the observed
        volume and the calibrator's current fitted strengths; if it only
        re-confirms a never-amortizing scheme, the graph is demoted to the
        original layout instead — a regressing reorder is strictly worse
        than serving the layout we already had.
        """
        if entry.redecisions >= self.max_redecisions:
            return None
        observed = entry.queries_observed
        if observed < self.redecide_min_queries:
            return None
        old = entry.decision
        if observed >= self.redecide_factor * max(entry.expected_queries, 1):
            trigger = "volume-divergence"
        elif old.scheme != "original" and entry.ledger.realized_gain <= 0:
            trigger = "never-amortize"
        else:
            return None

        new_volume = max(observed, entry.expected_queries)
        new = self.policy.decide(entry.probes, new_volume)
        if (trigger == "never-amortize"
                and (new.scheme, new.kwargs) == (old.scheme, old.kwargs)):
            new = PolicyDecision(
                "original", {},
                (f"re-decision demote: {old.scheme} realized gain "
                 f"{entry.ledger.realized_gain:.3f} <= 0 after "
                 f"{entry.ledger.queries_served} queries — it can never "
                 f"amortize, serving the original layout"),
                0.0, new.skew, new.backend,
                None)  # original layout has no packed prefix to exploit
        if (new.scheme, new.kwargs) == (old.scheme, old.kwargs):
            # same choice at the new volume: refresh the hint so the
            # divergence trigger re-arms at redecide_factor x observed
            entry.expected_queries = new_volume
            return None

        with self.tracer.span("redecide", graph_id=entry.graph_id,
                              trigger=trigger, old_scheme=old.scheme,
                              new_scheme=new.scheme):
            self._apply_decision(entry, new)
        self._c_redecisions.inc()
        entry.expected_queries = new_volume
        entry.redecisions += 1
        event = {
            "graph_id": entry.graph_id,
            "trigger": trigger,
            "old_scheme": old.scheme,
            "new_scheme": new.scheme,
            "observed_queries": observed,
            "new_expected_queries": new_volume,
            "reorder_seconds": entry.reorder_seconds,
            "reason": new.reason,
        }
        self.redecision_log.append(event)
        return event

    # ------------------------------------------------------ request plane
    def enqueue(self, graph_id: str, kernel: str, sources=None,
                priority: int = 0,
                deadline_seconds: float | None = None) -> QueryFuture:
        """Queue one query; returns a `QueryFuture` (the primary API).

        Nothing launches until ``flush()``/``drain()`` (or the future's
        own ``result()``, which flushes this graph). Pending requests on
        the same (graph, kernel) coalesce into shared device launches —
        see scheduler.py for the batching, dedup, and ordering rules.
        Sources and results use original vertex ids throughout.
        """
        return self.scheduler.enqueue(graph_id, kernel, sources,
                                      priority=priority,
                                      deadline_seconds=deadline_seconds)

    def flush(self, graph_id: str | None = None) -> int:
        """Serve everything pending (for one graph, or all); returns the
        number of requests served. Re-decisions happen here, per graph,
        after its pending requests are answered."""
        return self.scheduler.flush(graph_id)

    def drain(self) -> int:
        """Flush until no request is pending (lifecycle close)."""
        return self.scheduler.drain()

    def poll(self) -> int:
        """Auto-flush tick: serve any request past its deadline or older
        than ``max_delay``. Runs implicitly on every ``enqueue`` and
        ``QueryFuture.done()`` — call it directly from your own event
        loop, or let ``auto_flush_interval`` run it from a thread."""
        return self.scheduler.poll()

    def submit(self, graph_id: str, kernel: str,
               sources=None) -> np.ndarray:
        """Blocking sugar: enqueue + flush one query batch.

        Multi-source kernels (bfs/sssp/bc) return per-source rows
        ``(S, V)``; global kernels (pr/cc/ccsv) return ``(V,)``. Results
        use original vertex ids — including component-label *values* for
        cc/ccsv (min original id per component). Note: the flush serves
        *all* pending requests on this graph, so interleaving ``submit``
        with ``enqueue`` on one graph resolves the queued futures too.
        """
        future = self.enqueue(graph_id, kernel, sources)
        self.scheduler.flush(graph_id)
        return future.result()

    def bc_aggregate(self, graph_id: str, sources) -> np.ndarray:
        """GAP-style BC score: sum of per-source dependencies (V,)."""
        return self.submit(graph_id, "bc", sources).sum(axis=0)

    # ------------------------------------------------- scheduler internals
    def _launch(self, entry: GraphEntry, kernel: str,
                sources: np.ndarray | None) -> tuple[np.ndarray, float]:
        """One device launch against the entry's *current* layout.

        Sources arrive in original ids and are translated through
        ``entry.perm`` here — at launch time, not enqueue time — so a
        request enqueued before a re-decision is still translated and
        un-translated through one consistent generation. Returns the
        result already back in original id space plus the launch wall.
        """
        tracer = self.tracer
        is_vec = kernel in VECTOR_SOURCE
        served_sources = None
        if kernel in MULTI_SOURCE:
            with tracer.span("translate", graph_id=entry.graph_id,
                             kernel=kernel, generation=entry.generation):
                served_sources = entry.perm[sources].astype(np.int32)
        elif is_vec:
            # query vectors are not vertex ids — nothing to translate;
            # the handle's SearchSpec already binds the served layout
            served_sources = np.ascontiguousarray(sources, dtype=np.float32)
        # attribute the launch to compile vs cache hit through the
        # single backend's miss counter (sharded runners compile on
        # first use per kernel instead — annotated by the backend)
        misses0 = self.executor.single.cache_misses
        t0 = self.clock.now()
        with tracer.span("launch", graph_id=entry.graph_id, kernel=kernel,
                         backend=entry.backend) as span_args:
            with self.profiler.step(kernel,
                                    step_num=self.scheduler.launches):
                out = self.executor.run(entry.handle, kernel,
                                        served_sources)
                if is_vec:
                    ids, visits = out[0].cpu().numpy(), out[1].cpu().numpy()
                else:
                    out = out.cpu().numpy()
            if entry.backend == "single":
                hit = self.executor.single.cache_misses == misses0
                span_args["compile"] = "cache_hit" if hit else "compile"
        wall = self.clock.now() - t0
        self.metrics_registry.histogram(
            "engine_launch_wall_seconds", "device wall per launch",
            kernel=kernel, backend=entry.backend).observe(wall)
        if is_vec:
            # visit counts arrive per served vertex; fold them back to
            # original ids and into the registry's EWMA hotness estimate
            # (the telemetry refresh_hotness folds into the layout)
            self.registry.note_visits(entry.graph_id,
                                      np.asarray(visits)[entry.perm],
                                      num_queries=len(served_sources))
            # neighbor ids are served ids (-1 = unfilled beam slot; guard
            # the gather — a raw inv_perm[-1] would alias the last vertex)
            result = np.where(ids >= 0,
                              entry.inv_perm[np.maximum(ids, 0)],
                              -1).astype(np.int64)
            return result, wall
        # translate back: result for original vertex v lives at served
        # position perm[v]; component-label *values* (cc/ccsv) are served
        # ids and are canonicalized to min-original-id-per-component so
        # callers never see the internal layout (PR 4 leaked this)
        result = out[..., entry.perm]
        if kernel in LABEL_KERNELS:
            result = canonical_component_labels(result)
        return result, wall

    def _last_exchange(self, entry: GraphEntry) -> dict | None:
        """Per-run ExchangeStats delta of the launch that just returned
        (sharded placements only — the single-device path has no
        collective exchange to account)."""
        if entry.backend != "sharded":
            return None
        return self.executor.sharded.last_run_exchange

    # ---------------------------------------------------------- telemetry
    def telemetry(self) -> dict:
        return {
            "executor": self.executor.telemetry(),
            "scheduler": self.scheduler.telemetry(),
            "policy": [r.as_dict() for r in self.policy.history],
            "calibration": self.policy.calibrator.as_dict(),
            "redecisions": list(self.redecision_log),
            "mutations": {
                "mutations": self._c_mutations.value,
                "edges_added": self._c_edges_added.value,
                "edges_removed": self._c_edges_removed.value,
                "patch_reorders": self._c_patches.value,
                "layout_swaps": self._c_swaps.value,
                "layout_swaps_discarded": self._c_swaps_discarded.value,
                "pending_swaps": self._swap_pending_ids(),
            },
            "graphs": {
                gid: {
                    "scheme": e.decision.scheme if e.decision else None,
                    "generation": e.generation,
                    "backend": e.backend,
                    "hot_prefix_fraction": e.hot_prefix_fraction,
                    "bucket_shape": e.bucket_shape,
                    "device_bytes": (e.handle.device_bytes
                                     if e.handle else None),
                    "probes": dataclasses.asdict(e.probes),
                    "reorder_seconds": e.reorder_seconds,
                    "expected_queries": e.expected_queries,
                    "queries_observed": e.queries_observed,
                    "redecisions": e.redecisions,
                    "mutations": e.mutations,
                    "probe_drift": round(e.probe_drift, 6),
                    "hot_prefix_len": e.hot_prefix_len,
                    "visit_queries": e.visit_queries,
                    "ledger": e.ledger.as_dict() if e.ledger else None,
                }
                for gid, e in ((g, self.registry.get(g))
                               for g in self.registry.ids())
            },
        }


def _entry_repr(entry: GraphEntry) -> str:  # debugging convenience
    d = entry.decision
    return (f"<{entry.graph_id}: V={entry.probes.num_vertices} "
            f"E={entry.probes.num_edges} scheme={d.scheme if d else '?'}>")
