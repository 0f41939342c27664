"""Request plane: futures + micro-batch scheduling over the serving engine.

The paper's economic argument is *amortization* — a reorder pays off only
across many traversals — yet a blocking one-caller ``submit`` launches one
device program per call, so concurrent traffic can never share a vmapped
launch and the policy never observes real batch shapes. This module turns
the front door into an **always-on** request plane:

* ``EngineSession.enqueue(...)`` returns a `QueryFuture` immediately;
  nothing touches a device until a **flush boundary**.
* `MicroBatchScheduler` queues requests per ``(graph_id, kernel)`` and, at
  ``flush()``/``drain()``:

  - **coalesces** pending multi-source requests (bfs/sssp/bc) into one
    vmapped launch whose concatenated sources fill a power-of-two
    `source_bucket`, then slices each request's rows back out of the
    ``(S, V)`` result — N requests, one device program;
  - **deduplicates** concurrent global-kernel requests (pr/cc/ccsv) into
    a single run fanned out to every waiter — the result is
    source-independent, so running it twice is pure waste;
  - drains queues in **priority / deadline order** (higher ``priority``
    first, then earlier absolute deadline, then FIFO), so a latency-bound
    request is never stuck behind a bulk scan that arrived first;
  - **round-robins across graphs** when several graphs are pending in one
    flush: launches alternate one chunk per ``(graph_id, kernel)`` stream
    per cycle (graphs rotated between flushes), so one graph's burst
    chunked by ``max_batch_sources`` cannot monopolize consecutive
    launches.

* **auto-flush** — production traffic never calls ``flush()``. A flush
  tick (`poll`) fires whenever any pending request is past its deadline
  or older than ``max_delay``; it piggy-backs on every ``enqueue`` and
  ``QueryFuture.done()`` through the session's injectable clock, and an
  optional background thread (`start_auto_flush`) covers fully idle
  callers. No request waits past ``max_delay``/its deadline without a
  launch, flush() or not.

* **admission control** — an `engine.policy.AdmissionPolicy` bounds the
  queue: at ``max_pending`` an arrival is rejected with a typed
  `AdmissionRejected` or degraded to best-effort; below the cap,
  best-effort arrivals are shed while the recent deadline-miss rate
  (`obs.RateWindow`) says the plane is already overloaded. A pending
  request read past its deadline raises a typed `DeadlineExceeded` from
  ``result()`` instead of blocking on a flush that may never come.

* **result cache** — identical rows are served from memory inside a
  flush window *and* across windows: per-source rows are cached under
  ``(graph_id, generation, kernel, source)`` with hot-prefix sources
  pinned (`engine.result_cache`, GRASP-style), so repeat-heavy traffic
  stops re-launching what it asked seconds ago. Generation bumps from
  re-decision make stale rows unreachable by key.

* **generations** — every (re-)applied policy decision bumps the graph
  entry's ``generation``; a request's sources are translated through the
  layout *at launch time* and its result translated back before the
  flush-boundary re-decision check runs, so an in-flight future is never
  served half from a layout that was just replaced. Re-decision moves
  from per-submit to per-flush: one check per graph per flush, after all
  of its pending requests were served.

* **telemetry** — every future carries per-request serving facts: the
  launch it rode, how many requests shared it, its wall share, the
  generation that served it, whether its deadline was met, how many of
  its rows came from the result cache, and (sharded placements) the
  per-run `ExchangeStats` delta from ``core/dist.py``.

* **observability** (obs.py, docs/observability.md) — every counter here
  is a view over the session's `MetricsRegistry` (the old ``telemetry()``
  dict shape is preserved as a facade), queue-wait / serve-latency /
  deadline-slack histograms are recorded per ``(graph_id, kernel)``, and
  each request carries a ``trace_id`` tying its per-request trace track
  (enqueue → queue_wait → serve) to the engine track's flush / coalesce /
  translate / launch / cache_hit spans. All timing flows through the
  session's injectable clock, so latency tests are deterministic.

``EngineSession.submit`` is reimplemented as enqueue + flush sugar, so
the blocking API is exactly one request riding a one-element batch —
bit-identical results, same id translation, same ledger accounting.
docs/scheduler.md documents the lifecycle and the migration path.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
from typing import TYPE_CHECKING

import numpy as np

from ..search.serve import query_digest
from .backends import (GLOBAL, MULTI_SOURCE, VECTOR_SOURCE, build_kernel,
                       source_bucket)
from .obs import REQUEST_TID_BASE, RateWindow, signed_log_boundaries
from .result_cache import GLOBAL_SOURCE

if TYPE_CHECKING:  # import cycle: session builds the scheduler
    from .session import EngineSession

# component-label kernels whose *values* (not just positions) are vertex
# ids and must be canonicalized back to original id space at the boundary
LABEL_KERNELS = ("cc", "ccsv")


class AdmissionRejected(RuntimeError):
    """The request plane refused an arrival (bounded queue / shed band).

    ``shed`` distinguishes the soft path (best-effort arrival shed while
    deadlines are being missed) from the hard queue cap.
    """

    def __init__(self, message: str, pending: int, limit: int,
                 shed: bool = False):
        super().__init__(message)
        self.pending = pending
        self.limit = limit
        self.shed = shed


class DeadlineExceeded(TimeoutError):
    """``result()`` was called on a request already past its deadline
    while still pending — the caller gets a typed error *now* instead of
    paying for a launch whose answer it already declared worthless."""

    def __init__(self, message: str, deadline: float, now: float):
        super().__init__(message)
        self.deadline = deadline
        self.now = now


def canonical_component_labels(labels: np.ndarray) -> np.ndarray:
    """Relabel component ids to the **minimum original vertex id** of each
    component.

    ``labels[v]`` must be a consistent per-component representative (any
    id space — the engine's served layout uses served ids). The output is
    layout-independent: bit-identical to `core.baselines.cc_baseline`
    whatever permutation the graph was served under, which is what lets
    the parity matrix demand cross-backend bit-identity for cc/ccsv.
    """
    labels = np.asarray(labels)
    n = labels.shape[-1]
    flat = labels.reshape(-1, n).astype(np.int64, copy=False)
    out = np.empty_like(flat)
    for i, row in enumerate(flat):
        rep_min = np.full(int(row.max()) + 1, n, dtype=np.int64)
        np.minimum.at(rep_min, row, np.arange(n, dtype=np.int64))
        out[i] = rep_min[row]
    return out.reshape(labels.shape)


@dataclasses.dataclass
class Request:
    """One enqueued query: what to run, how urgently, and for whom."""

    seq: int                       # FIFO tiebreak, assigned at enqueue
    graph_id: str
    kernel: str
    # original-id space for MULTI_SOURCE; (S, d) float32 query rows for
    # VECTOR_SOURCE (a knn "source" is a vector); None for GLOBAL
    sources: np.ndarray | None
    priority: int                  # higher drains first
    deadline: float | None         # absolute perf_counter() time, or None
    enqueued_at: float
    future: "QueryFuture"
    generation: int | None = None  # layout generation that served it
    trace_id: str | None = None    # ties this request's spans together
    degraded: bool = False         # admitted best-effort under overload

    @property
    def num_sources(self) -> int:
        if self.sources is None:
            return 0
        # a 2-D source batch is S query *rows*, not S x d scalars
        if self.sources.ndim == 2:
            return int(len(self.sources))
        return int(self.sources.size)

    def order_key(self) -> tuple:
        """Drain order: priority desc, earliest deadline, FIFO."""
        return (-self.priority,
                self.deadline if self.deadline is not None else float("inf"),
                self.seq)


class QueryFuture:
    """Handle to a pending (or served) request.

    ``result()`` is the blocking read: if the request has not been served
    yet it flushes the owning scheduler for this request's graph first,
    so a lone ``enqueue(...).result()`` behaves exactly like the old
    blocking ``submit`` — unless the deadline already passed, in which
    case it raises `DeadlineExceeded` instead of launching work whose
    answer is already stale. ``done()`` doubles as the auto-flush tick:
    polling a future gives the scheduler a chance to serve anything
    overdue. ``telemetry`` is populated at serve time (see
    `MicroBatchScheduler._account`).
    """

    def __init__(self, scheduler: "MicroBatchScheduler", request: Request):
        self._scheduler = scheduler
        self._result: np.ndarray | None = None
        self._exception: BaseException | None = None
        self._done = False
        self.request = request
        self.telemetry: dict = {}

    # ------------------------------------------------------------ protocol
    def done(self) -> bool:
        if not self._done:
            self._scheduler.poll()      # piggy-backed auto-flush tick
        return self._done

    def result(self) -> np.ndarray:
        if not self._done:
            req = self.request
            if (req.deadline is not None
                    and self._scheduler.session.clock.now() > req.deadline):
                self._scheduler._expire(req)
            if not self._done:
                self._scheduler.flush(req.graph_id)
        if not self._done:  # defensive: flush must have served us
            raise RuntimeError(
                f"flush did not serve request {self.request.seq} "
                f"({self.request.graph_id}/{self.request.kernel})")
        if self._exception is not None:
            raise self._exception
        return self._result

    def exception(self) -> BaseException | None:
        """The launch failure, if any (None while pending or on success)."""
        return self._exception

    @property
    def trace_id(self) -> str:
        """Id shared by every trace span of this request's lifecycle."""
        return self.request.trace_id

    # ------------------------------------------------------------ internal
    def _set_result(self, value: np.ndarray) -> None:
        self._result = value
        self._done = True

    def _set_exception(self, exc: BaseException) -> None:
        self._exception = exc
        self._done = True


class MicroBatchScheduler:
    """Per-(graph, kernel) request queues drained as micro-batches.

    One scheduler fronts one `EngineSession`; the session owns the
    registry/policy/executor and exposes the launch internals the
    scheduler drives (`EngineSession._launch` / ``_maybe_redecide``).
    ``max_batch_sources`` caps how many concatenated sources one coalesced
    launch may carry (None = coalesce everything pending into a single
    launch; the executor still pads the batch to its power-of-two
    `source_bucket`). ``max_delay`` is the auto-flush age bound (None
    disables the tick); ``admission`` an `engine.policy.AdmissionPolicy`
    (None admits everything). A single re-entrant lock serializes
    enqueue/flush/poll so the optional background flusher and the caller
    thread compose.
    """

    def __init__(self, session: "EngineSession",
                 max_batch_sources: int | None = None,
                 max_delay: float | None = 0.25,
                 admission=None):
        if max_batch_sources is not None and max_batch_sources < 1:
            raise ValueError("max_batch_sources must be >= 1 or None")
        if max_delay is not None and max_delay < 0:
            raise ValueError("max_delay must be >= 0 or None")
        self.session = session
        self.max_batch_sources = max_batch_sources
        self.max_delay = max_delay
        self.admission = admission
        self._queues: dict[tuple[str, str], list[Request]] = {}
        self._seq = itertools.count()
        self._lock = threading.RLock()
        self._rr_cursor = 0          # rotates which graph leads a flush
        self._miss_window = RateWindow(
            admission.miss_window if admission is not None else 64)
        self._flusher: threading.Thread | None = None
        self._flusher_stop: threading.Event | None = None
        self.auto_flush_error: BaseException | None = None
        # counters live in the session's metrics registry; the public
        # attributes below (and telemetry()) are read-through views, so
        # the pre-obs shapes survive while the registry is the one truth
        m = session.metrics_registry
        self._c_enqueued = m.counter(
            "engine_requests_enqueued_total", "requests accepted by enqueue")
        self._c_served = m.counter(
            "engine_requests_served_total", "futures resolved with a result")
        self._c_failed = m.counter(
            "engine_requests_failed_total", "futures resolved with an error")
        self._c_launches = m.counter(
            "engine_launches_total", "device launches issued")
        self._c_launches_failed = m.counter(
            "engine_launches_failed_total", "device launches that raised")
        self._c_coalesced = m.counter(
            "engine_coalesced_requests_total", "requests that shared a launch")
        self._c_dedup = m.counter(
            "engine_dedup_hits_total", "global requests served without a run")
        self._c_flushes = m.counter("engine_flushes_total", "flush boundaries")
        self._c_deadlines = m.counter(
            "engine_deadlines_missed_total", "requests served past deadline")
        self._c_auto = m.counter(
            "engine_auto_flushes_total",
            "flush boundaries triggered by the max-delay/deadline tick")
        self._c_expired = m.counter(
            "engine_requests_expired_total",
            "pending requests failed with DeadlineExceeded at result()")
        self._c_adm_rejected = m.counter(
            "engine_admission_rejected_total",
            "arrivals rejected at the pending-queue cap")
        self._c_adm_degraded = m.counter(
            "engine_admission_degraded_total",
            "arrivals demoted to best-effort at the pending-queue cap")
        self._c_adm_shed = m.counter(
            "engine_admission_shed_total",
            "best-effort arrivals shed while deadlines were being missed")
        self._g_pending = m.gauge(
            "engine_pending_requests", "requests enqueued but not served")
        self._metrics = m

    # --------------------------------------------- registry-backed counters
    @property
    def requests_enqueued(self) -> int:
        return self._c_enqueued.value

    @property
    def requests_served(self) -> int:
        return self._c_served.value

    @property
    def requests_failed(self) -> int:
        return self._c_failed.value

    @property
    def launches(self) -> int:
        return self._c_launches.value

    @property
    def launches_failed(self) -> int:
        return self._c_launches_failed.value

    @property
    def coalesced_requests(self) -> int:
        return self._c_coalesced.value

    @property
    def dedup_hits(self) -> int:
        return self._c_dedup.value

    @property
    def flushes(self) -> int:
        return self._c_flushes.value

    @property
    def deadlines_missed(self) -> int:
        return self._c_deadlines.value

    @property
    def auto_flushes(self) -> int:
        return self._c_auto.value

    @property
    def requests_expired(self) -> int:
        return self._c_expired.value

    @property
    def admission_rejected(self) -> int:
        return self._c_adm_rejected.value

    @property
    def admission_degraded(self) -> int:
        return self._c_adm_degraded.value

    @property
    def admission_shed(self) -> int:
        return self._c_adm_shed.value

    # ------------------------------------------------------------- enqueue
    def enqueue(self, graph_id: str, kernel: str, sources=None,
                priority: int = 0,
                deadline_seconds: float | None = None) -> QueryFuture:
        """Queue one request; returns its future. Validation is eager —
        unknown kernel/graph and empty source batches raise *here*, not at
        flush time where they would poison a coalesced batch. Admission
        control also runs here: an overloaded plane rejects/degrades/sheds
        before the request ever holds queue memory."""
        build_kernel(kernel)                    # ValueError on unknown
        entry = self.session.registry.get(graph_id)  # KeyError on unknown
        srcs = None
        if kernel in MULTI_SOURCE:
            srcs = np.atleast_1d(np.asarray(sources, dtype=np.int64))
            if srcs.size == 0:
                raise ValueError(f"{kernel} needs at least one source")
            n = entry.graph.num_vertices
            if int(srcs.min()) < 0 or int(srcs.max()) >= n:
                # out-of-range ids must fail *this* caller now — at launch
                # time they would poison every request coalesced alongside
                raise ValueError(
                    f"{kernel} sources must be in [0, {n}); got "
                    f"[{int(srcs.min())}, {int(srcs.max())}]")
        elif kernel in VECTOR_SOURCE:
            if entry.vectors is None:
                raise ValueError(
                    f"graph {graph_id!r} was registered without vectors=; "
                    f"{kernel} queries need a vector corpus")
            srcs = np.atleast_2d(np.asarray(sources, dtype=np.float32))
            if srcs.size == 0:
                raise ValueError(f"{kernel} needs at least one query vector")
            dim = int(entry.vectors.shape[1])
            if srcs.ndim != 2 or srcs.shape[1] != dim:
                raise ValueError(
                    f"{kernel} queries must be (S, {dim}) float32 rows "
                    f"matching the registered corpus, got shape "
                    f"{srcs.shape}")
        with self._lock:
            priority, deadline_seconds, degraded = self._admit(
                graph_id, kernel, priority, deadline_seconds)
            now = self.session.clock.now()
            seq = next(self._seq)
            req = Request(
                seq=seq, graph_id=graph_id, kernel=kernel,
                sources=srcs, priority=priority,
                deadline=(now + deadline_seconds
                          if deadline_seconds is not None else None),
                enqueued_at=now, future=None,  # type: ignore[arg-type]
                trace_id=f"req-{seq}", degraded=degraded)
            req.future = QueryFuture(self, req)
            self._queues.setdefault((graph_id, kernel), []).append(req)
            self._c_enqueued.inc()
            self._g_pending.inc()
            tracer = self.session.tracer
            tracer.set_thread_name(REQUEST_TID_BASE + seq, req.trace_id)
            tracer.instant("enqueue", tid=REQUEST_TID_BASE + seq,
                           trace_id=req.trace_id, graph_id=graph_id,
                           kernel=kernel, priority=priority)
            self.poll()                  # piggy-backed auto-flush tick
        return req.future

    def _admit(self, graph_id: str, kernel: str, priority: int,
               deadline_seconds: float | None) -> tuple[int, float | None,
                                                        bool]:
        """Apply the admission policy to one arrival; returns the possibly
        degraded ``(priority, deadline_seconds, degraded)`` or raises
        `AdmissionRejected`."""
        adm = self.admission
        if adm is None:
            return priority, deadline_seconds, False
        pending = self.pending()
        if pending >= min(adm.max_pending, adm.soft_limit):
            # the plane looks overloaded — tick it before judging the
            # arrival, so admission sees the post-flush depth and a queue
            # full of *overdue* work can't wedge into a reject storm where
            # nothing ever drains (every rejected enqueue bails before the
            # piggy-backed poll that would have flushed it)
            self.poll()
            pending = self.pending()
        if pending >= adm.max_pending:
            if adm.overload == "degrade":
                self._c_adm_degraded.inc()
                return min(priority, adm.degraded_priority), None, True
            self._c_adm_rejected.inc()
            raise AdmissionRejected(
                f"queue full: {pending} pending >= max_pending="
                f"{adm.max_pending} ({graph_id}/{kernel})",
                pending=pending, limit=adm.max_pending)
        best_effort = deadline_seconds is None and priority <= 0
        if (best_effort and pending >= adm.soft_limit
                and len(self._miss_window) >= adm.min_miss_samples
                and self._miss_window.rate >= adm.shed_miss_rate):
            self._c_adm_shed.inc()
            raise AdmissionRejected(
                f"shedding best-effort arrival: {pending} pending >= "
                f"soft_limit={adm.soft_limit} with recent deadline-miss "
                f"rate {self._miss_window.rate:.2f} ({graph_id}/{kernel})",
                pending=pending, limit=adm.soft_limit, shed=True)
        return priority, deadline_seconds, False

    def pending(self, graph_id: str | None = None) -> int:
        return sum(len(reqs) for (gid, _), reqs in self._queues.items()
                   if graph_id is None or gid == graph_id)

    # ---------------------------------------------------------- auto-flush
    def poll(self) -> int:
        """The auto-flush tick: flush every graph holding an *overdue*
        request — older than ``max_delay`` or past its deadline. Cheap
        when nothing is overdue (one pass over the pending queues);
        piggy-backed on ``enqueue``/``done()`` and driven by the optional
        background thread, so the plane serves traffic even when no one
        ever calls ``flush()``."""
        with self._lock:
            now = self.session.clock.now()
            due: list[str] = []
            for (gid, _), reqs in self._queues.items():
                if gid in due:
                    continue
                for r in reqs:
                    if ((r.deadline is not None and now >= r.deadline)
                            or (self.max_delay is not None
                                and now - r.enqueued_at >= self.max_delay)):
                        due.append(gid)
                        break
            if not due:
                return 0
            self._c_auto.inc()
            return self._flush_graphs(due)

    def start_auto_flush(self, interval: float | None = None
                         ) -> threading.Thread:
        """Run ``poll()`` from a daemon thread every ``interval`` seconds
        (default ``max_delay / 2``) so fully idle callers still get their
        overdue requests served. Idempotent; `stop_auto_flush` (or
        ``EngineSession.close``) tears it down."""
        with self._lock:
            if self._flusher is not None:
                return self._flusher
            if interval is None:
                interval = (self.max_delay / 2 if self.max_delay else 0.05)
            interval = max(float(interval), 1e-3)
            stop = threading.Event()

            def _loop():
                while not stop.wait(interval):
                    try:
                        self.poll()
                    except Exception as exc:   # futures already carry it
                        self.auto_flush_error = exc
            t = threading.Thread(target=_loop, name="engine-auto-flush",
                                 daemon=True)
            self._flusher, self._flusher_stop = t, stop
            t.start()
            return t

    def stop_auto_flush(self) -> None:
        with self._lock:
            t, stop = self._flusher, self._flusher_stop
            self._flusher = self._flusher_stop = None
        if t is not None:
            stop.set()
            t.join(timeout=5.0)

    # --------------------------------------------------------------- flush
    def flush(self, graph_id: str | None = None) -> int:
        """Serve everything currently pending (for one graph, or all).

        Queues drain in priority/deadline order within each stream, with
        launches round-robined across streams; each graph gets exactly
        one re-decision check *after* all of its pending requests were
        served — the flush boundary — so no in-flight future straddles a
        layout replacement. Graphs holding a completed async full-reorder
        (`EngineSession.update_graph`) join the flush set even with no
        pending requests, so the flush boundary can swap their layout in.
        """
        with self._lock:
            graphs: list[str] = []
            for (gid, _), reqs in self._queues.items():
                if reqs and (graph_id is None or gid == graph_id):
                    if gid not in graphs:
                        graphs.append(gid)
            for gid in self.session._swap_pending_ids():
                if (graph_id is None or gid == graph_id) and gid not in graphs:
                    graphs.append(gid)
            return self._flush_graphs(graphs)

    def drain(self) -> int:
        """Flush until no request is pending anywhere (lifecycle close).
        A final flush applies any still-pending layout swaps."""
        served = 0
        with self._lock:
            while self.pending():
                served += self.flush()
            if self.session._swap_pending_ids():
                served += self.flush()
        return served

    @contextlib.contextmanager
    def fence(self, graph_id: str):
        """Mutation fence: serve every in-flight request of ``graph_id``
        under its current (pre-mutation) generation, then hold the
        plane's lock while the caller mutates — enqueues from other
        threads block until the mutation completes, so no future ever
        straddles a mutation. Re-entrant (the lock is an RLock), so a
        fenced mutation may itself flush or apply decisions."""
        with self._lock:
            self.flush(graph_id)
            yield

    def _expire(self, req: Request) -> None:
        """Fail one still-pending request with `DeadlineExceeded` (called
        from ``result()`` once the deadline has passed). No-op if a
        concurrent flush already took it."""
        with self._lock:
            q = self._queues.get((req.graph_id, req.kernel))
            if q is None or req not in q:
                return        # already being served; result() re-checks
            q.remove(req)
            now = self.session.clock.now()
            self._c_deadlines.inc()
            self._c_expired.inc()
            self._c_failed.inc()
            self._g_pending.dec()
            self._miss_window.record(True)
            self.session.tracer.instant(
                "expired", tid=REQUEST_TID_BASE + req.seq,
                trace_id=req.trace_id, graph_id=req.graph_id,
                kernel=req.kernel)
            req.future._set_exception(DeadlineExceeded(
                f"request {req.seq} ({req.graph_id}/{req.kernel}) missed "
                f"its deadline by {now - req.deadline:.4f}s before any "
                "flush served it", deadline=req.deadline, now=now))

    # ------------------------------------------------------ flush internals
    def _take_queues(self, graph_id: str) -> list[tuple[str, list[Request]]]:
        """Pop this graph's non-empty queues, ordered by their most urgent
        request (so a high-priority sssp drains before a bulk bfs)."""
        taken = []
        for (gid, kernel), reqs in list(self._queues.items()):
            if gid == graph_id and reqs:
                taken.append((kernel, reqs))
                del self._queues[(gid, kernel)]
        taken.sort(key=lambda kv: min(r.order_key() for r in kv[1]))
        return taken

    def _flush_graphs(self, graphs: list[str]) -> int:
        """One flush boundary over ``graphs``: take every stream, then
        round-robin launches one chunk per ``(graph_id, kernel)`` stream
        per cycle. The graph order rotates between flushes (`_rr_cursor`),
        so with `max_batch_sources` chunking no graph's burst can
        monopolize consecutive launches across flushes either."""
        session = self.session
        self._c_flushes.inc()
        if not graphs:
            return 0
        if len(graphs) > 1:
            lead = self._rr_cursor % len(graphs)
            graphs = graphs[lead:] + graphs[:lead]
        self._rr_cursor += 1
        # streams: [graph_id, kernel, entry, chunk list] in fair-drain order
        entries = {gid: session.registry.get(gid) for gid in graphs}
        streams: list[list] = []
        taken_reqs: list[Request] = []
        for gid in graphs:
            for kernel, reqs in self._take_queues(gid):
                reqs.sort(key=Request.order_key)
                taken_reqs.extend(reqs)
                chunks = ([reqs] if kernel in GLOBAL else self._chunks(reqs))
                streams.append([gid, kernel, entries[gid], chunks])
        served = 0
        try:
            with session.tracer.span("flush", graphs=len(graphs),
                                     requests=len(taken_reqs)):
                while streams:
                    survivors: list[list] = []
                    for stream in streams:
                        gid, kernel, entry, chunks = stream
                        chunk = chunks.pop(0)
                        if kernel in GLOBAL:
                            self._serve_global(entry, kernel, chunk)
                        else:
                            self._serve_multi(entry, kernel, chunk)
                        served += len(chunk)
                        if chunks:
                            survivors.append(stream)
                    streams = survivors
        except Exception as exc:
            # a failed launch must not strand the rest of the flush set:
            # every taken-but-unserved future fails with the same cause
            for r in taken_reqs:
                if not r.future._done:
                    r.future._set_exception(exc)
                    self._c_failed.inc()
                    self._g_pending.dec()
            raise
        finally:
            # requests resolved before a mid-flush failure were genuinely
            # served: keep the counter consistent with their futures
            self._c_served.inc(served)
        # flush boundary: all pending requests for these graphs are
        # answered and translated under the generation that served them —
        # only now may layouts be replaced (skipped if the flush aborted).
        # A completed async full-reorder swaps in here; a graph whose
        # layout just swapped skips the re-decision check this boundary
        for gid in graphs:
            if session._apply_pending_swap(entries[gid]):
                continue
            session._maybe_redecide(entries[gid])
        return served

    def _chunks(self, reqs: list[Request]) -> list[list[Request]]:
        """Greedy coalescing under the source cap, in drain order."""
        if self.max_batch_sources is None:
            return [reqs]
        chunks: list[list[Request]] = []
        cur: list[Request] = []
        total = 0
        for r in reqs:
            if cur and total + r.num_sources > self.max_batch_sources:
                chunks.append(cur)
                cur, total = [], 0
            cur.append(r)
            total += r.num_sources
        if cur:
            chunks.append(cur)
        return chunks

    @staticmethod
    def _source_items(kernel: str, req: Request) -> list[tuple[int, object]]:
        """Per-source ``(cache_key, launch_payload)`` pairs for one
        request. Integer sources key as themselves; a knn query row keys
        as its content digest (`search.serve.query_digest`) — what makes
        float vectors addressable by the result cache — and its payload
        is the row itself."""
        if kernel in VECTOR_SOURCE:
            return [(query_digest(row), row) for row in req.sources]
        return [(int(s), int(s)) for s in req.sources]

    def _serve_multi(self, entry, kernel: str, reqs: list[Request]) -> None:
        """One vmapped launch for the chunk's *uncached* sources; cached
        rows come from the result cache (within-window dedup falls out of
        the same lookup), per-request rows are reassembled per source."""
        session = self.session
        cache = session.result_cache
        launch_begin = session.clock.now()
        if cache is None:
            self._serve_multi_uncached(entry, kernel, reqs, launch_begin)
            return
        is_vec = kernel in VECTOR_SOURCE
        gid, gen = entry.graph_id, entry.generation
        req_items = [self._source_items(kernel, r) for r in reqs]
        rows: dict[int, np.ndarray] = {}       # cache key -> result row
        missing: list = []                     # fresh payloads, first-seen
        missing_keys: list[int] = []
        missing_set: set[int] = set()
        for items in req_items:
            for key, payload in items:
                if key in rows or key in missing_set:
                    continue
                row = cache.get(gid, gen, kernel, key)
                if row is None:
                    missing.append(payload)
                    missing_keys.append(key)
                    missing_set.add(key)
                else:
                    rows[key] = row
        wall, exchange = 0.0, None
        if missing:
            with session.tracer.span("coalesce", graph_id=gid, kernel=kernel,
                                     requests=len(reqs),
                                     cached_sources=len(rows)):
                launch_sources = (np.stack(missing).astype(np.float32)
                                  if is_vec
                                  else np.asarray(missing, dtype=np.int64))
            try:
                out, wall = session._launch(entry, kernel, launch_sources)
            except Exception as exc:
                self._fail_launch(reqs, exc)
                raise
            exchange = session._last_exchange(entry)
            session.policy.observe_batch_sources(len(missing))
            self._c_launches.inc()
            hot = entry.hot_prefix_len
            for i, key in enumerate(missing_keys):
                # copy: a slice view would pin the whole (S, V) launch
                # array for as long as any one cached row is retained
                row = out[i].copy()
                rows[key] = row
                # knn rows are keyed by content digest, not vertex id, so
                # GRASP pinning (a vertex-prefix rule) never applies
                pinned = (not is_vec and hot > 0
                          and int(entry.perm[key]) < hot)
                cache.put(gid, gen, kernel, key, row, pinned=pinned)
        else:
            # every row came from memory — the whole chunk serves with no
            # device work at all; make that visible on the engine track
            with session.tracer.span("cache_hit", graph_id=gid,
                                     kernel=kernel, requests=len(reqs),
                                     sources=len(rows)):
                pass
        if len(reqs) > 1:
            self._c_coalesced.inc(len(reqs))
        # launch wall is shared pro-rata over freshly launched rows only:
        # a fully cached request costs (and is charged) ~nothing
        fresh = [sum(1 for key, _ in items if key in missing_set)
                 for items in req_items]
        fresh_total = sum(fresh) or 1
        with session.tracer.span("slice_out", graph_id=gid, kernel=kernel,
                                 requests=len(reqs)):
            for r, items, n_fresh in zip(reqs, req_items, fresh):
                out_rows = np.stack([rows[key] for key, _ in items])
                self._account(entry, r, out_rows, wall,
                              wall * (n_fresh / fresh_total), len(reqs),
                              len(missing), exchange, launch_begin,
                              cache_hits=r.num_sources - n_fresh,
                              from_cache=not missing)

    def _serve_multi_uncached(self, entry, kernel: str, reqs: list[Request],
                              launch_begin: float) -> None:
        """Cache-off path: pure coalescing, byte-identical to the PR 5
        plane (duplicate sources ride the launch)."""
        session = self.session
        with session.tracer.span("coalesce", graph_id=entry.graph_id,
                                 kernel=kernel, requests=len(reqs)):
            all_sources = np.concatenate([r.sources for r in reqs])
        try:
            out, wall = session._launch(entry, kernel, all_sources)
        except Exception as exc:
            self._fail_launch(reqs, exc)
            raise
        exchange = session._last_exchange(entry)
        total = int(len(all_sources))   # rows for (S, d) vector batches
        session.policy.observe_batch_sources(total)
        self._c_launches.inc()
        if len(reqs) > 1:
            self._c_coalesced.inc(len(reqs))
        offset = 0
        with session.tracer.span("slice_out", graph_id=entry.graph_id,
                                 kernel=kernel, requests=len(reqs)):
            for r in reqs:
                # copy: a slice view would pin the whole (S_total, V) launch
                # array for as long as any one future's result is retained
                rows = out[offset:offset + r.num_sources].copy()
                offset += r.num_sources
                share = wall * (r.num_sources / max(total, 1))
                self._account(entry, r, rows, wall, share, len(reqs), total,
                              exchange, launch_begin)

    def _serve_global(self, entry, kernel: str, reqs: list[Request]) -> None:
        """One run, fanned out to every waiter (the result is
        source-independent, so concurrent requests are duplicates) — and
        served straight from the result cache across flush windows."""
        session = self.session
        cache = session.result_cache
        launch_begin = session.clock.now()
        gid, gen = entry.graph_id, entry.generation
        out = (cache.get(gid, gen, kernel, GLOBAL_SOURCE)
               if cache is not None else None)
        from_cache = out is not None
        wall, exchange = 0.0, None
        if out is None:
            try:
                out, wall = session._launch(entry, kernel, None)
            except Exception as exc:
                self._fail_launch(reqs, exc)
                raise
            exchange = session._last_exchange(entry)
            self._c_launches.inc()
            if cache is not None:
                # global results are one row per graph and every request
                # wants it: always worth pinning
                cache.put(gid, gen, kernel, GLOBAL_SOURCE, out, pinned=True)
            if len(reqs) > 1:
                self._c_dedup.inc(len(reqs) - 1)
        else:
            with session.tracer.span("cache_hit", graph_id=gid,
                                     kernel=kernel, requests=len(reqs)):
                pass
            self._c_dedup.inc(len(reqs))
        if len(reqs) > 1:
            self._c_coalesced.inc(len(reqs))
        for r in reqs:
            self._account(entry, r, out, wall, wall / len(reqs), len(reqs),
                          0, exchange, launch_begin,
                          cache_hits=1 if from_cache else 0,
                          from_cache=from_cache)

    def _fail_launch(self, reqs: list[Request], exc: BaseException) -> None:
        """One launch raised: fail its riders, count the outcome."""
        self._c_launches_failed.inc()
        for r in reqs:
            r.future._set_exception(exc)
            self._c_failed.inc()
            self._g_pending.dec()

    def _account(self, entry, req: Request, result: np.ndarray, wall: float,
                 wall_share: float, sharing: int, batch_sources: int,
                 exchange: dict | None, launch_begin: float,
                 cache_hits: int = 0, from_cache: bool = False) -> None:
        """Resolve one future: ledger, realized-volume, telemetry,
        latency histograms, and the request's trace track."""
        session = self.session
        req.generation = entry.generation
        entry.ledger.record_query(req.num_sources, wall_share)
        session.registry.note_queries(entry.graph_id)
        served_at = session.clock.now()
        missed = req.deadline is not None and served_at > req.deadline
        if missed:
            self._c_deadlines.inc()
        if req.deadline is not None:
            self._miss_window.record(missed)
        labels = {"graph_id": req.graph_id, "kernel": req.kernel}
        queue_wait = launch_begin - req.enqueued_at
        serve_latency = served_at - req.enqueued_at
        m = self._metrics
        m.histogram("engine_queue_wait_seconds",
                    "enqueue -> launch start", **labels).observe(queue_wait)
        m.histogram("engine_serve_seconds",
                    "enqueue -> result resolved (end-to-end)",
                    **labels).observe(serve_latency)
        if req.deadline is not None:
            # slack > 0: met with room; < 0: by how much it was missed —
            # the attributable version of the deadlines_missed counter
            m.histogram("engine_deadline_slack_seconds",
                        "deadline - served_at (negative = missed by)",
                        boundaries=signed_log_boundaries(),
                        **labels).observe(req.deadline - served_at)
        tid = REQUEST_TID_BASE + req.seq
        tracer = session.tracer
        span_args = {"trace_id": req.trace_id, **labels}
        tracer.emit("queue_wait", req.enqueued_at, launch_begin, tid=tid,
                    args=span_args)
        tracer.emit("serve", launch_begin, served_at, tid=tid,
                    args={**span_args, "coalesced_with": sharing - 1,
                          "deadline_missed": missed,
                          "served_from_cache": from_cache})
        self._g_pending.dec()
        req.future.telemetry = {
            "kernel": req.kernel,
            "graph_id": req.graph_id,
            "priority": req.priority,
            "generation": req.generation,
            "launch_index": self.launches,  # 1-based, in launch order
            "launch_wall_seconds": wall,
            "wall_share_seconds": wall_share,
            "coalesced_with": sharing - 1,
            "launch_batch_sources": batch_sources,
            "queue_seconds": serve_latency,
            "deadline_missed": missed,
            "cache_hit_sources": cache_hits,
            "served_from_cache": from_cache,
            "degraded": req.degraded,
            "exchange": exchange,
            "trace_id": req.trace_id,
        }
        req.future._set_result(result)

    # ----------------------------------------------------------- telemetry
    def telemetry(self) -> dict:
        """Pre-obs dict shape (a view over the metrics registry) plus the
        launch/request failure, auto-flush, admission, and result-cache
        counters."""
        cache = self.session.result_cache
        return {
            "requests_enqueued": self.requests_enqueued,
            "requests_served": self.requests_served,
            "pending": self.pending(),
            "launches": self.launches,
            "coalesced_requests": self.coalesced_requests,
            "dedup_hits": self.dedup_hits,
            "flushes": self.flushes,
            "deadlines_missed": self.deadlines_missed,
            "launches_failed": self.launches_failed,
            "requests_failed": self.requests_failed,
            "max_batch_sources": self.max_batch_sources,
            "max_delay": self.max_delay,
            "auto_flushes": self.auto_flushes,
            "requests_expired": self.requests_expired,
            "admission": (self.admission.as_dict()
                          if self.admission is not None else None),
            "admission_rejected": self.admission_rejected,
            "admission_degraded": self.admission_degraded,
            "admission_shed": self.admission_shed,
            "deadline_miss_rate": round(self._miss_window.rate, 4),
            "result_cache": cache.stats() if cache is not None else None,
        }


__all__ = ["AdmissionRejected", "DeadlineExceeded", "LABEL_KERNELS",
           "MicroBatchScheduler", "QueryFuture", "Request",
           "canonical_component_labels", "source_bucket"]
