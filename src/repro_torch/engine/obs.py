"""Observability plane: metrics registry, trace spans, profiling hooks.

The paper's central claim is about *where time goes* — cache-miss latency
dominating traversal execution — yet until this module the engine could
only report coarse wall-clock sums and hand-maintained counters. This is
the dependency-free telemetry substrate every other engine layer now
writes into:

* **Metrics registry** (`MetricsRegistry`) — named counters, gauges, and
  log-bucketed histograms, optionally labelled (e.g. per
  ``(graph_id, kernel)``). ``snapshot()`` returns one nested dict of
  everything; ``to_prometheus()`` renders the standard text exposition
  format so a scrape endpoint is a two-liner. The scheduler/backends'
  legacy ``telemetry()`` dicts are *views* over these instruments — the
  old shapes survive byte-for-byte, the registry is the source of truth.

* **Trace spans** (`Tracer`) — Chrome-trace-event JSON (load the exported
  file in https://ui.perfetto.dev or ``chrome://tracing``). Engine-side
  phases (flush, coalesce, translate, launch, device_sync, per-step
  sharded ``exchange``, reorder, redecide) land on the engine track;
  each request gets its own track carrying ``enqueue`` → ``queue_wait``
  → ``serve``, tied together by the ``trace_id`` every `QueryFuture`
  carries. Events are buffered (bounded, drop-oldest-never: excess
  events are counted in ``dropped``) and exported on demand.

* **Profiling hooks** (`ProfilerHook`) — an optional ``torch.profiler``
  integration enabled per-session: ``start()``/``stop()`` bracket a
  device-level trace (CPU and, where present, CUDA activity) into a log
  dir, and ``step(name)`` wraps each launch in a ``record_function``
  range so engine launches line up with kernel events in the profiler
  UI. Fully inert when no log dir is configured.

* **Clocks** (`Clock` / `ManualClock`) — the single injectable monotonic
  time source. The session owns one and the scheduler/tracer read it,
  so deadline and latency tests advance a `ManualClock` instead of
  sleeping.

docs/observability.md has the metric catalog and the span taxonomy.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import json
import math
import pathlib
import time


# ------------------------------------------------------------------- clocks
class Clock:
    """Injectable monotonic clock — the engine's single time source.

    Everything the session and scheduler time (queue waits, launch walls,
    deadlines, trace timestamps) reads ``now()`` so tests can substitute
    `ManualClock` and assert latency math deterministically.
    """

    def now(self) -> float:
        return time.perf_counter()


class ManualClock(Clock):
    """Deterministic clock for tests: time moves only via ``advance``."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)

    def now(self) -> float:
        return self._now

    def advance(self, seconds: float) -> float:
        if seconds < 0:
            raise ValueError("time is monotonic; cannot advance backwards")
        self._now += seconds
        return self._now


# ------------------------------------------------------------------ buckets
def log_boundaries(lo: float = 1e-6, hi: float = 128.0,
                   factor: float = 2.0) -> tuple[float, ...]:
    """Geometric bucket boundaries ``lo, lo*f, ... >= hi`` (seconds)."""
    if lo <= 0 or factor <= 1.0:
        raise ValueError("need lo > 0 and factor > 1")
    out = [lo]
    while out[-1] < hi:
        out.append(out[-1] * factor)
    return tuple(out)


def signed_log_boundaries(lo: float = 1e-6, hi: float = 128.0,
                          factor: float = 2.0) -> tuple[float, ...]:
    """Mirrored log boundaries for signed quantities (deadline slack)."""
    pos = log_boundaries(lo, hi, factor)
    return tuple([-b for b in reversed(pos)] + [0.0] + list(pos))


# --------------------------------------------------------------- rate window
class RateWindow:
    """Sliding-window event fraction over the last ``size`` observations.

    The scheduler records one boolean per deadline-carrying request at
    serve/expiry time (missed or met); ``rate`` is the recent miss
    fraction feeding the admission shed policy — a bounded deque, so an
    old overload stops biasing the signal once healthy serves displace
    it.
    """

    def __init__(self, size: int = 64):
        if size < 1:
            raise ValueError("window size must be >= 1")
        self._events: collections.deque[bool] = collections.deque(maxlen=size)

    def record(self, event: bool) -> None:
        self._events.append(bool(event))

    @property
    def rate(self) -> float:
        if not self._events:
            return 0.0
        return sum(self._events) / len(self._events)

    def __len__(self) -> int:
        return len(self._events)


# -------------------------------------------------------------- instruments
class Counter:
    """Monotonically increasing count."""

    kind = "counter"

    def __init__(self, name: str, labels: dict | None = None):
        self.name = name
        self.labels = dict(labels or {})
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """Point-in-time value (can move both ways)."""

    kind = "gauge"

    def __init__(self, name: str, labels: dict | None = None):
        self.name = name
        self.labels = dict(labels or {})
        self.value = 0

    def set(self, v) -> None:
        self.value = v

    def inc(self, n=1) -> None:
        self.value += n

    def dec(self, n=1) -> None:
        self.value -= n

    def snapshot(self):
        return self.value


class Histogram:
    """Log-bucketed distribution with streaming quantile estimates.

    ``boundaries`` are upper bucket edges; an observation lands in the
    first bucket whose edge is >= value (one implicit overflow bucket
    past the last edge). Quantiles interpolate linearly inside the
    winning bucket — coarse but monotone and dependency-free, and at the
    default factor-of-2 spacing the estimate is within 2x, which is what
    a latency SLO dashboard needs.
    """

    kind = "histogram"

    def __init__(self, name: str, labels: dict | None = None,
                 boundaries: tuple[float, ...] | None = None):
        self.name = name
        self.labels = dict(labels or {})
        self.boundaries = tuple(boundaries or log_boundaries())
        if list(self.boundaries) != sorted(self.boundaries):
            raise ValueError("histogram boundaries must be sorted")
        self.bucket_counts = [0] * (len(self.boundaries) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        value = float(value)
        self.bucket_counts[bisect.bisect_left(self.boundaries, value)] += 1
        self.count += 1
        self.sum += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (q in [0, 1]); nan when empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile {q} outside [0, 1]")
        if self.count == 0:
            return math.nan
        rank = q * (self.count - 1)
        seen = 0
        for i, c in enumerate(self.bucket_counts):
            if c == 0:
                continue
            if seen + c > rank:
                lo = (self.boundaries[i - 1] if i > 0 else
                      min(self.min, self.boundaries[0]))
                hi = (self.boundaries[i] if i < len(self.boundaries)
                      else self.max)
                lo = max(lo, self.min)
                hi = min(hi, self.max)
                if c == 1 or hi <= lo:
                    return float(hi)
                return float(lo + (hi - lo) * (rank - seen) / c)
            seen += c
        return float(self.max)

    def snapshot(self) -> dict:
        empty = self.count == 0
        return {
            "count": self.count,
            "sum": self.sum,
            "min": None if empty else self.min,
            "max": None if empty else self.max,
            "p50": None if empty else self.quantile(0.50),
            "p90": None if empty else self.quantile(0.90),
            "p99": None if empty else self.quantile(0.99),
            "boundaries": list(self.boundaries),
            "bucket_counts": list(self.bucket_counts),
        }


def merge_histogram_snapshots(snaps: list[dict]) -> dict:
    """Aggregate same-boundary histogram snapshots (e.g. the per-label
    children of one family) into one distribution snapshot."""
    snaps = [s for s in snaps if s]
    if not snaps:
        return Histogram("merged").snapshot()
    merged = Histogram("merged", boundaries=tuple(snaps[0]["boundaries"]))
    for s in snaps:
        if list(s["boundaries"]) != list(merged.boundaries):
            raise ValueError("cannot merge histograms with "
                             "different boundaries")
        merged.bucket_counts = [a + b for a, b in
                                zip(merged.bucket_counts,
                                    s["bucket_counts"])]
        merged.count += s["count"]
        merged.sum += s["sum"]
        if s["count"]:
            merged.min = min(merged.min, s["min"])
            merged.max = max(merged.max, s["max"])
    return merged.snapshot()


# ------------------------------------------------------------------ registry
def _label_key(labels: dict) -> str:
    return ",".join(f"{k}={labels[k]}" for k in sorted(labels))


class _Family:
    """All children of one metric name (one per distinct label set)."""

    def __init__(self, name: str, kind: str, help: str,
                 boundaries: tuple[float, ...] | None):
        self.name = name
        self.kind = kind
        self.help = help
        self.boundaries = boundaries
        self.children: dict[str, Counter | Gauge | Histogram] = {}

    def child(self, labels: dict):
        key = _label_key(labels)
        got = self.children.get(key)
        if got is None:
            if self.kind == "counter":
                got = Counter(self.name, labels)
            elif self.kind == "gauge":
                got = Gauge(self.name, labels)
            else:
                got = Histogram(self.name, labels, self.boundaries)
            self.children[key] = got
        return got


class MetricsRegistry:
    """Named counters / gauges / histograms with labels.

    One registry per engine session (backends built standalone own a
    private one; a session adopts its executor's so everything lands in
    a single namespace). Re-requesting an existing ``(name, labels)``
    returns the same instrument; re-requesting a name as a *different*
    kind raises — silent type drift is how metrics rot.
    """

    def __init__(self):
        self._families: dict[str, _Family] = {}

    def _family(self, name: str, kind: str, help: str,
                boundaries=None) -> _Family:
        fam = self._families.get(name)
        if fam is None:
            fam = _Family(name, kind, help, boundaries)
            self._families[name] = fam
        elif fam.kind != kind:
            raise ValueError(f"metric {name!r} already registered as "
                             f"{fam.kind}, not {kind}")
        return fam

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._family(name, "counter", help).child(labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._family(name, "gauge", help).child(labels)

    def histogram(self, name: str, help: str = "", boundaries=None,
                  **labels) -> Histogram:
        return self._family(name, "histogram", help,
                            tuple(boundaries) if boundaries else None
                            ).child(labels)

    def family(self, name: str) -> dict:
        """label-key -> instrument for one metric name ({} if absent)."""
        fam = self._families.get(name)
        return dict(fam.children) if fam else {}

    # ------------------------------------------------------------- export
    def snapshot(self) -> dict:
        """Everything, as one nested plain dict (JSON-safe).

        Shape: ``{"counters"|"gauges"|"histograms": {name: value-or-
        {label_key: value}}}`` — unlabelled instruments collapse to their
        bare value; labelled families keep one entry per label set.
        """
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        section = {"counter": "counters", "gauge": "gauges",
                   "histogram": "histograms"}
        for name, fam in sorted(self._families.items()):
            vals = {k: c.snapshot() for k, c in sorted(fam.children.items())}
            if list(vals) == [""]:      # unlabelled: collapse
                vals = vals[""]
            out[section[fam.kind]][name] = vals
        return out

    def to_prometheus(self) -> str:
        """Standard Prometheus text exposition format."""
        lines = []
        for name, fam in sorted(self._families.items()):
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for _, child in sorted(fam.children.items()):
                lbl = ",".join(f'{k}="{v}"' for k, v in
                               sorted(child.labels.items()))
                if fam.kind != "histogram":
                    lines.append(f"{name}{{{lbl}}} {child.value}" if lbl
                                 else f"{name} {child.value}")
                    continue
                cum = 0
                for edge, c in zip(child.boundaries, child.bucket_counts):
                    cum += c
                    le = f'le="{edge}"'
                    full = f"{lbl},{le}" if lbl else le
                    lines.append(f"{name}_bucket{{{full}}} {cum}")
                inf = f'le="+Inf"'
                full = f"{lbl},{inf}" if lbl else inf
                lines.append(f"{name}_bucket{{{full}}} {child.count}")
                suffix = f"{{{lbl}}}" if lbl else ""
                lines.append(f"{name}_sum{suffix} {child.sum}")
                lines.append(f"{name}_count{suffix} {child.count}")
        return "\n".join(lines) + "\n"


# -------------------------------------------------------------------- tracer
ENGINE_TID = 0          # engine-side phases: flush/launch/reorder/exchange
REQUEST_TID_BASE = 1000  # each request's lifecycle gets its own track


class Tracer:
    """Chrome-trace-event collector (Perfetto/chrome://tracing loadable).

    Timestamps come from the injected clock and are exported in
    microseconds relative to tracer construction. ``span`` is the
    primary API — a context manager emitting one complete ("X") event
    whose ``args`` dict the caller may still mutate inside the block
    (e.g. to mark a launch as compile vs cache hit once known). ``emit``
    takes explicit start/end times for spans whose lifetime doesn't
    match a Python block (queue waits, per-step exchanges).
    """

    def __init__(self, clock: Clock | None = None,
                 max_events: int = 200_000, pid: int = 1):
        self.clock = clock or Clock()
        self.max_events = max_events
        self.pid = pid
        self.events: list[dict] = []
        self.dropped = 0
        self._t0 = self.clock.now()
        self._thread_names: dict[int, str] = {}
        self.set_thread_name(ENGINE_TID, "engine")

    # ------------------------------------------------------------ plumbing
    def _ts(self, t: float) -> float:
        return round((t - self._t0) * 1e6, 3)

    def _push(self, event: dict) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(event)

    def set_thread_name(self, tid: int, name: str) -> None:
        self._thread_names[tid] = name

    # ------------------------------------------------------------- emitters
    @contextlib.contextmanager
    def span(self, name: str, tid: int = ENGINE_TID, **args):
        """Complete event covering the ``with`` block; yields the args
        dict so facts discovered inside the block can be attached."""
        start = self.clock.now()
        try:
            yield args
        finally:
            self.emit(name, start, self.clock.now(), tid=tid, args=args)

    def emit(self, name: str, start: float, end: float,
             tid: int = ENGINE_TID, args: dict | None = None) -> None:
        """Complete event with explicit clock times (seconds)."""
        self._push({
            "name": name, "ph": "X", "pid": self.pid, "tid": tid,
            "ts": self._ts(start),
            "dur": max(round((end - start) * 1e6, 3), 0.0),
            "args": dict(args or {}),
        })

    def instant(self, name: str, tid: int = ENGINE_TID, **args) -> None:
        self._push({
            "name": name, "ph": "i", "s": "t", "pid": self.pid,
            "tid": tid, "ts": self._ts(self.clock.now()),
            "args": dict(args),
        })

    # -------------------------------------------------------------- export
    def to_chrome(self) -> dict:
        meta = [{"name": "thread_name", "ph": "M", "pid": self.pid,
                 "tid": tid, "args": {"name": name}}
                for tid, name in sorted(self._thread_names.items())]
        return {"traceEvents": meta + list(self.events),
                "displayTimeUnit": "ms",
                "otherData": {"dropped_events": self.dropped}}

    def export(self, path) -> pathlib.Path:
        """Write the Chrome trace JSON; open it in ui.perfetto.dev."""
        p = pathlib.Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(json.dumps(self.to_chrome()))
        return p


def validate_chrome_trace(trace: dict) -> dict:
    """Structural validation of an exported trace (tests + CI smoke).

    Checks the Chrome-trace envelope, event field types, and that the
    complete ("X") events on every thread are *properly nested*: sorted
    by start time, each event either contains or is disjoint from the
    next — the invariant Perfetto's track builder relies on. Returns
    summary stats (event/track counts, span names).
    """
    assert isinstance(trace, dict) and "traceEvents" in trace, \
        "not a Chrome trace object"
    by_tid: dict[int, list[dict]] = {}
    names = set()
    for ev in trace["traceEvents"]:
        assert isinstance(ev.get("name"), str) and "ph" in ev, ev
        if ev["ph"] != "X":
            continue
        assert isinstance(ev["ts"], (int, float)), ev
        assert isinstance(ev["dur"], (int, float)) and ev["dur"] >= 0, ev
        names.add(ev["name"])
        by_tid.setdefault(ev["tid"], []).append(ev)
    for tid, evs in by_tid.items():
        evs.sort(key=lambda e: (e["ts"], -e["dur"]))
        stack: list[tuple[float, float]] = []
        for ev in evs:
            s, e = ev["ts"], ev["ts"] + ev["dur"]
            while stack and s >= stack[-1][1] - 1e-2:
                stack.pop()
            # 0.01 µs slop both ways: ts/dur are rounded independently
            # on export, so adjacent spans sharing a clock instant
            # (queue_wait end == serve start) may overlap by < 0.01 µs
            assert not stack or e <= stack[-1][1] + 1e-2, (
                f"span {ev['name']!r} on tid {tid} overlaps its "
                f"neighbour without nesting: [{s}, {e}] vs {stack[-1]}")
            stack.append((s, e))
    return {"events": len(trace["traceEvents"]),
            "complete_spans": sum(len(v) for v in by_tid.values()),
            "tracks": len(by_tid),
            "span_names": sorted(names)}


# ------------------------------------------------------------ profiler hook
class ProfilerHook:
    """Optional ``torch.profiler`` bridge, enabled by giving a log dir.

    ``start()``/``stop()`` bracket a device-level profiler trace written
    to ``log_dir`` as Chrome-trace JSON (open with ui.perfetto.dev or
    TensorBoard's profile plugin); ``step(name)`` wraps one engine launch
    in a ``record_function`` range so scheduler launches are attributable
    inside the kernel timeline. Everything is a no-op when unconfigured,
    and any profiler failure (unsupported platform, double-start) is
    recorded in ``error`` instead of failing the serving path.
    """

    def __init__(self, log_dir: str | None = None):
        self.log_dir = str(log_dir) if log_dir else None
        self.active = False
        self.error: str | None = None
        self._prof = None

    @property
    def enabled(self) -> bool:
        return self.log_dir is not None

    def start(self) -> bool:
        if not self.enabled or self.active:
            return False
        try:
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(
                activities=acts,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(
                    self.log_dir))
            self._prof.start()
            self.active = True
        except Exception as exc:  # profiling must never fail serving
            self.error = f"start_trace: {exc}"
            self._prof = None
        return self.active

    def stop(self) -> bool:
        if not self.active:
            return False
        try:
            self._prof.stop()
        except Exception as exc:
            self.error = f"stop_trace: {exc}"
        self._prof = None
        self.active = False
        return True

    def step(self, name: str, step_num: int = 0):
        """Context manager around one launch (inert unless active)."""
        if not self.active:
            return contextlib.nullcontext()
        try:
            import torch
            return torch.profiler.record_function(f"{name}#{step_num}")
        except Exception as exc:
            self.error = f"step: {exc}"
            return contextlib.nullcontext()


__all__ = [
    "Clock", "Counter", "ENGINE_TID", "Gauge", "Histogram", "ManualClock",
    "MetricsRegistry", "ProfilerHook", "REQUEST_TID_BASE", "RateWindow",
    "Tracer",
    "log_boundaries", "merge_histogram_snapshots", "signed_log_boundaries",
    "validate_chrome_trace",
]
