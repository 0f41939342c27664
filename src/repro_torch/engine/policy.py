"""Adaptive reorder policy: probes + expected query volume -> scheme.

The paper's result (section 5) is a trade-off, not a recommendation:
reordering buys per-traversal speedup proportional to degree skew, at a
one-time cost that only amortizes over enough traversals (Faldu et al.
make the same point for the lightweight schemes). The policy encodes that
trade-off:

* **volume gate** — below ``min_queries`` expected traversals nothing can
  amortize, serve the original layout;
* **skew gate** — low degree Gini (meshes, roads, rings) means no hub
  working set to pack; reordering moves nothing, serve original;
* **cheap tier** — skewed graph but modest volume: a single O(V) pass
  (HubCluster below ``dbg_gini``, DBG above) captures most of the win;
* **expensive tier** — skewed graph and high volume: LOrder with
  κ = ⌈D/2⌉ derived from the registry's diameter probe (paper Table 5.2).

Every decision carries a *predicted* fractional miss-rate reduction,
``skew x strength[scheme]``. The strengths are **calibrated, not
static**: the session records the *realized* reduction from the cache
simulator into a ``StrengthCalibrator`` (see calibration.py), and later
decisions consult the fitted strengths. Once a scheme has enough
observations, a tier's default choice can be overridden by a candidate
whose fitted predicted gain is higher by ``override_margin`` — so a
scheme that consistently mispredicts loses decisions to the one that
actually delivers (the top Engine item in ROADMAP.md).
"""
from __future__ import annotations

import dataclasses

from ..core.baselines import reordering_registry
from .backends import bucket_dims, estimate_device_bytes
from .calibration import DEFAULT_PRIORS, StrengthCalibrator
from .registry import GraphProbes

# Backwards-compatible alias: PR 1 exposed the static strengths here.
# They are now the *priors* of the calibration model (calibration.py).
_SCHEME_STRENGTH = DEFAULT_PRIORS


@dataclasses.dataclass(frozen=True)
class PolicyDecision:
    scheme: str              # key into reordering_registry(), or "visitsort"
    kwargs: dict             # scheme arguments (e.g. probe-derived kappa)
    reason: str              # human-readable rule that fired
    predicted_gain: float    # predicted fractional miss-rate reduction
    skew: float = 0.0        # probe composite the prediction was based on
    backend: str = "single"  # placement: engine.backends name
    # sharded placement only: fraction of each shard's property slice
    # all-gathered every step (None = full exchange every step)
    hot_prefix_fraction: float | None = None
    # what "hot" means for this layout: "degree" (structural probes) or
    # "visits" (serving telemetry, the search-family signal) — determines
    # which skew axis the prediction used and how the hot prefix is kept
    # fresh (session.refresh_hotness patches by visit mask)
    hotness_source: str = "degree"


def decision_changed(old: PolicyDecision | None,
                     new: PolicyDecision | None) -> bool:
    """Whether a fresh decision is materially different from the applied
    one — i.e. whether a mutation warrants an async full reorder. Reasons
    and predicted gains differ on every re-decide; what matters is the
    layout recipe: scheme, its kwargs, placement, exchange fraction, and
    which hotness axis the layout is ordered by.
    """
    if old is None or new is None:
        return old is not new
    return (old.scheme != new.scheme
            or old.kwargs != new.kwargs
            or old.backend != new.backend
            or old.hot_prefix_fraction != new.hot_prefix_fraction
            or old.hotness_source != new.hotness_source)


@dataclasses.dataclass(frozen=True)
class AdmissionPolicy:
    """Backpressure contract for the request plane (scheduler.py).

    ``max_pending`` bounds the queue: at the cap an arrival is either
    rejected with `scheduler.AdmissionRejected` (``overload="reject"``)
    or *degraded* — admitted as best-effort with its priority clamped to
    ``degraded_priority`` and its deadline dropped (``"degrade"``).
    Below the cap a *shed* band starts at ``soft_fraction`` of it: when
    the queue is that deep AND the recent deadline-miss rate (a
    `RateWindow` over the last ``miss_window`` deadline outcomes, armed
    after ``min_miss_samples``) is at least ``shed_miss_rate``, new
    best-effort arrivals (no deadline, priority <= 0) are shed so the
    latency-sensitive traffic that is already missing deadlines stops
    queueing behind them.
    """

    max_pending: int = 1024
    overload: str = "reject"      # "reject" | "degrade"
    soft_fraction: float = 0.5
    shed_miss_rate: float = 0.5
    miss_window: int = 64
    min_miss_samples: int = 8
    degraded_priority: int = -1

    def __post_init__(self):
        if self.max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        if self.overload not in ("reject", "degrade"):
            raise ValueError("overload must be 'reject' or 'degrade'")
        if not 0.0 <= self.soft_fraction <= 1.0:
            raise ValueError("soft_fraction must be in [0, 1]")
        if not 0.0 <= self.shed_miss_rate <= 1.0:
            raise ValueError("shed_miss_rate must be in [0, 1]")
        if self.miss_window < 1:
            raise ValueError("miss_window must be >= 1")

    @property
    def soft_limit(self) -> int:
        return max(int(self.max_pending * self.soft_fraction), 1)

    def as_dict(self) -> dict:
        return {
            "max_pending": self.max_pending,
            "overload": self.overload,
            "soft_limit": self.soft_limit,
            "shed_miss_rate": self.shed_miss_rate,
        }


@dataclasses.dataclass
class PolicyRecord:
    """Predicted vs realized benefit for one policy decision."""

    graph_id: str
    decision: PolicyDecision
    miss_rate_before: float
    miss_rate_after: float
    reorder_seconds: float
    family: str = "analytics"   # graph family the outcome belongs to

    @property
    def realized_gain(self) -> float:
        if self.miss_rate_before <= 0:
            return 0.0
        return 1.0 - self.miss_rate_after / self.miss_rate_before

    @property
    def prediction_error(self) -> float:
        return self.decision.predicted_gain - self.realized_gain

    def as_dict(self) -> dict:
        return {
            "graph_id": self.graph_id,
            "family": self.family,
            "scheme": self.decision.scheme,
            "backend": self.decision.backend,
            "hot_prefix_fraction": self.decision.hot_prefix_fraction,
            "kwargs": self.decision.kwargs,
            "reason": self.decision.reason,
            "skew": self.decision.skew,
            "predicted_gain": self.decision.predicted_gain,
            "realized_gain": self.realized_gain,
            "miss_rate_before": self.miss_rate_before,
            "miss_rate_after": self.miss_rate_after,
            "reorder_seconds": self.reorder_seconds,
        }


class ReorderPolicy:
    """Threshold policy over (probes, volume) with calibrated strengths."""

    def __init__(self, min_queries: int = 4, high_volume: int = 32,
                 min_gini: float = 0.25, dbg_gini: float = 0.45,
                 calibrator: StrengthCalibrator | None = None,
                 min_calibration_samples: int = 5,
                 override_margin: float = 0.05,
                 device_budget_bytes: int | None = None,
                 hot_prefix_hub_mass_min: float = 0.5,
                 hot_prefix_margin: float = 2.0,
                 hot_prefix_bounds: tuple[float, float] = (0.05, 0.5)):
        self.min_queries = min_queries
        self.high_volume = high_volume
        self.min_gini = min_gini
        self.dbg_gini = dbg_gini
        self.calibrator = calibrator or StrengthCalibrator()
        self.min_calibration_samples = min_calibration_samples
        self.override_margin = override_margin
        # None = everything fits one device; a byte budget turns placement
        # on and routes oversized graphs to the sharded backend
        self.device_budget_bytes = device_budget_bytes
        # sharded placement: hub mass above the threshold means a hub-
        # packing reorder concentrates most property reads in the first
        # ~hub_fraction of ids, so the per-step all-gather can be thinned
        # to that prefix (margin x for the cold vertices interleaved by
        # imperfect packing), clamped to the bounds
        self.hot_prefix_hub_mass_min = hot_prefix_hub_mass_min
        self.hot_prefix_margin = hot_prefix_margin
        self.hot_prefix_bounds = hot_prefix_bounds
        # placement v2: the S term of estimate_device_bytes. Starts at 1
        # (a lone query's state) and tracks the micro-batch scheduler's
        # *observed* coalesced launch sizes via an EWMA, so re-decisions
        # place graphs against the batch shapes traffic actually produces
        self.batch_sources_ewma = 1.0
        self.batch_sources_decay = 0.2
        self.batches_observed = 0
        self.history: list[PolicyRecord] = []

    # ------------------------------------------------------------- decide
    @staticmethod
    def _skew(probes: GraphProbes) -> float:
        """Probe composite: how much hot working set there is to pack."""
        return min(probes.degree_gini * (0.5 + probes.hub_mass), 1.0)

    @staticmethod
    def _visit_skew(probes: GraphProbes) -> float:
        """The same composite over observed visit frequency — the skew
        axis for search graphs, whose fixed out-degree makes the degree
        composite read ~0 (docs/search.md)."""
        return min(probes.visit_gini * (0.5 + probes.visit_hub_mass), 1.0)

    def _predict_gain(self, probes: GraphProbes, scheme: str) -> float:
        """Payoff model: skew x fitted scheme strength (family-keyed)."""
        skew = (self._visit_skew(probes) if scheme == "visitsort"
                else self._skew(probes))
        return round(skew * self.calibrator.strength(
            scheme, family=probes.family), 4)

    def _scheme_kwargs(self, scheme: str, probes: GraphProbes) -> dict:
        if scheme == "lorder":
            return {"kappa": max(1, (probes.diameter + 1) // 2)}
        return {}

    def observe_batch_sources(self, num_sources: int) -> None:
        """Feed one coalesced launch's source count into the S estimate.

        Called by the micro-batch scheduler after every multi-source
        launch; `_placement` sizes query state from the EWMA of these
        observations, closing the loop between the request plane's real
        batch shapes and where graphs are placed (ROADMAP placement v2).
        """
        n = max(int(num_sources), 1)
        if self.batches_observed == 0:
            self.batch_sources_ewma = float(n)
        else:
            d = self.batch_sources_decay
            self.batch_sources_ewma = ((1.0 - d) * self.batch_sources_ewma
                                       + d * n)
        self.batches_observed += 1

    @property
    def batch_sources_hint(self) -> int:
        """S for placement: the vmapped launch the executor would build
        for the typical observed batch (its power-of-two source bucket)."""
        from .backends import source_bucket
        return source_bucket(max(int(round(self.batch_sources_ewma)), 1))

    def _placement(self, probes: GraphProbes) -> tuple[str, str | None]:
        """Pick the execution backend from the working set vs budget.

        Placement changes the amortization math, not just the launch
        path: a sharded traversal pays an all-gather per step, so the
        session discounts booked reorder savings on sharded graphs
        (`AmortizationLedger.gain_discount`).
        """
        if self.device_budget_bytes is None:
            return "single", None
        # what the single-device backend would actually hold live: the
        # graph padded to its geometric bucket (default bucketing params,
        # not the raw (V, E) footprint — a graph just under budget raw
        # can be nearly growth x over it once padded) plus the (S, V)
        # query state of the typical observed micro-batch
        v_b, e_b = bucket_dims(probes.num_vertices, probes.num_edges)
        s = self.batch_sources_hint
        csr_only = estimate_device_bytes(v_b, e_b)
        need = estimate_device_bytes(v_b, e_b, batch_sources=s)
        if need > self.device_budget_bytes:
            batch_note = ""
            if csr_only <= self.device_budget_bytes:
                batch_note = (f" (the CSR alone fits; S={s} observed "
                              f"batch state tips it over)")
            note = (f"placement: working set ~{need / 1e6:.1f} MB "
                    f"(CSR + S={s} query state) exceeds device budget "
                    f"{self.device_budget_bytes / 1e6:.1f} MB — serving "
                    f"sharded across devices{batch_note}")
            return "sharded", note
        return "single", None

    def _hot_prefix(self, probes: GraphProbes,
                    scheme: str) -> tuple[float | None, str | None]:
        """Derive the sharded hot-prefix fraction from the hub-mass probe.

        Only meaningful when a hub-packing reorder concentrates the hot
        working set toward low ids: the original/random layouts scatter
        hubs across every shard's slice, so thinning the exchange would
        just delay convergence for nothing. The exchange gathers the
        first ``fraction`` of *each shard's* slice — under a
        degree-monotone packing that is each shard's locally-hottest
        range, while the absolute hubs sit on the first shard(s), so
        this is a heuristic, not a coverage guarantee (covering the
        global hub prefix exactly would need ``fraction ~ hub_fraction x
        num_shards``; the realized coverage is what the backend's
        ``prefix_hit_rate`` telemetry measures). ``margin x
        hub_fraction`` clamped to the bounds is a serviceable default
        either way: results stay exact regardless, only convergence
        speed rides on the estimate.
        """
        if scheme in ("original", "random"):
            return None, None
        if probes.hub_mass < self.hot_prefix_hub_mass_min:
            return None, None
        lo, hi = self.hot_prefix_bounds
        frac = round(min(max(probes.hub_fraction * self.hot_prefix_margin,
                             lo), hi), 4)
        note = (f"hot-prefix exchange: hub mass {probes.hub_mass:.2f} >= "
                f"{self.hot_prefix_hub_mass_min} concentrated on "
                f"{probes.hub_fraction:.1%} of vertices — gathering the "
                f"first {frac:.1%} of each shard per step")
        return frac, note

    def _calibrated_override(self, default: str, candidates: list[str],
                             probes: GraphProbes) -> tuple[str, str | None]:
        """Swap the tier default for a candidate with higher fitted gain.

        Only fires once there is evidence to act on — the default or the
        challenger has ``min_calibration_samples`` observations — so an
        uncalibrated policy reproduces the static PR 1 decision tree
        exactly. The margin keeps noise from flapping decisions.
        """
        cal, n_min = self.calibrator, self.min_calibration_samples
        best, best_gain = default, self._predict_gain(probes, default)
        for cand in candidates:
            if cand == default:
                continue
            if cal.count(cand) < n_min and cal.count(default) < n_min:
                continue
            gain = self._predict_gain(probes, cand)
            if gain > best_gain + self.override_margin:
                best, best_gain = cand, gain
        if best == default:
            return default, None
        note = (f"calibration override: fitted strength favours {best} "
                f"({best_gain:.3f}) over {default} "
                f"({self._predict_gain(probes, default):.3f}) by more than "
                f"{self.override_margin}")
        return best, note

    def _decide_search(self, probes: GraphProbes,
                       expected_queries: int) -> PolicyDecision:
        """Search-family tree: degree probes are blind here (fixed
        out-degree), so the only skew worth packing is *observed* visit
        frequency — populated by `GraphRegistry.note_visits` as knn
        traffic flows and refreshed via ``refresh_visit_probes``. Until
        telemetry shows skew, serve the original layout."""
        if expected_queries < self.min_queries:
            scheme, source = "original", "degree"
            reason = (f"volume gate: {expected_queries} expected queries "
                      f"< {self.min_queries}, reorder cannot amortize")
        elif probes.visit_gini < self.min_gini:
            scheme, source = "original", "degree"
            reason = (f"search skew gate: visit gini "
                      f"{probes.visit_gini:.3f} < {self.min_gini} — no "
                      f"observed hot set to pack (degree gini "
                      f"{probes.degree_gini:.3f} is structurally "
                      f"uninformative on fixed out-degree graphs)")
        else:
            scheme, source = "visitsort", "visits"
            reason = (f"search family: observed visit gini "
                      f"{probes.visit_gini:.3f} >= {self.min_gini} with "
                      f"{probes.visit_hub_mass:.1%} of visits on "
                      f"{probes.visit_hub_fraction:.1%} of vertices — "
                      f"packing the hot prefix by visit telemetry")
        backend, placement_note = self._placement(probes)
        if placement_note:
            reason = f"{reason}; {placement_note}"
        skew = (self._visit_skew(probes) if source == "visits"
                else self._skew(probes))
        return PolicyDecision(scheme, {}, reason,
                              self._predict_gain(probes, scheme),
                              skew, backend, None, hotness_source=source)

    def decide(self, probes: GraphProbes,
               expected_queries: int) -> PolicyDecision:
        if probes.family == "search":
            return self._decide_search(probes, expected_queries)
        candidates: list[str] = []
        if expected_queries < self.min_queries:
            scheme = "original"
            reason = (f"volume gate: {expected_queries} expected queries "
                      f"< {self.min_queries}, reorder cannot amortize")
        elif probes.degree_gini < self.min_gini:
            scheme = "original"
            reason = (f"skew gate: degree gini {probes.degree_gini:.3f} "
                      f"< {self.min_gini}, no hub working set to pack")
        elif expected_queries < self.high_volume:
            candidates = ["hubcluster", "dbg"]
            if probes.degree_gini < self.dbg_gini:
                scheme = "hubcluster"
                reason = (f"cheap tier: moderate skew "
                          f"(gini {probes.degree_gini:.3f}), single-pass "
                          f"hub clustering")
            else:
                scheme = "dbg"
                reason = (f"cheap tier: high skew "
                          f"(gini {probes.degree_gini:.3f}), degree-based "
                          f"grouping")
        else:
            candidates = ["hubcluster", "dbg", "lorder"]
            scheme = "lorder"
            kappa = self._scheme_kwargs("lorder", probes)["kappa"]
            reason = (f"high volume ({expected_queries} >= "
                      f"{self.high_volume}) + skew "
                      f"(gini {probes.degree_gini:.3f}): LOrder with "
                      f"probe-derived kappa = ceil(D/2) = {kappa} "
                      f"(D ~ {probes.diameter})")
        if candidates:
            scheme, note = self._calibrated_override(scheme, candidates,
                                                     probes)
            if note:
                reason = f"{reason}; {note}"
        backend, placement_note = self._placement(probes)
        if placement_note:
            reason = f"{reason}; {placement_note}"
        hot_prefix = None
        if backend == "sharded":
            hot_prefix, prefix_note = self._hot_prefix(probes, scheme)
            if prefix_note:
                reason = f"{reason}; {prefix_note}"
        return PolicyDecision(scheme, self._scheme_kwargs(scheme, probes),
                              reason, self._predict_gain(probes, scheme),
                              self._skew(probes), backend, hot_prefix)

    # -------------------------------------------------------------- apply
    def reorder_fn(self, decision: PolicyDecision, visits=None):
        """Resolve the decision to a callable(graph) -> perm.

        ``visits`` carries the observed per-vertex visit EWMA (original-id
        space) that the ``visitsort`` scheme orders by — it is serving
        telemetry, not graph structure, so it rides in from the session
        rather than the registry of structural schemes.
        """
        if decision.scheme == "visitsort":
            if visits is None:
                raise ValueError(
                    "visitsort orders by observed visits; pass visits=")
            from ..search.serve import visit_order
            return lambda g: visit_order(visits)
        fn = reordering_registry()[decision.scheme]
        return lambda g: fn(g, **decision.kwargs)

    def record(self, graph_id: str, decision: PolicyDecision,
               miss_rate_before: float, miss_rate_after: float,
               reorder_seconds: float,
               family: str = "analytics") -> PolicyRecord:
        """Log an outcome and feed it to the calibrator (the closed loop)."""
        rec = PolicyRecord(graph_id, decision, miss_rate_before,
                           miss_rate_after, reorder_seconds, family=family)
        self.history.append(rec)
        self.calibrator.observe_record(rec)
        return rec

    # ----------------------------------------------------------- persist
    def save_calibration(self, path):
        """Persist fitted strengths so calibration survives sessions."""
        return self.calibrator.save(path)

    def load_calibration(self, path) -> None:
        self.calibrator = StrengthCalibrator.load(path)
