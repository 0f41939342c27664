"""Graph registry: per-graph serving state + cheap structural probes.

The engine's reorder policy needs exactly the structural facts the paper
shows modulate reordering payoff — degree skew (§2.1 hotness) and diameter
(the κ = D/2 analysis) — but must obtain them at a cost far below a
reorder pass. The probes here are O(E) single passes: a degree Gini
coefficient, the hot-vertex fraction and hot edge mass (λ = avg degree,
the paper's threshold), and a single double-sweep BFS diameter bound.

Registry entries carry everything serving needs per graph: the original
layout (query ids stay in this space), the chosen permutation and its
inverse, the reordered ("served") layout, and the device arrays. Entries
also track *realized* query volume (``queries_observed``) independently
of the amortization ledger — the ledger resets on every re-decision, but
the volume history that triggers re-decisions must not.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..core.csr import Graph
from ..core.diameter import two_sweep_diameter
from ..core.mutate import MutationDelta


@dataclasses.dataclass(frozen=True)
class GraphProbes:
    """Cheap structural summary feeding the reorder policy.

    The ``visit_*`` fields mirror the degree probes but over *observed
    visit frequency* (EWMA, ``GraphRegistry.note_visits``) — the skew
    signal for search graphs, whose out-degree is fixed by construction
    so degree probes read as uniform (Coleman et al., docs/search.md).
    They stay 0 until serving telemetry arrives.
    """

    num_vertices: int
    num_edges: int
    avg_degree: float
    degree_gini: float    # 0 = uniform degrees, →1 = extreme skew
    hub_fraction: float   # fraction of vertices with degree > λ (avg)
    hub_mass: float       # fraction of total degree held by hub vertices
    diameter: int         # double-sweep BFS lower bound
    probe_seconds: float
    family: str = "analytics"    # workload family: "analytics" | "search"
    visit_gini: float = 0.0      # Gini of EWMA visit counts
    visit_hub_fraction: float = 0.0  # fraction with above-mean visits
    visit_hub_mass: float = 0.0      # visit mass held by that hot set


def degree_gini(degrees: np.ndarray) -> float:
    """Gini coefficient of the degree distribution (skew probe)."""
    d = np.sort(degrees.astype(np.float64))
    n = len(d)
    total = d.sum()
    if n == 0 or total == 0:
        return 0.0
    ranks = np.arange(1, n + 1, dtype=np.float64)
    return float(2.0 * (ranks * d).sum() / (n * total) - (n + 1) / n)


def degree_histogram(degrees: np.ndarray) -> np.ndarray:
    """Degree histogram — the O(max_degree) basis of incremental probes."""
    if len(degrees) == 0:
        return np.zeros(1, dtype=np.int64)
    return np.bincount(degrees.astype(np.int64))


def gini_from_histogram(hist: np.ndarray) -> float:
    """Degree Gini from a degree histogram, O(max_degree).

    Equals ``degree_gini(degrees)`` exactly: with degrees sorted
    ascending, a degree value d occupying ranks r0+1..r0+c contributes
    d · (c·r0 + c(c+1)/2) to Σ rank·degree.
    """
    hist = np.asarray(hist, dtype=np.float64)
    counts = hist
    values = np.arange(len(hist), dtype=np.float64)
    n = counts.sum()
    total = (values * counts).sum()
    if n == 0 or total == 0:
        return 0.0
    r0 = np.concatenate([[0.0], np.cumsum(counts)[:-1]])
    rank_sum = (values * (counts * r0 + counts * (counts + 1) / 2.0)).sum()
    return float(2.0 * rank_sum / (n * total) - (n + 1) / n)


def hub_stats_from_histogram(hist: np.ndarray) -> tuple[float, float, float]:
    """(avg_degree, hub_fraction, hub_mass) from a degree histogram.

    Hot := degree > λ (= avg degree), matching ``Graph.hot_mask``.
    """
    hist = np.asarray(hist, dtype=np.float64)
    values = np.arange(len(hist), dtype=np.float64)
    n = hist.sum()
    total = (values * hist).sum()
    if n == 0:
        return 0.0, 0.0, 0.0
    lam = total / n
    hot = values > lam
    hub_fraction = float(hist[hot].sum() / n)
    hub_mass = float((values[hot] * hist[hot]).sum() / total) if total else 0.0
    return float(lam), hub_fraction, hub_mass


def probe_graph(g: Graph, family: str = "analytics") -> GraphProbes:
    """Compute all policy probes in one pass over degrees + two BFS."""
    t0 = time.perf_counter()
    deg = g.degree
    hot = g.hot_mask()
    total = float(deg.sum())
    return GraphProbes(
        num_vertices=g.num_vertices,
        num_edges=g.num_edges,
        avg_degree=g.average_degree,
        degree_gini=degree_gini(deg),
        hub_fraction=float(hot.mean()) if g.num_vertices else 0.0,
        hub_mass=float(deg[hot].sum() / total) if total else 0.0,
        diameter=two_sweep_diameter(g),
        probe_seconds=time.perf_counter() - t0,
        family=family,
    )


@dataclasses.dataclass
class GraphEntry:
    """Per-graph serving state. Fields after ``expected_queries`` are
    populated by the session once the policy has run."""

    graph_id: str
    graph: Graph                      # original layout (query id space)
    probes: GraphProbes
    expected_queries: int             # volume hint; refreshed on re-decision
    perm: np.ndarray | None = None    # perm[old_id] = served_id
    inv_perm: np.ndarray | None = None
    served: Graph | None = None       # reordered layout actually executed
    arrays: object | None = None      # GraphArrays of `served` (single only)
    handle: object | None = None      # engine.backends.GraphHandle
    backend: str = "single"           # placement the policy chose
    bucket_shape: tuple | None = None  # padded (V_b, E_b) upload shape
    hot_prefix_fraction: float | None = None  # sharded exchange thinning
    # served-id prefix length considered "hot" under the current layout
    # (0 for identity/random layouts): result-cache entries whose source
    # permutes below this index are pinned (GRASP-style, result_cache.py)
    hot_prefix_len: int = 0
    reorder_seconds: float = 0.0
    decision: object | None = None    # engine.policy.PolicyDecision
    ledger: object | None = None      # engine.session.AmortizationLedger
    queries_observed: int = 0         # realized volume, survives re-decisions
    redecisions: int = 0
    # layout generation: bumped every time a policy decision is (re-)applied
    # or the graph mutates. The scheduler translates each request through
    # the generation current at launch time and stamps it into the
    # request's telemetry, so layout replacements are observable and never
    # straddle an in-flight future.
    generation: int = 0
    # --- dynamic-graph state (core/mutate.py deltas) -------------------
    mutations: int = 0                # applied deltas; doubles as the token
    #                                   fencing stale async full reorders
    degree_hist: np.ndarray | None = None  # basis of incremental probes
    # accumulated |delta| / E since the last full probe_graph; past the
    # session's drift threshold the next mutation pays a full re-probe
    probe_drift: float = 0.0
    # --- search-graph state (search/, knn_search) ----------------------
    vectors: np.ndarray | None = None      # (V, d) float32, original order
    search_params: object | None = None    # search.serve.SearchParams
    entry_point: int = 0                   # entry vertex, original id
    visit_ewma: np.ndarray | None = None   # (V,) EWMA visits, original ids
    visits_total: int = 0                  # raw visit-count sum observed
    visit_queries: int = 0                 # queries behind visit_ewma


class GraphRegistry:
    """Ingests graphs, probes them, and holds serving state by id."""

    def __init__(self):
        self._entries: dict[str, GraphEntry] = {}

    def add(self, graph: Graph, graph_id: str | None = None,
            expected_queries: int = 64,
            family: str = "analytics") -> GraphEntry:
        if graph_id is not None and not graph_id:
            # an explicit empty id must not silently alias to graph.name
            raise ValueError("graph_id must be a non-empty string")
        gid = graph_id if graph_id is not None else graph.name
        if not gid:
            raise ValueError(
                "graph has an empty name; pass an explicit graph_id")
        if gid in self._entries:
            raise KeyError(f"graph id {gid!r} already registered")
        entry = GraphEntry(gid, graph, probe_graph(graph, family=family),
                           expected_queries)
        entry.degree_hist = degree_histogram(graph.degree)
        self._entries[gid] = entry
        return entry

    def apply_mutation(self, graph_id: str, new_graph: Graph,
                       delta: MutationDelta,
                       drift_threshold: float = 0.5) -> str:
        """Swap in the mutated graph and refresh probes; returns the probe
        mode used, ``"incremental"`` or ``"full"``.

        Incremental mode updates the degree histogram from the delta's
        per-vertex degree changes (O(|delta| + max_degree)) and
        recomputes Gini/hub stats from it — exact, since both are pure
        functions of the degree multiset. The diameter probe is *not* a
        function of degrees, so it goes stale under incremental mode;
        accumulated drift (Σ |delta| / E) past ``drift_threshold``
        forces a full ``probe_graph`` (fresh diameter) and resets drift.
        """
        entry = self._entries[graph_id]
        old_degrees = entry.graph.degree  # cached; pre-mutation values
        n_old = len(old_degrees)
        t0 = time.perf_counter()
        entry.graph = new_graph
        entry.mutations += 1
        entry.probe_drift += delta.edges_changed / max(entry.probes.num_edges, 1)
        if entry.degree_hist is None or entry.probe_drift > drift_threshold:
            entry.probes = probe_graph(new_graph,
                                       family=entry.probes.family)
            entry.degree_hist = degree_histogram(new_graph.degree)
            entry.probe_drift = 0.0
            return "full"

        hist = entry.degree_hist
        changed = delta.changed_vertices
        # vertices added by this delta enter the multiset at degree 0
        # before their edge endpoints are applied; ids >= the old vertex
        # count must read old degree 0, not index out of the old array
        if delta.vertices_added:
            hist = hist.copy()
            hist[0] += delta.vertices_added
            old_d = np.where(changed < n_old,
                             old_degrees[np.minimum(changed, n_old - 1)],
                             0).astype(np.int64)
        else:
            old_d = old_degrees[changed].astype(np.int64)
        new_d = old_d + delta.degree_delta
        max_d = int(new_d.max()) if len(new_d) else 0
        if max_d >= len(hist):
            hist = np.concatenate(
                [hist, np.zeros(max_d - len(hist) + 1, dtype=hist.dtype)])
        np.subtract.at(hist, old_d, 1)
        np.add.at(hist, new_d, 1)
        entry.degree_hist = hist
        lam, hub_fraction, hub_mass = hub_stats_from_histogram(hist)
        entry.probes = dataclasses.replace(
            entry.probes,
            num_vertices=new_graph.num_vertices,
            num_edges=new_graph.num_edges,
            avg_degree=lam,
            degree_gini=gini_from_histogram(hist),
            hub_fraction=hub_fraction,
            hub_mass=hub_mass,
            # diameter: stale until the next full re-probe (drift-gated)
            probe_seconds=time.perf_counter() - t0,
        )
        return "incremental"

    def get(self, graph_id: str) -> GraphEntry:
        return self._entries[graph_id]

    def note_queries(self, graph_id: str, n: int = 1) -> int:
        """Count realized query batches against a graph; returns total."""
        entry = self._entries[graph_id]
        entry.queries_observed += n
        return entry.queries_observed

    def note_visits(self, graph_id: str, visits: np.ndarray,
                    num_queries: int = 1, alpha: float = 0.3) -> np.ndarray:
        """Fold one launch's per-vertex visit counts (original-id space)
        into the entry's EWMA hotness estimate.

        The estimate tracks *visits per query* so batch size doesn't
        scale it; ``alpha`` is the EWMA smoothing weight on the newest
        batch. Returns the updated EWMA array.
        """
        entry = self._entries[graph_id]
        rate = np.asarray(visits, dtype=np.float64) / max(num_queries, 1)
        if entry.visit_ewma is None or len(entry.visit_ewma) != len(rate):
            # first telemetry, or the vertex set grew (update_graph
            # add_vertices=): start fresh at the observed rate
            entry.visit_ewma = rate.copy()
        else:
            entry.visit_ewma += alpha * (rate - entry.visit_ewma)
        entry.visits_total += int(np.asarray(visits).sum())
        entry.visit_queries += num_queries
        return entry.visit_ewma

    def refresh_visit_probes(self, graph_id: str) -> GraphProbes:
        """Recompute the visit-skew probe fields from the current EWMA
        (the search-family analogue of the degree probes); returns the
        refreshed probes. No-op (returns current) without telemetry."""
        entry = self._entries[graph_id]
        v = entry.visit_ewma
        if v is None or v.sum() <= 0:
            return entry.probes
        hot = v > v.mean()
        total = float(v.sum())
        entry.probes = dataclasses.replace(
            entry.probes,
            visit_gini=degree_gini(v),
            visit_hub_fraction=float(hot.mean()),
            visit_hub_mass=float(v[hot].sum() / total),
        )
        return entry.probes

    def ids(self) -> list[str]:
        return list(self._entries)

    def __contains__(self, graph_id: str) -> bool:
        return graph_id in self._entries

    def __len__(self) -> int:
        return len(self._entries)
