"""Set-associative LRU cache simulator (set-sampling) — paper's cache stats.

The paper attributes reordering speedups to LLC miss-rate reduction on the
*vertex property arrays* (§2.3: vertex/edge arrays stream; property arrays
have degree-proportional reuse). We reproduce those statistics exactly and
hardware-independently:

* The property-access trace of a pull-mode traversal over CSR is the
  in-edge array itself (for each destination in id order, the source ids
  whose property is read) — i.e. ``g.transpose.indices``. Push-mode uses
  ``g.indices``. Reordering changes the *content* of that trace, which is
  the entire effect being measured.
* Misses are counted with an exact per-set LRU model. For speed we use
  **set sampling** (simulate 1/R of the sets exactly; architectural
  standard, unbiased for index-hashed caches). ``sample_rate=1`` gives the
  exact full simulation.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict

import numpy as np

from ..core.csr import Graph


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    size_bytes: int = 2 * 1024 * 1024   # per-core LLC slice
    ways: int = 16
    line_bytes: int = 64
    prop_bytes: int = 4                 # float32/int32 vertex property
    sample_rate: int = 16               # simulate 1/sample_rate of the sets

    @property
    def num_sets(self) -> int:
        return self.size_bytes // (self.line_bytes * self.ways)

    @property
    def props_per_line(self) -> int:
        return self.line_bytes // self.prop_bytes


LLC = CacheConfig()
L2 = CacheConfig(size_bytes=1024 * 1024, ways=8)


def property_trace(g: Graph, mode: str = "pull") -> np.ndarray:
    """Vertex-property access trace of one full traversal (paper §2.3)."""
    if mode == "pull":
        return np.asarray(g.transpose.indices, dtype=np.int64)
    if mode == "push":
        return np.asarray(g.indices, dtype=np.int64)
    raise ValueError(mode)


def simulate_misses(trace: np.ndarray, cfg: CacheConfig = LLC) -> dict:
    """Exact LRU simulation on sampled sets. Returns miss statistics."""
    lines = trace // cfg.props_per_line
    sets = lines % cfg.num_sets
    if cfg.sample_rate > 1:
        keep = (sets % cfg.sample_rate) == 0
        lines, sets = lines[keep], sets[keep]
    sampled = len(lines)
    if sampled == 0:
        return {"misses": 0, "accesses": 0, "miss_rate": 0.0, "sampled": 0}

    lru: dict[int, OrderedDict] = {}
    misses = 0
    for line, s in zip(lines.tolist(), sets.tolist()):
        od = lru.get(s)
        if od is None:
            od = OrderedDict()
            lru[s] = od
        if line in od:
            od.move_to_end(line)
        else:
            misses += 1
            od[line] = None
            if len(od) > cfg.ways:
                od.popitem(last=False)
    return {
        "misses": misses,
        "accesses": sampled,
        "miss_rate": misses / sampled,
        "sampled": sampled,
    }


def miss_rate(g: Graph, cfg: CacheConfig = LLC, mode: str = "pull") -> float:
    return simulate_misses(property_trace(g, mode), cfg)["miss_rate"]


def scaled_config(g: Graph, capacity_fraction: float = 1 / 8,
                  ways: int = 16, sample_rate: int = 8) -> CacheConfig:
    """Cache sized so the property array is ~1/capacity_fraction× capacity.

    Small benchmark graphs fit a real LLC outright, which would hide the
    reordering effect; scaling capacity to the graph restores the paper's
    working-set-exceeds-LLC regime (same trick as benchmarks/speedups.py).
    """
    prop_bytes = g.num_vertices * 4
    size = max(8 * 1024, int(prop_bytes * capacity_fraction))
    return CacheConfig(size_bytes=size, ways=ways, sample_rate=sample_rate)


def estimate_miss_rate(g: Graph, cfg: CacheConfig | None = None,
                       mode: str = "pull", max_accesses: int = 1 << 20) -> float:
    """Cheap miss-rate estimate for the engine's reorder policy.

    Large traces are cut down by raising the *set*-sampling rate, never by
    truncating the trace: set sampling stays unbiased across the whole
    traversal, whereas a trace prefix covers only low-id destinations —
    exactly the region reordering packs hubs into, which would bias
    before/after comparisons.
    """
    cfg = scaled_config(g) if cfg is None else cfg
    trace = property_trace(g, mode)
    if len(trace) > max_accesses * cfg.sample_rate:
        boost = -(-len(trace) // max_accesses)  # ceil
        cfg = dataclasses.replace(cfg, sample_rate=int(boost))
    return simulate_misses(trace, cfg)["miss_rate"]


def compare_orders(g: Graph, perms: dict[str, np.ndarray],
                   cfg: CacheConfig = LLC, mode: str = "pull") -> dict[str, float]:
    """Miss rate per reordering, including the original layout."""
    out = {"original": miss_rate(g, cfg, mode)}
    for name, perm in perms.items():
        out[name] = miss_rate(g.apply_permutation(perm), cfg, mode)
    return out
