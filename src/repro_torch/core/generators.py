"""Synthetic graph suite — offline substitutes for the paper's datasets.

The container has no network access, so the SNAP graphs the paper uses
(LiveJournal, Orkut, Youtube, Pokec, PLD-arc) are replaced by generators
matched on the properties the paper's mechanism depends on:

* power-law degree skew (hot-vertex fraction, Table 1 analogue),
* community structure (planted partition, ground-truth labels retained so
  LOrder-v2 can consume them),
* a diameter range spanning "small-world social" (D≈8-20) to "road-like"
  (D≈O(√V)) for the κ = D/2 analysis.

`kron` mirrors the paper's Graph500 Kronecker dataset in-kind (RMAT).
"""
from __future__ import annotations

import numpy as np

from .csr import Graph, from_edges


def _rng(seed):
    return np.random.default_rng(seed)


def rmat(scale: int, edge_factor: int = 16, a: float = 0.57, b: float = 0.19,
         c: float = 0.19, seed: int = 0, name: str | None = None) -> Graph:
    """Graph500-style RMAT/Kronecker generator (paper's kron dataset)."""
    n = 1 << scale
    m = n * edge_factor
    rng = _rng(seed)
    src = np.zeros(m, dtype=np.int64)
    dst = np.zeros(m, dtype=np.int64)
    ab, abc = a + b, a + b + c
    for bit in range(scale):
        r = rng.random(m)
        # quadrant choice per Graph500 reference
        go_right = (r >= a) & (r < ab) | (r >= abc)
        go_down = r >= ab
        src = (src << 1) | go_down.astype(np.int64)
        dst = (dst << 1) | go_right.astype(np.int64)
    # permute vertex labels so generation order carries no information
    relab = rng.permutation(n)
    return from_edges(n, relab[src], relab[dst], name=name or f"kron{scale}")


def _chung_lu_edges(weights: np.ndarray, m: int, rng) -> tuple[np.ndarray, np.ndarray]:
    """Sample m edges with endpoint probability ∝ weights (power-law degrees)."""
    p = weights / weights.sum()
    src = rng.choice(len(weights), size=m, p=p)
    dst = rng.choice(len(weights), size=m, p=p)
    return src, dst


def powerlaw_community(num_vertices: int, avg_degree: float = 16.0,
                       num_communities: int | None = None,
                       mixing: float = 0.1, alpha: float = 2.2,
                       seed: int = 0, name: str = "plc") -> Graph:
    """Planted-partition graph with Zipf community sizes and power-law degrees.

    ``mixing`` is the fraction of edges crossing community boundaries
    (LFR-style µ). Ground-truth community labels are retained on the Graph.
    """
    rng = _rng(seed)
    n = num_vertices
    k = num_communities or max(8, int(np.sqrt(n) / 4))
    # Zipf community sizes
    sizes = 1.0 / np.arange(1, k + 1) ** 1.2
    sizes = np.maximum((sizes / sizes.sum() * n).astype(np.int64), 4)
    sizes[0] += n - sizes.sum()  # absorb rounding in the largest community
    labels = np.repeat(np.arange(k), sizes)[:n]
    rng.shuffle(labels)

    # power-law vertex weights (degree propensity)
    w = (1.0 - rng.random(n)) ** (-1.0 / (alpha - 1.0))
    w = np.minimum(w, n ** 0.5)  # cap to avoid absurd hubs

    m = int(n * avg_degree)
    m_inter = int(m * mixing)
    m_intra = m - m_inter

    # intra-community edges: sample community ∝ total weight, endpoints within
    order = np.argsort(labels, kind="stable")
    lab_sorted = labels[order]
    starts = np.searchsorted(lab_sorted, np.arange(k))
    ends = np.searchsorted(lab_sorted, np.arange(k), side="right")
    comm_w = np.bincount(labels, weights=w, minlength=k)
    comm_p = comm_w / comm_w.sum()
    counts = rng.multinomial(m_intra, comm_p)
    src_parts, dst_parts = [], []
    for ci in np.nonzero(counts)[0]:
        members = order[starts[ci]:ends[ci]]
        pw = w[members] / w[members].sum()
        src_parts.append(members[rng.choice(len(members), counts[ci], p=pw)])
        dst_parts.append(members[rng.choice(len(members), counts[ci], p=pw)])
    s_i, d_i = _chung_lu_edges(w, m_inter, rng)
    src = np.concatenate(src_parts + [s_i])
    dst = np.concatenate(dst_parts + [d_i])
    return from_edges(n, src, dst, dedup=True, communities=labels, name=name)


def small_world(num_vertices: int, k: int = 8, rewire: float = 0.05,
                seed: int = 0, name: str = "smallworld") -> Graph:
    """Watts-Strogatz ring: moderate diameter, strong local structure."""
    rng = _rng(seed)
    n = num_vertices
    offsets = np.arange(1, k // 2 + 1)
    src = np.repeat(np.arange(n), len(offsets))
    dst = (src + np.tile(offsets, n)) % n
    flip = rng.random(len(dst)) < rewire
    dst[flip] = rng.integers(0, n, flip.sum())
    return from_edges(n, np.concatenate([src, dst]),
                      np.concatenate([dst, src]), dedup=True, name=name)


def road_grid(side: int, shortcuts: int = 0, seed: int = 0,
              name: str = "road") -> Graph:
    """2-D grid ('road network'): diameter ≈ 2·side — the high-D regime."""
    rng = _rng(seed)
    n = side * side
    idx = np.arange(n).reshape(side, side)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()])
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()])
    src = np.concatenate([right[0], down[0]])
    dst = np.concatenate([right[1], down[1]])
    if shortcuts:
        s = rng.integers(0, n, shortcuts)
        d = rng.integers(0, n, shortcuts)
        src, dst = np.concatenate([src, s]), np.concatenate([dst, d])
    return from_edges(n, np.concatenate([src, dst]),
                      np.concatenate([dst, src]), dedup=True, name=name)


def clustered_vectors(num_vectors: int, dim: int = 16,
                      num_clusters: int = 8, spread: float = 0.15,
                      zipf: float = 1.1, seed: int = 0
                      ) -> tuple[np.ndarray, np.ndarray]:
    """Synthetic vector corpus for the k-NN search workload (search/).

    Gaussian blobs around ``num_clusters`` random centers with Zipf-skewed
    cluster sizes — the skew is what makes a *query* mix concentrate visits
    on the popular clusters' vertices, mirroring the visit-frequency skew
    Coleman et al. exploit on search graphs. Returns ``(vectors, labels)``
    with float32 ``(N, dim)`` vectors and int64 cluster labels.
    """
    rng = _rng(seed)
    n, k = num_vectors, max(1, num_clusters)
    sizes = 1.0 / np.arange(1, k + 1) ** zipf
    sizes = np.maximum((sizes / sizes.sum() * n).astype(np.int64), 1)
    sizes[0] += n - sizes.sum()  # absorb rounding in the largest cluster
    labels = np.repeat(np.arange(k), sizes)[:n]
    rng.shuffle(labels)
    centers = rng.standard_normal((k, dim))
    vecs = centers[labels] + spread * rng.standard_normal((n, dim))
    return vecs.astype(np.float32), labels


# --------------------------------------------------------------------------
# Dataset registry: the paper's six datasets, regenerated in-kind.
# scale=1.0 is the default benchmark size; tests use smaller scales.
# --------------------------------------------------------------------------
def dataset_suite(scale: float = 1.0, seed: int = 7) -> dict[str, Graph]:
    def sz(x):
        return max(1024, int(x * scale))

    return {
        # LiveJournal-like: large social network, D≈16
        "lj-sim": powerlaw_community(sz(1 << 17), avg_degree=14.0, mixing=0.12,
                                     seed=seed, name="lj-sim"),
        # Orkut-like: dense community graph, D≈9
        "orkut-sim": powerlaw_community(sz(1 << 16), avg_degree=38.0, mixing=0.25,
                                        num_communities=64, seed=seed + 1,
                                        name="orkut-sim"),
        # PLD-arc-like: hyperlink graph, extreme skew
        "pld-sim": rmat(max(10, int(np.log2(sz(1 << 17)))), edge_factor=8,
                        a=0.65, b=0.15, c=0.15, seed=seed + 2, name="pld-sim"),
        # the paper's kron dataset (scaled from kron23)
        "kron-sim": rmat(max(10, int(np.log2(sz(1 << 16)))), edge_factor=16,
                         seed=seed + 3, name="kron-sim"),
        # Youtube-like: sparse community graph, high diameter (D≈20)
        "youtube-sim": powerlaw_community(sz(1 << 17), avg_degree=5.0,
                                          mixing=0.05, seed=seed + 4,
                                          name="youtube-sim"),
        # Pokec-like: social network, D≈11
        "pokec-sim": powerlaw_community(sz(1 << 16), avg_degree=18.0,
                                        mixing=0.15, seed=seed + 5,
                                        name="pokec-sim"),
    }


def diameter_suite(seed: int = 11) -> dict[str, Graph]:
    """Extra graphs spanning the diameter axis (paper's κ=D/2 analysis)."""
    return {
        "ring-sw": small_world(1 << 15, k=8, rewire=0.01, seed=seed),
        "road-256": road_grid(128, shortcuts=64, seed=seed),
        "kron-lowD": rmat(14, edge_factor=16, seed=seed),
    }
