"""Vocabulary reordering — the paper's LOrder run on a token co-occurrence
graph.

A copy of the numpy part of the JAX package's
``src/repro/locality/vocab.py``. Token frequencies are Zipf-distributed
and co-occurrence is community-structured (topics). We build a directed
co-occurrence graph from a corpus sample — vertex = token id, edge u→v for
each adjacent pair (u, v) within a window — and run the LOrder algorithm
on it. The resulting permutation maps hot tokens to a contiguous low-id
slab, whose rows the ``hot_embed`` kernel serves.

The reference's ``apply_to_params`` (a JAX take over the embedding rows)
and its frequency-sort fallback are not copied: the port's weights are
drawn at random, so permuting their rows would change nothing measured.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.csr import Graph, from_edges, validate_permutation
from ..core.lorder import lorder


@dataclasses.dataclass
class VocabReorder:
    """perm[old_token_id] = new_token_id, plus diagnostics."""
    perm: np.ndarray
    inverse: np.ndarray
    hot_size: int
    scheme: str

    def map_tokens(self, tokens: np.ndarray) -> np.ndarray:
        return self.perm[tokens]

    def unmap_tokens(self, tokens: np.ndarray) -> np.ndarray:
        return self.inverse[tokens]


def cooccurrence_graph(corpus: np.ndarray, vocab_size: int,
                       window: int = 1, max_pairs: int = 4_000_000) -> Graph:
    """Directed co-occurrence multigraph from a flat token stream."""
    toks = np.asarray(corpus, dtype=np.int64).reshape(-1)
    srcs, dsts = [], []
    budget = max_pairs
    for off in range(1, window + 1):
        s, d = toks[:-off], toks[off:]
        if len(s) > budget:
            s, d = s[:budget], d[:budget]
        srcs.append(s)
        dsts.append(d)
        budget -= len(s)
        if budget <= 0:
            break
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    return from_edges(vocab_size, src, dst, name="vocab-cooc")


def vocab_permutation(corpus: np.ndarray, vocab_size: int,
                      kappa: int = 2, hot_fraction: float = 0.05,
                      window: int = 1) -> VocabReorder:
    """LOrder over the co-occurrence graph. κ defaults to 2: co-occurrence
    graphs are near-small-world (D ≈ 4-6 through hub tokens), so the
    paper's κ = D/2 rule lands at ~2."""
    g = cooccurrence_graph(corpus, vocab_size, window)
    perm = np.asarray(lorder(g, kappa=kappa), dtype=np.int64)
    assert validate_permutation(perm, vocab_size)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(vocab_size)
    hot = max(1, int(vocab_size * hot_fraction))
    return VocabReorder(perm, inv, hot, scheme="lorder")


def hot_coverage(corpus: np.ndarray, reorder: VocabReorder) -> float:
    """Fraction of corpus tokens served by the hot slab after reordering —
    the metric the hot_embed kernel's win is proportional to."""
    mapped = reorder.map_tokens(np.asarray(corpus).reshape(-1))
    return float((mapped < reorder.hot_size).mean())
