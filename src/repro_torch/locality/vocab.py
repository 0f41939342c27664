"""Vocabulary reordering — the paper's LOrder run on a token co-occurrence
graph.

A copy of the numpy part of the JAX package's
``src/repro/locality/vocab.py``. Token frequencies are Zipf-distributed
and co-occurrence is community-structured (topics). We build a directed
co-occurrence graph from a corpus sample — vertex = token id, edge u→v for
each adjacent pair (u, v) within a window — and run the LOrder algorithm
on it. The resulting permutation maps hot tokens to a contiguous low-id
slab, whose rows the ``hot_embed`` kernel serves:

* the embedding table's rows (and an untied head's columns) are permuted
  once at init (`VocabReorder.apply_to_params`, in place on a
  `models.transformer.Transformer`);
* the data pipeline maps token ids through the permutation on the host.

`vocab_permutation` is exact LOrder; `degree_permutation` is the
DBG-style lightweight fallback (frequency binning) for when no corpus
sample is at hand.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.csr import Graph, from_edges, validate_permutation
from ..core.lorder import lorder


@dataclasses.dataclass
class VocabReorder:
    """perm[old_token_id] = new_token_id, plus diagnostics."""
    perm: np.ndarray
    inverse: np.ndarray
    hot_size: int
    scheme: str

    def apply_to_params(self, model):
        """Permute a `Transformer`'s table rows (and an untied head's
        columns) in place, as the reference's ``take`` over ``inverse``
        does; returns the model."""
        inv = torch.from_numpy(self.inverse).to(model.device)
        with torch.no_grad():
            table = model.embed["table"]
            table.copy_(table.index_select(0, inv))
            if "head" in model.embed:
                head = model.embed["head"]
                head.copy_(head.index_select(1, inv))
        return model

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


def degree_permutation(token_counts: np.ndarray,
                       hot_fraction: float = 0.05) -> VocabReorder:
    """Frequency-sort fallback (DBG-flavoured; no graph needed)."""
    n = len(token_counts)
    order = np.argsort(-np.asarray(token_counts, dtype=np.int64),
                       kind="stable")
    perm = np.empty(n, dtype=np.int64)
    perm[order] = np.arange(n)
    inv = order.astype(np.int64)
    hot = max(1, int(n * hot_fraction))
    return VocabReorder(perm, inv, hot, scheme="frequency")
