"""Deterministic synthetic-corpus token source.

A copy of the numpy token source of the JAX package
(``src/repro/data/pipeline.py``), kept here because the port imports
nothing of ``repro``. The corpus is generated, not downloaded:

* **Zipf-community token source** — token frequencies follow a Zipf law
  and tokens are drawn per-document from topic clusters (a planted
  community structure over the vocabulary). This is the same generative
  family the vocab-LOrder feature exploits, so hot-slab coverage measured
  on this corpus is meaningful.
* **Deterministic sharding** — sample ``i`` of host ``h`` depends only on
  (seed, h, i): restartable from any step with no state files, and two
  hosts never emit the same sequence.

The reference's prefetching ``DataLoader`` is not copied: nothing in the
port trains yet. Callers map a batch through `locality.vocab.VocabReorder`
themselves, as the loader's hook does.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    num_topics: int = 64
    zipf_alpha: float = 1.2
    topic_concentration: float = 0.25   # fraction of tokens from the topic
    num_hosts: int = 1
    host_id: int = 0

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.num_hosts == 0
        return self.global_batch // self.num_hosts


class ZipfCommunityCorpus:
    """Deterministic, seekable token source."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # global Zipf over a shuffled vocab (so raw id ≠ frequency rank —
        # the reordering has real work to do)
        ranks = rng.permutation(v)
        w = 1.0 / (1.0 + ranks.astype(np.float64)) ** cfg.zipf_alpha
        self.global_p = w / w.sum()
        # topics: contiguous rank-bands of the vocabulary per topic, so
        # co-occurrence has community structure
        t = cfg.num_topics
        by_rank = np.argsort(ranks, kind="stable")
        bands = np.array_split(by_rank, t)
        self.topic_tokens = bands
        self.topic_p = [self.global_p[b] / self.global_p[b].sum()
                        for b in bands]

    def sample_doc(self, key: tuple[int, ...], length: int) -> np.ndarray:
        """One document; ``key`` = (host, step, row) determines everything."""
        rng = np.random.default_rng(
            np.random.SeedSequence((self.cfg.seed, *key)))
        topic = int(rng.integers(self.cfg.num_topics))
        from_topic = rng.random(length) < self.cfg.topic_concentration
        n_t = int(from_topic.sum())
        doc = rng.choice(self.cfg.vocab_size, size=length, p=self.global_p)
        if n_t:
            doc[from_topic] = rng.choice(self.topic_tokens[topic], size=n_t,
                                         p=self.topic_p[topic])
        return doc.astype(np.int32)

    def batch(self, step: int) -> np.ndarray:
        """(host_batch, seq_len) int32 for this host at ``step``."""
        cfg = self.cfg
        rows = [self.sample_doc((cfg.host_id, step, r), cfg.seq_len)
                for r in range(cfg.host_batch)]
        return np.stack(rows)


def corpus_sample(cfg: DataConfig, num_batches: int = 2) -> np.ndarray:
    """Flat token stream for building the co-occurrence graph."""
    corpus = ZipfCommunityCorpus(cfg)
    return np.concatenate(
        [corpus.batch(s).reshape(-1) for s in range(num_batches)])
