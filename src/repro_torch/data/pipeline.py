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
* **Host prefetch** — `DataLoader`, the trainer's loader, keeps a bounded
  queue of ready batches filled by a background thread, and maps token
  ids through an attached `locality.vocab.VocabReorder` on the host (the
  paper's reordering deployed as preprocessing). Other callers map a batch
  themselves, as the loader's hook does.
"""
from __future__ import annotations

import dataclasses
import queue
import threading

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
    prefetch: int = 2

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


class DataLoader:
    """Prefetching host loader with an optional vocab permutation."""

    def __init__(self, cfg: DataConfig, vocab_reorder=None,
                 start_step: int = 0):
        self.cfg = cfg
        self.corpus = ZipfCommunityCorpus(cfg)
        self.vocab_reorder = vocab_reorder
        self._step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=max(1, cfg.prefetch))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _produce(self, step: int) -> dict:
        tokens = self.corpus.batch(step)
        if self.vocab_reorder is not None:
            tokens = self.vocab_reorder.map_tokens(tokens).astype(np.int32)
        return {"tokens": tokens, "step": step}

    def _worker(self):
        step = self._step
        while not self._stop.is_set():
            batch = self._produce(step)
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self) -> dict:
        return self._q.get()

    def __iter__(self):
        return self

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)


def token_histogram(cfg: DataConfig, num_batches: int = 4) -> np.ndarray:
    """Empirical token counts (hot-vocab calibration / vocab-LOrder input)."""
    corpus = ZipfCommunityCorpus(cfg)
    counts = np.zeros(cfg.vocab_size, dtype=np.int64)
    for s in range(num_batches):
        np.add.at(counts, corpus.batch(s).reshape(-1), 1)
    return counts


def corpus_sample(cfg: DataConfig, num_batches: int = 2) -> np.ndarray:
    """Flat token stream for building the co-occurrence graph."""
    corpus = ZipfCommunityCorpus(cfg)
    return np.concatenate(
        [corpus.batch(s).reshape(-1) for s in range(num_batches)])
