"""PyTorch port: the corpus and the vocab LOrder agree with the JAX package.

The port keeps numpy copies of ``repro.data.pipeline``'s token source and
``repro.locality.vocab``'s permutation, which build the prefill's token
ids on the card. The same configs go through both; every array must be
equal, since both are the same numpy code on the same seeds.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro.data import pipeline as jp
from repro.locality import vocab as jv
from repro_torch.data import pipeline as tp
from repro_torch.locality import vocab as tv


@pytest.mark.parametrize("vocab,seq,batch,step,seed", [
    (1000, 64, 2, 0, 1234), (5000, 300, 1, 3, 7), (257, 16, 4, 1, 0)])
def test_corpus_batches_equal_the_reference(vocab, seq, batch, step, seed):
    kw = dict(vocab_size=vocab, seq_len=seq, global_batch=batch, seed=seed)
    want = jp.ZipfCommunityCorpus(jp.DataConfig(**kw)).batch(step)
    got = tp.ZipfCommunityCorpus(tp.DataConfig(**kw)).batch(step)
    assert got.dtype == np.int32 and got.shape == (batch, seq)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tp.corpus_sample(tp.DataConfig(**kw), 2),
        jp.corpus_sample(jp.DataConfig(**kw), 2))


@pytest.mark.parametrize("vocab,window,hot_fraction", [
    (2000, 1, 0.05), (3000, 2, 0.1)])
def test_vocab_permutation_equals_the_reference(vocab, window, hot_fraction):
    kw = dict(vocab_size=vocab, seq_len=2048, global_batch=2)
    sample = jp.corpus_sample(jp.DataConfig(**kw), 1)
    want = jv.vocab_permutation(sample, vocab, hot_fraction=hot_fraction,
                                window=window)
    got = tv.vocab_permutation(sample, vocab, hot_fraction=hot_fraction,
                               window=window)
    np.testing.assert_array_equal(got.perm, want.perm)
    np.testing.assert_array_equal(got.inverse, want.inverse)
    assert got.hot_size == want.hot_size
    held_out = jp.ZipfCommunityCorpus(jp.DataConfig(**kw)).batch(1)
    np.testing.assert_array_equal(got.map_tokens(held_out),
                                  want.map_tokens(held_out))
    np.testing.assert_array_equal(got.unmap_tokens(got.map_tokens(held_out)),
                                  held_out)
    assert tv.hot_coverage(held_out, got) == jv.hot_coverage(held_out, want)
