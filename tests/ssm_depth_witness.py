"""How far decode parts from forward with depth, in the recurrent trunks of
the reference and of the port.

Run on the CPU, from the root of the repo::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/ssm_depth_witness.py

rwkv6-3b and zamba2-1.2b at full width, cut to a few layers and a
vocabulary of ``--vocab`` rows (the trunk never sees the vocabulary),
weights from the JAX package's ``init_params`` (seed 7) carried into the
port. One prompt of ``--tokens`` ids goes through each package's
``forward`` and, teacher-forced, its own ``decode_step``. For each depth
it prints the largest logit difference, whether
tests/test_models.py's decode standard (rtol/atol 0.15) holds, and the
argmax agreement, for the reference and the port side by side.

With random weights both stacks amplify a rounding difference layer by
layer (RWKV6's per-head group norm divides by the spread of a head's
output, which for a random model is near zero at some heads and
positions), so the two runs part further at each depth, in the reference
as in the port. At the defaults it holds two copies of at most 2.2 GB of
float32 weights and runs for about two minutes.
"""
from __future__ import annotations

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_get
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.models import transformer as TT


def _cut(cfg, layers: int, vocab: int):
    return dataclasses.replace(cfg, num_layers=layers, vocab_size=vocab,
                               block_pattern=cfg.block_pattern[:layers])


def _report(name, dec, full) -> None:
    diff = np.abs(dec - full)
    held = bool(np.all(diff <= 0.15 + 0.15 * np.abs(full)))
    agree = float((dec.argmax(-1) == full.argmax(-1)).mean())
    print(f"  {name}: max_abs_diff={diff.max():.4f} decode standard "
          f"{'holds' if held else 'fails'}, argmax agreement {agree:.4f}")


def run(arch: str, layers: int, vocab: int, tokens: int) -> None:
    cfg_j = _cut(jax_get(arch), layers, vocab)
    cfg_t = _cut(get_config(arch), layers, vocab)
    params = JT.init_params(cfg_j, jax.random.PRNGKey(7))
    model = TT.from_jax_params(cfg_t, jax.tree.map(np.asarray, params),
                               device="cpu")
    ids = np.random.default_rng(0).integers(0, vocab, (1, tokens)).astype(
        np.int32)

    want = np.asarray(jax.jit(lambda p, t: JT.forward(
        p, {"tokens": t}, cfg_j)[0])(params, jnp.asarray(ids)), np.float32)
    step = jax.jit(lambda p, c, t: JT.decode_step(p, c, t, cfg_j))
    cache, steps = JT.init_cache(cfg_j, 1, tokens), []
    for i in range(tokens):
        lg, cache = step(params, cache, jnp.asarray(ids[:, i:i + 1]))
        steps.append(np.asarray(lg[:, 0], np.float32))
    print(f"{arch}, {layers} layers:")
    _report("reference decode vs its forward", np.stack(steps, 1), want)

    full = TT.forward(model, {"tokens": torch.from_numpy(ids)})[0]
    cache, steps = TT.init_cache(cfg_t, 1, tokens, device="cpu"), []
    for i in range(tokens):
        lg, cache = TT.decode_step(model, cache,
                                   torch.from_numpy(ids[:, i:i + 1]))
        steps.append(lg[:, 0].float().numpy())
    _report("port decode vs its forward     ", np.stack(steps, 1),
            full.float().numpy())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--tokens", type=int, default=16)
    args = ap.parse_args(argv)
    for arch, depths in (("rwkv6-3b", (2, 4, 6, 8)),
                         ("zamba2-1.2b", (6, 12, 18))):
        for layers in depths:
            run(arch, layers, args.vocab, args.tokens)


if __name__ == "__main__":
    main()
