#!/usr/bin/env python3
"""The prefill forward of the recurrent trunks (rwkv6-3b, zamba2-1.2b) of
one or more checkouts of the port, in turns, on one CUDA card: its wall
seconds and its peak memory.

    python3 recurrent_prefill_ab.py                       # this checkout
    python3 recurrent_prefill_ab.py build/parent . . build/parent

Each argument is the root of a checkout; each runs in a process of its
own (the checkouts share module names), builds that checkout's hot_embed
and flash kernels into its own ``build/kernels``, makes each model at full
width and depth (``init_params``, seeded as chip_smoke.py seeds it) and
runs ``models.transformer.forward`` on chip_smoke.py's prefill shape, 1 x
32,768 token ids (uniform over the vocab, from a seed), after a forward
of the first 256 as a warm-up: the median wall seconds of 3 forwards
(host clock, synchronised), the peak GiB that ``max_memory_allocated``
reports over them and that peak less the memory held before (the
weights). Prints one line per checkout and model, and the card's name
and power limit.
"""
from __future__ import annotations

import pathlib
import statistics
import sys
import time

import ab_harness

ARCHS = ("rwkv6-3b", "zamba2-1.2b")
TOKENS = 32768
SEED = 7


def child(root: pathlib.Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    from repro_torch.models.transformer import forward, init_params
    if not torch.cuda.is_available():
        raise SystemExit("recurrent_prefill_ab: no CUDA device")
    _build.build_all(["flash_attn", "hot_embed"])
    dev = torch.device("cuda")

    out = {}
    for arch in ARCHS:
        cfg = get_config(arch)
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(SEED),
                            dev)
        ids = torch.from_numpy(np.random.default_rng(SEED).integers(
            0, cfg.vocab_size, (1, TOKENS)).astype(np.int32)).to(dev)
        forward(model, {"tokens": ids[:, :256]})
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            logits, _ = forward(model, {"tokens": ids})
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            del logits
        peak = torch.cuda.max_memory_allocated()
        out[f"{arch} 1x{TOKENS}"] = {
            "wall_s": statistics.median(walls),
            "peak_gib": peak / 2**30, "above_weights_gib": (peak - held) / 2**30}
        del model, ids
        torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    sys.exit(ab_harness.main(sys.argv, __file__, "recurrent_prefill_ab",
                             child))
