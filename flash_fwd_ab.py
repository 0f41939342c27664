#!/usr/bin/env python3
"""Time the flash forward (``flash_attn.flash_attention``) of one or more
checkouts of the port, in turns, on one CUDA card.

    python3 flash_fwd_ab.py                       # this checkout
    python3 flash_fwd_ab.py build/parent . . build/parent

Each argument is the root of a checkout; each runs in a process of its
own (the checkouts share module names), builds that checkout's flash
kernels into its own ``build/kernels`` and measures, on the same inputs
made from a seed, the forward's device milliseconds (CUDA events over 10
calls, after 3), without and with the row log-sum-exp
(``flash_attention_lse``, the training forward), at chip_smoke.py's
prefill shapes of two models: paligemma-3b (8 query rows of 32,768 over 1
kv row, head dim 256, causal with a 256-token prefix) and, as the control,
qwen2.5-3b (16 query rows over 2 kv rows, head dim 128, causal). Prints
one line per checkout and shape, and the card's name and power limit.
"""
from __future__ import annotations

import pathlib
import sys

import ab_harness

# (name, BH, KV, S, d, prefix)
SHAPES = (("paligemma-3b", 8, 1, 32768, 256, 256),
          ("qwen2.5-3b", 16, 2, 32768, 128, 0))


def child(root: pathlib.Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn import flash_attn as fa
    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_ab: no CUDA device")
    _build.build_all(["flash_attn"])
    dev = torch.device("cuda")

    out = {}
    for name, bh, kv, s, d, prefix in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(7)
        q, k, v = (torch.randn((n, s, d), generator=gen, device=dev).to(
            torch.bfloat16) for n in (bh, kv, kv))
        out[f"{name} ({bh}, {kv}, {s}, {d}) prefix {prefix}"] = {
            "ms": ab_harness.device_ms(
                lambda: fa.flash_attention(q, k, v, prefix=prefix), 10),
            "lse_ms": ab_harness.device_ms(
                lambda: fa.flash_attention_lse(q, k, v, prefix=prefix), 10)}
        del q, k, v
    return out


if __name__ == "__main__":
    sys.exit(ab_harness.main(sys.argv, __file__, "flash_fwd_ab", child))
