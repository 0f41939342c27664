#!/usr/bin/env python3
"""Time the flash backward (``flash_attn.flash_attention_bwd``) of one or
more checkouts of the port, in turns, on one CUDA card.

    python3 flash_bwd_ab.py                       # this checkout
    python3 flash_bwd_ab.py build/parent . . build/parent

Each argument is the root of a checkout; each runs in a process of its
own (the checkouts share module names), builds that checkout's flash
kernels into its own ``build/kernels`` and measures, on the same inputs
made from a seed, the backward's device milliseconds (CUDA events over 20
calls, after 3) at chip_smoke.py's two training shapes, causal: a
qwen2.5-3b microbatch (32 query rows of 4,096 over 4 kv rows, d 128) and a
minicpm-2b one (72 rows, d 64). Where the checkout's wrapper has
``backward_launches``, each of its two kernels is also timed alone.
Prints one line per checkout and shape, and the card's name and power
limit.
"""
from __future__ import annotations

import pathlib
import sys

import ab_harness

SHAPES = ((32, 4, 4096, 128), (72, 72, 4096, 64))   # (BH, KV, S, d)


def child(root: pathlib.Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn import flash_attn as fa
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_ab: no CUDA device")
    _build.build_all(["flash_attn"])
    dev = torch.device("cuda")

    def device_ms(fn):
        return ab_harness.device_ms(fn, 20)

    out = {}
    for bh, kv, s, d in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(7)
        q, do, k, v = (torch.randn((n, s, d), generator=gen, device=dev).to(
            torch.bfloat16) for n in (bh, bh, kv, kv))
        o, lse = fa.flash_attention_lse(q, k, v)
        key = f"({bh}, {kv}, {s}, {d})"
        out[key] = {"ms": device_ms(
            lambda: fa.flash_attention_bwd(q, k, v, o, lse, do))}
        if hasattr(fa, "backward_launches"):
            _, launch_dq, launch_dkdv = fa.backward_launches(q, k, v, o, lse,
                                                             do)
            launch_dq()
            out[key].update(dq_ms=device_ms(launch_dq),
                            dkdv_ms=device_ms(launch_dkdv))
    return out


if __name__ == "__main__":
    sys.exit(ab_harness.main(sys.argv, __file__, "flash_bwd_ab", child))
