#!/usr/bin/env python3
"""Time the flash backward (``flash_attn.flash_attention_bwd``) of one or
more checkouts of the port, in turns, on one CUDA card.

    python3 flash_bwd_ab.py                       # this checkout
    python3 flash_bwd_ab.py build/parent . . build/parent

Each argument is the root of a checkout; each runs in a process of its
own (the checkouts share module names), builds that checkout's flash
kernels into its own ``build/kernels`` and measures, on the same inputs
made from a seed, the backward's device milliseconds (CUDA events over 20
calls, after 3) at chip_smoke.py's three training shapes: a qwen2.5-3b
microbatch (32 query rows of 4,096 over 4 kv rows, d 128, causal), a
minicpm-2b one (72 rows, d 64, causal) and a paligemma-3b one (16 rows
over 2 kv rows, d 256, causal with a 256-row prefix); a checkout whose
backward does not take a shape says so. Where the checkout's wrapper has
``backward_launches``, each of its two kernels is also timed alone.
Prints one line per checkout and shape, and the card's name and power
limit.
"""
from __future__ import annotations

import pathlib
import sys

import ab_harness

# (BH, KV, S, d, prefix)
SHAPES = ((32, 4, 4096, 128, 0), (72, 72, 4096, 64, 0),
          (16, 2, 4096, 256, 256))


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
    for bh, kv, s, d, prefix in SHAPES:
        key = f"({bh}, {kv}, {s}, {d}, prefix {prefix})"
        try:
            fa.bwd_variant(torch.bfloat16, d)
        except NotImplementedError as e:
            out[key] = {"not taken": str(e)}
            continue
        gen = torch.Generator(device=dev).manual_seed(7)
        q, do, k, v = (torch.randn((n, s, d), generator=gen, device=dev).to(
            torch.bfloat16) for n in (bh, bh, kv, kv))
        o, lse = fa.flash_attention_lse(q, k, v, prefix=prefix)
        out[key] = {"ms": device_ms(lambda: fa.flash_attention_bwd(
            q, k, v, o, lse, do, prefix=prefix))}
        if hasattr(fa, "backward_launches"):
            _, launch_dq, launch_dkdv = fa.backward_launches(
                q, k, v, o, lse, do, prefix=prefix)
            launch_dq()
            out[key].update(dq_ms=device_ms(launch_dq),
                            dkdv_ms=device_ms(launch_dkdv))
    return out


if __name__ == "__main__":
    sys.exit(ab_harness.main(sys.argv, __file__, "flash_bwd_ab", child))
