#!/usr/bin/env python3
"""Time the grouped matmul's wrapper (``moe_gmm.gmm``) of one or more
checkouts of the port, in turns, on one CUDA card.

    python3 gmm_ab.py                       # this checkout
    python3 gmm_ab.py build/parent . . build/parent

Each argument is the root of a checkout; each runs in a process of its
own (the checkouts share module names), builds that checkout's kernels
into its own ``build/kernels`` and measures, on the same inputs made from
a seed, at moonshot-v1-16b-a3b's widths (64 experts, d 2048, d_ff 1408):

* a decode step's gate and down products (4 tokens x top-6 = 24 rows):
  the wrapper's host milliseconds a call (the wall of enqueuing 200 calls
  after a synchronize, as ``chip_smoke.py``'s phase 13 takes it) and its
  device milliseconds (CUDA events over 100 calls queued behind a device
  sleep, so the host cannot starve the device);
* a 32,768-token prefill's gate and down products (196,608 rows over a
  seeded skewed routing): device milliseconds over 5 calls.
* for a checkout whose wrapper has the weight-gradient kernel
  (``moe_gmm.tgmm``), a training microbatch's weight gradients (8,192
  tokens x top-6 = 49,152 rows over a seeded skewed routing; xᵀ (2048 x
  49,152) @ dY (49,152 x 1408) for the gate product and the transpose
  widths for the down product): device milliseconds over 10 calls.

Every call uses the wrapper's own choice of kernel. For a checkout whose
wrapper has the split-K kernel (``moe_gmm.splitk_plan``), the decode
shapes are also timed through that kernel's C entry at every chunk count
from 1 to 8 (``chunks``: device ms by count, beside the count the plan
picks). Prints one line per checkout and measurement, and the card's
name and power limit.
"""
from __future__ import annotations

import pathlib
import sys

import ab_harness

E, D, D_FF, TOPK = 64, 2048, 1408, 6


def child(root: pathlib.Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.moe_gmm import moe_gmm as gm
    if not torch.cuda.is_available():
        raise SystemExit("gmm_ab: no CUDA device")
    _build.build_all(["moe_gmm"])
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    bf16 = torch.bfloat16

    def offsets(sizes):
        return torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)])
                                .astype(np.int32)).to(dev)

    def device_ms(fn, reps):
        return ab_harness.device_ms(fn, reps, behind_sleep=True)

    def chunk_sweep(gm, x, w, offs):
        """Device ms of the split-K kernel at 1-8 K chunks (bf16 out)."""
        m, k = x.shape
        n = w.shape[2]
        fn = gm._kernel("splitk")
        out = torch.empty(m, n, device=dev, dtype=bf16)
        stream = torch.cuda.current_stream().cuda_stream
        times = {"plan": float(gm.splitk_plan(m, E, k, n)[0])}
        for chunks in range(1, 9):
            kc = -(-(-(-k // chunks)) // 8) * 8

            def call(kc=kc):
                rc = fn(x.data_ptr(), w.data_ptr(), offs.data_ptr(),
                        out.data_ptr(), 0, m, k, n, E, -(-k // kc), kc,
                        stream)
                if rc != 0:
                    raise RuntimeError(f"split-K launch failed: {rc}")
            times[f"chunks {-(-k // kc)}"] = device_ms(call, 100)
        return times

    decode = np.zeros(E, np.int64)
    for _ in range(4):
        decode[rng.choice(E, TOPK, replace=False)] += 1
    p = rng.dirichlet(np.full(E, 2.0))
    prefill = rng.multinomial(32_768 * TOPK, p)
    out = {}
    for k, n, name in ((D, D_FF, "gate"), (D_FF, D, "down")):
        w = (torch.randn(E, k, n, device=dev) * k ** -0.5).to(bf16)
        for shape, sizes in (("decode", decode), ("prefill", prefill)):
            x = torch.randn(int(sizes.sum()), k, device=dev).to(bf16)
            offs = offsets(sizes)

            def call():
                return gm.gmm(x, w, offs, out_dtype=bf16)
            key = f"{shape} {name}"
            if shape == "decode":
                out[key] = {"host_ms": ab_harness.host_ms(call),
                            "device_ms": device_ms(call, 100)}
                if hasattr(gm, "splitk_plan"):
                    out[key + " chunks"] = chunk_sweep(gm, x, w, offs)
            else:
                out[key] = {"device_ms": device_ms(call, 5)}
            del x
        del w
        if hasattr(gm, "tgmm"):
            train = rng.multinomial(8_192 * TOPK, p)
            x = torch.randn(int(train.sum()), k, device=dev).to(bf16)
            dy = torch.randn(int(train.sum()), n, device=dev).to(bf16)
            offs = offsets(train)

            def grad_call():
                return gm.tgmm(x, dy, offs, out_dtype=bf16)
            out[f"train {name} tgmm"] = {"device_ms": device_ms(grad_call,
                                                                10)}
            del x, dy
    return out


if __name__ == "__main__":
    sys.exit(ab_harness.main(sys.argv, __file__, "gmm_ab", child))
