"""How chaotic rwkv6-3b's bf16 gradients are at full width and random
weights, on the port alone.

Run on the CPU, from the root of the repo::

    PYTHONPATH=src python grad_witness.py

rwkv6-3b at full width, cut to 1 and to 2 layers (``launch.train.
cut_depth``), weights from ``init_params`` on a ``torch.Generator`` seeded
as ``chip_smoke.py`` seeds it, one sequence of 512 corpus tokens through
the vocab LOrder: the inputs of ``chip_smoke.train_card_vs_cpu``. For
each depth and compute dtype (bf16, the model's; float32, every module's
``COMPUTE_DTYPE`` switched) it prints how far the gradients move, leaf by
leaf in relative L2, when every weight is multiplied by ``1 + 1e-6
N(0, 1)``: a perturbation below a bf16 unit, which moves a few roundings;
and how far the bf16 gradients lie from the float32 ones on the same
weights, the most that roundings alone can move them. Then, at 2 layers in bf16, the share of layer 0's ``u_bonus`` gradient
that comes from position 0 and the gradient of the time-mix output there
against the median position's.

At position 0 the time-mix output is exactly zero at init (no carried
state, ``u_bonus`` zero), so its per-head group norm divides by the
square root of its epsilon, and the residual stream there keeps the
embedding's small variance, which the next norm divides by. The gradient
that flows back through position 0 is many times the other positions',
and the bf16 roundings along it decide it. About 2 minutes and 4 GB on
a CPU.
"""
from __future__ import annotations

import copy
import dataclasses
import pathlib
import sys

import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))
import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.train import cut_depth  # noqa: E402
from repro_torch.models import rwkv6  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    Transformer, init_params, param_tree)

EPS = 1e-6


def _moved(host, batch) -> tuple[str, float, float]:
    """(worst leaf, its relative L2 move, the median leaf's move) when every
    weight of ``host`` is multiplied by 1 + EPS N(0, 1)."""
    _, want = cs.loss_and_grads(host, batch)
    shaken = copy.deepcopy(host)
    gen = torch.Generator().manual_seed(cs.SEED)
    with torch.no_grad():
        for p in shaken.parameters():
            p.mul_(1 + EPS * torch.randn(p.shape, generator=gen))
    _, got = cs.loss_and_grads(shaken, batch)
    rel = cs.leaf_errors(got, want)
    worst = max(rel, key=rel.get)
    return worst, rel[worst], sorted(rel.values())[len(rel) // 2]


def _position_zero(host, batch) -> tuple[float, float]:
    """(position 0's share of layer 0's ``u_bonus`` gradient norm, the
    norm of the loss's gradient on layer 0's wkv output at position 0
    over the median position's)."""
    seen = []
    scan = rwkv6._wkv_chunked

    def record(r, k, v, logw, u, h, dh, chunk=rwkv6.WKV_CHUNK):
        y, s = scan(r, k, v, logw, u, h, dh, chunk)
        if not seen:
            rec = {"rkv": (r.detach(), k.detach(), v.detach()), "h": h}
            seen.append(rec)
            y.register_hook(lambda g: rec.__setitem__("g", g.detach()))
        return y, s

    rwkv6._wkv_chunked = record
    try:
        cs.loss_and_grads(Transformer(dataclasses.replace(
            host.cfg, remat=False), param_tree(host)), batch)
    finally:
        rwkv6._wkv_chunked = scan
    rec = seen[0]
    h = rec["h"]
    t = rec["g"].shape[1]
    r, k, v = (a[0].reshape(t, h, -1) for a in rec["rkv"])
    g = rec["g"][0].reshape(t, h, -1)
    per_position = r * k * (g * v).sum(-1, keepdim=True)
    total = float(per_position.sum(0).norm())
    share = float(per_position[0].norm()) / max(total, 1e-30)
    norms = g.reshape(t, -1).norm(dim=1)
    return share, float(norms[0] / norms.median())


def main() -> None:
    full = get_config(cs.RWKV_ARCH)
    for layers in (1, 2):
        cfg = cut_depth(full, layers)
        host = init_params(cfg, torch.Generator().manual_seed(cs.SEED),
                           "cpu")
        batch = cs.lm_batch(cfg, cs.token_source(cfg, 512), 1, 512)
        grads = {}
        for name, dtype in (("bf16", torch.bfloat16),
                            ("float32", torch.float32)):
            with cs.compute_dtype(dtype):
                worst, top, median = _moved(host, batch)
                grads[name] = cs.loss_and_grads(host, batch)[1]
            print(f"{cfg.name} at {layers} layer(s), {name}: weights x (1 + "
                  f"{EPS:g} N(0, 1)) move the gradients by up to {top:.3e} "
                  f"({worst}), the median leaf by {median:.3e}", flush=True)
        rel = cs.leaf_errors(grads["bf16"], grads["float32"])
        worst = max(rel, key=rel.get)
        print(f"{cfg.name} at {layers} layer(s): bf16 against float32 "
              f"gradients up to {rel[worst]:.3e} ({worst}), the median leaf "
              f"{sorted(rel.values())[len(rel) // 2]:.3e}", flush=True)
        if layers == 2:
            share, ratio = _position_zero(host, batch)
            print(f"{cfg.name} at 2 layers, bf16: position 0 gives "
                  f"{100 * share:.1f}% of layer 0's u_bonus gradient norm; "
                  f"the loss's gradient on layer 0's wkv output there is "
                  f"{ratio:.3g}x the median position's")


if __name__ == "__main__":
    main()
