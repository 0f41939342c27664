"""Where an MoE model's two runs part, in the reference and in the port.

Run on the CPU, from the root of the repo::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/moe_routing_witness.py

moonshot-v1-16b-a3b at full width (d 2048, 16 heads of 128, 64 experts
of d_ff 1408, top-6, 2 shared experts), cut to ``--layers`` layers and a
vocabulary of ``--vocab`` rows (the router never sees the vocabulary, and
the logits' spread does not depend on its size), weights from the JAX
package's ``init_params`` (seed 7) carried into the port. One prompt of
``--tokens`` ids goes through, each teacher-forced:

* the reference's ``forward`` against its own ``decode_step``;
* the port's ``forward`` against its own ``decode_step``, as shipped
  (float32 PV in both) and with decode's probabilities rounded to bf16
  before PV (``round_p``), as the reference's chunked attention rounds
  them;
* the port's ``forward`` against the reference's;
* the port's decode replaying its forward's expert choices.

For each pair it prints where the routing parts (layer-positions, the
roots: flips not downstream of an earlier one, and the first run's router
margins there), the largest logit difference, whether
tests/test_models.py's decode standard (rtol/atol 0.15) holds, argmax
agreement, and where the argmax differs, by how much the first run's top
logit leads its logit at the second run's pick.
At the defaults it holds two copies of 5.2 GB of float32 weights (the
reference's and the port's) and runs for several minutes.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as jax_config
from repro.models import moe as JM
from repro.models import transformer as JT
from repro_torch.configs import get_config
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.models.moe import RouteTape

ARCH = "moonshot-v1-16b-a3b"
DECODE_TOL = dict(rtol=0.15, atol=0.15)   # tests/test_models.py


class JaxTape:
    """`RouteTape`'s record for the reference: its ``_route`` reports each
    call's sorted expert ids and router margins through a host callback."""

    def __init__(self):
        self.experts, self.margins = [], []

    def __enter__(self):
        self._real = real = JM._route

        def route(p, x, cfg):
            experts, gates, aux = real(p, x, cfg)
            probs = jax.nn.softmax(jnp.einsum(
                "td,de->te", x.astype(jnp.float32), p["router"]), axis=-1)
            top = jax.lax.top_k(probs, cfg.experts_per_token + 1)[0]
            jax.debug.callback(self._put, experts, top[:, -2] - top[:, -1],
                               ordered=True)
            return experts, gates, aux
        JM._route = route
        return self

    def _put(self, experts, margins):
        self.experts.append(torch.from_numpy(np.sort(experts, -1)))
        self.margins.append(torch.from_numpy(np.array(margins)))

    def __exit__(self, *exc):
        JM._route = self._real


def by_layer(tape, layers: int, decode: bool) -> torch.Tensor:
    """(layers, n, k) expert ids; a decode step routes one position
    through every layer."""
    e = torch.stack([t.reshape(-1, t.shape[-1]) for t in tape.experts])
    if decode:
        return e.reshape(-1, layers, e.shape[-1]).transpose(0, 1)
    return e


def compare(name, want, got, want_tape, got_experts, layers):
    want_e = by_layer(want_tape, layers, False)
    margins = torch.stack([m.reshape(-1) for m in want_tape.margins])
    differ = (want_e != got_experts).any(-1)                 # (layers, n)
    upto = differ.int().cumsum(1).clamp(max=1)
    roots = differ & ~((upto.cumsum(0) - upto) > 0)
    diff = np.abs(got - want)
    held = diff <= DECODE_TOL["atol"] + DECODE_TOL["rtol"] * np.abs(want)
    pick = got.argmax(-1)
    lead = want.max(-1) - np.take_along_axis(want, pick[..., None], -1)[..., 0]
    row = {
        "pair": name,
        "positions_parted": int(differ.any(0).sum()),
        "layer_positions_parted": int(differ.sum()),
        "root_margins": [float(m) for m in margins[roots]],
        "max_abs_diff": float(diff.max()),
        "positions_within_decode_tol": int(held.all(-1).sum()),
        "decode_tol_holds": bool(held.all()),
        "argmax_agreement": float((pick == want.argmax(-1)).mean()),
        "want_lead_where_argmax_differs": [
            float(v) for v in lead[pick != want.argmax(-1)]],
        "positions": int(want.shape[1]),
    }
    print(json.dumps(row))
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--vocab", type=int, default=32_768)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    cut = dict(num_layers=args.layers, block_pattern=("attn",) * args.layers,
               vocab_size=args.vocab)
    cfg_j = dataclasses.replace(jax_config(ARCH), **cut)
    cfg_t = dataclasses.replace(get_config(ARCH), **cut)
    n, layers = args.tokens, args.layers
    params = JT.init_params(cfg_j, jax.random.PRNGKey(args.seed))
    tokens = np.random.default_rng(args.seed).integers(
        0, args.vocab, (1, n)).astype(np.int32)

    with JaxTape() as jf:
        j_full = np.asarray(JT.forward(params, {"tokens": jnp.asarray(
            tokens)}, cfg_j)[0], np.float32)
    step = jax.jit(lambda p, c, t: JT.decode_step(p, c, t, cfg_j))
    cache, steps = JT.init_cache(cfg_j, 1, n), []
    with JaxTape() as jd:
        for i in range(n):
            lg, cache = step(params, cache, jnp.asarray(tokens[:, i:i + 1]))
            steps.append(np.asarray(lg[:, 0], np.float32))
    j_dec = np.stack(steps, 1)
    model = TT.from_jax_params(cfg_t, jax.tree.map(np.asarray, params),
                               device="cpu")
    del params
    ids = torch.from_numpy(tokens).long()

    def port_forward():
        with torch.no_grad(), RouteTape() as tape:
            out = TT.forward(model, {"tokens": ids})[0].float().numpy()
        return out, tape

    def port_decode(replay=None):
        cache, steps = TT.init_cache(cfg_t, 1, n, device="cpu"), []
        with torch.no_grad(), RouteTape(replay) as tape:
            for i in range(n):
                lg, cache = TT.decode_step(model, cache, ids[:, i:i + 1])
                steps.append(lg[:, 0].float().numpy())
        return np.stack(steps, 1), tape

    t_full, tf = port_forward()
    t_dec, td = port_decode()
    shipped = TL._sdpa_chunked
    TL._sdpa_chunked = lambda *a, **kw: shipped(*a, **{**kw, "round_p": True})
    try:
        b_dec, bd = port_decode()
    finally:
        TL._sdpa_chunked = shipped
    replay = [tf.experts[layer][i:i + 1] for i in range(n)
              for layer in range(layers)]
    r_dec, _ = port_decode(replay)

    rows = [
        compare("reference forward vs reference decode", j_full, j_dec, jf,
                by_layer(jd, layers, True), layers),
        compare("port forward vs port decode", t_full, t_dec, tf,
                by_layer(td, layers, True), layers),
        compare("port forward vs port decode, p rounded to bf16", t_full,
                b_dec, tf, by_layer(bd, layers, True), layers),
        compare("reference forward vs port forward", j_full, t_full, jf,
                by_layer(tf, layers, False), layers),
        compare("port forward vs port decode, the forward's routing "
                "replayed", t_full, r_dec, tf, by_layer(tf, layers, False),
                layers),
    ]
    margins = torch.cat([m.reshape(-1) for m in jf.margins])
    print(json.dumps({
        "config": f"{ARCH} cut to {layers} layers, vocab {args.vocab}",
        "tokens": n, "seed": args.seed,
        "router_margin_median": float(margins.median()),
        "router_margin_share_below_1e-3": float((margins < 1e-3).float()
                                                .mean()),
        "logits_std": float(j_full.std()),
        "logits_max": float(np.abs(j_full).max()),
        "logit_scale": cfg_j.logit_scale,
        "pairs": len(rows)}))


if __name__ == "__main__":
    main()
