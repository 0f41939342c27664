"""Serving driver: the reference's continuous-batching decode loop.

The PyTorch port of ``src/repro/launch/serve.py``, with its semantics kept
as they are:

* **continuous batching** — fixed B decode slots; a finished sequence is
  replaced by the next queued request (its slot of the KV cache zeroed),
  so the batch never drains;
* **prompts through the decode path** — an admitted prompt is fed token by
  token through `decode_step`, with one write offset (``cache["pos"]``,
  ``cache["length"]``) shared by all slots. The reference calls a per-slot
  prefill into the cache its "documented production extension"; it is not
  here either;
* **greedy or temperature sampling**, temperature by the Gumbel-max trick
  on an explicit ``torch.Generator`` (the reference's
  ``jax.random.categorical``; the random numbers differ).

On the card each decode step launches the hot-slab embedding kernel once;
decode attention is the plain chunked version over the cache, as in the
reference, which has no kernel there. Every trunk serves: attention
(K/V cache), RWKV6 (rwkv6-3b: token-shift and wkv states) and the Mamba2
hybrid (zamba2-1.2b: conv and SSD states, plus the shared attention
block's K/V).

Usage:
  python -m repro_torch.launch.serve --arch minicpm-2b --smoke --device cpu
  python -m repro_torch.launch.serve --arch rwkv6-3b --smoke --device cpu
  python -m repro_torch.launch.serve --arch zamba2-1.2b --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from ..device import resolve_device
from ..models.transformer import decode_step, init_cache

# Decode steps run by `serve_loop` since import (or since a caller last
# reset it), the prompt-feeding ones included.
decode_steps = 0


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: list = dataclasses.field(default_factory=list)
    t_enqueue: float = 0.0
    t_first: float | None = None
    t_done: float | None = None


def synthetic_requests(n: int, vocab: int, seed: int = 0,
                       plen: tuple[int, int] = (8, 32),
                       gen: tuple[int, int] = (8, 48)) -> list[Request]:
    rng = np.random.default_rng(seed)
    now = time.time()
    return [
        Request(rid=i,
                prompt=rng.integers(0, vocab,
                                    rng.integers(*plen)).astype(np.int32),
                max_new=int(rng.integers(*gen)), t_enqueue=now)
        for i in range(n)
    ]


def _reset_slot(cache, slot: int, kind: str):
    """Zero one batch slot of the cache (new request admission), in place.

    Every leaf of ``cache["layers"]`` and ``cache["shared"]``, however
    nested (RWKV's ``tm``/``cm``), laid out ``(L, B, ...)`` with ``L != 1``
    is touched, the reference's test, kept as it is (a one-layer model is
    not reset)."""
    def z(x):
        if isinstance(x, dict):
            return {k: z(v) for k, v in x.items()}
        if x.dim() >= 2 and x.shape[0] != 1:
            x[:, slot] = 0
        return x
    out = dict(cache, layers=z(cache["layers"]))
    if "shared" in cache:
        out["shared"] = z(cache["shared"])
    return out


def _sample(lg: torch.Tensor, temperature: float,
            gen: torch.Generator) -> torch.Tensor:
    if temperature <= 0:
        return torch.argmax(lg, dim=-1)
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(lg.shape, generator=gen, device=lg.device).clamp_(tiny, 1)
    return torch.argmax(lg / temperature - torch.log(-torch.log(u)), dim=-1)


def serve_loop(cfg, model, requests: list[Request], batch_slots: int = 4,
               max_len: int = 512, temperature: float = 0.0, seed: int = 0):
    """Continuous-batching loop on the model's device. Returns the
    completed requests, in completion order. Every decode step it runs
    adds one to the module's `decode_steps`."""
    from .mesh import make_host_mesh
    dev = model.device
    mesh = make_host_mesh(dev)             # one shard: the model's device
    queue = list(requests)[::-1]           # pop() takes the oldest
    active: list[Request | None] = [None] * batch_slots
    remaining = [0] * batch_slots
    done: list[Request] = []

    cache = init_cache(cfg, batch_slots, max_len, device=dev)
    tokens = torch.zeros((batch_slots, 1), dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def run_step():
        global decode_steps
        decode_steps += 1
        return decode_step(model, cache, tokens, mesh)

    def admit(slot: int):
        nonlocal cache
        req = queue.pop()
        cache = _reset_slot(cache, slot, "any")
        # feed the prompt through decode steps; the other slots step too,
        # on their current token, as in the reference
        for tok in req.prompt:
            tokens[slot, 0] = int(tok)
            _, cache = run_step()
        active[slot] = req
        remaining[slot] = req.max_new
        req.t_first = None

    steps = 0
    while queue or any(a is not None for a in active):
        for s in range(batch_slots):
            if active[s] is None and queue:
                admit(s)
        logits, cache = run_step()
        nxt = _sample(logits[:, -1].float(), temperature, gen)
        tokens = nxt[:, None].to(torch.int32)
        nxt_host = nxt.tolist()         # waits for the step to finish
        now = time.time()
        for s in range(batch_slots):
            req = active[s]
            if req is None:
                continue
            if req.t_first is None:
                req.t_first = now
            req.out.append(int(nxt_host[s]))
            remaining[s] -= 1
            if remaining[s] <= 0:
                req.t_done = now
                done.append(req)
                active[s] = None
        steps += 1
        if steps * batch_slots > 100_000:
            raise RuntimeError("serve loop runaway")
    return done


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    from ..configs import get_config, smoke_config
    from ..models.layers import flash_eligible
    from ..models.transformer import init_params

    cfg = smoke_config(args.arch, layers=args.layers) if args.smoke \
        else get_config(args.arch)
    if cfg.is_encoder:
        raise SystemExit("encoder-only arch has no decode step")
    dev = resolve_device(args.device)
    # a head dim the flash kernel lacks is refused on the card before any
    # work, as `forward` refuses it
    flash_eligible(cfg, dev)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    reqs = synthetic_requests(args.requests, cfg.vocab_size)
    t0 = time.time()
    done = serve_loop(cfg, model, reqs, batch_slots=args.slots,
                      temperature=args.temperature)
    dt = time.time() - t0
    toks = sum(len(r.out) for r in done)
    print(f"[serve] {len(done)} requests, {toks} tokens in {dt:.1f}s "
          f"({toks / dt:.1f} tok/s aggregate) on {dev}")
    lat = [r.t_done - r.t_enqueue for r in done]
    print(f"[serve] latency p50 {np.percentile(lat, 50):.2f}s "
          f"p95 {np.percentile(lat, 95):.2f}s")
    return done


if __name__ == "__main__":
    main()
