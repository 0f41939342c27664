"""End-to-end training driver: data → train step → checkpoints.

The PyTorch port of ``src/repro/launch/train.py``, on one device (the
card unless ``--device`` names another):

* checkpoint/restart (atomic, async, keep-k) via ``ckpt.CheckpointManager``
  in the reference's format (params and AdamW moments with the layer
  leaves stacked to ``(L, ...)``) — ``--resume`` restores the latest
  committed step, including after a crash mid-save;
* straggler monitor — per-step wall-time EWMA; steps slower than
  ``threshold × ewma`` are logged;
* vocab-LOrder preprocessing — when the arch enables it, the permutation
  is computed from a corpus sample before step 0 and applied to the
  embedding rows and to the host token stream.

The step is built on ``make_host_mesh()``, as the reference's is: a
one-shard mesh on the run's device, whose step is the single-device one
(a sharded run goes through ``train.steps.make_train_step`` on a larger
mesh, and ``CheckpointManager.restore(shardings=)`` restores a save onto
it). Embedding-fed archs are refused, as in the reference.
Beside the reference's flags: ``--device``; ``--depth N``, the full
width with the depth cut to N layers (the reference's ``--layers`` cuts
the smoke config only); and ``--no-final-ckpt``, which skips the save
the reference always makes at the end (only ``--ckpt-every``'s periodic
saves are written), for runs whose last state nobody restores.

Usage:
  python -m repro_torch.launch.train --arch qwen2.5-3b --smoke --device cpu
  python -m repro_torch.launch.train --arch qwen2.5-3b --smoke --resume
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import numpy as np
import torch


@dataclasses.dataclass
class StragglerMonitor:
    """EWMA step-time tracker; flags slow steps (fleet: triggers re-slice)."""
    alpha: float = 0.1
    threshold: float = 2.0
    ewma: float | None = None
    flagged: int = 0

    def observe(self, dt: float) -> bool:
        slow = self.ewma is not None and dt > self.threshold * self.ewma
        self.ewma = dt if self.ewma is None else \
            (1 - self.alpha) * self.ewma + self.alpha * dt
        if slow:
            self.flagged += 1
        return slow


def build_vocab_reorder(cfg, dc):
    """Paper preprocessing: LOrder over the corpus co-occurrence graph."""
    from ..data.pipeline import corpus_sample
    from ..locality.vocab import hot_coverage, vocab_permutation
    sample = corpus_sample(dc, num_batches=1)
    vr = vocab_permutation(sample, cfg.vocab_size,
                           hot_fraction=cfg.hot_vocab_fraction or 0.05)
    cov = hot_coverage(sample, vr)
    print(f"[vocab-lorder] hot slab {vr.hot_size} rows "
          f"({100 * vr.hot_size / cfg.vocab_size:.1f}% of vocab) covers "
          f"{100 * cov:.1f}% of corpus tokens")
    return vr


def cut_depth(cfg, layers: int):
    """``cfg`` at full width with its depth cut to ``layers``; a hybrid
    keeps its shared block on the last layer, as ``smoke_config`` cuts."""
    pattern = cfg.block_pattern[:layers]
    if "shared_attn" in cfg.block_pattern and "shared_attn" not in pattern:
        pattern = pattern[:-1] + ("shared_attn",)
    return dataclasses.replace(cfg, num_layers=layers, block_pattern=pattern)


def train_state(model, opt_state: dict) -> dict:
    """The checkpoint's tree: params and AdamW moments in the reference's
    layout (host copies, layer leaves stacked), and the step."""
    from ..models.transformer import stack_layers, to_jax_params
    return {"params": to_jax_params(model),
            "opt": {"mu": stack_layers(opt_state["mu"]),
                    "nu": stack_layers(opt_state["nu"]),
                    "step": opt_state["step"]}}


def load_state(cfg, state: dict, device):
    """`train_state` reversed: (model, opt_state) on ``device``."""
    from ..models.transformer import from_jax_params, unstack_layers
    model = from_jax_params(cfg, state["params"], device)
    opt = state["opt"]
    return model, {
        "mu": unstack_layers(opt["mu"], cfg.num_layers, device),
        "nu": unstack_layers(opt["nu"], cfg.num_layers, device),
        "step": torch.as_tensor(np.asarray(opt["step"]),
                                dtype=torch.int32).to(device)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-scale ~100M-class trunk)")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--depth", type=int, default=0,
                    help="full width, depth cut to this many layers")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--schedule", default="cosine",
                    choices=("cosine", "wsd", "const"))
    ap.add_argument("--total-steps", type=int, default=0,
                    help="schedule horizon (defaults to --steps); pin it "
                         "when resuming so the LR curve is invariant")
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--no-final-ckpt", action="store_true",
                    help="save no checkpoint at the end of the run")
    ap.add_argument("--no-vocab-reorder", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from ..ckpt.manager import CheckpointManager
    from ..configs import get_config, smoke_config
    from ..data.pipeline import DataConfig, DataLoader
    from ..device import resolve_device
    from ..launch.mesh import make_host_mesh
    from ..locality import applies_to
    from ..models.transformer import init_params, param_tree
    from ..train.optim import TrainConfig, init_opt_state
    from ..train.steps import make_train_step

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch, layers=args.layers) if args.smoke \
        else get_config(args.arch)
    if args.depth and not args.smoke:
        cfg = cut_depth(cfg, args.depth)
    if cfg.input_mode != "tokens":
        raise SystemExit(f"{args.arch} is embedding-fed (stub frontend); "
                         "use examples/audio_encoder.py instead")
    total = args.total_steps or args.steps
    tc = TrainConfig(learning_rate=args.lr, total_steps=total,
                     warmup_steps=max(1, total // 10),
                     schedule=args.schedule,
                     microbatch=args.microbatch)

    seq = args.seq_len - (cfg.prefix_tokens or 0)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                    global_batch=args.global_batch)

    feats = applies_to(cfg)
    vocab_reorder = None
    if feats["vocab_reorder"] and not args.no_vocab_reorder:
        vocab_reorder = build_vocab_reorder(cfg, dc)

    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    if vocab_reorder is not None:
        vocab_reorder.apply_to_params(model)
    opt_state = init_opt_state(param_tree(model))

    ckpt = CheckpointManager(args.ckpt_dir, keep=3)
    start_step = 0
    if args.resume:
        step_found, state = ckpt.restore()
        if state is not None:
            model, opt_state = load_state(cfg, state, dev)
            start_step = step_found + 1
            print(f"[ckpt] resumed from step {step_found}")

    step_fn = make_train_step(cfg, tc, make_host_mesh(dev))
    loader = DataLoader(dc, vocab_reorder, start_step=start_step)
    monitor = StragglerMonitor()

    losses = []
    try:
        for step in range(start_step, args.steps):
            host = next(loader)
            batch = {"tokens": torch.from_numpy(host["tokens"]).to(dev)}
            if cfg.prefix_tokens:
                batch["prefix"] = torch.zeros(
                    (args.global_batch, cfg.prefix_tokens, cfg.d_model),
                    dtype=torch.bfloat16, device=dev)
            t0 = time.time()
            model, opt_state, metrics = step_fn(model, opt_state, batch)
            loss = float(metrics["loss"])
            dt = time.time() - t0
            if monitor.observe(dt):
                print(f"[straggler] step {step} took {dt:.2f}s "
                      f"(ewma {monitor.ewma:.2f}s)")
            losses.append(loss)
            if step % args.log_every == 0 or step == args.steps - 1:
                print(f"step {step:5d} loss {loss:.4f} "
                      f"gnorm {float(metrics['grad_norm']):.3f} "
                      f"lr {float(metrics['lr']):.2e} {dt:.2f}s", flush=True)
            if args.ckpt_every and (step + 1) % args.ckpt_every == 0:
                ckpt.save(step, train_state(model, opt_state))
    finally:
        loader.close()
        ckpt.wait()

    if not args.no_final_ckpt:
        t0 = time.time()
        ckpt.save(args.steps - 1, train_state(model, opt_state),
                  blocking=True)
        final = ckpt.dir / f"step_{args.steps - 1:08d}"
        size = sum(p.stat().st_size for p in final.iterdir())
        print(f"[ckpt] saved step {args.steps - 1}: {size} bytes in "
              f"{time.time() - t0:.2f} s")
    first = np.mean(losses[:5]) if len(losses) >= 5 else losses[0]
    last = np.mean(losses[-5:])
    print(f"[done] loss {first:.4f} -> {last:.4f} "
          f"({len(losses)} steps, {monitor.flagged} straggler flags)")
    return losses


if __name__ == "__main__":
    main()
