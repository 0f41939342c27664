"""Optimizer substrate: AdamW + schedules (cosine, minicpm's WSD),
global-norm clipping, and int8 gradient compression.

The PyTorch port of ``src/repro/train/optim.py``. The optimizer works on
nested dicts (and lists) of float32 tensors, the parameters, their
gradients and the state alike, and updates them in place under
``torch.no_grad()``: the reference donates its inputs, so in place is its
equivalent, and at full width it saves a second copy of the masters and of
both moments.

Which leaves get weight decay follows the reference's layout, not the
port's: the reference decays a leaf of rank 2 or more (``optim.py:82``),
and stacks every layer's leaves to ``(L, ...)``
(``src/repro/models/transformer.py:79``), so it decays each layer's norm
scales and its q/k/v biases too, but not ``final_norm`` or a hybrid's
unstacked ``shared_attn``. The port keeps one tensor a layer (the items of
a ``"layers"`` list), so a leaf decays when its rank, plus one inside
``"layers"``, is 2 or more (`decays`); a ``"layers"`` dict holds stacked
leaves, as in the reference, and counts as it is.

On a mesh the train step (``train/steps.py``) hands these functions
trees whose leaves are lists of one slice a shard; ``skip`` names the
slices that replicate another (a slice counts once in the global norm),
and each leaf is updated on its own device. The cross-pod error-feedback
all-reduce (`ef_compressed_psum`) runs over one mesh axis, on one value a
shard.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..core import dist


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 1000
    schedule: str = "cosine"          # "cosine" | "wsd" | "const"
    wsd_decay_frac: float = 0.1       # WSD: last 10% decays
    microbatch: int = 0               # >0: grad accumulation chunk size
    grad_compress_pod: bool = False   # int8 EF compression on "pod" axis


def schedule_lr(tc: TrainConfig, step) -> torch.Tensor:
    """LR at ``step`` (a number or a 0-d tensor) as a 0-d float32 tensor on
    the step's device, computed in float32 as the reference does."""
    step = torch.as_tensor(step, dtype=torch.float32)
    one = torch.ones((), dtype=torch.float32, device=step.device)
    warm = torch.minimum(step / max(tc.warmup_steps, 1), one)
    if tc.schedule == "cosine":
        t = ((step - tc.warmup_steps)
             / max(tc.total_steps - tc.warmup_steps, 1)).clamp(0, 1)
        mult = 0.5 * (1 + torch.cos(math.pi * t))
    elif tc.schedule == "wsd":   # warmup-stable-decay (minicpm)
        decay_start = tc.total_steps * (1 - tc.wsd_decay_frac)
        t = ((step - decay_start)
             / max(tc.total_steps - decay_start, 1)).clamp(0, 1)
        mult = torch.where(step < decay_start, one, 0.5 ** (t * 10))
    else:
        mult = one
    return tc.learning_rate * warm * mult


def _leaves(tree, path=()):
    """(path, leaf) pairs in a fixed order: dict keys sorted, as
    ``jax.tree.leaves`` orders them; list items in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def decays(path: tuple, leaf: torch.Tensor) -> bool:
    """Whether the reference decays this leaf: its rank in the reference's
    layout (one more for an unstacked layer leaf, an item of a
    ``"layers"`` list) is 2 or more."""
    stacked = len(path) > 1 and path[0] == "layers" and isinstance(
        path[1], int)
    return leaf.dim() + int(stacked) >= 2


def init_opt_state(params) -> dict:
    """Zero first and second moments shaped like ``params``, and a 0-d
    int32 step, on the params' device."""
    first = next(_leaves(params))[1]
    return {"mu": _map(torch.zeros_like, params),
            "nu": _map(torch.zeros_like, params),
            "step": torch.zeros((), dtype=torch.int32, device=first.device)}


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, skip=frozenset()):
    """Scales ``grads`` in place so that their global L2 norm is at most
    ``max_norm``; returns (grads, the norm before, a 0-d float32 tensor on
    the first leaf's device). Leaves at a path in ``skip`` are scaled but
    not counted (a replica of another slice)."""
    flat = list(_leaves(grads))
    dev = flat[0][1].device
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())).to(dev)
                           for path, g in flat if path not in skip))
    scale = torch.clamp(max_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    for _, g in flat:
        g.mul_(scale.to(g.device))
    return grads, gnorm


@torch.no_grad()
def adamw_update(params, grads, opt_state: dict, tc: TrainConfig,
                 skip=frozenset()):
    """One AdamW step in place on ``params`` and ``opt_state`` (trees of one
    structure; ``grads`` is clipped in place, ``skip`` as
    `clip_by_global_norm` takes it). Returns (params, opt_state, metrics)
    with ``grad_norm`` and ``lr`` as 0-d tensors."""
    grads, gnorm = clip_by_global_norm(grads, tc.grad_clip, skip)
    step = opt_state["step"] + 1
    lr = schedule_lr(tc, step)
    b1, b2 = tc.beta1, tc.beta2
    sf = step.float()
    bc = {step.device: (lr, 1 - b1 ** sf, 1 - b2 ** sf)}
    flat_mu = dict(_leaves(opt_state["mu"]))
    flat_nu = dict(_leaves(opt_state["nu"]))
    flat_g = dict(_leaves(grads))
    for path, p in _leaves(params):
        if p.device not in bc:
            bc[p.device] = tuple(t.to(p.device) for t in bc[step.device])
        lr_d, bc1, bc2 = bc[p.device]
        g = flat_g[path].float()
        mu, nu = flat_mu[path], flat_nu[path]
        mu.mul_(b1).add_((1 - b1) * g)
        nu.mul_(b2).add_((1 - b2) * torch.square(g))
        update = (mu / bc1) / (torch.sqrt(nu / bc2) + tc.eps)
        if decays(path, p):   # decoupled weight decay on matrices only
            update = update + tc.weight_decay * p
        p.sub_(lr_d * update)
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}


# ------------------------------------------------- gradient compression
def compress_int8(g: torch.Tensor):
    """Per-tensor symmetric int8 quantization. Returns (q, scale)."""
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compressed_psum(grads, errors, axis: str, mesh):
    """Error-feedback int8 psum over the mesh axis ``axis`` (the
    low-bandwidth cross-pod link), the reference's as a function over the
    shards: ``grads`` and ``errors`` are trees whose leaves are lists of
    one tensor a shard (in the mesh's order). Each shard quantises its
    gradient plus its residual to int8 with one scale, keeps the new
    residual, and the decompressed values are summed over ``axis`` and
    divided by its size. Returns (mean_grads, new_errors), leaves of the
    same form."""
    n = mesh.shape[axis]

    def one(gs, es):
        gcs = [g.float() + e for g, e in zip(gs, es)]
        sent = [decompress_int8(*compress_int8(gc)) for gc in gcs]
        new_e = [gc - d for gc, d in zip(gcs, sent)]
        total = dist.psum(sent, mesh, axis)
        return [t / n for t in total], new_e

    if isinstance(grads, dict):
        out = {k: ef_compressed_psum(grads[k], errors[k], axis, mesh)
               for k in grads}
        return ({k: v[0] for k, v in out.items()},
                {k: v[1] for k, v in out.items()})
    return one(grads, errors)
