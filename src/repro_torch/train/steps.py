"""Train, prefill and serve steps, on one device or on a mesh.

The PyTorch port of ``src/repro/train/steps.py``. `make_train_step` builds
the update: the loss and its gradients by autograd (through the flash
backward kernels and the hot-slab gradient on the card), summed over
microbatches (`TrainConfig.microbatch`) so that the peak activation
footprint is one microbatch, then AdamW in place. The reference jits the
step with GSPMD shardings over a mesh and donates its inputs; here the
step runs eagerly and updates the model and the optimizer state in place.

On a mesh (a `models.transformer.ShardedModel`, its optimizer state cut
by `opt_state_specs` with ``launch.shardings.shard_tree``) the step is
FSDP with tensor parallelism: the parameters and both moments are stored
as the specs give them (ZeRO-3 over ``data``, split over ``model``); the
forward gathers the FSDP slices per layer and autograd reduce-scatters
their gradients back; a slice that several shards replicate sums its
replicas' gradients (the all-reduce over the axes its spec leaves out),
and the global gradient norm counts each unique slice once. The global
batch is cut into microbatches of contiguous rows first and each
microbatch is then split over the data axes, as the reference's scan
over microbatches meets GSPMD's split: the rows that meet in one data
shard, and so the rows the MoE's capacity drops, are the reference's.

`make_forward` and `make_serve_step` are thin wrappers of the model's
`forward` and `decode_step`; on a mesh they expect the serving layout
(``param_specs(serve=True)``, the cache by ``cache_specs``). With a mesh,
each returned function carries its specs (``pspecs``, and ``cspecs`` for
the serve step), as the reference returns them.
"""
from __future__ import annotations

import torch

from ..core import dist
from ..core.dist import Mesh
from ..launch.shardings import (P, cache_specs, param_specs)
from ..models.config import ModelConfig
from ..models.transformer import (ShardedModel, _sharded, decode_step,
                                  forward, loss_fn, param_tree)
from .optim import TrainConfig, adamw_update


def opt_state_specs(pspecs):
    return {"mu": pspecs, "nu": pspecs, "step": P()}


def init_sharded_opt_state(sm: ShardedModel) -> dict:
    """Zero AdamW moments laid out as ``sm``'s params (`opt_state_specs`),
    made shard by shard, and a zero step on every shard."""
    from ..launch.shardings import ShardedTensor, shard_leaf

    def zeros(tree):
        if isinstance(tree, dict):
            return {k: zeros(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [zeros(v) for v in tree]
        return ShardedTensor([torch.zeros_like(t) for t in tree.shards],
                             tree.spec, tree.mesh, tree.shape)
    return {"mu": zeros(sm.params), "nu": zeros(sm.params),
            "step": shard_leaf(torch.zeros((), dtype=torch.int32), P(),
                               sm.mesh)}


def _check_mesh(mesh) -> None:
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"a mesh is a core.dist.Mesh (launch/mesh.py), "
                        f"not {type(mesh).__name__}")


def _microbatches(batch: dict, n: int, i: int) -> dict:
    """Slice ``i`` of ``n`` along the batch, as the reference's
    ``x.reshape(n, -1, ...)[i]``: rows ``i·B/n`` to ``(i+1)·B/n``."""
    return {k: v.reshape(n, -1, *v.shape[1:])[i] for k, v in batch.items()}


def _grads(cfg: ModelConfig, tc: TrainConfig, model, batch: dict):
    """The loss over ``batch`` backpropagated into each parameter's
    ``.grad`` (zeros where the loss does not reach), divided by the
    number of microbatches; returns the metrics' means."""
    params = list(model.parameters())
    some = next(iter(batch.values()))
    n = some.shape[0] // tc.microbatch if tc.microbatch > 0 else 1
    losses, ces, auxes = [], [], []
    try:
        for p in params:
            p.grad = None
            p.requires_grad_(True)
        with torch.enable_grad():
            for i in range(n):
                mb = _microbatches(batch, n, i) if n > 1 else batch
                loss, metrics = loss_fn(model, mb)
                loss.backward()
                losses.append(loss.detach())
                ces.append(metrics["ce"].detach())
                auxes.append(metrics["aux"].detach())
    finally:
        for p in params:
            p.requires_grad_(False)
    with torch.no_grad():
        for p in params:
            if p.grad is None:   # a leaf the loss did not reach
                p.grad = torch.zeros_like(p)
            elif n > 1:
                p.grad.div_(n)
    dev = losses[0].device
    return {"loss": torch.stack(losses).mean(),
            "ce": torch.stack(ces).mean(),
            "aux": torch.stack([a.to(dev) for a in auxes]).mean()}


def make_train_step(cfg: ModelConfig, tc: TrainConfig, mesh=None):
    """Returns ``step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: the gradient of `loss_fn` over the batch (the mean of the
    microbatches' gradients when ``tc.microbatch`` > 0: summed, then
    divided by their count), one `adamw_update`, and the metrics ``loss``,
    ``ce``, ``aux`` (means over the microbatches), ``grad_norm`` and ``lr``
    as 0-d tensors. ``batch`` holds the global batch's tensors (on the
    model's device, or the mesh's home). The parameters require gradients
    only for the step's duration.

    ``model`` is a `Transformer` (no mesh, or a one-shard mesh such as
    ``make_host_mesh()``) or a `ShardedModel` on ``mesh`` with its
    optimizer state laid out by `opt_state_specs` (the step's ``pspecs``
    are ``param_specs(cfg, mesh)``)."""
    _check_mesh(mesh)

    def train_step(model, opt_state, batch):
        if model.cfg != cfg:
            raise ValueError("the model's config is not the step's")
        if _sharded(model, mesh):
            return apply_sharded(model, opt_state,
                                 sharded_grads(model, batch, tc), tc)
        return apply(model, opt_state, _grads(cfg, tc, model, batch), tc)

    if mesh is not None:
        train_step.pspecs = param_specs(cfg, mesh)
    return train_step


def apply(model, opt_state: dict, metrics: dict, tc: TrainConfig):
    """AdamW on one device from the gradients in the params' ``.grad``
    (`_grads`); the gradients are cleared. Returns the step's triple."""
    with torch.no_grad():
        grads = _grad_tree(param_tree(model))
        _, opt_state, om = adamw_update(param_tree(model), grads,
                                        opt_state, tc)
    for p in model.parameters():
        p.grad = None
    return model, opt_state, {**metrics, **om}


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grad_tree(v) for v in tree]
    return tree.grad


def _shard_lists(tree):
    """A tree of `ShardedTensor`s as one of lists of their shards."""
    if isinstance(tree, dict):
        return {k: _shard_lists(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shard_lists(v) for v in tree]
    return list(tree.shards)


def _replicas(tree, path=()):
    """(path, shard) of each slice that replicates another's."""
    if isinstance(tree, dict):
        for k in tree:
            yield from _replicas(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _replicas(v, path + (i,))
    else:
        for i in range(tree.mesh.size):
            if not tree.is_representative(i):
                yield path + (i,)


def sharded_grads(sm: ShardedModel, batch: dict, tc: TrainConfig) -> dict:
    """The train step's gradients on a mesh, in each shard tensor's
    ``.grad``: the microbatches' mean, each slice that several shards
    replicate summed over its replicas (the all-reduce over the axes its
    spec leaves out). Returns the metrics (``loss``, ``ce``, ``aux``)."""
    mesh = sm.mesh
    metrics = _grads(sm.cfg, tc, sm, batch)
    with torch.no_grad():
        for st in sm.leaves():
            rep = tuple(a for a in mesh.axis_names
                        if a not in st.axes() and mesh.shape[a] > 1)
            if rep:
                total = dist.psum([t.grad for t in st.shards], mesh, rep)
                for t, g in zip(st.shards, total):
                    t.grad.copy_(g)
    return metrics


def apply_sharded(sm: ShardedModel, opt_state: dict, metrics: dict,
                  tc: TrainConfig):
    """AdamW on a mesh from the gradients `sharded_grads` left, the global
    norm over each unique slice once; the gradients are cleared."""
    with torch.no_grad():
        params = _shard_lists(sm.params)
        state = {"mu": _shard_lists(opt_state["mu"]),
                 "nu": _shard_lists(opt_state["nu"]),
                 "step": opt_state["step"].shards[0]}
        _, state, om = adamw_update(params, _grad_tree(params), state, tc,
                                    skip=frozenset(_replicas(sm.params)))
        for t in opt_state["step"].shards:
            t.copy_(state["step"])
    for p in sm.parameters():
        p.grad = None
    return sm, opt_state, {**metrics, **om}


def make_forward(cfg: ModelConfig, mesh=None):
    """Prefill forward: ``fwd(model, batch) -> (logits, aux)``; on a mesh
    the model is a `ShardedModel` in the serving layout (``fwd.pspecs``)."""
    _check_mesh(mesh)

    def fwd(model, batch):
        return forward(model, batch, mesh)

    if mesh is not None:
        fwd.pspecs = param_specs(cfg, mesh, serve=True)
    return fwd


def make_serve_step(cfg: ModelConfig, mesh=None, global_batch: int = 0,
                    max_len: int = 0):
    """One-token decode step: ``serve(model, cache, tokens) -> (logits,
    cache)``; the cache is written in place (`decode_step`). On a mesh
    the model is a `ShardedModel` in the serving layout (``serve.pspecs``)
    and the cache is laid out by ``serve.cspecs``, ``cache_specs`` at
    ``global_batch`` and ``max_len``."""
    _check_mesh(mesh)

    def serve(model, cache, tokens):
        return decode_step(model, cache, tokens, mesh)

    if mesh is not None:
        serve.pspecs = param_specs(cfg, mesh, serve=True)
        serve.cspecs = cache_specs(cfg, mesh, global_batch, max_len)
    return serve
