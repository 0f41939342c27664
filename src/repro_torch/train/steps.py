"""Train, prefill and serve steps on one device.

The PyTorch port of ``src/repro/train/steps.py``. `make_train_step` builds
the update: the loss and its gradients by autograd (through the flash
backward kernels and the hot-slab gradient on the card), summed over
microbatches (`TrainConfig.microbatch`) so that the peak activation
footprint is one microbatch, then AdamW in place. The reference jits the
step with GSPMD shardings over a mesh and donates its inputs; here the
step runs eagerly on the model's device and updates the model and the
optimizer state in place. A mesh raises (ROADMAP A8.8).

`make_forward` and `make_serve_step` are thin single-device wrappers of
the model's `forward` and `decode_step`.
"""
from __future__ import annotations

import torch

from ..models.config import ModelConfig
from ..models.transformer import decode_step, forward, loss_fn, param_tree
from .optim import TrainConfig, adamw_update


def _no_mesh(mesh, what: str) -> None:
    if mesh is not None:
        raise NotImplementedError(f"sharded {what} (a mesh): ROADMAP A8.8")


def _microbatches(batch: dict, n: int, i: int) -> dict:
    """Slice ``i`` of ``n`` along the batch, as the reference's
    ``x.reshape(n, -1, ...)[i]``: rows ``i·B/n`` to ``(i+1)·B/n``."""
    return {k: v.reshape(n, -1, *v.shape[1:])[i] for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, tc: TrainConfig, mesh=None):
    """Returns ``step(model, opt_state, batch) -> (model, opt_state,
    metrics)``: the gradient of `loss_fn` over the batch (the mean of the
    microbatches' gradients when ``tc.microbatch`` > 0: summed, then
    divided by their count), one `adamw_update`, and the metrics ``loss``,
    ``ce``, ``aux`` (means over the microbatches), ``grad_norm`` and ``lr``
    as 0-d tensors. ``batch`` holds tensors on the model's device. The
    parameters require gradients only for the step's duration."""
    _no_mesh(mesh, "train step")

    def train_step(model, opt_state, batch):
        if model.cfg != cfg:
            raise ValueError("the model's config is not the step's")
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
            grads = _grad_tree(param_tree(model))
            _, opt_state, om = adamw_update(param_tree(model), grads,
                                            opt_state, tc)
        for p in params:
            p.grad = None
        metrics = {"loss": torch.stack(losses).mean(),
                   "ce": torch.stack(ces).mean(),
                   "aux": torch.stack(auxes).mean(), **om}
        return model, opt_state, metrics

    return train_step


def _grad_tree(tree):
    if isinstance(tree, dict):
        return {k: _grad_tree(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grad_tree(v) for v in tree]
    return tree.grad


def make_forward(cfg: ModelConfig, mesh=None):
    """Prefill forward: ``fwd(model, batch) -> (logits, aux)``."""
    _no_mesh(mesh, "forward")

    def fwd(model, batch):
        return forward(model, batch)

    return fwd


def make_serve_step(cfg: ModelConfig, mesh=None, global_batch: int = 0,
                    max_len: int = 0):
    """One-token decode step: ``serve(model, cache, tokens) -> (logits,
    cache)``; the cache is written in place (`decode_step`)."""
    _no_mesh(mesh, "serve step")

    def serve(model, cache, tokens):
        return decode_step(model, cache, tokens)

    return serve
