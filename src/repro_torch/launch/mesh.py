"""Mesh builders for the LM: the PyTorch port of ``src/repro/launch/mesh.py``.

A mesh is `core.dist.Mesh`: an N-D grid of ``torch.device``s with named
axes (``data``, ``model``, and ``pod`` for the multi-pod layout), one
device a shard, row-major over the axes as a JAX mesh orders its devices.

**Single controller.** One process drives every shard: each shard's
tensors live on its device, and the collectives (`core.dist.all_gather`,
``psum``, ``pmax``) are plain torch functions over the shards' tensors.
Because there is one controller, autograd differentiates through the
collectives directly: an all-gather's backward is the reduce-scatter of
the gradients, a psum's backward hands every input the summed gradient.
There is no ``torch.distributed`` and no process group. Several shards
may share one device (four shards on one card); they then share the
results of a collective.

``device=None`` (or ``"cuda"``) spreads the shards round-robin over the
visible cards; a named device (``"cuda:0"``, ``"cpu"``) holds every
shard. A missing card raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dist import Mesh, shard_devices


def make_mesh(shape, axes, device: str | torch.device | None = None) -> Mesh:
    """A mesh of ``prod(shape)`` shards with axes ``axes``."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes) or min(shape, default=1) < 1:
        raise ValueError(f"mesh shape {shape} for axes {axes}")
    return Mesh(shard_devices(int(np.prod(shape)), device), axes, shape)


def make_production_mesh(*, multi_pod: bool = False,
                         device: str | torch.device | None = None) -> Mesh:
    """16×16 single-pod (256 shards) or 2×16×16 multi-pod (512 shards).

    Without ``device`` this needs 256 or 512 cards and raises on fewer,
    as a missing card does; a named device holds every shard (the specs'
    tests build it on ``"cpu"``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    dev = None if device is None else torch.device(device)
    if dev is None or (dev.type == "cuda" and dev.index is None):
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if count < n:
            raise RuntimeError(f"the production mesh needs {n} cards, "
                               f"{count} visible; name one device to put "
                               "every shard on it")
    return make_mesh(shape, axes, device)


def make_host_mesh(device: str | torch.device | None = None) -> Mesh:
    """Degenerate 1×1 ``(data, model)`` mesh on one device: a step built on
    it computes what the step without a mesh computes, bit for bit."""
    return make_mesh((1, 1), ("data", "model"), device)
