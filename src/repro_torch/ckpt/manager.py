"""Fault-tolerant checkpoint manager.

The PyTorch port of ``src/repro/ckpt/manager.py``, in the same format, so
that each package restores the other's checkpoints:

* **Shard files**: a step's state is written as ``host_<id>.npz`` with the
  tree's ``/`` paths stored as ``|`` keys, into ``step_<n>.tmp/``.
* **Atomic commit**: ``MANIFEST.json`` is written last and the directory
  is then renamed to ``step_<n>/``; readers ignore uncommitted
  directories, so a failure mid-save never corrupts the restore point.
* **Async save**: a background thread writes the files, one save deep
  (the next save waits for the one in flight). The port updates its
  tensors in place, so `CheckpointManager.save` copies every leaf to host
  memory on the caller's thread (``.detach().to("cpu", copy=True)``, which
  waits for the card) before it returns; the reference relies on
  ``jax.device_get``'s copies for the same.
* **keep-k GC**: committed steps beyond ``keep`` are deleted after a
  successful commit, never before.

* **Elastic restore**: a save holds the *global* arrays (a sharded
  leaf, ``launch.shardings.ShardedTensor``, is gathered whole first), and
  ``restore(shardings=)`` cuts each onto the mesh and spec of its
  ``NamedSharding`` (``launch.shardings.to_named``), so a state saved
  from one mesh restores onto another; ``device=`` puts the restored
  leaves on one device, as tensors of their stored dtypes.
"""
from __future__ import annotations

import json
import pathlib
import shutil
import threading
import time

import numpy as np
import torch


def _flatten(tree, prefix=""):
    """dict-of-dicts -> {path: leaf}; path uses '/' separators."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: dict):
    root: dict = {}
    for path, leaf in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf
    return root


def _to_host(v) -> np.ndarray:
    """A tensor as a host copy that later in-place updates cannot reach;
    anything else as ``np.asarray`` takes it, as in the reference."""
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", copy=True).numpy()
    if hasattr(v, "full"):     # a ShardedTensor: its global array
        return v.full("cpu").numpy()
    return np.asarray(v)


class CheckpointManager:
    def __init__(self, directory, *, keep: int = 3, host_id: int = 0,
                 num_hosts: int = 1, async_save: bool = True):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.host_id = host_id
        self.num_hosts = num_hosts
        self.async_save = async_save
        self._inflight: threading.Thread | None = None

    # ------------------------------------------------------------- save
    def save(self, step: int, state: dict, blocking: bool = False):
        """Snapshot ``state`` (nested dicts of tensors, numpy arrays or
        numbers) at ``step``."""
        self.wait()  # one-deep async pipeline
        # snapshot on the caller thread: the tensors are updated in place
        flat = {k: _to_host(v) for k, v in _flatten(state).items()}
        if self.async_save and not blocking:
            self._inflight = threading.Thread(
                target=self._write, args=(step, flat), daemon=True)
            self._inflight.start()
        else:
            self._write(step, flat)

    def _write(self, step: int, flat: dict):
        tmp = self.dir / f"step_{step:08d}.tmp"
        final = self.dir / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        shard_file = tmp / f"host_{self.host_id:05d}.npz"
        np.savez(shard_file, **{k.replace("/", "|"): v
                                for k, v in flat.items()})
        manifest = {
            "step": step,
            "num_hosts": self.num_hosts,
            "keys": sorted(flat.keys()),
            "time": time.time(),
        }
        (tmp / "MANIFEST.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        tmp.rename(final)          # atomic commit
        self._gc()

    def wait(self):
        if self._inflight is not None:
            self._inflight.join()
            self._inflight = None

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for p in sorted(self.dir.glob("step_*")):
            if p.suffix == ".tmp" or not (p / "MANIFEST.json").exists():
                continue  # uncommitted — ignore (fault tolerance)
            out.append(int(p.name.split("_")[1]))
        return out

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int | None = None, shardings=None,
                device: str | torch.device | None = None):
        """Load a committed step (the latest by default): (step, tree) with
        numpy leaves, or tensors on ``device`` when it is given, or, with
        ``shardings`` (a tree of ``NamedSharding`` of the checkpoint's
        structure), ``ShardedTensor``s cut by each leaf's spec onto its
        mesh: the elastic-restart path. (None, None) when nothing is
        committed."""
        if step is None:
            step = self.latest_step()
            if step is None:
                return None, None
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "MANIFEST.json").read_text())
        flat: dict = {}
        for shard_file in sorted(d.glob("host_*.npz")):
            with np.load(shard_file) as z:
                for k in z.files:
                    flat[k.replace("|", "/")] = z[k]
        missing = set(manifest["keys"]) - set(flat)
        if missing:
            raise FileNotFoundError(
                f"checkpoint step {step} incomplete: missing {missing}")
        if shardings is not None:
            from ..launch.shardings import shard_leaf
            named = _flatten(shardings)
            if set(named) != set(flat):
                raise ValueError(
                    "the shardings' tree is not the checkpoint's: "
                    f"{sorted(set(named) ^ set(flat))[:4]}")
            flat = {k: shard_leaf(v, named[k].spec, named[k].mesh)
                    for k, v in flat.items()}
        elif device is not None:
            flat = {k: torch.from_numpy(v).to(device)
                    for k, v in flat.items()}
        return step, _unflatten(flat)
