"""Sharding rules: param/activation/cache PartitionSpecs per architecture,
and the placement of trees onto a mesh.

The PyTorch port of ``src/repro/launch/shardings.py``. The scheme is the
reference's: megatron-style tensor parallelism on the ``model`` axis
(attention heads / ffn hidden / vocab), ZeRO-3-style FSDP on the ``data``
axis (params and optimizer state sharded, gathered per layer just before
use), pure replication across ``pod`` for params. Dims that do not divide
the axis size fall back to replication (`_maybe`).

`PartitionSpec` is the port's own: a tuple with one entry a dim, each
``None``, an axis name or a tuple of axis names (split over their
product, the first major). The spec functions read only ``mesh.shape``
and ``mesh.axis_names``, so any object with those two serves.

`shard_tree` takes the place of the reference's ``to_named`` plus
``jax.device_put``: it cuts each leaf of a tree by its spec into one
`ShardedTensor`, whose shard ``i`` holds exactly the slice its spec gives
shard ``i`` of the mesh, on that shard's device (a replica of its own
where the spec leaves an axis out). `unshard_tree` is its inverse. A tree
in the port's layout, whose ``"layers"`` is a list of one dict a layer,
takes the reference's stacked layer specs with their leading ``(L,)``
entry dropped.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from ..core.dist import Mesh
from ..models.config import ModelConfig

DP_AXES = ("pod", "data")


class PartitionSpec(tuple):
    """One entry a dim: ``None`` (replicated), an axis name, or a tuple of
    axis names (a tuple of one name is that name, as JAX's spec keeps
    it). Trailing dims a spec does not name are replicated."""

    def __new__(cls, *entries):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: a leaf of the ``shardings=`` tree that
    ``CheckpointManager.restore`` places a checkpoint onto."""
    mesh: Mesh
    spec: PartitionSpec


def _axsize(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        out = 1
        for a in axis:
            out *= mesh.shape.get(a, 1)
        return out
    return mesh.shape.get(axis, 1)


def _maybe(mesh, dim: int, axis):
    """axis if it divides dim (and exists in the mesh), else None."""
    n = _axsize(mesh, axis)
    return axis if (n > 1 and dim % n == 0) else None


def dp_axes(mesh):
    axes = tuple(a for a in DP_AXES if a in mesh.axis_names)
    return axes if axes else (None,)


def param_specs(cfg: ModelConfig, mesh, serve: bool = False):
    """PartitionSpec tree mirroring the reference's ``init_params(cfg)``
    (layer leaves stacked, their leading ``(L,)`` dim never sharded).

    ``serve=True`` drops the ZeRO/FSDP data-axis sharding: training wants
    params sharded over ``data`` (optimizer state scales), but decode
    would re-gather those shards every layer every token; the serving
    layout keeps weights TP-sharded over ``model`` only, replicated across
    ``data``."""
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab_size
    hd, nh, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
    mdl, dat = "model", (None if serve else "data")
    L = None  # stacked leading layer dim: never sharded

    def attn_spec(scanned: bool):
        lead = (L,) if scanned else ()
        s = {
            "wq": P(*lead, _maybe(mesh, d, dat), _maybe(mesh, nh * hd, mdl)),
            "wk": P(*lead, _maybe(mesh, d, dat), _maybe(mesh, nkv * hd, mdl)),
            "wv": P(*lead, _maybe(mesh, d, dat), _maybe(mesh, nkv * hd, mdl)),
            "wo": P(*lead, _maybe(mesh, nh * hd, mdl), _maybe(mesh, d, dat)),
        }
        if cfg.qkv_bias:
            s["bq"] = P(*lead, _maybe(mesh, nh * hd, mdl))
            s["bk"] = P(*lead, _maybe(mesh, nkv * hd, mdl))
            s["bv"] = P(*lead, _maybe(mesh, nkv * hd, mdl))
        if cfg.attn_out_bias:
            s["bo"] = P(*lead, None)
        return s

    def mlp_spec(scanned: bool):
        lead = (L,) if scanned else ()
        if cfg.mlp_type == "swiglu":
            s = {"w_gate": P(*lead, _maybe(mesh, d, dat), _maybe(mesh, f, mdl)),
                 "w_up": P(*lead, _maybe(mesh, d, dat), _maybe(mesh, f, mdl)),
                 "w_down": P(*lead, _maybe(mesh, f, mdl), _maybe(mesh, d, dat))}
        else:
            s = {"w_in": P(*lead, _maybe(mesh, d, dat), _maybe(mesh, f, mdl)),
                 "w_out": P(*lead, _maybe(mesh, f, mdl), _maybe(mesh, d, dat))}
            if cfg.mlp_bias:
                s["b_in"] = P(*lead, _maybe(mesh, f, mdl))
                s["b_out"] = P(*lead, None)
        return s

    def moe_spec():
        # TP-within-expert storage: every model shard holds the F/|model|
        # slice of every expert, the layout the capacity dispatch consumes
        fmdl = _maybe(mesh, f, mdl)
        s = {
            "router": P(L, _maybe(mesh, d, dat), None),
            "w_gate": P(L, None, _maybe(mesh, d, dat), fmdl),
            "w_up": P(L, None, _maybe(mesh, d, dat), fmdl),
            "w_down": P(L, None, fmdl, _maybe(mesh, d, dat)),
        }
        if cfg.num_shared_experts:
            fs = f * cfg.num_shared_experts
            s["shared"] = {
                "w_gate": P(L, _maybe(mesh, d, dat), _maybe(mesh, fs, mdl)),
                "w_up": P(L, _maybe(mesh, d, dat), _maybe(mesh, fs, mdl)),
                "w_down": P(L, _maybe(mesh, fs, mdl), _maybe(mesh, d, dat)),
            }
        return s

    def norm_spec(scanned: bool = True):
        lead = (L,) if scanned else ()
        s = {"scale": P(*lead, None)}
        if cfg.norm_type == "layernorm":
            s["bias"] = P(*lead, None)
        return s

    def mamba_spec():
        di = cfg.d_inner
        return {
            "w_in": P(L, _maybe(mesh, d, dat), None),
            "conv": P(L, None, None),
            "a_log": P(L, None),
            "dt_bias": P(L, None),
            "d_skip": P(L, None),
            "norm_scale": P(L, None),
            "w_out": P(L, _maybe(mesh, di, mdl), _maybe(mesh, d, dat)),
        }

    def rwkv_spec():
        return {
            "mu_base": P(L, None, None),
            "ddl_w1": P(L, _maybe(mesh, d, dat), None),
            "ddl_w2": P(L, None, None, None),
            "wr": P(L, _maybe(mesh, d, dat), _maybe(mesh, d, mdl)),
            "wk": P(L, _maybe(mesh, d, dat), _maybe(mesh, d, mdl)),
            "wv": P(L, _maybe(mesh, d, dat), _maybe(mesh, d, mdl)),
            "wg": P(L, _maybe(mesh, d, dat), _maybe(mesh, d, mdl)),
            "wo": P(L, _maybe(mesh, d, mdl), _maybe(mesh, d, dat)),
            "w_base": P(L, None),
            "dec_w1": P(L, _maybe(mesh, d, dat), None),
            "dec_w2": P(L, None, None),
            "u_bonus": P(L, None, None),
            "ln_scale": P(L, None),
            "cm_mu": P(L, None, None),
            "cm_k": P(L, _maybe(mesh, d, dat), _maybe(mesh, f, mdl)),
            "cm_v": P(L, _maybe(mesh, f, mdl), _maybe(mesh, d, dat)),
            "cm_r": P(L, _maybe(mesh, d, dat), _maybe(mesh, d, mdl)),
        }

    from ..models.transformer import trunk_kind
    kind = trunk_kind(cfg)
    if kind == "attn":
        layer = {"norm1": norm_spec(), "norm2": norm_spec(),
                 "attn": attn_spec(True),
                 "ffn": moe_spec() if cfg.is_moe else mlp_spec(True)}
    elif kind == "rwkv":
        layer = {"norm1": norm_spec(), "norm2": norm_spec(),
                 "rwkv": rwkv_spec()}
    else:
        layer = {"norm1": norm_spec(), "mamba": mamba_spec()}

    specs = {
        "embed": {"table": P(_maybe(mesh, v, mdl), _maybe(mesh, d, dat))},
        "layers": layer,
        "final_norm": norm_spec(scanned=False),
    }
    if not cfg.tie_embeddings:
        specs["embed"]["head"] = P(_maybe(mesh, d, dat), _maybe(mesh, v, mdl))
    if "shared_attn" in cfg.block_pattern:
        specs["shared_attn"] = {
            "norm1": norm_spec(False), "norm2": norm_spec(False),
            "attn": attn_spec(False), "ffn": mlp_spec(False),
        }
    return specs


def batch_specs(cfg: ModelConfig, mesh, global_batch: int):
    """Input batch PartitionSpecs (tokens/embeds/prefix/targets)."""
    dp = dp_axes(mesh)
    bspec = dp if (global_batch % _axsize(mesh, tuple(a for a in dp if a))
                   == 0 and dp != (None,)) else None
    out = {"tokens": P(bspec, None)}
    if cfg.input_mode == "embeddings":
        out = {"embeds": P(bspec, None, None), "targets": P(bspec, None)}
    if cfg.prefix_tokens:
        out["prefix"] = P(bspec, None, None)
    return out


def cache_specs(cfg: ModelConfig, mesh, global_batch: int,
                max_len: int | None = None):
    """KV/state cache PartitionSpecs mirroring ``init_cache(cfg)``.

    When kv heads don't divide the model axis, the cache is sharded on the
    SEQUENCE dim instead (where the length divides it and there is no
    window) and decode runs `layers._decode_attn_seqsharded`; otherwise
    the cache would replicate over ``model``."""
    from ..models.layers import _seq_shards
    from ..models.transformer import trunk_kind
    dp = dp_axes(mesh)
    b_ok = (dp != (None,) and
            global_batch % _axsize(mesh, tuple(a for a in dp if a)) == 0)
    bspec = dp if b_ok else None
    kind = trunk_kind(cfg)
    kv_ax = _maybe(mesh, cfg.num_kv_heads, "model")
    t = max_len if max_len is not None else 0
    seq_ax = "model" if (kv_ax is None and
                         _seq_shards(mesh, cfg, t) > 1) else None
    if kind == "attn":
        layers = {"k": P(None, bspec, seq_ax, kv_ax, None),
                  "v": P(None, bspec, seq_ax, kv_ax, None),
                  "length": P(None)}
    elif kind == "rwkv":
        h = cfg.num_heads
        h_ax = _maybe(mesh, h, "model")
        layers = {"tm": {"shift": P(None, bspec, None),
                         "wkv": P(None, bspec, h_ax, None, None)},
                  "cm": {"shift": P(None, bspec, None)}}
    else:
        h_ax = _maybe(mesh, cfg.ssm_heads, "model")
        layers = {"conv": P(None, bspec, None, None),
                  "ssd": P(None, bspec, h_ax, None, None)}
    specs = {"layers": layers, "pos": P()}
    if "shared_attn" in cfg.block_pattern:
        specs["shared"] = {"k": P(None, bspec, seq_ax, kv_ax, None),
                           "v": P(None, bspec, seq_ax, kv_ax, None),
                           "length": P(None)}
    return specs


def to_named(specs, mesh: Mesh):
    """A spec tree as a tree of `NamedSharding` on ``mesh`` (the
    ``shardings=`` of ``CheckpointManager.restore``)."""
    if isinstance(specs, PartitionSpec):
        return NamedSharding(mesh, specs)
    return {k: to_named(v, mesh) for k, v in specs.items()}


# ------------------------------------------------------------- placement
def _entry_axes(mesh: Mesh, entry) -> tuple[str, ...]:
    """The mesh axes a spec entry splits its dim over (absent ones drop)."""
    if entry is None:
        return ()
    axes = entry if isinstance(entry, tuple) else (entry,)
    return tuple(a for a in axes if a in mesh.axis_names)


def _part(mesh: Mesh, coords: dict, axes: tuple) -> tuple[int, int]:
    """(index, count) of a shard's part along a dim split over ``axes``,
    the first axis major."""
    idx, n = 0, 1
    for a in axes:
        idx = idx * mesh.shape[a] + coords[a]
        n *= mesh.shape[a]
    return idx, n


class ShardedTensor:
    """A global tensor of ``shape`` laid out on ``mesh`` by ``spec``:
    ``shards[i]`` is shard ``i``'s slice, on its device."""

    def __init__(self, shards: list, spec: PartitionSpec, mesh: Mesh,
                 shape: tuple):
        self.shards = list(shards)
        self.spec = PartitionSpec(*spec, *([None] * (len(shape)
                                                     - len(spec))))
        self.mesh = mesh
        self.shape = tuple(shape)

    def __repr__(self):
        return (f"ShardedTensor({self.shape}, {self.spec}, "
                f"{self.mesh.shape})")

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def axes(self) -> set[str]:
        """The mesh axes the spec splits some dim over."""
        return {a for e in self.spec for a in _entry_axes(self.mesh, e)}

    def bounds(self, i: int, dim: int) -> tuple[int, int]:
        """[lo, hi) of the global ``dim`` that shard ``i`` holds."""
        axes = _entry_axes(self.mesh, self.spec[dim])
        idx, n = _part(self.mesh, self.mesh.coords(i), axes)
        per = self.shape[dim] // n
        return idx * per, (idx + 1) * per

    def is_representative(self, i: int) -> bool:
        """Whether shard ``i`` is the first holder of its slice: index 0 on
        every axis the spec leaves out (its replicas sit there)."""
        c = self.mesh.coords(i)
        used = self.axes()
        return all(c[a] == 0 for a in self.mesh.axis_names if a not in used)

    def gather(self, axes=None) -> list[torch.Tensor]:
        """One tensor a shard: its slice gathered over ``axes`` (a name, a
        tuple of names, or None for every axis), each piece taken from the
        shard that agrees with it on every other axis. Shards that would
        gather the same pieces onto one device share one tensor. Autograd
        runs through the gather: each piece's gradient reaches the shard
        that holds it (summed over its users: a reduce-scatter)."""
        mesh = self.mesh
        if axes is None:
            axes = set(mesh.axis_names)
        elif isinstance(axes, str):
            axes = {axes}
        axes = set(axes) & self.axes()
        dims = [j for j, e in enumerate(self.spec)
                if set(_entry_axes(mesh, e)) & axes]
        for j in dims:
            if not set(_entry_axes(mesh, self.spec[j])) <= axes:
                raise ValueError(f"dim {j} of {self.spec} is split over "
                                 f"axes beyond {sorted(axes)}")
        if not dims:
            return list(self.shards)
        from ..core import dist
        if dist.ledger is not None:
            s = self.shards[0]
            n = int(np.prod([mesh.shape[a] for j in dims
                             for a in _entry_axes(mesh, self.spec[j])]))
            dist.ledger.book("all_gather", n, s.numel() * s.element_size())
        index = {tuple(mesh.coords(i).values()): i for i in range(mesh.size)}
        out, done = [], {}
        for i, dev in enumerate(mesh.devices):
            c = mesh.coords(i)
            key = (dev, tuple(v for a, v in c.items() if a not in axes))
            if key not in done:
                done[key] = self._build(c, dims, dev, index)
            out.append(done[key])
        return out

    def _build(self, coords: dict, dims: list, dev, index) -> torch.Tensor:
        if not dims:
            i = index[tuple(coords[a] for a in self.mesh.axis_names)]
            return self.shards[i].to(dev)
        j, rest = dims[0], dims[1:]
        axes = _entry_axes(self.mesh, self.spec[j])
        pieces = [self._build({**coords, **dict(zip(axes, combo))}, rest,
                              dev, index)
                  for combo in itertools.product(
                      *(range(self.mesh.shape[a]) for a in axes))]
        return torch.cat(pieces, dim=j)

    def full(self, device=None) -> torch.Tensor:
        """The global tensor, on ``device`` (shard 0's by default): a
        detached copy that shares no storage with the shards."""
        with torch.no_grad():
            t = self.gather()[0]
        if t.untyped_storage().data_ptr() == \
                self.shards[0].untyped_storage().data_ptr():
            t = t.clone()
        return t if device is None else t.to(device)


def _leaf_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach()
    return torch.from_numpy(np.array(x))


def shard_leaf(x, spec: PartitionSpec, mesh: Mesh) -> ShardedTensor:
    """``x`` (a tensor or an array) cut by ``spec``: shard ``i`` gets a
    contiguous copy of its slice on its device."""
    t = _leaf_tensor(x)
    st = ShardedTensor([], spec, mesh, t.shape)
    for j, e in enumerate(st.spec):
        n = _part(mesh, mesh.coords(0), _entry_axes(mesh, e))[1]
        if t.shape[j] % n:
            raise ValueError(f"dim {j} of {tuple(t.shape)} does not divide "
                             f"into {n} parts ({spec})")
    for i, dev in enumerate(mesh.devices):
        sl = tuple(slice(*st.bounds(i, j)) for j in range(t.dim()))
        st.shards.append(t[sl].to(dev, copy=True).contiguous())
    return st


def _drop_lead(specs):
    """Layer specs for one layer: the stacked ``(L,)`` entry dropped."""
    if isinstance(specs, PartitionSpec):
        if specs and specs[0] is not None:
            raise ValueError(f"a stacked layer dim is sharded: {specs}")
        return PartitionSpec(*specs[1:])
    return {k: _drop_lead(v) for k, v in specs.items()}


def shard_tree(tree, specs, mesh: Mesh):
    """Each leaf of ``tree`` cut by its spec (`shard_leaf`). A list in
    ``tree`` (the port's ``"layers"``) meets one stacked spec dict: each
    item takes it with the leading ``(L,)`` entry dropped."""
    if isinstance(specs, PartitionSpec):
        return shard_leaf(tree, specs, mesh)
    if isinstance(tree, (list, tuple)):
        one = _drop_lead(specs)
        return [shard_tree(item, one, mesh) for item in tree]
    return {k: shard_tree(tree[k], specs[k], mesh) for k in specs}


def unshard_tree(tree, device=None):
    """`shard_tree` reversed: each `ShardedTensor` as its global tensor on
    ``device`` (its shard 0's by default); lists and dicts kept."""
    if isinstance(tree, ShardedTensor):
        return tree.full(device)
    if isinstance(tree, (list, tuple)):
        return [unshard_tree(v, device) for v in tree]
    if isinstance(tree, dict):
        return {k: unshard_tree(v, device) for k, v in tree.items()}
    return tree


def layer_of(tree, i: int):
    """Layer ``i`` of a stacked sharded tree (each shard's ``[i]`` view,
    so in-place writes reach the stack), its specs' leading entry
    dropped."""
    if isinstance(tree, ShardedTensor):
        return ShardedTensor([s[i] for s in tree.shards], tree.spec[1:],
                             tree.mesh, tree.shape[1:])
    return {k: layer_of(v, i) for k, v in tree.items()}
