"""Distributed graph engine: 1-D edge-partitioned kernels over a device list.

Scales the paper's workload past one device: edges are partitioned by
destination range (each shard owns a contiguous dst range = its slice of
the property array); a traversal step is

    local gather (remote props via all-gather) -> local segment-reduce

which is the pull-mode pattern of the paper mapped onto collectives.
After LOrder, hot vertices are concentrated in low id ranges, so the
all-gather payload that every shard actually *uses* is concentrated in a
small prefix — the cluster-level analogue of cache-line locality.

**Single controller.** One process drives every shard, as the JAX
package's ``shard_map`` over a 1-D mesh does: a `Mesh` is an ordered
list of devices, one per shard; each shard's vertex slice and edges are
tensors on its device; and the collectives (`all_gather`, `psum`,
`pmax`) are plain functions over the shards' tensors, the only place
where a step's data crosses shards (a run's result is assembled on shard
0's device at its end). Four shards run on four cards
(``cuda:0..3``), on one card (all on ``cuda:0``) or on the CPU alike;
where shards share a device they share one gathered tensor.

The **hot-prefix exchange** (`hot_prefix_fraction` on the traversal
factories) exploits the concentration: every step all-gathers only the
first ``h_local = ceil(fraction * per)`` entries of each shard's
property slice; the cold remainder is refreshed by a full exchange every
``cold_every`` steps and read from a per-shard stale cache in between.
This is only applied to the *monotone min-relaxation* kernels (BFS as
unit-weight Bellman-Ford, SSSP, CC label propagation): their state only
ever decreases, so relaxing against stale — i.e. older, hence larger —
remote values can never commit a wrong result, only delay convergence.
Termination requires a **full** exchange step that changes nothing, so
the returned fixed point is exactly the single-device result. PageRank
and BC are level/iteration-synchronous and always exchange in full.
`ExchangeStats` accounts the per-step exchanged bytes either way.

**``fused``.** The JAX package's ``fused=True`` compiles a whole run into
one ``XLA::While``. Here both values run the same host step loop, one
host sync a step (the shards' flags are combined on the device first),
so their results are bit-identical; ``fused`` only decides how
dispatches are booked in `ExchangeStats`: one a run when fused, one a
step otherwise, as the reference books them.

All six serving kernels have distributed entry points here: PR
(`make_distributed_pagerank`), multi-source BFS/SSSP
(`make_distributed_bfs` / `make_distributed_sssp`), CC by min-label
propagation (`make_distributed_cc`, also serving CC-SV: both converge to
the min-id-per-component labeling), and multi-source BC
(`make_distributed_bc`: BFS forward + sharded path counting + a
src-partitioned dependency-accumulation backward pass). Each shard keeps
only its real edges (the reference pads every shard to the fullest one's
count for SPMD), with vertex ids widened to int64 once, at build time.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..algos.kernels import INF_I32, _seg_any, _seg_sum
from ..device import resolve_device
from .csr import Graph


# ---------------------------------------------------------------- the mesh
@dataclasses.dataclass(frozen=True)
class Mesh:
    """An N-D mesh: the device of each shard, in shard order, row-major over
    the named axes (the last axis varies fastest, as in a JAX mesh's
    device grid). ``Mesh(devices)`` is the graph engine's 1-D mesh over
    ``data``; ``launch/mesh.py`` builds the LM's ``(data, model)`` and
    ``(pod, data, model)`` meshes. Several shards may share a device."""

    devices: tuple[torch.device, ...]
    axis_names: tuple[str, ...] = ("data",)
    dims: tuple[int, ...] | None = None

    def __post_init__(self):
        if isinstance(self.axis_names, str):
            object.__setattr__(self, "axis_names", (self.axis_names,))
        if self.dims is None:
            if len(self.axis_names) != 1:
                raise ValueError("an N-D mesh needs its dims")
            object.__setattr__(self, "dims", (len(self.devices),))
        if len(self.dims) != len(self.axis_names) or \
                int(np.prod(self.dims)) != len(self.devices):
            raise ValueError(f"{len(self.devices)} devices for axes "
                             f"{self.axis_names} of sizes {self.dims}")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.dims))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> tuple[torch.device, ...]:
        """The mesh's devices, each once, in shard order."""
        return tuple(dict.fromkeys(self.devices))

    @property
    def home(self) -> torch.device:
        """Where whole results are assembled: shard 0's device."""
        return self.devices[0]

    def coords(self, i: int) -> dict[str, int]:
        """Shard ``i``'s index along each axis."""
        return dict(zip(self.axis_names,
                        (int(c) for c in np.unravel_index(i, self.dims))))

    def groups(self, axes=None) -> list[list[int]]:
        """The shards that a collective over ``axes`` (a name, a tuple of
        names, or None for every axis) combines: one list a group, of the
        shards that agree on every other axis, in row-major order over
        ``axes``. Axes the mesh lacks are ignored, as a size-1 axis."""
        if axes is None:
            axes = self.axis_names
        elif isinstance(axes, str):
            axes = (axes,)
        rest = [a for a in self.axis_names if a not in axes]
        out: dict[tuple, list[int]] = {}
        for i in range(self.size):
            c = self.coords(i)
            out.setdefault(tuple(c[a] for a in rest), []).append(i)
        return list(out.values())


def make_mesh(num_shards: int | None = None, axis: str = "data",
              device: str | torch.device | None = None) -> Mesh:
    """A 1-D mesh of ``num_shards`` shards.

    ``device=None`` or ``"cuda"`` spreads the shards round-robin over the
    visible cards (one shard a card by default, as the reference's
    default is ``jax.device_count()``); a named device (``"cuda:1"``,
    ``"cpu"``) holds every shard (one by default). A missing card raises.
    """
    if num_shards is not None and num_shards < 1:
        raise ValueError(f"num_shards must be >= 1, got {num_shards}")
    return Mesh(shard_devices(num_shards, device), (axis,))


def shard_devices(num_shards: int | None,
                  device: str | torch.device | None) -> tuple:
    """The device of each of ``num_shards`` shards (`make_mesh`)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        count = torch.cuda.device_count()
        n = num_shards or count
        return tuple(torch.device("cuda", i % count) for i in range(n))
    if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
        raise RuntimeError(f"no device {dev}: "
                           f"{torch.cuda.device_count()} visible")
    return (dev,) * (num_shards or 1)


# ------------------------------------------------------------ collectives
# Each takes one tensor a shard (in shard order) and returns one a shard.
# ``axis`` (a name, a tuple of names, None for all) picks the shards each
# result combines (`Mesh.groups`). Shards of one group on one device share
# one result tensor. The functions are plain torch ops, so autograd runs
# through them: an all-gather's backward hands each shard the gradient of
# its own piece summed over the group (a reduce-scatter), a psum's
# backward hands each input the sum of the outputs' gradients.
def all_gather(slabs: list[torch.Tensor], mesh: Mesh,
               h_local: int | None = None, axis=None,
               dim: int = -1) -> list[torch.Tensor]:
    """Tiled all-gather along ``dim`` (the last by default): every shard
    receives its group's slabs (or their first ``h_local`` entries)
    concatenated in group order."""
    parts = [s if h_local is None else s[..., :h_local] for s in slabs]
    _book("all_gather", parts, mesh, axis)
    return _combine(parts, mesh, axis,
                    lambda ps: torch.cat(ps, dim=dim))


class CollectiveLedger:
    """Bytes the collectives move, booked by the reference's per-device
    formulas while one is open (``with``): an all-gather of ``b`` bytes a
    shard over ``n`` shards moves ``(n - 1)·b`` into each device, a psum
    or pmax (a ring all-reduce) ``2(n - 1)/n·b``. Booked once a call, for
    one device of the group; autograd's backward of a gather (a
    reduce-scatter) and of a psum move the same bytes again and are not
    booked."""

    def __init__(self):
        self.bytes: dict[str, float] = {}
        self.calls: dict[str, int] = {}

    def __enter__(self):
        global ledger
        ledger = self
        return self

    def __exit__(self, *exc):
        global ledger
        ledger = None

    def book(self, kind: str, n: int, nbytes: int) -> None:
        if n <= 1:
            return
        moved = (n - 1) * nbytes if kind == "all_gather" else \
            2 * (n - 1) / n * nbytes
        self.bytes[kind] = self.bytes.get(kind, 0.0) + moved
        self.calls[kind] = self.calls.get(kind, 0) + 1

    def as_dict(self) -> dict:
        return {"bytes_per_device": dict(self.bytes), "calls": dict(
            self.calls), "total_bytes_per_device": sum(self.bytes.values())}


# the `CollectiveLedger` the collectives book into, while one is open
ledger = None


def _book(kind: str, values: list, mesh: Mesh, axis) -> None:
    if ledger is not None:
        n = len(mesh.groups(axis)[0])
        v = values[0]
        ledger.book(kind, n, v.numel() * v.element_size())


def _combine(values: list[torch.Tensor], mesh: Mesh, axis, op) -> list:
    out: list = [None] * mesh.size
    for group in mesh.groups(axis):
        done: dict = {}
        for i in group:
            d = mesh.devices[i]
            if d not in done:
                done[d] = op([values[j].to(d) for j in group])
            out[i] = done[d]
    return out


def _reduce(values: list[torch.Tensor], mesh: Mesh, op, axis=None) -> list:
    return _combine(values, mesh, axis, lambda vs: op(torch.stack(vs)))


def psum(values: list[torch.Tensor], mesh: Mesh,
         axis=None) -> list[torch.Tensor]:
    """Sum of one value a shard over its group, summed in group order, on
    every shard of the group."""
    _book("psum", values, mesh, axis)
    return _reduce(values, mesh, lambda t: t.sum(0, dtype=t.dtype), axis)


def pmax(values: list[torch.Tensor], mesh: Mesh,
         axis=None) -> list[torch.Tensor]:
    """Max of one value a shard over its group, on every shard of it."""
    _book("pmax", values, mesh, axis)
    return _reduce(values, mesh, lambda t: t.amax(0), axis)


def _any(flags: list[torch.Tensor], mesh: Mesh) -> bool:
    """Is any shard's flag set: one host sync, on shard 0's copy."""
    return bool(psum([f.to(torch.int32) for f in flags], mesh)[0] > 0)


# ------------------------------------------------------------- partitions
def _partition_coo(src, dst, num_vertices: int, num_shards: int,
                   edge_values=None):
    """Split raw COO edges by dst range; pad shards to equal edge counts.

    Returns ``(src_pad, dst_pad, valid, per[, values_pad])`` where
    ``src_pad`` keeps *global* ids, ``dst_pad`` is localized to each
    shard's ``[i*per, (i+1)*per)`` range, and ``valid`` masks padding.
    Swapping the ``src``/``dst`` arguments partitions by source instead
    (used by the BC backward pass, which accumulates at src).
    """
    per = -(-num_vertices // num_shards)  # dst ids [i*per, (i+1)*per)
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    shard_of = dst // per
    order = np.argsort(shard_of, kind="stable")
    src, dst = src[order], dst[order]
    counts = np.bincount(shard_of[order], minlength=num_shards)
    emax = int(counts.max()) if counts.size else 0
    s_pad = np.zeros((num_shards, emax), np.int32)
    d_pad = np.zeros((num_shards, emax), np.int32)
    valid = np.zeros((num_shards, emax), bool)
    if edge_values is not None:
        vals = np.asarray(edge_values)[order]
        v_pad = np.zeros((num_shards, emax), vals.dtype)
    off = 0
    for i, c in enumerate(counts):
        s_pad[i, :c] = src[off:off + c]
        d_pad[i, :c] = dst[off:off + c] - i * per  # local dst index
        valid[i, :c] = True
        if edge_values is not None:
            v_pad[i, :c] = vals[off:off + c]
        off += c
    if edge_values is not None:
        return s_pad, d_pad, valid, per, v_pad
    return s_pad, d_pad, valid, per


def partition_edges(g: Graph, num_shards: int, edge_values=None):
    """Split a graph's COO edges by dst range; pad shards equally.

    ``edge_values`` (optional, aligned with the graph's out-CSR edge
    order, e.g. SSSP weights) is partitioned identically and returned as
    a fifth array.
    """
    return _partition_coo(g.edge_src, g.indices, g.num_vertices, num_shards,
                          edge_values=edge_values)


class _Edges(NamedTuple):
    """One shard's real edges on its device: ``src`` and ``dst`` int64
    (which of them is global and which local is the partition's), ``w``
    int32 edge values or None."""

    src: torch.Tensor
    dst: torch.Tensor
    w: torch.Tensor | None = None


def _upload(parts, mesh: Mesh, values=None, keep=None) -> list[_Edges]:
    """Each shard's real edges of a padded partition (``keep``, a bool
    mask over them, selects a subset) onto its device."""
    s_pad, d_pad, valid = parts[:3]
    out = []
    for i, dev in enumerate(mesh.devices):
        m = valid[i] if keep is None else valid[i] & keep[i]

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a[i][m], dtype)
                                    ).to(dev)

        out.append(_Edges(put(s_pad, np.int64), put(d_pad, np.int64),
                          None if values is None else put(values, np.int32)))
    return out


def _put_state(values: np.ndarray, mesh: Mesh, per: int) -> list:
    """Upload an (S, n_pad) property matrix, one (S, per) slice a shard."""
    return [torch.from_numpy(np.ascontiguousarray(
        values[:, i * per:(i + 1) * per])).to(dev)
        for i, dev in enumerate(mesh.devices)]


def _collect(slabs: list[torch.Tensor], mesh: Mesh) -> torch.Tensor:
    """The shards' slices side by side, on the mesh's home device."""
    return torch.cat([s.to(mesh.home) for s in slabs], dim=-1)


# ---------------------------------------------------------- exchange stats
@dataclasses.dataclass
class ExchangeStats:
    """Per-step collective payload accounting for the sharded kernels.

    A "step" is one traversal iteration that all-gathers vertex property
    state. Bytes count what one device *receives* per step:
    ``(num_shards - 1) * slab_bytes`` — the remote share of the gathered
    array. ``bytes_full_equivalent`` books what the same step would have
    cost with a full exchange, so the hot-prefix saving is
    ``1 - bytes_exchanged / bytes_full_equivalent``.

    ``dispatches`` counts host→device launches: with host-loop drivers
    that is one per step (plus prep launches), with fused drivers one per
    run — the collapse the fused benchmark phase demonstrates.
    """

    steps_full: int = 0
    steps_hot: int = 0
    bytes_full: int = 0
    bytes_hot: int = 0
    bytes_full_equivalent: int = 0
    dispatches: int = 0
    # optional per-step observer ``(mode, nbytes, full_nbytes) -> None``:
    # the engine's sharded backend points this at its tracer while a run
    # is live, so every exchange becomes one trace span (engine/obs.py)
    # without dist growing an engine dependency. Fused runs replay their
    # device-side step counts through here right after the launch.
    span_sink: object = dataclasses.field(default=None, compare=False,
                                          repr=False)

    def record_full(self, nbytes: int) -> None:
        self.steps_full += 1
        self.bytes_full += nbytes
        self.bytes_full_equivalent += nbytes
        if self.span_sink is not None:
            self.span_sink("full", nbytes, nbytes)

    def record_hot(self, nbytes: int, full_nbytes: int) -> None:
        self.steps_hot += 1
        self.bytes_hot += nbytes
        self.bytes_full_equivalent += full_nbytes
        if self.span_sink is not None:
            self.span_sink("hot", nbytes, full_nbytes)

    def record_dispatch(self, n: int = 1) -> None:
        self.dispatches += n

    def record_run(self, steps_full: int, steps_hot: int,
                   full_nbytes: int, hot_nbytes: int) -> None:
        """Replay a fused run's device-side step counts one step at a
        time, so per-step accounting (and the span_sink) see the same
        sequence of records the host-loop driver would have produced."""
        for _ in range(int(steps_full)):
            self.record_full(full_nbytes)
        for _ in range(int(steps_hot)):
            self.record_hot(hot_nbytes, full_nbytes)

    def snapshot(self) -> tuple:
        """Counter tuple for per-run attribution (see ``delta``)."""
        return (self.steps_full, self.steps_hot, self.bytes_full,
                self.bytes_hot, self.bytes_full_equivalent, self.dispatches)

    def delta(self, since: tuple) -> "ExchangeStats":
        """Stats accumulated since ``snapshot()`` — the exchange cost of
        exactly one runner invocation when runs are serial, which is how
        the scheduler attributes collective bytes to individual requests
        instead of only the backend-level aggregate."""
        now = self.snapshot()
        return ExchangeStats(*(a - b for a, b in zip(now, since)))

    @property
    def steps(self) -> int:
        return self.steps_full + self.steps_hot

    @property
    def bytes_exchanged(self) -> int:
        return self.bytes_full + self.bytes_hot

    @property
    def bytes_per_step(self) -> float:
        return self.bytes_exchanged / max(self.steps, 1)

    @property
    def savings_fraction(self) -> float:
        if self.bytes_full_equivalent <= 0:
            return 0.0
        return 1.0 - self.bytes_exchanged / self.bytes_full_equivalent

    def as_dict(self) -> dict:
        return {
            "steps": self.steps,
            "steps_full": self.steps_full,
            "steps_hot": self.steps_hot,
            "bytes_full": self.bytes_full,
            "bytes_hot": self.bytes_hot,
            "bytes_exchanged": self.bytes_exchanged,
            "bytes_full_equivalent": self.bytes_full_equivalent,
            "bytes_per_step": round(self.bytes_per_step, 1),
            "savings_fraction": round(self.savings_fraction, 4),
            "dispatches": self.dispatches,
        }


class _Ledger:
    """Books one run's steps into an optional `ExchangeStats`: a dispatch
    a step on the host loop (``fused=False``), one a run when fused."""

    def __init__(self, stats: ExchangeStats | None, fused: bool):
        self.stats, self.fused = stats, fused
        if stats is not None and fused:
            stats.record_dispatch()

    def full(self, nbytes: int) -> None:
        if self.stats is not None:
            if not self.fused:
                self.stats.record_dispatch()
            self.stats.record_full(nbytes)

    def hot(self, nbytes: int, full_nbytes: int) -> None:
        if self.stats is not None:
            if not self.fused:
                self.stats.record_dispatch()
            self.stats.record_hot(nbytes, full_nbytes)


# ------------------------------------------------------------------ PageRank
def make_distributed_pagerank(g: Graph, mesh: Mesh, axis: str = "data",
                              damping: float = 0.85, num_iters: int = 20,
                              stats: ExchangeStats | None = None,
                              fused: bool = True):
    """Returns ``(run, devices)``: ``run(rank0=None)`` runs ``num_iters``
    synchronous power iterations over `axis` of `mesh` and returns the
    (V,) ranks; ``devices`` holds each shard's device (where a ``rank0``
    slice goes)."""
    num_shards = mesh.shape[axis]
    parts = partition_edges(g, num_shards)
    per = parts[3]
    edges = _upload(parts, mesh)
    n = g.num_vertices
    n_pad = per * num_shards
    outdeg = np.maximum(np.asarray(g.out_degree, np.float32), 1.0)
    outdeg_pad = np.ones(n_pad, np.float32)
    outdeg_pad[:n] = outdeg
    dangling_pad = np.zeros(n_pad, np.float32)
    dangling_pad[:n] = (np.asarray(g.out_degree) == 0).astype(np.float32)
    degs = _put_state(outdeg_pad[None], mesh, per)
    dangs = _put_state(dangling_pad[None], mesh, per)

    def iterate(ranks):
        # all-gather the full property array — the collective whose
        # *useful* payload LOrder concentrates; the degrees too, as the
        # reference gathers them every iteration
        full = all_gather(ranks, mesh)
        full_deg = all_gather(degs, mesh)
        dangling = psum([(r * d).sum() for r, d in zip(ranks, dangs)], mesh)
        out = []
        for i, e in enumerate(edges):
            contrib = full[i][:, e.src] / full_deg[i][:, e.src]
            summed = _seg_sum(contrib, e.dst, per)
            # dangling mass redistributed uniformly (GAP semantics)
            out.append((1.0 - damping) / n
                       + damping * (summed + dangling[i] / n))
        return out

    # PR's power iteration is synchronous: every step needs a consistent
    # full view, so there is no hot-prefix variant — two f32 gathers
    # (rank + outdeg) per iteration, accounted in full.
    iter_bytes = 2 * (num_shards - 1) * per * 4

    def run(rank0=None):
        r0 = (np.full(n_pad, 1.0 / n, np.float32) if rank0 is None
              else np.asarray(rank0, np.float32))
        ranks = _put_state(r0[None], mesh, per)
        ledger = _Ledger(stats, fused)
        for _ in range(num_iters):
            ranks = iterate(ranks)
            ledger.full(iter_bytes)
        return _collect(ranks, mesh)[0, :n]

    return run, mesh.devices


# ------------------------------------------------- multi-source traversals
#
# Serving parity with the single-device engine: batched BFS / SSSP / CC /
# BC where the (S, V) property matrix is sharded along the *vertex* axis
# and each level/relaxation step all-gathers it. The outer iteration is a
# host loop with one device-side convergence flag a step, bounded by
# eccentricity (BFS) or V (Bellman-Ford).


# ------------------------------------------- hot-prefix min-relaxation core
def _make_minrelax_runner(coo_src, coo_dst, edge_w, num_vertices: int,
                          mesh: Mesh, axis: str,
                          hot_prefix_fraction: float | None = None,
                          cold_every: int = 4,
                          stats: ExchangeStats | None = None,
                          fused: bool = True):
    """Generic monotone min-relaxation to a fixed point over the shards.

    State is an int32 ``(S, n_pad)`` matrix sharded on the vertex axis;
    one step relaxes ``state[dst] = min(state[dst], state[src] + w)`` over
    the dst-partitioned edge set. With ``hot_prefix_fraction`` set, hot
    steps gather only each shard's first ``h_local`` entries and read the
    cold remainder from the cache left by the last full exchange; the
    shard's *own* slice is always read live. Because state is monotone
    non-increasing, stale (older = larger) remote values can only delay a
    relaxation, never commit a wrong one — and the loop terminates only
    when a **full**-exchange step changes nothing, i.e. at the exact
    global fixed point.

    Each shard's edges are split at build time by where their source
    lives: its own slice (read from the live state) or another shard's
    (read from the exchanged view). So a hot step only writes the fresh
    prefix into the device's cached view, in place; shards that share a
    device share that view.

    Returns ``run(state0) -> (S, n_pad) final state`` on the home device,
    with ``run.h_local``, ``run.per``, ``run.hot_prefix_fraction`` and the
    static ``run.prefix_hit_rate`` (fraction of edge-source reads served
    fresh: local to the shard, or inside the gathered hot prefix).
    """
    num_shards = mesh.shape[axis]
    cold_every = max(int(cold_every), 1)
    s_pad, d_pad, valid, per, w_pad = _partition_coo(
        coo_src, coo_dst, num_vertices, num_shards,
        edge_values=np.asarray(edge_w, np.int32))
    n_pad = per * num_shards
    f = hot_prefix_fraction
    h_local = per if f is None else min(per, max(1, int(np.ceil(f * per))))
    # distance info crosses at least one hop per full exchange even in
    # the worst case, so the fixed point is reached well inside
    # V * cold_every steps; the bound is a backstop, not the driver
    max_iters = num_vertices * cold_every + cold_every + 2

    own = (s_pad // per) == np.arange(num_shards)[:, None]
    local = _upload((s_pad % per, d_pad, valid), mesh, w_pad, own)
    remote = _upload((s_pad, d_pad, valid), mesh, w_pad, ~own)

    def relax(states, views):
        news, flags = [], []
        for st, view, lo, re in zip(states, views, local, remote):
            # segment min into local dst; empty segments stay INT32_MAX
            relaxed = torch.full_like(st, INF_I32)
            for du, e in ((st[:, lo.src], lo), (view[:, re.src], re)):
                cand = torch.where(du != INF_I32, du + e.w, INF_I32)
                relaxed.scatter_reduce_(1, e.dst.expand_as(cand), cand,
                                        "amin", include_self=True)
            new = torch.minimum(st, relaxed)
            news.append(new)
            flags.append((new != st).any())
        return news, _any(flags, mesh)

    def hot_views(states, cache):
        # gather only the hot prefix of every shard's slice into the
        # device's cached view; the cold suffix stays as last exchanged
        fresh = all_gather(states, mesh, h_local)
        for d in mesh.distinct:
            i = mesh.devices.index(d)
            v = cache[i].view(-1, num_shards, per)
            v[:, :, :h_local] = fresh[i].view(-1, num_shards, h_local)
        return cache

    def run(state0):
        s = int(np.asarray(state0).shape[0])
        states = _put_state(np.asarray(state0, np.int32), mesh, per)
        full_b = (num_shards - 1) * per * 4 * s
        hot_b = (num_shards - 1) * h_local * 4 * s
        ledger = _Ledger(stats, fused)
        cache = None
        full_due = True
        for it in range(max_iters):
            if f is None or full_due or it % cold_every == 0:
                # the gathered view doubles as the cold cache until the
                # next full exchange
                cache = all_gather(states, mesh)
                states, changed = relax(states, cache)
                ledger.full(full_b)
                full_due = False
                if not changed:
                    break  # fixed point certified against the full view
            else:
                states, changed = relax(states, hot_views(states, cache))
                ledger.hot(hot_b, full_b)
                if not changed:
                    full_due = True  # locally quiesced: verify in full
        return _collect(states, mesh)

    if f is None:
        run.prefix_hit_rate = 1.0
    else:
        hit = (own | ((s_pad % per) < h_local)) & valid
        nvalid = int(valid.sum())
        run.prefix_hit_rate = float(hit.sum() / nvalid) if nvalid else 1.0
    run.h_local, run.per, run.hot_prefix_fraction = h_local, per, f
    return run


def _copy_prefix_attrs(run, relax) -> None:
    run.prefix_hit_rate = relax.prefix_hit_rate
    run.h_local, run.per = relax.h_local, relax.per
    run.hot_prefix_fraction = relax.hot_prefix_fraction


# ------------------------------------------------------------------- BFS
def _make_bfs_frontier(g: Graph, mesh: Mesh, axis: str,
                       stats: ExchangeStats | None, fused: bool = True):
    """Level-synchronous frontier BFS; returns run(sources) -> the
    shards' (S, per) depth slices (the full-exchange path, also BC's
    forward pass)."""
    num_shards = mesh.shape[axis]
    parts = partition_edges(g, num_shards)
    per = parts[3]
    edges = _upload(parts, mesh)
    n, n_pad = g.num_vertices, per * num_shards

    def step(depths, fronts, level):
        full_front = all_gather(fronts, mesh)
        news, out = [], []
        for depth, full, e in zip(depths, full_front, edges):
            touched = _seg_any(full[:, e.src], e.dst, per)
            new = touched & (depth < 0)
            out.append(torch.where(new, level + 1, depth))
            news.append(new)
        return out, news, _any([x.any() for x in news], mesh)

    def run_full(sources, ledger: _Ledger):
        srcs = np.atleast_1d(np.asarray(sources, np.int64))
        s = srcs.size
        depth0 = np.full((s, n_pad), -1, np.int32)
        depth0[np.arange(s), srcs] = 0
        front0 = np.zeros((s, n_pad), bool)
        front0[np.arange(s), srcs] = True
        depths = _put_state(depth0, mesh, per)
        fronts = _put_state(front0, mesh, per)
        level_bytes = (num_shards - 1) * per * 1 * s  # bool frontier
        # do-while: the initial frontier is never empty (sources exist)
        for level in range(n):
            depths, fronts, alive = step(depths, fronts, level)
            ledger.full(level_bytes)
            if not alive:
                break
        return depths

    run_full.per = per
    # the dst-partitioned edge uploads, reused by BC's forward σ pass —
    # one partition, one upload
    run_full.edges = edges
    return run_full


def make_distributed_bfs(g: Graph, mesh: Mesh, axis: str = "data",
                         hot_prefix_fraction: float | None = None,
                         cold_every: int = 4,
                         stats: ExchangeStats | None = None,
                         fused: bool = True):
    """Returns run(sources) -> (S, V) BFS depths over `axis` of `mesh`.

    With ``hot_prefix_fraction`` set, BFS runs as unit-weight Bellman-Ford
    through the hot-prefix min-relaxation driver (exact depths; the level
    counter of the frontier formulation cannot tolerate stale frontiers,
    min-relaxation can). Without it, the level-synchronous frontier path
    exchanges the full frontier every step.
    """
    n = g.num_vertices
    if hot_prefix_fraction is None:
        run_full = _make_bfs_frontier(g, mesh, axis, stats, fused=fused)

        def run(sources):
            depths = run_full(sources, _Ledger(stats, fused))
            return _collect(depths, mesh)[:, :n]

        run.prefix_hit_rate, run.hot_prefix_fraction = 1.0, None
        run.per = run_full.per
        run.h_local = run_full.per
        return run

    unit = np.ones(g.num_edges, np.int32)
    relax = _make_minrelax_runner(g.edge_src, g.indices, unit, n, mesh, axis,
                                  hot_prefix_fraction, cold_every, stats,
                                  fused=fused)
    n_pad = relax.per * mesh.shape[axis]

    def run(sources):
        srcs = np.atleast_1d(np.asarray(sources, np.int64))
        state0 = np.full((srcs.size, n_pad), INF_I32, np.int32)
        state0[np.arange(srcs.size), srcs] = 0
        dist = relax(state0)
        return torch.where(dist == INF_I32, -1, dist)[:, :n]

    _copy_prefix_attrs(run, relax)
    return run


def make_distributed_sssp(g: Graph, mesh: Mesh, axis: str = "data",
                          canonical_ids=None,
                          hot_prefix_fraction: float | None = None,
                          cold_every: int = 4,
                          stats: ExchangeStats | None = None,
                          fused: bool = True):
    """Returns run(sources) -> (S, V) Bellman-Ford distances.

    Weights are the engine's canonical per-edge hash
    (`algos.graph_arrays.edge_weights`, relabel-invariant through
    ``canonical_ids``), so sharded distances match the single-device
    executor exactly — with or without the hot-prefix exchange
    (Bellman-Ford is monotone, see `_make_minrelax_runner`). Both the
    full-exchange and hot-prefix paths run through the min-relaxation
    driver (with ``hot_prefix_fraction=None`` every step is a full
    exchange).
    """
    from ..algos.graph_arrays import edge_weights

    n = g.num_vertices
    w = edge_weights(g.edge_src, g.indices, canonical_ids)
    relax = _make_minrelax_runner(g.edge_src, g.indices, w, n, mesh, axis,
                                  hot_prefix_fraction, cold_every, stats,
                                  fused=fused)
    n_pad = relax.per * mesh.shape[axis]

    def run(sources):
        srcs = np.atleast_1d(np.asarray(sources, np.int64))
        state0 = np.full((srcs.size, n_pad), INF_I32, np.int32)
        state0[np.arange(srcs.size), srcs] = 0
        return relax(state0)[:, :n]

    _copy_prefix_attrs(run, relax)
    return run


# -------------------------------------------------- Connected Components
def make_distributed_cc(g: Graph, mesh: Mesh, axis: str = "data",
                        hot_prefix_fraction: float | None = None,
                        cold_every: int = 4,
                        stats: ExchangeStats | None = None,
                        fused: bool = True):
    """Returns run() -> (V,) min-label CC over the symmetrized edges.

    Min-label propagation is a monotone min-relaxation (weight 0 over the
    symmetrized edge set), so it runs through the same driver as the
    hot-prefix traversals — with ``hot_prefix_fraction`` unset every step
    is a full exchange. Converges to the min-vertex-id-per-component
    labeling, bit-identical to `algos.kernels.cc_labelprop`; CC-SV
    reaches the same labeling, so this runner serves both cc and ccsv.
    """
    n = g.num_vertices
    src = np.concatenate([np.asarray(g.edge_src), np.asarray(g.indices)])
    dst = np.concatenate([np.asarray(g.indices), np.asarray(g.edge_src)])
    relax = _make_minrelax_runner(src, dst, np.zeros(src.size, np.int32), n,
                                  mesh, axis, hot_prefix_fraction,
                                  cold_every, stats, fused=fused)
    n_pad = relax.per * mesh.shape[axis]

    def run():
        lab0 = np.arange(n_pad, dtype=np.int32)[None, :]
        return relax(lab0)[0, :n]

    _copy_prefix_attrs(run, relax)
    return run


# -------------------------------------------- Betweenness Centrality (BC)
def make_distributed_bc(g: Graph, mesh: Mesh, axis: str = "data",
                        stats: ExchangeStats | None = None,
                        fused: bool = True):
    """Returns run(sources) -> (S, V) per-source Brandes dependencies.

    Three sharded passes, mirroring `algos.kernels.bc_single_source`:

    1. **forward depths** — the frontier BFS above, kept sharded;
    2. **path counts** — per level, all-gather sigma and segment-sum the
       tree-edge contributions into local dst (edges partitioned by dst);
    3. **dependency accumulation** — per level backwards, all-gather
       delta and accumulate ``sigma[u]/sigma[v] * (1 + delta[v])`` into
       local src over a *source-partitioned* copy of the edges (the
       backward pass scatters to src, so dst-partitioned edges would
       need a cross-shard scatter).

    ``max_level`` is a `pmax` over the shards' deepest levels, read once.
    Level-synchronous float accumulation: no hot-prefix variant (the
    per-level sums need a consistent view), and results are numerically
    close — not bit-identical — to the single-device kernel because the
    segment-sum order differs.
    """
    num_shards = mesh.shape[axis]
    n = g.num_vertices
    bfs_full = _make_bfs_frontier(g, mesh, axis, stats, fused=fused)
    per = bfs_full.per
    n_pad = per * num_shards
    # forward: dst-partitioned (sigma accumulates at dst) — the exact
    # partition the frontier BFS already uploaded, so reuse it
    fwd = bfs_full.edges
    # backward: src-partitioned (delta accumulates at src); swapping the
    # COO roles localizes src and keeps dst global
    bd_pad, bs_pad, bvalid, per_b = _partition_coo(g.indices, g.edge_src, n,
                                                   num_shards)
    assert per_b == per
    # _Edges(src=local src indices, dst=global dst ids)
    bwd = _upload((bs_pad, bd_pad, bvalid), mesh)

    def run(sources):
        srcs = np.atleast_1d(np.asarray(sources, np.int64))
        s = srcs.size
        step_bytes = (num_shards - 1) * per * 4 * s
        ledger = _Ledger(stats, fused)
        depths = bfs_full(srcs, ledger)
        max_level = int(pmax([d.amax() for d in depths], mesh)[0])

        # pass 2: path counts, level-synchronous up to max_level
        full_depth = all_gather(depths, mesh)
        ledger.full(step_bytes)                   # fwd_prep depth gather
        prep = []
        for depth, fd, e in zip(depths, full_depth, fwd):
            du = fd[:, e.src]
            dv = depth[:, e.dst]                  # dst is local
            prep.append((du, (dv == du + 1) & (du >= 0)))
        sigma0 = np.zeros((s, n_pad), np.float32)
        sigma0[np.arange(s), srcs] = 1.0
        sigmas = _put_state(sigma0, mesh, per)
        for level in range(max_level + 1):
            full_sigma = all_gather(sigmas, mesh)
            sigmas = [sig + _seg_sum(torch.where(tree & (du == level),
                                                 fs[:, e.src], 0.0),
                                     e.dst, per)
                      for sig, fs, (du, tree), e
                      in zip(sigmas, full_sigma, prep, fwd)]
            ledger.full(step_bytes)

        # pass 3: dependency accumulation, levels max_level-1 .. 0
        full_depth = all_gather(depths, mesh)
        # sigma is fixed during the backward pass: gather it once
        sig_full = all_gather(sigmas, mesh)
        ledger.full(2 * step_bytes)               # depth + sigma gathers
        prep = []
        for i, (depth, fd, sf, e) in enumerate(zip(depths, full_depth,
                                                   sig_full, bwd)):
            du = depth[:, e.src]                  # src is local
            dv = fd[:, e.dst]
            sig_u = sf[:, i * per + e.src]
            sig_v = torch.clamp_min(sf[:, e.dst], 1e-30)
            prep.append(((dv == du + 1) & (du >= 0), du, sig_u / sig_v))
        deltas = [torch.zeros_like(sig) for sig in sigmas]
        for level in range(max_level - 1, -1, -1):
            full_delta = all_gather(deltas, mesh)
            deltas = [dl + _seg_sum(torch.where(
                tree & (du == level), ratio * (1.0 + fd[:, e.dst]), 0.0),
                e.src, per)
                for dl, fd, (tree, du, ratio), e
                in zip(deltas, full_delta, prep, bwd)]
            ledger.full(step_bytes)
        out = _collect(deltas, mesh)[:, :n]
        out[torch.arange(s, device=out.device),
            torch.from_numpy(srcs).to(out.device)] = 0.0
        return out

    run.prefix_hit_rate, run.hot_prefix_fraction = 1.0, None
    run.per = per
    run.h_local = per
    return run
