"""Mixture-of-Experts with locality-sorted (dropless) dispatch.

The PyTorch port of ``src/repro/models/moe.py`` for one device. Token to
expert assignments are a skewed bipartite access graph; sorting them by
expert id (LOrder's hot-first grouping, DESIGN.md §3.2) gives one
contiguous block of rows per expert, and the expert FFN runs as grouped
matmuls over those blocks: `kernels.moe_gmm.ops.ragged_dot`, the
hand-written kernel on the card and its plain version on the CPU.

Kept from the reference:
* `_route`: a float32 router, softmax, top-k (the lower expert id first
  on ties, as ``jax.lax.top_k``), gates renormalised, the Switch-style
  auxiliary loss;
* `_dispatch_local`: the stable sort by expert, a zero "parking" group
  for assignments a shard does not own, the ``replica`` split, and the
  combine in bf16, each token's k rows added in the order of the sort;
  the gather of the sorted rows passes its gradient back the same way
  (`_GatherRows`), as the transpose of the reference's gather adds it;
* the unsorted control (``moe_locality_sort=False``), as plain einsums;
* the shared experts as plain bf16 matmuls (`layers._dense`).

`RouteTape` records each routing call's choices and, on request, gives a
later run the same choices, for checks that hold two runs of the model to
each other (``chip_smoke.py``).

On a mesh (``mesh=``) `apply_moe` takes the layer's params as
`ShardedTensor`s and ``x`` as one tensor a shard. Where the ``model``
axis has more than one shard and divides ``d_ff``, it runs the
reference's TP-within-expert dispatch: each shard takes the tokens of its
data shard (``t_local``), locality-sorts them (a stable sort by expert, so
the same rows meet and the same rows drop), scatters them into an
``(E, cap, D)`` buffer with ``cap = ceil(1.5·t_local·k/E/128)·128``
(`_dispatch_capacity`: GShard semantics, rows past an expert's capacity
are dropped) and multiplies it by its F/|model| slice of every expert
through `ragged_dot` with every group ``cap`` rows (the grouped-matmul
kernel on the card; ``tgmm`` and dX in training); a psum over ``model``
sums the slices. `DropTape` counts the rows kept and dropped. Without
that split each shard runs `_dispatch_local` on its rows with the
experts gathered whole.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import dist
from ..kernels.moe_gmm.ops import ragged_dot
from .config import ModelConfig
from .layers import (COMPUTE_DTYPE, MODEL, _dense, _normal, psum_model, silu,
                     split_over)


def init_moe(gen: torch.Generator, cfg: ModelConfig) -> dict:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    sc_in, sc_out = d ** -0.5, f ** -0.5
    p = {
        "router": _normal(gen, (d, e), sc_in),
        "w_gate": _normal(gen, (e, d, f), sc_in),
        "w_up": _normal(gen, (e, d, f), sc_in),
        "w_down": _normal(gen, (e, f, d), sc_out),
    }
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared"] = {
            "w_gate": _normal(gen, (d, fs), sc_in),
            "w_up": _normal(gen, (d, fs), sc_in),
            "w_down": _normal(gen, (fs, d), sc_out),
        }
    return p


# the `RouteTape` that `_route` reports to, while one is open
tape = None


class RouteTape:
    """Each `_route` call's expert ids (sorted, (T, k)) and router margins
    (the k-th largest probability less the (k+1)-th, (T,)), in call order,
    on the CPU. Open it with ``with``.

    With ``replay`` (the ``experts`` of an earlier tape, in this run's
    call order) each call takes those expert ids instead, gated by its
    own probabilities renormalised over them: the run's arithmetic is its
    own, on the other run's discrete choices. Two runs whose inputs differ
    by rounding pick another expert wherever two probabilities lie closer
    than that rounding, so this is how their arithmetic is compared, as a
    teacher-forced decode compares it on the same tokens."""

    def __init__(self, replay=None):
        self.experts, self.margins = [], []
        self._replay = None if replay is None else iter(replay)

    def __enter__(self):
        global tape
        tape = self
        return self

    def __exit__(self, *exc):
        global tape
        tape = None

    def take(self, probs, margins, experts, gates):
        self.margins.append(margins.cpu())
        if self._replay is not None:
            experts = next(self._replay).to(experts.device)
            gates = probs.gather(1, experts)
        self.experts.append(experts.sort(dim=-1).values.cpu())
        return experts, gates


def _expert_ffn_ragged(xs, w_gate, w_up, w_down, group_sizes):
    """SwiGLU over expert-sorted rows via grouped matmuls. The f32 expert
    stacks are cast to bf16 at every call, as in the reference."""
    dt = COMPUTE_DTYPE
    xs = xs.to(dt)
    h = silu(ragged_dot(xs, w_gate.to(dt), group_sizes)) * ragged_dot(
        xs, w_up.to(dt), group_sizes)
    return ragged_dot(h.to(dt), w_down.to(dt), group_sizes)


def _route_probs(p, x_flat, cfg: ModelConfig):
    """Top-k routing. Returns (experts (T,k) int64, gates (T,k), probs
    (T,E)).

    The router product runs in full float32 (on the card as long as
    ``torch.backends.cuda.matmul.allow_tf32`` stays False, its default):
    TF32 would move probabilities enough to flip top-k choices."""
    logits = torch.matmul(x_flat.float(), p["router"])
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort puts the lower index first among equal
    # probabilities, as jax.lax.top_k does
    top, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    gates, experts = top[:, :k], idx[:, :k]
    if tape is not None:
        experts, gates = tape.take(probs, top[:, k - 1] - top[:, k],
                                   experts, gates)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    return experts, gates, probs


def _route(p, x_flat, cfg: ModelConfig):
    """Top-k routing (`_route_probs`). Returns (experts (T,k) int64, gates
    (T,k), aux_loss): the Switch-style load-balancing loss."""
    experts, gates, probs = _route_probs(p, x_flat, cfg)
    e = cfg.num_experts
    density = torch.bincount(experts.reshape(-1), minlength=e).float() \
        / experts.numel()
    aux = e * torch.sum(density * probs.mean(0))
    return experts, gates, aux


class _GatherRows(torch.autograd.Function):
    """``x_flat[tok]``, the expert-sorted rows, whose backward adds each
    token's k gradient rows to zero one by one, in the order of the sort
    (ascending expert id), rounding in the gradient's dtype after each
    add: the order in which the reference's scatter-add (the transpose of
    its gather) adds them on the CPU. ``dest[i]`` is sorted row i's slot
    ``token * k + rank``. On the card autograd's own backward (an
    accumulating index-put) adds in an order and a precision of the
    library's choosing (bf16 summed in float32, rounded once), not the
    reference's."""

    @staticmethod
    def forward(ctx, x_flat, tok, dest, k: int):
        ctx.save_for_backward(dest)
        ctx.k = k
        return x_flat[tok]

    @staticmethod
    def backward(ctx, grad):
        (dest,) = ctx.saved_tensors
        rows = torch.empty_like(grad).index_copy_(0, dest, grad).view(
            -1, ctx.k, grad.shape[-1])
        dx = torch.zeros_like(rows[:, 0])
        for j in range(ctx.k):
            dx = dx + rows[:, j]
        return dx, None, None, None


def _sort_slots(flat_e, t: int, k: int):
    """The locality sort of ``t·k`` assignments by group id ``flat_e``
    (stable: ties keep their order). Returns (order, tok, dest): sorted
    row i is assignment ``order[i]`` of token ``tok[i]``, and ``dest[i]``
    is its slot ``token·k + rank``, rank its place among the token's k
    rows in the order of the sort (ascending group id)."""
    dev = flat_e.device
    order = torch.argsort(flat_e, stable=True)          # the locality sort
    tok = order // k
    _, jperm = torch.sort(flat_e.view(t, k), dim=1, stable=True)
    rank = torch.empty_like(jperm).scatter_(
        1, jperm, torch.arange(k, device=dev).expand(t, k).contiguous())
    return order, tok, tok * k + rank.reshape(-1)[order]


def _combine_rows(vals, dest, t: int, k: int):
    """Each token's k weighted rows (``vals`` in sorted order) added one by
    one in bf16 in the order of the sort, as the reference's segment_sum
    adds them: scattered to (T, k, D) by slot first, a fixed order where
    index_add_ on the card would add in atomics."""
    rows = torch.empty_like(vals).index_copy_(0, dest, vals).view(t, k, -1)
    y = rows[:, 0]
    for j in range(1, k):
        y = y + rows[:, j]
    return y


def _dispatch_local(x_flat, experts, gates, w_gate, w_up, w_down,
                    num_local: int, base: int, replica=None):
    """Locality-sorted dispatch for experts [base, base+num_local).

    ``replica=(rep_id, reps)``: when several shards co-own the same expert
    set, each takes the assignment subset with index % reps == rep_id.
    Returns the combined output (T, D) in bf16.
    """
    t, k = experts.shape
    dev = experts.device
    flat_e = experts.reshape(-1) - base
    owned = (flat_e >= 0) & (flat_e < num_local)
    if replica is not None:
        rep_id, reps = replica
        owned &= (torch.arange(t * k, device=dev) % reps) == rep_id
    # route unowned assignments to a zero "parking" group at the end
    flat_e = torch.where(owned, flat_e, num_local)
    order, tok, dest = _sort_slots(flat_e, t, k)
    xs = _GatherRows.apply(x_flat, tok, dest, k)
    group_sizes = torch.bincount(flat_e, minlength=num_local + 1)[:num_local]
    ys = _expert_ffn_ragged(xs, w_gate, w_up, w_down, group_sizes)
    w = (gates.reshape(-1)[order] * owned[order]).to(ys.dtype)
    return _combine_rows(ys * w[:, None], dest, t, k)


# the `DropTape` that `_dispatch_capacity` reports to, while one is open
drops = None


class DropTape:
    """Each capacity dispatch's capacity, its sorted rows' keep mask, and
    their tokens and experts, left on the device until read. Open it with
    ``with``."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        global drops
        drops = self
        return self

    def __exit__(self, *exc):
        global drops
        drops = None

    def totals(self) -> dict:
        """Rows kept and dropped over every call, and the capacities (one
        host sync)."""
        kept = sum(int(c[1].sum()) for c in self.calls)
        rows = sum(c[1].numel() for c in self.calls)
        return {"calls": len(self.calls), "kept": kept,
                "dropped": rows - kept,
                "capacities": sorted({c[0] for c in self.calls})}

    def dropped(self) -> list:
        """Each call's dropped rows as (token, expert) pairs, an (N, 2)
        int64 array sorted by token, then expert."""
        out = []
        for _, keep, tok, ex in self.calls:
            pairs = torch.stack([tok[~keep], ex[~keep]], 1).cpu().numpy()
            out.append(pairs[np.lexsort((pairs[:, 1], pairs[:, 0]))])
        return out


def capacity(t_local: int, cfg: ModelConfig) -> int:
    """Rows of each expert's group in the capacity buffer: 1.5 times an
    even share of the ``t_local·k`` assignments, rounded up to 128."""
    return int(math.ceil(1.5 * t_local * cfg.experts_per_token
                         / cfg.num_experts / 128)) * 128


def _dispatch_capacity(x_flat, experts, gates, w_gate, w_up, w_down,
                       num_experts: int, capacity: int):
    """Locality-sorted capacity dispatch: the expert-sorted rows fill an
    (E, capacity, D) buffer, each expert's first ``capacity`` rows in the
    order of the stable sort, and the expert FFN is one grouped matmul
    with every group ``capacity`` rows (`ragged_dot`: the grouped-matmul
    kernel on the card). Rows beyond an expert's capacity are dropped
    (GShard/Switch semantics). Returns the combined output (T, D) bf16."""
    t, k = experts.shape
    dev = experts.device
    dt = COMPUTE_DTYPE
    flat_e = experts.reshape(-1)
    order, tok, dest = _sort_slots(flat_e, t, k)
    sorted_e = flat_e[order]
    counts = torch.bincount(flat_e, minlength=num_experts)
    offsets = counts.cumsum(0) - counts
    pos = torch.arange(t * k, device=dev) - offsets[sorted_e]
    keep = pos < capacity                  # rank within the expert's group
    if drops is not None:
        drops.calls.append((capacity, keep, tok, sorted_e))
    xs = _GatherRows.apply(x_flat.to(dt), tok, dest, k)
    ecap = num_experts * capacity
    j = torch.arange(ecap, device=dev)
    e_of, p_of = j // capacity, j % capacity
    filled = p_of < counts[e_of]
    src = (offsets[e_of] + p_of).clamp(max=t * k - 1)
    xe = torch.where(filled[:, None], xs[src], 0)
    sizes = torch.full((num_experts,), capacity, dtype=torch.int32,
                       device=dev)
    h = silu(ragged_dot(xe, w_gate.to(dt), sizes)) * ragged_dot(
        xe, w_up.to(dt), sizes)
    ye = ragged_dot(h.to(dt), w_down.to(dt), sizes)
    slot = (sorted_e * capacity + pos).clamp(max=ecap - 1)
    picked = torch.where(keep[:, None], ye[slot], 0)
    w = (gates.reshape(-1)[order] * keep).to(picked.dtype)
    return _combine_rows(picked * w[:, None], dest, t, k)


def _unsorted(x_flat, experts, gates, w_gate, w_up, w_down):
    """The unsorted baseline: dense per-token einsum over gathered
    experts, the "no reordering" control for the MoE benchmarks."""
    dt = COMPUTE_DTYPE
    wg = w_gate[experts]   # (T, k, D, F): skew-random gathers
    wu = w_up[experts]
    wd = w_down[experts]
    xd = x_flat.to(dt)
    g = torch.einsum("td,tkdf->tkf", xd, wg.to(dt))
    u = torch.einsum("td,tkdf->tkf", xd, wu.to(dt))
    yk = torch.einsum("tkf,tkfd->tkd", silu(g) * u, wd.to(dt))
    return torch.einsum("tkd,tk->td", yk, gates.to(dt))


def apply_moe(p, x, cfg: ModelConfig, mesh=None, ep_axis: str = MODEL,
              dp_axes=("pod", "data"), split_rows: bool = False):
    """x: (B, S, D). Returns (y (B, S, D) bf16, aux_loss).

    With ``mesh``, ``p`` maps names to `ShardedTensor`s and ``x`` is one
    tensor a shard: its data shard's rows when ``split_rows`` (the batch
    split over ``dp_axes``), else every row (`_apply_moe_sharded`)."""
    if mesh is not None:
        if not isinstance(x, (list, tuple)):
            raise TypeError("on a mesh x is one tensor a shard")
        return _apply_moe_sharded(p, x, cfg, mesh, ep_axis, dp_axes,
                                  split_rows)
    b, s, d = x.shape
    x_flat = x.reshape(b * s, d)
    experts, gates, aux = _route(p, x_flat, cfg)

    if not cfg.moe_locality_sort:
        y = _unsorted(x_flat, experts, gates, p["w_gate"], p["w_up"],
                      p["w_down"])
    else:
        y = _dispatch_local(x_flat, experts, gates, p["w_gate"], p["w_up"],
                            p["w_down"], cfg.num_experts, 0)

    if cfg.num_shared_experts:
        sp = p["shared"]
        y = y + _dense(silu(_dense(x_flat, sp["w_gate"]))
                       * _dense(x_flat, sp["w_up"]), sp["w_down"])
    return y.reshape(b, s, d).to(COMPUTE_DTYPE), aux


def _apply_moe_sharded(p, xs, cfg: ModelConfig, mesh, ep_axis, dp_axes,
                       split_rows: bool):
    """`apply_moe` on a mesh (see the module docstring). The tokens split
    over the data axes as the reference's ``shard_map`` splits the
    flattened tokens: by rows when the batch is split, else (the batch
    replicated) into equal runs of the flattened tokens when they divide,
    gathered back after the psum over ``model``. The auxiliary loss is
    the global one: expert counts and probability sums ``psum``med over
    the data axes where the tokens were split."""
    n = mesh.size
    dp = tuple(a for a in dp_axes if a in mesh.axis_names)
    ndp = int(math.prod(mesh.shape[a] for a in dp))
    b, s, d = xs[0].shape
    flat = [x.reshape(b * s, d) for x in xs]
    t = b * s
    nmod = mesh.shape.get(ep_axis, 1)
    e, k = cfg.num_experts, cfg.experts_per_token
    tp = (cfg.moe_locality_sort and nmod > 1 and cfg.d_ff % nmod == 0)
    cut = tp and not split_rows and ndp > 1 and t % ndp == 0
    if cut:   # the replicated batch's tokens in equal runs over data
        per = t // ndp
        toks = []
        for i in range(n):
            c = mesh.coords(i)
            r = 0
            for a in dp:
                r = r * mesh.shape[a] + c[a]
            toks.append(flat[i][r * per:(r + 1) * per])
    else:
        toks = flat
    split = ndp > 1 and (split_rows or cut)
    router = p["router"].gather()
    routed = [_route_probs({"router": router[i]}, toks[i], cfg)
              for i in range(n)]
    if split:
        counts = dist.psum([torch.bincount(ex.reshape(-1), minlength=e)
                            .float() for ex, _, _ in routed], mesh, dp)
        psums = dist.psum([pr.sum(0) for _, _, pr in routed], mesh, dp)
        total = ndp * toks[0].shape[0]
        aux = [e * torch.sum((c / (total * k)) * (ps / total))
               for c, ps in zip(counts, psums)]
    else:
        aux = [e * torch.sum(torch.bincount(ex.reshape(-1), minlength=e)
                             .float() / ex.numel() * pr.mean(0))
               for ex, _, pr in routed]

    names = ("w_gate", "w_up", "w_down")
    if not cfg.moe_locality_sort:
        w = [p[nm].gather() for nm in names]
        y = [_unsorted(toks[i], routed[i][0], routed[i][1],
                       *(wi[i] for wi in w)) for i in range(n)]
    elif tp:
        w = [p[nm].gather(dp_axes) for nm in names]
        cap = capacity(toks[0].shape[0], cfg)
        y = psum_model([_dispatch_capacity(
            toks[i], routed[i][0], routed[i][1], *(wi[i] for wi in w),
            e, cap) for i in range(n)], mesh, split_over(p["w_down"], 1,
                                                         ep_axis))
        if cut:
            y = dist.all_gather(y, mesh, axis=dp, dim=0)
    else:
        w = [p[nm].gather() for nm in names]
        y = [_dispatch_local(toks[i], routed[i][0], routed[i][1],
                             *(wi[i] for wi in w), e, 0) for i in range(n)]

    if cfg.num_shared_experts:
        sp = p["shared"]
        sg = {nm: sp[nm].gather(dp_axes) for nm in names}
        part = [_dense(silu(_dense(flat[i], sg["w_gate"][i]))
                       * _dense(flat[i], sg["w_up"][i]), sg["w_down"][i])
                for i in range(n)]
        shared = psum_model(part, mesh, split_over(sp["w_down"], 0))
        y = [yi + si for yi, si in zip(y, shared)]
    return [yi.reshape(b, s, d).to(COMPUTE_DTYPE) for yi in y], aux
