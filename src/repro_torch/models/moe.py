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

Not ported: the expert-parallel mode under ``shard_map`` and its
``_dispatch_capacity`` (``moe.py:72-108``, ``:156-194``), which need a
mesh: a ``mesh=`` argument raises (ROADMAP A8.8).
"""
from __future__ import annotations

import torch

from ..kernels.moe_gmm.ops import ragged_dot
from .config import ModelConfig
from .layers import COMPUTE_DTYPE, _dense, _normal, silu


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


def _route(p, x_flat, cfg: ModelConfig):
    """Top-k routing. Returns (experts (T,k) int64, gates (T,k), aux_loss).

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
    # Switch-style load-balancing auxiliary loss
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
    order = torch.argsort(flat_e, stable=True)          # the locality sort
    tok = order // k
    # Sorted row i's slot: token tok[i], rank = its place among the
    # token's k rows in the order of the sort (ascending expert id).
    _, jperm = torch.sort(flat_e.view(t, k), dim=1, stable=True)
    rank = torch.empty_like(jperm).scatter_(
        1, jperm, torch.arange(k, device=dev).expand(t, k).contiguous())
    dest = tok * k + rank.reshape(-1)[order]
    xs = _GatherRows.apply(x_flat, tok, dest, k)
    group_sizes = torch.bincount(flat_e, minlength=num_local + 1)[:num_local]
    ys = _expert_ffn_ragged(xs, w_gate, w_up, w_down, group_sizes)
    w = (gates.reshape(-1)[order] * owned[order]).to(ys.dtype)
    # The reference's segment_sum adds each token's k rows in bf16 in the
    # order of the sort. Scatter the weighted rows to (T, k, D) by slot and
    # add them one by one: a fixed order, where index_add_ on the card
    # would add in atomics.
    rows = torch.empty_like(ys).index_copy_(0, dest, ys * w[:, None])
    rows = rows.view(t, k, -1)
    y = rows[:, 0]
    for j in range(1, k):
        y = y + rows[:, j]
    return y


def apply_moe(p, x, cfg: ModelConfig, mesh=None):
    """x: (B, S, D). Returns (y (B, S, D) bf16, aux_loss)."""
    if mesh is not None:
        raise NotImplementedError(
            "expert-parallel MoE (a mesh) is not ported yet: ROADMAP A8.8")
    b, s, d = x.shape
    x_flat = x.reshape(b * s, d)
    experts, gates, aux = _route(p, x_flat, cfg)

    if not cfg.moe_locality_sort:
        # unsorted baseline: dense per-token einsum over gathered experts,
        # the "no reordering" control for the MoE benchmarks
        dt = COMPUTE_DTYPE
        wg = p["w_gate"][experts]   # (T, k, D, F): skew-random gathers
        wu = p["w_up"][experts]
        wd = p["w_down"][experts]
        xd = x_flat.to(dt)
        g = torch.einsum("td,tkdf->tkf", xd, wg.to(dt))
        u = torch.einsum("td,tkdf->tkf", xd, wu.to(dt))
        yk = torch.einsum("tkf,tkfd->tkd", silu(g) * u, wd.to(dt))
        y = torch.einsum("tkd,tk->td", yk, gates.to(dt))
    else:
        y = _dispatch_local(x_flat, experts, gates, p["w_gate"], p["w_up"],
                            p["w_down"], cfg.num_experts, 0)

    if cfg.num_shared_experts:
        sp = p["shared"]
        y = y + _dense(silu(_dense(x_flat, sp["w_gate"]))
                       * _dense(x_flat, sp["w_up"]), sp["w_down"])
    return y.reshape(b, s, d).to(COMPUTE_DTYPE), aux
