"""The six GAP-style graph kernels in PyTorch (paper §5.1).

Each kernel is edge-parallel: gathers over the COO edge arrays and
segment reductions (`scatter_reduce_` / `index_add_`) back onto vertices,
inside a host loop that runs until the iteration converges — the
level-synchronous / iterative structure of the paper's C++ GAPS kernels.
Vertex property arrays are the reuse-heavy state the paper reorders for.
PageRank's pull relaxation always goes through the hand-written CUDA
SpMV (kernels/csr_spmv), whose wrapper runs its plain version on CPU
tensors.

Dtypes follow the JAX package with x64 off: depths, labels and distances
are int32, ranks and dependencies float32. Empty segments keep the
reduction's identity (INT32_MAX for min, False for max), as
``jax.ops.segment_min``/``segment_max`` do.

Batched multi-source forms carry a leading source axis (S, V) and follow
the semantics of a ``vmap`` over the single-source while loops: the loop
runs until every lane has converged, and a converged lane stays frozen.
The k-NN beam search (`knn_search_multi`) batches its query lanes the
same way.

Bucket padding: when a `GraphArrays` carries ``vertex_valid`` /
``edge_valid`` masks (shape-bucketed uploads, see engine/backends.py),
every kernel excludes sentinel edges and padded vertices, so results on
the real ``[:V]`` prefix are exactly the unpadded results.
"""
from __future__ import annotations

import torch

from ..kernels.csr_spmv.csr_spmv import csr_spmv
from .graph_arrays import GraphArrays

INF_I32 = 2**31 - 1


def _seg_sum(vals: torch.Tensor, segs: torch.Tensor, n: int) -> torch.Tensor:
    """Sum ``vals`` (..., E) into (..., n) by segment id ``segs`` (E,)."""
    out = torch.zeros(vals.shape[:-1] + (n,), dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(vals.dim() - 1, segs, vals)


def _seg_min(vals: torch.Tensor, segs: torch.Tensor, n: int) -> torch.Tensor:
    """Segment min of int32 ``vals``; empty segments hold INT32_MAX."""
    out = torch.full(vals.shape[:-1] + (n,), INF_I32, dtype=vals.dtype,
                     device=vals.device)
    return out.scatter_reduce_(-1, segs.expand_as(vals), vals, "amin",
                               include_self=True)


def _seg_any(vals: torch.Tensor, segs: torch.Tensor, n: int) -> torch.Tensor:
    """Segment max of bool ``vals``; empty segments hold False."""
    out = torch.zeros(vals.shape[:-1] + (n,), dtype=torch.int32,
                      device=vals.device)
    return out.scatter_reduce_(-1, segs.expand_as(vals), vals.int(), "amax",
                               include_self=True) > 0


def _sources(sources, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(sources, device=device).to(torch.long).reshape(-1)


# ---------------------------------------------------------------------- BFS
def bfs_multi(g: GraphArrays, sources) -> torch.Tensor:
    """Batched level-synchronous BFS (push): (S,) sources -> (S, V) int32
    depth rows, -1 unreached."""
    n, dev = g.num_vertices, g.device
    srcs = _sources(sources, dev)
    lanes = torch.arange(srcs.shape[0], device=dev)
    src, dst = g.src.long(), g.indices.long()
    depth = torch.full((srcs.shape[0], n), -1, dtype=torch.int32, device=dev)
    depth[lanes, srcs] = 0
    front = torch.zeros((srcs.shape[0], n), dtype=torch.bool, device=dev)
    front[lanes, srcs] = True
    level = 0
    while bool(front.any()):
        # gather(prop, src) over the edge array: the hot access the paper
        # optimizes — property reads follow g.indices / g.src layout.
        active = front[:, src]
        if g.edge_valid is not None:
            active &= g.edge_valid
        new = _seg_any(active, dst, n) & (depth < 0)
        depth = torch.where(new, level + 1, depth)
        front = new
        level += 1
    return depth


def bfs(g: GraphArrays, source) -> torch.Tensor:
    """Level-synchronous BFS (push). Returns depth (V,), -1 unreached."""
    return bfs_multi(g, source)[0]


# ----------------------------------------------------------------- PageRank
def pagerank(g: GraphArrays, num_iters: int = 20, damping: float = 0.85,
             tol: float = 1e-6) -> torch.Tensor:
    return pagerank_spmv(g, spmv_values(g), num_iters, damping, tol)


def _pagerank(g: GraphArrays, num_iters, damping, tol, relax):
    """Pull-mode PR: r[v] = (1-d)/N + d * Σ_{u→v} r[u]/outdeg[u].

    ``relax(contrib)`` computes the pull sum. With bucket masks, N is the
    count of *real* vertices and all rank mass stays on real vertices;
    padded vertices hold rank 0 throughout, so the real prefix matches
    the unpadded run. Stops after ``num_iters`` or once the L1 change is
    at most ``tol``, like the reference's ``while_loop``.
    """
    n, dev = g.num_vertices, g.device
    f32 = torch.float32
    valid = g.vertex_valid
    if valid is None:
        n_real = torch.tensor(float(n), dtype=f32, device=dev)
        dangling_mask = g.out_degree == 0
    else:
        n_real = valid.sum().to(f32)
        dangling_mask = (g.out_degree == 0) & valid
    d = torch.tensor(damping, dtype=f32, device=dev)
    base = (1.0 - d) / n_real
    outdeg = torch.clamp_min(g.out_degree, 1).to(f32)

    r = torch.ones(n, dtype=f32, device=dev) / n_real
    if valid is not None:
        r = torch.where(valid, r, 0.0)
    it, err = 0, float("inf")
    while it < num_iters and err > tol:
        contrib = r / outdeg
        summed = relax(contrib)
        # dangling mass redistributed uniformly (GAP semantics)
        dangling = torch.where(dangling_mask, r, 0.0).sum()
        r_new = base + d * (summed + dangling / n_real)
        if valid is not None:
            r_new = torch.where(valid, r_new, 0.0)
        err = float((r_new - r).abs().sum())
        r = r_new
        it += 1
    return r


def spmv_values(g: GraphArrays) -> torch.Tensor:
    """PR's SpMV edge values in in-CSR order: 1 on real edges, 0 on
    sentinels (`to_device` keeps real edges on the ``[:E]`` prefix of
    both CSR views, so ``edge_valid`` aligns with the in-CSR too)."""
    if g.edge_valid is None:
        return torch.ones(g.num_edges, dtype=torch.float32, device=g.device)
    return g.edge_valid.to(torch.float32)


def pagerank_spmv(g: GraphArrays, spmv_val: torch.Tensor,
                  num_iters: int = 20, damping: float = 0.85,
                  tol: float = 1e-6, *,
                  num_rows: int | None = None) -> torch.Tensor:
    """`_pagerank` with the pull relaxation on the CSR SpMV kernel
    (kernels/csr_spmv) over ``g.t_indptr``/``g.t_indices``: one launch
    per iteration.

    ``spmv_val`` is `spmv_values(g)`: sentinel edges of bucketed uploads
    carry 0 so they contribute nothing. ``num_rows`` (the real vertex
    count of a bucketed upload) limits the kernel to the real rows: the
    padded vertices are the suffix ``[num_rows, V)``, their rank is
    masked to 0, and the last of them owns every sentinel edge — one row
    of up to half the edge bucket that a warp would walk alone. Their
    sums are 0 either way.
    """
    n = g.num_vertices
    rows = n if num_rows is None else num_rows
    if rows < n and g.vertex_valid is None:
        raise ValueError("num_rows < V needs a bucketed upload")

    def relax(contrib):
        y = csr_spmv(g.t_indptr[:rows + 1], g.t_indices, spmv_val,
                     contrib[:rows])
        return y if rows == n else torch.nn.functional.pad(y, (0, n - rows))

    return _pagerank(g, num_iters, damping, tol, relax)


# ------------------------------------------------- Connected Components (LP)
def cc_labelprop(g: GraphArrays) -> torch.Tensor:
    """CC by iterative min-label propagation over the symmetrized edges."""
    n, dev = g.num_vertices, g.device
    src, dst = g.src.long(), g.indices.long()
    lab = torch.arange(n, dtype=torch.int32, device=dev)
    while True:
        lab_src, lab_dst = lab[src], lab[dst]
        if g.edge_valid is not None:
            lab_src = torch.where(g.edge_valid, lab_src, INF_I32)
            lab_dst = torch.where(g.edge_valid, lab_dst, INF_I32)
        m1 = _seg_min(lab_src, dst, n)
        m2 = _seg_min(lab_dst, src, n)
        new = torch.minimum(lab, torch.minimum(m1, m2))
        changed = bool((new != lab).any())
        lab = new
        if not changed:
            return lab


# ------------------------------------------- Connected Components (CC-SV)
def cc_shiloach_vishkin(g: GraphArrays) -> torch.Tensor:
    """Shiloach-Vishkin: alternating hook + pointer-jumping (paper's CC_SV)."""
    n, dev = g.num_vertices, g.device
    src, dst = g.src.long(), g.indices.long()
    parent = torch.arange(n, dtype=torch.int32, device=dev)
    while True:
        pu, pv = parent[src], parent[dst]
        # hook: root(pu) adopts smaller pv (and symmetrically)
        lo = torch.minimum(pu, pv)
        hi = torch.maximum(pu, pv)
        if g.edge_valid is not None:
            # sentinel edges hook nothing: min with INF is a no-op
            lo = torch.where(g.edge_valid, lo, INF_I32)
            hi = torch.where(g.edge_valid, hi, 0)
        p = parent.clone().scatter_reduce_(0, hi.long(), lo, "amin",
                                           include_self=True)
        # pointer jumping to full compression
        while True:
            p2 = p[p.long()]
            jumped = bool((p2 != p).any())
            p = p2
            if not jumped:
                break
        changed = bool((p != parent).any())
        parent = p
        if not changed:
            return parent


# -------------------------------------------------------- SSSP (Bellman-Ford)
def sssp_multi(g: GraphArrays, sources) -> torch.Tensor:
    """Batched Bellman-Ford: (S,) sources -> (S, V) int32 distance rows,
    INT32_MAX unreached."""
    n, dev = g.num_vertices, g.device
    srcs = _sources(sources, dev)
    lanes = torch.arange(srcs.shape[0], device=dev)
    src, dst = g.src.long(), g.indices.long()
    dist = torch.full((srcs.shape[0], n), INF_I32, dtype=torch.int32,
                      device=dev)
    dist[lanes, srcs] = 0
    changed, it = True, 0
    while changed and it < n:
        du = dist[:, src]
        cand = torch.where(du == INF_I32, INF_I32, du + g.weights)
        if g.edge_valid is not None:
            cand = torch.where(g.edge_valid, cand, INF_I32)
        new = torch.minimum(dist, _seg_min(cand, dst, n))
        changed = bool((new != dist).any())
        dist = new
        it += 1
    return dist


def sssp(g: GraphArrays, source) -> torch.Tensor:
    """Bellman-Ford with edge-parallel relaxation (paper's SSSP)."""
    return sssp_multi(g, source)[0]


# -------------------------------------------- Betweenness Centrality (Brandes)
def bc_multi(g: GraphArrays, sources) -> torch.Tensor:
    """Batched Brandes: (S,) sources -> (S, V) float32 dependencies.

    Each lane runs its own number of levels (``lane_max`` = its deepest
    BFS level): the forward sweep takes levels ``0..lane_max`` and the
    backward sweep levels ``lane_max-1..0``; steps past a lane's own
    count are masked out, so the lane stays frozen as under ``vmap``.
    """
    n, dev = g.num_vertices, g.device
    srcs = _sources(sources, dev)
    lanes = torch.arange(srcs.shape[0], device=dev)
    src, dst = g.src.long(), g.indices.long()
    depth = bfs_multi(g, srcs)
    lane_max = depth.max(dim=1).values[:, None]      # (S, 1)
    steps = int(lane_max.max())

    # forward: path counts sigma, level-synchronous over out-edges
    sigma = torch.zeros((srcs.shape[0], n), dtype=torch.float32, device=dev)
    sigma[lanes, srcs] = 1.0
    du, dv = depth[:, src], depth[:, dst]
    tree_edge = (dv == du + 1) & (du >= 0)
    if g.edge_valid is not None:
        tree_edge &= g.edge_valid
    for level in range(steps + 1):
        mask = tree_edge & (du == level) & (level <= lane_max)
        sigma = sigma + _seg_sum(torch.where(mask, sigma[:, src], 0.0),
                                 dst, n)

    # backward: delta[u] += sigma[u]/sigma[v] * (1 + delta[v]) on tree edges
    ratio = sigma[:, src] / torch.clamp_min(sigma[:, dst], 1e-30)
    delta = torch.zeros((srcs.shape[0], n), dtype=torch.float32, device=dev)
    for i in range(steps):
        mask = tree_edge & (du == lane_max - 1 - i) & (i < lane_max)
        contrib = torch.where(mask, ratio * (1.0 + delta[:, dst]), 0.0)
        delta = delta + _seg_sum(contrib, src, n)
    delta[lanes, srcs] = 0.0
    return delta


def bc_single_source(g: GraphArrays, source) -> torch.Tensor:
    """Brandes dependency accumulation for one source (unweighted)."""
    return bc_multi(g, source)[0]


def bc_weighted(g: GraphArrays, sources, weights) -> torch.Tensor:
    """BC aggregate with per-source weights (0-weight lanes = padding)."""
    deltas = bc_multi(g, sources)
    w = torch.as_tensor(weights, dtype=torch.float32, device=g.device)
    return (deltas * w[:, None]).sum(dim=0)


def bc(g: GraphArrays, sources, chunk: int = 16) -> torch.Tensor:
    """BC over a source sample (GAP uses sampled sources for large graphs).

    Batched ``chunk`` sources at a time, which caps peak memory at
    ``chunk × E`` edge state; only the final float32 accumulation order
    depends on the chunking.
    """
    srcs = _sources(sources, g.device)
    out = torch.zeros(g.num_vertices, dtype=torch.float32, device=g.device)
    for i in range(0, srcs.shape[0], chunk):
        out = out + bc_multi(g, srcs[i:i + chunk]).sum(dim=0)
    return out


# ------------------------------------------------------- k-NN beam search
#
# Greedy best-first traversal of a fixed out-degree k-NN graph with a
# bounded beam (the reference's `knn_search`, one `lax.while_loop` per
# query, vmapped over the batch). Candidates rank by the pair
#
#     (float32_dist_bits, canonical_id)
#
# squared-L2 distances are non-negative, so their float32 bit patterns
# order like the floats as int32, and the canonical (original) vertex id
# breaks every distance tie the same way in every layout. Both halves are
# non-negative int32, so the int64 key ``bits·2³¹ + tie`` is that pair's
# total order, and one stable sort of it is the reference's
# ``lexsort((tie, bits))``. KNN_SENTINEL exceeds the bits of any real
# distance (+inf is 0x7F800000), so empty slots and visited candidates
# sort last.

KNN_SENTINEL = 2**31 - 1  # int32 max
# Beam-search loop iterations since import (or since a caller last reset
# it), over every `knn_search_multi` call: each ends in one host sync.
knn_iterations = 0


def _dist_bits(dist: torch.Tensor) -> torch.Tensor:
    return dist.to(torch.float32).contiguous().view(torch.int32)


def _rank_key(bits: torch.Tensor, tie: torch.Tensor) -> torch.Tensor:
    """The int64 key whose order is the lexicographic order of
    ``(bits, tie)``, both non-negative int32."""
    return (bits.long() << 31) | tie.long()


def _first_argmin(vals: torch.Tensor) -> torch.Tensor:
    """Index of the first minimum along the last axis (``jnp.argmin``'s
    tie rule), spelled out so that no backend's argmin decides it."""
    pos = torch.arange(vals.shape[-1], device=vals.device)
    at_min = vals == vals.amin(-1, keepdim=True)
    return torch.where(at_min, pos, vals.shape[-1]).amin(-1)


def knn_search_multi(g: GraphArrays, vectors: torch.Tensor,
                     canon: torch.Tensor, entry, queries: torch.Tensor,
                     valid: torch.Tensor, *, k_out: int, beam_width: int,
                     k_return: int, max_steps: int
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched beam search: (S, d) queries -> ((S, k_return) int32 served
    ids, -1 in empty slots; (V,) int32 visit counts).

    ``vectors`` (V, d) are in served order, ``canon`` (V,) maps served to
    original ids, ``entry`` is the served id every lane starts from, and
    ``valid`` (S,) masks pad lanes out of the visit counts. Every row of
    ``g`` holds exactly ``k_out`` neighbours.

    Each lane carries its beam (``bits``, ``tie``, ``ids``, ``exp``,
    (S, beam_width)) and its (S, V) visited mask. A lane is active while
    it has an unexpanded real candidate; an inactive lane is frozen, as
    under the reference's vmapped ``while_loop``, and never wakes, since
    its state no longer changes. The loop runs at most ``max_steps``
    iterations and stops once no lane is active: one host sync an
    iteration.
    """
    global knn_iterations
    dev = vectors.device
    n = g.num_vertices
    sent = KNN_SENTINEL
    q = queries.to(device=dev, dtype=torch.float32)
    s = q.shape[0]
    lanes = torch.arange(s, device=dev)
    indices = g.indices.long()
    indptr = g.indptr.long()
    offs = torch.arange(k_out, device=dev)

    def dists(ids):   # (S, m) served ids -> (S, m) float32 distances
        diff = vectors[ids] - q[:, None, :]
        return (diff * diff).sum(-1)

    e = torch.as_tensor(entry, device=dev).long().reshape(())
    bits = torch.full((s, beam_width), sent, dtype=torch.int32, device=dev)
    bits[:, 0] = _dist_bits(dists(e.expand(s)[:, None]))[:, 0]
    tie = torch.full((s, beam_width), sent, dtype=torch.int32, device=dev)
    tie[:, 0] = canon[e]
    ids = torch.zeros((s, beam_width), dtype=torch.int32, device=dev)
    ids[:, 0] = e.to(torch.int32)
    exp = torch.zeros((s, beam_width), dtype=torch.bool, device=dev)
    visited = torch.zeros((s, n), dtype=torch.bool, device=dev)
    visited[:, e] = True
    fresh_exp = torch.zeros((s, k_out), dtype=torch.bool, device=dev)

    for _ in range(max_steps):
        active = (~exp & (bits < sent)).any(-1)
        if not bool(active.any()):
            break
        knn_iterations += 1
        # nearest unexpanded slot: min bits first, the canonical id breaks
        # distance ties (each vertex enters a beam at most once)
        m = torch.where(exp, sent, bits).amin(-1, keepdim=True)
        slot = _first_argmin(torch.where(exp | (bits != m), sent, tie))
        v = ids[lanes, slot].long()
        exp[lanes, slot] |= active
        nbrs = indices[indptr[v][:, None] + offs]              # (S, k_out)
        seen = visited.gather(1, nbrs)
        fresh = ~seen
        visited.scatter_(1, nbrs, seen | active[:, None])
        nbits = torch.where(fresh, _dist_bits(dists(nbrs)), sent)
        ntie = torch.where(fresh, canon[nbrs], sent)
        all_bits = torch.cat([bits, nbits], 1)
        all_tie = torch.cat([tie, ntie], 1)
        all_ids = torch.cat([ids, nbrs.to(torch.int32)], 1)
        all_exp = torch.cat([exp, fresh_exp], 1)
        keep = torch.sort(_rank_key(all_bits, all_tie), dim=1,
                          stable=True).indices[:, :beam_width]
        live = active[:, None]
        bits = torch.where(live, all_bits.gather(1, keep), bits)
        tie = torch.where(live, all_tie.gather(1, keep), tie)
        ids = torch.where(live, all_ids.gather(1, keep), ids)
        exp = torch.where(live, all_exp.gather(1, keep), exp)

    # the beam stays sorted by every merge, so its head is the result
    top = torch.where(bits[:, :k_return] < sent, ids[:, :k_return], -1)
    valid = torch.as_tensor(valid, device=dev).bool()
    visits = (visited & valid[:, None]).sum(0, dtype=torch.int32)
    return top, visits


def knn_search(g: GraphArrays, vectors: torch.Tensor, canon: torch.Tensor,
               entry, query: torch.Tensor, *, k_out: int, beam_width: int,
               k_return: int, max_steps: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """One query -> ``(ids, visited)``: the ``k_return`` nearest served
    ids found (-1 in empty slots) and the (V,) bool visited mask."""
    ids, visits = knn_search_multi(
        g, vectors, canon, entry, query.reshape(1, -1),
        torch.ones(1, dtype=torch.bool), k_out=k_out, beam_width=beam_width,
        k_return=k_return, max_steps=max_steps)
    return ids[0], visits > 0


KERNELS = {
    "bfs": lambda g, src=0: bfs(g, src),
    "pr": lambda g: pagerank(g),
    "cc": lambda g: cc_labelprop(g),
    "ccsv": lambda g: cc_shiloach_vishkin(g),
    "sssp": lambda g, src=0: sssp(g, src),
    "bc": lambda g, sources=(0, 1, 2, 3): bc(g, sources),
}
