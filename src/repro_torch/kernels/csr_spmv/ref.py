"""Plain PyTorch version of the csr_spmv kernel (runs on any device)."""
from __future__ import annotations

import torch


def csr_spmv_ref(t_indptr: torch.Tensor, t_indices: torch.Tensor,
                 val: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y[v] = Σ_{u→v} w(u,v)·x[u] over the in-CSR arrays.

    The rows own edges ``[0, t_indptr[-1])``; ``t_indices``/``val`` may
    run longer (a row prefix of a larger CSR), and the tail is not read.
    """
    n = t_indptr.shape[0] - 1
    counts = (t_indptr[1:] - t_indptr[:-1]).long()
    t_dst = torch.repeat_interleave(
        torch.arange(n, device=t_indptr.device), counts)
    m = t_dst.shape[0]
    return torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(
        0, t_dst, x[t_indices[:m].long()] * val[:m])


def block_ranges(t_indptr: torch.Tensor,
                 blocks: int) -> list[tuple[int, int, int, int]]:
    """The kernel's partition: ``(lo, hi, row_first, row_last)`` a block.

    The row ends and the edges ``[t_indptr[0], t_indptr[-1])`` form one
    merged sequence, row r's end right after its last edge. Block b takes
    the items ``[b (n + E) // blocks, (b + 1) (n + E) // blocks)`` of it:
    the edges ``[lo, hi)`` and the rows ``[row_first, row_last)`` whose
    ends fall there. A row whose edges run past ``lo`` or ``hi`` is cut
    there; empty rows are items like any other.
    """
    if blocks < 1:
        raise ValueError("blocks must be at least 1")
    n = t_indptr.shape[0] - 1
    ip = t_indptr.long()
    e0 = int(ip[0])
    total = n + int(ip[n]) - e0
    # merge position of row r's end: r rows and end - e0 edges before it
    pos = torch.arange(n, device=ip.device) + ip[1:] - e0
    d = torch.tensor([total * b // blocks for b in range(blocks + 1)],
                     device=ip.device)
    rows = torch.searchsorted(pos, d).tolist()
    return [(e0 + int(d[b]) - rows[b], e0 + int(d[b + 1]) - rows[b + 1],
             rows[b], rows[b + 1]) for b in range(blocks)]


def csr_spmv_blocked_ref(t_indptr: torch.Tensor, t_indices: torch.Tensor,
                         val: torch.Tensor, x: torch.Tensor,
                         blocks: int, tile: int) -> torch.Tensor:
    """`csr_spmv_ref` computed through the CUDA kernel's partition.

    Blocks as `block_ranges` cuts them. A block walks its share of the
    merged sequence in tiles of ``tile`` items; the edges of one row in
    one tile form a part, summed in edge order, and a row's parts in the
    block are added in order. The row still open at a block's end carries
    that block's part to the block that finishes it, which adds the
    carried parts in block order and then its own. The kernel sums inside
    a tile by a segmented-scan tree, so its bits may differ from this
    model's; the partition, and so what each part holds, is the same.
    Plain PyTorch; the tests hold it to the reference, the wrapper never
    calls it.
    """
    if tile < 1:
        raise ValueError("tile must be at least 1")
    n = t_indptr.shape[0] - 1
    ends = t_indptr[1:].long()
    y = torch.zeros(n, dtype=x.dtype, device=x.device)
    open_row, carried = n, []   # row left open by earlier blocks, its parts
    for lo, hi, first, last in block_ranges(t_indptr, blocks):
        e = torch.arange(lo, hi, device=t_indptr.device)
        row = torch.searchsorted(ends, e, right=True)
        # an edge's place in the block's share: the edges and row ends of
        # the share before it
        part = (e - lo + row - first) // tile
        prod = val[lo:hi] * x[t_indices[lo:hi].long()]
        new = torch.ones(hi - lo, dtype=torch.bool, device=e.device)
        new[1:] = (row[1:] != row[:-1]) | (part[1:] != part[:-1])
        pid = torch.cumsum(new.long(), 0) - 1
        sums = torch.zeros(int(pid[-1]) + 1 if hi > lo else 0,
                           dtype=x.dtype, device=x.device).index_add_(
                               0, pid, prod)
        # a row's parts in order (index_add_ on the CPU adds in order)
        own = torch.zeros(last - first + 1, dtype=x.dtype,
                          device=x.device).index_add_(0, row[new] - first,
                                                      sums)
        if open_row < last and open_row == first:
            total = torch.zeros((), dtype=x.dtype, device=x.device)
            for p in carried:                    # block order
                total = total + p
            own[0] = total + own[0]
            open_row, carried = n, []
        y[first:last] = own[:-1]
        if last < n:                             # this block's part of it
            if open_row != last:
                open_row, carried = last, []
            carried.append(own[-1])
    return y
