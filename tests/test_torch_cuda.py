"""PyTorch port on a CUDA card: the hand-written kernels, the engine and
the LM slice.

Every test here needs a card; each decides inside itself and skips with
a reason where there is none. The file imports neither JAX nor `repro`,
so it runs on a host that has only the port's dependencies::

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

The SpMV kernel is held to its plain version at rtol 1e-5 / atol 1e-6:
the float32 sums of a row are taken in another order. It is also held,
at the same tolerance, to the plain model of its partition
(``ref.csr_spmv_blocked_ref``: equal shares of the merged row ends and
edges a block, rows cut at share and step boundaries, parts added in
block order), and every result must
repeat bit for bit. The flash kernel is
held to its plain version at the reference test's tolerances
(tests/test_kernels.py: float32 rtol 1e-3 / atol 2e-3, bf16 5e-2), and
with its prefix-LM and bidirectional masks and at head dims 80 and 256
to one bf16 unit of the output (`FLASH_MASK_TOL`), the
hot-slab gather exactly; grouped-query calls (k and v of BH / group
rows) must also give the bits of the same kernel on k and v repeated per
query row, and multi-head calls the bits the kernel gave before it took
grouped-query attention (`MHA_DIGESTS`). k-NN search served through
`EngineSession` on the card must give the CPU session's ids and visits
bit for bit on integer-valued vectors. The grouped matmul is held to its plain version
(float32 products, one float32 matmul per group) at rtol/atol 1e-4 for a
float32 result: bf16 products are exact in float32, so only the order of
the sums differs. A bf16 result must equal the kernel's float32 result
rounded to bf16: the kernel rounds the same sums once. Each of its two
bf16 variants (``wgmma``, ``splitk``) is held so, forced by ``variant=``;
their bits need not agree with each other. The smoke models of every
trunk (attention, RWKV6, the Mamba2 hybrid) are held to the same weights
on the CPU at tests/test_models.py's decode standard.
"""
from __future__ import annotations

import hashlib
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.csr import from_edges  # noqa: E402
from repro_torch.engine import BatchedExecutor, EngineSession  # noqa: E402
from repro_torch.kernels.csr_spmv import csr_spmv as spmv_mod  # noqa: E402
from repro_torch.kernels.csr_spmv.ref import (csr_spmv_blocked_ref,  # noqa: E402
                                             csr_spmv_ref)
from repro_torch.kernels.flash_attn import flash_attn as fa  # noqa: E402
from repro_torch.kernels.flash_attn.ref import (attention_bwd_ref,  # noqa: E402
                                               attention_ref)
from repro_torch.kernels.hot_embed import hot_embed as he  # noqa: E402
from repro_torch.kernels.hot_embed.ops import hot_cold_lookup  # noqa: E402
from repro_torch.kernels.hot_embed.ref import hot_gather_ref  # noqa: E402
from repro_torch.kernels.moe_gmm import moe_gmm as gmm_mod  # noqa: E402
from repro_torch.kernels.moe_gmm.ops import (grouped_matmul,  # noqa: E402
                                             ragged_dot)
from repro_torch.kernels.moe_gmm.ref import (gmm_grouped_ref,  # noqa: E402
                                             gmm_ref, gmm_splitk_ref,
                                             tgmm_grouped_ref)

TOL = dict(rtol=1e-5, atol=1e-6)


def _card() -> torch.device:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _in_csr(g, dev):
    t = g.transpose
    return (torch.from_numpy(np.asarray(t.indptr, np.int32)).to(dev),
            torch.from_numpy(np.asarray(t.indices, np.int32)).to(dev))


@pytest.mark.parametrize("num_vertices,num_edges", [
    (1, 0), (40, 39), (700, 20_000), (3000, 5000)])
def test_kernel_matches_plain_version(num_vertices, num_edges):
    """Random graphs: fewer edges than the grid has blocks, rows shorter
    and longer than a block's range, and empty rows."""
    dev = _card()
    rng = np.random.default_rng(num_edges)
    g = from_edges(num_vertices, rng.integers(0, num_vertices, num_edges),
                   rng.integers(0, num_vertices, num_edges))
    ip, ix = _in_csr(g, dev)
    val = torch.from_numpy(rng.random(num_edges, np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal(num_vertices)
                         .astype(np.float32)).to(dev)
    launches = spmv_mod.launches
    got = spmv_mod.csr_spmv(ip, ix, val, x)
    again = spmv_mod.csr_spmv(ip, ix, val, x)
    torch.cuda.synchronize()
    assert spmv_mod.launches == launches + 2
    assert got.dtype == torch.float32 and got.shape == (num_vertices,)
    assert torch.equal(got, again)  # fixed summation order: same bits
    torch.testing.assert_close(got, csr_spmv_ref(ip, ix, val, x), **TOL)


def test_kernel_one_long_row():
    """A hub row of 100k in-edges, summed in parts by the blocks whose
    shares it crosses and added in block order, beside short rows."""
    dev = _card()
    rng = np.random.default_rng(1)
    n = 2000
    src = np.concatenate([rng.integers(0, n, 100_000),
                          rng.integers(0, n, 3000)])
    dst = np.concatenate([np.zeros(100_000, np.int64),
                          rng.integers(1, n, 3000)])
    ip, ix = _in_csr(from_edges(n, src, dst), dev)
    val = torch.ones(ix.numel(), device=dev)
    x = torch.from_numpy(rng.random(n, np.float32)).to(dev)
    got = spmv_mod.csr_spmv(ip, ix, val, x)
    # float64 on the host: the exact sum to hold the warp's float32 to
    want = csr_spmv_ref(ip.cpu(), ix.cpu(), val.cpu().double(),
                        x.cpu().double())
    torch.testing.assert_close(got.cpu().double(), want, **TOL)


def _spmv_holds(ip, ix, val, x, model=True):
    """The kernel against its plain version and the model of its
    partition; two runs must give the same bits. Returns the result."""
    launches = spmv_mod.launches
    got = spmv_mod.csr_spmv(ip, ix, val, x)
    again = spmv_mod.csr_spmv(ip, ix, val, x)
    torch.cuda.synchronize()
    assert spmv_mod.launches == launches + 2
    assert got.dtype == torch.float32 and got.shape == (ip.numel() - 1,)
    assert torch.equal(got, again)
    torch.testing.assert_close(got, csr_spmv_ref(ip, ix, val, x), **TOL)
    if model:   # the kernel's own grid and step of 2,048 items
        want = csr_spmv_blocked_ref(ip.cpu(), ix.cpu(), val.cpu(), x.cpu(),
                                    spmv_mod.blocks(x.device.index), 2048)
        torch.testing.assert_close(got.cpu(), want, **TOL)
    return got


def _random_csr(rng, num_vertices, num_edges, dev):
    g = from_edges(num_vertices, rng.integers(0, num_vertices, num_edges),
                   rng.integers(0, num_vertices, num_edges))
    ip, ix = _in_csr(g, dev)
    val = torch.from_numpy(rng.random(num_edges, np.float32)).to(dev)
    x = torch.from_numpy(rng.standard_normal(num_vertices)
                         .astype(np.float32)).to(dev)
    return ip, ix, val, x


@pytest.mark.parametrize("edges_per_block", [0.5, 1, 700, 2048, 5000,
                                             12_000])
def test_kernel_across_block_ranges(edges_per_block):
    """Random graphs sized by the card's grid: blocks with less than one
    edge, with one, inside one 2,048-edge chunk, about one chunk, and
    several chunks, so that rows cross 1, 2 and many blocks' shares."""
    dev = _card()
    blocks = spmv_mod.blocks(torch.cuda.current_device())
    num_edges = int(edges_per_block * blocks)
    rng = np.random.default_rng(num_edges)
    num_vertices = max(1, num_edges // 12)
    _spmv_holds(*_random_csr(rng, num_vertices, num_edges, dev))


def test_kernel_hub_across_ranges_repeats_its_bits():
    """The 100k-edge hub spans many blocks' ranges; its parts are added
    in block order by the second kernel, so five runs give one result."""
    dev = _card()
    rng = np.random.default_rng(2)
    n = 2000
    g = from_edges(n, rng.integers(0, n, 103_000),
                   np.concatenate([np.zeros(100_000, np.int64),
                                   rng.integers(1, n, 3000)]))
    ip, ix = _in_csr(g, dev)
    val = torch.from_numpy(rng.random(ix.numel(), np.float32)).to(dev)
    x = torch.from_numpy(rng.random(n, np.float32)).to(dev)
    got = _spmv_holds(ip, ix, val, x)
    for _ in range(3):
        assert torch.equal(spmv_mod.csr_spmv(ip, ix, val, x), got)


@pytest.mark.parametrize("rows", ["all", "real"])
def test_kernel_bucketed_upload(rows):
    """A bucketed upload: its full ``t_indptr``, whose last padded row
    holds every sentinel edge (half the edge bucket), or its real rows
    only, as PR's relaxation passes them, so that ``t_indptr[-1]`` is
    less than ``len(t_indices)``."""
    from repro_torch.algos.graph_arrays import to_device
    from repro_torch.core.generators import powerlaw_community
    from repro_torch.engine.backends import bucket_dims
    dev = _card()
    g = powerlaw_community(50_000, avg_degree=12.0, seed=3)
    ga = to_device(g, pad_to=bucket_dims(g.num_vertices, g.num_edges),
                   device=dev)
    n = ga.num_vertices if rows == "all" else g.num_vertices
    ip = ga.t_indptr[:n + 1]
    assert rows == "all" or int(ip[-1]) < ga.t_indices.numel()
    x = torch.from_numpy(np.random.default_rng(4).random(n, np.float32))
    _spmv_holds(ip, ga.t_indices, ga.edge_valid.to(torch.float32),
                x.to(dev))


def test_kernel_rows_ending_on_boundaries():
    """Rows of 512 edges and empty rows that end exactly on every
    2,048-edge chunk boundary and on every block's share: 8 rows of 512
    edges and one empty row a block, 4,105 items, so each share ends
    right after an empty row's end."""
    dev = _card()
    blocks = spmv_mod.blocks(torch.cuda.current_device())
    deg = np.tile([512] * 8 + [0], blocks)
    rng = np.random.default_rng(5)
    ip = torch.from_numpy(np.concatenate([[0], np.cumsum(deg)])
                          .astype(np.int32)).to(dev)
    e = int(deg.sum())
    assert e == 4096 * blocks
    ix = torch.from_numpy(rng.integers(0, deg.size, e, dtype=np.int32))
    val = torch.from_numpy(rng.random(e, np.float32))
    x = torch.from_numpy(rng.random(deg.size, np.float32))
    _spmv_holds(ip, ix.to(dev), val.to(dev), x.to(dev))


def test_kernel_one_vertex():
    dev = _card()
    rng = np.random.default_rng(6)
    ip = torch.tensor([0, 5000], dtype=torch.int32, device=dev)
    ix = torch.zeros(5000, dtype=torch.int32, device=dev)
    val = torch.from_numpy(rng.random(5000, np.float32)).to(dev)
    x = torch.tensor([0.5], device=dev)
    got = _spmv_holds(ip, ix, val, x)
    assert got.shape == (1,)


@pytest.mark.parametrize("offsets", [(1, 0, 0), (0, 1, 3), (2, 3, 1)],
                         ids=["indices", "values", "all"])
def test_kernel_takes_unaligned_views(offsets):
    """Views at 4-byte but not 16-byte offsets: the bulk copies widen to
    16-byte boundaries and the elements outside the array come from
    plain loads."""
    dev = _card()
    rng = np.random.default_rng(7)
    ip, ix, val, x = _random_csr(rng, 3000, 40_000, dev)
    views = []
    for t, off in zip((ip, ix, val), offsets):
        v = torch.empty(t.numel() + off, dtype=t.dtype, device=dev)[off:]
        v.copy_(t)
        assert off == 0 or v.data_ptr() % 16 != 0
        views.append(v)
    got = _spmv_holds(*views, x)
    assert torch.equal(got, spmv_mod.csr_spmv(ip, ix, val, x))


def test_kernel_does_not_sync_with_the_host():
    """No host read of the edge count or anything else: the wrapper runs
    under ``set_sync_debug_mode("error")``, on a bucketed prefix."""
    dev = _card()
    rng = np.random.default_rng(8)
    ip, ix, val, x = _random_csr(rng, 5000, 60_000, dev)
    spmv_mod.csr_spmv(ip, ix, val, x)   # load the library first
    pad = torch.zeros(1000, dtype=torch.int32, device=dev)
    ixp, valp = torch.cat([ix, pad]), torch.cat([val, pad.float()])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = spmv_mod.csr_spmv(ip, ixp, valp, x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.testing.assert_close(got, csr_spmv_ref(ip, ix, val, x), **TOL)


def test_kernel_refuses_bad_operands_on_the_card():
    """On a CUDA tensor the wrapper launches the kernel or raises; it
    never hands the call to the plain version."""
    dev = _card()
    ip = torch.tensor([0, 1, 2], dtype=torch.int32, device=dev)
    ix = torch.tensor([1, 0], dtype=torch.int32, device=dev)
    val = torch.ones(2, device=dev)
    x = torch.ones(2, device=dev)
    launches = spmv_mod.launches
    with pytest.raises(TypeError):
        spmv_mod.csr_spmv(ip.long(), ix, val, x)
    with pytest.raises(ValueError, match="is on"):
        spmv_mod.csr_spmv(ip.cpu(), ix, val, x)
    with pytest.raises(ValueError, match="entries for 2 rows"):
        spmv_mod.csr_spmv(ip, ix, val, torch.ones(3, device=dev))
    assert spmv_mod.launches == launches
    empty = spmv_mod.csr_spmv(ip[:1], ix[:0], val[:0], x[:0])
    assert empty.shape == (0,) and spmv_mod.launches == launches


def test_engine_serves_on_the_card_by_default(plc_graph):
    """No ``device=``: the executor lands on CUDA, PR goes through the
    kernel, and every answer equals the same session on the CPU."""
    _card()
    ex = BatchedExecutor()
    assert ex.device.type == "cuda"
    card = EngineSession(executor=ex, redecide_min_queries=10**6)
    host = EngineSession(device="cpu", redecide_min_queries=10**6)
    srcs = np.array([5, 321, 1500])
    for s in (card, host):
        s.register(plc_graph, graph_id="g", expected_queries=256)
    launches = spmv_mod.launches
    for kernel, sources in (("bfs", srcs), ("sssp", srcs), ("cc", None),
                            ("ccsv", None)):
        np.testing.assert_array_equal(card.submit("g", kernel, sources),
                                      host.submit("g", kernel, sources))
    np.testing.assert_allclose(card.submit("g", "bc", srcs),
                               host.submit("g", "bc", srcs),
                               rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(card.submit("g", "pr"), host.submit("g", "pr"),
                               rtol=1e-4, atol=1e-9)
    assert spmv_mod.launches > launches
    assert card.telemetry()["executor"]["single"]["spmv_pr"] is True


# ------------------------------------------------------------ flash_attn
FLASH_TOL = {torch.float32: dict(rtol=1e-3, atol=2e-3),
             torch.bfloat16: dict(rtol=5e-2, atol=5e-2)}
# the masks and head dims 80 / 256 in bf16: kernel and plain version both
# keep PV in float32 and round once, so they part by at most one bf16 unit
# of the output (2^-7 of it); atol covers outputs near zero
FLASH_MASK_TOL = dict(rtol=8e-3, atol=1e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("window", [0, 128])
@pytest.mark.parametrize("bh,s,d", [
    (2, 256, 64), (1, 512, 128), (3, 256, 32),   # tests/test_kernels.py
    (2, 300, 64), (1, 77, 16), (1, 1, 32)])      # S not a multiple of 256
def test_flash_matches_plain_version(bh, s, d, window, dtype):
    dev = _card()
    rng = np.random.default_rng(s * d + window)
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, s, d)).astype(
        np.float32)).to(dev, dtype) for _ in range(3))
    launches = fa.launches
    got = fa.flash_attention(q, k, v, window=window)
    again = fa.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert fa.launches == launches + 2
    assert got.dtype == dtype and got.shape == (bh, s, d)
    assert torch.equal(got, again)  # fixed loop order: same bits
    want = attention_ref(q, k, v, window=window)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_causality(dtype):
    """Future keys must not move the output (tests/test_kernels.py:89)."""
    dev = _card()
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 300, 32)).astype(
        np.float32)).to(dev, dtype) for _ in range(3))
    o1 = fa.flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 200:], v2[:, 200:] = 99.0, -99.0
    o2 = fa.flash_attention(q, k2, v2)
    assert torch.equal(o1[:, :200], o2[:, :200])


@pytest.mark.parametrize("bh", [1, 3])
@pytest.mark.parametrize("window", [0, 128, 1000])
@pytest.mark.parametrize("s", [1, 77, 128, 129, 300, 1024, 4096])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_wgmma_flash_matches_plain_version(d, s, window, bh):
    """The Hopper kernel (bf16 at the served head dims): one tile and
    less, a tile and one row, the ring wrapping many times (at d 256 two
    64-key tiles to a query tile, K and V in rings of their own), windows
    that cut tiles; the reference test's bf16 tolerance, the same bits on
    a repeat, every launch through the wgmma variant."""
    dev = _card()
    rng = np.random.default_rng(7 * s + d + window + bh)
    q, k, v = (torch.from_numpy(rng.standard_normal((bh, s, d)).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(3))
    before = dict(fa.launches_by_variant)
    got = fa.flash_attention(q, k, v, window=window)
    again = fa.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert fa.launches_by_variant == {
        **before, "wgmma": before["wgmma"] + 2}
    assert got.dtype == torch.bfloat16 and got.shape == (bh, s, d)
    assert torch.equal(got, again)
    want = attention_ref(q, k, v, window=window)
    torch.testing.assert_close(got.float(), want.float(),
                               **FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("sm_scale", [-0.3, 0.02])
@pytest.mark.parametrize("d", [64, 128, 256])
def test_wgmma_flash_takes_any_scale(d, sm_scale):
    """Off the masked tiles the kernel takes the row max on the raw
    logits (the min, for a negative scale) and folds the scale into the
    exponent; both signs against the plain version."""
    dev = _card()
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 700, d)).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(3))
    got = fa.flash_attention(q, k, v, sm_scale=sm_scale, window=300)
    want = attention_ref(q, k, v, sm_scale=sm_scale, window=300)
    torch.testing.assert_close(got.float(), want.float(),
                               **FLASH_TOL[torch.bfloat16])


@pytest.mark.parametrize("d", [64, 128, 256])
def test_wgmma_flash_causality(d):
    """Future keys, in the same tile and in later ones, must not move the
    output of the Hopper kernel."""
    dev = _card()
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 600, d)).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(3))
    o1 = fa.flash_attention(q, k, v)
    k2, v2 = k.clone(), v.clone()
    k2[:, 200:], v2[:, 200:] = 99.0, -99.0
    o2 = fa.flash_attention(q, k2, v2)
    assert torch.equal(o1[:, :200], o2[:, :200])
    assert not torch.equal(o1[:, 200:], o2[:, 200:])


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 16, "mma_sync"), (torch.bfloat16, 32, "mma_sync"),
    (torch.float32, 32, "simt"), (torch.float32, 128, "simt"),
    (torch.bfloat16, 256, "wgmma")])
def test_flash_launches_its_variant(dtype, d, want):
    """Each (dtype, head dim) reaches the kernel `variant` names, once."""
    dev = _card()
    q = torch.randn(2, 130, d, generator=torch.Generator().manual_seed(d))
    q = q.to(dev, dtype)
    before = dict(fa.launches_by_variant)
    fa.flash_attention(q, q, q)
    torch.cuda.synchronize()
    assert fa.variant(dtype, d) == want
    assert fa.launches_by_variant == {**before, want: before[want] + 1}


def test_flash_refuses_bad_operands_on_the_card():
    dev = _card()
    q = torch.zeros(2, 64, 48, device=dev)
    launches = fa.launches
    with pytest.raises(ValueError, match="head dim 48"):
        fa.flash_attention(q, q, q)
    h = torch.zeros(2, 64, 64, device=dev, dtype=torch.float16)
    with pytest.raises(TypeError):
        fa.flash_attention(h, h, h)
    z = torch.zeros(2, 64, 64, device=dev)
    with pytest.raises(ValueError, match="is on"):
        fa.flash_attention(z, z.cpu(), z)
    assert fa.launches == launches


@pytest.mark.parametrize("s", [256, 300])
@pytest.mark.parametrize("window", [0, 128])
@pytest.mark.parametrize("group", [2, 4, 8])
@pytest.mark.parametrize("dtype,d", [
    (torch.bfloat16, 64), (torch.bfloat16, 128),      # wgmma
    (torch.bfloat16, 16), (torch.bfloat16, 32),       # mma_sync
    (torch.float32, 32), (torch.float32, 128)],       # simt
    ids=["bf16-64", "bf16-128", "bf16-16", "bf16-32", "f32-32", "f32-128"])
def test_flash_grouped_query_matches_plain_version(dtype, d, group, window,
                                                   s):
    """Grouped-query attention in every variant: 8 query rows over 8 /
    group kv rows. The result must repeat its bits, equal the same
    kernel's on k and v repeated per query row (each block reads its kv
    row where the multi-head call reads a copy of it), and match the plain
    version at the reference test's tolerance."""
    dev = _card()
    bh = 8
    rng = np.random.default_rng(group * s + d + window)
    q = torch.from_numpy(rng.standard_normal((bh, s, d)).astype(
        np.float32)).to(dev, dtype)
    k, v = (torch.from_numpy(rng.standard_normal((bh // group, s, d)).astype(
        np.float32)).to(dev, dtype) for _ in range(2))
    want_variant = fa.variant(dtype, d)
    before = dict(fa.launches_by_variant)
    got = fa.flash_attention(q, k, v, window=window)
    again = fa.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert fa.launches_by_variant == {
        **before, want_variant: before[want_variant] + 2}
    assert got.shape == (bh, s, d) and torch.equal(got, again)
    expanded = fa.flash_attention(q, k.repeat_interleave(group, 0),
                                  v.repeat_interleave(group, 0),
                                  window=window)
    assert torch.equal(got, expanded)
    want = attention_ref(q, k, v, window=window)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_TOL[dtype])


def test_flash_grouped_query_at_qwen_heads():
    """qwen2.5-3b's attention: 16 query heads over 2 kv heads (group 8)
    at d 128, through the wgmma variant, at S 4,096."""
    dev = _card()
    rng = np.random.default_rng(16)
    q = torch.from_numpy(rng.standard_normal((16, 4096, 128)).astype(
        np.float32)).to(dev, torch.bfloat16)
    k, v = (torch.from_numpy(rng.standard_normal((2, 4096, 128)).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(2))
    got = fa.flash_attention(q, k, v)
    assert torch.equal(got, fa.flash_attention(q, k, v))
    want = attention_ref(q, k, v)
    torch.testing.assert_close(got.float(), want.float(),
                               **FLASH_TOL[torch.bfloat16])


# The served configs' attention past the smoke ones, bf16 at d 128 as
# (heads, kv heads, S, window): chatglm3-6b's 32 query heads over 2 kv
# heads (group 16) and starcoder2-7b's 36 over 4 (group 9, the first group
# that is no power of two), at S 300 and 4,096 with window 0 and 128; then
# mixtral-8x7b's window of 4,096 at S 8,192 and 8,192 + 77, where it cuts
# every row past 4,096, at groups 4 (mixtral's 32 over 8), 9 and 16.
# chip_smoke.py's phase 6 runs the same cases.
SERVED_FLASH_CASES = (
    [(h, kv, s, w) for h, kv in ((32, 2), (36, 4)) for s in (300, 4096)
     for w in (0, 128)]
    + [(h, kv, s, 4096) for h, kv in ((32, 8), (36, 4), (32, 2))
       for s in (8192, 8192 + 77)])


def served_flash_inputs(case, dev):
    """bf16 q (heads, S, 128) and k, v (kv heads, S, 128) of one
    `SERVED_FLASH_CASES` case, N(0, 1) from a seed of the case."""
    h, kv, s, window = case
    rng = np.random.default_rng(h * 100_000 + kv * 10_000 + s + window)
    return [torch.from_numpy(rng.standard_normal((n, s, 128)).astype(
        np.float32)).to(dev, torch.bfloat16) for n in (h, kv, kv)]


@pytest.mark.parametrize("case", SERVED_FLASH_CASES,
                         ids=[f"h{c[0]}-kv{c[1]}-s{c[2]}-w{c[3]}"
                              for c in SERVED_FLASH_CASES])
def test_flash_at_the_served_groups_and_window(case):
    """Groups 16 and 9 and a window of 4,096 through the wgmma variant:
    the bits repeat and equal the same kernel's on k and v repeated per
    query row, the plain version holds at one bf16 unit of the output, and
    every launch counts as grouped and, with a window, as windowed."""
    dev = _card()
    h, kv, s, window = case
    q, k, v = served_flash_inputs(case, dev)
    before = fa.launches_grouped, fa.launches_windowed
    got = fa.flash_attention(q, k, v, window=window)
    again = fa.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert (fa.launches_grouped, fa.launches_windowed) == (
        before[0] + 2, before[1] + (2 if window else 0))
    assert got.shape == (h, s, 128) and torch.equal(got, again)
    group = h // kv
    assert torch.equal(got, fa.flash_attention(
        q, k.repeat_interleave(group, 0), v.repeat_interleave(group, 0),
        window=window))
    want = attention_ref(q, k, v, window=window)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_MASK_TOL)


# (dtype, d, S, window) -> sha256 of the output bytes of the multi-head
# kernel on `_digest_inputs`, recorded on an H100 from the kernel as it
# was before it took grouped-query attention: a multi-head call (group 1)
# must keep those bits.
MHA_DIGESTS = {
    (64, 300, 0, "torch.bfloat16"):
        "4b944725ee9d098b338405d0f5b5b65610b70bc10f6883ec31f237769650df96",
    (128, 700, 128, "torch.bfloat16"):
        "9f5cb0bfdcb3c52c53e86af7a3aa2638f3c62b2535ef1e14896cd297db5cc4e9",
    (32, 300, 0, "torch.bfloat16"):
        "2a1ce1569ac0e811954da30594926251abf3d9dcb1b9a2103e135a4462d8a19c",
    (16, 77, 16, "torch.bfloat16"):
        "920f718cd7d9438f1cfcafeb97386b885f87a36ec32f0d780a8f065f984e6425",
    (64, 300, 128, "torch.float32"):
        "90a78a5047d9a1076c49adc00e81b6cf7774a3d75c78196b44c89cdcd45188b6",
    (128, 256, 0, "torch.float32"):
        "60182e02e70fa75c459e6df43cdce1030cf83f3789d59e811b1c0d190a4c6dfb",
}


def _digest_inputs(dtype, d, s, window, dev):
    rng = np.random.default_rng(1000 * d + s + window)
    return [torch.from_numpy(rng.standard_normal((3, s, d)).astype(
        np.float32)).to(dev, dtype) for _ in range(3)]


def flash_digest(attention, dtype, d, s, window, dev) -> str:
    """sha256 of ``attention(q, k, v, window=window)``'s bytes on the
    fixed inputs of one `MHA_DIGESTS` case."""
    out = attention(*_digest_inputs(dtype, d, s, window, dev),
                    window=window)
    return hashlib.sha256(out.contiguous().view(torch.uint8).cpu()
                          .numpy().tobytes()).hexdigest()


DIGEST_CASES = [(torch.bfloat16, 64, 300, 0), (torch.bfloat16, 128, 700, 128),
                (torch.bfloat16, 32, 300, 0), (torch.bfloat16, 16, 77, 16),
                (torch.float32, 64, 300, 128), (torch.float32, 128, 256, 0)]


@pytest.mark.parametrize("case", DIGEST_CASES,
                         ids=[f"{str(c[0])[6:]}-{c[1]}-{c[2]}-{c[3]}"
                              for c in DIGEST_CASES])
def test_flash_multi_head_keeps_its_bits(case):
    dev = _card()
    assert flash_digest(fa.flash_attention, *case, dev) == MHA_DIGESTS[
        case[1:] + (str(case[0]),)]


MASKS = [dict(prefix=100), dict(prefix=300), dict(causal=False),
         dict(prefix=64, window=128)]
MASK_IDS = ["prefix100", "prefix300", "non_causal", "prefix64-window128"]


@pytest.mark.parametrize("mask", MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("s", [77, 300])
@pytest.mark.parametrize("dtype,d", [
    (torch.bfloat16, 64), (torch.bfloat16, 80), (torch.bfloat16, 128),
    (torch.bfloat16, 16), (torch.bfloat16, 32), (torch.bfloat16, 256),
    (torch.float32, 32), (torch.float32, 128)],
    ids=["bf16-64", "bf16-80", "bf16-128", "bf16-16", "bf16-32", "bf16-256",
         "f32-32", "f32-128"])
def test_flash_masks_match_plain_version(dtype, d, s, mask):
    """The prefix-LM and bidirectional masks in every variant and at the
    new head dims (80 through the wgmma kernel's zero-filled columns, 256
    through its 64-key tiles), S not a multiple of any tile, a prefix
    shorter and longer than S: the same bits on a repeat, the launch
    counted under its variant and mask, and the plain version at the
    reference test's tolerance."""
    dev = _card()
    rng = np.random.default_rng(s * d + len(mask))
    q, k, v = (torch.from_numpy(rng.standard_normal((2, s, d)).astype(
        np.float32)).to(dev, dtype) for _ in range(3))
    kind = fa.mask_kind(mask.get("causal", True), mask.get("prefix", 0))
    want_variant = fa.variant(dtype, d)
    by_variant, by_mask = dict(fa.launches_by_variant), dict(
        fa.launches_by_mask)
    got = fa.flash_attention(q, k, v, **mask)
    again = fa.flash_attention(q, k, v, **mask)
    torch.cuda.synchronize()
    assert fa.launches_by_variant == {
        **by_variant, want_variant: by_variant[want_variant] + 2}
    assert fa.launches_by_mask == {**by_mask, kind: by_mask[kind] + 2}
    assert got.shape == (2, s, d) and torch.equal(got, again)
    want = attention_ref(q, k, v, **mask)
    tol = FLASH_MASK_TOL if dtype == torch.bfloat16 else FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("d", [80, 256])
def test_flash_masks_keep_the_future_out(d):
    """Prefix-LM: a row below the prefix sees every prefix key, a row past
    it no later key; non-causal: the last key moves the first row. Then
    one key at a time at the edges (prefix 300 and S 600 inside a tile of
    every variant): key 300, the first past the prefix, leaves rows 0-299
    bit for bit and moves row 300; key 299 moves row 0; non-causal, key
    599 in the ragged tile moves row 0."""
    dev = _card()
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 600, d)).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(3))
    k2, v2 = k.clone(), v.clone()
    k2[:, 250:], v2[:, 250:] = 9.0, -9.0        # inside the prefix of 300
    o1 = fa.flash_attention(q, k, v, prefix=300)
    o2 = fa.flash_attention(q, k2, v2, prefix=300)
    assert not torch.equal(o1[:, :1], o2[:, :1])
    k3, v3 = k.clone(), v.clone()
    k3[:, 400:], v3[:, 400:] = 9.0, -9.0        # past the prefix
    o3 = fa.flash_attention(q, k3, v3, prefix=300)
    assert torch.equal(o1[:, :400], o3[:, :400])
    b1 = fa.flash_attention(q, k, v, causal=False)
    b3 = fa.flash_attention(q, k3, v3, causal=False)
    assert not torch.equal(b1[:, :1], b3[:, :1])

    def bumped(j):
        kj, vj = k.clone(), v.clone()
        kj[:, j], vj[:, j] = kj[:, j] + 4.0, vj[:, j] - 4.0
        return kj, vj

    past = fa.flash_attention(q, *bumped(300), prefix=300)
    assert torch.equal(o1[:, :300], past[:, :300])
    assert not torch.equal(o1[:, 300], past[:, 300])
    last = fa.flash_attention(q, *bumped(299), prefix=300)
    assert not torch.equal(o1[:, :1], last[:, :1])
    end = fa.flash_attention(q, *bumped(599), causal=False)
    assert not torch.equal(b1[:, :1], end[:, :1])


@pytest.mark.parametrize("arch", ["paligemma-3b", "hubert-xlarge"])
def test_flash_at_the_new_models_heads(arch):
    """paligemma-3b's attention (8 query heads over 1 kv head, d 256, a
    256-token prefix) and hubert-xlarge's (16 heads of 80, bidirectional)
    at S 4,096, against the plain version to one bf16 unit."""
    dev = _card()
    h, kv, d, mask = ((8, 1, 256, dict(prefix=256)) if arch == "paligemma-3b"
                      else (16, 16, 80, dict(causal=False)))
    rng = np.random.default_rng(h + d)
    q = torch.from_numpy(rng.standard_normal((h, 4096, d)).astype(
        np.float32)).to(dev, torch.bfloat16)
    k, v = (torch.from_numpy(rng.standard_normal((kv, 4096, d)).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(2))
    got = fa.flash_attention(q, k, v, **mask)
    assert torch.equal(got, fa.flash_attention(q, k, v, **mask))
    if kv < h:
        assert torch.equal(got, fa.flash_attention(
            q, k.repeat_interleave(h // kv, 0),
            v.repeat_interleave(h // kv, 0), **mask))
    want = attention_ref(q, k, v, **mask)
    torch.testing.assert_close(got.float(), want.float(), **FLASH_MASK_TOL)


def test_flash_refuses_float32_at_head_dim_256():
    """Head dim 256 is built for bf16 only: a float32 call is refused
    before a launch."""
    dev = _card()
    launches = fa.launches
    with pytest.raises(ValueError, match="head dim 256"):
        z = torch.zeros(1, 64, 256, device=dev)
        fa.flash_attention(z, z, z)
    assert fa.launches == launches


@pytest.mark.parametrize("arch", ["paligemma-3b", "hubert-xlarge"])
def test_new_models_on_the_card_match_the_cpu(arch):
    """2-layer smoke paligemma (prefix 4, one kv head) and hubert
    (bidirectional) through the flash kernel on the card against the same
    weights on the CPU, to tests/test_models.py's decode standard; one
    launch a layer, counted under the config's mask."""
    import copy

    from repro_torch.configs import smoke_config
    from repro_torch.configs.shapes import ShapeSpec, input_specs
    from repro_torch.models import transformer as T

    dev = _card()
    cfg = smoke_config(arch, layers=2)
    host = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = copy.deepcopy(host).to(dev)
    g = torch.Generator().manual_seed(1)
    batch = {}
    for name, spec in input_specs(cfg, ShapeSpec("t", 300, 2,
                                                 "prefill")).items():
        batch[name] = (torch.randint(0, cfg.vocab_size, spec.shape,
                                     generator=g, dtype=torch.int32)
                       if name == "tokens" else
                       torch.randn(spec.shape, generator=g).to(spec.dtype))
    kind = fa.mask_kind(cfg.causal, cfg.prefix_tokens)
    before = fa.launches_by_mask[kind]
    got, _ = T.forward(card, {n: t.to(dev) for n, t in batch.items()})
    torch.cuda.synchronize()
    assert fa.launches_by_mask[kind] - before == cfg.num_layers
    want, _ = T.forward(host, batch)
    torch.testing.assert_close(got.float().cpu(), want.float(),
                               rtol=0.15, atol=0.15)
    agree = (got.float().cpu().argmax(-1) == want.float().argmax(-1))
    assert agree.float().mean() > 0.95


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-1.2b"])
def test_ssm_trunks_on_the_card_match_the_cpu(arch):
    """2-layer smoke rwkv6 (time-mix and channel-mix) and zamba2 (Mamba2
    with the shared attention block at its last layer): the prefill on
    the card against the same weights on the CPU at S 304 (the chunked
    wkv and SSD forms) to tests/test_models.py's decode
    standard, with one flash launch per application of the shared block
    and one hot-slab launch; then teacher-forced decode against the
    card's forward, and the server."""
    import copy

    from repro_torch.configs import smoke_config
    from repro_torch.launch.serve import serve_loop, synthetic_requests
    from repro_torch.models import transformer as T

    dev = _card()
    cfg = smoke_config(arch, layers=2)
    host = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = copy.deepcopy(host).to(dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 304)).astype(np.int32))
    fl, hl = fa.launches, he.launches
    got, _ = T.forward(card, {"tokens": tokens.to(dev)})
    torch.cuda.synchronize()
    assert (fa.launches - fl, he.launches - hl) == (
        len(cfg.attn_positions), 1)
    want, _ = T.forward(host, {"tokens": tokens})
    torch.testing.assert_close(got.float().cpu(), want.float(),
                               rtol=0.15, atol=0.15)
    agree = (got.float().cpu().argmax(-1) == want.float().argmax(-1))
    assert agree.float().mean() > 0.95
    cache = T.init_cache(cfg, 2, 24, device=dev)
    steps = []
    for i in range(24):
        lg, cache = T.decode_step(card, cache, tokens[:, i:i + 1].to(dev))
        steps.append(lg[:, 0].float())
    full = got[:, :24].float()
    torch.testing.assert_close(torch.stack(steps, 1), full, rtol=0.15,
                               atol=0.15)
    done = serve_loop(cfg, card, synthetic_requests(4, cfg.vocab_size),
                      batch_slots=2)
    assert sorted(r.rid for r in done) == [0, 1, 2, 3]
    assert all(len(r.out) == r.max_new for r in done)


# ------------------------------------------------------------- hot_embed
@pytest.mark.parametrize("vocab,hot,n,d", [
    (1000, 128, 400, 32), (4096, 512, 512, 32), (600, 600, 14, 32),
    (122_753, 6_137, 3000, 2304), (64, 32, 17, 7),    # D % 4 != 0
    (16_384, 6_137, 40_000, 2304)])   # more ids than warps: grid-stride
def test_hot_gather_is_exact(vocab, hot, n, d):
    dev = _card()
    rng = np.random.default_rng(n)
    table = torch.from_numpy(rng.standard_normal((vocab, d)).astype(
        np.float32)).to(dev)
    ids = torch.from_numpy(rng.integers(0, vocab, n).astype(np.int32)).to(dev)
    launches = he.launches
    got = he.hot_gather(ids, table[:hot])
    again = he.hot_gather(ids, table[:hot])
    torch.cuda.synchronize()
    assert he.launches == launches + 2
    assert torch.equal(got, hot_gather_ref(ids, table[:hot]))
    assert torch.equal(got, again)
    assert torch.equal(hot_cold_lookup(ids, table, hot),
                       table[ids.long()])


def test_hot_gather_all_cold_and_all_hot():
    dev = _card()
    table = torch.arange(64 * 8, dtype=torch.float32,
                         device=dev).reshape(64, 8)
    cold = torch.arange(32, 64, dtype=torch.int32, device=dev)
    assert not he.hot_gather(cold, table[:32]).any()
    assert torch.equal(hot_cold_lookup(cold, table, 32), table[cold.long()])
    every = torch.arange(64, dtype=torch.int32, device=dev)
    assert torch.equal(he.hot_gather(every, table), table)
    launches = he.launches
    with pytest.raises(TypeError, match="int32"):
        he.hot_gather(every.long(), table)
    assert he.launches == launches


# ----------------------------------------------------------- the LM slice
def test_lm_slice_on_the_card_matches_the_cpu():
    """A 2-layer smoke minicpm: the prefill forward on the card (flash
    kernel per layer, one hot-slab launch) against the same weights on
    the CPU (plain versions), and the decode path, to the standard of
    tests/test_models.py::test_decode_matches_forward."""
    import copy

    from repro_torch.configs import smoke_config
    from repro_torch.launch.serve import serve_loop, synthetic_requests
    from repro_torch.models import transformer as T

    dev = _card()
    cfg = smoke_config("minicpm-2b", layers=2)
    host = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = copy.deepcopy(host).to(dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 300)).astype(np.int32))
    fl, hl = fa.launches, he.launches
    got, _ = T.forward(card, {"tokens": tokens.to(dev)})
    torch.cuda.synchronize()
    assert (fa.launches - fl, he.launches - hl) == (cfg.num_layers, 1)
    want, _ = T.forward(host, {"tokens": tokens})
    torch.testing.assert_close(got.float().cpu(), want.float(),
                               rtol=0.15, atol=0.15)
    agree = (got.float().cpu().argmax(-1) == want.float().argmax(-1))
    assert agree.float().mean() > 0.95
    hl = he.launches
    done = serve_loop(cfg, card, synthetic_requests(4, cfg.vocab_size),
                      batch_slots=2)
    assert sorted(r.rid for r in done) == [0, 1, 2, 3]
    assert all(len(r.out) == r.max_new for r in done)
    assert he.launches > hl


# ------------------------------------------------------------------- k-NN
def _int_corpus(n, dim, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 12, (n, dim)).astype(np.float32),
            rng.integers(0, 12, (24, dim)).astype(np.float32))


def test_knn_served_on_the_card_matches_the_cpu():
    """k-NN through `EngineSession` on the card and on the CPU, integer
    coordinates (exact float32 distances): the same ids, the host
    oracle's ids, the same visit totals; and the same ids after
    `refresh_hotness` moves the graph to the visit-sorted layout and then
    repacks it (patch)."""
    from repro_torch.core.baselines import knn_search_baseline
    from repro_torch.search import SearchParams, build_nsw_graph, medoid_entry
    dev = _card()
    vecs, queries = _int_corpus(600, 8, 3)
    g = build_nsw_graph(vecs, k=8)
    params = SearchParams(k_out=8, beam_width=16, k_return=8)
    got, totals = {}, {}
    for where in ("cuda", "cpu"):
        with EngineSession(device=where) as s:
            gid = s.register(g, "int-knn", vectors=vecs,
                             search_params=params)
            got[where] = s.submit(gid, "knn", queries)
            totals[where] = s.registry.get(gid).visits_total
            assert s.refresh_hotness(gid)["tier"] == "full"
            assert np.array_equal(s.submit(gid, "knn", queries), got[where])
            assert s.refresh_hotness(gid)["tier"] == "patch"
            assert np.array_equal(s.submit(gid, "knn", queries), got[where])
    np.testing.assert_array_equal(got["cuda"], got["cpu"])
    assert totals["cuda"] == totals["cpu"]
    entry = medoid_entry(vecs)
    for q, row in zip(queries, got["cuda"]):
        want, _ = knn_search_baseline(g, vecs, q, entry, beam_width=16,
                                      k_return=8)
        assert row.tolist() == want.tolist()


def test_knn_recall_on_the_card():
    """tests/test_search.py:164 on the card: its clustered float corpus,
    recall@10 of at least 0.95 against brute force; the run stays on the
    card."""
    from repro_torch.core.generators import clustered_vectors
    from repro_torch.search import build_nsw_graph, knn_brute_force
    dev = _card()
    vecs, _ = clustered_vectors(240, dim=8, num_clusters=5, seed=1)
    g = build_nsw_graph(vecs, k=8)
    rng = np.random.default_rng(0)
    queries = vecs[rng.integers(0, len(vecs), 24)]
    queries = (queries + rng.normal(0, 0.01, queries.shape)).astype(
        np.float32)
    with EngineSession(device=dev) as s:
        gid = s.register(g, "recall", vectors=vecs)
        got = s.submit(gid, "knn", queries)
        ex = s.executor.single
        ga = s.registry.get(gid).handle
        assert ga.search.vectors.device.type == "cuda"
        ids, visits = ex.run(ga, "knn", queries)
        assert ids.device.type == "cuda" and visits.device.type == "cuda"
    oracle = knn_brute_force(vecs, queries, 10)
    recall = np.mean([len(set(a) & set(b)) / 10
                      for a, b in zip(got.tolist(), oracle.tolist())])
    assert recall >= 0.95


# --------------------------------------------------------------- moe_gmm
GMM_TOL = dict(rtol=1e-4, atol=1e-4)


def _pad_groups_tiles(gs):
    """tile_expert of `moe_gmm.pad_groups` for the reference's cases."""
    return gmm_mod.pad_groups(np.array(gs))[1:]


@pytest.mark.parametrize("gs,k,n", [
    ([128, 128, 128, 128], 128, 256), ([100, 30, 0, 128], 128, 256),
    ([0, 0, 5, 1], 128, 256), ([512, 0, 0, 0], 128, 256),
    ([128, 128], 384, 128)])                   # tests/test_kernels.py
def test_grouped_matmul_f32_matches_plain_version(gs, k, n):
    dev = _card()
    te, total = _pad_groups_tiles(gs)
    rng = np.random.default_rng(total + k)
    x = torch.from_numpy(rng.standard_normal((total, k)).astype(
        np.float32)).to(dev)
    w = torch.from_numpy((0.1 * rng.standard_normal((len(gs), k, n))).astype(
        np.float32)).to(dev)
    te = torch.from_numpy(te).to(dev)
    launches = gmm_mod.launches
    got = grouped_matmul(x, w, te)
    again = grouped_matmul(x, w, te)
    torch.cuda.synchronize()
    assert gmm_mod.launches == launches + 2
    assert got.dtype == torch.float32 and torch.equal(got, again)
    want = gmm_ref(x, w, te.repeat_interleave(gmm_mod.TILE_M))
    torch.testing.assert_close(got, want, **GMM_TOL)


def _sizes(rng, m, e, case):
    if case == "one_group":
        sizes = np.zeros(e, np.int64)
        sizes[e // 2] = m
    elif case == "short":                 # rows past the total
        sizes = rng.multinomial(m - 13, np.ones(e) / e)
    else:                                 # skewed, with empty groups
        p = 1.0 / (1 + np.arange(e)) ** 1.2
        sizes = rng.multinomial(m, p / p.sum())
        sizes[1] = 0
    return sizes


@pytest.mark.parametrize("case", ["skewed", "one_group", "short"])
@pytest.mark.parametrize("m,k,n,e", [
    (40, 64, 128, 4), (40, 128, 64, 4),          # smoke moonshot widths
    (1000, 2048, 1408, 64), (1000, 1408, 2048, 64),   # served widths
    (24, 2048, 1408, 64),                         # a decode step
    (300, 40, 24, 3)])                            # K, N multiples of 8 only
def test_ragged_dot_bf16_matches_plain_version(m, k, n, e, case):
    dev = _card()
    assert not torch.backends.cuda.matmul.allow_tf32
    rng = np.random.default_rng(m * k + n)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(
        dev, torch.bfloat16)
    w = torch.from_numpy((k ** -0.5 * rng.standard_normal((e, k, n))).astype(
        np.float32)).to(dev, torch.bfloat16)
    sizes = torch.from_numpy(_sizes(rng, m, e, case)).to(dev)
    offs = torch.zeros(e + 1, dtype=torch.int32, device=dev)
    offs[1:] = sizes.cumsum(0)
    launches = gmm_mod.launches
    got = ragged_dot(x, w, sizes)
    again = ragged_dot(x, w, sizes)
    f32 = gmm_mod.gmm(x, w, offs, out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert gmm_mod.launches == launches + 3
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    torch.testing.assert_close(f32, gmm_grouped_ref(x, w, offs), **GMM_TOL)
    # the same float32 sums, rounded once
    assert torch.equal(got, f32.to(torch.bfloat16))
    total = int(sizes.sum())
    assert not got[total:].any() and not f32[total:].any()


def test_grouped_matmul_refuses_bad_operands_on_the_card():
    dev = _card()
    x = torch.zeros(128, 64, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(2, 64, 32, device=dev, dtype=torch.bfloat16)
    offs = torch.tensor([0, 100, 128], dtype=torch.int32, device=dev)
    launches = gmm_mod.launches
    with pytest.raises(TypeError):
        gmm_mod.gmm(x.half(), w.half(), offs)
    with pytest.raises(TypeError, match="is torch.float32"):
        gmm_mod.gmm(x, w.float(), offs)
    with pytest.raises(TypeError, match="int32"):
        gmm_mod.gmm(x, w, offs.long())
    with pytest.raises(ValueError, match="is on"):
        gmm_mod.gmm(x, w.cpu(), offs)
    with pytest.raises(ValueError, match="multiples of 8"):
        gmm_mod.gmm(x[:, :60].contiguous(), w[:, :60].contiguous(), offs)
    with pytest.raises(ValueError, match="multiples of 8"):
        gmm_mod.gmm(x, w[:, :, :20].contiguous(), offs)
    with pytest.raises(ValueError, match="contiguous"):
        gmm_mod.gmm(x.t().contiguous().t(), w, offs)
    by_variant = dict(gmm_mod.launches_by_variant)
    with pytest.raises(ValueError, match="'wgmma' or 'splitk'"):
        gmm_mod.gmm(x, w, offs, variant="mma_sync")
    with pytest.raises(ValueError, match="'simt'"):
        gmm_mod.gmm(x.float(), w.float(), offs, variant="splitk")
    with pytest.raises(TypeError, match="is torch.float32"):
        gmm_mod.gmm(x, w.float(), offs, variant="wgmma")
    assert gmm_mod.launches == launches
    assert gmm_mod.launches_by_variant == by_variant


# mixtral-8x7b's widths, 8 experts: the gate and up products (K 4,096, N
# 14,336) and the down product (K 14,336, N 4,096) at 1,000 rows, skewed,
# in one group and short of the rows, and a decode step's 8 rows (4
# tokens, top 2: one row an expert, past split-K's half a row, so the rule
# gives wgmma; each variant is forced here). chip_smoke.py's phase 12 runs
# the same cases.
MIXTRAL_GMM_CASES = [(case, 1000, k, n, 8) for k, n in ((4096, 14336),
                                                         (14336, 4096))
                     for case in ("skewed", "one_group", "short")] + [
    ("decode_top2", 8, 4096, 14336, 8)]


def _variant_sizes(rng, case, m, e):
    sizes = np.zeros(e, np.int64)
    if case == "m1":
        sizes[e // 3] = 1
    elif case == "boundary":            # group ends inside 128-row tiles
        sizes[:] = [50, 100, 78]
    elif case == "empty":               # 8 groups hold every row
        sizes[rng.choice(e, 8, replace=False)] = rng.multinomial(
            m, np.ones(8) / 8)
    elif case == "one_group":
        sizes[e // 2] = m
    elif case == "short":               # rows past offs[E]
        sizes[:] = rng.multinomial(m - 13, np.ones(e) / e)
    elif case == "decode":              # 4 tokens, 6 distinct experts each
        for _ in range(4):
            sizes[rng.choice(e, 6, replace=False)] += 1
    elif case == "decode_top2":         # 4 tokens, 2 distinct experts each
        for _ in range(4):
            sizes[rng.choice(e, 2, replace=False)] += 1
    else:                               # skewed, with empty groups
        p = 1.0 / (1 + np.arange(e)) ** 1.2
        sizes[:] = rng.multinomial(m, p / p.sum())
        sizes[1] = 0
    return sizes


@pytest.mark.parametrize("variant", ["wgmma", "splitk"])
@pytest.mark.parametrize("case,m,k,n,e", [
    ("m1", 1, 2048, 1408, 64),
    ("boundary", 228, 136, 200, 3),     # K % 64 != 0, N % 128 != 0
    ("empty", 300, 2048, 1408, 64),
    ("one_group", 1000, 1408, 2048, 64),
    ("short", 1000, 2048, 1408, 64),
    ("skewed", 1000, 1408, 2048, 64),   # the served widths
    ("decode", 24, 2048, 1408, 64),
    ("decode", 24, 1408, 2048, 64)] + MIXTRAL_GMM_CASES)
def test_gmm_variant_matches_plain_version(variant, case, m, k, n, e):
    """Each bf16 variant, forced, against the plain version at GMM_TOL
    (float32 out), its bf16 result the float32 one rounded once, its bits
    equal on a repeat, rows past offs[E] zero, and three launches counted
    under its name. The two variants' bits may differ (split-K adds in
    another order); split-K is also held to its own order's model."""
    dev = _card()
    rng = np.random.default_rng(m * k + n + e)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(
        dev, torch.bfloat16)
    w = torch.from_numpy((k ** -0.5 * rng.standard_normal((e, k, n))).astype(
        np.float32)).to(dev, torch.bfloat16)
    sizes = _variant_sizes(rng, case, m, e)
    offs = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)]).astype(
        np.int32)).to(dev)
    before = dict(gmm_mod.launches_by_variant)
    got = gmm_mod.gmm(x, w, offs, variant=variant)
    again = gmm_mod.gmm(x, w, offs, variant=variant)
    half = gmm_mod.gmm(x, w, offs, out_dtype=torch.bfloat16, variant=variant)
    torch.cuda.synchronize()
    assert gmm_mod.launches_by_variant == {**before,
                                           variant: before[variant] + 3}
    assert got.dtype == torch.float32 and torch.equal(got, again)
    torch.testing.assert_close(got, gmm_grouped_ref(x, w, offs), **GMM_TOL)
    assert torch.equal(half, got.to(torch.bfloat16))
    total = int(sizes.sum())
    assert not got[total:].any() and not half[total:].any()
    if variant == "splitk":
        kc = gmm_mod.splitk_plan(m, e, k, n)[1]
        torch.testing.assert_close(got, gmm_splitk_ref(x, w, offs, kc),
                                   **GMM_TOL)


@pytest.mark.parametrize("m,dtype,want", [
    (24, torch.bfloat16, "splitk"), (1000, torch.bfloat16, "wgmma"),
    (24, torch.float32, "simt")])
def test_gmm_launches_the_variant_its_rule_picks(m, dtype, want):
    dev = _card()
    e, k, n = 64, 256, 128
    x = torch.ones(m, k, device=dev, dtype=dtype)
    w = torch.full((e, k, n), 0.5, device=dev, dtype=dtype)
    offs = torch.linspace(0, m, e + 1, device=dev).to(torch.int32)
    if dtype == torch.bfloat16:
        assert gmm_mod.variant(m, e, k, n) == want
    before = dict(gmm_mod.launches_by_variant)
    got = gmm_mod.gmm(x, w, offs)
    torch.cuda.synchronize()
    assert gmm_mod.launches_by_variant == {**before, want: before[want] + 1}
    assert torch.equal(got, torch.full_like(got, 0.5 * k))


def test_moe_model_on_the_card_matches_the_cpu():
    """A 2-layer smoke moonshot (MoE with a shared expert): the prefill on
    the card (3 grouped-matmul launches per layer) against the same
    weights on the CPU, and `serve_loop`. The standard of
    tests/test_models.py::test_decode_matches_forward (rtol/atol 0.15,
    argmax agreement > 0.95), held at 95% of the positions or more when
    the card routes freely (where two experts' probabilities nearly tie,
    rounding that differs between cuBLAS and the CPU picks the other
    expert for that token) and at every position when the card replays
    the CPU's expert choices (`models.moe.RouteTape`)."""
    import copy

    from repro_torch.configs import smoke_config
    from repro_torch.launch.serve import serve_loop, synthetic_requests
    from repro_torch.models import transformer as T
    from repro_torch.models.moe import RouteTape

    dev = _card()
    cfg = smoke_config("moonshot-v1-16b-a3b", layers=2)
    host = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = copy.deepcopy(host).to(dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 300)).astype(np.int32))
    gl = gmm_mod.launches
    got, aux = T.forward(card, {"tokens": tokens.to(dev)})
    torch.cuda.synchronize()
    assert gmm_mod.launches - gl == 3 * cfg.num_layers
    with RouteTape() as tape:
        want, want_aux = T.forward(host, {"tokens": tokens})
    diff = (got.float().cpu() - want.float()).abs()
    close = (diff <= 0.15 + 0.15 * want.float().abs()).all(-1)
    assert close.float().mean() >= 0.95
    agree = (got.float().cpu().argmax(-1) == want.float().argmax(-1))
    assert agree.float().mean() > 0.95
    assert abs(float(aux) - float(want_aux)) <= 1e-2 * float(want_aux)
    with RouteTape(tape.experts):
        got, _ = T.forward(card, {"tokens": tokens.to(dev)})
    torch.testing.assert_close(got.float().cpu(), want.float(), rtol=0.15,
                               atol=0.15)
    agree = (got.float().cpu().argmax(-1) == want.float().argmax(-1))
    assert agree.float().mean() > 0.95
    gl = gmm_mod.launches
    done = serve_loop(cfg, card, synthetic_requests(4, cfg.vocab_size),
                      batch_slots=2)
    assert sorted(r.rid for r in done) == [0, 1, 2, 3]
    assert all(len(r.out) == r.max_new for r in done)
    assert gmm_mod.launches > gl


# ------------------------------------------------- flash backward (training)
def _plain_attention(q, k, v, mask):
    """Plain attention in the inputs' dtype throughout (logits, softmax
    and both products), k and v repeated per query row: in bf16 the plain
    bf16 path of FlashAttention's own standard, in float64 its oracle."""
    from repro_torch.kernels.flash_attn.ref import visible
    bh, s, d = q.shape
    group = bh // k.shape[0]
    k, v = k.repeat_interleave(group, 0), v.repeat_interleave(group, 0)
    pos = torch.arange(s, device=q.device)
    logits = torch.einsum("bqd,bkd->bqk", q, k) * d ** -0.5
    seen = visible(pos, pos, **mask)
    p = torch.softmax(torch.where(seen[None], logits, -1e30), dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v)


def flash_backward_holds(q, k, v, do, mask, name=""):
    """FlashAttention's standard: dq, dk and dv of the kernels, each at
    most 2x (plus 1e-3) the max error of the plain bf16 path against a
    float64 autograd oracle; a second backward repeats the bits; returns
    the kernels' (dq, dk, dv)."""
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    out = fa.flash_attention_grad(*leaves, **mask)
    out.backward(do)
    got = [t.grad for t in leaves]
    again = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    fa.flash_attention_grad(*again, **mask).backward(do)
    for a, b in zip(got, (t.grad for t in again)):
        assert torch.equal(a, b), f"{name}: a second backward differs"
    oracle = [t.detach().double().requires_grad_(True) for t in (q, k, v)]
    _plain_attention(*oracle, mask).backward(do.double())
    plain = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    _plain_attention(*plain, mask).backward(do)
    for label, g, o, p in zip("qkv", got, oracle, plain):
        err = float((g.double() - o.grad).abs().max())
        base = float((p.grad.double() - o.grad).abs().max())
        assert err <= 2 * base + 1e-3, (
            f"{name} d{label}: {err:.3e} against the plain bf16 path's "
            f"{base:.3e}")
    return got


@pytest.mark.parametrize("mask", [
    dict(causal=True), dict(causal=True, window=48),
    dict(causal=True, prefix=70), dict(causal=False)],
    ids=["causal", "window", "prefix", "bidirectional"])
@pytest.mark.parametrize("d", fa.BWD_HEAD_DIMS)
@pytest.mark.parametrize("bh,kv,s", [(4, 4, 200), (8, 2, 130), (4, 1, 64)])
def test_flash_backward_holds_the_flashattention_standard(bh, kv, s, d, mask):
    """The backward kernels (multi-head and grouped, every mask, S not a
    multiple of a tile) against a float64 oracle, at FlashAttention's
    standard; two launches a backward, one of each kernel."""
    dev = _card()
    rng = np.random.default_rng(bh * s + d)
    q, do = (torch.from_numpy(rng.standard_normal((bh, s, d)).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((kv, s, d)).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(2))
    before = dict(fa.launches_bwd)
    flash_backward_holds(q, k, v, do, mask)
    assert {n: fa.launches_bwd[n] - before[n] for n in before} == {
        "dq": 2, "dkdv": 2}


@pytest.mark.parametrize("d", [64, 128, 16, 80, 256])
def test_flash_lse_keeps_the_output_bits(d):
    """The forward with its log-sum-exp gives the bits of the forward
    without it, and the log-sum-exp of the plain version to 1e-4; at d 256
    with paligemma-3b's grouping, 8 query rows over 1 kv row."""
    from repro_torch.kernels.flash_attn.ref import attention_lse_ref
    dev = _card()
    rng = np.random.default_rng(d)
    kv = 1 if d == 256 else 2
    q = torch.from_numpy(rng.standard_normal((8, 300, d)).astype(
        np.float32)).to(dev, torch.bfloat16)
    k, v = (torch.from_numpy(rng.standard_normal((kv, 300, d)).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(2))
    for mask in (dict(causal=True), dict(causal=True, prefix=40),
                 dict(causal=False)):
        o, lse = fa.flash_attention_lse(q, k, v, **mask)
        assert torch.equal(o, fa.flash_attention(q, k, v, **mask))
        torch.testing.assert_close(lse, attention_lse_ref(q, k, **mask),
                                   rtol=1e-4, atol=1e-4)


def test_flash_backward_matches_its_plain_version():
    """The kernels against `attention_bwd_ref` on the kernels' own o and
    lse, at qwen2.5-3b's heads (16 over 2 kv heads, d 128): the same
    recompute, where only the bf16 rounding of p and dS as operands
    differs."""
    dev = _card()
    rng = np.random.default_rng(3)
    q, do = (torch.from_numpy(rng.standard_normal((16, 512, 128)).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((2, 512, 128)).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(2))
    o, lse = fa.flash_attention_lse(q, k, v)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do)
    want = attention_bwd_ref(q, k, v, o, lse, do)
    for g, w in zip(got, want):
        scale = float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), rtol=2e-2,
                                   atol=2e-2 * scale)


def test_flash_backward_refuses_before_a_launch():
    """float32, and a head dim no kernel is built for, have no backward
    kernel: the call raises before the forward launches (ROADMAP A8.5c)."""
    dev = _card()
    fwd, bwd = fa.launches, dict(fa.launches_bwd)
    for dtype, d in ((torch.float32, 64), (torch.bfloat16, 48)):
        z = torch.zeros(2, 64, d, device=dev, dtype=dtype,
                        requires_grad=True)
        with pytest.raises(NotImplementedError, match="A8.5c"):
            fa.flash_attention_grad(z, z, z)
    assert fa.launches == fwd and fa.launches_bwd == bwd


def test_flash_grad_at_head_dim_256_refuses_before_a_launch():
    """At paligemma-3b's head dim 256 the backward is built for bf16 only:
    a float32 `flash_attention_grad` (8 query rows over 1 kv row, a
    256-token prefix) raises, naming A8.5c, before the forward or any
    backward kernel launches."""
    dev = _card()
    q = torch.zeros(8, 300, 256, device=dev, requires_grad=True)
    k, v = (torch.zeros(1, 300, 256, device=dev, requires_grad=True)
            for _ in range(2))
    fwd = (fa.launches, dict(fa.launches_by_variant))
    bwd = (dict(fa.launches_bwd), dict(fa.launches_bwd_by_variant))
    with pytest.raises(NotImplementedError, match="A8.5c"):
        fa.flash_attention_grad(q, k, v, prefix=256)
    torch.cuda.synchronize()
    assert (fa.launches, fa.launches_by_variant) == fwd
    assert (fa.launches_bwd, fa.launches_bwd_by_variant) == bwd


def test_flash_grad_at_head_dim_256_runs_on_the_wgmma_kernels():
    """paligemma-3b's attention gradient (8 query rows over 1 kv row, d
    256, a 256-token prefix, S 4,096) runs the forward with its
    log-sum-exp and the ``wgmma`` backward pair, one launch of each, at
    FlashAttention's standard with repeatable bits, and within 2e-2 of
    the plain version on the kernels' own o and lse."""
    dev = _card()
    q, k, v, do = _bwd_inputs(8, 1, 4096, 256, 29, dev)
    mask = dict(causal=True, prefix=256)
    fwd = dict(fa.launches_by_mask)
    bwd = dict(fa.launches_bwd_by_variant)
    flash_backward_holds(q, k, v, do, mask, name="paligemma")
    assert fa.launches_by_mask["prefix"] - fwd["prefix"] == 2
    assert {n: fa.launches_bwd_by_variant[n] - bwd[n] for n in bwd} == {
        "wgmma": 4, "mma_sync": 0}
    o, lse = fa.flash_attention_lse(q, k, v, **mask)
    want = attention_bwd_ref(q, k, v, o, lse, do, **mask)
    for g, w in zip(fa.flash_attention_bwd(q, k, v, o, lse, do, **mask),
                    want):
        scale = float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), rtol=2e-2,
                                   atol=2e-2 * scale)


# (BH, KV, S, mask) across the wgmma backward's tiles (128 keys a dk/dv
# block, 64 at d 256, 64 rows a step; 128 rows a dq block, 64 keys a
# step): S not a multiple of 64 or 128 and S below 64; group 8
# (qwen2.5-3b's and, over one kv row, paligemma-3b's), 16 and 1; a window
# that ends inside a 128-key tile; prefixes that cross one and that end
# inside a 64-row step; starcoder2-7b's group of 9 (a kv row's group
# starting mid-block at S 300, and at a microbatch's 4,096 + 77) and
# mixtral-8x7b's window of 4,096 at group 4 where it cuts (S 8,192 + 77;
# at train_4k's 4,096 it masks nothing)
WGMMA_BWD_CASES = [
    (16, 2, 300, dict(causal=True)),
    (16, 1, 200, dict(causal=True)),
    (4, 4, 40, dict(causal=True)),
    (8, 1, 333, dict(causal=True, window=100)),
    (4, 4, 260, dict(causal=True, window=100)),
    (16, 2, 300, dict(causal=True, prefix=150)),
    (4, 4, 200, dict(causal=True, prefix=150, window=90)),
    (8, 1, 200, dict(causal=False)),
    (4, 4, 40, dict(causal=False)),
    (8, 1, 333, dict(causal=True, prefix=100)),
    (18, 2, 300, dict(causal=True)),
    (9, 1, 4173, dict(causal=True)),
    (8, 2, 8269, dict(causal=True, window=4096)),
]
WGMMA_BWD_IDS = ["g8-s300", "g16-s200", "g1-s40", "g8-window", "g1-window",
                 "g8-prefix", "g1-prefix-window", "g8-bidirectional",
                 "g1-s40-bidirectional", "g8-kv1-prefix100", "g9-s300",
                 "g9-s4173", "g4-window4096-s8269"]


def _bwd_inputs(bh, kv, s, d, seed, dev):
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.standard_normal((bh, s, d)).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((kv, s, d)).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("case", WGMMA_BWD_CASES, ids=WGMMA_BWD_IDS)
@pytest.mark.parametrize("d", fa.BWD_WGMMA_HEAD_DIMS)
def test_wgmma_backward_holds_the_flashattention_standard(d, case):
    """The Hopper backward kernels (``flash_bwd_dq_wgmma``,
    ``flash_bwd_dkdv_wgmma``) at FlashAttention's standard against a
    float64 oracle, with repeatable bits, on shapes that cross their
    tiles; both backwards launch the ``wgmma`` kernels, one of each,
    counted under their kv group and, with a window, as windowed."""
    bh, kv, s, mask = case
    dev = _card()
    q, k, v, do = _bwd_inputs(bh, kv, s, d, bh * s + d, dev)
    before = dict(fa.launches_bwd_by_variant)
    group0 = dict(fa.launches_bwd_by_group)
    windowed0 = fa.launches_bwd_windowed
    flash_backward_holds(q, k, v, do, mask, name=f"d{d}")
    assert {n: fa.launches_bwd_by_variant[n] - before[n] for n in before} == {
        "wgmma": 4, "mma_sync": 0}
    assert {g: n - group0.get(g, 0)
            for g, n in fa.launches_bwd_by_group.items()
            if n != group0.get(g, 0)} == {bh // kv: 4}
    assert fa.launches_bwd_windowed - windowed0 == 4 * (
        mask.get("window", 0) > 0)


@pytest.mark.parametrize("d", fa.BWD_HEAD_DIMS)
def test_flash_backward_launches_its_variant(d):
    """One backward launches its variant's two kernels: ``wgmma`` at head
    dims 64, 80, 128 and 256, ``mma_sync`` at 16 and 32."""
    dev = _card()
    q, k, v, do = _bwd_inputs(8, 2, 130, d, d, dev)
    o, lse = fa.flash_attention_lse(q, k, v)
    before = dict(fa.launches_bwd_by_variant)
    fa.flash_attention_bwd(q, k, v, o, lse, do)
    want = fa.bwd_variant(torch.bfloat16, d)
    assert {n: fa.launches_bwd_by_variant[n] - before[n] for n in before} == {
        n: 2 * (n == want) for n in before}


@pytest.mark.parametrize("mask", [dict(causal=True), dict(causal=True,
                                                            prefix=300),
                                  dict(causal=False)],
                         ids=["causal", "prefix", "bidirectional"])
@pytest.mark.parametrize("d", fa.BWD_WGMMA_HEAD_DIMS)
def test_wgmma_backward_matches_its_tiled_model(d, mask):
    """The Hopper kernels against their plain model
    (`ref.attention_bwd_tiled_ref`: P and dS rounded to bf16 as operands,
    the same steps, the group summed in head order) on the kernels' own o
    and lse, at qwen2.5-3b's heads (16 over 2 kv heads): only float32 sums
    inside a product, ex2.approx and a bf16 unit of P or dS where the two
    round on either side of a tie part them."""
    from repro_torch.kernels.flash_attn.ref import attention_bwd_tiled_ref
    dev = _card()
    q, k, v, do = _bwd_inputs(16, 2, 700, d, d + 1, dev)
    o, lse = fa.flash_attention_lse(q, k, v, **mask)
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **mask)
    want = attention_bwd_tiled_ref(q, k, v, o, lse, do, **mask)
    for g, w in zip(got, want):
        scale = float(w.float().abs().max())
        torch.testing.assert_close(g.float(), w.float(), rtol=1e-2,
                                   atol=5e-3 * scale)


def test_hot_gather_passes_the_slab_gradient():
    """The hot/cold lookup's table gradient on the card equals the CPU's
    (the hot rows through the kernel's autograd Function, the cold ones
    through torch's gather), to float32 sums in another order."""
    dev = _card()
    rng = np.random.default_rng(5)
    table = rng.standard_normal((1000, 32)).astype(np.float32)
    ids = rng.integers(0, 1000, (6, 50)).astype(np.int32)
    grad = rng.standard_normal((6, 50, 32)).astype(np.float32)
    got = []
    for d in (dev, torch.device("cpu")):
        t = torch.from_numpy(table).to(d).requires_grad_(True)
        launches = he.launches
        hot_cold_lookup(torch.from_numpy(ids).to(d), t, 128).backward(
            torch.from_numpy(grad).to(d))
        assert he.launches - launches == (d.type == "cuda")
        got.append(t.grad.cpu())
    assert got[0][:128].abs().sum() > 0
    torch.testing.assert_close(got[0], got[1], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ["qwen2.5-3b", "minicpm-2b"])
def test_training_on_the_card_matches_the_cpu(arch):
    """Smoke qwen2.5-3b (grouped kv) and minicpm-2b (multi-head), 2
    layers, remat on: one microbatch's loss and gradients on the card
    (the flash backward kernels, one pair a layer; the hot-slab gradient)
    against the same weights on the CPU, the loss within 1e-2 and each
    leaf's relative L2 error within 5e-2 (the card keeps PV in float32,
    the CPU rounds p to bf16 first); then two `make_train_step` steps on
    each, losses within 1e-2."""
    import copy
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.train.optim import TrainConfig, init_opt_state
    from repro_torch.train.steps import make_train_step

    dev = _card()
    cfg = dataclasses.replace(smoke_config(arch, layers=2), remat=True)
    host = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = copy.deepcopy(host).to(dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 64)).astype(np.int32))
    grads, losses = [], []
    for model, d in ((host, "cpu"), (card, dev)):
        for p in model.parameters():
            p.requires_grad_(True)
        before = dict(fa.launches_bwd)
        loss, _ = T.loss_fn(model, {"tokens": tokens[:2].to(d)})
        loss.backward()
        if d == dev:
            assert fa.launches_bwd["dq"] - before["dq"] == cfg.num_layers
        losses.append(float(loss.detach()))
        grads.append({n: p.grad.float().cpu()
                      for n, p in model.named_parameters()})
        for p in model.parameters():
            p.grad = None
            p.requires_grad_(False)
    assert losses[1] == pytest.approx(losses[0], rel=1e-2)
    for n, want in grads[0].items():
        assert bool(grads[1][n].any()), n
        rel = float((grads[1][n] - want).norm() / want.norm().clamp(
            min=1e-30))
        assert rel < 5e-2, (n, rel)
    tc = TrainConfig(learning_rate=1e-3, warmup_steps=0, schedule="const",
                     microbatch=2)
    step = make_train_step(cfg, tc)
    out = []
    for model, d in ((host, "cpu"), (card, dev)):
        opt = init_opt_state(T.param_tree(model))
        for _ in range(2):
            model, opt, m = step(model, opt, {"tokens": tokens.to(d)})
        out.append(float(m["loss"]))
    assert out[1] == pytest.approx(out[0], rel=1e-2)


def test_grouped_matmul_trains_on_the_card():
    """`ragged_dot` under autograd on the card: the forward and dX launch
    the `gmm` kernel (dX reading the expert stack transposed) and dW the
    `tgmm` kernel, one launch each; each gradient is its kernel's float32
    sum rounded once to bf16 and held to the plain path at GMM_TOL; rows
    past the groups' total get a zero dX, an empty group a zero dW."""
    dev = _card()
    rng = np.random.default_rng(5)
    m, k, n, e = 300, 136, 200, 4
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(
        dev, torch.bfloat16).requires_grad_(True)
    w = torch.from_numpy((k ** -0.5 * rng.standard_normal((e, k, n))).astype(
        np.float32)).to(dev, torch.bfloat16).requires_grad_(True)
    dy = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).to(
        dev, torch.bfloat16)
    sizes = torch.tensor([120, 0, 150, 17], device=dev)
    offs = torch.zeros(e + 1, dtype=torch.int32, device=dev)
    offs[1:] = sizes.cumsum(0)
    before = dict(gmm_mod.launches_by_variant)
    ragged_dot(x, w, sizes).backward(dy)
    torch.cuda.synchronize()
    launched = {v: gmm_mod.launches_by_variant[v] - before[v]
                for v in before}
    assert launched == {"wgmma": 2, "splitk": 0, "simt": 0, "tgmm": 1}
    wt = w.detach().transpose(1, 2).contiguous()
    dx32 = gmm_mod.gmm(dy, w.detach(), offs, out_dtype=torch.float32,
                       w_transposed=True)
    dw32 = gmm_mod.tgmm(x.detach(), dy, offs, out_dtype=torch.float32)
    torch.testing.assert_close(dx32, gmm_mod.gmm(dy, wt, offs), **GMM_TOL)
    torch.testing.assert_close(dx32, gmm_grouped_ref(dy, wt, offs),
                               **GMM_TOL)
    torch.testing.assert_close(dw32, tgmm_grouped_ref(x.detach(), dy, offs),
                               **GMM_TOL)
    assert torch.equal(x.grad, dx32.to(torch.bfloat16))
    assert torch.equal(w.grad, dw32.to(torch.bfloat16))
    assert not x.grad[287:].any() and not w.grad[1].any()
    assert w.grad[0].any() and w.grad[2].any() and w.grad[3].any()


@pytest.mark.parametrize("case", ["skewed", "one_group", "short", "empty"])
@pytest.mark.parametrize("m,k,n,e", [
    (40, 64, 128, 4), (40, 128, 64, 4),          # smoke moonshot widths
    (1000, 2048, 1408, 64), (1000, 1408, 2048, 64),   # served widths
    (333, 2048, 1408, 64),                        # M not a multiple of 128
    (228, 136, 200, 3)])                          # K % 128, N % 128 != 0
def test_tgmm_matches_plain_version(m, k, n, e, case):
    """The weight-gradient kernel against `tgmm_grouped_ref` at GMM_TOL
    (float32 out: exact bf16 products summed in another order), its bf16
    result the float32 one rounded once, a repeat's bits equal, groups
    with no rows zero, rows past offs[E] ignored, and three launches
    counted under "tgmm" and nothing else."""
    dev = _card()
    rng = np.random.default_rng(m * k + n + e)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(
        dev, torch.bfloat16)
    dy = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32)).to(
        dev, torch.bfloat16)
    if case == "empty":                  # only 2 groups hold rows
        sizes = np.zeros(e, np.int64)
        sizes[[0, e - 1]] = [m // 3, m - m // 3]
    else:
        sizes = _sizes(rng, m, e, case)
    offs = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)]).astype(
        np.int32)).to(dev)
    before = dict(gmm_mod.launches_by_variant)
    got = gmm_mod.tgmm(x, dy, offs)
    again = gmm_mod.tgmm(x, dy, offs)
    half = gmm_mod.tgmm(x, dy, offs, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert gmm_mod.launches_by_variant == {**before,
                                           "tgmm": before["tgmm"] + 3}
    assert got.dtype == torch.float32 and got.shape == (e, k, n)
    assert torch.equal(got, again)
    torch.testing.assert_close(got, tgmm_grouped_ref(x, dy, offs), **GMM_TOL)
    assert torch.equal(half, got.to(torch.bfloat16))
    for g in np.flatnonzero(sizes == 0):
        assert not got[g].any()
    total = int(sizes.sum())
    if total < m:                        # rows past the total add nothing
        torch.testing.assert_close(got, gmm_mod.tgmm(
            x[:total].contiguous(), dy[:total].contiguous(), offs),
            rtol=0, atol=0)


def _tgmm_operands(dev, rng, sizes, k, n, tail=0, dy_scale=1.0):
    """bf16 x (M, K) from N(0, 1) and dy (M, N) from N(0, dy_scale²), M
    the sizes' total plus ``tail`` rows past it, and the (E + 1,) int32
    offsets on the card."""
    m = int(np.sum(sizes)) + tail
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(
        dev, torch.bfloat16)
    dy = torch.from_numpy((dy_scale * rng.standard_normal((m, n))).astype(
        np.float32)).to(dev, torch.bfloat16)
    offs = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)]).astype(
        np.int32)).to(dev)
    return x, dy, offs


# mixtral-8x7b's training microbatch: 2 x 4,096 tokens, top 2 of 8
# experts, 16,384 rows, one expert empty
MIXTRAL_TGMM_SIZES = [2731, 0, 1964, 2305, 2048, 2600, 2100, 2636]
# group sizes whose ends fall off multiples of 64 and of 16, groups of
# fewer than 16 rows (1, 3, 5), empty groups, and a group of 2,049 rows
# (33 slices) whose tiles spread over many persistent blocks; K and N
# at the served widths, off multiples of 128 and 256, and at the smoke's
# widths over more groups than the kernel orders (1,100: they keep their
# own order) and more tiles than the card has blocks; and mixtral-8x7b's
# gate and down products at a training microbatch
_TGMM_EDGE_CASES = {
    "served": ([5, 77, 3, 2049, 0, 131, 1, 600, 0, 270], 2048, 1408, 13),
    "down": ([5, 77, 3, 2049, 0, 131, 1, 600, 0, 270], 1408, 2048, 0),
    "mixtral": (MIXTRAL_TGMM_SIZES, 4096, 14336, 0),
    "mixtral_down": (MIXTRAL_TGMM_SIZES, 14336, 4096, 0),
    "ragged": ([17, 0, 1, 95, 200, 15], 136, 200, 29),
    "many_groups": (None, 64, 128, 7),
}


@pytest.mark.parametrize("case", sorted(_TGMM_EDGE_CASES))
def test_tgmm_holds_at_group_edges(case):
    """The weight-gradient kernel where a group's last slice is short:
    held to `tgmm_grouped_ref` at GMM_TOL, its bf16 result the float32
    one rounded once, a repeat's bits equal, empty groups zero, the rows
    past offs[E] adding nothing (the same bits without them), one launch
    a call. dy is at a gradient's scale, 1 / sqrt(the longest group's
    rows), so that |dW| stays near 1 as in the shorter groups of
    `test_tgmm_matches_plain_version`: two float32 sums of 2,049 unit
    products in other orders part by more than GMM_TOL's 1e-4 where the
    sum is near 0. A row of a neighbour left in a group's last slice
    would still move its dW by about 1e-2, and the bits of the call
    without the rows past offs[E] would differ."""
    dev = _card()
    rng = np.random.default_rng(27)
    sizes, k, n, tail = _TGMM_EDGE_CASES[case]
    if sizes is None:
        sizes = rng.integers(0, 40, 1100)
        sizes[::7] = 0
    sizes = np.asarray(sizes)
    x, dy, offs = _tgmm_operands(dev, rng, sizes, k, n, tail,
                                 float(sizes.max()) ** -0.5)
    before = gmm_mod.launches_by_variant["tgmm"]
    got = gmm_mod.tgmm(x, dy, offs)
    again = gmm_mod.tgmm(x, dy, offs)
    half = gmm_mod.tgmm(x, dy, offs, out_dtype=torch.bfloat16)
    total = int(sizes.sum())
    cut = gmm_mod.tgmm(x[:total].contiguous(), dy[:total].contiguous(), offs)
    torch.cuda.synchronize()
    assert gmm_mod.launches_by_variant["tgmm"] == before + 4
    assert got.shape == (len(sizes), k, n) and torch.equal(got, again)
    torch.testing.assert_close(got, tgmm_grouped_ref(x, dy, offs), **GMM_TOL)
    assert torch.equal(half, got.to(torch.bfloat16))
    assert torch.equal(cut, got)
    assert not got[torch.from_numpy(sizes == 0).to(dev)].any()


def test_tgmm_keeps_non_finite_rows_in_their_group():
    """An inf in one row of group g makes only dW[g] non-finite (the
    group before it reads that row in its last slice, and zeroes it); a
    NaN in a row past offs[E] leaves every dW finite. The finite groups
    are held to the plain version at GMM_TOL."""
    dev = _card()
    rng = np.random.default_rng(2727)
    sizes = np.array([70, 9, 130, 0, 45])
    k, n = 200, 264
    x, dy, offs = _tgmm_operands(dev, rng, sizes, k, n, tail=20)
    x[70 + 2, 150] = float("inf")     # group 1's third row
    dy[260, 3] = float("nan")         # past offs[E] = 254
    dw = gmm_mod.tgmm(x, dy, offs)
    torch.cuda.synchronize()
    finite = torch.isfinite(dw).flatten(1).all(1).tolist()
    assert finite == [True, False, True, True, True]
    assert torch.isfinite(dw[1, :150]).all()
    assert torch.isfinite(dw[1, 151:]).all()
    keep = [0, 2, 3, 4]
    torch.testing.assert_close(dw[keep], tgmm_grouped_ref(x, dy, offs)[keep],
                               **GMM_TOL)


@pytest.mark.parametrize("case,m,k,n,e", [
    ("m1", 1, 1408, 2048, 64),
    ("boundary", 228, 200, 136, 3),     # K % 64 != 0, N % 256 != 0
    ("empty", 300, 1408, 2048, 64),
    ("one_group", 1000, 2048, 1408, 64),
    ("short", 1000, 1408, 2048, 64),
    ("skewed", 1000, 2048, 1408, 64),
    ("decode", 24, 1408, 2048, 64)])
def test_gmm_takes_the_stack_transposed(case, m, k, n, e):
    """``gmm(..., w_transposed=True)`` multiplies by each ``w[e]ᵀ`` of an
    (E, N, K) stack through the ``wgmma`` kernel at any M (decode-sized
    too), held to the plain version on the transposed view at GMM_TOL,
    its bf16 result the float32 one rounded once, a repeat's bits equal,
    rows past offs[E] zero, three launches under "wgmma"; other variants
    and float32 operands raise before any launch."""
    dev = _card()
    rng = np.random.default_rng(m * k + n + e + 1)
    x = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32)).to(
        dev, torch.bfloat16)
    w = torch.from_numpy((k ** -0.5 * rng.standard_normal((e, n, k))).astype(
        np.float32)).to(dev, torch.bfloat16)
    sizes = _variant_sizes(rng, case, m, e)
    offs = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)]).astype(
        np.int32)).to(dev)
    before = dict(gmm_mod.launches_by_variant)
    got = gmm_mod.gmm(x, w, offs, w_transposed=True)
    again = gmm_mod.gmm(x, w, offs, w_transposed=True)
    half = gmm_mod.gmm(x, w, offs, out_dtype=torch.bfloat16,
                       w_transposed=True)
    torch.cuda.synchronize()
    assert gmm_mod.launches_by_variant == {**before,
                                           "wgmma": before["wgmma"] + 3}
    assert got.shape == (m, n) and torch.equal(got, again)
    torch.testing.assert_close(
        got, gmm_grouped_ref(x, w.transpose(1, 2), offs), **GMM_TOL)
    assert torch.equal(half, got.to(torch.bfloat16))
    assert not got[int(sizes.sum()):].any()
    with pytest.raises(ValueError, match="'wgmma'"):
        gmm_mod.gmm(x, w, offs, w_transposed=True, variant="splitk")
    with pytest.raises(TypeError, match="bfloat16"):
        gmm_mod.gmm(x.float(), w.float(), offs, w_transposed=True)
    with pytest.raises(ValueError, match=r"\(E, N, K\)"):
        gmm_mod.gmm(x, w.transpose(1, 2).contiguous(), offs,
                    w_transposed=True)
    assert gmm_mod.launches_by_variant["wgmma"] == before["wgmma"] + 3


_FRESH_BACKWARD = {
    "ragged_dot": """
        from repro_torch.kernels.moe_gmm.ops import ragged_dot
        x = torch.randn(256, 64, device="cuda").bfloat16().requires_grad_()
        w = torch.randn(4, 64, 128, device="cuda").bfloat16()
        y = ragged_dot(x, w, torch.full((4,), 64, device="cuda"))
        y.backward(torch.ones_like(y))
        grad = x.grad
    """,
    "ragged_dot_w": """
        from repro_torch.kernels.moe_gmm.ops import ragged_dot
        x = torch.randn(256, 64, device="cuda").bfloat16()
        w = torch.randn(4, 64, 128, device="cuda").bfloat16().requires_grad_()
        y = ragged_dot(x, w, torch.full((4,), 64, device="cuda"))
        y.backward(torch.ones_like(y))
        grad = w.grad
    """,
    "flash_attention": """
        from repro_torch.kernels.flash_attn.flash_attn import (
            flash_attention_grad)
        q = torch.randn(4, 256, 64, device="cuda").bfloat16().requires_grad_()
        k, v = (torch.randn(4, 256, 64, device="cuda").bfloat16()
                for _ in range(2))
        o = flash_attention_grad(q, k, v)
        o.backward(torch.ones_like(o))
        grad = q.grad
    """,
}


@pytest.mark.parametrize("op", sorted(_FRESH_BACKWARD))
def test_backward_kernels_bind_a_fresh_thread(op):
    """A backward whose first CUDA work on autograd's worker thread is a
    TMA-fed kernel (the grouped matmul's dX reading the stack transposed;
    with only w requiring a gradient, `tgmm`; the flash backward): that
    thread has no current context yet, and the kernel binds the device's
    before it encodes its tensor maps. In a process of its own, so that
    no earlier test has warmed the thread."""
    _card()
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    code = "import torch\n" + textwrap.dedent(_FRESH_BACKWARD[op]) + (
        "torch.cuda.synchronize()\n"
        "assert bool(torch.isfinite(grad).all()) and bool(grad.any())\n")
    env = {**os.environ, "PYTHONPATH": str(src)}
    done = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=900)
    assert done.returncode == 0, done.stdout[-2000:] + done.stderr[-4000:]


def test_tgmm_refuses_what_its_kernel_does_not_take():
    """float32 (or mixed) operands, another offsets dtype, a device
    mismatch, K or N not a multiple of 8, non-contiguous operands and
    mismatched rows all raise before any launch."""
    dev = _card()
    x = torch.zeros(64, 32, device=dev, dtype=torch.bfloat16)
    dy = torch.zeros(64, 16, device=dev, dtype=torch.bfloat16)
    offs = torch.tensor([0, 40, 64], dtype=torch.int32, device=dev)
    before = dict(gmm_mod.launches_by_variant)
    with pytest.raises(TypeError, match="bfloat16"):
        gmm_mod.tgmm(x.float(), dy.float(), offs)
    with pytest.raises(TypeError, match="bfloat16"):
        gmm_mod.tgmm(x, dy.float(), offs)
    with pytest.raises(TypeError, match="int32"):
        gmm_mod.tgmm(x, dy, offs.long())
    with pytest.raises(ValueError, match="is on"):
        gmm_mod.tgmm(x, dy.cpu(), offs)
    with pytest.raises(ValueError, match="multiples of 8"):
        gmm_mod.tgmm(x[:, :28].contiguous(), dy, offs)
    with pytest.raises(ValueError, match="contiguous"):
        gmm_mod.tgmm(x.t().contiguous().t(), dy, offs)
    with pytest.raises(ValueError, match="x must be"):
        gmm_mod.tgmm(x[:32].contiguous(), dy, offs)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        gmm_mod.tgmm(x, dy, offs, out_dtype=torch.float16)
    xr = x.float().requires_grad_(True)
    w = torch.zeros(2, 32, 16, device=dev, requires_grad=True)
    y = ragged_dot(xr, w, torch.tensor([40, 24], device=dev))
    with pytest.raises(TypeError, match="bfloat16"):
        y.backward(torch.ones_like(y))
    torch.cuda.synchronize()
    assert gmm_mod.launches_by_variant["tgmm"] == before["tgmm"]


def test_tgmm_of_no_rows_is_zero_without_a_launch():
    """M 0: every group is empty, so dW is zeros, in either dtype, and
    no kernel runs (a TMA map cannot span no rows)."""
    dev = _card()
    x = torch.zeros(0, 136, device=dev, dtype=torch.bfloat16)
    dy = torch.zeros(0, 200, device=dev, dtype=torch.bfloat16)
    offs = torch.zeros(4, dtype=torch.int32, device=dev)
    before = gmm_mod.launches_by_variant["tgmm"]
    for dtype in (torch.float32, torch.bfloat16):
        dw = gmm_mod.tgmm(x, dy, offs, out_dtype=dtype)
        assert dw.shape == (3, 136, 200) and dw.dtype == dtype
        assert not dw.any()
    assert gmm_mod.launches_by_variant["tgmm"] == before


def test_moe_training_on_the_card_matches_the_cpu():
    """Smoke moonshot, 2 layers, remat on: one microbatch's loss and
    gradients on the card against the same weights on the CPU, the card
    replaying the CPU's expert choices (`models.moe.RouteTape`; with remat
    both runs route each layer twice, in the same order), the loss within
    1e-2 and each leaf's relative L2 error within 5e-2, no leaf all zero;
    9 `gmm` launches a layer (the forward, the replay and dX of 3
    products) and 3 `tgmm`; and on the card, the same gradients with
    remat off and on a repeat, bit for bit."""
    import copy
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.models.moe import RouteTape

    dev = _card()
    cfg = dataclasses.replace(smoke_config("moonshot-v1-16b-a3b", layers=2),
                              remat=True)
    host = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 64)).astype(np.int32))

    def grads_of(model, d, tape):
        for p in model.parameters():
            p.requires_grad_(True)
        with tape:
            loss, _ = T.loss_fn(model, {"tokens": tokens.to(d)})
            loss.backward()
        out = {n: p.grad.float().cpu() for n, p in model.named_parameters()}
        for p in model.parameters():
            p.grad = None
            p.requires_grad_(False)
        return float(loss.detach()), out

    tape = RouteTape()
    want_loss, want = grads_of(host, "cpu", tape)
    card = copy.deepcopy(host).to(dev)
    before = dict(gmm_mod.launches_by_variant)
    got_loss, got = grads_of(card, dev, RouteTape(tape.experts))
    torch.cuda.synchronize()
    launched = {v: gmm_mod.launches_by_variant[v] - before[v]
                for v in before}
    v = gmm_mod.variant(tokens.numel() * cfg.experts_per_token,
                        cfg.num_experts, cfg.d_model, cfg.d_ff)
    expected = dict.fromkeys(before, 0)
    expected[v] += 6 * cfg.num_layers        # the forward and its replay
    expected["wgmma"] += 3 * cfg.num_layers  # dX, the stack read transposed
    expected["tgmm"] = 3 * cfg.num_layers
    assert launched == expected
    assert got_loss == pytest.approx(want_loss, rel=1e-2)
    for n, w in want.items():
        assert bool(got[n].any()), n
        rel = float((got[n] - w).norm() / w.norm().clamp(min=1e-30))
        assert rel < 5e-2, (n, rel)
    # without remat each layer routes once: the forward's choices alone
    plain = T.init_params(dataclasses.replace(cfg, remat=False),
                          torch.Generator().manual_seed(0), "cpu").to(dev)
    _, no_remat = grads_of(plain, dev,
                           RouteTape(tape.experts[:cfg.num_layers]))
    _, again = grads_of(card, dev, RouteTape(tape.experts))
    for n in got:
        assert torch.equal(no_remat[n], got[n]), n
        assert torch.equal(again[n], got[n]), n


# ---------------------------------------------------------------- the mesh
def _mesh4(shape):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh(shape, ("data", "model"), "cuda:0")


@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_seqsharded_decode_attention_on_the_card(shape):
    """``layers._decode_attn_seqsharded`` at qwen2.5-3b's heads (2 kv heads
    of 8 query heads, head dim 128) on 4 shards of the card, the cache
    split on its sequence over ``model`` (and its rows over ``data``),
    against the unsharded decode attention (``_sdpa_chunked``, p in
    float32) over the same cache after the same write: within 1e-3 or one
    bf16 unit of each value (both round one float32 result to bf16); the
    cache's slices equal the whole cache's."""
    from repro_torch.configs import get_config
    from repro_torch.launch.shardings import P, shard_leaf
    from repro_torch.models import layers as L
    dev = _card()
    cfg = get_config("qwen2.5-3b")
    mesh = _mesh4(shape)
    b, t, filled = 4, 4096, 3000
    kv, dh = cfg.num_kv_heads, cfg.head_dim
    rep = cfg.num_heads // kv
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*s):
        return torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
    q, kn, vn = randn(b, 1, kv, rep, dh), randn(b, 1, kv, dh), randn(
        b, 1, kv, dh)
    ck, cv = randn(b, t, kv, dh), randn(b, t, kv, dh)
    length = torch.tensor(filled, dtype=torch.int32, device=dev)
    rows = "data" if shape[0] > 1 else None
    spec = P(rows, "model", None, None)
    cache = {"k": shard_leaf(ck, spec, mesh), "v": shard_leaf(cv, spec, mesh),
             "length": shard_leaf(length, P(), mesh)}
    per = b // shape[0]

    def mine(x, i):     # shard i's rows
        r = mesh.coords(i)["data"]
        return x[r * per:(r + 1) * per]
    n = mesh.size
    got, new = L._decode_attn_seqsharded(
        [mine(q, i) for i in range(n)], [mine(kn, i) for i in range(n)],
        [mine(vn, i) for i in range(n)], cache, cfg, mesh)
    pos = length[None]
    wk, wv, k_pos, k_valid = L._cache_write(
        {"k": ck.clone(), "v": cv.clone(), "length": length}, kn, vn, cfg,
        pos)
    want = L._sdpa_chunked(q.reshape(b, 1, kv * rep, dh), wk, wv, pos,
                           k_pos, cfg, k_valid, round_p=False).float()
    unit = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-30)))
                      - 7)
    for i, o in enumerate(got):
        w, u = mine(want, i), mine(unit, i)
        d = (o.reshape(w.shape).float() - w).abs()
        assert bool((d <= torch.clamp(u, min=1e-3)).all()), float(d.max())
    assert torch.equal(new["k"].full(), wk)
    assert torch.equal(new["v"].full(), wv)
    assert all(int(x) == filled + 1 for x in new["length"].shards)


def test_capacity_dispatch_through_moe_gmm_on_the_card():
    """``moe._dispatch_capacity`` at moonshot's widths (d 2048, 64 experts,
    top 6; one model shard's F/2 = 704 slice of every expert) over 512
    tokens whose routing sends every token to expert 0 (so its group
    drops rows past the capacity of 128), on the card through
    ``moe_gmm`` (3 launches, every group ``cap`` rows) against its plain
    version on the CPU on the same inputs: the output within 2% of each
    value or of the largest magnitude (tests/test_torch_models.py's bf16
    standard: the bf16 intermediates round at other places), the same rows
    kept and dropped; and its gradients (``tgmm`` and dX) within 5e-2
    relative L2 of the CPU's."""
    from repro_torch.models import moe as TM
    dev = _card()
    t, d, f, e, k = 512, 2048, 704, 64, 6
    cap = TM.capacity(t, type("C", (), {"experts_per_token": k,
                                        "num_experts": e})())
    assert cap == 128
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(t, d, generator=gen).to(torch.bfloat16)
    weights = 1.0 / torch.arange(1, e + 1, dtype=torch.float32)
    rest = torch.stack([torch.multinomial(weights[1:], k - 1, generator=gen)
                        + 1 for _ in range(t)])
    experts = torch.cat([torch.zeros(t, 1, dtype=torch.long), rest], 1)
    gates = torch.softmax(torch.randn(t, k, generator=gen), -1)
    ws = [torch.randn(e, d, f, generator=gen) * d ** -0.5,
          torch.randn(e, d, f, generator=gen) * d ** -0.5,
          torch.randn(e, f, d, generator=gen) * f ** -0.5]
    runs = {}
    for where in ("cpu", dev):
        xs = x.detach().to(where).requires_grad_(True)
        wt = [w.detach().to(where).requires_grad_(True) for w in ws]
        launched = gmm_mod.launches
        with TM.DropTape() as tape:
            y = TM._dispatch_capacity(xs, experts.to(where), gates.to(where),
                                      *wt, e, cap)
        if where == dev:
            assert gmm_mod.launches - launched == 3
        y.float().square().sum().backward()
        runs[str(where)] = (y.detach().float().cpu(), tape.dropped(), tape.totals(),
                            [xs.grad.float().cpu()]
                            + [w.grad.float().cpu() for w in wt])
    (yc, dc, tc, gc), (yg, dg, tg, gg) = runs["cpu"], runs[str(dev)]
    assert tc == tg and tc["dropped"] >= t - cap
    for a, b in zip(dc, dg):
        assert np.array_equal(a, b)
    frac = 2e-2
    torch.testing.assert_close(yg, yc, rtol=frac,
                               atol=frac * float(yc.abs().max()))
    for a, b in zip(gg, gc):
        assert float((a - b).norm() / b.norm()) < 5e-2
