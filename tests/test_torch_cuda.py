"""PyTorch port on a CUDA card: the hand-written SpMV and the engine.

Every test here needs a card; each decides inside itself and skips with
a reason where there is none. The file imports neither JAX nor `repro`,
so it runs on a host that has only the port's dependencies::

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

The kernel is held to its plain version at rtol 1e-5 / atol 1e-6: the
float32 sums of a row are taken in another order.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.csr import from_edges  # noqa: E402
from repro_torch.engine import BatchedExecutor, EngineSession  # noqa: E402
from repro_torch.kernels.csr_spmv import csr_spmv as spmv_mod  # noqa: E402
from repro_torch.kernels.csr_spmv.ref import csr_spmv_ref  # noqa: E402

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
    """Random graphs: rows shorter and longer than the 4x32-edge unroll,
    and empty rows."""
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
    """A hub row of 100k in-edges, walked by one warp, beside short rows."""
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
