"""PyTorch port: the device graph upload equals the JAX package's.

`repro_torch.algos.graph_arrays.to_device` must give the same eleven
fields, with the same dtypes and values, as `repro.algos.graph_arrays`
on every conftest graph, padded and unpadded; `from_numpy` carries a JAX
upload across unchanged. The port must not import JAX or `repro`, and
its entry points must refuse to run without a card unless the caller
asks for the CPU.
"""
from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.algos import graph_arrays as jga  # noqa: E402
from repro_torch.algos import graph_arrays as tga  # noqa: E402
from repro_torch.engine.backends import bucket_dims  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"vertex_valid": torch.bool, "edge_valid": torch.bool}


def _host(ga) -> dict:
    return {k: None if v is None else np.asarray(v)
            for k, v in ga._asdict().items()}


def _assert_same(want: dict, got) -> None:
    assert list(want) == list(got._fields)
    for name, w in want.items():
        t = getattr(got, name)
        if w is None:
            assert t is None, name
            continue
        assert t.dtype == DTYPES.get(name, torch.int32), name
        assert t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), w, err_msg=name)
        assert t.numpy().dtype == w.dtype, name


@pytest.mark.parametrize("padded", [False, True], ids=["exact", "bucket"])
def test_to_device_matches_reference(any_graph, padded):
    g = any_graph
    pad = bucket_dims(g.num_vertices, g.num_edges) if padded else None
    canon = np.random.default_rng(0).permutation(g.num_vertices)
    want = _host(jga.to_device(g, canonical_ids=canon, pad_to=pad))
    got = tga.to_device(g, canonical_ids=canon, pad_to=pad, device="cpu")
    _assert_same(want, got)
    assert got.num_vertices == len(want["indptr"]) - 1
    assert got.num_edges == len(want["indices"])


@pytest.mark.parametrize("padded", [False, True], ids=["exact", "bucket"])
def test_from_numpy_round_trip(plc_graph, padded):
    pad = (4096, 32768) if padded else None
    want = _host(jga.to_device(plc_graph, pad_to=pad))
    got = tga.from_numpy(want, device="cpu")
    _assert_same(want, got)
    # the upload owns its memory: writing to it leaves the source alone
    got.indices[0] += 1
    assert want["indices"][0] + 1 == int(got.indices[0])


def test_to_device_rejects_bad_padding(tiny_graph):
    with pytest.raises(ValueError, match="smaller than graph"):
        tga.to_device(tiny_graph, pad_to=(4, 4), device="cpu")
    with pytest.raises(ValueError, match="padded vertex"):
        tga.to_device(tiny_graph, pad_to=(8, 64), device="cpu")


def test_edge_weights_are_the_reference_hash(rmat_graph):
    src, dst = rmat_graph.edge_src, rmat_graph.indices
    np.testing.assert_array_equal(tga.edge_weights(src, dst),
                                  jga.edge_weights(src, dst))


def test_port_imports_neither_jax_nor_repro():
    code = ("import sys\n"
            "import repro_torch, repro_torch.engine\n"
            "import repro_torch.kernels.csr_spmv.csr_spmv\n"
            "import repro_torch.kernels.csr_spmv.ops\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]


def test_entry_points_refuse_without_a_card(tiny_graph):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.engine import EngineSession
    from repro_torch.kernels.csr_spmv.ops import SpMV
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tga.to_device(tiny_graph)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EngineSession()
    t = tiny_graph.transpose
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpMV(t.indptr, t.indices)
