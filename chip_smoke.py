#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) end to end on one CUDA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and none is caught:

1. Card: print ``nvidia-smi --query-gpu=name,power.limit``.
2. Build: compile every CUDA source of the port (one ``nvcc`` each, all
   at once) and print the build seconds.
3. Kernel check: ``csr_spmv`` against its plain PyTorch version on the
   card (ragged rows, empty rows, a graph with no edges, a bucketed
   upload with sentinel edges of value 0), rtol 1e-5 / atol 1e-6: float32
   sums taken in another order. Each result must also repeat bit for bit.
4. Serve: ``EngineSession(device="cuda")`` registers a 1M-vertex
   power-law community graph (the repo's ``lj-sim`` recipe, a stand-in
   for LiveJournal), lets the policy reorder it, and answers BFS, SSSP
   and BC (4 sources each), PR, CC and CC-SV. The launch counters are
   set to 0 just before and read just after; every answer is checked
   against the numpy oracles of ``core/baselines.py`` (exact for BFS,
   SSSP, CC and CC-SV; rtol 1e-4 for PR, 1e-3 for BC).
5. Kernel timing at the served graph's shapes (the real rows of its
   in-CSR, as PR's relaxation passes them): the kernel, its plain
   version, one ``torch.sparse`` CSR product as a yardstick (timed only;
   the port never calls it) and the bound (bytes over 3.35 TB/s, the
   H100 SXM's HBM rate).

The line before the last is the ``kernels`` JSON object; the last line
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SEED = 7
NUM_VERTICES = 1_000_000
SPMV_TOL = dict(rtol=1e-5, atol=1e-6)
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12               # H100 SXM float32 outside tensor cores


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def cuda_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device milliseconds per call, from CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def spmv_check(name, t_indptr, t_indices, val, x) -> float:
    """Kernel vs plain version on the same card tensors; returns max |err|."""
    import torch
    from repro_torch.kernels.csr_spmv import csr_spmv as spmv
    from repro_torch.kernels.csr_spmv.ref import csr_spmv_ref
    got = spmv.csr_spmv(t_indptr, t_indices, val, x)
    again = spmv.csr_spmv(t_indptr, t_indices, val, x)
    want = csr_spmv_ref(t_indptr, t_indices, val, x)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"csr_spmv[{name}]: two runs differ")
    torch.testing.assert_close(got, want, **SPMV_TOL)
    err = float((got - want).abs().max()) if got.numel() else 0.0
    print(f"csr_spmv[{name}]: rows={got.numel()} "
          f"edges={int(t_indptr[-1])} max_abs_err={err:.3e}")
    return err


def kernel_cases(dev) -> float:
    """Phase 3: the edge cases of tests/test_csr_spmv.py, on the card."""
    import numpy as np
    import torch
    from repro_torch.algos.graph_arrays import to_device
    from repro_torch.core.csr import from_edges
    from repro_torch.core.generators import powerlaw_community
    from repro_torch.engine.backends import bucket_dims

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(n):
        return torch.rand(n, generator=gen, device=dev)

    def in_csr(g):
        t = g.transpose
        return (torch.from_numpy(np.asarray(t.indptr, np.int32)).to(dev),
                torch.from_numpy(np.asarray(t.indices, np.int32)).to(dev))

    errs = []
    g = powerlaw_community(20_000, avg_degree=12.0, mixing=0.12, seed=SEED)
    ip, ix = in_csr(g)
    errs.append(spmv_check("ragged", ip, ix, rand(ix.numel()),
                           rand(g.num_vertices)))
    g = from_edges(600, [0, 1, 2], [5, 5, 515])
    ip, ix = in_csr(g)
    errs.append(spmv_check("empty_rows", ip, ix, torch.ones(3, device=dev),
                           rand(600)))
    g = from_edges(17, np.array([], np.int64), np.array([], np.int64))
    ip, ix = in_csr(g)
    errs.append(spmv_check("no_edges", ip, ix,
                           torch.ones(0, device=dev), rand(17)))
    g = powerlaw_community(3000, avg_degree=8.0, seed=11)
    ga = to_device(g, pad_to=bucket_dims(g.num_vertices, g.num_edges),
                   device=dev)
    errs.append(spmv_check("sentinels", ga.t_indptr, ga.t_indices,
                           ga.edge_valid.to(torch.float32),
                           rand(ga.num_vertices)))
    return max(errs)


def serve(dev, num_vertices: int) -> dict:
    """Phase 4: the port's main path, checked against the numpy oracles."""
    import numpy as np
    from repro_torch.algos.graph_arrays import edge_weights
    from repro_torch.core import baselines as B
    from repro_torch.core.generators import powerlaw_community
    from repro_torch.engine import EngineSession
    from repro_torch.kernels.csr_spmv import csr_spmv as spmv

    t0 = time.perf_counter()
    g = powerlaw_community(num_vertices, avg_degree=14.0, mixing=0.12,
                           seed=SEED)
    print(f"graph: V={g.num_vertices} E={g.num_edges} "
          f"generated in {time.perf_counter() - t0:.1f} s")
    session = EngineSession(device=dev)
    t0 = time.perf_counter()
    gid = session.register(g, graph_id="lj-sim", expected_queries=4096)
    entry = session.registry.get(gid)
    print(f"registered in {time.perf_counter() - t0:.1f} s: "
          f"bucket={entry.bucket_shape} "
          f"device_bytes={entry.handle.device_bytes}")
    print(f"decision: {entry.decision}")

    rng = np.random.default_rng(SEED)
    sources = {k: rng.choice(g.num_vertices, 4, replace=False)
               for k in ("bfs", "sssp", "bc")}
    kernels = ("bfs", "sssp", "bc", "pr", "cc", "ccsv")
    spmv.launches = 0
    futures = {k: session.enqueue(gid, k, sources.get(k)) for k in kernels}
    t0 = time.perf_counter()
    session.flush()
    served_s = time.perf_counter() - t0
    launches = {"csr_spmv": spmv.launches}
    out = {k: np.asarray(f.result()) for k, f in futures.items()}
    print(f"served {len(kernels)} requests in {served_s:.3f} s")
    m = session.metrics()
    for k in kernels:
        h = m.histogram("engine_launch_wall_seconds", "device wall per launch",
                        kernel=k, backend="single")
        print(f"launch wall {k}: {h.sum:.4f} s over {h.count} launch(es)")
    if launches["csr_spmv"] <= 0:
        raise AssertionError("the PR request did not launch csr_spmv")
    print(f"csr_spmv launches during the PR request: {launches['csr_spmv']}")

    t0 = time.perf_counter()
    weights = edge_weights(g.edge_src, g.indices)
    for i, s in enumerate(sources["bfs"]):
        np.testing.assert_array_equal(out["bfs"][i], B.bfs_baseline(g, s))
    for i, s in enumerate(sources["sssp"]):
        np.testing.assert_array_equal(out["sssp"][i].astype(np.int64),
                                      B.sssp_baseline(g, weights, s))
    for i, s in enumerate(sources["bc"]):
        np.testing.assert_allclose(out["bc"][i], B.bc_baseline(g, [s]),
                                   rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(out["pr"], B.pagerank_baseline(g),
                               rtol=1e-4, atol=1e-9)
    labels = B.cc_baseline(g)
    np.testing.assert_array_equal(out["cc"], labels)
    np.testing.assert_array_equal(out["ccsv"], labels)
    for k in kernels:
        print(f"{k}: shape={out[k].shape} dtype={out[k].dtype} "
              f"matches the numpy oracle")
    print(f"oracles checked in {time.perf_counter() - t0:.1f} s")
    return {"session": session, "entry": entry, "launches": launches}


def time_spmv(entry) -> tuple[dict, float]:
    """Phase 5: csr_spmv at the served shapes, beside plain and library."""
    import torch
    from repro_torch.kernels.csr_spmv import csr_spmv as spmv
    from repro_torch.kernels.csr_spmv.ref import csr_spmv_ref

    ga, n = entry.handle.arrays, entry.handle.num_vertices
    e = entry.handle.num_edges
    ip = ga.t_indptr[:n + 1]
    ix, val = ga.t_indices, entry.handle.spmv_val
    gen = torch.Generator(device=ga.device).manual_seed(SEED)
    x = torch.rand(n, generator=gen, device=ga.device)
    err = spmv_check("served", ip, ix, val, x)
    kept = spmv.launches
    ms = cuda_ms(lambda: spmv.csr_spmv(ip, ix, val, x), reps=50)
    plain_ms = cuda_ms(lambda: csr_spmv_ref(ip, ix, val, x), reps=20)
    mat = torch.sparse_csr_tensor(ip, ix[:e], val[:e], size=(n, n),
                                  check_invariants=True)
    library_ms = cuda_ms(lambda: mat @ x, reps=50)
    spmv.launches = kept  # timing launches are not the main path's
    nbytes = 4 * (n + 1) + 8 * e + 4 * n + 4 * n
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * e / F32_FLOPS * 1e3
    print(f"csr_spmv timing: rows={n} edges={e} ms={ms:.4f} "
          f"plain_ms={plain_ms:.4f} library_ms={library_ms:.4f} "
          f"bound_ms={max(bytes_ms, ops_ms):.4f} ({nbytes} bytes)")
    return ({"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
             "bound_ms": max(bytes_ms, ops_ms),
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"},
            err)


def main() -> int:
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found; run from the root of "
              "a checkout", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 3
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    card = card_line()
    print(f"card: {card}")
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")

    err = kernel_cases(dev)
    served = serve(dev, NUM_VERTICES)
    timing, served_err = time_spmv(served["entry"])
    served["session"].close()
    kernels = [{
        "name": "csr_spmv",
        "route": "cuda",
        "source": "src/repro_torch/csrc/csr_spmv.cu",
        "replaces": "src/repro/kernels/csr_spmv/csr_spmv.py:88",
        "launches": served["launches"]["csr_spmv"],
        "max_abs_err": max(err, served_err),
        **timing,
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
