#!/usr/bin/env python3
"""Time the CSR SpMV's wrapper (``csr_spmv.csr_spmv``) of one or more
checkouts of the port, in turns, on one CUDA card.

    python3 spmv_ab.py                       # this checkout
    python3 spmv_ab.py build/parent . . build/parent

The graph is the one ``chip_smoke.py`` serves:
``powerlaw_community(1_000_000, avg_degree=14.0, mixing=0.12, seed=7)``
relabelled by LOrder at kappa 4 (the policy's pick for it), made once
with this checkout's modules and kept in ``build/spmv_ab_graph.npz``
(``build/`` is gitignored). Its in-CSR goes in as PageRank's relaxation
passes it: the real rows' ``t_indptr`` with the edge arrays of the
bucketed upload (sentinel slots after the real edges, value 0), and an
``x`` drawn from a seeded generator on the card.

Each argument is the root of a checkout; each runs in a process of its
own (the checkouts share module names), builds that checkout's kernels
into its own ``build/kernels`` and measures, on the same inputs:

* device ms a call: CUDA events over 100 calls queued behind a device
  sleep, so that the host cannot starve the device;
* host ms a call: the wall of enqueuing 200 calls after a synchronize,
  as ``chip_smoke.py``'s phase 5 takes it;

and holds the result to the plain version (rtol 1e-5 / atol 1e-6) and a
repeat to its bits. Prints one line per checkout, and the card's name and
power limit.

    python3 spmv_ab.py --floor

times, on the same arrays, a plain grid-stride kernel (source below,
built with ``nvcc`` into ``build/``) that reads every real edge's index
and value with coalesced loads and sums ``val[e] * x[f(idx[e])]``, 8
loads in flight a thread: with no gather (x read as 1: the stream
alone), f = idx & 8191 (gathers that stay in L1) and f = idx (the real
gathers). It
is no SpMV and the port never calls it; it shows what the edge stream and
the x gathers cost on this graph with nothing else in the way. Before it,
the arrays alone give how the gathers spread (`gather_stats`).
"""
from __future__ import annotations

import pathlib
import subprocess
import sys
import time

import ab_harness

ROOT = pathlib.Path(__file__).resolve().parent
GRAPH = ROOT / "build" / "spmv_ab_graph.npz"
SEED = 7


def make_graph() -> None:
    """The served graph's in-CSR, once, with this checkout's modules."""
    import numpy as np
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.generators import powerlaw_community
    from repro_torch.core.lorder import lorder
    from repro_torch.engine.backends import bucket_dims
    t0 = time.perf_counter()
    g = powerlaw_community(1_000_000, avg_degree=14.0, mixing=0.12,
                           seed=SEED)
    t = g.apply_permutation(lorder(g, kappa=4)).transpose
    slots = bucket_dims(g.num_vertices, g.num_edges)[1]
    GRAPH.parent.mkdir(parents=True, exist_ok=True)
    tmp = GRAPH.with_suffix(".tmp.npz")
    np.savez(tmp, indptr=np.asarray(t.indptr, np.int32),
             indices=np.asarray(t.indices, np.int32), slots=slots)
    tmp.replace(GRAPH)
    print(f"graph: V={g.num_vertices} E={g.num_edges} slots={slots} "
          f"made in {time.perf_counter() - t0:.1f} s")


def child(root: pathlib.Path) -> dict:
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.csr_spmv import csr_spmv as spmv
    from repro_torch.kernels.csr_spmv.ref import csr_spmv_ref
    if not torch.cuda.is_available():
        raise SystemExit("spmv_ab: no CUDA device")
    _build.build_all(["csr_spmv"])
    dev = torch.device("cuda")
    data = np.load(GRAPH)
    ip = torch.from_numpy(data["indptr"]).to(dev)
    e, slots = data["indices"].size, int(data["slots"])
    ix = torch.zeros(slots, dtype=torch.int32, device=dev)
    ix[:e] = torch.from_numpy(data["indices"]).to(dev)
    val = torch.zeros(slots, device=dev)
    val[:e] = 1.0
    n = ip.numel() - 1
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.rand(n, generator=gen, device=dev)

    def call():
        return spmv.csr_spmv(ip, ix, val, x)

    got, again = call(), call()
    torch.testing.assert_close(got, csr_spmv_ref(ip, ix, val, x),
                               rtol=1e-5, atol=1e-6)
    if not torch.equal(got, again):
        raise AssertionError("two runs differ")
    host = ab_harness.host_ms(call)
    return {"device_ms": ab_harness.device_ms(call, 100, warmup=0,
                                              behind_sleep=True),
            "host_ms": host}


FLOOR_CU = r"""
__global__ void __launch_bounds__(256)
gather_sum(const int* __restrict__ idx, const float* __restrict__ val,
           const float* __restrict__ x, float* __restrict__ out, int e,
           int mode) {
  const int stride = gridDim.x * blockDim.x;
  int g = blockIdx.x * blockDim.x + threadIdx.x;
  float acc = 0.0f;
  for (; g + 7 * stride < e; g += 8 * stride) {
    int c[8];
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      c[k] = __ldg(idx + g + k * stride);
      v[k] = __ldg(val + g + k * stride);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int i = mode == 2 ? c[k] : (mode == 1 ? (c[k] & 8191) : -1);
      acc += v[k] * (i < 0 ? 1.0f : __ldg(x + i));
    }
  }
  for (; g < e; g += stride) acc += val[g] * x[idx[g]];
  out[blockIdx.x * blockDim.x + threadIdx.x] = acc;
}
extern "C" int gather_floor(const int* idx, const float* val, const float* x,
                            float* out, int e, int blocks, int mode,
                            void* stream) {
  gather_sum<<<blocks, 256, 0, (cudaStream_t)stream>>>(idx, val, x, out, e,
                                                       mode);
  return (int)cudaGetLastError();
}
"""


def gather_stats() -> None:
    """How the served graph's x gathers spread, from the arrays alone:
    distinct 128-byte lines of x in each run of 32 consecutive edges (a
    warp's gather), and the share of gathers into x's first 16,384
    vertices (64 KB, the hubs after LOrder)."""
    import numpy as np
    ix = np.load(GRAPH)["indices"]
    runs = np.sort(ix[:ix.size // 32 * 32].reshape(-1, 32) >> 5, axis=1)
    lines = 1 + (np.diff(runs, axis=1) != 0).sum(axis=1)
    print(f"spmv_ab gathers: {lines.mean():.2f} distinct 128-byte lines of x "
          f"a run of 32 edges; {(ix < 16_384).mean():.4f} of the gathers "
          f"into x[:16384]")


def floor() -> None:
    """The plain gather-and-sum kernel's ms on the served graph."""
    import ctypes
    import numpy as np
    import torch
    src = ROOT / "build" / "spmv_floor.cu"
    lib = src.with_suffix(".so")
    src.write_text(FLOOR_CU)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels._build import nvcc
    subprocess.run([nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib), str(src)],
                   check=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).gather_floor
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    dev = torch.device("cuda")
    data = np.load(GRAPH)
    ix = torch.from_numpy(data["indices"]).to(dev)
    e = ix.numel()
    val = torch.ones(e, device=dev)
    n = data["indptr"].size - 1
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x = torch.rand(n, generator=gen, device=dev)
    blocks = 4 * torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(blocks * 256, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for mode, what in ((0, "stream alone"), (1, "x[idx & 8191], in L1"),
                       (2, "x[idx]")):
        def call():
            if fn(ix.data_ptr(), val.data_ptr(), x.data_ptr(),
                  out.data_ptr(), e, blocks, mode, stream) != 0:
                raise RuntimeError("gather_floor launch failed")
        print(f"spmv_ab floor [{what}]: device_ms "
              f"{ab_harness.device_ms(call, 100):.4f} ({e} edges)")


def main(argv: list[str]) -> int:
    if len(argv) == 3 and argv[1] == "--child":
        return ab_harness.main(argv, __file__, "spmv_ab", child)
    print(f"card: {ab_harness.card_line()}")
    if not GRAPH.exists():
        make_graph()
    if argv[1:] == ["--floor"]:
        gather_stats()
        floor()
        print(ab_harness.card_line())
        return 0
    return ab_harness.compare(__file__, "spmv_ab", argv[1:] or ["."])


if __name__ == "__main__":
    sys.exit(main(sys.argv))
