// Pull-mode CSR SpMV for PageRank's relaxation, hand-written for Hopper.
//
//   y[v] = sum over e in [indptr[v], indptr[v+1]) of val[e] * x[idx[e]]
//
// over the in-CSR of a graph (int32 ids, float32 values). One warp owns one
// destination row at a time and walks the rows in a grid-stride loop. The
// lanes stride over the row's edges (lane l takes edges begin+l, begin+l+32,
// ...), so the index and value reads of a warp are coalesced; each lane sums
// in float32 and a fixed __shfl_down_sync tree folds the 32 partial sums.
// The summation order of a row is therefore fixed: no atomics, and the same
// bits from run to run. A row with no edges writes 0.
//
// Bound: bytes. Per call the kernel streams indptr, idx and val once
// (8 bytes per edge plus 4 per row) and writes y (4 per row); the x[idx]
// gathers are random, but x is one float per vertex and stays in the 50 MB
// L2 for graphs up to ~12M vertices.
//
// Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;                    // 8 warps, 8 rows per block
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr int kBlocksPerSm = 8;                  // 2048 threads per SM

__global__ void __launch_bounds__(kThreads)
csr_spmv_warp_per_row(const int* __restrict__ indptr,
                      const int* __restrict__ idx,
                      const float* __restrict__ val,
                      const float* __restrict__ x,
                      float* __restrict__ y, int n) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = (blockIdx.x * kThreads + threadIdx.x) / kWarp;
  const int num_warps = gridDim.x * kWarpsPerBlock;
  for (int row = warp; row < n; row += num_warps) {
    const int begin = indptr[row];
    const int end = indptr[row + 1];
    float acc = 0.0f;
    int e = begin + lane;
    // four independent gathers in flight per lane; each lane still adds
    // its edges in edge order, so the row's summation order is fixed
    for (; e + 3 * kWarp < end; e += 4 * kWarp) {
      const int i0 = idx[e];
      const int i1 = idx[e + kWarp];
      const int i2 = idx[e + 2 * kWarp];
      const int i3 = idx[e + 3 * kWarp];
      const float p0 = val[e] * __ldg(x + i0);
      const float p1 = val[e + kWarp] * __ldg(x + i1);
      const float p2 = val[e + 2 * kWarp] * __ldg(x + i2);
      const float p3 = val[e + 3 * kWarp] * __ldg(x + i3);
      acc += p0;
      acc += p1;
      acc += p2;
      acc += p3;
    }
    for (; e < end; e += kWarp) {
      acc += val[e] * __ldg(x + idx[e]);
    }
#pragma unroll
    for (int offset = kWarp / 2; offset > 0; offset >>= 1) {
      acc += __shfl_down_sync(0xffffffffu, acc, offset);
    }
    if (lane == 0) {
      y[row] = acc;
    }
  }
}

int sm_count() {
  static int count = 0;
  if (count == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) {
      count = 1;
    }
  }
  return count;
}

}  // namespace

extern "C" int csr_spmv_f32(const int* indptr, const int* idx,
                            const float* val, const float* x, float* y,
                            int n, void* stream) {
  if (n <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  const long long rows_per_block = kWarpsPerBlock;
  const long long wanted = (static_cast<long long>(n) + rows_per_block - 1) /
                           rows_per_block;
  const long long cap = static_cast<long long>(sm_count()) * kBlocksPerSm;
  const int blocks = static_cast<int>(wanted < cap ? wanted : cap);
  csr_spmv_warp_per_row<<<blocks, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      indptr, idx, val, x, y, n);
  return static_cast<int>(cudaGetLastError());
}
