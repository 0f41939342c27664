// Grouped matmul over expert-sorted rows, hand-written for Hopper.
//
//   out[i, :] = x[i, :] @ w[e]   for offs[e] <= i < offs[e + 1]
//   out[i, :] = 0                for offs[E] <= i < M
//
// x is (M, K), w is (E, K, N), out is (M, N), all row-major and contiguous;
// offs is (E + 1,) int32 on the device, offs[0] = 0, nondecreasing (values
// past M are clipped to M). K and N are multiples of 8.
//
// Replaces gmm_pallas (src/repro/kernels/moe_gmm/moe_gmm.py). The TPU kernel
// needs every group padded to 128-row tiles on the host and a per-tile expert
// map in scalar-prefetch memory; its grid runs the K steps in order and
// accumulates in the output tile. Here nothing is padded: blockIdx.x counts
// row tiles over all groups in order, and each block walks the offsets
// itself to find its expert and its row range [r0, r1) inside one group. A
// group of n rows takes ceil(n / BM) tiles, so at most ceil(M / BM) + E + 1
// tiles exist; the launch sizes the grid for that and surplus blocks exit.
// The tiles past the last group write zeros. blockIdx.y is the 128-column
// tile. K is a loop inside the block, so each output element is summed in a
// fixed order, without atomics: two runs give the same bits.
//
// Two kernels:
//  * bf16 operands: tensor-core mma.sync m16n8k16 (bf16 in, float32 sums),
//    a 128 x 128 output tile per block of eight warps (each 64 x 32), K in
//    slices of 32 double-buffered in shared memory with cp.async (zero-fill
//    for rows outside the tile's group and for K and N past the edge),
//    fragments read with ldmatrix (.trans for w, which is K-major). The
//    result is written once, as float32 or rounded to bf16.
//  * float32 operands: SIMT float32 FMAs, a 64 x 64 tile per block of 256
//    threads, each 4 x 4 outputs, K in slices of 16 summed in order.
//
// Bound: operations at prefill (2 * rows * K * N multiply-adds, far above
// the card's ridge point at 196,608 rows), bytes at decode (a few rows read
// whole experts' weights). This first version uses mma.sync without TMA or
// wgmma.
//
// Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes; the C entry points return cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// Row tile t of the groups: its expert (-1 for the zero tail) and rows
// [r0, r1). Returns false for a block past the last tile.
__device__ __forceinline__ bool find_tile(const int* __restrict__ offs,
                                          int num_groups, int m, int bm,
                                          int t, int* expert, int* r0,
                                          int* r1) {
  int base = 0;
  int lo = min(max(__ldg(offs), 0), m);
  for (int g = 0; g < num_groups; ++g) {
    const int hi = max(min(__ldg(offs + g + 1), m), lo);
    const int tiles = (hi - lo + bm - 1) / bm;
    if (t < base + tiles) {
      *expert = g;
      *r0 = lo + (t - base) * bm;
      *r1 = min(hi, *r0 + bm);
      return true;
    }
    base += tiles;
    lo = hi;
  }
  const int tiles = (m - lo + bm - 1) / bm;
  if (t < base + tiles) {
    *expert = -1;
    *r0 = lo + (t - base) * bm;
    *r1 = min(m, *r0 + bm);
    return true;
  }
  return false;
}

// ------------------------------------------------ bf16, tensor cores
constexpr int kBm = 128;          // rows per block tile
constexpr int kBn = 128;          // columns per block tile
constexpr int kBk = 32;           // K per shared-memory slice
constexpr int kLdA = kBk + 8;     // padded row strides (bf16 elements):
constexpr int kLdB = kBn + 8;     // ldmatrix rows land in distinct banks
constexpr int kMmaThreads = 256;  // eight warps: 2 (rows) x 4 (columns)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One K slice [k0, k0 + kBk): rows [r0, r1) of x into as (kBm x kLdA) and
// rows k0.. of the expert's (K, N) weight, columns [n0, n0 + kBn), into bs
// (kBk x kLdB). Each of the 256 threads issues two 16-byte copies of each.
__device__ __forceinline__ void load_slice(
    __nv_bfloat16* as, __nv_bfloat16* bs, const __nv_bfloat16* __restrict__ x,
    const __nv_bfloat16* __restrict__ wt, int r0, int r1, int k0, int n0,
    int k, int n) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kMmaThreads;
    const int row = c / (kBk / 8);
    const int col = (c % (kBk / 8)) * 8;
    const bool in = r0 + row < r1 && k0 + col < k;
    const __nv_bfloat16* src =
        in ? x + static_cast<long long>(r0 + row) * k + k0 + col : x;
    cp_async16(as + row * kLdA + col, src, in ? 16 : 0);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int c = threadIdx.x + i * kMmaThreads;
    const int row = c / (kBn / 8);
    const int col = (c % (kBn / 8)) * 8;
    const bool in = k0 + row < k && n0 + col < n;
    const __nv_bfloat16* src =
        in ? wt + static_cast<long long>(k0 + row) * n + n0 + col : wt;
    cp_async16(bs + row * kLdB + col, src, in ? 16 : 0);
  }
}

__device__ __forceinline__ void store2(float* out, float a, float b) {
  *reinterpret_cast<float2*>(out) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* out, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(a, b);
}

template <typename Out>
__device__ void zero_rows(Out* __restrict__ out, int r0, int r1, int n0,
                          int n, int bn, int threads) {
  const int cols = min(bn, n - n0);
  for (int c = threadIdx.x; c < (r1 - r0) * cols; c += threads) {
    out[static_cast<long long>(r0 + c / cols) * n + n0 + c % cols] = Out(0.0f);
  }
}

template <typename Out>
__global__ void __launch_bounds__(kMmaThreads)
gmm_bf16_mma(const __nv_bfloat16* __restrict__ x,
             const __nv_bfloat16* __restrict__ w, const int* __restrict__ offs,
             Out* __restrict__ out, int m, int k, int n, int num_groups) {
  __shared__ __align__(16) __nv_bfloat16 as[2][kBm * kLdA];
  __shared__ __align__(16) __nv_bfloat16 bs[2][kBk * kLdB];

  int expert, r0, r1;
  if (!find_tile(offs, num_groups, m, kBm, blockIdx.x, &expert, &r0, &r1)) {
    return;
  }
  const int n0 = blockIdx.y * kBn;
  if (expert < 0) {
    zero_rows(out, r0, r1, n0, n, kBn, kMmaThreads);
    return;
  }
  const __nv_bfloat16* wt = w + static_cast<long long>(expert) * k * n;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp / 4) * 64;  // the warp's rows in the tile
  const int wn = (warp % 4) * 32;  // the warp's columns in the tile

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.0f;
    }
  }

  const int slices = (k + kBk - 1) / kBk;
  load_slice(as[0], bs[0], x, wt, r0, r1, 0, n0, k, n);
  cp_async_commit();
  for (int s = 0; s < slices; ++s) {
    if (s + 1 < slices) {
      load_slice(as[(s + 1) & 1], bs[(s + 1) & 1], x, wt, r0, r1,
                 (s + 1) * kBk, n0, k, n);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* a_s = as[s & 1];
    const __nv_bfloat16* b_s = bs[s & 1];
#pragma unroll
    for (int kk = 0; kk < kBk; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ldmatrix_x4(a[i], a_s + (wm + i * 16 + lane % 16) * kLdA + kk +
                              (lane / 16) * 8);
      }
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, b_s + (kk + lane % 16) * kLdB + wn + p * 16 +
                                 (lane / 16) * 8);
        b[2 * p][0] = r[0];
        b[2 * p][1] = r[1];
        b[2 * p + 1][0] = r[2];
        b[2 * p + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
        }
      }
    }
    __syncthreads();  // the next iteration's copy reuses this buffer
  }

  const int g = lane / 4;
  const int t = lane % 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row_a = r0 + wm + i * 16 + g;
    const int row_b = row_a + 8;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn + j * 8 + t * 2;
      if (col >= n) {
        continue;
      }
      if (row_a < r1) {
        store2(out + static_cast<long long>(row_a) * n + col, acc[i][j][0],
               acc[i][j][1]);
      }
      if (row_b < r1) {
        store2(out + static_cast<long long>(row_b) * n + col, acc[i][j][2],
               acc[i][j][3]);
      }
    }
  }
}

// ---------------------------------------------------- float32, SIMT
constexpr int kFm = 64;            // rows per block tile
constexpr int kFn = 64;            // columns per block tile
constexpr int kFk = 16;            // K per shared-memory slice
constexpr int kSimtThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(kSimtThreads)
gmm_f32_simt(const float* __restrict__ x, const float* __restrict__ w,
             const int* __restrict__ offs, float* __restrict__ out, int m,
             int k, int n, int num_groups) {
  __shared__ float as[kFk][kFm];  // transposed: a k-row of the x tile
  __shared__ float bs[kFk][kFn];

  int expert, r0, r1;
  if (!find_tile(offs, num_groups, m, kFm, blockIdx.x, &expert, &r0, &r1)) {
    return;
  }
  const int n0 = blockIdx.y * kFn;
  if (expert < 0) {
    zero_rows(out, r0, r1, n0, n, kFn, kSimtThreads);
    return;
  }
  const float* wt = w + static_cast<long long>(expert) * k * n;
  const int tx = threadIdx.x % 16;  // columns tx*4 .. tx*4+3
  const int ty = threadIdx.x / 16;  // rows ty*4 .. ty*4+3

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  }

  for (int k0 = 0; k0 < k; k0 += kFk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = threadIdx.x + i * kSimtThreads;
      const int row = c / kFk;
      const int kc = c % kFk;
      as[kc][row] = (r0 + row < r1 && k0 + kc < k)
                        ? __ldg(x + static_cast<long long>(r0 + row) * k +
                                k0 + kc)
                        : 0.0f;
      const int kr = c / kFn;
      const int col = c % kFn;
      bs[kr][col] = (k0 + kr < k && n0 + col < n)
                        ? __ldg(wt + static_cast<long long>(k0 + kr) * n +
                                n0 + col)
                        : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kFk; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = as[kk][ty * 4 + i];
        b[i] = bs[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty * 4 + i;
    if (row >= r1) {
      continue;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx * 4 + j;
      if (col < n) {
        out[static_cast<long long>(row) * n + col] = acc[i][j];
      }
    }
  }
}

dim3 grid_for(int m, int n, int num_groups, int bm, int bn) {
  return dim3((m + bm - 1) / bm + num_groups + 1, (n + bn - 1) / bn);
}

}  // namespace

// x, w: bf16; out: float32 when out_f32, else bf16. Shapes as above; the
// wrapper checks them, and M * N, M * K and E * K * N stay below 2^31.
extern "C" int moe_gmm_bf16(const void* x, const void* w, const int* offs,
                            void* out, int out_f32, int m, int k, int n,
                            int num_groups, void* stream) {
  if (m <= 0 || n <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid = grid_for(m, n, num_groups, kBm, kBn);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  if (out_f32) {
    gmm_bf16_mma<float><<<grid, kMmaThreads, 0, st>>>(
        xb, wb, offs, static_cast<float*>(out), m, k, n, num_groups);
  } else {
    gmm_bf16_mma<__nv_bfloat16><<<grid, kMmaThreads, 0, st>>>(
        xb, wb, offs, static_cast<__nv_bfloat16*>(out), m, k, n, num_groups);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int moe_gmm_f32(const void* x, const void* w, const int* offs,
                           void* out, int m, int k, int n, int num_groups,
                           void* stream) {
  if (m <= 0 || n <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  gmm_f32_simt<<<grid_for(m, n, num_groups, kFm, kFn), kSimtThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), offs,
      static_cast<float*>(out), m, k, n, num_groups);
  return static_cast<int>(cudaGetLastError());
}
