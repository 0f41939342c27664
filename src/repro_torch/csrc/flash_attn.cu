// Causal / sliding-window flash attention, hand-written for Hopper.
//
//   o[b, i, :] = sum over j <= i (and i - j < window when window > 0) of
//                softmax_j(scale * q[b, i, :] . k[b, j, :]) * v[b, j, :]
//
// on (BH, S, d) tensors, row-major and contiguous. Each thread block owns one
// (bh, query tile); it walks the key tiles from the first one the window
// reaches up to the diagonal, staging each K and V tile in shared memory, and
// keeps the online-softmax state of the TPU kernel's _kernel
// (src/repro/kernels/flash_attn/flash_attn.py:30-45) in float32: the running
// max m, the normaliser l and the unnormalised output acc, rescaled by
// exp(m_old - m_new) at every tile. Masked logits are -1e30, as there. The
// loop order is fixed and nothing is summed with atomics, so two runs give
// the same bits. Any S is taken: rows and keys past S are masked and never
// written. Blocks are issued longest-first (the last query tiles walk the
// most key tiles), so the tail of the grid is short.
//
// Two kernels:
//  * bf16 inputs: tensor-core mma.sync m16n8k16 (bf16 in, float32 out),
//    64 queries by 64 keys per tile, four warps of 16 query rows. QK^T sums
//    exact products in float32. For PV the float32 probabilities are split
//    into p_hi = bf16(p) and p_lo = bf16(p - p_hi) and both products are
//    accumulated, so PV keeps ~16 bits of p: close to the float32 PV of the
//    TPU kernel, which the reference's tests hold this kernel to.
//  * float32 inputs: SIMT float32 FMAs, 32 queries by 32 keys per tile, four
//    threads per query row, each holding a quarter of q and of acc; the four
//    partial dot products are folded with a fixed xor-shuffle butterfly,
//    which leaves the same bits in all four lanes.
//
// Bound: operations at long S (2 * BH * S^2 * d multiply-adds for a causal
// call against 4 * BH * S * d elements moved). This first version uses
// mma.sync without TMA, wgmma or pipelining of the tile loads.
//
// Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes; the C entry points return cudaGetLastError().

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;

__device__ __forceinline__ bool key_visible(int key, int row, int s,
                                            int window) {
  return key <= row && key < s && (window <= 0 || row - key < window);
}

// First key tile that any row of a query tile starting at q0 can see.
__device__ __forceinline__ int first_key_tile(int q0, int window, int tile) {
  if (window <= 0) {
    return 0;
  }
  const int first_key = q0 - window + 1;
  return first_key > 0 ? first_key / tile : 0;
}

// ------------------------------------------------ bf16, tensor cores
constexpr int kTile = 64;          // query rows and keys per tile
constexpr int kMmaThreads = 128;   // four warps, 16 query rows each

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 in one register: `first` (the lower column) in the low half.
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 first,
                                          __nv_bfloat16 second) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(first)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(second)) << 16);
}

__device__ __forceinline__ void split2(float x, float y, uint32_t* hi,
                                       uint32_t* lo) {
  const __nv_bfloat16 xh = __float2bfloat16_rn(x);
  const __nv_bfloat16 yh = __float2bfloat16_rn(y);
  *hi = pack2(xh, yh);
  *lo = pack2(__float2bfloat16_rn(x - __bfloat162float(xh)),
              __float2bfloat16_rn(y - __bfloat162float(yh)));
}

// Rows [r0, r0 + kTile) of an (s, D) bf16 matrix into shared memory with
// row stride D + 8; rows at or past s are zero.
template <int D>
__device__ __forceinline__ void load_tile_bf16(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src, int r0,
    int s) {
  constexpr int kChunks = D / 8;   // 16-byte chunks per row
  constexpr int kLd = D + 8;
  for (int c = threadIdx.x; c < kTile * kChunks; c += kMmaThreads) {
    const int row = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + row < s) {
      val = __ldg(reinterpret_cast<const uint4*>(
          src + static_cast<long long>(r0 + row) * D + col));
    }
    *reinterpret_cast<uint4*>(dst + row * kLd + col) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_bf16_mma(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, int bh_count, int s,
                   float scale, int window, int num_q_tiles) {
  constexpr int kLd = D + 8;   // padded row stride: conflict-free fragments
  constexpr int kK = D / 16;   // k-steps of QK^T
  constexpr int kN = D / 8;    // n-blocks of PV
  __shared__ __align__(16) __nv_bfloat16 ks[kTile * kLd];
  __shared__ __align__(16) __nv_bfloat16 vs[kTile * kLd];

  const int qt = num_q_tiles - 1 - static_cast<int>(blockIdx.x / bh_count);
  const int bh = static_cast<int>(blockIdx.x % bh_count);
  const long long base = static_cast<long long>(bh) * s * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;      // fragment row group
  const int t = lane % 4;      // thread in group
  const int q0 = qt * kTile;
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;

  // q fragments, staged through the K buffer
  load_tile_bf16<D>(ks, q + base, q0, s);
  __syncthreads();
  uint32_t qa[kK][4];
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
    const int r = warp * 16 + g;
    const int c = kk * 16 + t * 2;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(ks + r * kLd + c);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(ks + (r + 8) * kLd + c);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(ks + r * kLd + c + 8);
    qa[kk][3] =
        *reinterpret_cast<const uint32_t*>(ks + (r + 8) * kLd + c + 8);
  }

  float acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  }
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

  const int kt_end = qt;   // the diagonal tile (query and key tiles align)
  for (int kt = first_key_tile(q0, window, kTile); kt <= kt_end; ++kt) {
    __syncthreads();
    load_tile_bf16<D>(ks, k + base, kt * kTile, s);
    load_tile_bf16<D>(vs, v + base, kt * kTile, s);
    __syncthreads();

    float sc[kTile / 8][4];
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb) {
      sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        const __nv_bfloat16* kr = ks + (nb * 8 + g) * kLd + kk * 16 + t * 2;
        mma_bf16(sc[nb], qa[kk], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }

    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt * kTile + nb * 8 + t * 2 + (e & 1);
        const int row = e < 2 ? row0 : row1;
        sc[nb][e] = key_visible(key, row, s, window) ? sc[nb][e] * scale
                                                     : kNegInf;
      }
      mx0 = fmaxf(mx0, fmaxf(sc[nb][0], sc[nb][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[nb][2], sc[nb][3]));
    }
    // a row's 64 logits sit in the four lanes of its group
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0);
    const float mn1 = fmaxf(m1, mx1);
    const float alpha0 = expf(m0 - mn0);
    const float alpha1 = expf(m1 - mn1);
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb) {
      sc[nb][0] = expf(sc[nb][0] - mn0);
      sc[nb][1] = expf(sc[nb][1] - mn0);
      sc[nb][2] = expf(sc[nb][2] - mn1);
      sc[nb][3] = expf(sc[nb][3] - mn1);
      sum0 += sc[nb][0] + sc[nb][1];
      sum1 += sc[nb][2] + sc[nb][3];
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    l0 = l0 * alpha0 + sum0;
    l1 = l1 * alpha1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

#pragma unroll
    for (int kstep = 0; kstep < kTile / 16; ++kstep) {
      uint32_t ph[4], pl[4];
      split2(sc[2 * kstep][0], sc[2 * kstep][1], &ph[0], &pl[0]);
      split2(sc[2 * kstep][2], sc[2 * kstep][3], &ph[1], &pl[1]);
      split2(sc[2 * kstep + 1][0], sc[2 * kstep + 1][1], &ph[2], &pl[2]);
      split2(sc[2 * kstep + 1][2], sc[2 * kstep + 1][3], &ph[3], &pl[3]);
      const __nv_bfloat16* vr = vs + (kstep * 16 + t * 2) * kLd + g;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const __nv_bfloat16* vc = vr + n * 8;
        const uint32_t b0 = pack2(vc[0], vc[kLd]);
        const uint32_t b1 = pack2(vc[8 * kLd], vc[9 * kLd]);
        mma_bf16(acc[n], ph, b0, b1);
        mma_bf16(acc[n], pl, b0, b1);
      }
    }
  }

  const float d0 = fmaxf(l0, 1e-30f);
  const float d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    const int col = n * 8 + t * 2;
    if (row0 < s) {
      *reinterpret_cast<uint32_t*>(o + base +
                                   static_cast<long long>(row0) * D + col) =
          pack2(__float2bfloat16_rn(acc[n][0] / d0),
                __float2bfloat16_rn(acc[n][1] / d0));
    }
    if (row1 < s) {
      *reinterpret_cast<uint32_t*>(o + base +
                                   static_cast<long long>(row1) * D + col) =
          pack2(__float2bfloat16_rn(acc[n][2] / d1),
                __float2bfloat16_rn(acc[n][3] / d1));
    }
  }
}

// ---------------------------------------------------- float32, SIMT
constexpr int kPart = 4;                     // threads per query row
constexpr int kRowsF = 32;                   // query rows per block
constexpr int kKeysF = 32;                   // keys per tile
constexpr int kSimtThreads = kRowsF * kPart;

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <int D>
__global__ void __launch_bounds__(kSimtThreads)
flash_fwd_f32_simt(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   int bh_count, int s, float scale, int window,
                   int num_q_tiles) {
  constexpr int kVec = D / 4;        // float4 per row
  constexpr int kMine = kVec / kPart;  // float4 per thread: chunk i*4+part
  __shared__ float4 ks[kKeysF][kVec];
  __shared__ float4 vs[kKeysF][kVec];

  const int qt = num_q_tiles - 1 - static_cast<int>(blockIdx.x / bh_count);
  const int bh = static_cast<int>(blockIdx.x % bh_count);
  const long long base = static_cast<long long>(bh) * s * D;
  const int part = threadIdx.x % kPart;
  const int q0 = qt * kRowsF;
  const int row = q0 + threadIdx.x / kPart;

  float4 qv[kMine], acc[kMine];
#pragma unroll
  for (int i = 0; i < kMine; ++i) {
    qv[i] = row < s ? __ldg(reinterpret_cast<const float4*>(
                          q + base + static_cast<long long>(row) * D) +
                      i * kPart + part)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf, l = 0.0f;

  const int last_row = (q0 + kRowsF < s ? q0 + kRowsF : s) - 1;
  const int kt_end = last_row / kKeysF;
  for (int kt = first_key_tile(q0, window, kKeysF); kt <= kt_end; ++kt) {
    __syncthreads();
    for (int c = threadIdx.x; c < kKeysF * kVec; c += kSimtThreads) {
      const int key = kt * kKeysF + c / kVec;
      const int col = c % kVec;
      const long long off = base + static_cast<long long>(key) * D;
      const bool in = key < s;
      ks[c / kVec][col] =
          in ? __ldg(reinterpret_cast<const float4*>(k + off) + col)
             : make_float4(0.f, 0.f, 0.f, 0.f);
      vs[c / kVec][col] =
          in ? __ldg(reinterpret_cast<const float4*>(v + off) + col)
             : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncthreads();

    float p[kKeysF];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kKeysF; ++j) {
      float dot = 0.0f;
#pragma unroll
      for (int i = 0; i < kMine; ++i) {
        dot = dot4(qv[i], ks[j][i * kPart + part], dot);
      }
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int key = kt * kKeysF + j;
      p[j] = key_visible(key, row, s, window) ? dot * scale : kNegInf;
      mx = fmaxf(mx, p[j]);
    }
    const float mn = fmaxf(m, mx);
    const float alpha = expf(m - mn);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < kKeysF; ++j) {
      p[j] = expf(p[j] - mn);
      sum += p[j];
    }
    l = l * alpha + sum;
    m = mn;
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      acc[i].x *= alpha;
      acc[i].y *= alpha;
      acc[i].z *= alpha;
      acc[i].w *= alpha;
    }
#pragma unroll
    for (int j = 0; j < kKeysF; ++j) {
#pragma unroll
      for (int i = 0; i < kMine; ++i) {
        const float4 vv = vs[j][i * kPart + part];
        acc[i].x = fmaf(p[j], vv.x, acc[i].x);
        acc[i].y = fmaf(p[j], vv.y, acc[i].y);
        acc[i].z = fmaf(p[j], vv.z, acc[i].z);
        acc[i].w = fmaf(p[j], vv.w, acc[i].w);
      }
    }
  }

  if (row < s) {
    const float den = fmaxf(l, 1e-30f);
    float4* dst =
        reinterpret_cast<float4*>(o + base + static_cast<long long>(row) * D);
#pragma unroll
    for (int i = 0; i < kMine; ++i) {
      dst[i * kPart + part] = make_float4(acc[i].x / den, acc[i].y / den,
                                          acc[i].z / den, acc[i].w / den);
    }
  }
}

template <int D>
void launch_bf16(const void* q, const void* k, const void* v, void* o,
                 int bh, int s, float scale, int window, cudaStream_t st) {
  const int tiles = (s + kTile - 1) / kTile;
  flash_fwd_bf16_mma<D><<<tiles * bh, kMmaThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      bh, s, scale, window, tiles);
}

template <int D>
void launch_f32(const void* q, const void* k, const void* v, void* o, int bh,
                int s, float scale, int window, cudaStream_t st) {
  const int tiles = (s + kRowsF - 1) / kRowsF;
  flash_fwd_f32_simt<D><<<tiles * bh, kSimtThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), bh, s, scale,
      window, tiles);
}

}  // namespace

// q, k, v, o: (bh, s, d) contiguous, 16-byte aligned; d in {16, 32, 64, 128};
// bh * ceil(s / 32) < 2^31. The wrapper checks all of it.
extern "C" int flash_attn_bf16(const void* q, const void* k, const void* v,
                               void* o, int bh, int s, int d, float scale,
                               int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: launch_bf16<16>(q, k, v, o, bh, s, scale, window, st); break;
    case 32: launch_bf16<32>(q, k, v, o, bh, s, scale, window, st); break;
    case 64: launch_bf16<64>(q, k, v, o, bh, s, scale, window, st); break;
    case 128: launch_bf16<128>(q, k, v, o, bh, s, scale, window, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int flash_attn_f32(const void* q, const void* k, const void* v,
                              void* o, int bh, int s, int d, float scale,
                              int window, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: launch_f32<16>(q, k, v, o, bh, s, scale, window, st); break;
    case 32: launch_f32<32>(q, k, v, o, bh, s, scale, window, st); break;
    case 64: launch_f32<64>(q, k, v, o, bh, s, scale, window, st); break;
    case 128: launch_f32<128>(q, k, v, o, bh, s, scale, window, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
