// Flash attention, hand-written for Hopper: causal, sliding-window,
// prefix-LM and bidirectional masks.
//
//   o[b, i, :] = sum over the keys j that row i sees of
//                softmax_j(scale * q[b, i, :] . k[b / g, j, :]) *
//                v[b / g, j, :]
//
// on row-major, contiguous q and o of (BH, S, d) and k and v of (BH / g, S,
// d): grouped-query attention, where the g query heads h = kv * g .. kv * g +
// g - 1 of a batch row share kv head kv (b = batch * H + h, so b / g =
// batch * KV + kv). g = 1 is multi-head attention. Which keys a row sees is
// the port's layers._attn_mask (struct Mask below): a causal row i sees keys
// j <= i, and j < P too when i < P (a prefix of P tokens that attend to each
// other both ways), cut to i - j < window when window > 0; a non-causal row
// sees every key. Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attn/flash_attn.py:59), which is causal only;
// the prefix and non-causal masks have no TPU counterpart.
// Each thread block owns one (bh, query tile); it walks the key tiles from
// the first one the window reaches up to the last one any of its rows sees
// (the diagonal; the prefix's last tile, if later; every tile when
// non-causal), in a fixed order, and keeps the online-softmax state of the
// TPU kernel's _kernel (flash_attn.py:30-45) in float32: the running max m,
// the normaliser l and the unnormalised output acc, rescaled by
// exp(m_old - m_new) at every tile. Masked logits are -1e30, as there.
// Nothing is summed with atomics and no query tile's keys are split across
// blocks, so two runs give the same bits. Any S is taken: rows and keys past
// S are masked and never written. Blocks are issued longest-first (the last
// query tiles walk the most key tiles), so the tail of the grid is short;
// within a query tile consecutive blocks take consecutive bh, so the g heads
// that share a kv head run side by side and read its K and V tiles from L2.
//
// Three kernels, chosen by dtype and head dim (flash_attn.py's `variant`
// names them; nothing falls back from one to another):
//  * "wgmma", bf16 at d 64, 80, 128 and 256 (the served models): the
//    Hopper design below (flash_fwd_bf16_wgmma). d 80 runs in 128-column
//    tiles whose last 48 columns TMA fills with zeros; d 256 in 64-key
//    tiles, with K and V in rings of their own.
//  * "mma_sync", bf16 at d 16 and 32: warp-level mma.sync m16n8k16, 64
//    queries by 64 keys per tile, four warps of 16 query rows.
//  * "simt", float32 at d 16, 32, 64 and 128: float32 FMAs, 32 queries by
//    32 keys per tile, four threads per query row.
//
// Both bf16 kernels sum QK^T as exact products in float32. For PV the
// float32 probabilities are split into p_hi = bf16(p) and
// p_lo = bf16(p - p_hi) and both products are accumulated, so PV keeps ~16
// bits of p: close to the TPU kernel's float32 PV, which the reference's
// tests hold this kernel to. That costs 1.5 times the operations of a bf16
// PV: the bound of a faithful kernel is 6 * d * pairs FLOPs at the card's
// bf16 rate, where pairs is the (row, key) pairs the mask lets through
// (S(S+1)/2 * BH causal, S^2 * BH non-causal).
//
// Bound: operations at long S (4 * d * pairs FLOPs against 4 * BH * S * d
// elements moved).
//
// Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v
// and called through ctypes; the C entry points return cudaGetLastError(),
// or minus the CUresult of cuTensorMapEncodeTiled when it refuses a map.

#include <cstdint>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e30f;

// The keys a query row sees (the port's layers._attn_mask). The wrapper
// passes window 0 and prefix 0 with causal 0, as the mask ignores both
// there.
struct Mask {
  int s;        // rows and keys of the sequence
  int window;   // > 0: a causal row sees only keys with row - key < window
  int prefix;   // causal rows below it see every key below it
  int causal;   // 0: every row sees every key below s

  __device__ __forceinline__ bool visible(int key, int row) const {
    if (key >= s) {
      return false;
    }
    if (!causal) {
      return true;
    }
    return (key <= row || (row < prefix && key < prefix)) &&
           (window <= 0 || row - key < window);
  }

  // First key tile that any row of a query tile starting at q0 can see.
  __device__ __forceinline__ int first_tile(int q0, int tile) const {
    if (window <= 0) {
      return 0;
    }
    const int first_key = q0 - window + 1;
    return first_key > 0 ? first_key / tile : 0;
  }

  // Last key tile that any row of a query tile can see, given the tile
  // holding its last row's own key (`diag`): the prefix's last tile when
  // later, every tile when non-causal.
  __device__ __forceinline__ int last_tile(int diag, int tile) const {
    if (!causal) {
      return (s - 1) / tile;
    }
    const int p = prefix < s ? prefix : s;
    const int prefix_tile = p > 0 ? (p - 1) / tile : 0;
    return diag > prefix_tile ? diag : prefix_tile;
  }

  // The backward's walk the other way round, over the query rows that
  // can see a key tile's keys k0 .. k_last: the first such row (0 when
  // non-causal or when the tile starts inside the prefix, else the
  // diagonal) and the last (the window's far edge, else the last row).
  __device__ __forceinline__ int first_row(int k0) const {
    return (!causal || k0 < prefix) ? 0 : k0;
  }
  __device__ __forceinline__ int last_row(int k_last) const {
    if (causal && window > 0 && k_last + window - 1 < s - 1) {
      return k_last + window - 1;
    }
    return s - 1;
  }
};

// ------------------------------------------ bf16 at d 16 and 32: mma.sync
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

// The m16k16 A fragment of rows r, r + 8 and columns c .. c + 15 of a tile
// with row stride kLd (lane = 4 g + t reads columns c + 2t, + 1, + 8, + 9).
template <int kLd>
__device__ __forceinline__ void a_fragment(uint32_t a[4],
                                           const __nv_bfloat16* tile, int r,
                                           int c) {
  a[0] = *reinterpret_cast<const uint32_t*>(tile + r * kLd + c);
  a[1] = *reinterpret_cast<const uint32_t*>(tile + (r + 8) * kLd + c);
  a[2] = *reinterpret_cast<const uint32_t*>(tile + r * kLd + c + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(tile + (r + 8) * kLd + c + 8);
}

// Shared memory of the mma.sync kernel: the K and V tiles, padded to rows of
// D + 8.
template <int D>
struct MmaTile {
  static constexpr int kLd = D + 8;   // padded row stride: conflict-free
  static constexpr int kSmemBytes = 2 * kTile * kLd * 2;
  static_assert(kSmemBytes <= 48 * 1024, "more than static shared memory");
};

// kLse: also write each row's log-sum-exp of its scaled logits (natural
// log, float32, (BH, S)) for the backward; the inference instantiation
// (kLse false) is the kernel as it was.
template <int D, bool kLse>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_bf16_mma(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int bh_count, int group, Mask mask, float scale,
                   int num_q_tiles) {
  using T = MmaTile<D>;
  constexpr int kLd = T::kLd;
  constexpr int kK = D / 16;   // k-steps of QK^T
  constexpr int kN = D / 8;    // n-blocks of PV
  extern __shared__ __align__(16) uint8_t mma_smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(mma_smem);
  __nv_bfloat16* vs = ks + kTile * kLd;

  const int s = mask.s;
  const int qt = num_q_tiles - 1 - static_cast<int>(blockIdx.x / bh_count);
  const int bh = static_cast<int>(blockIdx.x % bh_count);
  const long long base = static_cast<long long>(bh) * s * D;
  const long long kv_base = static_cast<long long>(bh / group) * s * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;      // fragment row group
  const int t = lane % 4;      // thread in group
  const int q0 = qt * kTile;
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;

  // q fragments, held in registers (staged through the K buffer)
  uint32_t qa[kK][4];
  load_tile_bf16<D>(ks, q + base, q0, s);
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
    a_fragment<kLd>(qa[kk], ks, warp * 16 + g, kk * 16 + t * 2);
  }

  float acc[kN][4];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  }
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.0f, l1 = 0.0f;

  // query and key tiles align: tile qt holds the query tile's own keys
  const int kt_end = mask.last_tile(qt, kTile);
  for (int kt = mask.first_tile(q0, kTile); kt <= kt_end; ++kt) {
    __syncthreads();
    load_tile_bf16<D>(ks, k + kv_base, kt * kTile, s);
    load_tile_bf16<D>(vs, v + kv_base, kt * kTile, s);
    __syncthreads();

    float sc[kTile / 8][4];
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb) {
      sc[nb][0] = sc[nb][1] = sc[nb][2] = sc[nb][3] = 0.0f;
    }
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb) {
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
        sc[nb][e] = mask.visible(key, row) ? sc[nb][e] * scale : kNegInf;
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
  if constexpr (kLse) {   // l0 and l1 are whole in every lane of the quad
    if (t == 0) {
      const long long lb = static_cast<long long>(bh) * s;
      if (row0 < s) lse[lb + row0] = m0 + logf(d0);
      if (row1 < s) lse[lb + row1] = m1 + logf(d1);
    }
  }
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
                   int bh_count, int group, Mask mask, float scale,
                   int num_q_tiles) {
  constexpr int kVec = D / 4;        // float4 per row
  constexpr int kMine = kVec / kPart;  // float4 per thread: chunk i*4+part
  __shared__ float4 ks[kKeysF][kVec];
  __shared__ float4 vs[kKeysF][kVec];

  const int s = mask.s;
  const int qt = num_q_tiles - 1 - static_cast<int>(blockIdx.x / bh_count);
  const int bh = static_cast<int>(blockIdx.x % bh_count);
  const long long base = static_cast<long long>(bh) * s * D;
  const long long kv_base = static_cast<long long>(bh / group) * s * D;
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
  const int kt_end = mask.last_tile(last_row / kKeysF, kKeysF);
  for (int kt = mask.first_tile(q0, kKeysF); kt <= kt_end; ++kt) {
    __syncthreads();
    for (int c = threadIdx.x; c < kKeysF * kVec; c += kSimtThreads) {
      const int key = kt * kKeysF + c / kVec;
      const int col = c % kVec;
      const long long off = kv_base + static_cast<long long>(key) * D;
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
      p[j] = mask.visible(key, row) ? dot * scale : kNegInf;
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

template <int D, bool kLse>
int launch_bf16_as(const void* q, const void* k, const void* v, void* o,
                   float* lse, int bh, int group, Mask mask, float scale,
                   cudaStream_t st) {
  using T = MmaTile<D>;
  const int tiles = (mask.s + kTile - 1) / kTile;
  flash_fwd_bf16_mma<D, kLse><<<tiles * bh, kMmaThreads, T::kSmemBytes,
                                st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, bh, group, mask, scale, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int bh, int group, Mask mask, float scale,
                cudaStream_t st) {
  return lse == nullptr
             ? launch_bf16_as<D, false>(q, k, v, o, nullptr, bh, group, mask,
                                        scale, st)
             : launch_bf16_as<D, true>(q, k, v, o, static_cast<float*>(lse),
                                       bh, group, mask, scale, st);
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int bh,
               int group, Mask mask, float scale, cudaStream_t st) {
  const int tiles = (mask.s + kRowsF - 1) / kRowsF;
  flash_fwd_f32_simt<D><<<tiles * bh, kSimtThreads, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), bh, group, mask,
      scale, tiles);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------- bf16 at d 64, 80, 128 and 256: Hopper design
//
// One block = one producer warpgroup and two consumer warpgroups (384
// threads, one block an SM); 128 query rows a block, 64 per consumer, and
// key tiles of kKeys (Hopper<D>): 128 at d <= 128, 64 at d 256. What bounds
// it is the tensor cores' operations (1.5 times a bf16 PV's, for the
// split), then the softmax's instructions: a tile costs each consumer warp
// hundreds of them, 66 of which are MUFU.EX2 at a quarter of a warp a
// clock, beside 1,536 clocks of products a tile pair at d 64 (at d 256 the
// products are 6,144 clocks a 64-key tile pair, the softmax a quarter of
// d 64's).
//  * Loads: one thread of the producer issues TMA copies
//    (cp.async.bulk.tensor) on 3-D tensor maps over (BH, S, d) for Q and
//    (BH / g, S, d) for K and V, 128-byte swizzled, into a ring of K/V
//    stages; a block's K and V tiles come from kv row bh / g. Tiles past S
//    arrive zero-filled, and so do columns past d: d 80 takes two 64-column
//    panels, the second one 16 columns wide in memory. QK^T stops at column
//    d (5 k-steps at d 80); PV runs over all 128 columns, 1.6 times d 80's
//    work, and only the first d are stored. Each stage has a `full`
//    mbarrier (the copies' bytes land) and an `empty` one (all 256 consumer
//    threads have finished reading it), so the loads of later tiles run
//    while the tensor cores work on this one.
//  * d 256: a 128-key stage would be 128 KB beside Q's 64 KB, so the key
//    tile is 64 (QK^T m64n64k16, 16 k-steps; PV one m64n256k16 a half and
//    a 16-key step, 256 being wgmma's widest N). Two 64-key stages fit
//    (192 KB), three do not. K and V have rings of their own
//    (Hopper::kSplit): K's stage is freed when QK^T is done, V's after PV,
//    a tile later, and the producer loads K(i + 1) then V(i), so each copy
//    has about a tile pair's products to land in, where one ring of two
//    stages would show the loads' latency on every tile. A 128-row query
//    tile's own keys span two key tiles: the walk runs to the tile of its
//    last row's key (or the prefix's last tile), and the first warpgroup
//    multiplies the second of those with every logit masked (p = 0).
//  * Products: wgmma.mma_async. S = Q K^T reads Q and K from shared memory
//    through descriptors (both K-major). O += P_hi V and O += P_lo V take P
//    from registers as the A operand and V from shared memory as an
//    MN-major B operand (the descriptor's transpose bit): no scalar shared
//    loads.
//  * Overlap: each consumer issues QK^T of tile i with PV of tile i - 1, and
//    the two consumers take turns to issue (named barriers), so one's
//    softmax runs while the other's products do.
//  * setmaxnreg moves registers from the producer (24) to the consumers
//    (240): S, O and both halves of P live in registers (at d 256: O 128
//    floats, S 32, P 32, all live while PV(i - 1) and the softmax of tile
//    i overlap).
//  * exp2, with the scale folded into the exponent's FMA off the masked
//    tiles; m and l stay float32.
//
// Shared memory: Q, then kStages K tiles, then kStages V tiles, then the
// mbarriers. A tile is ceil(d/64) panels of its rows (Q: 128; K and V:
// kKeys) x 64 bf16, each row 128 bytes, 16-byte chunk c of row r stored at
// chunk c ^ (r % 8) (TMA's 128-byte swizzle, which the wgmma descriptors
// name as layout B128). Panel p holds columns 64p .. 64p + 63. Every panel
// starts 1024-aligned.
//
// Fragment layouts (warp w of a warpgroup owns rows 16w .. 16w + 15 of the
// warpgroup's 64; lane = 4 g + t):
//  * accumulator of m64nNk16, N/2 floats a thread: for n-block j (columns
//    8j .. 8j + 7), acc[4j + 0, 1] = row g, columns 8j + 2t, + 1;
//    acc[4j + 2, 3] = row g + 8, the same columns. A row's N values sit in
//    the four lanes of its quad (same g), so its max and sum fold with
//    xor-shuffles over lanes 1 and 2, and over nothing else.
//  * A operand from registers (m64k16, four 32-bit registers of two bf16):
//    a0 = row g, k 2t, 2t + 1; a1 = row g + 8, the same k; a2 = row g,
//    k 2t + 8, 2t + 9; a3 = row g + 8, the same k. For the 16 keys
//    16kk .. 16kk + 15 these are S's accumulator entries 8kk + {0,1},
//    8kk + {2,3}, 8kk + {4,5} and 8kk + {6,7}: P is converted in place.
constexpr int kRows = 128;       // query rows a block: two warpgroups of 64
constexpr int kWgThreads = 128;
constexpr int kHopperThreads = 3 * kWgThreads;
constexpr int kConsumers = 2 * kWgThreads;
constexpr int kPanelBytes = 128 * 128;   // 128 rows x 64 bf16
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Hopper {
  static constexpr int kPanels = (D + 63) / 64;
  static constexpr int kWidth = 64 * kPanels;   // columns of a tile: D or 128
  static constexpr int kKeys = D > 128 ? 64 : 128;   // keys a K or V tile
  static constexpr int kKvPanelBytes = kKeys * 128;  // kKeys rows x 64 bf16
  static constexpr int kQBytes = kPanels * kPanelBytes;       // Q: 128 rows
  static constexpr int kTileBytes = kPanels * kKvPanelBytes;  // K or V tile
  // d <= 128: one ring, a stage (K and V) refilled only after the PV that
  // read it, so with two stages the loads' latency shows on every tile (d
  // 128: 10.4 ms with two, 9.2 with three); three still fit beside Q at d
  // 128 (225 KB). d 256: two rings of two (see above).
  static constexpr bool kSplit = D > 128;
  static constexpr int kStages = kSplit ? 2 : 3;
  // full and empty barriers of each ring, then Q's
  static constexpr int kBarrierBytes = 8 * ((kSplit ? 4 : 2) * kStages + 1);
  // + 1024: the dynamic segment is aligned up to 1024 bytes in the kernel
  static constexpr int kSmemBytes =
      kQBytes + 2 * kStages * kTileBytes + 128 + 1024;
  static_assert(kBarrierBytes <= 128, "barriers overflow their slot");
  static_assert(kSmemBytes <= 232448, "more than a block's shared memory");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// One arrival that also announces `bytes` of TMA traffic for this phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` has completed. (A poll count
// that traps, as moe_gmm.cu's has, makes ptxas spill these kernels'
// consumers and serialise their wgmma at every head dim.)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// A (64-column, 128-row) box of a (BH, S, d) tensor map at (c0, c1, c2)
// = (column, row, q or kv row) into shared memory; completion counted on
// `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand:
// start address, leading and stride byte offsets (all >> 4), layout B128.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (1ull << 62);
}

// K-major (Q, K): 8-row groups 1024 bytes apart (SBO); the 16 columns of one
// k-step sit inside a 128-byte row, so LBO is unused (16).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return sw128_desc(addr, 16, 1024);
}

// MN-major (V as K x N = keys x d): 8-key groups 1024 bytes apart (SBO),
// 64-column panels `panel` bytes apart (LBO).
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr,
                                                 uint32_t panel) {
  return sw128_desc(addr, panel, 1024);
}

// Named barriers over the 256 consumer threads: one warpgroup waits at
// `id` while the other only arrives there.
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of registers that an
// in-flight wgmma owns across the fence/commit/wait points.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    asm volatile("" : "+f"(r[i])::"memory");
  }
}

template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      asm volatile("" : "+r"(r[i][j])::"memory");
    }
  }
}

#define ACC8(d, i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),        \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, float32) (+)= A (64 x 16, smem) * B (16 x 128, smem), both
// K-major; `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32),
        ACC8(d, 40), ACC8(d, 48), ACC8(d, 56)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x D, float32) += A (64 x 16, bf16 registers) * B (16 x D, smem,
// MN-major: the transpose bit is set).
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32),
        ACC8(d, 40), ACC8(d, 48), ACC8(d, 56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_pv(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71,"
      " %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87,"
      " %88, %89, %90, %91, %92, %93, %94, %95,"
      " %96, %97, %98, %99, %100, %101, %102, %103,"
      " %104, %105, %106, %107, %108, %109, %110, %111,"
      " %112, %113, %114, %115, %116, %117, %118, %119,"
      " %120, %121, %122, %123, %124, %125, %126, %127},"
      " {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n"
      "}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32),
        ACC8(d, 40), ACC8(d, 48), ACC8(d, 56), ACC8(d, 64), ACC8(d, 72),
        ACC8(d, 80), ACC8(d, 88), ACC8(d, 96), ACC8(d, 104), ACC8(d, 112),
        ACC8(d, 120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 64, float32) (+)= A (64 x 16, smem) * B (16 x 64, smem), both
// K-major; `accumulate` 0 overwrites d. The backward's S, dP and their
// transposes; the forward's S at d 256.
__device__ __forceinline__ void wgmma_ss64(float (&d)[32], uint64_t desc_a,
                                           uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

#undef ACC8

__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// p_hi = bf16(x, y) and p_lo = bf16(x - p_hi.x, y - p_hi.y), packed with x
// (the lower key) in the low half. A bf16 is the top half of a float, so
// p_hi unpacks with one shift and one mask.
__device__ __forceinline__ void split_hi_lo(float x, float y, uint32_t* hi,
                                            uint32_t* lo) {
  const uint32_t h = bf16x2_bits(__floats2bfloat162_rn(x, y));
  *hi = h;
  const float hx = __uint_as_float(h << 16);
  const float hy = __uint_as_float(h & 0xffff0000u);
  *lo = bf16x2_bits(__floats2bfloat162_rn(x - hx, y - hy));
}

// Max (or, for `lowest`, min) of one row's N / 2 values of sc: entries
// 4j + r and 4j + r + 1 for j = 0 .. N / 4 - 1 (r = 0: row g, r = 2: row
// g + 8), over four independent chains so the latencies overlap.
template <bool lowest, int N>
__device__ __forceinline__ float row_extreme(const float (&sc)[N], int r) {
  float e[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    e[c] = lowest ? fminf(sc[4 * c + r], sc[4 * c + r + 1])
                  : fmaxf(sc[4 * c + r], sc[4 * c + r + 1]);
  }
#pragma unroll
  for (int j = 4; j < N / 4; ++j) {
    const float a = sc[4 * j + r], b = sc[4 * j + r + 1];
    e[j % 4] = lowest ? fminf(e[j % 4], fminf(a, b))
                      : fmaxf(e[j % 4], fmaxf(a, b));
  }
  return lowest ? fminf(fminf(e[0], e[1]), fminf(e[2], e[3]))
                : fmaxf(fmaxf(e[0], e[1]), fmaxf(e[2], e[3]));
}

// Sum of one row's N / 2 values of sc (as in row_extreme), four chains.
template <int N>
__device__ __forceinline__ float row_sum(const float (&sc)[N], int r) {
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    a[j % 4] += sc[4 * j + r] + sc[4 * j + r + 1];
  }
  return (a[0] + a[1]) + (a[2] + a[3]);
}

// The max over the four lanes of a quad (one row's logits of a tile).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

// Whether the key tile of kKeys keys from k0 needs masking for the query
// tile of rows q0 .. q0 + kRows - 1: a tile with a key past row q0 under a
// causal mask (the diagonal's tiles, the prefix's tiles past them), a tile
// that the window cuts for some row; and the tile that holds key S - 1
// when S is not a whole number of tiles. A causal call without a prefix
// reaches that last tile only as a diagonal one.
template <int kKeys>
__device__ __forceinline__ bool edge_tile(int k0, int q0, const Mask& mask) {
  return (mask.causal &&
          (k0 + kKeys - 1 > q0 ||
           (mask.window > 0 && q0 + kRows - 1 - k0 >= mask.window))) ||
         k0 + kKeys > mask.s;
}

// The softmax step of one key tile (keys k0 .. k0 + N / 2 - 1) on S's
// accumulators (see the layouts above): move the running max (log2 units)
// of rows row0 and row1 and turn sc into p = exp2(scale_log2 * s - m). On
// the diagonal's tiles, and where the mask cuts the tile, logits are scaled
// and masked first; elsewhere the max is taken on the raw logits (the min,
// for a negative scale) and the scale is folded into the exponent's FMA.
// Returns in alpha0, alpha1 the factors that rescale what was summed
// before; l0, l1 take p's sums.
template <int N>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[N], int k0, bool edge, int row0, int row1, int t,
    const Mask& mask, float scale_log2, float& m0, float& m1, float& l0,
    float& l1, float& alpha0, float& alpha1) {
  float mx0, mx1;
  if (edge) {
#pragma unroll
    for (int j = 0; j < N / 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        const int row = e < 2 ? row0 : row1;
        sc[4 * j + e] =
            mask.visible(key, row) ? sc[4 * j + e] * scale_log2 : kNegInf;
      }
    }
    mx0 = row_extreme<false>(sc, 0);
    mx1 = row_extreme<false>(sc, 2);
  } else if (scale_log2 >= 0.0f) {
    mx0 = row_extreme<false>(sc, 0) * scale_log2;
    mx1 = row_extreme<false>(sc, 2) * scale_log2;
  } else {
    mx0 = row_extreme<true>(sc, 0) * scale_log2;
    mx1 = row_extreme<true>(sc, 2) * scale_log2;
  }
  const float mn0 = fmaxf(m0, quad_max(mx0));
  const float mn1 = fmaxf(m1, quad_max(mx1));
  alpha0 = exp2_approx(m0 - mn0);
  alpha1 = exp2_approx(m1 - mn1);
  m0 = mn0;
  m1 = mn1;
  const float c = edge ? 1.0f : scale_log2;   // edge logits are scaled
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    sc[4 * j] = exp2_approx(fmaf(sc[4 * j], c, -mn0));
    sc[4 * j + 1] = exp2_approx(fmaf(sc[4 * j + 1], c, -mn0));
    sc[4 * j + 2] = exp2_approx(fmaf(sc[4 * j + 2], c, -mn1));
    sc[4 * j + 3] = exp2_approx(fmaf(sc[4 * j + 3], c, -mn1));
  }
  l0 = l0 * alpha0 + row_sum(sc, 0);
  l1 = l1 * alpha1 + row_sum(sc, 2);
}

// P in the A-operand layout, 16 keys a k-step, high and low halves.
template <int N>
__device__ __forceinline__ void split_tile(const float (&sc)[N],
                                           uint32_t (&ph)[N / 8][4],
                                           uint32_t (&pl)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      split_hi_lo(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1], &ph[kk][r],
                  &pl[kk][r]);
    }
  }
}

// S = Q K^T on one K tile: k-step kk reads columns 16kk .. 16kk + 15, in
// panel kk / 4 at byte 32 (kk % 4) of each swizzled row; d / 16 k-steps
// (the zero columns of a padded tile are skipped). Issued, not waited.
template <int D, int N>
__device__ __forceinline__ void issue_qk(float (&sc)[N], uint32_t q_rows,
                                         uint32_t k_tile) {
  constexpr int kKvPanel = Hopper<D>::kKvPanelBytes;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t qd = kmajor_desc(q_rows + (kk / 4) * kPanelBytes +
                                    (kk % 4) * 32);
    const uint64_t kd = kmajor_desc(k_tile + (kk / 4) * kKvPanel +
                                    (kk % 4) * 32);
    if constexpr (N == 64) {
      wgmma_qk(sc, qd, kd, kk > 0);
    } else {
      wgmma_ss64(sc, qd, kd, kk > 0);
    }
  }
}

// O += P_hi V + P_lo V on one V tile of K keys: k-step kk reads keys 16kk
// .. 16kk + 15, rows 16kk .. of every panel. Issued, not waited.
template <int K, int N>
__device__ __forceinline__ void issue_pv(float (&acc)[N],
                                         const uint32_t (&ph)[K / 16][4],
                                         const uint32_t (&pl)[K / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    const uint64_t dv = mnmajor_desc(v_tile + kk * 16 * 128, K * 128);
    wgmma_pv(acc, ph[kk], dv);
    wgmma_pv(acc, pl[kk], dv);
  }
}

// A consumer warpgroup's loop over the key tiles. The softmax of tile i
// runs while the tensor cores still multiply tile i - 1's P by its V: per
// iteration, QK^T of tile i and PV of tile i - 1 are issued as two
// wgmma groups, `wait_group 1` waits for the first only, the softmax
// works on S, `wait_group 0` waits for PV (which owns P's registers and O
// until then), and only then is stage i - 1 released, O rescaled and the
// new P written over the old. The compiler may move that wait up into the
// softmax (it does: the new P reuses the old P's registers), so the
// overlap that counts is the one between the two warpgroups, which take
// turns to issue their products (named barriers 1 and 2). With split
// rings (d 256) K's stage i is released as soon as S is in.
//
// kLse: also write each row's log-sum-exp (natural log, float32, (BH, S))
// for the backward, after the stores of O; the inference instantiation
// (kLse false) is the kernel as it was.
template <int D, bool kLse>
__global__ void __launch_bounds__(kHopperThreads, 1)
flash_fwd_bf16_wgmma(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     int bh_count, int group, Mask mask, float scale_log2,
                     int num_q_tiles) {
  using H = Hopper<D>;
  constexpr int kKeys = H::kKeys;
  constexpr int kAcc = H::kWidth / 2;   // O accumulator floats a thread
  constexpr int kS = kKeys / 2;         // S accumulator floats a thread
  constexpr int kStages = H::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sk = sq + H::kQBytes;
  const uint32_t sv = sk + kStages * H::kTileBytes;
  const uint32_t bars = sv + kStages * H::kTileBytes;
  // K's ring: full[i] at bars + 8i, empty[i] at bars + 8(kStages + i); V's
  // ring the same kStages later when split, else V shares K's barriers
  const uint32_t v_bars = bars + (H::kSplit ? 16 * kStages : 0);
  const uint32_t q_bar = bars + (H::kSplit ? 32 : 16) * kStages;
  auto full = [&](uint32_t ring, int stage) { return ring + 8 * stage; };
  auto empty = [&](uint32_t ring, int stage) {
    return ring + 8 * (kStages + stage);
  };

  const int qt = num_q_tiles - 1 - static_cast<int>(blockIdx.x / bh_count);
  const int bh = static_cast<int>(blockIdx.x % bh_count);
  const int bh_kv = bh / group;
  const int q0 = qt * kRows;
  const int s = mask.s;
  const int kt0 = mask.first_tile(q0, kKeys);
  // up to the key tile of the last row's own key (the prefix's last, or
  // the last of all, if later)
  const int last_row = (q0 + kRows < s ? q0 + kRows : s) - 1;
  const int n_tiles = mask.last_tile(last_row / kKeys, kKeys) - kt0 + 1;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int r = 0; r < (H::kSplit ? 2 : 1); ++r) {
#pragma unroll
      for (int i = 0; i < kStages; ++i) {
        mbar_init(full(bars + 16 * kStages * r, i), 1);
        mbar_init(empty(bars + 16 * kStages * r, i), kConsumers);
      }
    }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWgThreads) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_bar, H::kQBytes);
#pragma unroll
      for (int p = 0; p < H::kPanels; ++p) {
        tma_load(sq + p * kPanelBytes, &tm_q, q_bar, 64 * p, q0, bh);
      }
      // one ring: K(i) and V(i) into stage i; split rings: K(i) then V(i -
      // 1), each into its own ring's stage once the consumers free it
      for (int i = 0; i < n_tiles + H::kSplit; ++i) {
        if (i < n_tiles) {
          const int stage = i % kStages;
          if (i >= kStages) {   // wait for the consumers to free the stage
            mbar_wait(empty(bars, stage), (i / kStages - 1) & 1);
          }
          mbar_expect_tx(full(bars, stage),
                         (H::kSplit ? 1 : 2) * H::kTileBytes);
          const int key0 = (kt0 + i) * kKeys;
#pragma unroll
          for (int p = 0; p < H::kPanels; ++p) {
            const uint32_t off = stage * H::kTileBytes + p * H::kKvPanelBytes;
            tma_load(sk + off, &tm_k, full(bars, stage), 64 * p, key0, bh_kv);
            if constexpr (!H::kSplit) {
              tma_load(sv + off, &tm_v, full(bars, stage), 64 * p, key0,
                       bh_kv);
            }
          }
        }
        if constexpr (H::kSplit) {
          const int j = i - 1;   // V's tile
          if (j >= 0) {
            const int stage = j % kStages;
            if (j >= kStages) {
              mbar_wait(empty(v_bars, stage), (j / kStages - 1) & 1);
            }
            mbar_expect_tx(full(v_bars, stage), H::kTileBytes);
            const int key0 = (kt0 + j) * kKeys;
#pragma unroll
            for (int p = 0; p < H::kPanels; ++p) {
              tma_load(sv + stage * H::kTileBytes + p * H::kKvPanelBytes,
                       &tm_v, full(v_bars, stage), 64 * p, key0, bh_kv);
            }
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = threadIdx.x / kWgThreads - 1;   // rows 64cw .. 64cw + 63
    const int warp = (threadIdx.x % kWgThreads) / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int row0 = q0 + cw * 64 + warp * 16 + g;
    const int row1 = row0 + 8;
    const uint32_t q_rows = sq + cw * 64 * 128;   // this warpgroup's Q rows

    float acc[kAcc];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      acc[i] = 0.0f;
    }
    float m0 = kNegInf, m1 = kNegInf;   // running max, log2 units
    float l0 = 0.0f, l1 = 0.0f;         // this lane's share of the normaliser
    uint32_t ph[kKeys / 16][4], pl[kKeys / 16][4];   // P's two halves

    // The two consumer warpgroups take turns to issue their products:
    // named barrier 1 + cw is this warpgroup's turn, which the other one
    // gives after each issue. While one warpgroup's products run, the
    // other computes its softmax. Warpgroup 0 goes first; warpgroup 1
    // gives no turn after its last issue, which nothing waits for.
    const int issues = n_tiles + 1;   // tile 0's QK^T, n - 1 steps, last PV
    int issued = 0;
    auto take_turn = [&] { named_sync(1 + cw, kConsumers); };
    auto give_turn = [&] {
      if (cw == 0 || ++issued < issues) {
        named_arrive(2 - cw, kConsumers);
      }
    };
    if (cw == 1) {
      named_arrive(1, kConsumers);
    }
    // split rings: V's tile j has landed
    auto wait_v = [&](int j) {
      if constexpr (H::kSplit) {
        mbar_wait(full(v_bars, j % kStages), (j / kStages) & 1);
      }
    };

    mbar_wait(q_bar, 0);
    mbar_wait(bars, 0);
    {   // tile 0: nothing in flight yet
      float sc[kS];
      float alpha0, alpha1;
      hold(sc);
      take_turn();
      wgmma_fence();
      issue_qk<D>(sc, q_rows, sk);
      wgmma_commit();
      give_turn();
      wgmma_wait<0>();
      hold(sc);
      if constexpr (H::kSplit) {
        mbar_arrive(empty(bars, 0));
      }
      const int k0 = kt0 * kKeys;
      softmax_tile(sc, k0, edge_tile<kKeys>(k0, q0, mask), row0, row1, t,
                   mask, scale_log2, m0, m1, l0, l1, alpha0, alpha1);
      split_tile(sc, ph, pl);
    }
    for (int i = 1; i < n_tiles; ++i) {
      const int k0 = (kt0 + i) * kKeys;
      const int stage = i % kStages;
      const int prev = (i - 1) % kStages;
      mbar_wait(full(bars, stage), (i / kStages) & 1);
      wait_v(i - 1);
      float sc[kS];
      hold(sc);
      hold(acc);
      hold(ph);
      hold(pl);
      take_turn();
      wgmma_fence();
      issue_qk<D>(sc, q_rows, sk + stage * H::kTileBytes);
      wgmma_commit();
      issue_pv<kKeys>(acc, ph, pl, sv + prev * H::kTileBytes);
      wgmma_commit();
      give_turn();
      wgmma_wait<1>();   // S is in; PV of tile i - 1 may still run
      hold(sc);
      if constexpr (H::kSplit) {
        mbar_arrive(empty(bars, stage));
      }
      float alpha0, alpha1;
      softmax_tile(sc, k0, edge_tile<kKeys>(k0, q0, mask), row0, row1, t,
                   mask, scale_log2, m0, m1, l0, l1, alpha0, alpha1);
      wgmma_wait<0>();
      hold(acc);
      hold(ph);
      hold(pl);
      mbar_arrive(empty(v_bars, prev));
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= alpha0;
        acc[4 * j + 1] *= alpha0;
        acc[4 * j + 2] *= alpha1;
        acc[4 * j + 3] *= alpha1;
      }
      split_tile(sc, ph, pl);
    }
    // the last tile's PV
    wait_v(n_tiles - 1);
    hold(acc);
    hold(ph);
    hold(pl);
    take_turn();
    wgmma_fence();
    issue_pv<kKeys>(acc, ph, pl,
                    sv + ((n_tiles - 1) % kStages) * H::kTileBytes);
    wgmma_commit();
    give_turn();
    wgmma_wait<0>();
    hold(acc);
    hold(ph);
    hold(pl);

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float d0 = fmaxf(l0, 1e-30f);
    const float d1 = fmaxf(l1, 1e-30f);
    const long long base = static_cast<long long>(bh) * s * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = 8 * j + 2 * t;
      if (row0 < s) {
        *reinterpret_cast<__nv_bfloat162*>(
            o + base + static_cast<long long>(row0) * D + col) =
            __floats2bfloat162_rn(acc[4 * j] / d0, acc[4 * j + 1] / d0);
      }
      if (row1 < s) {
        *reinterpret_cast<__nv_bfloat162*>(
            o + base + static_cast<long long>(row1) * D + col) =
            __floats2bfloat162_rn(acc[4 * j + 2] / d1, acc[4 * j + 3] / d1);
      }
    }
    if constexpr (kLse) {   // m is in log2 units; l is whole in the quad
      if (t == 0) {
        constexpr float kLn2 = 0.6931471805599453f;
        const long long lb = static_cast<long long>(bh) * s;
        if (row0 < s) lse[lb + row0] = (m0 + log2f(d0)) * kLn2;
        if (row1 < s) lse[lb + row1] = (m1 + log2f(d1)) * kLn2;
      }
    }
  }
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, found through the runtime so the
// library needs no -lcuda; null if it cannot be found. Each call also
// makes the current device's primary context current on the calling
// thread: a thread that has run no CUDA work yet (autograd's backward
// worker, when a backward kernel here is its first) has none, and the
// encoder refuses every map there (CUDA_ERROR_INVALID_CONTEXT). Since
// CUDA 12 cudaSetDevice initializes and binds that context; if it fails,
// the encoder's refusal reports it.
EncodeTiled tensor_map_encoder() {
  int dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess) {
    cudaSetDevice(dev);
  }
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// 0, a cudaError_t, or minus a CUresult if a tensor map is refused.
template <int D>
int launch_bf16_wgmma(const void* q, const void* k, const void* v, void* o,
                      void* lse, int bh, int group, Mask mask, float scale,
                      cudaStream_t st) {
  using H = Hopper<D>;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) {
    return -static_cast<int>(CUDA_ERROR_NOT_FOUND);
  }
  const int s = mask.s;
  // q: (bh, s, D); k and v: (bh / group, s, D). A box is 64 columns wide;
  // at D 80 the second panel's box reaches past column D, and TMA fills
  // those columns with zeros.
  const cuuint64_t rows[3] = {static_cast<cuuint64_t>(bh),
                              static_cast<cuuint64_t>(bh / group),
                              static_cast<cuuint64_t>(bh / group)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(D) * 2,
      static_cast<cuuint64_t>(s) * static_cast<cuuint64_t>(D) * 2};
  const cuuint32_t unit[3] = {1, 1, 1};
  const void* ptrs[3] = {q, k, v};
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    // Q's box is a query tile's 128 rows, K's and V's a key tile's
    const cuuint32_t box[3] = {
        64, static_cast<cuuint32_t>(i == 0 ? kRows : H::kKeys), 1};
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                                static_cast<cuuint64_t>(s), rows[i]};
    const CUresult r = encode(
        &maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
        const_cast<void*>(ptrs[i]), dims, strides, box, unit,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) {
      return -static_cast<int>(r);
    }
  }
  auto kernel = lse == nullptr ? flash_fwd_bf16_wgmma<D, false>
                               : flash_fwd_bf16_wgmma<D, true>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, H::kSmemBytes);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int tiles = (s + kRows - 1) / kRows;
  kernel<<<tiles * bh, kHopperThreads, H::kSmemBytes, st>>>(
      maps[0], maps[1], maps[2], static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), bh, group, mask, scale * kLog2e, tiles);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------- backward, bf16 at d 16 and 32: mma.sync
//
// The gradient of the forward above, from its row log-sum-exp (natural
// log, written by the kLse instantiations). With s = scale * q . k,
// p = exp(s - lse), delta_i = sum_d dO[i, d] * O[i, d] and
// dS = p * (dO . v - delta):
//   dV[j] = sum_i p[i, j] dO[i],  dK[j] = scale * sum_i dS[i, j] q[i],
//   dQ[i] = scale * sum_j dS[i, j] k[j],
// summed over the rows i that see key j (the forward's one Mask) and, for
// dK and dV, over the `group` query heads that share a kv head.
//
// It replaces no TPU kernel: the reference trains by XLA's autodiff of its
// plain chunked attention (src/repro/models/layers.py, _sdpa_chunked) and
// its Pallas kernel has no VJP. It is here because the port's forward runs
// the flash kernel, whose outputs carry no autograd graph.
//
// Two kernels, so that nothing is summed with atomics and a result repeats
// bit for bit (d 64, 80, 128 and 256 take the Hopper kernels further below):
//  * flash_bwd_dq_bf16: one block per (query head, 64-row query tile), four
//    warps of 16 rows. Its prologue computes delta for its rows (float32,
//    from the bf16 O and dO) and writes it out for the second kernel; then
//    it walks the key tiles the rows see (the forward's range), recomputes
//    S and P, dP = dO V^T, and accumulates dQ += dS K in registers.
//  * flash_bwd_dkdv_bf16: one block per (kv head, 64-key tile), four warps
//    of 16 keys. It walks the group's query heads and, for each, the
//    32-row query tiles that can see the tile (Mask::first_row, last_row),
//    recomputes S^T = K Q^T and P^T, dP^T = V dO^T, and accumulates
//    dV += P^T dO and dK += dS^T Q in registers: one block owns a kv row's
//    dK and dV, so the sum over the grouped heads needs no second pass.
// Products are mma.sync m16n8k16 on bf16 operands with float32 sums; P and
// dS are rounded to bf16 as operands (FlashAttention's own rounding).
// K, V, Q and dO tiles sit in shared memory with rows padded to D + 8;
// fragments of a transposed operand are gathered two bf16 at a time.
//
// Bound: operations. The five products of the math (S, dP, dV, dK, dQ) are
// 2 * d * pairs FLOPs each, pairs the (row, key) pairs the mask lets
// through; the two-kernel design recomputes S and dP once more (seven in
// all) to avoid atomics. Bytes: q, k, v, O, dO and the three gradients
// once, far below the products at long S.
constexpr int kBwdThreads = 128;   // four warps of 16 rows (dq) or keys
constexpr int kBwdKeys = 64;       // dkdv: keys a block
constexpr int kBwdRows = 32;       // dkdv: query rows an iteration
constexpr int kDqRows = 64;        // dq: query rows a block
constexpr int kDqKeys = 64;        // dq: keys an iteration
constexpr float kLog2eBwd = 1.4426950408889634f;

template <int D>
struct BwdTile {
  static constexpr int kLd = D + 8;
  // K and V tiles, Q and dO tiles, then lse and delta of the rows
  static constexpr int kDkdvBytes =
      (2 * kBwdKeys + 2 * kBwdRows) * kLd * 2 + 2 * kBwdRows * 4;
  // Q and dO tiles (O in the K slot for the prologue), K and V tiles, then
  // lse and delta of the rows
  static constexpr int kDqBytes =
      (2 * kDqRows + 2 * kDqKeys) * kLd * 2 + 2 * kDqRows * 4;
  static_assert(kDkdvBytes <= 232448 && kDqBytes <= 232448,
                "more than a block's shared memory");
};

// Rows [r0, r0 + kN) of an (s, D) bf16 matrix into shared memory with row
// stride D + 8; rows at or past s are zero.
template <int D, int kN>
__device__ __forceinline__ void load_rows_bf16(
    __nv_bfloat16* dst, const __nv_bfloat16* __restrict__ src, int r0,
    int s) {
  constexpr int kChunks = D / 8;
  constexpr int kLd = D + 8;
  for (int c = threadIdx.x; c < kN * kChunks; c += kBwdThreads) {
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

// C[16 x 8 nb] += A[16 x D] B^T where A's rows are rows r .. r + 15 of tile
// `a` and B's are rows 8 nb .. of tile `b` (both row-major, stride kLd,
// sum over their D columns): S = Q K^T, dP = dO V^T and their transposes.
template <int D, int kNb>
__device__ __forceinline__ void mma_abt(float (&c)[kNb][4],
                                        const __nv_bfloat16* a,
                                        const __nv_bfloat16* b, int r, int g,
                                        int t) {
  constexpr int kLd = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    a_fragment<kLd>(af, a, r + g, kk * 16 + t * 2);
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb) {
      const __nv_bfloat16* br = b + (nb * 8 + g) * kLd + kk * 16 + t * 2;
      mma_bf16(c[nb], af, *reinterpret_cast<const uint32_t*>(br),
               *reinterpret_cast<const uint32_t*>(br + 8));
    }
  }
}

// acc[16 x D] += X[16 x 16 ks] B where X is the accumulator-layout tile x
// (16 rows by 8 kNb columns, rounded to bf16 as the A operand) and B's
// rows 0 .. 8 kNb - 1 are rows of tile `b` (row-major, stride kLd): dQ +=
// dS K, dV += P^T dO, dK += dS^T Q.
template <int D, int kNb>
__device__ __forceinline__ void mma_xb(float (&acc)[D / 8][4],
                                       const float (&x)[kNb][4],
                                       const __nv_bfloat16* b, int g,
                                       int t) {
  constexpr int kLd = D + 8;
#pragma unroll
  for (int ks = 0; ks < kNb / 2; ++ks) {
    uint32_t af[4];
    af[0] = pack2(__float2bfloat16_rn(x[2 * ks][0]),
                  __float2bfloat16_rn(x[2 * ks][1]));
    af[1] = pack2(__float2bfloat16_rn(x[2 * ks][2]),
                  __float2bfloat16_rn(x[2 * ks][3]));
    af[2] = pack2(__float2bfloat16_rn(x[2 * ks + 1][0]),
                  __float2bfloat16_rn(x[2 * ks + 1][1]));
    af[3] = pack2(__float2bfloat16_rn(x[2 * ks + 1][2]),
                  __float2bfloat16_rn(x[2 * ks + 1][3]));
    const __nv_bfloat16* br = b + (ks * 16 + t * 2) * kLd + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const __nv_bfloat16* bc = br + n * 8;
      mma_bf16(acc[n], af, pack2(bc[0], bc[kLd]),
               pack2(bc[8 * kLd], bc[9 * kLd]));
    }
  }
}

// Rows row0 and row1 (row0 + 8) of a 16 x D accumulator, times `mul`, as
// bf16 into a row-major (s, D) matrix at `base`.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* __restrict__ dst,
                                           long long base,
                                           const float (&acc)[D / 8][4],
                                           int row0, int s, int t, float mul) {
  const int row1 = row0 + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + t * 2;
    if (row0 < s) {
      *reinterpret_cast<uint32_t*>(dst + base +
                                   static_cast<long long>(row0) * D + col) =
          pack2(__float2bfloat16_rn(acc[n][0] * mul),
                __float2bfloat16_rn(acc[n][1] * mul));
    }
    if (row1 < s) {
      *reinterpret_cast<uint32_t*>(dst + base +
                                   static_cast<long long>(row1) * D + col) =
          pack2(__float2bfloat16_rn(acc[n][2] * mul),
                __float2bfloat16_rn(acc[n][3] * mul));
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_bf16(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  const __nv_bfloat16* __restrict__ o,
                  const __nv_bfloat16* __restrict__ dout,
                  const float* __restrict__ lse, float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dq, int bh_count, int group,
                  Mask mask, float scale, int num_q_tiles) {
  using T = BwdTile<D>;
  constexpr int kLd = T::kLd;
  constexpr int kNb = kDqKeys / 8;
  extern __shared__ __align__(16) uint8_t bwd_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(bwd_smem);
  __nv_bfloat16* dos = qs + kDqRows * kLd;
  __nv_bfloat16* ks = dos + kDqRows * kLd;
  __nv_bfloat16* vs = ks + kDqKeys * kLd;
  float* lse_s = reinterpret_cast<float*>(vs + kDqKeys * kLd);
  float* delta_s = lse_s + kDqRows;

  const int s = mask.s;
  const int qt = num_q_tiles - 1 - static_cast<int>(blockIdx.x / bh_count);
  const int bh = static_cast<int>(blockIdx.x % bh_count);
  const long long base = static_cast<long long>(bh) * s * D;
  const long long kv_base = static_cast<long long>(bh / group) * s * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int q0 = qt * kDqRows;
  const int row0 = q0 + warp * 16 + g;
  const int row1 = row0 + 8;
  const float scale_log2 = scale * kLog2eBwd;

  load_rows_bf16<D, kDqRows>(qs, q + base, q0, s);
  load_rows_bf16<D, kDqRows>(dos, dout + base, q0, s);
  load_rows_bf16<D, kDqRows>(ks, o + base, q0, s);   // O, for delta
  __syncthreads();
  {   // delta of row q0 + tid / 2: two threads, half the columns each
    const int r = threadIdx.x / 2;
    const int c0 = (threadIdx.x % 2) * (D / 2);
    float acc = 0.0f;
#pragma unroll 8
    for (int c = c0; c < c0 + D / 2; ++c) {
      acc = fmaf(__bfloat162float(dos[r * kLd + c]),
                 __bfloat162float(ks[r * kLd + c]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (threadIdx.x % 2 == 0) {
      const bool in = q0 + r < s;
      const long long at = static_cast<long long>(bh) * s + q0 + r;
      delta_s[r] = acc;
      lse_s[r] = in ? lse[at] * kLog2eBwd : 0.0f;
      if (in) {
        delta[at] = acc;
      }
    }
  }
  __syncthreads();
  const float lse0 = lse_s[warp * 16 + g], lse1 = lse_s[warp * 16 + g + 8];
  const float dl0 = delta_s[warp * 16 + g], dl1 = delta_s[warp * 16 + g + 8];

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.0f;
  }
  // query and key tiles align (64 each): tile qt holds the rows' own keys
  const int kt_end = mask.last_tile(qt, kDqKeys);
  for (int kt = mask.first_tile(q0, kDqKeys); kt <= kt_end; ++kt) {
    __syncthreads();
    load_rows_bf16<D, kDqKeys>(ks, k + kv_base, kt * kDqKeys, s);
    load_rows_bf16<D, kDqKeys>(vs, v + kv_base, kt * kDqKeys, s);
    __syncthreads();
    float sc[kNb][4], dp[kNb][4];
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        sc[nb][e] = 0.0f;
        dp[nb][e] = 0.0f;
      }
    }
    mma_abt<D, kNb>(sc, qs, ks, warp * 16, g, t);
    mma_abt<D, kNb>(dp, dos, vs, warp * 16, g, t);
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kt * kDqKeys + nb * 8 + t * 2 + (e & 1);
        const int row = e < 2 ? row0 : row1;
        const float p =
            row < s && mask.visible(key, row)
                ? exp2f(fmaf(sc[nb][e], scale_log2, -(e < 2 ? lse0 : lse1)))
                : 0.0f;
        sc[nb][e] = p * (dp[nb][e] - (e < 2 ? dl0 : dl1));   // dS
      }
    }
    mma_xb<D, kNb>(acc, sc, ks, g, t);
  }
  store_rows<D>(dq, base, acc, row0, s, t, scale);
}

template <int D>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkdv_bf16(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    const __nv_bfloat16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk,
                    __nv_bfloat16* __restrict__ dv, int kv_count, int group,
                    Mask mask, float scale) {
  using T = BwdTile<D>;
  constexpr int kLd = T::kLd;
  constexpr int kNb = kBwdRows / 8;
  extern __shared__ __align__(16) uint8_t bwd_smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(bwd_smem);
  __nv_bfloat16* vs = ks + kBwdKeys * kLd;
  __nv_bfloat16* qs = vs + kBwdKeys * kLd;
  __nv_bfloat16* dos = qs + kBwdRows * kLd;
  float* lse_s = reinterpret_cast<float*>(dos + kBwdRows * kLd);
  float* delta_s = lse_s + kBwdRows;

  const int s = mask.s;
  // key tile 0 first: under a causal mask it has the most rows to walk
  const int kt = static_cast<int>(blockIdx.x / kv_count);
  const int kvh = static_cast<int>(blockIdx.x % kv_count);
  const long long kv_base = static_cast<long long>(kvh) * s * D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int k0 = kt * kBwdKeys;
  const int key0 = k0 + warp * 16 + g;
  const int key1 = key0 + 8;
  const float scale_log2 = scale * kLog2eBwd;

  load_rows_bf16<D, kBwdKeys>(ks, k + kv_base, k0, s);
  load_rows_bf16<D, kBwdKeys>(vs, v + kv_base, k0, s);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dka[n][e] = 0.0f;
      dva[n][e] = 0.0f;
    }
  }
  const int last_key = (k0 + kBwdKeys < s ? k0 + kBwdKeys : s) - 1;
  const int qt0 = mask.first_row(k0) / kBwdRows;
  const int qt1 = mask.last_row(last_key) / kBwdRows;
  for (int h = 0; h < group; ++h) {
    const int bh = kvh * group + h;
    const long long base = static_cast<long long>(bh) * s * D;
    for (int qt = qt0; qt <= qt1; ++qt) {
      const int q0 = qt * kBwdRows;
      __syncthreads();
      load_rows_bf16<D, kBwdRows>(qs, q + base, q0, s);
      load_rows_bf16<D, kBwdRows>(dos, dout + base, q0, s);
      if (threadIdx.x < kBwdRows) {
        const int r = q0 + threadIdx.x;
        const long long at = static_cast<long long>(bh) * s + r;
        lse_s[threadIdx.x] = r < s ? lse[at] * kLog2eBwd : 0.0f;
        delta_s[threadIdx.x] = r < s ? delta[at] : 0.0f;
      }
      __syncthreads();
      float st[kNb][4], dpt[kNb][4];
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[nb][e] = 0.0f;
          dpt[nb][e] = 0.0f;
        }
      }
      mma_abt<D, kNb>(st, ks, qs, warp * 16, g, t);    // S^T = K Q^T
      mma_abt<D, kNb>(dpt, vs, dos, warp * 16, g, t);  // dP^T = V dO^T
#pragma unroll
      for (int nb = 0; nb < kNb; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = nb * 8 + t * 2 + (e & 1);   // row q0 + c
          const int row = q0 + c;
          const int key = e < 2 ? key0 : key1;
          const float p =
              row < s && mask.visible(key, row)
                  ? exp2f(fmaf(st[nb][e], scale_log2, -lse_s[c]))
                  : 0.0f;
          st[nb][e] = p;
          dpt[nb][e] = p * (dpt[nb][e] - delta_s[c]);   // dS^T
        }
      }
      mma_xb<D, kNb>(dva, st, dos, g, t);    // dV += P^T dO
      mma_xb<D, kNb>(dka, dpt, qs, g, t);    // dK += dS^T Q
    }
  }
  store_rows<D>(dk, kv_base, dka, key0, s, t, scale);
  store_rows<D>(dv, kv_base, dva, key0, s, t, 1.0f);
}

template <int D>
int launch_bwd_dq(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const void* lse, void* delta, void* dq,
                  int bh, int group, Mask mask, float scale,
                  cudaStream_t st) {
  using T = BwdTile<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kDqBytes);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int tiles = (mask.s + kDqRows - 1) / kDqRows;
  flash_bwd_dq_bf16<D><<<tiles * bh, kBwdThreads, T::kDqBytes, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(delta),
      static_cast<__nv_bfloat16*>(dq), bh, group, mask, scale, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd_dkdv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int bh, int group, Mask mask,
                    float scale, cudaStream_t st) {
  using T = BwdTile<D>;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::kDkdvBytes);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int tiles = (mask.s + kBwdKeys - 1) / kBwdKeys;
  const int kv = bh / group;
  flash_bwd_dkdv_bf16<D><<<tiles * kv, kBwdThreads, T::kDkdvBytes, st>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), kv,
      group, mask, scale);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------ backward, bf16 at d 64, 80, 128 and 256: Hopper
//
// The same gradient as the mma.sync kernels above, in two kernels built
// like the forward's Hopper design (flash_fwd_bf16_wgmma). Like those, they
// replace no TPU kernel: the reference trains by XLA's autodiff of
// _sdpa_chunked (src/repro/models/layers.py) and its Pallas kernel has no
// VJP; they exist because the port's forward runs the flash kernel, whose
// output carries no autograd graph.
//
//  * flash_bwd_dq_wgmma: one block per (query head, 128-row query tile),
//    the last tiles first (they see the most keys). Its consumers first
//    compute delta = rowsum(dO * O) for their rows from device memory and
//    write it, with lse * log2 e, into `rows` ((2, BH, S_pad) float32,
//    S_pad = S rounded up to 128, zero past S) for the second kernel.
//    Q and dO arrive once; K and V stream through the ring in 64-key
//    steps. Per step: S = Q K^T and dP = dO V^T (wgmma, both operands
//    K-major from shared memory), P = exp2(S scale log2 e - lse log2 e),
//    dS = P (dP - delta), dQ += dS K (dS rounded to bf16 from registers
//    as the A operand, K as an MN-major B operand: the transpose bit).
//  * d 256 (paligemma-3b) has its own specialisations of both kernels,
//    flash_bwd_dq_wgmma<256> and flash_bwd_dkdv_wgmma<256> (after the
//    primary templates): 64-row and 64-key blocks whose two consumer
//    warpgroups split the head dim, trading S and dP through shared memory.
//  * flash_bwd_dkdv_wgmma: one block per (query head, 128-key tile), key
//    tile 0 first (under a causal mask it has the most rows to walk). K
//    and V arrive once; Q, dO and their rows of `rows` stream through the
//    ring in 64-row steps, over the rows that can see the tile
//    (Mask::first_row, last_row). Per step: S^T = K Q^T and dP^T = V dO^T
//    (both K-major), P^T and dS^T as above with lse and delta by column,
//    dV += P^T dO and dK += dS^T Q (P^T and dS^T from registers, dO and
//    Q MN-major). Under grouped-query attention (group > 1) each block
//    writes its float32 dK and dV to `partial` (row-major, a (128, w)
//    matrix each) and counts itself done on the (kv head, key tile)'s
//    counter (atomicAdd after __threadfence); the block that finds the
//    count at group - 1 sums the group's partials in head order 0 ..
//    group - 1, stores dK and dV in bf16 and sets the counter back to 0.
//    The order of the sum is fixed, so a result repeats bit for bit; no
//    float is summed with atomics. At group 1 the block sums its own
//    partial, one head, the same way.
//
// Both: one producer warpgroup (setmaxnreg 24; one thread issues the TMA
// copies, 128-byte swizzled boxes of 64 columns over 3-D maps of (BH, S,
// d) and (BH / g, S, d), tiles past S and columns past d zero-filled) and
// two consumer warpgroups of 64 rows (dq) or keys (dkdv) each (setmaxnreg
// 240), a ring of two stages with `full` and `empty` mbarriers as in the
// forward (three and four were no faster), no __syncthreads in the loop.
// Each consumer issues S and dP as two wgmma groups and computes P while
// dP runs; dkdv then issues dV += P^T dO and computes dS while it runs.
// The two consumers' products and elementwise work interleave on the SM
// without named barriers. P and dS are rounded to bf16 as operands
// (FlashAttention's rounding); every sum is float32. Steps no pair of
// which the mask lets through skip their products; only steps the mask
// cuts test each pair (Mask::visible). d 80 runs in 128-column tiles
// as the forward does: S and dP stop at column 80, the other products run
// over 128 columns of which the last 48 are zero and not stored.
//
// What this does about the mma.sync kernels' limits: every product is a
// wgmma (the only way to the card's bf16 rate); loads are TMA copies that
// run while the tensor cores work, signalled by mbarriers; no operand is
// gathered from shared memory by scalar loads (the transposed operands are
// MN-major descriptors); and the work item is a (query head, key tile), so
// under grouped-query attention the group's heads run on as many SMs in
// parallel (1,024 blocks at qwen2.5-3b's microbatch, not 256 that each
// walk 8 heads in series), their sum order fixed by the counter.
//
// Bound: operations. The five products of the math are 2 * d * pairs FLOPs
// each: at qwen2.5-3b's training microbatch (BH 32 over 4 kv rows, S 4096,
// d 128, causal) 3.4368e11 FLOPs, 0.3475 ms at 989 TFLOP/s; dq recomputes
// S and dP, so seven are issued, 0.4865 ms. At paligemma-3b's (BH 16 over 2
// kv rows, S 4096, d 256, causal with a 256-row prefix) 3.4502e11 FLOPs,
// 0.3489 ms; the kernels multiply every 64 x 64 block that holds a visible
// pair whole, 4.8996e11 FLOPs.
//
// Registers (ptxas, sm_90a, from the build log chip_smoke.py prints): both
// kernels report 168 (the launch's count; the consumers run at 240 after
// setmaxnreg) with no spills and no wgmma serialised, at d 64, 80 and 128.
// At d 128 a dkdv consumer holds dK and dV (128 floats), S^T and dP^T (64)
// and P^T and dS^T as bf16 operands (32): two things keep that under 240.
// The dK/dV epilogue is one path for every group (a second branch that
// used the accumulators made ptxas spill them in the loop and serialise
// every wgmma), and K's and V's shared-memory addresses are made
// opaque at each step, so that their descriptors are rebuilt there rather
// than held in registers across the loop. d 256 does not fit that budget
// with 64 rows or keys a warpgroup over the whole head dim (a 128-row dq
// block spilled 24 bytes; see flash_bwd_dq_wgmma<256>), hence its split of
// the head dim; both of its kernels also report 168 with no spill.
constexpr int kBwKeys = 128;                 // dkdv: keys a block
constexpr int kBwRows = 64;                  // dkdv: query rows a step
constexpr int kBqRows = 128;                 // dq: query rows a block
constexpr int kBqKeys = 64;                  // dq: keys a step
constexpr int kHalfPanel = 64 * 128;         // 64 rows x 64 bf16

template <int D>
struct HopperBwd {
  static constexpr int kPanels = Hopper<D>::kPanels;
  static constexpr int kWidth = Hopper<D>::kWidth;   // columns of a tile
  static constexpr int kBig = Hopper<D>::kQBytes;     // a 128-row tile
  static constexpr int kSmall = kPanels * kHalfPanel;  // a 64-row tile
  static constexpr int kStages = 2;
  static constexpr int kRowBytes = 2 * kBwRows * 4;    // lse and delta
  // d 256 (the kernels' <256> specialisations): 64-row dq blocks and
  // 64-key dk/dv blocks whose two consumer warpgroups each own half of the
  // head dim, exchanging S (or S^T) and dP (dP^T) as float32 through
  // shared memory
  static constexpr bool kSplit = D > 128;
  static constexpr int kDqRows = kSplit ? 64 : kBqRows;  // dq: rows a block
  static constexpr int kKeys = kSplit ? 64 : kBwKeys;    // dkdv: keys a block
  static constexpr int kBlockTile = kSplit ? kSmall : kBig;  // Q, dO; K, V
  static constexpr int kCols = kSplit ? kWidth / 2 : kWidth;   // a consumer's
  static constexpr int kAcc = kCols / 2;        // floats of a 64-row sum
  static constexpr int kXchgBytes = kSplit ? 2 * 64 * 64 * 4 : 0;
  // dkdv: K, V, then kStages x Q, kStages x dO, kStages x (lse, delta);
  // dq: Q, dO, then kStages x K, kStages x V. Then the exchange, then the
  // mbarriers.
  static constexpr int kDkdvSmem = 2 * kBlockTile +
                                   kStages * (2 * kSmall + kRowBytes) +
                                   kXchgBytes + 128 + 1024;
  static constexpr int kDqSmem =
      2 * kBlockTile + kStages * 2 * kSmall + kXchgBytes + 128 + 1024;
  static_assert(8 * (2 * kStages + 1) <= 128, "barriers overflow their slot");
  static_assert(kDkdvSmem <= 232448 && kDqSmem <= 232448,
                "more than a block's shared memory");
};

// %ctaid.x and %tid.x, read anew: volatile, so that the compiler does not
// keep an earlier read (or what was computed from it) in a register.
__device__ __forceinline__ uint32_t ctaid_x() {
  uint32_t x;
  asm volatile("mov.u32 %0, %%ctaid.x;\n" : "=r"(x));
  return x;
}

__device__ __forceinline__ uint32_t tid_x() {
  uint32_t x;
  asm volatile("mov.u32 %0, %%tid.x;\n" : "=r"(x));
  return x;
}

// One 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into shared memory, counted on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// Whether the mask lets every pair of rows r0 .. r1 and keys k0 .. k1
// through (no pair needs testing), or none (the products add nothing).
__device__ __forceinline__ bool all_visible(const Mask& m, int r0, int r1,
                                            int k0, int k1) {
  if (r1 >= m.s || k1 >= m.s) {
    return false;
  }
  return !m.causal || (r0 >= k1 && (m.window <= 0 || r1 - k0 < m.window));
}

__device__ __forceinline__ bool none_visible(const Mask& m, int r0, int r1,
                                             int k0, int k1) {
  if (r0 >= m.s || k0 >= m.s) {
    return true;
  }
  if (!m.causal) {
    return false;
  }
  const bool above = k0 > r1 && !(r0 < m.prefix && k0 < m.prefix);
  return above || (m.window > 0 && r0 - k1 >= m.window);
}

// P (or P^T) of one 64 x 64 step, in place on S's accumulator: p =
// exp2(s * scale_log2 - lse2) where the mask lets (row, key) through, else
// 0; with kPack also packed as A operands in `pa` (4 k-steps of 16
// columns; see the forward's fragment layouts). `at(i, row, key, lse2)`
// gives element i's row, key and lse2.
template <bool kPack, typename At>
__device__ __forceinline__ void p_tile(float (&sc)[32], uint32_t (&pa)[4][4],
                                       bool edge, const Mask& mask,
                                       float scale_log2, At at) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // keeps the compiler from hoisting every k-step's loads of lse (16
    // registers in dkdv) above the first one's arithmetic
    asm volatile("" ::: "memory");
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = 8 * kk + e;
      int row, key;
      float lse2;
      at(i, row, key, lse2);
      const bool seen = !edge || (row < mask.s && mask.visible(key, row));
      sc[i] = seen ? exp2_approx(fmaf(sc[i], scale_log2, -lse2)) : 0.0f;
    }
    if constexpr (kPack) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = bf16x2_bits(__floats2bfloat162_rn(
            sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]));
      }
    }
  }
}

// dS (or dS^T) = p * (dp - delta) in place on dP's accumulator, packed as
// A operands in `pd`; `delta_of(i)` gives element i's delta.
template <typename Delta>
__device__ __forceinline__ void ds_tile(const float (&p)[32], float (&dp)[32],
                                        uint32_t (&pd)[4][4],
                                        Delta delta_of) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    asm volatile("" ::: "memory");
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = 8 * kk + e;
      dp[i] = p[i] * (dp[i] - delta_of(i));
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      pd[kk][r] = bf16x2_bits(
          __floats2bfloat162_rn(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]));
    }
  }
}

// Rows `row` and `row + 8` of a 64 x kWidth accumulator, times `mul`, as
// bf16 into columns 0 .. D - 1 of a row-major (s, D) matrix at `dst`.
template <int D, int N>
__device__ __forceinline__ void store_acc(__nv_bfloat16* __restrict__ dst,
                                          const float (&acc)[N], int row,
                                          int s, int t, float mul) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const int col = 8 * j + 2 * t;
    if (col >= D) {
      continue;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row + 8 * h;
      if (r < s) {
        *reinterpret_cast<__nv_bfloat162*>(
            dst + static_cast<long long>(r) * D + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h] * mul,
                                  acc[4 * j + 2 * h + 1] * mul);
      }
    }
  }
}

// Rows `row` and `row + 8` of a 64 x W float32 accumulator into a
// row-major float32 (rows, W) matrix at `dst`, every column.
template <int W, int N>
__device__ __forceinline__ void store_acc_f32(float* __restrict__ dst,
                                              const float (&acc)[N], int row,
                                              int t) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      __stcg(reinterpret_cast<float2*>(dst + (row + 8 * h) * W + 8 * j +
                                       2 * t),
             make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
    }
  }
}

// dK and dV of one key tile from the group's float32 partials: `src`
// holds head 0's (kKeys, W) dK then its dV, head h at + h * head floats;
// each element is summed over the heads in order 0 .. group - 1, and dK
// is scaled, as bf16 into rows k0 .. of (s, D) dk and dv.
template <int D, int W, int kKeys>
__device__ __forceinline__ void sum_heads_store(
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
    const float* src, long long head, int group, int k0, int s, float scale,
    int tid) {
  constexpr int kQuads = kKeys * W / 4;   // float4 of one matrix
  const float4* in = reinterpret_cast<const float4*>(src);
  const long long head4 = head / 4;
#pragma unroll 4
  for (int i = tid; i < 2 * kQuads; i += kConsumers) {
    float4 sum = __ldcg(in + i);
    for (int h = 1; h < group; ++h) {
      const float4 x = __ldcg(in + h * head4 + i);
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    const bool is_v = i >= kQuads;
    const int e = 4 * (i - (is_v ? kQuads : 0));
    const int key = k0 + e / W;
    const int col = e % W;
    if (key < s && col < D) {
      const float mul = is_v ? 1.0f : scale;
      __nv_bfloat162 lo = __floats2bfloat162_rn(sum.x * mul, sum.y * mul);
      __nv_bfloat162 hi = __floats2bfloat162_rn(sum.z * mul, sum.w * mul);
      uint2 packed = make_uint2(bf16x2_bits(lo), bf16x2_bits(hi));
      *reinterpret_cast<uint2*>((is_v ? dv : dk) +
                                static_cast<long long>(key) * D + col) =
          packed;
    }
  }
}

// Sum of eight products of bf16 pairs: x . y over one 16-byte chunk each.
__device__ __forceinline__ float dot8(uint4 x, uint4 y, float acc) {
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
  const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&xs[i]));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&ys[i]));
    acc = fmaf(a.x, b.x, acc);
    acc = fmaf(a.y, b.y, acc);
  }
  return acc;
}

template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_do,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __nv_bfloat16* __restrict__ o,
                   const __nv_bfloat16* __restrict__ dout,
                   const float* __restrict__ lse, float* __restrict__ rows,
                   __nv_bfloat16* __restrict__ dq, int bh_count, int group,
                   Mask mask, float scale, int num_q_tiles) {
  using H = HopperBwd<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sq = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdo = sq + H::kBig;
  const uint32_t sk = sdo + H::kBig;                 // stage i at + i kSmall
  const uint32_t sv = sk + H::kStages * H::kSmall;
  const uint32_t bars = sv + H::kStages * H::kSmall;
  const uint32_t qd_bar = bars + 16 * H::kStages;
  // full[i] at bars + 8i, empty[i] at bars + 8(kStages + i)

  const int s = mask.s;
  const int s_pad = num_q_tiles * kBqRows;
  const int qt = num_q_tiles - 1 - static_cast<int>(blockIdx.x / bh_count);
  const int bh = static_cast<int>(blockIdx.x % bh_count);
  const int q0 = qt * kBqRows;
  const int kt0 = mask.first_tile(q0, kBqKeys);
  const int diag = (q0 + kBqRows < s ? q0 + kBqRows : s) - 1;
  const int n_steps = mask.last_tile(diag / kBqKeys, kBqKeys) - kt0 + 1;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < H::kStages; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + 8 * (H::kStages + i), kConsumers);
    }
    mbar_init(qd_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWgThreads) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const int kvh = bh / group;
      mbar_expect_tx(qd_bar, 2 * H::kBig);
#pragma unroll
      for (int p = 0; p < H::kPanels; ++p) {
        tma_load(sq + p * kPanelBytes, &tm_q, qd_bar, 64 * p, q0, bh);
        tma_load(sdo + p * kPanelBytes, &tm_do, qd_bar, 64 * p, q0, bh);
      }
      for (int i = 0; i < n_steps; ++i) {
        const int stage = i % H::kStages;
        const uint32_t full = bars + 8 * stage;
        if (i >= H::kStages) {
          mbar_wait(bars + 8 * (H::kStages + stage), (i / H::kStages - 1) & 1);
        }
        mbar_expect_tx(full, 2 * H::kSmall);
        const int key0 = (kt0 + i) * kBqKeys;
#pragma unroll
        for (int p = 0; p < H::kPanels; ++p) {
          const uint32_t off = stage * H::kSmall + p * kHalfPanel;
          tma_load(sk + off, &tm_k, full, 64 * p, key0, kvh);
          tma_load(sv + off, &tm_v, full, 64 * p, key0, kvh);
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = threadIdx.x / kWgThreads - 1;   // rows 64cw .. 64cw + 63
    const int warp = (threadIdx.x % kWgThreads) / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int row_lo = q0 + cw * 64;
    const int row0 = row_lo + warp * 16 + g;       // and row0 + 8
    const float scale_log2 = scale * kLog2e;

    // delta and lse * log2 e of rows row0 and row0 + 8, whole in each lane
    // of the quad (lane t sums 16-byte chunks t, t + 4, ...); lane 0
    // writes both into `rows` for the dkdv kernel, zero past S.
    float lse2[2], delta[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      float acc = 0.0f;
      lse2[h] = 0.0f;
      if (r < s) {
        const long long at = static_cast<long long>(bh) * s + r;
        const uint4* a = reinterpret_cast<const uint4*>(dout + at * D);
        const uint4* b = reinterpret_cast<const uint4*>(o + at * D);
        for (int c = t; c < D / 8; c += 4) {
          acc = dot8(__ldg(a + c), __ldg(b + c), acc);
        }
        lse2[h] = lse[at] * kLog2e;
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      delta[h] = acc;
      if (t == 0) {
        const long long at = static_cast<long long>(bh) * s_pad + r;
        rows[at] = lse2[h];
        rows[static_cast<long long>(bh_count) * s_pad + at] = acc;
      }
    }

    float dqa[H::kAcc];
#pragma unroll
    for (int i = 0; i < H::kAcc; ++i) {
      dqa[i] = 0.0f;
    }
    const uint32_t q_rows = sq + cw * 64 * 128;    // this warpgroup's rows
    const uint32_t do_rows = sdo + cw * 64 * 128;
    mbar_wait(qd_bar, 0);
    for (int i = 0; i < n_steps; ++i) {
      const int stage = i % H::kStages;
      const int k0 = (kt0 + i) * kBqKeys;
      mbar_wait(bars + 8 * stage, (i / H::kStages) & 1);
      if (!none_visible(mask, row_lo, row_lo + 63, k0, k0 + kBqKeys - 1)) {
        const uint32_t ks = sk + stage * H::kSmall;
        const uint32_t vs = sv + stage * H::kSmall;
        float sc[32], dp[32];
        uint32_t pd[4][4];
        hold(sc);
        hold(dp);
        hold(dqa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t big = (kk / 4) * kPanelBytes + (kk % 4) * 32;
          const uint32_t small = (kk / 4) * kHalfPanel + (kk % 4) * 32;
          wgmma_ss64(sc, kmajor_desc(q_rows + big), kmajor_desc(ks + small),
                     kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t big = (kk / 4) * kPanelBytes + (kk % 4) * 32;
          const uint32_t small = (kk / 4) * kHalfPanel + (kk % 4) * 32;
          wgmma_ss64(dp, kmajor_desc(do_rows + big), kmajor_desc(vs + small),
                     kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();   // S is in; dP may still run
        hold(sc);
        // element 4j + e: row row0 (+ 8 for e >= 2), key k0 + 8j + 2t + e % 2
        p_tile<false>(sc, pd,   // P stays float32 here: pd is not written
                      !all_visible(mask, row_lo, row_lo + 63, k0,
                                   k0 + kBqKeys - 1),
                      mask, scale_log2,
                      [&](int x, int& row, int& key, float& l) {
                        const int h = (x % 4) / 2;
                        row = row0 + 8 * h;
                        key = k0 + 8 * (x / 4) + 2 * t + (x % 2);
                        l = lse2[h];
                      });
        wgmma_wait<0>();
        hold(dp);
        ds_tile(sc, dp, pd, [&](int x) { return delta[(x % 4) / 2]; });
        hold(pd);
        hold(dqa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBqKeys / 16; ++kk) {
          wgmma_pv(dqa, pd[kk], sw128_desc(ks + kk * 16 * 128, kHalfPanel,
                                           1024));
        }
        wgmma_commit();
        wgmma_wait<0>();
        hold(dqa);
        hold(pd);
      }
      mbar_arrive(bars + 8 * (H::kStages + stage));
    }
    store_acc<D>(dq + static_cast<long long>(bh) * s * D, dqa, row0, s, t,
                 scale);
  }
}

template <int D>
__global__ void __launch_bounds__(kHopperThreads, 1)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const float* __restrict__ rows,
                     float* __restrict__ partial, int* __restrict__ counters,
                     __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, int bh_count, int group,
                     Mask mask, float scale, int num_k_tiles) {
  using H = HopperBwd<D>;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int last_block;
  uint8_t* smem =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t sk = smem_addr(smem);
  const uint32_t sv = sk + H::kBig;
  const uint32_t sq = sv + H::kBig;                  // stage i at + i kSmall
  const uint32_t sdo = sq + H::kStages * H::kSmall;
  const uint32_t srow = sdo + H::kStages * H::kSmall;   // + i kRowBytes
  const uint32_t bars = srow + H::kStages * H::kRowBytes;
  const uint32_t kv_bar = bars + 16 * H::kStages;

  const int s = mask.s;
  const int s_pad = ((s + kBqRows - 1) / kBqRows) * kBqRows;
  const int kt = static_cast<int>(blockIdx.x / bh_count);
  const int bh = static_cast<int>(blockIdx.x % bh_count);
  const int kvh = bh / group;
  const int k0 = kt * kBwKeys;
  const int step0 = mask.first_row(k0) / kBwRows;
  const int k_last = (k0 + kBwKeys < s ? k0 + kBwKeys : s) - 1;
  const int n_steps = mask.last_row(k_last) / kBwRows - step0 + 1;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < H::kStages; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + 8 * (H::kStages + i), kConsumers);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWgThreads) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_bar, 2 * H::kBig);
#pragma unroll
      for (int p = 0; p < H::kPanels; ++p) {
        tma_load(sk + p * kPanelBytes, &tm_k, kv_bar, 64 * p, k0, kvh);
        tma_load(sv + p * kPanelBytes, &tm_v, kv_bar, 64 * p, k0, kvh);
      }
      const float* lse_rows = rows + static_cast<long long>(bh) * s_pad;
      const float* delta_rows =
          rows + static_cast<long long>(bh_count + bh) * s_pad;
      for (int i = 0; i < n_steps; ++i) {
        const int stage = i % H::kStages;
        const uint32_t full = bars + 8 * stage;
        if (i >= H::kStages) {
          mbar_wait(bars + 8 * (H::kStages + stage), (i / H::kStages - 1) & 1);
        }
        mbar_expect_tx(full, 2 * H::kSmall + H::kRowBytes);
        const int q0 = (step0 + i) * kBwRows;
#pragma unroll
        for (int p = 0; p < H::kPanels; ++p) {
          const uint32_t off = stage * H::kSmall + p * kHalfPanel;
          tma_load(sq + off, &tm_q, full, 64 * p, q0, bh);
          tma_load(sdo + off, &tm_do, full, 64 * p, q0, bh);
        }
        const uint32_t r = srow + stage * H::kRowBytes;
        bulk_load(r, lse_rows + q0, kBwRows * 4, full);
        bulk_load(r + kBwRows * 4, delta_rows + q0, kBwRows * 4, full);
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = threadIdx.x / kWgThreads - 1;   // keys 64cw .. 64cw + 63
    const int warp = (threadIdx.x % kWgThreads) / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int key_lo = k0 + cw * 64;
    const int key0 = key_lo + warp * 16 + g;       // and key0 + 8
    const float scale_log2 = scale * kLog2e;

    float dka[H::kAcc], dva[H::kAcc];
#pragma unroll
    for (int i = 0; i < H::kAcc; ++i) {
      dka[i] = 0.0f;
      dva[i] = 0.0f;
    }
    uint32_t k_rows = sk + cw * 64 * 128;    // this warpgroup's keys
    uint32_t v_rows = sv + cw * 64 * 128;
    mbar_wait(kv_bar, 0);
    for (int i = 0; i < n_steps; ++i) {
      const int stage = i % H::kStages;
      const int q0 = (step0 + i) * kBwRows;
      mbar_wait(bars + 8 * stage, (i / H::kStages) & 1);
      // K's and V's descriptors are the same at every step: rebuilt here
      // rather than held in registers across the loop (see the note)
      asm volatile("" : "+r"(k_rows), "+r"(v_rows));
      if (!none_visible(mask, q0, q0 + kBwRows - 1, key_lo, key_lo + 63)) {
        const uint32_t qs = sq + stage * H::kSmall;
        const uint32_t dos = sdo + stage * H::kSmall;
        const float* lse_s = reinterpret_cast<const float*>(
            smem + (srow - sk) + stage * H::kRowBytes);
        const float* delta_s = lse_s + kBwRows;
        float st[32], dpt[32];
        uint32_t pa[4][4], pd[4][4];
        hold(st);
        hold(dpt);
        hold(dka);
        hold(dva);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t big = (kk / 4) * kPanelBytes + (kk % 4) * 32;
          const uint32_t small = (kk / 4) * kHalfPanel + (kk % 4) * 32;
          wgmma_ss64(st, kmajor_desc(k_rows + big), kmajor_desc(qs + small),
                     kk > 0);
        }
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const uint32_t big = (kk / 4) * kPanelBytes + (kk % 4) * 32;
          const uint32_t small = (kk / 4) * kHalfPanel + (kk % 4) * 32;
          wgmma_ss64(dpt, kmajor_desc(v_rows + big),
                     kmajor_desc(dos + small), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<1>();   // S^T is in; dP^T may still run
        hold(st);
        // element 4j + e: key key0 (+ 8 for e >= 2), row q0 + 8j + 2t + e % 2
        p_tile<true>(st, pa,
                     !all_visible(mask, q0, q0 + kBwRows - 1, key_lo,
                                  key_lo + 63),
                     mask, scale_log2,
                     [&](int x, int& row, int& key, float& l) {
                       const int c = 8 * (x / 4) + 2 * t + (x % 2);
                       row = q0 + c;
                       key = key0 + 8 * ((x % 4) / 2);
                       l = lse_s[c];
                     });
        hold(pa);
        hold(dva);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBwRows / 16; ++kk) {   // dV += P^T dO
          wgmma_pv(dva, pa[kk], sw128_desc(dos + kk * 16 * 128, kHalfPanel,
                                           1024));
        }
        wgmma_commit();
        wgmma_wait<1>();   // dP^T is in; dV may still run
        hold(dpt);
        ds_tile(st, dpt, pd, [&](int x) {
          return delta_s[8 * (x / 4) + 2 * t + (x % 2)];
        });
        hold(pd);
        hold(dka);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBwRows / 16; ++kk) {   // dK += dS^T Q
          wgmma_pv(dka, pd[kk], sw128_desc(qs + kk * 16 * 128, kHalfPanel,
                                           1024));
        }
        wgmma_commit();
        wgmma_wait<0>();
        hold(dka);
        hold(dva);
        hold(pa);
        hold(pd);
      }
      mbar_arrive(bars + 8 * (H::kStages + stage));
    }

    // The block's indices again, from the special registers, so that none
    // is held across the loop
    const int item = static_cast<int>(ctaid_x());
    const int kt_e = item / bh_count;
    const int bh_e = item % bh_count;
    const int kvh_e = bh_e / group;
    const int k0_e = kt_e * kBwKeys;
    const int ctid = static_cast<int>(tid_x()) - kWgThreads;
    const int t_e = ctid % 4;
    const int row_e = ctid / 4 % 8 + 16 * (ctid / 32);   // key0 - k0
    // This head's float32 dK and dV, row-major (kBwKeys, kWidth) each,
    // into `partial`; the last of the group's blocks to finish (at group 1
    // the block itself) sums them in head order from memory and stores dK
    // and dV. One path for every group (see the note above).
    constexpr int kPart = kBwKeys * H::kWidth;
    float* mine = partial + (static_cast<long long>(bh_e) * num_k_tiles +
                             kt_e) * 2 * kPart;
    store_acc_f32<H::kWidth>(mine, dka, row_e, t_e);
    store_acc_f32<H::kWidth>(mine + kPart, dva, row_e, t_e);
    __threadfence();
    named_sync(1, kConsumers);
    if (ctid == 0) {
      last_block = 1;
      if (group > 1) {
        int* count =
            counters + static_cast<long long>(kvh_e) * num_k_tiles + kt_e;
        last_block = atomicAdd(count, 1) == group - 1;
        if (last_block) {
          *count = 0;   // ready for the next call
        }
      }
    }
    named_sync(1, kConsumers);
    if (last_block) {
      __threadfence();
      const long long kv_base = static_cast<long long>(kvh_e) * s * D;
      sum_heads_store<D, H::kWidth, kBwKeys>(
          dk + kv_base, dv + kv_base,
          partial + (static_cast<long long>(kvh_e) * group * num_k_tiles +
                     kt_e) * 2 * kPart,
          static_cast<long long>(num_k_tiles) * 2 * kPart, group, k0_e, s,
          scale, ctid);
    }
  }
}

// P^T (or any 64 x 64 step) packed as the A operands of 4 k-steps of 16,
// as p_tile's kPack packs it.
__device__ __forceinline__ void pack_tile(const float (&x)[32],
                                          uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      a[kk][r] = bf16x2_bits(
          __floats2bfloat162_rn(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]));
    }
  }
}

// The d 256 kernels' exchange: this thread's 64 x 64 float32 tile `x`
// (its 32 accumulator entries, float4 j at mine[128 j]) into its
// warpgroup's slot, then the other warpgroup's same thread's into `y`:
// named barrier 2 once both warpgroups have written, 3 once both have
// read (so that the next step's writes wait for this step's reads).
__device__ __forceinline__ void swap_tiles(const float (&x)[32],
                                           float (&y)[32], float4* mine,
                                           const float4* other) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mine[128 * j] =
        make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
  }
  named_sync(2, kConsumers);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float4 v = other[128 * j];
    y[4 * j] = v.x;
    y[4 * j + 1] = v.y;
    y[4 * j + 2] = v.z;
    y[4 * j + 3] = v.w;
  }
  named_sync(3, kConsumers);
}

// d 256, dk/dv. K and V of 128 keys (64 KB each) beside two stages of 64
// query rows (Q and dO, 32 KB each) are more than a block's shared memory,
// and a warpgroup owning 64 keys would hold dK and dV as 64 x 256 floats
// each, 256 a thread, over setmaxnreg's 240. So a block owns 64 keys (K
// and V, 32 KB each), both consumer warpgroups see them, and each owns half
// of the head dim: dK and dV for columns 128 cw .. 128 cw + 127, 64 + 64
// floats a thread, the d 128 kernel's budget. Per step warpgroup 0
// computes S^T = K Q^T and turns it into P^T, warpgroup 1 dP^T = V dO^T,
// each over the whole head dim (16 k-steps of m64n64k16); they swap the
// two float32 tiles (`swap_tiles`), each forms dS^T = P^T (dP^T - delta)
// itself, the same arithmetic in both, and multiplies its half: dV +=
// P^T dO[:, half] and dK += dS^T Q[:, half] (m64n128k16, dO and Q
// MN-major from the half's panels). Each of the five products is issued
// once. The epilogue is the primary template's: per-head float32 partials
// (64 keys x 256 columns, each warpgroup its half) summed over the group
// in head order by the last block of a key tile.
template <>
__global__ void __launch_bounds__(kHopperThreads, 1)
flash_bwd_dkdv_wgmma<256>(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_do,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const float* __restrict__ rows,
                          float* __restrict__ partial,
                          int* __restrict__ counters,
                          __nv_bfloat16* __restrict__ dk,
                          __nv_bfloat16* __restrict__ dv, int bh_count,
                          int group, Mask mask, float scale,
                          int num_k_tiles) {
  constexpr int D = 256;
  using H = HopperBwd<D>;
  constexpr int kKeys = H::kKeys;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int last_block;
  uint8_t* smem =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t sk = smem_addr(smem);
  const uint32_t sv = sk + H::kBlockTile;
  const uint32_t sq = sv + H::kBlockTile;              // stage i at + i kSmall
  const uint32_t sdo = sq + H::kStages * H::kSmall;
  const uint32_t srow = sdo + H::kStages * H::kSmall;   // + i kRowBytes
  const uint32_t sx = srow + H::kStages * H::kRowBytes;   // the exchange
  const uint32_t bars = sx + H::kXchgBytes;
  const uint32_t kv_bar = bars + 16 * H::kStages;

  const int s = mask.s;
  const int s_pad = ((s + kBqRows - 1) / kBqRows) * kBqRows;
  const int kt = static_cast<int>(blockIdx.x / bh_count);
  const int bh = static_cast<int>(blockIdx.x % bh_count);
  const int kvh = bh / group;
  const int k0 = kt * kKeys;
  const int step0 = mask.first_row(k0) / kBwRows;
  const int k_last = (k0 + kKeys < s ? k0 + kKeys : s) - 1;
  const int n_steps = mask.last_row(k_last) / kBwRows - step0 + 1;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < H::kStages; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + 8 * (H::kStages + i), kConsumers);
    }
    mbar_init(kv_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWgThreads) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_bar, 2 * H::kBlockTile);
#pragma unroll
      for (int p = 0; p < H::kPanels; ++p) {
        tma_load(sk + p * kHalfPanel, &tm_k, kv_bar, 64 * p, k0, kvh);
        tma_load(sv + p * kHalfPanel, &tm_v, kv_bar, 64 * p, k0, kvh);
      }
      const float* lse_rows = rows + static_cast<long long>(bh) * s_pad;
      const float* delta_rows =
          rows + static_cast<long long>(bh_count + bh) * s_pad;
      for (int i = 0; i < n_steps; ++i) {
        const int stage = i % H::kStages;
        const uint32_t full = bars + 8 * stage;
        if (i >= H::kStages) {
          mbar_wait(bars + 8 * (H::kStages + stage), (i / H::kStages - 1) & 1);
        }
        mbar_expect_tx(full, 2 * H::kSmall + H::kRowBytes);
        const int q0 = (step0 + i) * kBwRows;
#pragma unroll
        for (int p = 0; p < H::kPanels; ++p) {
          const uint32_t off = stage * H::kSmall + p * kHalfPanel;
          tma_load(sq + off, &tm_q, full, 64 * p, q0, bh);
          tma_load(sdo + off, &tm_do, full, 64 * p, q0, bh);
        }
        const uint32_t r = srow + stage * H::kRowBytes;
        bulk_load(r, lse_rows + q0, kBwRows * 4, full);
        bulk_load(r + kBwRows * 4, delta_rows + q0, kBwRows * 4, full);
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = threadIdx.x / kWgThreads - 1;   // columns 128cw ..
    const int wt = threadIdx.x % kWgThreads;
    const int warp = wt / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int key0 = k0 + warp * 16 + g;           // and key0 + 8
    const float scale_log2 = scale * kLog2e;
    // this thread's float4 j of the exchange at + 128 j: its own tile's,
    // and the other warpgroup's same thread's
    float4* mine_x = reinterpret_cast<float4*>(smem + (sx - sk)) +
                     cw * 1024 + wt;
    const float4* other_x = reinterpret_cast<const float4*>(
                                smem + (sx - sk)) + (1 - cw) * 1024 + wt;
    const uint32_t half = 2 * cw * kHalfPanel;     // this half's panels

    float dka[H::kAcc], dva[H::kAcc];
#pragma unroll
    for (int i = 0; i < H::kAcc; ++i) {
      dka[i] = 0.0f;
      dva[i] = 0.0f;
    }
    mbar_wait(kv_bar, 0);
    for (int i = 0; i < n_steps; ++i) {
      const int stage = i % H::kStages;
      const int q0 = (step0 + i) * kBwRows;
      mbar_wait(bars + 8 * stage, (i / H::kStages) & 1);
      if (!none_visible(mask, q0, q0 + kBwRows - 1, k0, k0 + kKeys - 1)) {
        const uint32_t qs = sq + stage * H::kSmall;
        const uint32_t dos = sdo + stage * H::kSmall;
        const float* lse_s = reinterpret_cast<const float*>(
            smem + (srow - sk) + stage * H::kRowBytes);
        const float* delta_s = lse_s + kBwRows;
        // element 4j + e: key key0 (+ 8 for e >= 2), row q0 + 8j + 2t + e % 2
        float p[32], dp[32];
        uint32_t pa[4][4], pd[4][4];
        if (cw == 0) {   // S^T = K Q^T, then P^T
          hold(p);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t at = (kk / 4) * kHalfPanel + (kk % 4) * 32;
            wgmma_ss64(p, kmajor_desc(sk + at), kmajor_desc(qs + at), kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          hold(p);
          p_tile<false>(p, pa,   // pa is packed below
                        !all_visible(mask, q0, q0 + kBwRows - 1, k0,
                                     k0 + kKeys - 1),
                        mask, scale_log2,
                        [&](int x, int& row, int& key, float& l) {
                          const int c = 8 * (x / 4) + 2 * t + (x % 2);
                          row = q0 + c;
                          key = key0 + 8 * ((x % 4) / 2);
                          l = lse_s[c];
                        });
          swap_tiles(p, dp, mine_x, other_x);
        } else {         // dP^T = V dO^T
          hold(dp);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t at = (kk / 4) * kHalfPanel + (kk % 4) * 32;
            wgmma_ss64(dp, kmajor_desc(sv + at), kmajor_desc(dos + at),
                       kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          hold(dp);
          swap_tiles(dp, p, mine_x, other_x);
        }
        pack_tile(p, pa);
        hold(pa);
        hold(dva);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBwRows / 16; ++kk) {   // dV += P^T dO
          wgmma_pv(dva, pa[kk], sw128_desc(dos + half + kk * 16 * 128,
                                           kHalfPanel, 1024));
        }
        wgmma_commit();
        ds_tile(p, dp, pd, [&](int x) {
          return delta_s[8 * (x / 4) + 2 * t + (x % 2)];
        });
        hold(pd);
        hold(dka);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBwRows / 16; ++kk) {   // dK += dS^T Q
          wgmma_pv(dka, pd[kk], sw128_desc(qs + half + kk * 16 * 128,
                                           kHalfPanel, 1024));
        }
        wgmma_commit();
        wgmma_wait<0>();
        hold(dka);
        hold(dva);
        hold(pa);
        hold(pd);
      }
      mbar_arrive(bars + 8 * (H::kStages + stage));
    }

    // The block's indices again, from the special registers, so that none
    // is held across the loop
    const int item = static_cast<int>(ctaid_x());
    const int kt_e = item / bh_count;
    const int bh_e = item % bh_count;
    const int kvh_e = bh_e / group;
    const int k0_e = kt_e * kKeys;
    const int ctid = static_cast<int>(tid_x()) - kWgThreads;
    const int t_e = ctid % 4;
    const int row_e = ctid / 4 % 8 + 16 * (ctid % kWgThreads / 32);
    constexpr int kPart = kKeys * H::kWidth;
    float* mine = partial + (static_cast<long long>(bh_e) * num_k_tiles +
                             kt_e) * 2 * kPart + 128 * (ctid / kWgThreads);
    store_acc_f32<H::kWidth>(mine, dka, row_e, t_e);
    store_acc_f32<H::kWidth>(mine + kPart, dva, row_e, t_e);
    __threadfence();
    named_sync(1, kConsumers);
    if (ctid == 0) {
      last_block = 1;
      if (group > 1) {
        int* count =
            counters + static_cast<long long>(kvh_e) * num_k_tiles + kt_e;
        last_block = atomicAdd(count, 1) == group - 1;
        if (last_block) {
          *count = 0;   // ready for the next call
        }
      }
    }
    named_sync(1, kConsumers);
    if (last_block) {
      __threadfence();
      const long long kv_base = static_cast<long long>(kvh_e) * s * D;
      sum_heads_store<D, H::kWidth, kKeys>(
          dk + kv_base, dv + kv_base,
          partial + (static_cast<long long>(kvh_e) * group * num_k_tiles +
                     kt_e) * 2 * kPart,
          static_cast<long long>(num_k_tiles) * 2 * kPart, group, k0_e, s,
          scale, ctid);
    }
  }
}

// d 256, dq. A 128-row block's dQ is 64 x 256 floats a consumer
// warpgroup, 128 a thread, and beside it S, dP and dS as an operand came to
// a few registers over setmaxnreg's 240 (ptxas spilled 12 to 44 bytes in
// every arrangement tried). So a dq block owns 64 query rows (Q and dO, 32
// KB each, beside two stages of a 64-key K and V tile), and both consumer
// warpgroups see them, each owning half of dQ's columns: 64 floats a
// thread. Per 64-key step warpgroup 0 computes S = Q K^T and turns it into
// P, warpgroup 1 computes dP = dO V^T, they swap the two float32 tiles
// (`swap_tiles`) as the dk/dv kernel above does, and each forms dS and
// multiplies its half: dQ[:, half] += dS K[:, half]. The sum over the key
// steps keeps the primary template's order.
template <>
__global__ void __launch_bounds__(kHopperThreads, 1)
flash_bwd_dq_wgmma<256>(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __nv_bfloat16* __restrict__ o,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        float* __restrict__ rows,
                        __nv_bfloat16* __restrict__ dq, int bh_count,
                        int group, Mask mask, float scale, int num_q_tiles) {
  constexpr int D = 256;
  using H = HopperBwd<D>;
  constexpr int kQRows = H::kDqRows;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem =
      smem_raw + ((1024u - (smem_addr(smem_raw) & 1023u)) & 1023u);
  const uint32_t sq = smem_addr(smem);
  const uint32_t sdo = sq + H::kBlockTile;
  const uint32_t sk = sdo + H::kBlockTile;           // stage i at + i kSmall
  const uint32_t sv = sk + H::kStages * H::kSmall;
  const uint32_t sx = sv + H::kStages * H::kSmall;   // the exchange
  const uint32_t bars = sx + H::kXchgBytes;
  const uint32_t qd_bar = bars + 16 * H::kStages;

  const int s = mask.s;
  const int s_pad = ((s + kBqRows - 1) / kBqRows) * kBqRows;   // as dkdv's
  const int qt = num_q_tiles - 1 - static_cast<int>(blockIdx.x / bh_count);
  const int bh = static_cast<int>(blockIdx.x % bh_count);
  const int q0 = qt * kQRows;
  const int kt0 = mask.first_tile(q0, kBqKeys);
  const int last = (q0 + kQRows < s ? q0 + kQRows : s) - 1;
  const int n_steps = mask.last_tile(last / kBqKeys, kBqKeys) - kt0 + 1;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < H::kStages; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + 8 * (H::kStages + i), kConsumers);
    }
    mbar_init(qd_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWgThreads) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const int kvh = bh / group;
      mbar_expect_tx(qd_bar, 2 * H::kBlockTile);
#pragma unroll
      for (int p = 0; p < H::kPanels; ++p) {
        tma_load(sq + p * kHalfPanel, &tm_q, qd_bar, 64 * p, q0, bh);
        tma_load(sdo + p * kHalfPanel, &tm_do, qd_bar, 64 * p, q0, bh);
      }
      for (int i = 0; i < n_steps; ++i) {
        const int stage = i % H::kStages;
        const uint32_t full = bars + 8 * stage;
        if (i >= H::kStages) {
          mbar_wait(bars + 8 * (H::kStages + stage), (i / H::kStages - 1) & 1);
        }
        mbar_expect_tx(full, 2 * H::kSmall);
        const int key0 = (kt0 + i) * kBqKeys;
#pragma unroll
        for (int p = 0; p < H::kPanels; ++p) {
          const uint32_t off = stage * H::kSmall + p * kHalfPanel;
          tma_load(sk + off, &tm_k, full, 64 * p, key0, kvh);
          tma_load(sv + off, &tm_v, full, 64 * p, key0, kvh);
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = threadIdx.x / kWgThreads - 1;   // columns 128cw ..
    const int wt = threadIdx.x % kWgThreads;
    const int warp = wt / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int row0 = q0 + warp * 16 + g;           // and row0 + 8
    const float scale_log2 = scale * kLog2e;

    // delta and lse * log2 e of rows row0 and row0 + 8, as the primary
    // template computes them, in both warpgroups; warpgroup 0 writes them
    // into `rows` for the dkdv kernel, zero past S.
    float lse2[2], delta[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 8 * h;
      float acc = 0.0f;
      lse2[h] = 0.0f;
      if (r < s) {
        const long long at = static_cast<long long>(bh) * s + r;
        const uint4* a = reinterpret_cast<const uint4*>(dout + at * D);
        const uint4* b = reinterpret_cast<const uint4*>(o + at * D);
        for (int c = t; c < D / 8; c += 4) {
          acc = dot8(__ldg(a + c), __ldg(b + c), acc);
        }
        lse2[h] = lse[at] * kLog2e;
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      delta[h] = acc;
      if (cw == 0 && t == 0) {
        const long long at = static_cast<long long>(bh) * s_pad + r;
        rows[at] = lse2[h];
        rows[static_cast<long long>(bh_count) * s_pad + at] = acc;
      }
    }

    float dqa[H::kAcc];
#pragma unroll
    for (int i = 0; i < H::kAcc; ++i) {
      dqa[i] = 0.0f;
    }
    // this thread's float4 j of the exchange at + 128 j, as in dkdv
    float4* mine_x = reinterpret_cast<float4*>(smem + (sx - sq)) +
                     cw * 1024 + wt;
    const float4* other_x = reinterpret_cast<const float4*>(
                                smem + (sx - sq)) + (1 - cw) * 1024 + wt;
    const uint32_t half = 2 * cw * kHalfPanel;     // this half's panels
    mbar_wait(qd_bar, 0);
    for (int i = 0; i < n_steps; ++i) {
      const int stage = i % H::kStages;
      const int k0 = (kt0 + i) * kBqKeys;
      mbar_wait(bars + 8 * stage, (i / H::kStages) & 1);
      if (!none_visible(mask, q0, q0 + kQRows - 1, k0, k0 + kBqKeys - 1)) {
        const uint32_t ks = sk + stage * H::kSmall;
        const uint32_t vs = sv + stage * H::kSmall;
        // element 4j + e: row row0 (+ 8 for e >= 2), key k0 + 8j + 2t + e % 2
        float p[32], dp[32];
        uint32_t pd[4][4];
        if (cw == 0) {   // S = Q K^T, then P
          hold(p);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t at = (kk / 4) * kHalfPanel + (kk % 4) * 32;
            wgmma_ss64(p, kmajor_desc(sq + at), kmajor_desc(ks + at), kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          hold(p);
          p_tile<false>(p, pd,   // P stays float32 here: pd is not written
                        !all_visible(mask, q0, q0 + kQRows - 1, k0,
                                     k0 + kBqKeys - 1),
                        mask, scale_log2,
                        [&](int x, int& row, int& key, float& l) {
                          const int h = (x % 4) / 2;
                          row = row0 + 8 * h;
                          key = k0 + 8 * (x / 4) + 2 * t + (x % 2);
                          l = lse2[h];
                        });
          swap_tiles(p, dp, mine_x, other_x);
        } else {         // dP = dO V^T
          hold(dp);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t at = (kk / 4) * kHalfPanel + (kk % 4) * 32;
            wgmma_ss64(dp, kmajor_desc(sdo + at), kmajor_desc(vs + at),
                       kk > 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          hold(dp);
          swap_tiles(dp, p, mine_x, other_x);
        }
        ds_tile(p, dp, pd, [&](int x) { return delta[(x % 4) / 2]; });
        hold(pd);
        hold(dqa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBqKeys / 16; ++kk) {   // dQ += dS K
          wgmma_pv(dqa, pd[kk], sw128_desc(ks + half + kk * 16 * 128,
                                           kHalfPanel, 1024));
        }
        wgmma_commit();
        wgmma_wait<0>();
        hold(dqa);
        hold(pd);
      }
      mbar_arrive(bars + 8 * (H::kStages + stage));
    }
    store_acc<D>(dq + static_cast<long long>(bh) * s * D + 128 * cw, dqa,
                 row0, s, t, scale);
  }
}

// A 3-D tensor map over a (n, s, D) bf16 tensor in boxes of 64 columns x
// `box_rows` rows x 1, 128-byte swizzled; columns and rows past the
// tensor's are zero-filled. 0, or the CUresult of a refusal.
int encode_rows(EncodeTiled encode, CUtensorMap* map, const void* ptr, int n,
                int s, int D, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(n)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(D) * 2,
      static_cast<cuuint64_t>(s) * static_cast<cuuint64_t>(D) * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return static_cast<int>(encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// The four maps of a backward kernel: q and dO of (bh, s, D) in boxes of
// `q_rows` rows, k and v of (bh / group, s, D) in boxes of `k_rows`.
// 0, or minus the CUresult of a refusal.
int encode_bwd_maps(CUtensorMap (&maps)[4], const void* q, const void* dout,
                    const void* k, const void* v, int bh, int group, int s,
                    int D, int q_rows, int k_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) {
    return -static_cast<int>(CUDA_ERROR_NOT_FOUND);
  }
  const void* ptrs[4] = {q, dout, k, v};
  for (int i = 0; i < 4; ++i) {
    const int r = encode_rows(encode, &maps[i], ptrs[i],
                              i < 2 ? bh : bh / group, s, D,
                              i < 2 ? q_rows : k_rows);
    if (r != 0) {
      return -r;
    }
  }
  return 0;
}

template <int D>
int launch_bwd_dq_wgmma(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const void* lse,
                        void* rows, void* dq, int bh, int group, Mask mask,
                        float scale, cudaStream_t st) {
  using H = HopperBwd<D>;
  CUtensorMap maps[4];
  const int rc = encode_bwd_maps(maps, q, dout, k, v, bh, group, mask.s, D,
                                 H::kDqRows, kBqKeys);
  if (rc != 0) {
    return rc;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      H::kDqSmem);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int tiles = (mask.s + H::kDqRows - 1) / H::kDqRows;
  flash_bwd_dq_wgmma<D><<<tiles * bh, kHopperThreads, H::kDqSmem, st>>>(
      maps[0], maps[1], maps[2], maps[3],
      static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<float*>(rows),
      static_cast<__nv_bfloat16*>(dq), bh, group, mask, scale, tiles);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_bwd_dkdv_wgmma(const void* q, const void* k, const void* v,
                          const void* dout, const void* rows, void* partial,
                          void* counters, void* dk, void* dv, int bh,
                          int group, Mask mask, float scale,
                          cudaStream_t st) {
  using H = HopperBwd<D>;
  if (partial == nullptr || (group > 1 && counters == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap maps[4];
  const int rc = encode_bwd_maps(maps, q, dout, k, v, bh, group, mask.s, D,
                                 kBwRows, H::kKeys);
  if (rc != 0) {
    return rc;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      H::kDkdvSmem);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int tiles = (mask.s + H::kKeys - 1) / H::kKeys;
  flash_bwd_dkdv_wgmma<D><<<tiles * bh, kHopperThreads, H::kDkdvSmem, st>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(rows),
      static_cast<float*>(partial), static_cast<int*>(counters),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), bh,
      group, mask, scale, tiles);
  return static_cast<int>(cudaGetLastError());
}

Mask make_mask(int s, int window, int causal, int prefix) {
  return causal ? Mask{s, window, prefix, 1} : Mask{s, 0, 0, 0};
}

}  // namespace

// q, o: (bh, s, d) and k, v: (bh / group, s, d), contiguous, 16-byte
// aligned; group >= 1 divides bh; d in {16, 32, 64, 80, 128, 256};
// bh * ceil(s / 32) < 2^31. The wrapper checks all of it. d 64, 80, 128 and
// 256 take the wgmma kernel, d 16 and 32 the mma.sync one. causal 0 sees
// every key (window and prefix are then ignored); causal 1 with prefix P
// lets the rows below P see every key below P.
// lse: null, or a float32 (bh, s) buffer that takes each row's log-sum-exp
// of its scaled logits (natural log) for the backward.
extern "C" int flash_attn_bf16(const void* q, const void* k, const void* v,
                               void* o, void* lse, int bh, int group, int s,
                               int d, float scale, int window, int causal,
                               int prefix, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group < 1 || bh % group != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Mask m = make_mask(s, window, causal, prefix);
  switch (d) {
    case 16:
      return launch_bf16<16>(q, k, v, o, lse, bh, group, m, scale, st);
    case 32:
      return launch_bf16<32>(q, k, v, o, lse, bh, group, m, scale, st);
    case 64:
      return launch_bf16_wgmma<64>(q, k, v, o, lse, bh, group, m, scale, st);
    case 80:
      return launch_bf16_wgmma<80>(q, k, v, o, lse, bh, group, m, scale, st);
    case 128:
      return launch_bf16_wgmma<128>(q, k, v, o, lse, bh, group, m, scale,
                                    st);
    case 256:
      return launch_bf16_wgmma<256>(q, k, v, o, lse, bh, group, m, scale,
                                    st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// float32: d in {16, 32, 64, 128}; lse must be null (no float32 backward);
// otherwise as flash_attn_bf16.
extern "C" int flash_attn_f32(const void* q, const void* k, const void* v,
                              void* o, void* lse, int bh, int group, int s,
                              int d, float scale, int window, int causal,
                              int prefix, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group < 1 || bh % group != 0 || lse != nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Mask m = make_mask(s, window, causal, prefix);
  switch (d) {
    case 16: return launch_f32<16>(q, k, v, o, bh, group, m, scale, st);
    case 32: return launch_f32<32>(q, k, v, o, bh, group, m, scale, st);
    case 64: return launch_f32<64>(q, k, v, o, bh, group, m, scale, st);
    case 128: return launch_f32<128>(q, k, v, o, bh, group, m, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The mma.sync backward, bf16 at d in {16, 32} (d 64, 80, 128 and 256
// take the Hopper kernels below), in two launches on one
// stream: first flash_bwd_dq (dq, and delta (bh, s) float32 for the second),
// then flash_bwd_dkdv (dk and dv). q, o, dout and dq: (bh, s, d); k, v, dk
// and dv: (bh / group, s, d); lse: the forward's (bh, s). The mask and
// scale are the forward's.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* o, const void* dout, const void* lse,
                            void* delta, void* dq, int bh, int group, int s,
                            int d, float scale, int window, int causal,
                            int prefix, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group < 1 || bh % group != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Mask m = make_mask(s, window, causal, prefix);
  switch (d) {
#define FLASH_BWD_DQ(D)                                                     \
  case D:                                                                   \
    return launch_bwd_dq<D>(q, k, v, o, dout, lse, delta, dq, bh, group, m, \
                            scale, st);
    FLASH_BWD_DQ(16)
    FLASH_BWD_DQ(32)
#undef FLASH_BWD_DQ
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_bwd_dkdv(const void* q, const void* k, const void* v,
                              const void* dout, const void* lse,
                              const void* delta, void* dk, void* dv, int bh,
                              int group, int s, int d, float scale,
                              int window, int causal, int prefix,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group < 1 || bh % group != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Mask m = make_mask(s, window, causal, prefix);
  switch (d) {
#define FLASH_BWD_DKDV(D)                                                  \
  case D:                                                                  \
    return launch_bwd_dkdv<D>(q, k, v, dout, lse, delta, dk, dv, bh, group, \
                              m, scale, st);
    FLASH_BWD_DKDV(16)
    FLASH_BWD_DKDV(32)
#undef FLASH_BWD_DKDV
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The Hopper backward, bf16 at d in {64, 80, 128, 256}, in two launches on
// one stream: first flash_bwd_dq_wgmma (dq, and `rows`: (2, bh, s_pad)
// float32, lse * log2 e then rowsum(dO * O), s_pad = s rounded up to 128,
// zero past s), then flash_bwd_dkdv_wgmma (dk and dv). The second needs
// `partial`, bh * ceil(s / n) * n * 2 * w float32 (key tiles of n = 128
// keys, 64 at d 256; w = 64 at d 64, 256 at d 256, else 128), and, with
// group > 1, `counters`, (bh / group) * ceil(s / n) int32 that are 0 on
// entry and are left at 0 (null at group 1).
// Other arguments as flash_bwd_dq and flash_bwd_dkdv.
extern "C" int flash_bwd_dq_wgmma(const void* q, const void* k,
                                  const void* v, const void* o,
                                  const void* dout, const void* lse,
                                  void* rows, void* dq, int bh, int group,
                                  int s, int d, float scale, int window,
                                  int causal, int prefix, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group < 1 || bh % group != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Mask m = make_mask(s, window, causal, prefix);
  switch (d) {
#define FLASH_BWD_DQ_WGMMA(D)                                             \
  case D:                                                                 \
    return launch_bwd_dq_wgmma<D>(q, k, v, o, dout, lse, rows, dq, bh,    \
                                  group, m, scale, st);
    FLASH_BWD_DQ_WGMMA(64)
    FLASH_BWD_DQ_WGMMA(80)
    FLASH_BWD_DQ_WGMMA(128)
    FLASH_BWD_DQ_WGMMA(256)
#undef FLASH_BWD_DQ_WGMMA
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int flash_bwd_dkdv_wgmma(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* rows, void* partial,
                                    void* counters, void* dk, void* dv,
                                    int bh, int group, int s, int d,
                                    float scale, int window, int causal,
                                    int prefix, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (group < 1 || bh % group != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Mask m = make_mask(s, window, causal, prefix);
  switch (d) {
#define FLASH_BWD_DKDV_WGMMA(D)                                           \
  case D:                                                                 \
    return launch_bwd_dkdv_wgmma<D>(q, k, v, dout, rows, partial,         \
                                    counters, dk, dv, bh, group, m, scale, \
                                    st);
    FLASH_BWD_DKDV_WGMMA(64)
    FLASH_BWD_DKDV_WGMMA(80)
    FLASH_BWD_DKDV_WGMMA(128)
    FLASH_BWD_DKDV_WGMMA(256)
#undef FLASH_BWD_DKDV_WGMMA
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
