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
// accumulates in the output tile. Here nothing is padded: the kernels read
// the device offsets themselves, so no call reads anything back to the host.
//
// Three kernels, chosen on the host (moe_gmm.py's `variant`, from M, E, K
// and N alone, never from the offsets; nothing falls back from one to
// another):
//  * "wgmma", bf16 operands at prefill-sized M (gmm_bf16_wgmma). Bound by
//    operations: 2 * rows * K * N against a few bytes per product. One
//    block owns a 128-row x 256-column output tile inside one group
//    (find_tile: a group of n rows takes ceil(n / 128) row tiles, so
//    nothing is padded; the tiles past the last group write zeros). One
//    producer warp issues TMA copies (cp.async.bulk.tensor) of 64-deep K
//    slices of x (a 2-D map, K-major) and of w[e] (a 3-D map over (E, K,
//    N), N contiguous: the MN-major B operand), 128-byte swizzled, into a
//    4-stage ring with full/empty mbarriers. Two consumer warpgroups of 64
//    rows each issue wgmma.mma_async m64n256k16 with float32 accumulators
//    in registers and keep one slice's products in flight while the next
//    slice lands. A tile's box may read rows of the next group or past M,
//    and columns or K past the edge: TMA fills what lies outside the
//    tensor with zeros, and the epilogue writes only rows [r0, r1) and
//    columns below N. Blocks are numbered column tile fastest, so the
//    blocks in flight share x rows and w[e] in L2. Its kWt instantiation
//    takes w as (E, N, K) and multiplies by w[e]^T, reading the stack
//    K-major (the backward's dX, with no transposed copy).
//  * "splitk", bf16 operands at decode-sized M (gmm_bf16_splitk). Bound
//    by bytes: a decode step's 24 rows touch up to 24 experts' whole
//    weights, 5.8 MB each at 2048 x 1408. K is split into `splits` chunks
//    of `kc` rows so that the grid fills the card (moe_gmm.py's
//    `splitk_plan`, a host function of M, E, K and N, at most 8 chunks).
//    One block owns (a group that has rows, 128 columns, one K chunk): its
//    128 threads stream the chunk's rows of those columns with 16-byte
//    loads, 4 in flight a thread, into float32 sums of up to 4 rows at
//    once. Blocks find their group by counting the groups that have rows,
//    so the ones that work come first in the grid and spread evenly over
//    the SMs, and 128 columns divide both served widths. The chunks of one
//    (group, column tile) form a thread-block cluster; each block leaves
//    its chunk's float32 partial sums in its shared memory, and the
//    second pass, by the cluster's rank-0 block, adds them in chunk order
//    through distributed shared memory and rounds once. So one launch does
//    both passes, with no workspace in device memory and no atomics.
//  * "simt", float32 operands (gmm_f32_simt): SIMT float32 FMAs, a 64 x 64
//    tile per block of 256 threads, each 4 x 4 outputs, K in slices of 16.
//    Only the reference's float32 test cases reach it.
//
// And the weight gradient of the bf16 product, which no TPU kernel has
// (the reference differentiates lax.ragged_dot in XLA):
//  * "tgmm" (gmm_bf16_tgmm): dW[e] = x_e^T dy_e, a grouped reduction over
//    each expert's rows. Bound by operations at a training microbatch
//    (49,152 rows x 2048 x 1408: 2.8e11 FLOPs against 0.71 GB). The
//    forward's design turned on its side: TMA boxes of 64 rows of x and
//    dy (the reduction) into a 3-stage ring, x^T read MN-major as
//    wgmma's A operand (transpose-A set) and dy as its MN-major B, two
//    consumer warpgroups on a 128 (K) x 256 (N) tile of one group's dW.
//    A group averages 768 rows, so tiles are short: persistent blocks,
//    one an SM, walk the tiles heaviest group first, the producer's
//    loads of the next tile overlap the last tile's epilogue, and a bf16
//    tile leaves by TMA store from shared memory while the consumers go
//    on. Rows past the group's end in its last slice are zeroed in
//    shared memory. No atomics and no split over rows, so a repeated
//    call gives the same bits.
//
// Bits: every kernel sums each output element in a fixed order, without
// atomics, so a call repeated on the same inputs gives the same bits. The
// two bf16 variants do not give the same bits as each other: wgmma adds
// exact bf16 products in the tensor cores' order over 16-deep steps, while
// split-K keeps 8 running fmaf sums inside a K chunk (rows k = p mod 8),
// adds them in order, and then adds the chunks: another order of the same
// float32 sums. Both are held to the plain version (one float32 matmul per
// group) at rtol/atol 1e-4. A bf16 result is the variant's float32 sum
// rounded once.
//
// Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v
// and called through ctypes; the C entry points return cudaGetLastError(),
// or minus the CUresult of cuTensorMapEncodeTiled when it refuses a map.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

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

// ------------------------------------------------- bf16, wgmma (prefill)
constexpr int kWgRows = 128;       // rows of an output tile: 2 x 64
constexpr int kWgCols = 256;       // columns of an output tile
constexpr int kWgDepth = 64;       // K of a slice: one 128-byte row of bf16
constexpr int kWgStages = 4;
constexpr int kWarpgroup = 128;
constexpr int kWgThreads = 3 * kWarpgroup;   // producer + two consumers
constexpr int kConsumers = 2 * kWarpgroup;
// A slice of x: 128 rows x 64 bf16, each row 128 bytes, 16-byte chunk c of
// row r stored at chunk c ^ (r % 8) (TMA's 128-byte swizzle, the wgmma
// descriptors' layout B128).
constexpr int kATileBytes = kWgRows * 128;
// A slice of w[e]: 4 panels of 64 columns, each 64 K-rows x 128 bytes,
// swizzled the same way; panel p holds columns 64p .. 64p + 63.
constexpr int kPanelBytes = kWgDepth * 128;
constexpr int kBTileBytes = (kWgCols / 64) * kPanelBytes;
constexpr int kStageBytes = kATileBytes + kBTileBytes;
// + 1024: the dynamic segment is aligned up to 1024 bytes in the kernel
constexpr int kWgSmemBytes = kStageBytes * kWgStages + 128 + 1024;
static_assert(8 * 2 * kWgStages <= 128, "barriers overflow their slot");
static_assert(kWgSmemBytes <= 232448, "more than a block's shared memory");

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

// Spin until the phase of parity `parity` has completed. A copy lands,
// and a stage is freed, in microseconds; a wait of seconds means an
// arrival that never comes, and traps, so that a fault ends the launch
// with an error instead of a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 26)) {
      __trap();
    }
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

// A box of a 2-D tensor map at (c0, c1) = (column, row) into shared
// memory; completion counted on `bar`.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The same for a 3-D map at (c0, c1, c2).
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
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

// x, K-major: 8-row groups 1024 bytes apart (SBO); the 16 K of one k-step
// sit inside a 128-byte row, so LBO is unused (16).
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return sw128_desc(addr, 16, 1024);
}

// An MN-major operand (K rows x M or N columns, M or N contiguous: w[e]
// here, x^T and dy in tgmm): 8-K-row groups 1024 bytes apart (SBO),
// 64-column panels kPanelBytes apart (LBO; a 64-wide A is one panel).
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr) {
  return sw128_desc(addr, kPanelBytes, 1024);
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

#define ACC8(d, i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),        \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 256, float32) (+)= A (64 x 16, smem) * B (16 x 256, smem), each
// operand MN-major with its transpose bit set (kTnspA, kTnspB 1), K-major
// without it (0); `accumulate` 0 overwrites d.
template <int kTnspA, int kTnspB>
__device__ __forceinline__ void wgmma_256(float (&d)[128], uint64_t desc_a,
                                          uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
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
      " %128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : ACC8(d, 0), ACC8(d, 8), ACC8(d, 16), ACC8(d, 24), ACC8(d, 32),
        ACC8(d, 40), ACC8(d, 48), ACC8(d, 56), ACC8(d, 64), ACC8(d, 72),
        ACC8(d, 80), ACC8(d, 88), ACC8(d, 96), ACC8(d, 104), ACC8(d, 112),
        ACC8(d, 120)
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTnspA),
        "n"(kTnspB));
}

#undef ACC8

// One block = one (row tile, 256-column tile); blockIdx.x counts column
// tiles fastest. Shared memory: kWgStages stages of (x slice, w slice),
// then the mbarriers: full[i] at bars + 8i, empty[i] at bars + 8(S + i).
// kWt: w holds (E, N, K) and the product takes w[e]^T, K contiguous: a
// slice of it is one TMA box of 256 rows (output columns) x 64 K, the
// K-major B operand (wgmma's transpose bit clear), laid out as x's slice
// is. The grouped matmul's backward takes dX = dY w[e]^T so, with no
// transposed copy of the expert stack.
//
// Accumulator layout of m64nNk16 (warp w of a warpgroup owns rows 16w ..
// 16w + 15 of its 64; lane = 4g + t): acc[4j + 0, 1] = row g, columns
// 8j + 2t, + 1; acc[4j + 2, 3] = row g + 8, the same columns.
template <typename Out, bool kWt>
__global__ void __launch_bounds__(kWgThreads, 1)
gmm_bf16_wgmma(const __grid_constant__ CUtensorMap tm_x,
               const __grid_constant__ CUtensorMap tm_w,
               const int* __restrict__ offs, Out* __restrict__ out, int m,
               int k, int n, int num_groups, int col_tiles) {
  extern __shared__ uint8_t smem_raw[];
  const int n0 = static_cast<int>(blockIdx.x % col_tiles) * kWgCols;
  int expert, r0, r1;
  if (!find_tile(offs, num_groups, m, kWgRows,
                 static_cast<int>(blockIdx.x / col_tiles), &expert, &r0,
                 &r1)) {
    return;
  }
  if (expert < 0) {
    zero_rows(out, r0, r1, n0, n, kWgCols, kWgThreads);
    return;
  }
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = base + kWgStages * kStageBytes;
  const int slices = (k + kWgDepth - 1) / kWgDepth;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kWgStages; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + 8 * (kWgStages + i), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < kWarpgroup) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      for (int s = 0; s < slices; ++s) {
        const int stage = s % kWgStages;
        if (s >= kWgStages) {   // wait for the consumers to free the stage
          mbar_wait(bars + 8 * (kWgStages + stage),
                    (s / kWgStages - 1) & 1);
        }
        const uint32_t full = bars + 8 * stage;
        const uint32_t a = base + stage * kStageBytes;
        mbar_expect_tx(full, kStageBytes);
        tma_load_2d(a, &tm_x, full, s * kWgDepth, r0);
        if constexpr (kWt) {
          tma_load_3d(a + kATileBytes, &tm_w, full, s * kWgDepth, n0, expert);
        } else {
#pragma unroll
          for (int p = 0; p < kWgCols / 64; ++p) {
            tma_load_3d(a + kATileBytes + p * kPanelBytes, &tm_w, full,
                        n0 + 64 * p, s * kWgDepth, expert);
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = threadIdx.x / kWarpgroup - 1;   // rows 64cw .. 64cw + 63
    float acc[128];
#pragma unroll
    for (int i = 0; i < 128; ++i) {
      acc[i] = 0.0f;
    }
    for (int s = 0; s < slices; ++s) {
      const int stage = s % kWgStages;
      mbar_wait(bars + 8 * stage, (s / kWgStages) & 1);
      const uint32_t a = base + stage * kStageBytes + cw * 64 * 128;
      const uint32_t b = base + stage * kStageBytes + kATileBytes;
      hold(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kWgDepth / 16; ++kk) {
        // k-step kk: bytes 32kk of each x row, K-rows 16kk .. of each
        // panel (or, kWt, bytes 32kk of each w^T row)
        if constexpr (kWt) {
          wgmma_256<0, 0>(acc, kmajor_desc(a + 32 * kk),
                          kmajor_desc(b + 32 * kk), 1);
        } else {
          wgmma_256<0, 1>(acc, kmajor_desc(a + 32 * kk),
                          mnmajor_desc(b + kk * 16 * 128), 1);
        }
      }
      wgmma_commit();
      wgmma_wait<1>();   // slice s - 1's products are done: free its stage
      hold(acc);
      if (s > 0) {
        mbar_arrive(bars + 8 * (kWgStages + (s - 1) % kWgStages));
      }
    }
    wgmma_wait<0>();
    hold(acc);

    const int warp = (threadIdx.x % kWarpgroup) / 32;
    const int lane = threadIdx.x % 32;
    const int row_a = r0 + cw * 64 + warp * 16 + lane / 4;
    const int row_b = row_a + 8;
#pragma unroll
    for (int j = 0; j < kWgCols / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      if (col >= n) {
        continue;
      }
      if (row_a < r1) {
        store2(out + static_cast<long long>(row_a) * n + col, acc[4 * j],
               acc[4 * j + 1]);
      }
      if (row_b < r1) {
        store2(out + static_cast<long long>(row_b) * n + col, acc[4 * j + 2],
               acc[4 * j + 3]);
      }
    }
  }
}

// ------------------------------------------------ bf16, split-K (decode)
// A block of 128 threads: 16 threads of 8 columns each (128 columns,
// which divide both served widths), times 8 phases of K rows; 4 rows of a
// group summed at once (a decode step's groups have at most 4: one a
// token); 4 16-byte loads of w in flight a thread. At 80 registers, 6
// blocks fit an SM (`launch_bounds`), so the grid that `splitk_plan`
// sizes for 6 x 132 blocks runs in one wave.
constexpr int kSkThreads = 128;
constexpr int kSkColThreads = 16;
constexpr int kSkCols = 8 * kSkColThreads;
constexpr int kSkPhases = kSkThreads / kSkColThreads;
constexpr int kSkRows = 4;
constexpr int kSkUnroll = 4;
constexpr int kSkBlocksPerSm = 6;
constexpr int kSkStage = 512;   // K rows of x staged in shared memory
static_assert(kSkRows * kSkCols == 4 * kSkThreads,
              "a pass's sums are added 4 values a thread");

__device__ __forceinline__ void unpack8(uint4 v, float (&f)[8]) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store4(float* out, float4 v) {
  *reinterpret_cast<float4*>(out) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* out, float4 v) {
  store2(out, v.x, v.y);
  store2(out + 2, v.z, v.w);
}

// The u-th group that has rows (clipped offsets lo < hi) and its rows
// [lo, hi), or g = -1: the block's 128 threads look at 128 groups at a
// time and count them with warp ballots.
static_assert(kSkThreads == 128, "nth_used_group counts with 4 warps");

struct GroupRows {
  int g, lo, hi;
};

__device__ GroupRows nth_used_group(const int* __restrict__ offs,
                                    int num_groups, int m, int u) {
  __shared__ int counts[4];
  __shared__ int3 found;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (threadIdx.x == 0) {
    found = make_int3(-1, 0, 0);
  }
  int seen = 0;   // groups with rows before this window
  for (int g0 = 0; g0 < num_groups; g0 += 128) {
    const int g = g0 + threadIdx.x;
    int lo = 0, hi = 0;
    if (g < num_groups) {
      lo = min(max(__ldg(offs + g), 0), m);
      hi = max(min(__ldg(offs + g + 1), m), lo);
    }
    const unsigned mask = __ballot_sync(0xffffffffu, hi > lo);
    if (lane == 0) {
      counts[warp] = __popc(mask);
    }
    __syncthreads();
    int rank = seen + __popc(mask & ((1u << lane) - 1u));
    for (int w = 0; w < warp; ++w) {
      rank += counts[w];
    }
    if (hi > lo && rank == u) {
      found = make_int3(g, lo, hi);
    }
    seen += counts[0] + counts[1] + counts[2] + counts[3];
    __syncthreads();   // `found` is written; `counts` may be rewritten
    if (found.x >= 0 || seen > u) {
      break;
    }
  }
  return {found.x, found.y, found.z};
}

// blockIdx = (column tile, K chunk, slot u); the K chunks of one (tile,
// slot) form a cluster of gridDim.y blocks. Slot u < gridDim.z - 1 takes
// the u-th group that has rows (slots past the last such group exit,
// whole clusters at a time), so the blocks that work come first in the
// grid and spread evenly over the SMs; the last slot is the zero tail. A
// block streams K rows [kb, ke) of its 128 columns of w[g]: thread
// (phase p, column group c) sums rows kb + p, kb + p + 8, ... of its 8
// columns in order with fmaf, for up to 4 rows of the group at once; the
// phases' sums are added in phase order through shared memory, which
// gives the chunk's float32 partial sums. The cluster's rank-0 block then
// reads every rank's partial sums through distributed shared memory, adds
// them in rank (K) order, rounds once and writes the rows.
template <typename Out>
__global__ void __launch_bounds__(kSkThreads, kSkBlocksPerSm)
gmm_bf16_splitk(const __nv_bfloat16* __restrict__ x,
                const __nv_bfloat16* __restrict__ w,
                const int* __restrict__ offs, Out* __restrict__ out, int m,
                int k, int n, int num_groups, int kc) {
  __shared__ float xs[kSkRows][kSkStage];
  __shared__ __align__(16) float red[kSkPhases][kSkRows][kSkCols];
  __shared__ float4 chunk_sum[kSkThreads];   // a pass's sums, 4 a thread
  const int c8 = (threadIdx.x % kSkColThreads) * 8;
  const int phase = threadIdx.x / kSkColThreads;
  const int n0 = blockIdx.x * kSkCols;
  const int col = n0 + c8;
  const bool active = col < n;
  if (blockIdx.z == gridDim.z - 1) {
    if (blockIdx.y == 0) {
      const int total = min(max(__ldg(offs + num_groups), 0), m);
      const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (long long o = threadIdx.x * 4;
           o < static_cast<long long>(m - total) * kSkCols;
           o += kSkThreads * 4) {
        const int c = n0 + static_cast<int>(o % kSkCols);
        if (c < n) {
          store4(out + (total + o / kSkCols) * n + c, zero);
        }
      }
    }
    return;
  }
  const GroupRows group = nth_used_group(offs, num_groups, m, blockIdx.z);
  const int g = group.g, lo = group.lo, hi = group.hi;
  if (g < 0) {
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int kb = blockIdx.y * kc;
  const int ke = min(k, kb + kc);
  const __nv_bfloat16* wg = w + static_cast<long long>(g) * k * n + col;

  for (int r0 = lo; r0 < hi; r0 += kSkRows) {
    float acc[kSkRows][8];
#pragma unroll
    for (int r = 0; r < kSkRows; ++r) {
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        acc[r][c] = 0.0f;
      }
    }
    for (int k0 = kb; k0 < ke; k0 += kSkStage) {
      const int kn = min(kSkStage, ke - k0);
      // rows phase, phase + P, ... below kn, kSkUnroll at a time
      const int mine = (kn - phase + kSkPhases - 1) / kSkPhases;
      uint4 v[kSkUnroll];
      auto load = [&](int j) {
#pragma unroll
        for (int u = 0; u < kSkUnroll; ++u) {
          if (j + u < mine) {
            v[u] = __ldg(reinterpret_cast<const uint4*>(
                wg + static_cast<long long>(k0 + phase +
                                            kSkPhases * (j + u)) * n));
          }
        }
      };
      if (active) {
        load(0);   // in flight while x is staged
      }
      __syncthreads();   // the previous stage's readers are done
      for (int c = threadIdx.x; c < kSkRows * kSkStage; c += kSkThreads) {
        const int r = c / kSkStage;
        const int i = c % kSkStage;
        xs[r][i] = (r0 + r < hi && i < kn)
                       ? __bfloat162float(
                             x[static_cast<long long>(r0 + r) * k + k0 + i])
                       : 0.0f;
      }
      __syncthreads();
      if (!active) {
        continue;
      }
      for (int j = 0; j < mine; j += kSkUnroll) {
        if (j > 0) {
          load(j);
        }
#pragma unroll
        for (int u = 0; u < kSkUnroll; ++u) {
          if (j + u < mine) {
            float wf[8];
            unpack8(v[u], wf);
#pragma unroll
            for (int r = 0; r < kSkRows; ++r) {
              const float xv = xs[r][phase + kSkPhases * (j + u)];
#pragma unroll
              for (int c = 0; c < 8; ++c) {
                acc[r][c] = fmaf(xv, wf[c], acc[r][c]);
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kSkRows; ++r) {
      float4* dst = reinterpret_cast<float4*>(&red[phase][r][c8]);
      dst[0] = make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      dst[1] = make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
    __syncthreads();
    // the thread's 4 sums: row r4, columns c4 .. c4 + 3
    const int r4 = threadIdx.x * 4 / kSkCols;
    const int c4 = threadIdx.x * 4 % kSkCols;
    float4 s = *reinterpret_cast<const float4*>(&red[0][r4][c4]);
#pragma unroll
    for (int p = 1; p < kSkPhases; ++p) {
      const float4 v = *reinterpret_cast<const float4*>(&red[p][r4][c4]);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    chunk_sum[threadIdx.x] = s;
    cluster.sync();   // every chunk's partial sums are in place
    if (cluster.block_rank() == 0) {
      for (unsigned q = 1; q < cluster.num_blocks(); ++q) {
        const float4 v = *cluster.map_shared_rank(&chunk_sum[threadIdx.x], q);
        s.x += v.x;
        s.y += v.y;
        s.z += v.z;
        s.w += v.w;
      }
      const int row = r0 + r4;
      if (row < hi && n0 + c4 < n) {
        store4(out + static_cast<long long>(row) * n + n0 + c4, s);
      }
    }
    cluster.sync();   // rank 0 has read them: they may be overwritten
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

// ------------------------------------- bf16 weight gradient (tgmm)
// dW[e] = x[offs[e]:offs[e+1]]^T @ dy[offs[e]:offs[e+1]]: (E, K, N) from
// (M, K) x and (M, N) dy. A tile is 128 rows (K) x 256 columns (N) of one
// group's dW; the reduction runs over the group's rows in 64-row slices.
// The forward's building blocks: one producer warp issues TMA copies into
// the kTgStages ring (full/empty mbarriers), two consumer warpgroups of 64
// dW rows each issue wgmma m64n256k16 into 128 float32 accumulators a
// thread. A stage holds one slice: x's rows as two 64-column panels (A,
// kATileBytes) and dy's as four (B, kBTileBytes), each panel 64 rows x 128
// bytes, 128-byte swizzled, one TMA box. A panel row is one reduction
// index and its 64 values run along the product's M (for x) or N (for dy):
// both operands are MN-major, A = x^T with wgmma's transpose-A bit set, B
// = dy laid out as the forward's w slice.
//
// Persistent: gridDim.x blocks (one an SM) walk the E * k_tiles * n_tiles
// tiles in rounds of gridDim.x, the groups heaviest first (every block
// orders them alike from the device offsets: by rows, ties by index; more
// than kTgMaxSorted groups keep their own order), N tile fastest inside a
// group; the blocks take a round's tiles in order, and the next round's
// in reverse (tg_round_tile; a plain stride gives the low blocks the
// heavier tile of every round, which told on skewed groups). The producer
// runs on into the next tile's slices while the consumers write the last
// tile out, so the ring's fill and the epilogue overlap the loads. A bf16
// tile is written into shared memory (a conflict-free swizzled layout)
// and leaves by TMA store, so the consumers start the next tile at once:
// stored from registers, a half-sector store an instruction, it held
// them far longer, which a fourth ring stage (the staging buffer's
// shared memory) did not make up. A float32 dW (the checks' format) is
// stored from registers. A group with no rows takes no slice and its
// tiles are written as zeros.
//
// A slice's boxes start at row lo + 64s, so the group's last slice reads
// the next group's rows (or rows past offs[E]); TMA fills only rows past M
// with zeros. The consumers zero the rows at or past the group's end in
// both operands before that slice's products, so a non-finite value there
// reaches no other group's dW. Columns past K or N come from TMA's zero
// fill, and the epilogue writes only rows below K and columns below N
// (the TMA store clips at the tensor's edge).
//
// Each dW element is one float32 sum over its group's rows in slice order
// (16 rows a wgmma), rounded once: no atomics, no split over rows.
constexpr int kTgStages = 3;
// a bf16 tile staged for its TMA store: per consumer warpgroup, 4 panels
// of 64 dW rows x 64 columns (128-byte rows, swizzled as the ring's)
constexpr int kTgOutBytes = 2 * (kWgCols / 64) * kPanelBytes;
constexpr int kTgSmemBytes =
    kTgStages * kStageBytes + kTgOutBytes + 128 + 1024;
constexpr int kTgMaxSorted = 1024;
static_assert(kATileBytes == 2 * kPanelBytes, "x's slice is two panels");
static_assert(8 * 2 * kTgStages <= 128, "barriers overflow their slot");
static_assert(kTgSmemBytes + 2 * kTgMaxSorted * 4 <= 232448,
              "more than a block's shared memory");

__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Generic-proxy writes to shared memory made visible to the async proxy
// (wgmma's operand reads, TMA stores).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A box of shared memory to a 3-D tensor map at (c0, c1, c2); TMA writes
// nothing outside the tensor.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// This thread's committed TMA stores have read their shared memory
// (kRead) or are done.
template <bool kRead>
__device__ __forceinline__ void bulk_wait_all() {
  if constexpr (kRead) {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  } else {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// Tile t of the walk: group g, dW rows k0 .. k0 + 127, columns n0 ..
// n0 + 255, and the group's clipped rows [lo, hi).
struct TgTile {
  int g, k0, n0, lo, hi;
};

__device__ __forceinline__ TgTile tg_tile(const int* order, bool sorted,
                                          const int* __restrict__ offs,
                                          int m, int n_tiles,
                                          int group_tiles, int t) {
  TgTile c;
  const int w = t % group_tiles;
  c.g = sorted ? order[t / group_tiles] : t / group_tiles;
  c.k0 = (w / n_tiles) * kWgRows;
  c.n0 = (w % n_tiles) * kWgCols;
  c.lo = min(max(__ldg(offs + c.g), 0), m);
  c.hi = max(min(__ldg(offs + c.g + 1), m), c.lo);
  return c;
}

// The tile a block takes in round q of the walk: the blocks in order in
// even rounds and in reverse in odd ones, so that over tiles sorted
// heaviest first no block keeps taking the heavier tile of every round.
__device__ __forceinline__ int tg_round_tile(int q) {
  const int b = static_cast<int>(blockIdx.x);
  const int blocks = static_cast<int>(gridDim.x);
  return q * blocks + ((q & 1) ? blocks - 1 - b : b);
}

// Shared memory: kTgStages stages of (x slice, dy slice), the staged
// output tile (bf16), then the mbarriers: full[i] at bars + 8i, empty[i]
// at bars + 8(S + i); the group order in static memory. Accumulator
// layout as gmm_bf16_wgmma's: warp w of consumer warpgroup cw owns dW rows
// 64cw + 16w .. of the tile; lane = 4g + t holds rows g and g + 8,
// columns 8j + 2t, + 1. tm_out is (E, K, N) bf16 dW in boxes of 64 x 64
// (unused for a float32 dW, which is stored from registers).
template <typename Out>
__global__ void __launch_bounds__(kWgThreads, 1)
gmm_bf16_tgmm(const __grid_constant__ CUtensorMap tm_x,
              const __grid_constant__ CUtensorMap tm_dy,
              const __grid_constant__ CUtensorMap tm_out,
              const int* __restrict__ offs, Out* __restrict__ out, int m,
              int k, int n, int num_groups) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ int order[kTgMaxSorted];   // the group of rank r
  __shared__ int rows[kTgMaxSorted];    // group g's clipped rows
  const int n_tiles = (n + kWgCols - 1) / kWgCols;
  const int group_tiles = ((k + kWgRows - 1) / kWgRows) * n_tiles;
  const int tiles = num_groups * group_tiles;
  const bool sorted = num_groups <= kTgMaxSorted;
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t staged = base + kTgStages * kStageBytes;
  const uint32_t bars = staged + kTgOutBytes;
  uint8_t* const ring = smem_raw + (base - smem_addr(smem_raw));

  if (sorted) {
    for (int g = threadIdx.x; g < num_groups; g += kWgThreads) {
      const int lo = min(max(__ldg(offs + g), 0), m);
      rows[g] = max(min(__ldg(offs + g + 1), m), lo) - lo;
    }
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < kTgStages; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + 8 * (kTgStages + i), kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (sorted) {   // rank = groups with more rows, or as many and before
    for (int g = threadIdx.x; g < num_groups; g += kWgThreads) {
      const int r = rows[g];
      int rank = 0;
      for (int h = 0; h < num_groups; ++h) {
        rank += rows[h] > r || (rows[h] == r && h < g);
      }
      order[rank] = g;
    }
  }
  __syncthreads();

  if (threadIdx.x < kWarpgroup) {
    // ------------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      int it = 0;   // slices issued by this block, across its tiles
      for (int q = 0, t = tg_round_tile(0); t < tiles;
           t = tg_round_tile(++q)) {
        const TgTile c = tg_tile(order, sorted, offs, m, n_tiles,
                                 group_tiles, t);
        for (int r0 = c.lo; r0 < c.hi; r0 += kWgDepth, ++it) {
          const int stage = it % kTgStages;
          if (it >= kTgStages) {   // wait for the consumers to free it
            mbar_wait(bars + 8 * (kTgStages + stage),
                      (it / kTgStages - 1) & 1);
          }
          const uint32_t full = bars + 8 * stage;
          const uint32_t a = base + stage * kStageBytes;
          mbar_expect_tx(full, kStageBytes);
#pragma unroll
          for (int p = 0; p < kATileBytes / kPanelBytes; ++p) {
            tma_load_2d(a + p * kPanelBytes, &tm_x, full, c.k0 + 64 * p, r0);
          }
#pragma unroll
          for (int p = 0; p < kWgCols / 64; ++p) {
            tma_load_2d(a + kATileBytes + p * kPanelBytes, &tm_dy, full,
                        c.n0 + 64 * p, r0);
          }
        }
      }
    }
  } else {
    // ------------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = threadIdx.x / kWarpgroup - 1;   // dW rows 64cw ..
    const int wt = threadIdx.x % kWarpgroup;
    const int warp = wt / 32;
    const int lane = threadIdx.x % 32;
    float acc[128];
    int it = 0;   // slices consumed, as the producer counts them
    for (int q = 0, t = tg_round_tile(0); t < tiles;
         t = tg_round_tile(++q)) {
      const TgTile c = tg_tile(order, sorted, offs, m, n_tiles, group_tiles,
                               t);
#pragma unroll
      for (int i = 0; i < 128; ++i) {
        acc[i] = 0.0f;
      }
      for (int r0 = c.lo; r0 < c.hi; r0 += kWgDepth, ++it) {
        const int stage = it % kTgStages;
        mbar_wait(bars + 8 * stage, (it / kTgStages) & 1);
        const uint32_t a = base + stage * kStageBytes;
        const int valid = c.hi - r0;
        if (valid < kWgDepth) {
          // rows valid .. 63 of the six panels: this warpgroup zeroes its
          // x panel and dy panels 2cw, 2cw + 1, whole 128-byte rows
          const int chunks = (kWgDepth - valid) * 8;
          for (int i = wt; i < 3 * chunks; i += kWarpgroup) {
            const int p = i / chunks;
            const int panel =
                p == 0 ? cw * kPanelBytes
                       : kATileBytes + (2 * cw + p - 1) * kPanelBytes;
            *reinterpret_cast<uint4*>(ring + stage * kStageBytes + panel +
                                      valid * 128 + (i % chunks) * 16) =
                make_uint4(0u, 0u, 0u, 0u);
          }
          fence_proxy_async();   // before either warpgroup's wgmma reads
          named_sync(1, kConsumers);
        }
        hold(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgDepth / 16; ++kk) {
          // k-step kk: panel rows 16kk .. 16kk + 15 of both operands
          wgmma_256<1, 1>(acc,
                          mnmajor_desc(a + cw * kPanelBytes + kk * 2048),
                          mnmajor_desc(a + kATileBytes + kk * 2048), 1);
        }
        wgmma_commit();
        wgmma_wait<1>();   // the previous slice's products are done
        hold(acc);
        if (r0 > c.lo) {
          mbar_arrive(bars + 8 * (kTgStages + (it - 1) % kTgStages));
        }
      }
      wgmma_wait<0>();
      hold(acc);
      if (c.hi > c.lo) {   // free the tile's last stage
        mbar_arrive(bars + 8 * (kTgStages + (it - 1) % kTgStages));
      }

      if constexpr (sizeof(Out) == 2) {
        // into this warpgroup's staged panels (conflict-free: the 8 rows
        // of a store instruction sit in 8 different 16-byte chunks), then
        // one thread stores them by TMA while the warpgroup goes on
        const uint32_t mine = staged + cw * (kTgOutBytes / 2);
        uint8_t* const dst = ring + (mine - base);
        const int row = warp * 16 + lane / 4;   // and row + 8
        if (wt == 0) {
          bulk_wait_all<true>();   // the last tile's store has read them
        }
        named_sync(2 + cw, kWarpgroup);
#pragma unroll
        for (int j = 0; j < kWgCols / 8; ++j) {
          const int at = (j / 8) * kPanelBytes + row * 128 +
                         ((j % 8) ^ (row % 8)) * 16 + 4 * (lane % 4);
          *reinterpret_cast<__nv_bfloat162*>(dst + at) =
              __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
          *reinterpret_cast<__nv_bfloat162*>(dst + at + 8 * 128) =
              __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
        }
        fence_proxy_async();
        named_sync(2 + cw, kWarpgroup);
        if (wt == 0) {
#pragma unroll
          for (int p = 0; p < kWgCols / 64; ++p) {
            tma_store_3d(&tm_out, mine + p * kPanelBytes, c.n0 + 64 * p,
                         c.k0 + 64 * cw, c.g);
          }
          bulk_commit();
        }
      } else {
        Out* dst = out + static_cast<long long>(c.g) * k * n;
        const int row_a = c.k0 + cw * 64 + warp * 16 + lane / 4;
        const int row_b = row_a + 8;
#pragma unroll
        for (int j = 0; j < kWgCols / 8; ++j) {
          const int col = c.n0 + 8 * j + 2 * (lane % 4);
          if (col >= n) {
            continue;
          }
          if (row_a < k) {
            store2(dst + static_cast<long long>(row_a) * n + col, acc[4 * j],
                   acc[4 * j + 1]);
          }
          if (row_b < k) {
            store2(dst + static_cast<long long>(row_b) * n + col,
                   acc[4 * j + 2], acc[4 * j + 3]);
          }
        }
      }
    }
    if (wt == 0) {
      bulk_wait_all<false>();   // every store of this warpgroup is done
    }
  }
}

// Row tiles of bm rows over all groups: at most ceil(M / bm) + E + 1.
int row_tiles(int m, int num_groups, int bm) {
  return (m + bm - 1) / bm + num_groups + 1;
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

// A bf16 tensor map with a 128-byte-swizzled box; 0 or the CUresult.
CUresult encode_bf16(EncodeTiled encode, CUtensorMap* map, int rank,
                     const void* ptr, const cuuint64_t* dims,
                     const cuuint64_t* strides, const cuuint32_t* box) {
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(ptr), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// 0, a cudaError_t, or minus a CUresult if a tensor map is refused.
template <typename Out, bool kWt>
int launch_wgmma(const void* x, const void* w, const int* offs, void* out,
                 int m, int k, int n, int num_groups, cudaStream_t st) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) {
    return -static_cast<int>(CUDA_ERROR_NOT_FOUND);
  }
  CUtensorMap tm_x, tm_w;
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(k),
                                static_cast<cuuint64_t>(m)};
  const cuuint64_t x_strides[1] = {static_cast<cuuint64_t>(k) * 2};
  const cuuint32_t x_box[2] = {kWgDepth, kWgRows};
  CUresult r = encode_bf16(encode, &tm_x, 2, x, x_dims, x_strides, x_box);
  if (r != CUDA_SUCCESS) {
    return -static_cast<int>(r);
  }
  // w (E, K, N), N contiguous, in 64-column panels; or, kWt, (E, N, K),
  // K contiguous, in one box of 256 rows of w^T
  const cuuint64_t inner = kWt ? k : n;
  const cuuint64_t w_dims[3] = {inner,
                                static_cast<cuuint64_t>(kWt ? n : k),
                                static_cast<cuuint64_t>(num_groups)};
  const cuuint64_t w_strides[2] = {
      inner * 2, static_cast<cuuint64_t>(k) * static_cast<cuuint64_t>(n) * 2};
  const cuuint32_t w_box[3] = {64, kWt ? kWgCols : kWgDepth, 1};
  r = encode_bf16(encode, &tm_w, 3, w, w_dims, w_strides, w_box);
  if (r != CUDA_SUCCESS) {
    return -static_cast<int>(r);
  }
  const cudaError_t err = cudaFuncSetAttribute(
      gmm_bf16_wgmma<Out, kWt>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kWgSmemBytes);
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int col_tiles = (n + kWgCols - 1) / kWgCols;
  gmm_bf16_wgmma<Out, kWt>
      <<<row_tiles(m, num_groups, kWgRows) * col_tiles, kWgThreads,
         kWgSmemBytes, st>>>(tm_x, tm_w, offs, static_cast<Out*>(out), m, k,
                             n, num_groups, col_tiles);
  return static_cast<int>(cudaGetLastError());
}

template <typename Out>
int launch_splitk(const void* x, const void* w, const int* offs, void* out,
                  int m, int k, int n, int num_groups, int splits, int kc,
                  cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  // slots for the groups that have rows (at most min(M, E)), then the tail
  cfg.gridDim = dim3((n + kSkCols - 1) / kSkCols, splits,
                     min(m, num_groups) + 1);
  cfg.blockDim = dim3(kSkThreads);
  cfg.stream = st;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = splits;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, gmm_bf16_splitk<Out>, static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), offs, static_cast<Out*>(out), m,
      k, n, num_groups, kc);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

// 0, a cudaError_t, or minus a CUresult if a tensor map is refused.
template <typename Out>
int launch_tgmm(const void* x, const void* dy, const int* offs, void* out,
                int m, int k, int n, int num_groups, cudaStream_t st) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) {
    return -static_cast<int>(CUDA_ERROR_NOT_FOUND);
  }
  // x (M, K) and dy (M, N), each in boxes of 64 columns x 64 rows
  CUtensorMap tm_x, tm_dy;
  const cuuint32_t box[2] = {64, kWgDepth};
  const cuuint64_t x_dims[2] = {static_cast<cuuint64_t>(k),
                                static_cast<cuuint64_t>(m)};
  const cuuint64_t x_strides[1] = {static_cast<cuuint64_t>(k) * 2};
  CUresult r = encode_bf16(encode, &tm_x, 2, x, x_dims, x_strides, box);
  if (r != CUDA_SUCCESS) {
    return -static_cast<int>(r);
  }
  const cuuint64_t dy_dims[2] = {static_cast<cuuint64_t>(n),
                                 static_cast<cuuint64_t>(m)};
  const cuuint64_t dy_strides[1] = {static_cast<cuuint64_t>(n) * 2};
  r = encode_bf16(encode, &tm_dy, 2, dy, dy_dims, dy_strides, box);
  if (r != CUDA_SUCCESS) {
    return -static_cast<int>(r);
  }
  // dW (E, K, N) bf16 in boxes of 64 x 64 dW rows, for the TMA stores
  CUtensorMap tm_out = {};
  if constexpr (sizeof(Out) == 2) {
    const cuuint64_t out_dims[3] = {static_cast<cuuint64_t>(n),
                                    static_cast<cuuint64_t>(k),
                                    static_cast<cuuint64_t>(num_groups)};
    const cuuint64_t out_strides[2] = {
        static_cast<cuuint64_t>(n) * 2,
        static_cast<cuuint64_t>(k) * static_cast<cuuint64_t>(n) * 2};
    const cuuint32_t out_box[3] = {64, 64, 1};
    r = encode_bf16(encode, &tm_out, 3, out, out_dims, out_strides, out_box);
    if (r != CUDA_SUCCESS) {
      return -static_cast<int>(r);
    }
  }
  cudaError_t err = cudaFuncSetAttribute(
      gmm_bf16_tgmm<Out>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTgSmemBytes);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) {
    err = cudaGetDevice(&dev);
  }
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int tiles = num_groups * ((k + kWgRows - 1) / kWgRows) *
                    ((n + kWgCols - 1) / kWgCols);
  gmm_bf16_tgmm<Out><<<min(tiles, sms), kWgThreads, kTgSmemBytes, st>>>(
      tm_x, tm_dy, tm_out, offs, static_cast<Out*>(out), m, k, n,
      num_groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The weight gradient: x (M, K) and dy (M, N) bf16, out (E, K, N) float32
// when out_f32, else bf16; every element of out is written (zeros for a
// group with no rows). The wrapper checks the shapes (M, K, N and E
// positive, K and N multiples of 8, E below 65,535), and M * K, M * N and
// E * K * N stay below 2^31. Returns as launch_tgmm.
extern "C" int moe_gmm_bf16_tgmm(const void* x, const void* dy,
                                 const int* offs, void* out, int out_f32,
                                 int m, int k, int n, int num_groups,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_f32 ? launch_tgmm<float>(x, dy, offs, out, m, k, n, num_groups,
                                      st)
                 : launch_tgmm<__nv_bfloat16>(x, dy, offs, out, m, k, n,
                                              num_groups, st);
}

// x, w: bf16; out: float32 when out_f32, else bf16; w_t: w is (E, N, K)
// and the product takes w[e]^T. Shapes as above; the wrapper checks them
// (M, K, N and E all positive), and M * N, M * K and E * K * N stay
// below 2^31.
extern "C" int moe_gmm_bf16_wgmma(const void* x, const void* w,
                                  const int* offs, void* out, int out_f32,
                                  int w_t, int m, int k, int n,
                                  int num_groups, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w_t) {
    return out_f32 ? launch_wgmma<float, true>(x, w, offs, out, m, k, n,
                                               num_groups, st)
                   : launch_wgmma<__nv_bfloat16, true>(x, w, offs, out, m, k,
                                                       n, num_groups, st);
  }
  return out_f32 ? launch_wgmma<float, false>(x, w, offs, out, m, k, n,
                                              num_groups, st)
                 : launch_wgmma<__nv_bfloat16, false>(x, w, offs, out, m, k,
                                                      n, num_groups, st);
}

// As above; K chunk c covers rows [c * kc, min(K, (c + 1) * kc)), kc a
// multiple of 8, splits * kc >= K > (splits - 1) * kc, 1 <= splits <= 8
// (a portable cluster), and min(M, E) + 1 below 65,536.
extern "C" int moe_gmm_bf16_splitk(const void* x, const void* w,
                                   const int* offs, void* out, int out_f32,
                                   int m, int k, int n, int num_groups,
                                   int splits, int kc, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return out_f32 ? launch_splitk<float>(x, w, offs, out, m, k, n, num_groups,
                                        splits, kc, st)
                 : launch_splitk<__nv_bfloat16>(x, w, offs, out, m, k, n,
                                                num_groups, splits, kc, st);
}

extern "C" int moe_gmm_f32(const void* x, const void* w, const int* offs,
                           void* out, int m, int k, int n, int num_groups,
                           void* stream) {
  if (m <= 0 || n <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(row_tiles(m, num_groups, kFm), (n + kFn - 1) / kFn);
  gmm_f32_simt<<<grid, kSimtThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), offs,
      static_cast<float*>(out), m, k, n, num_groups);
  return static_cast<int>(cudaGetLastError());
}
