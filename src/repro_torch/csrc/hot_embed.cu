// Hot-slab embedding gather, hand-written for Hopper.
//
//   out[i, :] = slab[ids[i], :]  where 0 <= ids[i] < H,  else 0
//
// (float32 slab of H rows by D columns, int32 ids). One warp owns one id at
// a time and walks the ids in a grid-stride loop; its lanes copy the row
// with 16-byte loads and stores when D % 4 == 0 and both base pointers are
// 16-byte aligned, else with 4-byte ones. A cold id (>= H, the caller lays
// the plain cold gather over it) writes a row of zeros. Every value is a
// copy, so the result is exact.
//
// Replaces hot_gather_pallas (src/repro/kernels/hot_embed/hot_embed.py).
// The TPU kernel pinned the whole slab in VMEM. Here the 50 MB L2 holds the
// rows that the id stream keeps reading: minicpm-2b's slab (6,137 rows of
// 2304 floats, 56.6 MB) does not fit whole, and rows that fall out of L2
// are read again from HBM.
//
// Bound: bytes. A call reads N ids and the hot rows they name and writes
// N * D floats; the writes dominate.
//
// Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes; the C entry point returns cudaGetLastError().

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;                    // 8 warps, 8 ids per block
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr int kBlocksPerSm = 8;

template <bool kVec4>
__global__ void __launch_bounds__(kThreads)
hot_gather_warp_per_id(const int* __restrict__ ids,
                       const float* __restrict__ slab,
                       float* __restrict__ out, int n, int h, int d) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = (blockIdx.x * kThreads + threadIdx.x) / kWarp;
  const int num_warps = gridDim.x * kWarpsPerBlock;
  for (int i = warp; i < n; i += num_warps) {
    const int id = __ldg(ids + i);
    const bool hot = id >= 0 && id < h;
    float* dst = out + static_cast<long long>(i) * d;
    const float* src = slab + static_cast<long long>(hot ? id : 0) * d;
    if (kVec4) {
      const int d4 = d >> 2;
      float4* dst4 = reinterpret_cast<float4*>(dst);
      const float4* src4 = reinterpret_cast<const float4*>(src);
      for (int c = lane; c < d4; c += kWarp) {
        dst4[c] = hot ? __ldg(src4 + c) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    } else {
      for (int c = lane; c < d; c += kWarp) {
        dst[c] = hot ? __ldg(src + c) : 0.0f;
      }
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

extern "C" int hot_gather_f32(const int* ids, const float* slab, float* out,
                              int n, int h, int d, void* stream) {
  if (n <= 0 || d <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  const long long wanted =
      (static_cast<long long>(n) + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const long long cap = static_cast<long long>(sm_count()) * kBlocksPerSm;
  const int blocks = static_cast<int>(wanted < cap ? wanted : cap);
  const bool vec4 = d % 4 == 0 &&
                    reinterpret_cast<std::uintptr_t>(slab) % 16 == 0 &&
                    reinterpret_cast<std::uintptr_t>(out) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    hot_gather_warp_per_id<true><<<blocks, kThreads, 0, s>>>(ids, slab, out,
                                                             n, h, d);
  } else {
    hot_gather_warp_per_id<false><<<blocks, kThreads, 0, s>>>(ids, slab, out,
                                                              n, h, d);
  }
  return static_cast<int>(cudaGetLastError());
}
