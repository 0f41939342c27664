// Pull-mode CSR SpMV for PageRank's relaxation, hand-written for Hopper.
//
//   y[v] = sum over e in [indptr[v], indptr[v+1]) of val[e] * x[idx[e]]
//
// over the in-CSR of a graph (int32 ids, float32 values). The rows own the
// edges [indptr[0], indptr[n]); idx and val may run longer (a bucketed
// upload passes its whole edge arrays with the real rows' indptr), and
// neither that count nor anything else is read back to the host.
//
// Replaces csr_spmv_pallas (src/repro/kernels/csr_spmv/csr_spmv.py:78,
// pl.pallas_call at :88). The TPU kernel packs the edge stream on the host
// into 512-row destination tiles padded to the densest tile; after LOrder
// that padding grew the served graph's stream 16 times. Here the rows are
// read as they are.
//
// Bound: bytes. A call must read indptr (4 bytes a row), idx and val (8 a
// real edge) and write y (4 a row). The x[idx] gathers are random; x is one
// float a vertex and stays in the 50 MB L2 (the stream is loaded with an L2
// evict-first policy so that it does not push x out), but every gather
// that misses L1 moves a 32-byte L2 sector for 4 useful bytes, and on the
// served graph that traffic, not HBM, sets the floor (see PERF.md).
//
// The design, balanced and deterministic:
//  * A grid of a fixed number of blocks a SM (csr_spmv_blocks), sized from
//    the SM count alone. The rows' ends and the edges [indptr[0],
//    indptr[n]) form one merged sequence (row r's end comes after its
//    last edge); block b takes the b-th of B equal shares of it, n + E
//    items over B: its edges and the rows that end among them, balanced
//    over edges and rows together. E is read on the device. A
//    block finds where its share starts and ends by a warp-wide 32-ary
//    search in indptr (4 steps at 1M rows).
//  * One thread streams the block's idx and val slices, and the indptr
//    slice of its rows' ends, in chunks of kTile elements into rings of
//    shared memory with 1-D bulk copies (cp.async.bulk) completed on
//    mbarriers. A chunk's copy is widened to 16-byte aligned addresses;
//    the at most 3 elements at either end of an array that no aligned copy
//    can reach are loaded with plain loads, so any 4-byte aligned view is
//    taken.
//  * The block walks its share in steps of kTile items. Every thread takes
//    8 consecutive items of a step: a bit map of the step's row ends (one
//    shared-memory OR per row, in place of a per-thread merge-path search)
//    tells each thread how many rows and edges come before its run and
//    which of its items end a row. So every lane works whatever the
//    degrees: a row of 2,781 edges and a run of empty rows cost the same
//    per item, and no warp walks rows one after another (the warp-per-row
//    kernel this replaced left 66% of its lanes idle on the served graph
//    and walked 118 rows a warp in series).
//  * The products val[e] * x[idx[e]] of a chunk are made in place of its
//    values, lanes on consecutive edges, 8 gathers in flight a thread;
//    the gathers are issued a step before their products are stored, up to
//    two chunks ahead of the walk. A run sums its products in registers,
//    row by row, in edge order.
//  * A row cut between threads is combined by a block-wide segmented scan
//    with a fixed tree (warp shuffles, then the warps' totals in order);
//    a row cut between steps carries its partial sum into the next step.
//  * A row cut between blocks is summed in parts: each block leaves the
//    partial sum of the row still open at its share's end in a workspace,
//    and a second small kernel adds the parts of each such row in block
//    order in front of the part its finishing block wrote.
// No value is added with an atomic, and the order of every sum depends only
// on indptr and the grid size, so a call repeated on the same inputs on the
// same card gives the same bits.
//
// Built by repro_torch/kernels/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and called through ctypes; the C entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 8;                    // merge items a thread a step
constexpr int kTile = kThreads * kItems;     // items a step; elements a chunk
constexpr int kSlots = kTile + 8;            // a chunk widened to 16 bytes
constexpr int kWords = kTile / 32;           // a step's row-end map
constexpr int kWordsPerLane = kWords > 32 ? kWords / 32 : 1;
constexpr int kEdgeStages = 4;               // powers of two
constexpr int kRowStages = 2;
constexpr int kBlocksPerSm = 2;
constexpr int kMaxDevices = 64;

struct __align__(16) Smem {
  int idx[kEdgeStages][kSlots];
  float val[kEdgeStages][kSlots];            // products once a chunk is ready
  int ends[kRowStages][kSlots];
  uint64_t bar[kEdgeStages + kRowStages];
  float warp_val[kWarps];
  int warp_flag[kWarps];
  unsigned bits[2][kWords];     // row ends of a step, by merge position
  int split_r[2], split_e[2];   // the block's first and last merge split
};

constexpr int kSmemBytes = static_cast<int>(sizeof(Smem));
static_assert((kSlots * 4) % 16 == 0, "stages must stay 16-byte aligned");
static_assert(kTile % 4 == 0, "chunks must keep their alignment phase");
static_assert(kItems <= 32 && 32 % kItems == 0, "a run sits in one word");
static_assert(kWords % kWordsPerLane == 0 && kWords <= kThreads &&
                  kWords <= 32 * kWordsPerLane,
              "a step's map is read by one warp");
static_assert((kEdgeStages & (kEdgeStages - 1)) == 0 && kEdgeStages >= 4,
              "products run a chunk ahead of the walk");
static_assert((kRowStages & (kRowStages - 1)) == 0 && kRowStages >= 2,
              "row stages");
static_assert(kSmemBytes * kBlocksPerSm <= 232448, "blocks do not fit an SM");

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

// Spin until the phase of parity `parity` has completed. A copy lands in
// microseconds; a wait of seconds means a copy that was never issued, and
// traps, so that a fault ends the launch with an error instead of a hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    if (spins == (1u << 26)) __trap();
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

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

// `bytes` (a multiple of 16) from 16-byte aligned global `src` to 16-byte
// aligned shared `dst`, counted on `bar`, with an L2 cache policy.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "l"(policy)
      : "memory");
}

// Orders this thread's shared-memory writes before later bulk copies into
// the same bytes.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// One 4-byte array streamed in chunks: chunk c holds the elements
// [first + c kTile, min(first + (c + 1) kTile, last)). A chunk's copy is
// widened to [down(start), up(end)) on the 16-byte grid of addresses and cut
// to [lead, tail), the part of that grid inside the array; element g sits
// at slot g - down(chunk start) of the chunk's stage.
struct Stream {
  const uint32_t* base;
  int first, last;
  int phase;       // (address of element 0 / 4) mod 4
  int lead, tail;  // first and one past the last element of a full copy

  __device__ Stream(const void* p, long long length, int first_, int last_)
      : base(static_cast<const uint32_t*>(p)), first(first_), last(last_) {
    phase = static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
    lead = up(0);
    const long long t = length - ((phase + length) & 3);
    tail = static_cast<int>(t < INT_MAX ? t : INT_MAX - 3);
  }
  __device__ int down(int g) const { return g - ((phase + g) & 3); }
  __device__ int up(int g) const { return g + ((4 - ((phase + g) & 3)) & 3); }
  __device__ int start(int c) const { return first + c * kTile; }
  __device__ int end(int c) const { return min(start(c) + kTile, last); }
  __device__ int chunks() const { return (last - first + kTile - 1) / kTile; }
  // slot offset of the chunk start: the same for every chunk
  __device__ int skew() const { return (phase + first) & 3; }
  // the copied part [lo, hi) of chunk c (empty if hi <= lo)
  __device__ void copied(int c, int& lo, int& hi) const {
    lo = max(down(start(c)), lead);
    hi = min(up(end(c)), tail);
  }
  __device__ uint32_t bytes(int c) const {
    int lo, hi;
    copied(c, lo, hi);
    return hi > lo ? 4u * static_cast<uint32_t>(hi - lo) : 0u;
  }
  __device__ void issue(int c, uint32_t* stage, uint32_t bar,
                        uint64_t policy) const {
    int lo, hi;
    copied(c, lo, hi);
    if (hi > lo) {
      bulk_load(smem_addr(stage + (lo - down(start(c)))), base + lo,
                4u * static_cast<uint32_t>(hi - lo), bar, policy);
    }
  }
  __device__ bool needs_patch(int c) const {
    int lo, hi;
    copied(c, lo, hi);
    return hi <= lo || lo > start(c) || hi < end(c);
  }
  // Plain loads of the elements of chunk c that its copy does not hold.
  __device__ void patch(int c, uint32_t* stage, int tid) const {
    int lo, hi;
    copied(c, lo, hi);
    const int s = start(c), e = end(c), origin = down(s);
    const int head_end = hi > lo ? min(lo, e) : e;
    for (int g = s + tid; g < head_end; g += kThreads) {
      stage[g - origin] = base[g];
    }
    if (hi > lo) {
      for (int g = max(hi, s) + tid; g < e; g += kThreads) {
        stage[g - origin] = base[g];
      }
    }
  }
};

// The merge path's split at diagonal d: how many of its first d items are
// row ends, where the end of row i comes before edge j when
// indptr[i + 1] <= j. A warp-wide 32-ary search: each step probes 32
// points of the interval at once and keeps the part between the last probe
// that is not past the split and the first that is (4 steps at 1M rows).
__device__ int split_rows(const int* __restrict__ indptr, int n, int e0,
                          long long edges, long long d, int lane) {
  // the first i in [a, b) with indptr[i + 1] > e0 + d - 1 - i, else b
  int a = static_cast<int>(d > edges ? d - edges : 0);
  int b = static_cast<int>(d < n ? d : n);
  while (a < b) {
    const int step = (b - a + 31) / 32;
    const int q = a + (lane + 1) * step - 1;
    const bool past =
        q >= b || __ldg(indptr + q + 1) > e0 + (d - 1 - q);
    const unsigned m = __ballot_sync(0xffffffffu, past);
    if (m == 0) {
      a = b;
    } else {
      const int first = __ffs(m) - 1;
      b = min(b, a + (first + 1) * step - 1);
      a += first * step;
    }
  }
  return a;
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
csr_spmv_merge(const int* __restrict__ indptr, const int* __restrict__ idx,
               const float* __restrict__ val, const float* __restrict__ x,
               float* __restrict__ y, float* __restrict__ carry_val,
               int* __restrict__ carry_row, int n, long long edge_slots) {
  // Cast straight from the __shared__ array, so that the compiler keeps
  // every access a shared-memory one (a detour through an integer address
  // turns them into generic loads and the map's ORs into global atomics).
  extern __shared__ __align__(16) uint8_t smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int block = blockIdx.x;
  const int blocks = gridDim.x;
  const uint32_t bar0 = smem_addr(&s.bar[0]);
  const uint32_t rbar0 = bar0 + 8 * kEdgeStages;

  // This block's share of the merge of n row ends and E edges.
  const int e0 = __ldg(indptr);
  const long long edges = static_cast<long long>(__ldg(indptr + n)) - e0;
  const long long total = n + edges;
  if (tid == 0) {
    for (int i = 0; i < kEdgeStages + kRowStages; ++i) {
      mbar_init(bar0 + 8 * i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (warp < 2) {
    const long long d = total * (block + warp) / blocks;
    const int i = split_rows(indptr, n, e0, edges, d, lane);
    if (lane == 0) {
      s.split_r[warp] = i;
      s.split_e[warp] = e0 + static_cast<int>(d - i);
    }
  }
  __syncthreads();
  const int rb = s.split_r[0], re = s.split_r[1];
  const int lo = s.split_e[0], hi = s.split_e[1];
  const Stream sidx(idx, edge_slots, lo, hi);
  const Stream sval(val, edge_slots, lo, hi);
  // row ends: indptr[r + 1] for the rows [rb, re)
  const Stream sends(indptr, static_cast<long long>(n) + 1, rb + 1, re + 1);
  const int edge_chunks = sidx.chunks();
  const int row_chunks = sends.chunks();
  uint64_t policy = 0;
  int edges_issued = 0, rows_issued = 0;
  auto issue_edges = [&](int upto) {
    for (; edges_issued < min(upto, edge_chunks); ++edges_issued) {
      const int c = edges_issued;
      const int st = c & (kEdgeStages - 1);
      const uint32_t bar = bar0 + 8 * st;
      mbar_expect_tx(bar, sidx.bytes(c) + sval.bytes(c));
      sidx.issue(c, reinterpret_cast<uint32_t*>(s.idx[st]), bar, policy);
      sval.issue(c, reinterpret_cast<uint32_t*>(s.val[st]), bar, policy);
    }
  };
  auto issue_rows = [&](int upto) {
    for (; rows_issued < min(upto, row_chunks); ++rows_issued) {
      const int c = rows_issued;
      const int st = c & (kRowStages - 1);
      const uint32_t bar = rbar0 + 8 * st;
      mbar_expect_tx(bar, sends.bytes(c));
      sends.issue(c, reinterpret_cast<uint32_t*>(s.ends[st]), bar, policy);
    }
  };
  if (tid == 0) {
    policy = evict_first_policy();
    issue_edges(kEdgeStages);
    issue_rows(kRowStages);
  }

  const int skew_idx = sidx.skew();
  const int skew_val = sval.skew();
  const int skew_end = sends.skew();
  // shared-memory home of row r's end
  auto row_end = [&](int r) -> int {
    const unsigned rel = static_cast<unsigned>(r - rb);
    return s.ends[(rel / kTile) % kRowStages][rel % kTile + skew_end];
  };

  // Products of edge chunk c: its copy is waited for, the x gathers are
  // issued into registers (gather), and the products are stored over the
  // values later (finish), so that the gathers' latency passes behind a
  // step's walk.
  int col[kItems];
  float w[kItems], xv[kItems];
  auto gather = [&](int c) {
    const int st = c & (kEdgeStages - 1);
    mbar_wait(bar0 + 8 * st, (c / kEdgeStages) & 1);
    if (sidx.needs_patch(c) || sval.needs_patch(c)) {
      sidx.patch(c, reinterpret_cast<uint32_t*>(s.idx[st]), tid);
      sval.patch(c, reinterpret_cast<uint32_t*>(s.val[st]), tid);
      fence_proxy_async();
      __syncthreads();
    }
    const int count = sidx.end(c) - sidx.start(c);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int q = tid + k * kThreads;
      col[k] = q < count ? s.idx[st][q + skew_idx] : 0;
      w[k] = q < count ? s.val[st][q + skew_val] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      xv[k] = tid + k * kThreads < count ? __ldg(x + col[k]) : 0.0f;
    }
  };
  auto finish = [&](int c) {
    const int st = c & (kEdgeStages - 1);
    const int count = sidx.end(c) - sidx.start(c);
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int q = tid + k * kThreads;
      if (q < count) s.val[st][q + skew_val] = w[k] * xv[k];
    }
    fence_proxy_async();
  };

  if (tid < kWords) {
    s.bits[0][tid] = 0u;
    s.bits[1][tid] = 0u;
  }
  __syncthreads();
  int buf = 0;           // which of the two row-end maps this step fills
  int staged = 0;        // edge chunks whose products are in shared memory
  bool pending = false;  // chunk `staged`'s gathers are in w and xv
  int rows_ready = 0;
  int r = rb, e = lo;
  float carry = 0.0f;  // partial sum of row r from the edges before e
  while (r < re || e < hi) {
    const long long left = static_cast<long long>(re - r) + (hi - e);
    const int items = static_cast<int>(left < kTile ? left : kTile);
    const int na = min(items, re - r);
    const int ne = min(items, hi - e);

    // Products for the edges [e, e + ne). The gathers of a chunk are
    // issued a step before its products are stored, and up to two chunks
    // ahead of the walk, so that the walk never waits for them.
    const int need = ne > 0 ? (e + ne - 1 - lo) / kTile : -1;
    if (pending && staged <= need + 1) {
      finish(staged++);
      pending = false;
    }
    for (; staged <= need; ++staged) {
      gather(staged);
      finish(staged);
      __syncthreads();
    }
    if (!pending && staged < edge_chunks && staged <= need + 2) {
      gather(staged);
      pending = true;
    }
    // Row ends for the rows [r, r + na).
    const int rows_need = na > 0 ? (r + na - 1 - rb) / kTile : -1;
    for (; rows_ready <= rows_need; ++rows_ready) {
      const int c = rows_ready;
      const int st = c & (kRowStages - 1);
      mbar_wait(rbar0 + 8 * st, (c / kRowStages) & 1);
      if (sends.needs_patch(c)) {
        sends.patch(c, reinterpret_cast<uint32_t*>(s.ends[st]), tid);
        fence_proxy_async();
        __syncthreads();
      }
    }

    // The step's row ends as bits of their merge positions [0, items):
    // row r + t ends at position t + row_end(r + t) - e.
    unsigned* bits = s.bits[buf];
    for (int t = tid; t < na; t += kThreads) {
      const int pos = t + row_end(r + t) - e;
      if (pos < items) atomicOr(bits + (pos >> 5), 1u << (pos & 31));
    }
    if (tid < kWords) s.bits[buf ^ 1][tid] = 0u;  // the next step's map
    __syncthreads();

    // Row ends before each word, counted by every warp alike.
    unsigned word_bits[kWordsPerLane];
    int count = 0;
#pragma unroll
    for (int q = 0; q < kWordsPerLane; ++q) {
      const int wq = lane * kWordsPerLane + q;
      word_bits[q] = wq < kWords ? bits[wq] : 0u;
      count += __popc(word_bits[q]);
    }
    int rows_upto = count;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, rows_upto, off);
      if (lane >= off) rows_upto += up;
    }
    const int step_rows = __shfl_sync(0xffffffffu, rows_upto, 31);

    // This thread's run: merge items [d0, d0 + run) of the step, their
    // row ends the bits of `marks`.
    const int d0 = tid * kItems;
    const int word = d0 >> 5;
    const int holder = word / kWordsPerLane;
    int i0 = __shfl_sync(0xffffffffu, rows_upto - count, holder);
#pragma unroll
    for (int q = 0; q + 1 < kWordsPerLane; ++q) {
      const int c = __popc(__shfl_sync(0xffffffffu, word_bits[q], holder));
      if (q < word % kWordsPerLane) i0 += c;
    }
    const unsigned w = bits[word];
    i0 += __popc(w & ((1u << (d0 & 31)) - 1u));
    const unsigned marks = (w >> (d0 & 31)) & ((1u << kItems) - 1u);
    const int run = max(0, min(kItems, items - d0));
    const int j = d0 - i0;  // edges of the step before the run
    // The run's edges are consecutive: read their products from two
    // pointers, this chunk's and the next one's.
    const unsigned rel = static_cast<unsigned>(e + j - lo);
    const int at = rel % kTile;
    const int room = kTile - at;  // the run's edges left in this chunk
    const float* here = &s.val[(rel / kTile) % kEdgeStages][at + skew_val];
    const float* next = &s.val[(rel / kTile + 1) % kEdgeStages][skew_val];
    float p[kItems];
#pragma unroll
    for (int k = 0, o = 0; k < kItems; ++k) {
      const bool edge = k < run && !((marks >> k) & 1u);
      p[k] = edge ? (o < room ? here[o] : next[o - room]) : 0.0f;
      o += edge;
    }
    float sum = 0.0f, head = 0.0f;
    bool closed = false;  // has this run finished a row?
    float* out = y + r + i0;
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      if ((marks >> k) & 1u) {
        if (closed) *out = sum;
        head = closed ? head : sum;
        closed = true;
        sum = 0.0f;
        ++out;
      } else {
        sum += p[k];
      }
    }

    // Segmented scan of the runs' open partial sums; a run that finished a
    // row starts a segment. Warps first, then the warps' totals in order,
    // seeded with the carry into the step. `flags` holds the lanes that
    // start a segment; v covers the lanes back to the nearest of them.
    const unsigned flags = __ballot_sync(0xffffffffu, closed);
    const unsigned upto = 0xffffffffu >> (31 - lane);  // lanes 0..lane
    float v = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float pv = __shfl_up_sync(0xffffffffu, v, off);
      const unsigned window = lane >= off ? upto & ~(upto >> off) : upto;
      if (lane >= off && !(flags & window)) v = pv + v;
    }
    if (lane == 31) {
      s.warp_val[warp] = v;
      s.warp_flag[warp] = flags != 0u;
    }
    __syncthreads();
    float before = carry, after = carry;
#pragma unroll
    for (int wp = 0; wp < kWarps; ++wp) {
      const float wv = s.warp_val[wp];
      after = s.warp_flag[wp] ? wv : after + wv;
      if (wp + 1 == warp) before = after;
    }
    const float lv = __shfl_up_sync(0xffffffffu, v, 1);
    const bool lf = (flags & (upto >> 1)) != 0u;   // a flag in lanes 0..lane-1
    const float carry_in = lane == 0 ? before : (lf ? lv : before + lv);
    if (closed) {
      y[r + i0] = carry_in + head;
    }
    r += step_rows;
    e += items - step_rows;
    carry = after;
    buf ^= 1;

    // Refill the stages whose chunks lie wholly behind (r, e).
    if (tid == 0) {
      issue_edges((e - lo) / kTile + kEdgeStages);
      issue_rows((r - rb) / kTile + kRowStages);
    }
  }
  if (tid == 0) {
    carry_val[block] = carry;  // the part of row re in this block's edges
    carry_row[block] = re;
  }
}

// Rows cut between blocks: for each row that some block left open, add the
// parts of the blocks that carried it, in block order, in front of the part
// its finishing block wrote. One warp a row; its lanes load 32 parts at a
// time and the sum runs through them in order.
__global__ void __launch_bounds__(256)
csr_spmv_carries(const float* __restrict__ carry_val,
                 const int* __restrict__ carry_row, float* __restrict__ y,
                 int n, int blocks) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x / 32);
  for (int b = (blockIdx.x * blockDim.x + threadIdx.x) / 32; b < blocks;
       b += warps) {
    const int row = carry_row[b];
    if (row >= n || (b > 0 && carry_row[b - 1] == row)) continue;
    float total = 0.0f;
    for (int k0 = b;; k0 += 32) {
      const int k = k0 + lane;
      const bool mine = k < blocks && carry_row[k] == row;
      const float part = mine ? carry_val[k] : 0.0f;
      const unsigned m = __ballot_sync(0xffffffffu, mine);
      for (int l = 0; l < 32; ++l) {
        const float p = __shfl_sync(0xffffffffu, part, l);
        if ((m >> l) & 1u) total += p;
      }
      if (m != 0xffffffffu) break;
    }
    if (lane == 0) y[row] = total + y[row];
  }
}

int sm_count(int dev) {
  static int counts[kMaxDevices] = {};
  int* known = dev >= 0 && dev < kMaxDevices ? &counts[dev] : nullptr;
  if (known != nullptr && *known > 0) return *known;
  int c = 0;
  cudaDeviceGetAttribute(&c, cudaDevAttrMultiProcessorCount, dev);
  c = c > 0 ? c : 1;
  if (known != nullptr) *known = c;
  return c;
}

}  // namespace

// Blocks of the kernel's grid on card `dev`: the workspace holds one
// partial sum and one row id for each.
extern "C" int csr_spmv_blocks(int dev) {
  return sm_count(dev) * kBlocksPerSm;
}

// Dynamic shared memory a block of the main kernel takes, in bytes.
extern "C" int csr_spmv_smem_bytes() { return kSmemBytes; }

// y = the product over the n rows of indptr; edge_slots is the length of
// idx and val (at least indptr[n]). carry_val and carry_row hold `blocks`
// entries each, blocks = csr_spmv_blocks(current device); their contents
// need not be set.
extern "C" int csr_spmv_f32(const int* indptr, const int* idx,
                            const float* val, const float* x, float* y,
                            float* carry_val, int* carry_row, int n,
                            long long edge_slots, int blocks, void* stream) {
  if (n <= 0) {
    return static_cast<int>(cudaSuccess);
  }
  static bool opted_in[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= kMaxDevices || !opted_in[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        csr_spmv_merge, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (err != cudaSuccess) {
      return static_cast<int>(err);
    }
    if (dev >= 0 && dev < kMaxDevices) opted_in[dev] = true;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  csr_spmv_merge<<<blocks, kThreads, kSmemBytes, st>>>(
      indptr, idx, val, x, y, carry_val, carry_row, n, edge_slots);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    return static_cast<int>(err);
  }
  csr_spmv_carries<<<(blocks + 7) / 8, 256, 0, st>>>(carry_val, carry_row, y,
                                                    n, blocks);
  return static_cast<int>(cudaGetLastError());
}
