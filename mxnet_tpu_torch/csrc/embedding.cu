// Embedding row gather and sorted-id row scatter for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/sparse/kernels.py
//   embedding_gather  (_gather_kernel / _gather_pallas, the pallas_call
//                      at :117): out[i, :] = table[ids[i], :];
//   embedding_scatter (_scatter_kernel / _scatter_pallas, the pallas_call
//                      at :175): rows applied to the table at sorted ids,
//                      in place, "add" or "set".
//
// What bounds it on the H100: bytes.  Both kernels move whole rows and do at
// most one add per element, far below the ~20 flop/byte at which the
// f32 pipes would be the limit.  Gather reads n ids and n rows and writes
// n rows; scatter reads n ids and n payload rows, reads the touched table
// rows (add mode) and writes them.  The least time is those bytes over
// 3.35 TB/s.
//
// What the design does about it:
//  * The gather is one launch over many (table, ids, out) segments: every
//    table's lookup of a recommender step in one launch, and every
//    table's weight and momentum rows of its update in another (26 and
//    52 segments at a Criteo shape, where one launch per table and use
//    cost more than the 4.2 MB each moves).  The C entry takes a host
//    array of segment descriptors and passes up to kMaxGatherSegs of them
//    BY VALUE in the kernel's parameters (a __grid_constant__ struct:
//    CUDA >= 12.1 takes 32,764 bytes of them, 680 segments; older
//    toolkits 4 KB, 80): no copy to the device, no allocation, no host
//    sync.  Each block takes a fixed run of kGatherChunk (row, vector)
//    work units of one segment and finds its segment by a binary search
//    over the segments' first blocks.  Segments may differ in D, rows
//    and alignment.
//  * Every thread moves 16-byte vectors (float4) of rows where the
//    segment's row width D is a multiple of 4 and its table and out are
//    16-byte aligned (the wrapper checks and says so), else single
//    floats.  Neighbouring threads take neighbouring vectors of a row and
//    then the next row, so a warp's accesses are coalesced runs of whole
//    rows (D = 16: 8 rows of 64 bytes per warp; D = 64: 2 rows of 256
//    bytes).  Each thread moves one (row, vector) unit, as the one-table
//    kernel before it did: two units per thread (half the blocks) ran the
//    bench shape's lookup 9.5% slower alone.  The TPU kernel's grid
//    fetched one (1, D)
//    block per step with the id prefetched into SMEM; here every thread
//    loads its id itself (the loads of one row's threads hit the same
//    word).  The scatter's threads are laid out the same way.
//  * Ids are clamped into [0, rows): an id out of range never reads or
//    writes out of bounds.  Callers clip, as the TPU kernel's caller does.
//  * The scatter gives each touched table row exactly one owner, so it
//    needs no atomics and its result does not depend on the order in
//    which blocks run.  The ids are sorted, so equal (clamped) ids form
//    runs; the entry that starts a run owns that row.  In "set" mode it
//    writes its own payload (first write wins, as in the TPU kernel); in
//    "add" mode it writes t + r_i + r_{i+1} + ... over the run, in the
//    TPU kernel's order.  The other entries of a run write nothing.  A
//    pad (id >= rows) is clamped onto the last row: when it follows a real
//    update of that row it joins that run and changes nothing, and a run
//    of pads alone writes its own no-op payload (the caller's contract).
//  * The scatter hides its latency in at most two rounds of loads.  One
//    thread per (entry, vector): round 1 issues every load that needs no
//    id together, the entry's id, its neighbours' ids and its own payload,
//    so a set-mode owner writes after one round trip.  In add mode the
//    owner's round 2 issues the table row with, where the run goes on,
//    its next four payloads and ids.  Blocks of 128 threads put the
//    recommender's 4096 ids at D 16 on 129 SMs.  (A warp-ballot design,
//    one warp listing a block's runs in shared memory, tied index_add_:
//    the barrier and the shared-memory hop sat between the two rounds.)
//
// Not yet done (later PRs): the scatter as one launch over many tables
// (it is one launch per table and use: 52 per Criteo step); TMA bulk row
// copies; a run longer than five entries costs one more round of loads
// per four entries.
//
// Interface: plain C, launched on the caller's stream, allocates nothing,
// returns cudaGetLastError() of the launches (the first that failed).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;   // grid-stride beyond this
constexpr int kScatterThreads = 128;   // 129 blocks at the bench shape
constexpr int kBatch = 4;              // payload rows per run loaded together
constexpr int kGatherItems = 1;        // gather work units per thread
constexpr int kGatherChunk = kThreads * kGatherItems;   // per block
#if CUDART_VERSION >= 12010
constexpr int kMaxGatherSegs = 680;    // 8 + 680 * 48 <= 32,764 bytes
#else
constexpr int kMaxGatherSegs = 80;     // 8 + 80 * 48 <= 4,096 bytes
#endif

__device__ __forceinline__ int clamp_id(int32_t id, int rows) {
  return id < 0 ? 0 : (id >= rows ? rows - 1 : id);
}

template <typename V>
__device__ __forceinline__ V add(V a, V b);

template <>
__device__ __forceinline__ float add<float>(float a, float b) {
  return a + b;
}

template <>
__device__ __forceinline__ float4 add<float4>(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// one gather segment as the kernel reads it (48 bytes): out (n, D) =
// table (rows, D)[ids (n,)], in vectors of W floats (cols = D / W)
struct GatherSeg {
  const float* table;
  const int32_t* ids;
  float* out;
  int rows;
  int cols;
  int n;
  int vec;
  int first_block;
  int pad;
};

template <int kCap>
struct GatherBatch {
  int count;
  int pad;
  GatherSeg seg[kCap];
};

// V = float4 (W = 4 floats per vector) or float (W = 1).  Work unit t of
// a segment is (entry t / cols, vector t % cols); the thread's units are
// t0, t0 + kThreads, ...: neighbouring threads on neighbouring vectors of
// a row, then the next row.  Every id is loaded, then every row vector,
// then every store.
template <typename V>
__device__ __forceinline__ void gather_chunk(
    const V* __restrict__ table, const int32_t* __restrict__ ids,
    V* __restrict__ out, int rows, int cols, long long total,
    long long t0) {
  long long off[kGatherItems];
#pragma unroll
  for (int k = 0; k < kGatherItems; ++k) {
    const long long t = t0 + (long long)k * kThreads;
    if (t < total) {
      const long long i = t / cols;
      const int c = (int)(t - i * cols);
      off[k] = (long long)clamp_id(ids[i], rows) * cols + c;
    }
  }
  V v[kGatherItems];
#pragma unroll
  for (int k = 0; k < kGatherItems; ++k) {
    const long long t = t0 + (long long)k * kThreads;
    if (t < total) v[k] = table[off[k]];
  }
#pragma unroll
  for (int k = 0; k < kGatherItems; ++k) {
    const long long t = t0 + (long long)k * kThreads;
    if (t < total) out[t] = v[k];
  }
}

// one block per kGatherChunk work units of one segment; the block finds
// its segment by a binary search over the segments' first blocks
template <int kCap>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const __grid_constant__ GatherBatch<kCap> b) {
  const int blk = blockIdx.x;
  int lo = 0, hi = b.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (b.seg[mid].first_block <= blk) lo = mid; else hi = mid - 1;
  }
  const GatherSeg& s = b.seg[lo];
  const long long total = (long long)s.n * s.cols;
  const long long t0 =
      (long long)(blk - s.first_block) * kGatherChunk + threadIdx.x;
  if (s.vec)
    gather_chunk<float4>(reinterpret_cast<const float4*>(s.table), s.ids,
                         reinterpret_cast<float4*>(s.out), s.rows, s.cols,
                         total, t0);
  else
    gather_chunk<float>(s.table, s.ids, s.out, s.rows, s.cols, total, t0);
}

// One thread per (entry, column).  Round 1 issues every load that needs
// no id: the entry's id, its neighbours' and its own payload.  A thread
// whose entry starts a run then issues round 2 (add mode): the table row,
// and where the run goes on, its next kBatch payloads and ids together.
template <typename V, bool kAdd>
__global__ void __launch_bounds__(kScatterThreads)
scatter_kernel(V* table, const int32_t* __restrict__ ids,
               const V* __restrict__ src, int rows, int cols, int n,
               long long total) {
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const int i = (int)(t / cols);
    const int c = (int)(t - (long long)i * cols);
    const int r = clamp_id(ids[i], rows);
    const int prev = i > 0 ? clamp_id(ids[i - 1], rows) : -1;
    const int next = i + 1 < n ? clamp_id(ids[i + 1], rows) : -1;
    const V first = src[(size_t)i * cols + c];
    if (prev == r) continue;         // the run's first entry writes
    V* dst = table + (size_t)r * cols + c;
    if (!kAdd) {
      *dst = first;
      continue;
    }
    const V row = *dst;
    V pay[kBatch];
    int nid[kBatch];
    int e = i + 1;                   // the next entry of the run
    bool more = next == r;
    if (more) {
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        pay[k] = src[(size_t)min(e + k, n - 1) * cols + c];
        nid[k] = e + k + 1 < n ? clamp_id(ids[e + k + 1], rows) : -1;
      }
    }
    V acc = add(row, first);
    while (more) {
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (more) {
          acc = add(acc, pay[k]);
          more = nid[k] == r;
        }
      }
      e += kBatch;
      if (more) {
#pragma unroll
        for (int k = 0; k < kBatch; ++k) {
          pay[k] = src[(size_t)min(e + k, n - 1) * cols + c];
          nid[k] = e + k + 1 < n ? clamp_id(ids[e + k + 1], rows) : -1;
        }
      }
    }
    *dst = acc;
  }
}

// launch one GatherBatch<kCap> over segs[0, count) (count <= kCap)
template <int kCap>
int launch_gather(const GatherSeg* segs, int count, cudaStream_t st) {
  GatherBatch<kCap> b;
  b.count = count;
  b.pad = 0;
  long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    b.seg[i] = segs[i];
    b.seg[i].first_block = (int)blocks;
    blocks += ((long long)segs[i].n * segs[i].cols + kGatherChunk - 1)
              / kGatherChunk;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  }
  gather_kernel<kCap><<<(unsigned)blocks, kThreads, 0, st>>>(b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int mxt_embedding_segments_per_launch() {
  return kMaxGatherSegs;
}

// one segment as the caller passes it: seven 64-bit words (table, ids,
// out, rows, D, n, vec); zero-length segments are the caller's to leave
// out
extern "C" int mxt_embedding_gather_many(const long long* desc, int count,
                                         void* stream) {
  if (count < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  GatherSeg segs[kMaxGatherSegs];
  for (int done = 0; done < count;) {
    const int m = count - done < kMaxGatherSegs ? count - done
                                                : kMaxGatherSegs;
    for (int i = 0; i < m; ++i) {
      const long long* d = desc + 7LL * (done + i);
      const long long rows = d[3], D = d[4], n = d[5];
      const int vec = (int)d[6];
      if (rows <= 0 || rows > 0x7fffffffLL || D <= 0 || D > 0x7fffffffLL
          || n <= 0 || n > 0x7fffffffLL || (vec && D % 4))
        return static_cast<int>(cudaErrorInvalidValue);
      GatherSeg& s = segs[i];
      s.table = reinterpret_cast<const float*>(d[0]);
      s.ids = reinterpret_cast<const int32_t*>(d[1]);
      s.out = reinterpret_cast<float*>(d[2]);
      s.rows = (int)rows;
      s.cols = (int)(vec ? D / 4 : D);
      s.n = (int)n;
      s.vec = vec;
      s.first_block = 0;
      s.pad = 0;
    }
    // the smallest parameter struct that holds the batch
    const int rc = m <= 1 ? launch_gather<1>(segs, m, st)
                 : m <= 16 ? launch_gather<16>(segs, m, st)
                 : launch_gather<kMaxGatherSegs>(segs, m, st);
    if (rc) return rc;
    done += m;
  }
  return 0;
}

extern "C" int mxt_embedding_scatter(float* table, const int32_t* ids,
                                     const float* src, int rows, int D,
                                     int n, int add_mode, int vec,
                                     void* stream) {
  if (rows <= 0 || D <= 0 || n < 0 || (vec && D % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int cols = vec ? D / 4 : D;
  const long long total = (long long)n * cols;
  const long long blocks = (total + kScatterThreads - 1) / kScatterThreads;
  const int grid = (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  if (vec) {
    float4* t4 = reinterpret_cast<float4*>(table);
    const float4* s4 = reinterpret_cast<const float4*>(src);
    if (add_mode)
      scatter_kernel<float4, true><<<grid, kScatterThreads, 0, st>>>(
          t4, ids, s4, rows, cols, n, total);
    else
      scatter_kernel<float4, false><<<grid, kScatterThreads, 0, st>>>(
          t4, ids, s4, rows, cols, n, total);
  } else {
    if (add_mode)
      scatter_kernel<float, true><<<grid, kScatterThreads, 0, st>>>(
          table, ids, src, rows, cols, n, total);
    else
      scatter_kernel<float, false><<<grid, kScatterThreads, 0, st>>>(
          table, ids, src, rows, cols, n, total);
  }
  return static_cast<int>(cudaGetLastError());
}
