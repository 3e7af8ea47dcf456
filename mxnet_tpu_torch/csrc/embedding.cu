// Embedding row gather and sorted-id row scatter for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/sparse/kernels.py
//   embedding_gather  (_gather_kernel / _gather_pallas, the pallas_call
//                      at :117): out[i, :] = table[ids[i], :];
//   embedding_scatter (_scatter_kernel / _scatter_pallas, the pallas_call
//                      at :175): rows applied to the table at sorted ids,
//                      in place, "add" or "set".
// Both run at the table's dtype, as the TPU kernels do (out_shape at
// table.dtype, :119; rows cast to table.dtype, :182): float32, and
// bfloat16, float16 and float64 tables.
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
//  * A gather is a copy, so it moves bytes: a segment's descriptor gives
//    its row width in bytes and the vector it moves them in (16, 8, 4 or
//    2 bytes: the largest that divides the row's bytes and both
//    pointers, which the wrapper picks).  One launch so covers tables of
//    any dtype together, e.g. bf16 tables with their float32 momentum
//    rows in a recommender update.  Every thread moves one such vector
//    (float32 at D % 4 == 0 and 16-byte aligned: one float4, as before
//    the dtypes were added).  Neighbouring threads take neighbouring
//    vectors of a row and then the next row, so a warp's accesses are
//    coalesced runs of whole rows (f32 D = 16: 8 rows of 64 bytes per
//    warp; D = 64: 2 rows of 256 bytes).  One (row, vector) unit per
//    thread: two units per thread (half the blocks) ran the bench shape's
//    lookup 9.5% slower alone.  The TPU kernel's grid fetched one (1, D)
//    block per step with the id prefetched into SMEM; here every thread
//    loads its id itself (the loads of one row's threads hit the same
//    word).  The scatter's threads are laid out the same way.
//  * Ids are clamped into [0, rows): an id out of range never reads or
//    writes out of bounds.  Callers clip, as the TPU kernel's caller does.
//  * The scatter gives each touched table row exactly one owner, so it
//    needs no atomics and its result does not depend on the order in
//    which blocks run.  The ids are sorted, so equal (clamped) ids form
//    runs; the entry that starts a run owns that row.  In "set" mode it
//    copies its own payload's bytes (first write wins, as in the TPU
//    kernel); in "add" mode it writes t + r_i + r_{i+1} + ... over the
//    run, in the TPU kernel's order and in the table's dtype, rounded
//    after every add: bf16 and f16 lanes are added in float32 and rounded
//    back to their type after each add, which is how the reference's
//    16-bit adds round (an f32 sum of two such values rounds to the same
//    16-bit value as their exact sum); float32 and float64 add natively.
//    An f32 accumulator rounded once at the end would be another result.
//    The add moves 16-byte vectors where the row's bytes and both
//    pointers allow, else one element per thread.  The other entries of
//    a run write nothing.  A pad (id >= rows) is clamped onto the last
//    row: when it follows a real update of that row it joins that run
//    and changes nothing, and a run of pads alone writes its own no-op
//    payload (the caller's contract).
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

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;   // grid-stride beyond this
constexpr int kScatterThreads = 128;   // 129 blocks at the bench shape
constexpr int kBatch = 4;              // payload rows per run loaded together
constexpr int kGatherChunk = kThreads;   // gather work units per block
#if CUDART_VERSION >= 12010
constexpr int kMaxGatherSegs = 680;    // 8 + 680 * 48 <= 32,764 bytes
#else
constexpr int kMaxGatherSegs = 80;     // 8 + 80 * 48 <= 4,096 bytes
#endif

// the table dtypes of the scatter's C entry (the wrapper's codes)
enum Dtype { kF32 = 0, kF16 = 1, kBF16 = 2, kF64 = 3 };

__device__ __forceinline__ int clamp_id(int32_t id, int rows) {
  return id < 0 ? 0 : (id >= rows ? rows - 1 : id);
}

// an unsigned type of B bytes: what a thread loads and stores
template <int B> struct RawOf;
template <> struct RawOf<16> { using T = uint4; };
template <> struct RawOf<8> { using T = uint2; };
template <> struct RawOf<4> { using T = unsigned int; };
template <> struct RawOf<2> { using T = unsigned short; };

// one add in the table's dtype, rounded to it
__device__ __forceinline__ float add1(float a, float b) { return a + b; }
__device__ __forceinline__ double add1(double a, double b) { return a + b; }
__device__ __forceinline__ __half add1(__half a, __half b) {
  return __float2half_rn(__half2float(a) + __half2float(b));
}
__device__ __forceinline__ __nv_bfloat16 add1(__nv_bfloat16 a,
                                              __nv_bfloat16 b) {
  return __float2bfloat16_rn(__bfloat162float(a) + __bfloat162float(b));
}

// L lanes of T moved as one Raw vector and added lane by lane
template <typename T, int L>
struct Lanes {
  using Raw = typename RawOf<(int)sizeof(T) * L>::T;
  __device__ static __forceinline__ Raw add(Raw a, Raw b) {
    T x[L], y[L];
    memcpy(x, &a, sizeof(Raw));
    memcpy(y, &b, sizeof(Raw));
#pragma unroll
    for (int k = 0; k < L; ++k) x[k] = add1(x[k], y[k]);
    Raw r;
    memcpy(&r, x, sizeof(Raw));
    return r;
  }
};

// a byte copy of B-byte vectors (set mode: no add is made)
template <int B>
struct Bytes {
  using Raw = typename RawOf<B>::T;
  __device__ static __forceinline__ Raw add(Raw a, Raw) { return a; }
};

// one gather segment as the kernel reads it (48 bytes): out (n, row) =
// table (rows, row)[ids (n,)], a row being cols vectors of vbytes bytes
struct GatherSeg {
  const unsigned char* table;
  const int32_t* ids;
  unsigned char* out;
  int rows;
  int cols;
  int n;
  int vbytes;
  int first_block;
  int pad;
};

template <int kCap>
struct GatherBatch {
  int count;
  int pad;
  GatherSeg seg[kCap];
};

// R is the vector type (16, 8, 4 or 2 bytes).  Work unit t of a segment
// is (entry t / cols, vector t % cols): neighbouring threads on
// neighbouring vectors of a row, then the next row.
template <typename R>
__device__ __forceinline__ void gather_one(
    const R* __restrict__ table, const int32_t* __restrict__ ids,
    R* __restrict__ out, int rows, int cols, long long total, long long t) {
  if (t >= total) return;
  const long long i = t / cols;
  const int c = (int)(t - i * cols);
  out[t] = table[(long long)clamp_id(ids[i], rows) * cols + c];
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
  const long long t =
      (long long)(blk - s.first_block) * kGatherChunk + threadIdx.x;
  switch (s.vbytes) {
    case 16:
      gather_one<uint4>(reinterpret_cast<const uint4*>(s.table), s.ids,
                        reinterpret_cast<uint4*>(s.out), s.rows, s.cols,
                        total, t);
      break;
    case 8:
      gather_one<uint2>(reinterpret_cast<const uint2*>(s.table), s.ids,
                        reinterpret_cast<uint2*>(s.out), s.rows, s.cols,
                        total, t);
      break;
    case 4:
      gather_one<unsigned int>(
          reinterpret_cast<const unsigned int*>(s.table), s.ids,
          reinterpret_cast<unsigned int*>(s.out), s.rows, s.cols, total, t);
      break;
    default:
      gather_one<unsigned short>(
          reinterpret_cast<const unsigned short*>(s.table), s.ids,
          reinterpret_cast<unsigned short*>(s.out), s.rows, s.cols, total,
          t);
  }
}

// One thread per (entry, vector).  Round 1 issues every load that needs
// no id: the entry's id, its neighbours' and its own payload.  A thread
// whose entry starts a run then issues round 2 (add mode): the table row,
// and where the run goes on, its next kBatch payloads and ids together.
// A is Lanes<T, L> (add) or Bytes<B> (set); R its vector type.
template <typename A, bool kAdd>
__global__ void __launch_bounds__(kScatterThreads)
scatter_kernel(typename A::Raw* table, const int32_t* __restrict__ ids,
               const typename A::Raw* __restrict__ src, int rows, int cols,
               int n, long long total) {
  using R = typename A::Raw;
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const int i = (int)(t / cols);
    const int c = (int)(t - (long long)i * cols);
    const int r = clamp_id(ids[i], rows);
    const int prev = i > 0 ? clamp_id(ids[i - 1], rows) : -1;
    const int next = i + 1 < n ? clamp_id(ids[i + 1], rows) : -1;
    const R first = src[(size_t)i * cols + c];
    if (prev == r) continue;         // the run's first entry writes
    R* dst = table + (size_t)r * cols + c;
    if (!kAdd) {
      *dst = first;
      continue;
    }
    const R row = *dst;
    R pay[kBatch];
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
    R acc = A::add(row, first);
    while (more) {
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        if (more) {
          acc = A::add(acc, pay[k]);
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

template <typename A, bool kAdd>
int launch_scatter(void* table, const int32_t* ids, const void* src,
                   int rows, int cols, int n, cudaStream_t st) {
  using R = typename A::Raw;
  const long long total = (long long)n * cols;
  const long long blocks = (total + kScatterThreads - 1) / kScatterThreads;
  const int grid = (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  scatter_kernel<A, kAdd><<<grid, kScatterThreads, 0, st>>>(
      static_cast<R*>(table), ids, static_cast<const R*>(src), rows, cols,
      n, total);
  return static_cast<int>(cudaGetLastError());
}

// the add in dtype T over vectors of 16 bytes (vec) or single elements
template <typename T>
int launch_add(void* table, const int32_t* ids, const void* src, int rows,
               int row_bytes, int n, int vbytes, cudaStream_t st) {
  constexpr int kL = 16 / (int)sizeof(T);
  if (vbytes == 16)
    return launch_scatter<Lanes<T, kL>, true>(table, ids, src, rows,
                                              row_bytes / 16, n, st);
  if (vbytes == (int)sizeof(T))
    return launch_scatter<Lanes<T, 1>, true>(table, ids, src, rows,
                                             row_bytes / vbytes, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
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

bool vector_bytes(long long v) {
  return v == 2 || v == 4 || v == 8 || v == 16;
}

}  // namespace

extern "C" int mxt_embedding_segments_per_launch() {
  return kMaxGatherSegs;
}

// one segment as the caller passes it: seven 64-bit words (table, ids,
// out, rows, row bytes, n, vector bytes); zero-length segments are the
// caller's to leave out
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
      const long long rows = d[3], row_bytes = d[4], n = d[5], vb = d[6];
      if (rows <= 0 || rows > 0x7fffffffLL || row_bytes <= 0
          || n <= 0 || n > 0x7fffffffLL || !vector_bytes(vb)
          || row_bytes % vb || row_bytes / vb > 0x7fffffffLL)
        return static_cast<int>(cudaErrorInvalidValue);
      GatherSeg& s = segs[i];
      s.table = reinterpret_cast<const unsigned char*>(d[0]);
      s.ids = reinterpret_cast<const int32_t*>(d[1]);
      s.out = reinterpret_cast<unsigned char*>(d[2]);
      s.rows = (int)rows;
      s.cols = (int)(row_bytes / vb);
      s.n = (int)n;
      s.vbytes = (int)vb;
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

// table (rows, D) of dtype (0 float32, 1 float16, 2 bfloat16, 3
// float64), src (n, D) of the same dtype; vbytes: the vector a thread
// moves (set: 2, 4, 8 or 16 dividing the row's bytes; add: 16 or the
// element's size)
extern "C" int mxt_embedding_scatter(void* table, const int32_t* ids,
                                     const void* src, int rows, int D,
                                     int n, int add_mode, int dtype,
                                     int vbytes, void* stream) {
  static const int kSize[] = {4, 2, 2, 8};
  if (rows <= 0 || D <= 0 || n < 0 || dtype < 0 || dtype > 3
      || !vector_bytes(vbytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long row_bytes = (long long)D * kSize[dtype];
  if (row_bytes % vbytes || row_bytes / vbytes > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rb = (int)row_bytes;
  if (!add_mode) {
    const int cols = rb / vbytes;
    switch (vbytes) {
      case 16: return launch_scatter<Bytes<16>, false>(table, ids, src, rows,
                                                       cols, n, st);
      case 8: return launch_scatter<Bytes<8>, false>(table, ids, src, rows,
                                                     cols, n, st);
      case 4: return launch_scatter<Bytes<4>, false>(table, ids, src, rows,
                                                     cols, n, st);
      default: return launch_scatter<Bytes<2>, false>(table, ids, src, rows,
                                                      cols, n, st);
    }
  }
  switch (dtype) {
    case kF32: return launch_add<float>(table, ids, src, rows, rb, n,
                                        vbytes, st);
    case kF16: return launch_add<__half>(table, ids, src, rows, rb, n,
                                         vbytes, st);
    case kBF16: return launch_add<__nv_bfloat16>(table, ids, src, rows, rb,
                                                 n, vbytes, st);
    default: return launch_add<double>(table, ids, src, rows, rb, n,
                                       vbytes, st);
  }
}
