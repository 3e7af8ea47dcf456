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
//  * Every thread moves one 16-byte vector (float4) of one row where the
//    row width D is a multiple of 4 and the pointers are 16-byte aligned
//    (the wrapper checks and says so), else one float.  Neighbouring
//    threads take neighbouring vectors of a row and then the next row, so
//    a warp's accesses are coalesced runs of whole rows (D = 16: 8 rows
//    of 64 bytes per warp; D = 64: 2 rows of 256 bytes).  The TPU kernel's
//    grid fetched one (1, D) block per step with the id prefetched into
//    SMEM; here every thread loads its id itself (the loads of one row's
//    threads hit the same word).
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
//
// Not yet done (later PRs): hiding the id load's latency (one id per
// vector today), a warp per long run in add mode (a run is walked by one
// thread per vector), TMA bulk row copies.
//
// Interface: plain C, launched on the caller's stream, allocates nothing,
// returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 16;   // grid-stride beyond this

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

// V = float4 (W = 4 floats per vector) or float (W = 1); cols = D / W
template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const V* __restrict__ table, const int32_t* __restrict__ ids,
              V* __restrict__ out, int rows, int cols, long long total) {
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const long long i = t / cols;
    const int c = (int)(t - i * cols);
    const int r = clamp_id(ids[i], rows);
    out[t] = table[(size_t)r * cols + c];
  }
}

template <typename V, bool kAdd>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(V* table, const int32_t* __restrict__ ids,
               const V* __restrict__ src, int rows, int cols, int n,
               long long total) {
  for (long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       t < total; t += (long long)gridDim.x * blockDim.x) {
    const int i = (int)(t / cols);
    const int c = (int)(t - (long long)i * cols);
    const int r = clamp_id(ids[i], rows);
    // only the entry that starts a run of equal clamped ids writes
    if (i > 0 && clamp_id(ids[i - 1], rows) == r) continue;
    V* dst = table + (size_t)r * cols + c;
    if (kAdd) {
      V acc = *dst;
      for (int k = i; k < n && clamp_id(ids[k], rows) == r; ++k)
        acc = add(acc, src[(size_t)k * cols + c]);
      *dst = acc;
    } else {
      *dst = src[(size_t)i * cols + c];
    }
  }
}

int grid_for(long long total) {
  long long blocks = (total + kThreads - 1) / kThreads;
  return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

extern "C" int mxt_embedding_gather(const float* table, const int32_t* ids,
                                    float* out, int rows, int D, int n,
                                    int vec, void* stream) {
  if (rows <= 0 || D <= 0 || n < 0 || (vec && D % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    const int cols = D / 4;
    const long long total = (long long)n * cols;
    gather_kernel<float4><<<grid_for(total), kThreads, 0, st>>>(
        reinterpret_cast<const float4*>(table), ids,
        reinterpret_cast<float4*>(out), rows, cols, total);
  } else {
    const long long total = (long long)n * D;
    gather_kernel<float><<<grid_for(total), kThreads, 0, st>>>(
        table, ids, out, rows, D, total);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mxt_embedding_scatter(float* table, const int32_t* ids,
                                     const float* src, int rows, int D,
                                     int n, int add_mode, int vec,
                                     void* stream) {
  if (rows <= 0 || D <= 0 || n < 0 || (vec && D % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    const int cols = D / 4;
    const long long total = (long long)n * cols;
    float4* t4 = reinterpret_cast<float4*>(table);
    const float4* s4 = reinterpret_cast<const float4*>(src);
    if (add_mode)
      scatter_kernel<float4, true><<<grid_for(total), kThreads, 0, st>>>(
          t4, ids, s4, rows, cols, n, total);
    else
      scatter_kernel<float4, false><<<grid_for(total), kThreads, 0, st>>>(
          t4, ids, s4, rows, cols, n, total);
  } else {
    const long long total = (long long)n * D;
    if (add_mode)
      scatter_kernel<float, true><<<grid_for(total), kThreads, 0, st>>>(
          table, ids, src, rows, D, n, total);
    else
      scatter_kernel<float, false><<<grid_for(total), kThreads, 0, st>>>(
          table, ids, src, rows, D, n, total);
  }
  return static_cast<int>(cudaGetLastError());
}
