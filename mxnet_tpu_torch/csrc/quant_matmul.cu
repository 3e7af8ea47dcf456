// Weight-only quantized matmul for Hopper (sm_90a): y = x @ dequant(qw).T
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py quant_matmul
//   (_quant_matmul_kernel, the pallas_call at :776), int8 and packed int4.
//
// What it computes: x (M, K) f32; qw (N, K) int8, or (N, ceil(K/2)) uint8
// holding two signed nibbles per byte (low nibble = even k, values in
// [-7, 7], quantize_weight's layout); scales (N,) f32;
//   y[m, n] = scales[n] * sum_k x[m, k] * w_int[n, k]
// accumulated in f32, with the per-row scale applied once at the end as
// the TPU kernel does (:728).
//
// What bounds it on the H100: bytes.  In decode M is the slot count (8),
// so each weight byte feeds 2*M = 16 flops (int8) or 32 (int4); the
// weight stream N*K*bits/8 dominates, and the least time is
// (N*K*bits/8 + 4N + 4MK + 4MN) bytes over 3.35 TB/s.
//
// What the design does about it:
//  * Weights are read once, as stored (1 or 0.5 byte per value), and
//    dequantized in registers: the f32 weights never exist in device
//    memory, which is the whole point of the TPU kernel too.
//  * One warp per output column n; its 32 lanes read the weight row as
//    4-byte words, 128 contiguous bytes per warp access, four accesses in
//    flight per lane per 512-byte chunk.
//  * The x tile of the chunk (up to 8 rows) is staged in shared memory
//    once per block, with all of a thread's loads issued together, and
//    reused by the block's 8 columns; lanes read it as float4
//    (conflict-free for int8, two-way for int4).
//  * int4 nibbles are sign-extended in registers (values above 7 minus
//    16, as _unpack_int4 does).
//
// Not yet done (later PRs): tensor-core dequant-GEMM for large M, split-K
// for the narrow 768-column shapes (96 blocks on 132 SMs), TMA staging.
//
// Interface: plain C, launched on the caller's stream, allocates nothing,
// returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;        // output columns per block
constexpr int kRows = 8;         // rows of x per block (grid.y tiles M)
constexpr int kChunkBytes = 512; // weight bytes per row per chunk
constexpr int kWordsPerLane = kChunkBytes / (32 * 4);

__device__ __forceinline__ float nibble(uint32_t v) {
  const int q = static_cast<int>(v & 0xFu);
  return static_cast<float>(q > 7 ? q - 16 : q);
}

// acc[m] += sum_j w_j * xs[m][kk + j] over one 4-byte weight word
template <int BITS>
__device__ __forceinline__ void accumulate_word(uint32_t wv, int kk,
                                                const float* xs, float* acc) {
  constexpr int kChunkK = kChunkBytes * (BITS == 8 ? 1 : 2);
  if (BITS == 8) {
    float w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = static_cast<float>(static_cast<int8_t>((wv >> (8 * j)) & 0xFFu));
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const float4 a = *reinterpret_cast<const float4*>(xs + m * kChunkK + kk);
      float t = acc[m];
      t = fmaf(w[0], a.x, t);
      t = fmaf(w[1], a.y, t);
      t = fmaf(w[2], a.z, t);
      t = fmaf(w[3], a.w, t);
      acc[m] = t;
    }
  } else {
    float w[8];   // byte j holds k = 2j (low nibble) and 2j + 1 (high)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      w[2 * j] = nibble(wv >> (8 * j));
      w[2 * j + 1] = nibble(wv >> (8 * j + 4));
    }
#pragma unroll
    for (int m = 0; m < kRows; ++m) {
      const float4* p = reinterpret_cast<const float4*>(xs + m * kChunkK + 2 * kk);
      const float4 a = p[0], b = p[1];
      float t = acc[m];
      t = fmaf(w[0], a.x, t);
      t = fmaf(w[1], a.y, t);
      t = fmaf(w[2], a.z, t);
      t = fmaf(w[3], a.w, t);
      t = fmaf(w[4], b.x, t);
      t = fmaf(w[5], b.y, t);
      t = fmaf(w[6], b.z, t);
      t = fmaf(w[7], b.w, t);
      acc[m] = t;
    }
  }
}

template <int BITS>
__global__ void __launch_bounds__(kWarps * 32)
quant_matmul_kernel(const float* __restrict__ x,
                    const uint8_t* __restrict__ qw,
                    const float* __restrict__ scales,
                    float* __restrict__ out, int M, int N, int K,
                    int row_bytes, int vec, int xvec) {
  constexpr int kPerByte = BITS == 8 ? 1 : 2;
  constexpr int kChunkK = kChunkBytes * kPerByte;
  constexpr int kTile = kRows * kChunkK;
  constexpr int kThreads = kWarps * 32;
  __shared__ __align__(16) float xs[kTile];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * kWarps + warp;
  const int m0 = blockIdx.y * kRows;
  const uint8_t* wrow = qw + (size_t)(n < N ? n : 0) * row_bytes;

  float acc[kRows];
#pragma unroll
  for (int m = 0; m < kRows; ++m) acc[m] = 0.f;

  for (int c0 = 0; c0 < row_bytes; c0 += kChunkBytes) {
    const int k0 = c0 * kPerByte;
    // stage x[m0:m0+8, k0:k0+kChunkK] (zero-padded); the loops have
    // constant trip counts and unroll, so every thread's loads are in
    // flight together instead of one latency each
    if (xvec) {          // K % 4 == 0 and x 16-byte aligned: float4 rows
#pragma unroll
      for (int it = 0; it < kTile / (4 * kThreads); ++it) {
        const int e = (it * kThreads + threadIdx.x) * 4;
        const int m = e / kChunkK, kk = e % kChunkK;
        const int gm = m0 + m, gk = k0 + kk;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gm < M && gk < K)
          v = __ldg(reinterpret_cast<const float4*>(x + (size_t)gm * K + gk));
        *reinterpret_cast<float4*>(xs + e) = v;
      }
    } else {
#pragma unroll 8
      for (int it = 0; it < kTile / kThreads; ++it) {
        const int e = it * kThreads + threadIdx.x;
        const int m = e / kChunkK, kk = e % kChunkK;
        const int gm = m0 + m, gk = k0 + kk;
        xs[e] = (gm < M && gk < K) ? __ldg(x + (size_t)gm * K + gk) : 0.f;
      }
    }
    __syncthreads();
    if (n < N) {
      uint32_t words[kWordsPerLane];
#pragma unroll
      for (int i = 0; i < kWordsPerLane; ++i) {
        const int b = c0 + i * 128 + lane * 4;
        uint32_t wv = 0;
        if (vec && b + 4 <= row_bytes) {
          wv = __ldg(reinterpret_cast<const unsigned int*>(wrow + b));
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (b + j < row_bytes) wv |= static_cast<uint32_t>(wrow[b + j]) << (8 * j);
        }
        words[i] = wv;
      }
#pragma unroll
      for (int i = 0; i < kWordsPerLane; ++i)   // byte offset in the chunk
        accumulate_word<BITS>(words[i], i * 128 + lane * 4, xs, acc);
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < kRows; ++m) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      acc[m] += __shfl_xor_sync(0xffffffffu, acc[m], off);
  }
  if (lane == 0 && n < N) {
    const float sc = scales[n];
#pragma unroll
    for (int m = 0; m < kRows; ++m)
      if (m0 + m < M) out[(size_t)(m0 + m) * N + n] = acc[m] * sc;
  }
}

}  // namespace

extern "C" int mxt_quant_matmul(const float* x, const uint8_t* qw,
                                const float* scales, float* out, int M,
                                int N, int K, int bits, int vec, int xvec,
                                void* stream) {
  const dim3 grid((N + kWarps - 1) / kWarps, (M + kRows - 1) / kRows);
  const dim3 block(kWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 8) {
    quant_matmul_kernel<8><<<grid, block, 0, st>>>(x, qw, scales, out, M, N,
                                                   K, K, vec, xvec);
  } else if (bits == 4) {
    quant_matmul_kernel<4><<<grid, block, 0, st>>>(x, qw, scales, out, M, N,
                                                   K, (K + 1) / 2, vec, xvec);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
