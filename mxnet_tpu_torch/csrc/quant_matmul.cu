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
//  * Tensor cores, swapped: y^T = w x^T, so a 16 x 8 tile of weights
//    (16 output columns, 8 k) is the A operand of
//    mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 and 8 rows of x
//    are the B operand (grid.y tiles M by 8).  The integer weights
//    (|w| <= 127) are exact in TF32, so splitting x alone into a TF32 big
//    and small part (big = x with the 13 mantissa bits below TF32 cleared,
//    small = x - big) keeps about 21 bits of each product in two MMAs
//    (x_small.w, then x_big.w, into two accumulators): the accuracy of the
//    flash kernels' 3xTF32.  1xTF32 is never used.
//  * Weights are read once, as stored, with one 16-byte (int8) or 8-byte
//    (int4) streaming load per lane per row and 64-k chunk, the next
//    chunk's loads in flight while the current one computes, and
//    dequantized in registers without int-to-float conversions: a byte
//    (int8 ^ 0x80, or a nibble ^ 8) is placed under the exponent of 2^23
//    by one byte permute, and one subtraction of 2^23 + 128 (or + 8)
//    leaves the integer exactly.  The f32 weights never exist in memory.
//  * Each lane's 16 k of a chunk are contiguous (k = 16t .. 16t + 15 of
//    the chunk for lane t of its quad), the same k for its weight rows
//    and its x row: MMA depth t is k 16t + 2s and depth t + 4 is
//    16t + 2s + 1 at step s.  x is read from global memory through L1
//    (four 16-byte loads per chunk, shared by the block's warps), not
//    staged in shared memory.
//  * One warp per 16 output columns; for narrow N the block's 8 warps
//    split K into ks slices (1, 2, 4 or 8, chosen so the grid has at
//    least one block per SM where K allows) and sum their partial tiles
//    through shared memory in slice order: no atomics, the same bits on
//    every run.
//
// Interface: plain C, launched on the caller's stream, allocates nothing,
// returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;     // warps per block, 16 output columns each
constexpr int kRows = 8;      // rows of x per block: the MMA's n
constexpr int kChunk = 64;    // k per chunk: 16 per lane of a quad

__device__ __forceinline__ float tf32_big(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// this lane's 16 weights of one row for one chunk, as stored: 16 bytes
// (int8) or 8 bytes (int4, w[0..1]); zero past the row and past N
template <int BITS>
__device__ __forceinline__ uint4 load_w(const uint8_t* qw, int row, int N,
                                        int row_bytes, int c, int t,
                                        int vec) {
  constexpr int kLaneBytes = BITS == 8 ? 16 : 8;
  uint4 r = make_uint4(0u, 0u, 0u, 0u);
  if (row >= N) return r;
  const int b0 = c * (kChunk * BITS / 8) + t * kLaneBytes;
  const uint8_t* p = qw + (size_t)row * row_bytes + b0;
  if (vec && b0 + kLaneBytes <= row_bytes) {
    if (BITS == 8) {
      r = __ldcs(reinterpret_cast<const uint4*>(p));
    } else {
      const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p));
      r.x = v.x;
      r.y = v.y;
    }
    return r;
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < kLaneBytes; ++j)
    if (b0 + j < row_bytes)
      w[j >> 2] |= static_cast<uint32_t>(p[j]) << (8 * (j & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// this lane's 16 values of x row m for one chunk (k = 16t .. 16t + 15 of
// it); zero past M and past K
__device__ __forceinline__ void load_x(float (&xs)[16], const float* x,
                                       int m, int M, int K, int c, int t,
                                       int xvec) {
  const int k0 = c * kChunk + 16 * t;
  const float* p = x + (size_t)m * K + k0;
  if (m < M && xvec && k0 + 16 <= K) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p) + i);
      xs[4 * i] = v.x;
      xs[4 * i + 1] = v.y;
      xs[4 * i + 2] = v.z;
      xs[4 * i + 3] = v.w;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 16; ++e)
    xs[e] = (m < M && k0 + e < K) ? __ldg(p + e) : 0.f;
}

// byte `sel` of `u` as the f32 2^23 + byte (an exact TF32 operand once
// the bias is subtracted)
__device__ __forceinline__ float biased(uint32_t u, int sel) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | sel));
}

// dequantized weights e = 2s and 2s + 1 of one row (its 16 k of the
// chunk), from the biased words: int8 words hold byte ^ 0x80; int4 words
// are (lo, hi) = the low and high nibbles ^ 8 of each byte, one per byte
template <int BITS>
__device__ __forceinline__ void weight_pair(const uint4& b, const uint4& hi4,
                                            int s, float& w0, float& w1) {
  if (BITS == 8) {
    const uint32_t word = (&b.x)[s >> 1];
    w0 = biased(word, (2 * s) & 3) - 8388736.f;       // 2^23 + 128
    w1 = biased(word, (2 * s + 1) & 3) - 8388736.f;
  } else {
    w0 = biased((&b.x)[s >> 2], s & 3) - 8388616.f;   // 2^23 + 8
    w1 = biased((&hi4.x)[s >> 2], s & 3) - 8388616.f;
  }
}

template <int BITS>
__device__ __forceinline__ void bias_words(const uint4& w, uint4& lo,
                                           uint4& hi) {
  if (BITS == 8) {
    lo = make_uint4(w.x ^ 0x80808080u, w.y ^ 0x80808080u,
                    w.z ^ 0x80808080u, w.w ^ 0x80808080u);
  } else {
    const uint32_t a = w.x ^ 0x88888888u, b = w.y ^ 0x88888888u;
    lo = make_uint4(a & 0x0F0F0F0Fu, b & 0x0F0F0F0Fu, 0u, 0u);
    hi = make_uint4((a >> 4) & 0x0F0F0F0Fu, (b >> 4) & 0x0F0F0F0Fu, 0u, 0u);
  }
}

// acc += the chunk's products: weight rows g and g + 8 of the warp's
// tile against x row g, 8 depth steps, x_small then x_big into two fresh
// accumulators added to acc in f32 (the tensor core truncates as it adds
// into an accumulator; a chunk's 8 MMAs into a fresh one, then a rounded
// add, keep that bias from growing with K)
template <int BITS>
__device__ __forceinline__ void mma_chunk(float (&acc)[4],
                                          const uint4 (&w)[2],
                                          const float (&xs)[16]) {
  float acc_lo[4] = {0.f, 0.f, 0.f, 0.f}, acc_hi[4] = {0.f, 0.f, 0.f, 0.f};
  uint4 lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) bias_words<BITS>(w[r], lo[r], hi[r]);
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    const float b0 = tf32_big(xs[2 * s]), b1 = tf32_big(xs[2 * s + 1]);
    float w00, w01, w10, w11;   // (row g | g + 8, depth t | t + 4)
    weight_pair<BITS>(lo[0], hi[0], s, w00, w01);
    weight_pair<BITS>(lo[1], hi[1], s, w10, w11);
    const uint32_t a[4] = {__float_as_uint(w00), __float_as_uint(w10),
                           __float_as_uint(w01), __float_as_uint(w11)};
    mma_tf32(acc_lo, a, __float_as_uint(xs[2 * s] - b0),
             __float_as_uint(xs[2 * s + 1] - b1));
    mma_tf32(acc_hi, a, __float_as_uint(b0), __float_as_uint(b1));
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += acc_lo[e] + acc_hi[e];
}

template <int BITS>
__global__ void __launch_bounds__(kWarps * 32, 2)
quant_matmul_kernel(const float* __restrict__ x,
                    const uint8_t* __restrict__ qw,
                    const float* __restrict__ scales,
                    float* __restrict__ out, int M, int N, int K,
                    int row_bytes, int vec, int xvec, int ks) {
  __shared__ float part[kWarps][4][32];

  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int warp = threadIdx.x >> 5;
  const int ng = kWarps / ks;               // column tiles of the block
  const int grp = warp % ng;
  const int slice = warp / ng;              // this warp's k slice
  const int n0 = (blockIdx.x * ng + grp) * 16;
  const int m = blockIdx.y * kRows + g;     // x row of this lane
  const int nchunks = (K + kChunk - 1) / kChunk;

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  uint4 w[2];
  float xs[16];
  int c = slice;
  if (c < nchunks) {
#pragma unroll
    for (int r = 0; r < 2; ++r)
      w[r] = load_w<BITS>(qw, n0 + g + 8 * r, N, row_bytes, c, t, vec);
    load_x(xs, x, m, M, K, c, t, xvec);
  }
  for (; c < nchunks; c += ks) {
    // the next chunk's loads fly while this one computes
    uint4 wn[2];
    float xn[16];
    const int cn = c + ks;
    if (cn < nchunks) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        wn[r] = load_w<BITS>(qw, n0 + g + 8 * r, N, row_bytes, cn, t, vec);
      load_x(xn, x, m, M, K, cn, t, xvec);
    }
    mma_chunk<BITS>(acc, w, xs);
#pragma unroll
    for (int r = 0; r < 2; ++r) w[r] = wn[r];
#pragma unroll
    for (int e = 0; e < 16; ++e) xs[e] = xn[e];
  }

  // partial tiles of the k slices, summed in slice order by slice 0
#pragma unroll
  for (int e = 0; e < 4; ++e) part[warp][e][lane] = acc[e];
  __syncthreads();
  if (slice != 0) return;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float sum = part[grp][e][lane];
    for (int sl = 1; sl < ks; ++sl) sum += part[sl * ng + grp][e][lane];
    // C fragment: y^T row g (+8) is output column n, column 2t (+1) row m
    const int n = n0 + g + 8 * (e >> 1);
    const int mm = blockIdx.y * kRows + 2 * t + (e & 1);
    if (n < N && mm < M) out[(size_t)mm * N + n] = sum * scales[n];
  }
}

// k slices: the fewest that give at least one block per SM, at most 8
// and at most half the chunks
int k_slices(int M, int N, int K) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 132;
  }
  const int nchunks = (K + kChunk - 1) / kChunk;
  const long long mtiles = (M + kRows - 1) / kRows;
  int ks = 1;
  while (ks < kWarps && nchunks >= 2 * ks) {
    const long long cols = 16LL * (kWarps / ks);
    if ((N + cols - 1) / cols * mtiles >= sms) break;
    ks *= 2;
  }
  return ks;
}

}  // namespace

extern "C" int mxt_quant_matmul(const float* x, const uint8_t* qw,
                                const float* scales, float* out, int M,
                                int N, int K, int bits, int vec, int xvec,
                                void* stream) {
  if (bits != 8 && bits != 4) return static_cast<int>(cudaErrorInvalidValue);
  const int ks = k_slices(M, N, K);
  const int cols = 16 * (kWarps / ks);
  const dim3 grid((N + cols - 1) / cols, (M + kRows - 1) / kRows);
  const dim3 block(kWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bits == 8) {
    quant_matmul_kernel<8><<<grid, block, 0, st>>>(x, qw, scales, out, M, N,
                                                   K, K, vec, xvec, ks);
  } else {
    quant_matmul_kernel<4><<<grid, block, 0, st>>>(
        x, qw, scales, out, M, N, K, (K + 1) / 2, vec, xvec, ks);
  }
  return static_cast<int>(cudaGetLastError());
}
