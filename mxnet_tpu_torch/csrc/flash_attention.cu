// Flash attention for Hopper (sm_90a): the forward with the row
// logsumexp, and the recompute-free backward as two kernels (dQ; dK/dV).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py
//   B1  forward   _flash_kernel (:173) / _flash_call (:231), the
//                 pallas_call at :250, via fused_attention (:270) and
//                 fused_attention_fwd (:300);
//   B2a dQ        _flash_bwd_dq_kernel (:322), the pallas_call at :448;
//   B2b dK/dV     _flash_bwd_dkv_kernel (:366), the pallas_call at :468;
//                 both in fused_attention_bwd (:417).
//
// What they compute, on (B, T, H, D) tensors read in place (row t of head
// h of batch b at ((b*T + t)*H + h)*D, so the FC -> Reshape output needs
// no transpose), with s = q.k * scale and, under `causal`, s = -1e30
// where q_idx < k_idx (absolute indices, as the TPU kernels):
//   forward  out = softmax(s) v, and optionally
//            lse[b*H + h, t] = m + log(max(l, 1e-37)) of the scaled logits;
//   dQ       dq = sum_k ds k,            ds = p (dp - delta) scale,
//   dK/dV    dk = sum_q ds^T q,  dv = sum_q p^T dO,
//   with p = exp(s - lse) rebuilt from the saved logsumexp (never the
//   forward again), dp = dO v^T, and delta = rowsum(dO * out) given by the
//   caller, (B*H, Tq) f32 like lse.
//
// What bounds it on the H100, each of the three: operations.  At the
// training shape (B8 T1024 H12 D64, causal) the forward does
// 4*BH*T^2*D/2 = 12.9 GFLOP on 113 MB of inputs and outputs: about 115
// flop/byte, far above the ~20 flop/byte at which the f32 pipes
// (67 TFLOP/s) rather than memory (3.35 TB/s) are the limit.  dQ does 6
// and dK/dV 8 of those units.
//
// What the design does about it (a first, simple version in f32 FMA; the
// tensor cores, wgmma and TMA are later work):
//  * One block per (b*h, 64-row tile) -- q tiles for the forward and dQ,
//    k tiles for dK/dV.  A loop inside the block replaces the TPU's
//    sequential grid axis: the forward and dQ walk k tiles up to the
//    diagonal, dK/dV walks q tiles from the diagonal.  Every output tile
//    has one owner, so there are no atomics and the result is
//    deterministic.  Causal blocks are issued heaviest first.
//  * 256 threads as 16 x 16; thread (ty, tx) owns rows ty + 16i and
//    columns tx + 16j (i, j < 4) of each 64 x 64 score tile, and columns
//    tx + 16j of the output rows it owns, so each operand read from
//    shared memory feeds four FMAs.  Tiles live in shared memory with a
//    row stride of D_pad + 1 floats, so both row and column walks are
//    free of bank conflicts; a row's max and sum reduce over its 16
//    threads with shuffles inside the half-warp.
//  * The online softmax (running max, sum and accumulator) stays in
//    registers for the whole k loop.
//  * Ragged edges: tiles are zero-filled past T and past D, columns past
//    Tk get p = 0 explicitly, and rows past Tq are never written, so the
//    result does not depend on the tile.
//  * Shared memory is above 48 KB (66 KB forward, 83 KB dQ, 100 KB dK/dV
//    at D = 64), so each launch first raises the kernel's dynamic shared
//    memory limit with cudaFuncSetAttribute.
//
// Interface: plain C, launched on the caller's stream, allocates nothing,
// f32 only, D <= 128; returns the first CUDA error (attribute or launch).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;          // rows of a q tile and of a k tile
constexpr int kThreads = 256;   // 16 x 16
constexpr int kLdS = kB + 1;    // row stride of a 64 x 64 score tile
constexpr float kNegBig = -1e30f;

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Rows [t0, t0 + 64) of head h, batch b of a (B, T, H, D) tensor into a
// 64 x (DP + 1) shared tile, zero past T and past D.  Consecutive threads
// take consecutive d: one coalesced read per row.
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int b, int h, int t0, int T,
                                          int H, int D) {
  constexpr int LD = DP + 1;
  for (int idx = threadIdx.x; idx < kB * DP; idx += kThreads) {
    const int r = idx / DP;
    const int d = idx % DP;
    const int t = t0 + r;
    float x = 0.f;
    if (t < T && d < D) x = src[((size_t)(b * T + t) * H + h) * D + d];
    dst[r * LD + d] = x;
  }
}

// 64 values of a (B*H, T) row vector (lse or delta), zero past T.
__device__ __forceinline__ void load_row(float* dst, const float* src,
                                         int bh, int t0, int T) {
  for (int r = threadIdx.x; r < kB; r += kThreads) {
    const int t = t0 + r;
    dst[r] = t < T ? src[(size_t)bh * T + t] : 0.f;
  }
}

// acc[i][j] += sum_{d < D} A[ty + 16i][d] * Bt[tx + 16j][d]: a 4 x 4 block
// of a (64 x D) (64 x D)^T product of two shared tiles.
template <int LD>
__device__ __forceinline__ void dot_rows(float (&acc)[4][4], const float* A,
                                         const float* Bt, int D, int ty,
                                         int tx) {
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = Bt[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
  }
}

// acc[i][j] += sum_{c < 64} P[ty + 16i][c] * M[c][tx + 16j]: the rows this
// thread owns of a (64 x 64) score tile times a (64 x D) shared tile.
template <int DP>
__device__ __forceinline__ void mul_tile(float (&acc)[4][DP / 16],
                                         const float* P, const float* M,
                                         int ty, int tx) {
  constexpr int LD = DP + 1;
  constexpr int NJ = DP / 16;
#pragma unroll 4
  for (int c = 0; c < kB; ++c) {
    float p[4], m[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(ty + 16 * i) * kLdS + c];
#pragma unroll
    for (int j = 0; j < NJ; ++j) m[j] = M[c * LD + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(p[i], m[j], acc[i][j]);
  }
}

// Store the rows this thread owns of a (64 x D) tile to a (B, T, H, D)
// tensor, rows below T and columns below D only.
template <int DP>
__device__ __forceinline__ void store_rows(float* dst,
                                           const float (&acc)[4][DP / 16],
                                           int b, int h, int t0, int T,
                                           int H, int D, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + ty + 16 * i;
    if (t >= T) continue;
    float* row = dst + ((size_t)(b * T + t) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DP / 16; ++j) {
      const int d = tx + 16 * j;
      if (d < D) row[d] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------------------
// B1: forward
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int H, int Tq, int Tk, int D,
                 int causal, float scale) {
  constexpr int LD = DP + 1;
  constexpr int NJ = DP / 16;
  extern __shared__ float smem[];
  float* sQ = smem;               // 64 x LD
  float* sK = sQ + kB * LD;       // 64 x LD
  float* sV = sK + kB * LD;       // 64 x LD
  float* sP = sV + kB * LD;       // 64 x kLdS

  const int nq = gridDim.x;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kB;   // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<DP>(sQ, q, b, h, q0, Tq, H, D);

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegBig;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  // causal: keys past the tile's last row are masked for all its rows
  const int k_end = causal ? min(Tk, q0 + kB) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += kB) {
    __syncthreads();              // the last tile's readers are done
    load_tile<DP>(sK, k, b, h, k0, Tk, H, D);
    load_tile<DP>(sV, v, b, h, k0, Tk, H, D);
    __syncthreads();

    float s[4][4] = {};
    dot_rows<LD>(s, sQ, sK, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = kNegBig;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if ((causal && qi < kj) || kj >= Tk) x = kNegBig;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = k0 + tx + 16 * j < Tk ? expf(s[i][j] - m_new) : 0.f;
        s[i][j] = p;
        rs += p;
      }
      l[i] = l[i] * corr + half_warp_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sP[(ty + 16 * i) * kLdS + tx + 16 * j] = s[i][j];
    }
    __syncthreads();
    mul_tile<DP>(acc, sP, sV, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = acc[i][j] / l[i];
    const int t = q0 + ty + 16 * i;
    if (lse != nullptr && tx == 0 && t < Tq)
      lse[(size_t)bh * Tq + t] = m[i] + logf(fmaxf(l[i], 1e-37f));
  }
  store_rows<DP>(out, acc, b, h, q0, Tq, H, D, ty, tx);
}

// ---------------------------------------------------------------------------
// B2a: dQ
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int Tq, int Tk, int D, int causal, float scale) {
  constexpr int LD = DP + 1;
  constexpr int NJ = DP / 16;
  extern __shared__ float smem[];
  float* sQ = smem;               // 64 x LD
  float* sO = sQ + kB * LD;       // dO, 64 x LD
  float* sK = sO + kB * LD;       // 64 x LD
  float* sV = sK + kB * LD;       // 64 x LD
  float* sS = sV + kB * LD;       // ds, 64 x kLdS
  float* sL = sS + kB * kLdS;     // lse, 64
  float* sD = sL + kB;            // delta, 64

  const int nq = gridDim.x;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kB;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<DP>(sQ, q, b, h, q0, Tq, H, D);
  load_tile<DP>(sO, dout, b, h, q0, Tq, H, D);
  load_row(sL, lse, bh, q0, Tq);
  load_row(sD, delta, bh, q0, Tq);

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int k_end = causal ? min(Tk, q0 + kB) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += kB) {
    __syncthreads();
    load_tile<DP>(sK, k, b, h, k0, Tk, H, D);
    load_tile<DP>(sV, v, b, h, k0, Tk, H, D);
    __syncthreads();

    float s[4][4] = {};
    float dp[4][4] = {};
    dot_rows<LD>(s, sQ, sK, D, ty, tx);
    dot_rows<LD>(dp, sO, sV, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (causal && qi < kj) x = kNegBig;
        const float p = kj < Tk ? expf(x - sL[r]) : 0.f;
        sS[r * kLdS + tx + 16 * j] = p * (dp[i][j] - sD[r]) * scale;
      }
    }
    __syncthreads();
    mul_tile<DP>(acc, sS, sK, ty, tx);
  }
  store_rows<DP>(dq, acc, b, h, q0, Tq, H, D, ty, tx);
}

// ---------------------------------------------------------------------------
// B2b: dK and dV
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int H,
                     int Tq, int Tk, int D, int causal, float scale) {
  constexpr int LD = DP + 1;
  constexpr int NJ = DP / 16;
  extern __shared__ float smem[];
  float* sK = smem;               // 64 x LD, this block's keys
  float* sV = sK + kB * LD;       // 64 x LD
  float* sQ = sV + kB * LD;       // 64 x LD, the current q tile
  float* sO = sQ + kB * LD;       // dO, 64 x LD
  float* sP = sO + kB * LD;       // p^T, 64 (k) x kLdS (q)
  float* sS = sP + kB * kLdS;     // ds^T, 64 (k) x kLdS (q)
  float* sL = sS + kB * kLdS;     // lse of the q tile, 64
  float* sD = sL + kB;            // delta of the q tile, 64

  // causal: early k tiles have the most q tiles to visit, so they go first
  const int k0 = (int)blockIdx.x * kB;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile<DP>(sK, k, b, h, k0, Tk, H, D);
  load_tile<DP>(sV, v, b, h, k0, Tk, H, D);

  float ak[4][NJ], av[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) ak[i][j] = av[i][j] = 0.f;

  // causal: q rows below k0 see none of these keys
  const int q_begin = causal ? (k0 / kB) * kB : 0;
  for (int q0 = q_begin; q0 < Tq; q0 += kB) {
    __syncthreads();
    load_tile<DP>(sQ, q, b, h, q0, Tq, H, D);
    load_tile<DP>(sO, dout, b, h, q0, Tq, H, D);
    load_row(sL, lse, bh, q0, Tq);
    load_row(sD, delta, bh, q0, Tq);
    __syncthreads();

    // transposed scores: this thread owns keys ty + 16i, queries tx + 16j
    float st[4][4] = {};
    float dpt[4][4] = {};
    dot_rows<LD>(st, sK, sQ, D, ty, tx);
    dot_rows<LD>(dpt, sV, sO, D, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int kj = k0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int qi = q0 + c;
        float x = st[i][j] * scale;
        if (causal && qi < kj) x = kNegBig;
        const float p = qi < Tq ? expf(x - sL[c]) : 0.f;
        sP[r * kLdS + c] = p;
        sS[r * kLdS + c] = p * (dpt[i][j] - sD[c]) * scale;
      }
    }
    __syncthreads();
    mul_tile<DP>(av, sP, sO, ty, tx);
    mul_tile<DP>(ak, sS, sQ, ty, tx);
  }
  store_rows<DP>(dk, ak, b, h, k0, Tk, H, D, ty, tx);
  store_rows<DP>(dv, av, b, h, k0, Tk, H, D, ty, tx);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename Kernel>
cudaError_t prepare(Kernel kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int DP>
int launch_fwd(const float* q, const float* k, const float* v, float* out,
               float* lse, int B, int H, int Tq, int Tk, int D, int causal,
               float scale, cudaStream_t st) {
  const size_t smem = sizeof(float) * (3 * kB * (DP + 1) + kB * kLdS);
  cudaError_t rc = prepare(flash_fwd_kernel<DP>, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((Tq + kB - 1) / kB, B * H);
  flash_fwd_kernel<DP><<<grid, kThreads, smem, st>>>(q, k, v, out, lse, H,
                                                     Tq, Tk, D, causal,
                                                     scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* delta,
              float* dq, int B, int H, int Tq, int Tk, int D, int causal,
              float scale, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (4 * kB * (DP + 1) + kB * kLdS + 2 * kB);
  cudaError_t rc = prepare(flash_bwd_dq_kernel<DP>, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((Tq + kB - 1) / kB, B * H);
  flash_bwd_dq_kernel<DP><<<grid, kThreads, smem, st>>>(
      q, k, v, dout, lse, delta, dq, H, Tq, Tk, D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* delta,
               float* dk, float* dv, int B, int H, int Tq, int Tk, int D,
               int causal, float scale, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * (4 * kB * (DP + 1) + 2 * kB * kLdS + 2 * kB);
  cudaError_t rc = prepare(flash_bwd_dkv_kernel<DP>, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((Tk + kB - 1) / kB, B * H);
  flash_bwd_dkv_kernel<DP><<<grid, kThreads, smem, st>>>(
      q, k, v, dout, lse, delta, dk, dv, H, Tq, Tk, D, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int H, int Tq, int Tk, int D) {
  return B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 128 ||
         (long long)B * H > 65535;
}

}  // namespace

// out (B, Tq, H, D); lse (B*H, Tq) or null (then it is not written).
extern "C" int mxt_flash_attention_fwd(const float* q, const float* k,
                                       const float* v, float* out,
                                       float* lse, int B, int H, int Tq,
                                       int Tk, int D, int causal,
                                       float scale, void* stream) {
  if (bad_shape(B, H, Tq, Tk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return launch_fwd<32>(q, k, v, out, lse, B, H, Tq, Tk, D, causal, scale,
                          st);
  if (D <= 64)
    return launch_fwd<64>(q, k, v, out, lse, B, H, Tq, Tk, D, causal, scale,
                          st);
  return launch_fwd<128>(q, k, v, out, lse, B, H, Tq, Tk, D, causal, scale,
                         st);
}

extern "C" int mxt_flash_attention_bwd_dq(const float* q, const float* k,
                                          const float* v, const float* dout,
                                          const float* lse,
                                          const float* delta, float* dq,
                                          int B, int H, int Tq, int Tk, int D,
                                          int causal, float scale,
                                          void* stream) {
  if (bad_shape(B, H, Tq, Tk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return launch_dq<32>(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, D,
                         causal, scale, st);
  if (D <= 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, D,
                         causal, scale, st);
  return launch_dq<128>(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, D,
                        causal, scale, st);
}

extern "C" int mxt_flash_attention_bwd_dkv(const float* q, const float* k,
                                           const float* v, const float* dout,
                                           const float* lse,
                                           const float* delta, float* dk,
                                           float* dv, int B, int H, int Tq,
                                           int Tk, int D, int causal,
                                           float scale, void* stream) {
  if (bad_shape(B, H, Tq, Tk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, D,
                          causal, scale, st);
  if (D <= 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, D,
                          causal, scale, st);
  return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, D,
                         causal, scale, st);
}
