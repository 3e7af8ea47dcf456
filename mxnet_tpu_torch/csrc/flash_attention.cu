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
// What the design does about it, common to the three:
//  * One block per (b*h, 64-row tile) -- q tiles for the forward and dQ,
//    k tiles for dK/dV.  A loop inside the block replaces the TPU's
//    sequential grid axis: the forward and dQ walk k tiles up to the
//    diagonal, dK/dV walks q tiles from the diagonal.  Every output tile
//    has one owner, so there are no atomics and the result is the same
//    bits on every run.  Causal blocks are issued heaviest first.
//    (Fusing dQ into the dK/dV kernel would do 10 rather than 14 units of
//    2*D flops per (q, k) pair, but dQ would then be summed over k tiles
//    with atomics, in an order that changes from run to run.)
//  * Ragged edges: tiles are zero-filled past T and past D, columns past
//    Tk (rows past Tq in dK/dV) get p = 0 explicitly, and rows past Tq
//    are never written, so the result does not depend on the tile.
//    Causal masking is on absolute indices (-1e30 in the forward, p = 0
//    in the backward), so Tq != Tk works.
//  * D <= 128 through templates at DP in {32, 64, 128}; a D between them
//    is zero-padded to DP.  Shared memory is above 48 KB, so each launch
//    first raises the kernel's dynamic shared memory limit.
//
// B1, the forward: a first, simple version in f32 FMA.  256 threads as
// 16 x 16; thread (ty, tx) owns rows ty + 16i and columns tx + 16j
// (i, j < 4) of each 64 x 64 score tile, so each operand read from shared
// memory feeds four FMAs; the online softmax stays in registers; tiles
// have a row stride of D_pad + 1 floats (66 KB at D = 64).  Its tensor
// core version is later work.
//
// B2a (dQ) and B2b (dK/dV): tensor cores in 3xTF32, f32-accurate.  The
// f32 FMA pipes (67 TFLOP/s) need about 4 FMAs per shared-memory load to
// stay busy, and the FMA kernels these replace reached 2 (3.6-3.8x their
// f32 bound).  Every product -- s = q k^T, dp = dO v^T, dq = ds k,
// dk = ds^T q, dv = p^T dO -- goes through
// mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 instead.  Each f32
// operand x is split into big = x with the 13 mantissa bits below TF32
// cleared and small = x - big (exact), and a.b is accumulated in f32 as
// a_big.b_small + a_small.b_big + a_big.b_big (the small terms first):
// three MMAs per product, which keep about 21 bits of each product, near
// f32 and far from the 11 of one TF32 product.  1xTF32 is never used.
// (This is the f32 path of PyTorch's memory-efficient attention,
// CUTLASS's OpMultiplyAddFastF32, here in inline PTX, so the build stays
// one nvcc per source with a plain C interface.  Clearing bits rather than
// cvt.rna costs one instruction, not several, and ptxas drops it for the
// big operand, whose low bits the MMA ignores.)
//  * 128 threads, 4 warps; warp w owns rows 16w..16w+15 of the block's
//    64-row tile (q rows for dQ, k rows for dK/dV).  dK/dV computes the
//    transposed scores s^T = k q^T, so p^T and ds^T come out with keys as
//    rows and are A operands directly.
//  * Resident A operands (q and dO for dQ, k and v for dK/dV) are copied
//    once per block into fragment order (a_slot): a lane loads its A
//    fragment with one 128-bit load.  Their depth order pairs columns 2t
//    and 2t + 1, which the B operand of q k^T (rows of k) reads as one
//    64-bit load.
//  * Streamed B operands (k and v tiles for dQ; q, dO, lse and delta for
//    dK/dV) come in 32-row tiles: cp.async fetches the next tile into a
//    staging buffer while the current one computes, and one pass splits
//    it into big and small tiles of row stride DP + 8 (8 mod 32) that
//    every warp reads without splitting: 64-bit loads along rows (words
//    8g + 2t) and 32-bit loads down columns (words 8t + g), both free of
//    bank conflicts.
//  * The MMAs of one depth step go in three passes over 8 independent
//    accumulators: three MMAs into one accumulator back to back would
//    each wait out the tensor core's latency.
//  * The p / ds tile between two products goes through shared memory (row
//    stride 40): the MMA's C fragment (lane holds rows g, g+8, cols 2t,
//    2t+1) is not its A fragment (rows g, g+8, cols t, t+4).  Each warp
//    writes and reads back only its own 16 rows, so a __syncwarp
//    suffices.
//  * exp as ex2.approx (about 2 ulp) with log2 e folded into the scale and
//    the saved lse; masking by select, with no branch per element.
//  * At D = 64 a block takes 96 KB (dQ) or 107 KB (dK/dV) of shared memory
//    and 223 / 245 registers (no spills), so two blocks share an SM; at
//    DP = 128, 255 registers with 8 bytes of spills and one block.
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
constexpr float kLog2e = 1.4426950408889634f;

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
// 3xTF32 tensor-core products (B2a, B2b)
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 128;   // 4 warps, 16 rows each
constexpr int kBs = 32;            // rows of a streamed (split) tile
constexpr int kChunk = 8;          // independent MMAs per pass

// An MMA operand fragment as its TF32 big and small parts.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// x = big + small exactly: big is x with the 13 mantissa bits below TF32
// cleared, small = x - big; the MMA reads small to TF32 precision, so a
// product keeps about 21 bits
__device__ __forceinline__ float tf32_big(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  const float big = tf32_big(x);
  hi = __float_as_uint(big);
  lo = __float_as_uint(x - big);
}

// 2^x on the special function unit (about 2 ulp; 0 below 2^-126)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[c0 + n] += a.b[n] for N column tiles in 3xTF32: the two small terms,
// then big.big, each as one pass over the N independent accumulators, so
// that no MMA waits for the one just before it (three MMAs into one
// accumulator back to back stall on the tensor core's latency).  c0 is a
// constant once the caller's loop is unrolled.
template <int N, int M>
__device__ __forceinline__ void mma3(float (&c)[M][4], int c0,
                                     const FragA& a, const FragB (&b)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[c0 + n], a.lo, b[n].hi);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[c0 + n], a.hi, b[n].lo);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(c[c0 + n], a.hi, b[n].hi);
}

// the same for two products that share nothing (s and dp, dv and dk):
// their passes interleave
template <int N, int M>
__device__ __forceinline__ void mma3x2(float (&c)[M][4], float (&e)[M][4],
                                       int c0, const FragA& a,
                                       const FragB (&b)[N], const FragA& f,
                                       const FragB (&g)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
    mma_tf32(c[c0 + n], a.lo, b[n].hi);
    mma_tf32(e[c0 + n], f.lo, g[n].hi);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    mma_tf32(c[c0 + n], a.hi, b[n].lo);
    mma_tf32(e[c0 + n], f.hi, g[n].lo);
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    mma_tf32(c[c0 + n], a.hi, b[n].hi);
    mma_tf32(e[c0 + n], f.hi, g[n].hi);
  }
}

// Where element (r, c) of a 64 x DP resident A-operand tile lives in its
// fragment-order layout: for each 16-row block and depth step of 8, the 32
// lanes' fragments as 4 consecutive floats each (a0 a1 a2 a3), so a lane
// loads its whole fragment with one 128-bit load and no register moves.
// Depth k = t sits at column 2t and k = t + 4 at 2t + 1: the B operand
// (frag_b_rows) reads the same two columns as one 64-bit load.
template <int DP>
__device__ __forceinline__ int a_slot(int r, int c) {
  const int rr = r & 15;
  const int cc = c & 7;
  const int lane = (rr & 7) * 4 + (cc >> 1);
  return ((((r >> 4) * (DP / 8) + (c >> 3)) * 32 + lane) << 2) + (rr >> 3) +
         2 * (cc & 1);
}

// The A fragment of rows m0..m0+15, depth step kk of a fragment-order
// tile, split here.
template <int DP>
__device__ __forceinline__ FragA frag_a_rows(const float* s, int m0, int kk,
                                             int lane) {
  const float4 x = reinterpret_cast<const float4*>(
      s)[((m0 >> 4) * (DP / 8) + kk) * 32 + lane];
  FragA f;
  split_tf32(x.x, f.hi[0], f.lo[0]);
  split_tf32(x.y, f.hi[1], f.lo[1]);
  split_tf32(x.z, f.hi[2], f.lo[2]);
  split_tf32(x.w, f.hi[3], f.lo[3]);
  return f;
}

// A fragment in the MMA's own depth order: rows m0 + g (+8), columns
// c0 + t (+4), split here.
__device__ __forceinline__ FragA frag_a(const float* s, int ld, int m0,
                                        int c0, int g, int t) {
  const float* r0 = s + (m0 + g) * ld + c0 + t;
  const float* r1 = r0 + 8 * ld;
  FragA f;
  split_tf32(r0[0], f.hi[0], f.lo[0]);
  split_tf32(r1[0], f.hi[1], f.lo[1]);
  split_tf32(r0[4], f.hi[2], f.lo[2]);
  split_tf32(r1[4], f.hi[3], f.lo[3]);
  return f;
}

// B fragment (depth x 8) whose column n is row n0 + n of a split tile
// (big and small parts in two row-major arrays): the transposed operand
// of q k^T, in frag_a_rows's depth order.
__device__ __forceinline__ FragB frag_b_rows(const float* hi,
                                             const float* lo, int ld,
                                             int n0, int c0, int g, int t) {
  const int at = (n0 + g) * ld + c0 + 2 * t;
  const float2 h = *reinterpret_cast<const float2*>(hi + at);
  const float2 l = *reinterpret_cast<const float2*>(lo + at);
  FragB f;
  f.hi[0] = __float_as_uint(h.x);
  f.hi[1] = __float_as_uint(h.y);
  f.lo[0] = __float_as_uint(l.x);
  f.lo[1] = __float_as_uint(l.y);
  return f;
}

// B fragment of a split row-major (depth x n) tile: rows k0 + t (+4),
// column n0 + g.
__device__ __forceinline__ FragB frag_b(const float* hi, const float* lo,
                                        int ld, int k0, int n0, int g,
                                        int t) {
  const int at = (k0 + t) * ld + n0 + g;
  FragB f;
  f.hi[0] = __float_as_uint(hi[at]);
  f.hi[1] = __float_as_uint(hi[at + 4 * ld]);
  f.lo[0] = __float_as_uint(lo[at]);
  f.lo[1] = __float_as_uint(lo[at + 4 * ld]);
  return f;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::
                   : "memory");
}

// Start copying rows [t0, t0 + 64) of head h, batch b of a (B, T, H, D)
// tensor into a 64 x DP fragment-order shared tile (a_slot), zero past T
// and past D (a copy of source size 0 writes zeros): the block's resident
// A operands.  Consecutive threads read consecutive d.
template <int DP>
__device__ __forceinline__ void stage_resident(float* dst, const float* src,
                                               int b, int h, int t0, int T,
                                               int H, int D) {
  const float* row = src + ((size_t)b * T * H + h) * D;   // row 0 of (b, h)
  const size_t HD = (size_t)H * D;
  for (int idx = threadIdx.x; idx < kB * DP; idx += kBwdThreads) {
    const int r = idx / DP;
    const int c = idx % DP;
    const int t = t0 + r;
    const bool ok = t < T && c < D;
    cp_async4(dst + a_slot<DP>(r, c), ok ? row + t * HD + c : src,
              ok ? 4 : 0);
  }
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(bytes));
}

// Start copying rows [t0, t0 + kBs) of a (B, T, H, D) tensor into a
// kBs x DP staging tile, zero past T and D: the next streamed tile, in
// flight while the current one computes.  `vec`: D % 4 == 0 and the
// tensor 16-byte aligned, so whole 16-byte chunks are copied.
template <int DP>
__device__ __forceinline__ void fetch_stream(float* raw, const float* src,
                                             int b, int h, int t0, int T,
                                             int H, int D, bool vec) {
  const float* row = src + ((size_t)b * T * H + h) * D;   // row 0 of (b, h)
  const size_t HD = (size_t)H * D;
  if (vec) {
    constexpr int C4 = DP / 4;
    for (int idx = threadIdx.x; idx < kBs * C4; idx += kBwdThreads) {
      const int t = t0 + idx / C4;
      const int c = (idx % C4) * 4;
      const bool ok = t < T && c < D;
      cp_async16(raw + idx * 4, ok ? row + t * HD + c : src, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < kBs * DP; idx += kBwdThreads) {
      const int t = t0 + idx / DP;
      const int c = idx % DP;
      const bool ok = t < T && c < D;
      cp_async4(raw + idx, ok ? row + t * HD + c : src, ok ? 4 : 0);
    }
  }
}

// kBs values of a (B*H, T) row vector (lse or delta) into staging, zero
// past T.
__device__ __forceinline__ void fetch_rows(float* raw, const float* src,
                                           int bh, int t0, int T) {
  for (int r = threadIdx.x; r < kBs; r += kBwdThreads) {
    const bool ok = t0 + r < T;
    cp_async4(raw + r, ok ? src + (size_t)bh * T + t0 + r : src,
              ok ? 4 : 0);
  }
}

// A staging tile split once into the big and small parts of two
// kBs x (DP + 8) tiles: the streamed B operands, read by every warp
// without splitting.
template <int DP>
__device__ __forceinline__ void split_stream(float* hi, float* lo,
                                             const float* raw) {
  constexpr int LD = DP + 8;
  constexpr int C4 = DP / 4;
  for (int idx = threadIdx.x; idx < kBs * C4; idx += kBwdThreads) {
    const float4 x = reinterpret_cast<const float4*>(raw)[idx];
    const float4 big = make_float4(tf32_big(x.x), tf32_big(x.y),
                                   tf32_big(x.z), tf32_big(x.w));
    const int at = (idx / C4) * LD + (idx % C4) * 4;
    *reinterpret_cast<float4*>(hi + at) = big;
    *reinterpret_cast<float4*>(lo + at) =
        make_float4(x.x - big.x, x.y - big.y, x.z - big.z, x.w - big.w);
  }
}

// Store a warp's 16 x DP accumulator tile (C fragments) to rows
// t0 + m0 + g (+8) of a (B, T, H, D) tensor, rows below T and columns
// below D only.
template <int DP>
__device__ __forceinline__ void store_frags(float* dst,
                                            const float (&acc)[DP / 8][4],
                                            int b, int h, int t0, int T,
                                            int H, int D, int m0, int g,
                                            int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = t0 + m0 + g + 8 * half;
    if (row >= T) continue;
    float* out = dst + ((size_t)(b * T + row) * H + h) * D;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = n * 8 + 2 * t;
      if (d < D) out[d] = acc[n][2 * half];
      if (d + 1 < D) out[d + 1] = acc[n][2 * half + 1];
    }
  }
}

// ---------------------------------------------------------------------------
// B2a: dQ
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(kBwdThreads, DP <= 64 ? 2 : 1)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq,
                    int H, int Tq, int Tk, int D, int causal, float scale,
                    int vec) {
  constexpr int LD = DP + 8;
  constexpr int LDS = kBs + 8;    // row stride of the ds tile
  constexpr int NK = DP / 8;      // depth steps over d; column tiles of dq
  constexpr int NS = kBs / 8;     // column tiles of a score tile
  constexpr int CH = NK < kChunk ? NK : kChunk;   // dq tiles per pass
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;               // 64 x DP, fragment order
  float* sO = sQ + kB * DP;       // dO, 64 x DP, fragment order
  float* rK = sO + kB * DP;       // the next k tile, kBs x DP staging
  float* rV = rK + kBs * DP;      // the next v tile
  float* sKh = rV + kBs * DP;     // k, big part, kBs x LD
  float* sKl = sKh + kBs * LD;    // k, small part
  float* sVh = sKl + kBs * LD;    // v, big part
  float* sVl = sVh + kBs * LD;    // v, small part
  float* sS = sVl + kBs * LD;     // ds, 64 x LDS

  const int nq = gridDim.x;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kB;   // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = (threadIdx.x >> 5) * 16;

  stage_resident<DP>(sQ, q, b, h, q0, Tq, H, D);
  stage_resident<DP>(sO, dout, b, h, q0, Tq, H, D);
  // lse (times log2 e) and delta of this lane's two rows, in registers for
  // the whole loop
  const float scale2 = scale * kLog2e;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + m0 + g + 8 * half;
    row_lse[half] = row < Tq ? lse[(size_t)bh * Tq + row] * kLog2e : 0.f;
    row_delta[half] = row < Tq ? delta[(size_t)bh * Tq + row] : 0.f;
  }

  float acc[NK][4];
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int k_end = causal ? min(Tk, q0 + kB) : Tk;
  fetch_stream<DP>(rK, k, b, h, 0, Tk, H, D, vec);
  fetch_stream<DP>(rV, v, b, h, 0, Tk, H, D, vec);
  for (int k0 = 0; k0 < k_end; k0 += kBs) {
    cp_async_wait_all();          // this tile (and q, dO) has landed
    __syncthreads();              // for every thread; the last tile is done
    split_stream<DP>(sKh, sKl, rK);
    split_stream<DP>(sVh, sVl, rV);
    __syncthreads();              // split tiles ready, staging free
    if (k0 + kBs < k_end) {       // the next tile flies during this one
      fetch_stream<DP>(rK, k, b, h, k0 + kBs, Tk, H, D, vec);
      fetch_stream<DP>(rV, v, b, h, k0 + kBs, Tk, H, D, vec);
    }

    // s = q k^T and dp = dO v^T for this warp's 16 rows x kBs keys
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const FragA aq = frag_a_rows<DP>(sQ, m0, kk, lane);
      const FragA ao = frag_a_rows<DP>(sO, m0, kk, lane);
      FragB bk[NS], bv[NS];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        bk[n] = frag_b_rows(sKh, sKl, LD, n * 8, kk * 8, g, t);
        bv[n] = frag_b_rows(sVh, sVl, LD, n * 8, kk * 8, g, t);
      }
      mma3x2(s, dp, 0, aq, bk, ao, bv);
    }

    // ds = p (dp - delta) scale, p = exp(s scale - lse), into shared memory
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + g + 8 * half;
        const int qi = q0 + r;
        float out[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int kj = k0 + n * 8 + 2 * t + j;
          const bool keep = kj < Tk && !(causal && qi < kj);
          const float e =
              exp2_approx(fmaf(s[n][2 * half + j], scale2, -row_lse[half]));
          const float p = keep ? e : 0.f;
          out[j] = p * (dp[n][2 * half + j] - row_delta[half]) * scale;
        }
        *reinterpret_cast<float2*>(sS + r * LDS + n * 8 + 2 * t) =
            make_float2(out[0], out[1]);
      }
    }
    __syncwarp();                 // each warp reads back only its rows

    // dq += ds k, in column chunks of 8 tiles (whole DP at DP <= 64)
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      const FragA a = frag_a(sS, LDS, m0, kk * 8, g, t);
#pragma unroll
      for (int c0 = 0; c0 < NK; c0 += CH) {
        FragB bk[CH];
#pragma unroll
        for (int n = 0; n < CH; ++n)
          bk[n] = frag_b(sKh, sKl, LD, kk * 8, (c0 + n) * 8, g, t);
        mma3(acc, c0, a, bk);
      }
    }
  }
  store_frags<DP>(dq, acc, b, h, q0, Tq, H, D, m0, g, t);
}

// ---------------------------------------------------------------------------
// B2b: dK and dV
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(kBwdThreads, DP <= 64 ? 2 : 1)
flash_bwd_dkv_kernel(const float* __restrict__ q,
                     const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int H,
                     int Tq, int Tk, int D, int causal, float scale,
                     int vec) {
  constexpr int LD = DP + 8;
  constexpr int LDP = kBs + 8;    // row stride of the p^T and ds^T tiles
  constexpr int NK = DP / 8;      // depth steps over d; column tiles of dk
  constexpr int NS = kBs / 8;     // column tiles of a score tile
  constexpr int CH = NK < kChunk / 2 ? NK : kChunk / 2;  // dk, dv per pass
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;               // 64 x DP, this block's keys, fragment order
  float* sV = sK + kB * DP;       // 64 x DP, fragment order
  float* rQ = sV + kB * DP;       // the next q tile, kBs x DP staging
  float* rO = rQ + kBs * DP;      // the next dO tile
  float* rL = rO + kBs * DP;      // the next lse, kBs
  float* rD = rL + kBs;           // the next delta, kBs
  float* sQh = rD + kBs;          // the current q tile, big part, kBs x LD
  float* sQl = sQh + kBs * LD;    // small part
  float* sOh = sQl + kBs * LD;    // dO, big part
  float* sOl = sOh + kBs * LD;    // dO, small part
  float* sP = sOl + kBs * LD;     // p^T, 64 (k) x LDP (q)
  float* sS = sP + kB * LDP;      // ds^T, 64 (k) x LDP (q)
  float* sL = sS + kB * LDP;      // lse of the q tile, kBs
  float* sD = sL + kBs;           // delta of the q tile, kBs

  // causal: early k tiles have the most q tiles to visit, so they go first
  const int k0 = (int)blockIdx.x * kB;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = (threadIdx.x >> 5) * 16;

  stage_resident<DP>(sK, k, b, h, k0, Tk, H, D);
  stage_resident<DP>(sV, v, b, h, k0, Tk, H, D);
  const float scale2 = scale * kLog2e;

  float ak[NK][4], av[NK][4];
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[n][e] = av[n][e] = 0.f;

  // causal: q rows below k0 see none of these keys
  const int q_begin = causal ? k0 : 0;
  if (q_begin < Tq) {
    fetch_stream<DP>(rQ, q, b, h, q_begin, Tq, H, D, vec);
    fetch_stream<DP>(rO, dout, b, h, q_begin, Tq, H, D, vec);
    fetch_rows(rL, lse, bh, q_begin, Tq);
    fetch_rows(rD, delta, bh, q_begin, Tq);
  }
  for (int q0 = q_begin; q0 < Tq; q0 += kBs) {
    cp_async_wait_all();          // this tile (and k, v) has landed
    __syncthreads();              // for every thread; the last tile is done
    split_stream<DP>(sQh, sQl, rQ);
    split_stream<DP>(sOh, sOl, rO);
    for (int r = threadIdx.x; r < kBs; r += kBwdThreads) {
      sL[r] = rL[r] * kLog2e;
      sD[r] = rD[r];
    }
    __syncthreads();              // split tiles ready, staging free
    if (q0 + kBs < Tq) {          // the next tile flies during this one
      fetch_stream<DP>(rQ, q, b, h, q0 + kBs, Tq, H, D, vec);
      fetch_stream<DP>(rO, dout, b, h, q0 + kBs, Tq, H, D, vec);
      fetch_rows(rL, lse, bh, q0 + kBs, Tq);
      fetch_rows(rD, delta, bh, q0 + kBs, Tq);
    }

    // transposed scores: this warp's 16 keys x kBs queries
    float st[NS][4], dpt[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const FragA fk = frag_a_rows<DP>(sK, m0, kk, lane);
      const FragA fv = frag_a_rows<DP>(sV, m0, kk, lane);
      FragB bq[NS], bo[NS];
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        bq[n] = frag_b_rows(sQh, sQl, LD, n * 8, kk * 8, g, t);
        bo[n] = frag_b_rows(sOh, sOl, LD, n * 8, kk * 8, g, t);
      }
      mma3x2(st, dpt, 0, fk, bq, fv, bo);
    }

#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int c = n * 8 + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(sL + c);
      const float2 d2 = *reinterpret_cast<const float2*>(sD + c);
      const float ls[2] = {l2.x, l2.y};
      const float dl[2] = {d2.x, d2.y};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + g + 8 * half;
        const int kj = k0 + r;
        float p[2], ds[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int qi = q0 + c + j;
          const bool keep = qi < Tq && !(causal && qi < kj);
          const float e =
              exp2_approx(fmaf(st[n][2 * half + j], scale2, -ls[j]));
          p[j] = keep ? e : 0.f;
          ds[j] = p[j] * (dpt[n][2 * half + j] - dl[j]) * scale;
        }
        *reinterpret_cast<float2*>(sP + r * LDP + c) = make_float2(p[0],
                                                                   p[1]);
        *reinterpret_cast<float2*>(sS + r * LDP + c) = make_float2(ds[0],
                                                                   ds[1]);
      }
    }
    __syncwarp();

    // dv += p^T dO, dk += ds^T q, in column chunks of 4 tiles each
#pragma unroll
    for (int kk = 0; kk < NS; ++kk) {
      const FragA ap = frag_a(sP, LDP, m0, kk * 8, g, t);
      const FragA as = frag_a(sS, LDP, m0, kk * 8, g, t);
#pragma unroll
      for (int c0 = 0; c0 < NK; c0 += CH) {
        FragB bo[CH], bq[CH];
#pragma unroll
        for (int n = 0; n < CH; ++n) {
          bo[n] = frag_b(sOh, sOl, LD, kk * 8, (c0 + n) * 8, g, t);
          bq[n] = frag_b(sQh, sQl, LD, kk * 8, (c0 + n) * 8, g, t);
        }
        mma3x2(av, ak, c0, ap, bo, as, bq);
      }
    }
  }
  cp_async_wait_all();            // a block with no q tile still copied k, v
  store_frags<DP>(dk, ak, b, h, k0, Tk, H, D, m0, g, t);
  store_frags<DP>(dv, av, b, h, k0, Tk, H, D, m0, g, t);
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

// whole 16-byte copies: D a multiple of 4 and every (B, T, H, D) operand
// 16-byte aligned
int vec_copies(int D, const float* a, const float* b, const float* c,
               const float* d) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(a) |
                        reinterpret_cast<uintptr_t>(b) |
                        reinterpret_cast<uintptr_t>(c) |
                        reinterpret_cast<uintptr_t>(d);
  return D % 4 == 0 && any % 16 == 0;
}

template <int DP>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* delta,
              float* dq, int B, int H, int Tq, int Tk, int D, int causal,
              float scale, cudaStream_t st) {
  const size_t smem = sizeof(float) * (2 * (kB + kBs) * DP +
                                       4 * kBs * (DP + 8) + kB * (kBs + 8));
  cudaError_t rc = prepare(flash_bwd_dq_kernel<DP>, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((Tq + kB - 1) / kB, B * H);
  flash_bwd_dq_kernel<DP><<<grid, kBwdThreads, smem, st>>>(
      q, k, v, dout, lse, delta, dq, H, Tq, Tk, D, causal, scale,
      vec_copies(D, q, k, v, dout));
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* delta,
               float* dk, float* dv, int B, int H, int Tq, int Tk, int D,
               int causal, float scale, cudaStream_t st) {
  const size_t smem = sizeof(float) * (2 * (kB + kBs) * DP +
                                       4 * kBs * (DP + 8) +
                                       2 * kB * (kBs + 8) + 4 * kBs);
  cudaError_t rc = prepare(flash_bwd_dkv_kernel<DP>, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((Tk + kB - 1) / kB, B * H);
  flash_bwd_dkv_kernel<DP><<<grid, kBwdThreads, smem, st>>>(
      q, k, v, dout, lse, delta, dk, dv, H, Tq, Tk, D, causal, scale,
      vec_copies(D, q, k, v, dout));
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
