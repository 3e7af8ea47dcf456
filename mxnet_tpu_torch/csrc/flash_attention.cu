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
//    Causal masking is on absolute indices (a logit of -inf in the
//    forward, p = 0 in the backward), so Tq != Tk works.
//  * D <= 128 through templates at DP in {32, 64, 128}; a D between them
//    is zero-padded to DP.  Shared memory is above 48 KB, so each launch
//    first raises the kernel's dynamic shared memory limit.
//
// B1 (forward), B2a (dQ) and B2b (dK/dV): tensor cores in 3xTF32,
// f32-accurate.  The f32 FMA pipes (67 TFLOP/s) need about 4 FMAs per
// shared-memory load to stay busy, and the FMA kernels these replace
// reached 2 (3.6-4.1x their f32 bound).  Every product -- s = q k^T,
// out += p v, dp = dO v^T, dq = ds k, dk = ds^T q, dv = p^T dO -- goes
// through mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 instead.
// Each f32 operand x is split into big = x with the 13 mantissa bits
// below TF32 cleared and small = x - big (exact), and a.b is accumulated
// in f32 as
// a_big.b_small + a_small.b_big + a_big.b_big (the small terms first):
// three MMAs per product, which keep about 21 bits of each product, near
// f32 and far from the 11 of one TF32 product.  1xTF32 is never used.
// (This is the f32 path of PyTorch's memory-efficient attention,
// CUTLASS's OpMultiplyAddFastF32, here in inline PTX, so the build stays
// one nvcc per source with a plain C interface.  Clearing bits rather than
// cvt.rna costs one instruction, not several, and ptxas drops it for the
// big operand, whose low bits the MMA ignores.)
//  * 128 threads, 4 warps; warp w owns rows 16w..16w+15 of the block's
//    64-row tile (q rows for the forward and dQ, k rows for dK/dV).
//    dK/dV computes the transposed scores s^T = k q^T, so p^T and ds^T
//    come out with keys as rows and are A operands directly.
//  * Resident A operands (q for the forward, q and dO for dQ, k and v for
//    dK/dV) are copied once per block into fragment order (a_slot): a
//    lane loads its A fragment with one 128-bit load.  Their depth order
//    pairs columns 2t and 2t + 1, which the B operand of q k^T (rows of
//    k) reads as one 64-bit load.
//  * Streamed B operands (k and v tiles for the forward and dQ; q, dO, lse
//    and delta for dK/dV) come in 32-row tiles: cp.async fetches the next
//    tile into a staging buffer while the current one computes, and one
//    pass splits it into big and small tiles of row stride DP + 8 (8 mod
//    32) that every warp reads without splitting: 64-bit loads along rows
//    (words 8g + 2t) and 32-bit loads down columns (words 8t + g), both
//    free of bank conflicts.
//  * The MMAs of one depth step go in three passes over 4 to 8
//    independent accumulators: three MMAs into one accumulator back to
//    back would each wait out the tensor core's latency.
//  * In the backward the p / ds tile between two products goes through
//    shared memory (row stride 40): the MMA's C fragment (lane holds rows
//    g, g+8, cols 2t, 2t+1) is not its A fragment (rows g, g+8, cols t,
//    t+4).  Each warp writes and reads back only its own 16 rows, so a
//    __syncwarp suffices.  The forward keeps p in registers instead: the
//    C fragment of s is the A fragment of p v once depth t is read as key
//    2t and depth t+4 as key 2t+1, and v is split into key-pair order
//    (split_pairs) so that its B fragment in that order is one 64-bit
//    load (on the H100 the shared-memory round trip was 17% slower).
//  * The forward's online softmax stays in the C fragments: the row max
//    over the quad's four lanes by two shuffles, each lane's share of the
//    row sum kept apart and added once at the end.  The tensor core
//    truncates as it adds into an accumulator, so summed into one
//    accumulator s (24 MMAs at D = 64) and out (12 per 32-key tile, 384
//    at T = 1024) drifted to 0.55-0.69 of out's 1e-5 tolerance at T 1024
//    on the H100; each depth step's three MMAs of s and each key tile's
//    MMAs of p v go into a fresh accumulator added in f32 round-to-
//    nearest (0.13-0.25 of it; 10% slower).  A warp skips a causal key
//    tile that lies wholly past its last row.
//  * exp as ex2.approx (about 2 ulp) with log2 e folded into the scale and
//    the saved lse; masking by select, with no branch per element.
//  * At D = 64 a block takes 96 KB (dQ) or 107 KB (dK/dV) of shared memory
//    and 223 / 245 registers (no spills), so two blocks share an SM; at
//    DP = 128, 255 registers with 8 bytes of spills and one block.
//
// B9: the same three functions in bf16 and f16 (the reference's kernels
// take bf16 or f16 q, k, v and dO, compute in f32 and write out, dQ, dK
// and dV in the input dtype, with lse and delta f32).  Outputs are rounded
// to the 16-bit type to nearest even, as astype does.  The forward
// (flash_fwd16_kernel), dQ (flash_bwd_dq16_kernel) and dK/dV
// (flash_bwd_dkv16_kernel) are templates over the 16-bit element type E:
// bf16 or __half tiles and the m16n8k16 MMA of that type; the bf16
// instantiations are the kernels described here, and the f16 ones differ
// only where f16's range demands (kPScale, rescale_rows below).  What bounds them on the H100, at the training shape:
// the forward moves 50.7 MB (0.0151 ms at 3.35 TB/s) for 12.9 GFLOP
// (0.0130 ms at the 989 TFLOP/s of bf16); dQ does 19.4 GFLOP (0.0196 ms)
// on 64 MB (0.0190 ms); dK/dV 25.8 GFLOP (0.0261 ms) on 76 MB (0.0227 ms).
// All three run far from either, on mma.sync (the rates of the tensor
// core that wgmma reaches are not open to it) at 3 (forward), 4 (dQ) and
// 6 (dK/dV) MMA units of 2 D flops per (q, k) pair.  What the design does
// (the percentages: NVIDIA H100 80GB HBM3 at 700 W,
// tools/flash_variants.py):
//    - bf16 tiles in shared memory, never widened, rows padded by 16
//      bytes (stride DP + 8 elements) so that ldmatrix's 8 rows of 16
//      bytes fall in 8 groups of 4 banks; the streamed tiles (k and v of
//      64 keys for the forward and dQ, q and dO of 64 rows with their lse
//      and delta for dK/dV) fill a ring of 2 stages by cp.async 16-byte
//      chunks, the next tile in flight while this one computes, one
//      barrier per tile.  Each thread's copy offsets are computed once
//      (recomputing them per chunk cost the forward 15%).
//    - mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 for every
//      product, fragments by ldmatrix.x4 (.trans where the depth runs
//      down the rows: v in p v, k in ds k, dO and q in p^T dO and ds^T
//      q).  q k^T, dO v^T, k q^T and v dO^T take one MMA per depth step of
//      16: bf16 x bf16 products are exact in f32, so this is the
//      reference's product up to summation order.
//    - The f32 side of p v, ds k, p^T dO and ds^T q (p, ds) goes in as two
//      bf16 terms, hi = bf16_rn(x) and lo = bf16_rn(x - hi), about 16 bits
//      of x, and two MMAs, the small term first.  One term (p or ds
//      rounded to bf16) breaks the bf16 tolerance (tests/test_torch_flash_
//      bf16_split.py: 5-16x on dq); it would save 12% of the forward and
//      of dK/dV.
//    - The C fragments of two adjacent n8 score tiles, packed as bf16x2,
//      are the A fragment of one depth step of 16 (split_frag): p and ds
//      never leave registers.  dK/dV computes s^T = k q^T and dp^T = v
//      dO^T with keys as the M rows for that reason.
//    - The forward: 4 warps of 16 q rows, one block per 64 q rows; q's A
//      fragments are read from shared memory per tile (held in registers
//      for the whole loop they cost 9%); the online softmax in exp2 units
//      in the C fragments; each tile's p v into a fresh accumulator per
//      64 columns, added in f32 (lesson (b) above).  dQ: the forward's
//      blocks and k / v ring, with q and dO resident; s, dp, p and ds in
//      the C fragments, lse and delta of a lane's two rows in registers.
//      dK/dV: 4 warps of 16 keys, one block per 64 keys.  dq, dk and dv
//      accumulate in f32 registers across the whole loop, rounded once to
//      bf16: their tolerance is one bf16 step, far above what the tensor
//      core's truncation of the sums costs (a fresh dq accumulator per
//      key tile, added in f32, gave the same error at every shape and
//      was 0.5% slower).
//    - The grid is (B H, tiles): blocks run heads across blockIdx.x, so
//      every head's heaviest causal tile runs in the first wave and the
//      tail is light (the other order cost 11% / 6%).  One owner per
//      output tile: no atomics, the same bits on every run.
//    - Masks (past T, the causal diagonal) only on the tiles that need
//      them; -inf logits in the forward, p = 0 in dQ and dK/dV.
//    Occupancy at DP = 64 (-Xptxas -v, sm_90a): forward 166 registers, no
//    spills, 45 KB of shared memory, 3 blocks (12 warps) per SM; dQ 166
//    registers, no spills, 54 KB, 3 blocks; dK/dV 212 registers, no
//    spills, 56 KB, 2 blocks.  DP = 32: 122 / 142 / 160 registers; DP =
//    128: 245 (forward) and 226 (dQ) registers, no spills, 255 with 72
//    bytes of stack (dK/dV).
// The f32 kernels give the same bits as before the bf16 kernels were
// added, and the bf16 forward and dK/dV the same as before dQ was
// (tests/test_torch_kernels_cuda.py holds their digests); the bf16
// kernels give the same bits and SASS as before the f16 ones were added.
// B9 f16 (DP 64: 168 / 164 / 214 registers, no spills): the same MMAs;
// p (at most 1) goes into its f16 hi + lo terms times 2^15, and ds, whose
// size follows dO's, times a running power of two per row, both undone
// in f32 (tests/test_torch_flash_f16_split.py emulates them: without the
// scaling a ds past 65504 gives NaN where the plain version is finite).

// Interface: plain C, launched on the caller's stream, allocates nothing,
// f32 (mxt_flash_attention_*), bf16 (mxt_flash_attention_*_bf16) or f16
// (mxt_flash_attention_*_f16) q, k, v, dO and outputs, lse and delta f32
// in all, D <= 128; returns the first CUDA error (attribute or launch).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kB = 64;          // rows of a backward block's tile
constexpr float kNegBig = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void store_elem(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_elem(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void store_elem(__half* p, float x) {
  *p = __float2half_rn(x);
}

// ---------------------------------------------------------------------------
// 3xTF32 tensor-core products (B1, B2a, B2b)
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

// Start copying rows [t0, t0 + ROWS) of head h, batch b of a (B, T, H, D)
// tensor into a ROWS x DP fragment-order shared tile (a_slot), zero past T
// and past D (a copy of source size 0 writes zeros): the block's resident
// A operands, by NT threads.  Consecutive threads read consecutive d.
template <int DP, int ROWS = kB, int NT = kBwdThreads>
__device__ __forceinline__ void stage_resident(float* dst, const float* src,
                                               int b, int h, int t0, int T_,
                                               int H, int D) {
  const float* row = src + ((size_t)b * T_ * H + h) * D;   // row 0 of (b, h)
  const size_t HD = (size_t)H * D;
  for (int idx = threadIdx.x; idx < ROWS * DP; idx += NT) {
    const int r = idx / DP;
    const int c = idx % DP;
    const int t = t0 + r;
    const bool ok = t < T_ && c < D;
    cp_async4(dst + a_slot<DP>(r, c), ok ? row + t * HD + c : src,
              ok ? 4 : 0);
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(bytes));
}

// Start copying rows [t0, t0 + kBs) of a (B, T, H, D) tensor into a
// kBs x DP staging tile, zero past T and D: the next streamed tile, in
// flight while the current one computes.  `vec`: whole 16-byte chunks (4
// elements) never cross D and the tensor is 16-byte aligned, so whole
// chunks are copied.  NT threads.
template <int DP, int NT = kBwdThreads>
__device__ __forceinline__ void fetch_stream(float* raw, const float* src,
                                             int b, int h, int t0, int T_,
                                             int H, int D, bool vec) {
  const float* row = src + ((size_t)b * T_ * H + h) * D;   // row 0 of (b, h)
  const size_t HD = (size_t)H * D;
  if (vec) {
    constexpr int E = 4;                    // elements per chunk
    constexpr int CE = DP / E;
    for (int idx = threadIdx.x; idx < kBs * CE; idx += NT) {
      const int t = t0 + idx / CE;
      const int c = (idx % CE) * E;
      const bool ok = t < T_ && c < D;
      cp_async16(raw + idx * E, ok ? row + t * HD + c : src, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < kBs * DP; idx += NT) {
      const int t = t0 + idx / DP;
      const int c = idx % DP;
      const bool ok = t < T_ && c < D;
      cp_async4(raw + idx, ok ? row + t * HD + c : src, ok ? 4 : 0);
    }
  }
}

// Four consecutive elements of a staging tile.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
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
// without splitting.  NT threads.
template <int DP, int NT = kBwdThreads>
__device__ __forceinline__ void split_stream(float* hi, float* lo,
                                             const float* raw) {
  constexpr int LD = DP + 8;
  constexpr int C4 = DP / 4;
  for (int idx = threadIdx.x; idx < kBs * C4; idx += NT) {
    const float4 x = load4(raw + idx * 4);
    const int at = (idx / C4) * LD + (idx % C4) * 4;
    const float4 big = make_float4(tf32_big(x.x), tf32_big(x.y),
                                   tf32_big(x.z), tf32_big(x.w));
    *reinterpret_cast<float4*>(hi + at) = big;
    *reinterpret_cast<float4*>(lo + at) =
        make_float4(x.x - big.x, x.y - big.y, x.z - big.z, x.w - big.w);
  }
}

// Store a warp's 16 x DP accumulator tile (C fragments) to rows
// t0 + m0 + g (+8) of a (B, T, H, D) tensor of element type T, rows below
// T and columns below D only.
template <int DP, typename T>
__device__ __forceinline__ void store_frags(T* dst,
                                            const float (&acc)[DP / 8][4],
                                            int b, int h, int t0, int T_,
                                            int H, int D, int m0, int g,
                                            int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = t0 + m0 + g + 8 * half;
    if (row >= T_) continue;
    T* out = dst + ((size_t)(b * T_ + row) * H + h) * D;
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = n * 8 + 2 * t;
      if (d < D) store_elem(out + d, acc[n][2 * half]);
      if (d + 1 < D) store_elem(out + d + 1, acc[n][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Shared-memory layouts: each tile's offset in floats from the start of
// dynamic shared memory, and `total`, what the launch reserves.
// ---------------------------------------------------------------------------

template <int DP>
struct Tiles {
  static constexpr int kStage = kBs * DP;         // kBs x DP staging tile
  static constexpr int kSplit = kBs * (DP + 8);   // kBs x LD split tile
};

// ---------------------------------------------------------------------------
// B1: forward
// ---------------------------------------------------------------------------

constexpr int kFwdWarps = 4;                 // 16 q rows each
constexpr int kFwdRows = 16 * kFwdWarps;     // q rows of a block
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr float kLn2 = 0.6931471805599453f;

// A kBs x DP staging tile of v split into big and small parts in key-pair
// order: keys 2p and 2p + 1 of column d side by side at p * (2 DP + 8) +
// 2d.  The B operand of p v, read in the key order of s's C fragment
// (frag_b_pairs), is then one 64-bit load, free of bank conflicts.
template <int DP>
__device__ __forceinline__ void split_pairs(float* hi, float* lo,
                                            const float* raw) {
  constexpr int LDV = 2 * DP + 8;
  constexpr int C4 = DP / 4;
  for (int idx = threadIdx.x; idx < kBs / 2 * C4; idx += kFwdThreads) {
    const int p = idx / C4;
    const int d = (idx % C4) * 4;
    const float4 x0 = load4(raw + 2 * p * DP + d);
    const float4 x1 = load4(raw + (2 * p + 1) * DP + d);
    const float pair[8] = {x0.x, x1.x, x0.y, x1.y, x0.z, x1.z, x0.w, x1.w};
    float big[8], small[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      big[e] = tf32_big(pair[e]);
      small[e] = pair[e] - big[e];
    }
    float4* h = reinterpret_cast<float4*>(hi + p * LDV + 2 * d);
    h[0] = make_float4(big[0], big[1], big[2], big[3]);
    h[1] = make_float4(big[4], big[5], big[6], big[7]);
    float4* l = reinterpret_cast<float4*>(lo + p * LDV + 2 * d);
    l[0] = make_float4(small[0], small[1], small[2], small[3]);
    l[1] = make_float4(small[4], small[5], small[6], small[7]);
  }
}

// B fragment of p v for keys 8j..8j+7 of the tile and columns n0..n0+7:
// depth t is key 8j + 2t and depth t + 4 key 8j + 2t + 1, the order in
// which s's C fragment holds p (see flash_fwd_kernel).
__device__ __forceinline__ FragB frag_b_pairs(const float* hi,
                                              const float* lo, int ldv,
                                              int j, int n0, int g, int t) {
  const int at = (4 * j + t) * ldv + 2 * (n0 + g);
  const float2 h = *reinterpret_cast<const float2*>(hi + at);
  const float2 l = *reinterpret_cast<const float2*>(lo + at);
  FragB f;
  f.hi[0] = __float_as_uint(h.x);
  f.hi[1] = __float_as_uint(h.y);
  f.lo[0] = __float_as_uint(l.x);
  f.lo[1] = __float_as_uint(l.y);
  return f;
}

template <int DP>
struct FwdSmem : Tiles<DP> {
  using B = Tiles<DP>;
  static constexpr int kPairs = kBs / 2 * (2 * DP + 8);   // split v tile
  static constexpr int rk = kFwdRows * DP;      // after q
  static constexpr int rv = rk + B::kStage;
  static constexpr int kh = rv + B::kStage;
  static constexpr int kl = kh + B::kSplit;
  static constexpr int vh = kl + B::kSplit;
  static constexpr int vl = vh + kPairs;
  static constexpr int total = vl + kPairs;
};

template <int DP>
__global__ void __launch_bounds__(kFwdThreads, DP <= 64 ? 3 : 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int H, int Tq, int Tk, int D,
                 int causal, float scale, int vec) {
  constexpr int LD = DP + 8;       // row stride of the split k tiles
  constexpr int LDV = 2 * DP + 8;  // of the split v tiles (key pairs)
  constexpr int NK = DP / 8;       // depth steps of q k^T; column tiles of out
  constexpr int NS = kBs / 8;      // column tiles of s; depth steps of p v
  constexpr int CH = NK < kChunk ? NK : kChunk;   // out tiles per pass
  using L = FwdSmem<DP>;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                  // kFwdRows x DP, fragment order
  float* rK = smem + L::rk;          // the next k tile, staging
  float* rV = smem + L::rv;          // the next v tile
  float* sKh = smem + L::kh;         // k, big part, kBs x LD
  float* sKl = smem + L::kl;         // k, small part
  float* sVh = smem + L::vh;         // v, big part, kBs / 2 x LDV
  float* sVl = smem + L::vl;         // v, small part

  const int nq = gridDim.x;
  const int q0 = (nq - 1 - (int)blockIdx.x) * kFwdRows;   // heaviest first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = (threadIdx.x >> 5) * 16;

  stage_resident<DP, kFwdRows, kFwdThreads>(sQ, q, b, h, q0, Tq, H, D);
  const float scale2 = scale * kLog2e;

  // per row (g, g + 8): the running max of the log2-scaled logits, and
  // this lane's share of the running sum (the quad's four shares are
  // added once at the end: the rescaling is the same for all four)
  float acc[NK][4], row_m[2] = {kNegBig, kNegBig}, row_l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NK; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // causal: keys past the block's last row are masked for all its rows,
  // and a tile of keys past a warp's last row for all the warp's rows
  const int k_end = causal ? min(Tk, q0 + kFwdRows) : Tk;
  const int warp_last = q0 + m0 + 15;
  fetch_stream<DP, kFwdThreads>(rK, k, b, h, 0, Tk, H, D, vec);
  fetch_stream<DP, kFwdThreads>(rV, v, b, h, 0, Tk, H, D, vec);
  for (int k0 = 0; k0 < k_end; k0 += kBs) {
    cp_async_wait_all();           // this tile (and q) has landed
    __syncthreads();               // for every thread; the last tile is done
    split_stream<DP, kFwdThreads>(sKh, sKl, rK);
    split_pairs<DP>(sVh, sVl, rV);
    __syncthreads();               // split tiles ready, staging free
    if (k0 + kBs < k_end) {        // the next tile flies during this one
      fetch_stream<DP, kFwdThreads>(rK, k, b, h, k0 + kBs, Tk, H, D, vec);
      fetch_stream<DP, kFwdThreads>(rV, v, b, h, k0 + kBs, Tk, H, D, vec);
    }
    if (causal && k0 > warp_last) continue;   // warp-uniform

    // s = q k^T for this warp's 16 rows x kBs keys, each depth step's
    // three MMAs into a fresh accumulator added in f32 (see the header)
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      const FragA aq = frag_a_rows<DP>(sQ, m0, kk, lane);
      FragB bk[NS];
#pragma unroll
      for (int n = 0; n < NS; ++n)
        bk[n] = frag_b_rows(sKh, sKl, LD, n * 8, kk * 8, g, t);
      float part[NS][4];
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
      mma3(part, 0, aq, bk);
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += part[n][e];
    }

    // online softmax in the C fragments (lane: rows g, g + 8, columns
    // 2t, 2t + 1 of each 8-key tile); a masked logit is -inf, so its p is
    // 0 whatever the running max
    const float neg_inf = __int_as_float(0xff800000);
    float mx[2] = {kNegBig, kNegBig};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = q0 + m0 + g + 8 * (e >> 1);
        const int kj = k0 + n * 8 + 2 * t + (e & 1);
        const bool keep = kj < Tk && !(causal && qi < kj);
        s[n][e] = keep ? s[n][e] * scale2 : neg_inf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float corr[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
      const float m_new = fmaxf(row_m[half], mx[half]);
      corr[half] = exp2_approx(row_m[half] - m_new);
      row_m[half] = m_new;
      row_l[half] *= corr[half];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2_approx(s[n][e] - row_m[e >> 1]);
        row_l[e >> 1] += s[n][e];
      }
    // out += p v.  The C fragment of s's tile j (rows g, g + 8; keys
    // 2t, 2t + 1) is the A fragment of depth step j once depth t is read
    // as key 2t and depth t + 4 as key 2t + 1: p stays in registers, and
    // v's B fragment is read in that key order (frag_b_pairs).
    // this tile's p v in a fresh accumulator; then out = out corr + p v
    float pv[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      FragA ap;
      split_tf32(s[j][0], ap.hi[0], ap.lo[0]);
      split_tf32(s[j][2], ap.hi[1], ap.lo[1]);
      split_tf32(s[j][1], ap.hi[2], ap.lo[2]);
      split_tf32(s[j][3], ap.hi[3], ap.lo[3]);
#pragma unroll
      for (int c0 = 0; c0 < NK; c0 += CH) {
        FragB bv[CH];
#pragma unroll
        for (int n = 0; n < CH; ++n)
          bv[n] = frag_b_pairs(sVh, sVl, LDV, j, (c0 + n) * 8, g, t);
        mma3(pv, c0, ap, bv);
      }
    }
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n][e] = fmaf(acc[n][e], corr[e >> 1], pv[n][e]);
  }

  // the quad's shares of each row's sum; out = acc / l; lse in natural
  // log units, m + log(max(l, 1e-37)) of the scaled logits
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float l = row_l[half];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = 1.f / l;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      acc[n][2 * half] *= inv;
      acc[n][2 * half + 1] *= inv;
    }
    const int row = q0 + m0 + g + 8 * half;
    if (lse != nullptr && t == 0 && row < Tq)
      lse[(size_t)bh * Tq + row] =
          row_m[half] * kLn2 + logf(fmaxf(l, 1e-37f));
  }
  store_frags<DP>(out, acc, b, h, q0, Tq, H, D, m0, g, t);
}

// ---------------------------------------------------------------------------
// B2a: dQ
// ---------------------------------------------------------------------------

template <int DP>
struct DqSmem : Tiles<DP> {
  using B = Tiles<DP>;
  static constexpr int o = kB * DP;             // after q
  static constexpr int rk = o + kB * DP;
  static constexpr int rv = rk + B::kStage;
  static constexpr int kh = rv + B::kStage;
  static constexpr int kl = kh + B::kSplit;
  static constexpr int vh = kl + B::kSplit;
  static constexpr int vl = vh + B::kSplit;
  static constexpr int s = vl + B::kSplit;
  static constexpr int total = s + kB * (kBs + 8);
};

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
  using L = DqSmem<DP>;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;               // 64 x DP, fragment order
  float* sO = smem + L::o;        // dO, 64 x DP, fragment order
  float* rK = smem + L::rk;       // the next k tile, staging
  float* rV = smem + L::rv;       // the next v
  float* sKh = smem + L::kh;      // k, big part, kBs x LD
  float* sKl = smem + L::kl;      // k, small part
  float* sVh = smem + L::vh;      // v, big part
  float* sVl = smem + L::vl;      // v, small part
  float* sS = smem + L::s;        // ds, 64 x LDS

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
struct DkvSmem : Tiles<DP> {
  using B = Tiles<DP>;
  static constexpr int v = kB * DP;             // after k
  static constexpr int rq = v + kB * DP;
  static constexpr int ro = rq + B::kStage;
  static constexpr int rl = ro + B::kStage;
  static constexpr int rd = rl + kBs;
  static constexpr int qh = rd + kBs;
  static constexpr int ql = qh + B::kSplit;
  static constexpr int oh = ql + B::kSplit;
  static constexpr int ol = oh + B::kSplit;
  static constexpr int p = ol + B::kSplit;
  static constexpr int s = p + kB * (kBs + 8);
  static constexpr int l = s + kB * (kBs + 8);
  static constexpr int d = l + kBs;
  static constexpr int total = d + kBs;
};

template <int DP>
__global__ void __launch_bounds__(kBwdThreads, DP <= 64 ? 2 : 1)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int H, int Tq, int Tk, int D,
                     int causal, float scale, int vec) {
  constexpr int LD = DP + 8;
  constexpr int LDP = kBs + 8;    // row stride of the p^T and ds^T tiles
  constexpr int NK = DP / 8;      // depth steps over d; column tiles of dk
  constexpr int NS = kBs / 8;     // column tiles of a score tile
  constexpr int CH = NK < kChunk / 2 ? NK : kChunk / 2;  // dk, dv per pass
  using L = DkvSmem<DP>;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;               // 64 x DP, this block's keys, fragment order
  float* sV = smem + L::v;        // 64 x DP, fragment order
  float* rQ = smem + L::rq;       // the next q tile, staging
  float* rO = smem + L::ro;       // the next dO
  float* rL = smem + L::rl;       // the next lse, kBs
  float* rD = smem + L::rd;       // the next delta, kBs
  float* sQh = smem + L::qh;      // the current q tile, big part, kBs x LD
  float* sQl = smem + L::ql;      // small part
  float* sOh = smem + L::oh;      // dO, big part
  float* sOl = smem + L::ol;      // dO, small part
  float* sP = smem + L::p;        // p^T, 64 (k) x LDP (q)
  float* sS = smem + L::s;        // ds^T, 64 (k) x LDP (q)
  float* sL = smem + L::l;        // lse of the q tile, kBs
  float* sD = smem + L::d;        // delta of the q tile, kBs

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
// B9 forward, dK/dV and dQ: 16-bit tiles and 16-bit tensor-core MMAs
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

// the forward: 4 warps of 16 q rows a block, kFwdKeys keys a streamed k /
// v tile, a ring of kFwdStages tiles; dK/dV: 4 warps of 16 keys a block,
// q / dO tiles of as many rows in a ring of kDkvStages
constexpr int kFwdThreads16 = 128;
constexpr int kFwdRows16 = 64;
constexpr int kFwdKeys = 64;
constexpr int kFwdStages = 2;
constexpr int kFwdMinBlocks = 2;
constexpr int kDkvRows = 64;
constexpr int kDkvThreads = 128;
constexpr int kDkvStages = 2;
constexpr int kDkvMinBlocks = 2;

// B9's element types: bf16, and f16 (__half), the same kernels over 16-bit
// tiles with the m16n8k16 MMA of that type (f32 sums)
template <typename E>
constexpr bool kIsF16 = std::is_same<E, __half>::value;

__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1,
                                      const bf16*) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4],
                                      uint32_t b0, uint32_t b1,
                                      const __half*) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// f16's range (largest 65504, normal from 2^-14) is not f32's, so the f32
// side of p v, ds k, p^T dO and ds^T q goes into its f16 hi + lo terms
// scaled by an exact power of two, undone in f32 after the MMAs:
//  * p (at most 1) by kPScale = 2^15: hi + lo then keep f32's relative
//    precision for p down to 2^-29 and stay below 2^15;
//  * ds, whose size follows dO's (a loss scale of 2^16 puts |ds| far past
//    65504), by 2^-e per row, e the row's running exponent: kept so that
//    the row's largest |ds| so far times 2^-e lies in [2^14, 2^15); when a
//    tile raises it, the row's accumulator is scaled down by the same
//    power of two first (exact in f32).  In bf16, whose exponent is f32's,
//    neither is done.
constexpr float kPScale = 32768.f;
constexpr float kPUnscale = 1.f / 32768.f;
constexpr int kEMin = -110;      // a row's exponent before its first ds

// 2^n as a float for n in [kEMin - 110 - 16, 127]; 0 below 2^-126
__device__ __forceinline__ float pow2i(int n) {
  return n < -126 ? 0.f : __int_as_float((n + 127) << 23);
}

// The running exponent of a warp's rows g and g + 8 (this lane's `re`)
// after a tile whose ds is x (C fragments, rows g / g + 8 in e >> 1): the
// quad's largest |ds| of each row sets e = floor(log2 max) - 14, never
// lowered and clamped to [kEMin, 110]; `acc`'s rows are scaled by 2^(old
// - new), and x by 2^-new.  NaN does not raise e (fmaxf), inf sets 110.
template <int NS, int NA>
__device__ __forceinline__ void rescale_rows(float (&x)[NS][4],
                                             float (&acc)[NA][4],
                                             int (&re)[2]) {
  float mx[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], fabsf(x[n][e]));
  float down[2], mul[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float m = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
    const int ex = ((__float_as_int(m) >> 23) & 0xff) - 127 - 14;
    const int e_new = max(re[half], min(ex, 110));
    down[half] = pow2i(re[half] - e_new);
    mul[half] = pow2i(-e_new);
    re[half] = e_new;
  }
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= down[e >> 1];
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[n][e] *= mul[e >> 1];
}

// the accumulator's rows g, g + 8 times 2^re (the scale of ds undone)
template <int NA>
__device__ __forceinline__ void unscale_rows(float (&acc)[NA][4],
                                             const int (&re)[2]) {
  const float up[2] = {pow2i(re[0]), pow2i(re[1])};
#pragma unroll
  for (int n = 0; n < NA; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] *= up[e >> 1];
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8 x 8 bf16 matrices from shared memory (byte address `a`): lane l
// gives the address of row l % 8 of matrix l / 8 and receives (row l / 4,
// columns 2 (l % 4), +1) of each; .trans: (rows 2 (l % 4), +1, column
// l / 4)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// Each lane's row of a 16 x 16 ldmatrix.x4 block of a tile of row stride
// LDS elements, in elements from the block's corner:
//   a_lane: the A fragment (rows 0-7, 8-15) x (depth 0-7, 8-15);
//   b_lane: the B fragments of two n8 tiles whose columns are rows 0-7 and
//           8-15 of the tile, depth along the row (b0, b1 of each);
//   bt_lane: the same with depth down the rows (.trans).
template <int LDS>
__device__ __forceinline__ int a_lane(int lane) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * LDS + (lane >> 4) * 8;
}
template <int LDS>
__device__ __forceinline__ int b_lane(int lane) {
  return ((lane >> 4) * 8 + (lane & 7)) * LDS + ((lane >> 3) & 1) * 8;
}
template <int LDS>
__device__ __forceinline__ int bt_lane(int lane) {
  return (((lane >> 3) & 1) * 8 + (lane & 7)) * LDS + (lane >> 4) * 8;
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// x0, x1 (f32) as bf16x2 hi + lo, each rounded to nearest even: hi =
// bf16(x), lo = bf16(x - hi), so hi + lo keeps about 16 bits of x; x0 in
// the low halves (the lower column of an MMA operand)
__device__ __forceinline__ void split16(float x0, float x1, uint32_t& hi,
                                        uint32_t& lo, const bf16*) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
// the same in f16: hi + lo keep about 22 bits of x (the callers keep x
// inside f16's normal range, see kPScale)
__device__ __forceinline__ void split16(float x0, float x1, uint32_t& hi,
                                        uint32_t& lo, const __half*) {
  const __half2 h = __floats2half2_rn(x0, x1);
  const float2 hf = __half22float2(h);
  const __half2 l = __floats2half2_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// The C fragments of two adjacent n8 score tiles (rows g, g + 8; columns
// 2t, 2t + 1 of each), packed in pairs, are the A fragment of one depth
// step of 16: split into hi and lo A fragments of element type E.
template <typename E>
__device__ __forceinline__ void split_frag(const float (&c0)[4],
                                           const float (&c1)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4]) {
  const E* tag = nullptr;
  split16(c0[0], c0[1], hi[0], lo[0], tag);   // row g, columns 2t, 2t + 1
  split16(c0[2], c0[3], hi[1], lo[1], tag);   // row g + 8
  split16(c1[0], c1[1], hi[2], lo[2], tag);   // row g, columns 8 + 2t, + 1
  split16(c1[2], c1[3], hi[3], lo[3], tag);   // row g + 8
}

// the same with the f32 values times `mul` first (f16's p: kPScale)
template <typename E>
__device__ __forceinline__ void split_frag(const float (&c0)[4],
                                           const float (&c1)[4],
                                           uint32_t (&hi)[4],
                                           uint32_t (&lo)[4], float mul) {
  const float a[4] = {c0[0] * mul, c0[1] * mul, c0[2] * mul, c0[3] * mul};
  const float b[4] = {c1[0] * mul, c1[1] * mul, c1[2] * mul, c1[3] * mul};
  split_frag<E>(a, b, hi, lo);
}

// a zero of the tile's element type
__device__ __forceinline__ bf16 zero16(const bf16*) {
  return __float2bfloat16_rn(0.f);
}
__device__ __forceinline__ __half zero16(const __half*) {
  return __float2half_rn(0.f);
}

// Start copying rows [t0, t0 + ROWS) of head h, batch b of a (B, T, H, D)
// bf16 tensor into a ROWS x (DP + 8) shared tile, zero past T and past D,
// by NT threads.  `vec`: 16-byte cp.async chunks (D % 8 == 0, 16-byte
// aligned tensors); else plain loads, complete at the next barrier.
template <int DP, int ROWS, int NT, typename E>
__device__ __forceinline__ void load_tile(E* dst, const E* src, int b,
                                          int h, int t0, int T_, int H,
                                          int D, bool vec) {
  constexpr int LDS = DP + 8;
  const E* row = src + ((size_t)b * T_ * H + h) * D;   // row 0 of (b, h)
  const size_t HD = (size_t)H * D;
  if (vec) {
    // thread x copies chunk x % CE of rows x / CE + RS i
    constexpr int CE = DP / 8;      // 16-byte chunks per row
    constexpr int RS = NT / CE;     // rows per round of NT chunks
    static_assert(NT % CE == 0 && ROWS % RS == 0, "whole rounds");
    const int r0 = threadIdx.x / CE;
    const int c = (threadIdx.x % CE) * 8;
    const E* from = row + (size_t)(t0 + r0) * HD + c;
    E* to = dst + r0 * LDS + c;
#pragma unroll
    for (int i = 0; i < ROWS / RS; ++i) {
      const bool ok = t0 + r0 + RS * i < T_ && c < D;
      cp_async16(to + RS * i * LDS, ok ? from + RS * i * HD : src,
                 ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * DP; idx += NT) {
      const int r = idx / DP;
      const int c = idx % DP;
      const int t = t0 + r;
      dst[r * LDS + c] =
          t < T_ && c < D ? row[t * HD + c] : zero16(dst);
    }
  }
}

// ---------------------------------------------------------------------------
// B9 forward
// ---------------------------------------------------------------------------

// shared memory of the forward, in bf16 elements: q, then kFwdStages
// stages of k and of v; rows padded by 8 elements (16 bytes), so that
// ldmatrix's 8 rows of 16 bytes fall in 8 different groups of 4 banks
template <int DP>
struct FwdBf16Smem {
  static constexpr int LDS = DP + 8;
  static constexpr int q_tile = kFwdRows16 * LDS;
  static constexpr int kv_tile = kFwdKeys * LDS;
  static constexpr int total = q_tile + 2 * kFwdStages * kv_tile;
};

template <int DP, typename E>
__global__ void __launch_bounds__(kFwdThreads16, kFwdMinBlocks)
flash_fwd16_kernel(const E* __restrict__ q, const E* __restrict__ k,
                   const E* __restrict__ v, E* __restrict__ out,
                   float* __restrict__ lse, int H, int Tq, int Tk, int D,
                   int causal, float scale, int vec) {
  using L = FwdBf16Smem<DP>;
  constexpr int LDS = L::LDS;
  constexpr int QR = kFwdRows16;   // q rows of the block
  constexpr int KN = kFwdKeys;
  constexpr int NT = kFwdThreads16;
  constexpr int NK = DP / 16;      // depth steps of q k^T
  constexpr int NS = KN / 8;       // n8 tiles of s (keys of a tile)
  constexpr int NO = DP / 8;       // n8 tiles of out
  constexpr int CH = NO < 8 ? NO : 8;   // out tiles per fresh accumulator
  constexpr int S = kFwdStages;
  constexpr bool F16 = kIsF16<E>;
  const E* tag = nullptr;
  extern __shared__ __align__(16) float smem[];
  E* sQ = reinterpret_cast<E*>(smem);
  E* sK = sQ + L::q_tile;          // S stages
  E* sV = sK + S * L::kv_tile;     // S stages

  // blocks run in the order of blockIdx.x + gridDim.x blockIdx.y: every
  // head's heaviest (causal: last) q tile first
  const int q0 = (gridDim.y - 1 - (int)blockIdx.y) * QR;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = (threadIdx.x >> 5) * 16;
  const float scale2 = scale * kLog2e;
  // this lane's ldmatrix rows (bytes): q's A fragments, k's B fragments
  // (keys as columns), v's B fragments (keys as depth, .trans)
  const unsigned aq_at = smem_u32(sQ) + 2 * (m0 * LDS + a_lane<LDS>(lane));
  const unsigned bk_at = smem_u32(sK) + 2 * b_lane<LDS>(lane);
  const unsigned bv_at = smem_u32(sV) + 2 * bt_lane<LDS>(lane);

  // causal: keys past the block's last row are masked for all its rows
  const int k_end = causal ? min(Tk, q0 + QR) : Tk;
  const int n_tiles = (k_end + KN - 1) / KN;
  // tile i of k and v into stage s of the ring, as one copy group
  auto load_kv = [&](int i, int s) {
    if (i < n_tiles) {
      load_tile<DP, KN, NT>(sK + s * L::kv_tile, k, b, h, i * KN, Tk, H, D,
                            vec);
      load_tile<DP, KN, NT>(sV + s * L::kv_tile, v, b, h, i * KN, Tk, H, D,
                            vec);
    }
    cp_async_commit();
  };
  load_tile<DP, QR, NT>(sQ, q, b, h, q0, Tq, H, D, vec);
#pragma unroll
  for (int i = 0; i < S - 1; ++i) load_kv(i, i);   // q goes with tile 0

  // per row (g, g + 8): the output, the running max of the log2-scaled
  // logits, this lane's share of the running sum (the quad's four shares
  // are added once at the end: the rescaling is the same for all four)
  float acc[NO][4], row_m[2] = {kNegBig, kNegBig}, row_l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int it = 0, st = 0; it < n_tiles; ++it, st = st + 1 < S ? st + 1
                                                                : 0) {
    const int k0 = it * KN;
    cp_async_wait<S - 2>();        // tile it (and q) has landed ...
    __syncthreads();               // ... for every thread, and every warp
                                   // is done with tile it - 1
    load_kv(it + S - 1, st > 0 ? st - 1 : S - 1);   // into its stage
    const unsigned ck = bk_at + st * (2 * L::kv_tile);
    const unsigned cv = bv_at + st * (2 * L::kv_tile);

    // s = q k^T, 16 rows x KN keys: one MMA per depth step of 16, exact
    // bf16 products summed in f32 (q's fragments read again each tile:
    // held in registers for the whole loop they cost more than the reads)
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t aq[4];
      ldsm_x4(aq, aq_at + 32 * kk);
#pragma unroll
      for (int n2 = 0; n2 < NS / 2; ++n2) {
        uint32_t bk[4];
        ldsm_x4(bk, ck + 2 * (16 * n2 * LDS + 16 * kk));
        mma16(s[2 * n2], aq, bk[0], bk[1], tag);
        mma16(s[2 * n2 + 1], aq, bk[2], bk[3], tag);
      }
    }

    const int r0 = q0 + m0;      // this warp's first row
    // online softmax in the C fragments (rows g, g + 8; keys 2t, 2t + 1
    // of each n8 tile); a masked logit is -inf, so its p is 0 whatever
    // the running max.  Only a tile past Tk or across the diagonal
    // masks.
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] *= scale2;
    if (k0 + KN > Tk || (causal && k0 + KN - 1 > r0)) {
      const float neg_inf = __int_as_float(0xff800000);
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = r0 + g + 8 * (e >> 1);
          const int kj = k0 + n * 8 + 2 * t + (e & 1);
          s[n][e] = kj < Tk && !(causal && qi < kj) ? s[n][e] : neg_inf;
        }
    }
    float mx[2] = {kNegBig, kNegBig};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
    float corr[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
      mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
      const float m_new = fmaxf(row_m[half], mx[half]);
      corr[half] = exp2_approx(row_m[half] - m_new);
      row_m[half] = m_new;
      row_l[half] *= corr[half];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2_approx(s[n][e] - row_m[e >> 1]);
        row_l[e >> 1] += s[n][e];
      }

    // out = out corr + p v, p as bf16 hi + lo (two MMAs per depth step,
    // the small term first) into a fresh accumulator per tile and CH
    // column tiles: the tensor core truncates as it accumulates (f16: p
    // times kPScale, undone with 1 / l)
#pragma unroll
    for (int c0 = 0; c0 < NO; c0 += CH) {
      float pv[CH][4];
#pragma unroll
      for (int n = 0; n < CH; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NS / 2; ++j) {
        uint32_t ph[4], pl[4];
        if constexpr (F16)
          split_frag<E>(s[2 * j], s[2 * j + 1], ph, pl, kPScale);
        else
          split_frag<E>(s[2 * j], s[2 * j + 1], ph, pl);
        uint32_t bv[CH / 2][4];
#pragma unroll
        for (int n2 = 0; n2 < CH / 2; ++n2)
          ldsm_x4_t(bv[n2], cv + 2 * (16 * j * LDS + (c0 + 2 * n2) * 8));
#pragma unroll
        for (int n2 = 0; n2 < CH / 2; ++n2) {
          mma16(pv[2 * n2], pl, bv[n2][0], bv[n2][1], tag);
          mma16(pv[2 * n2 + 1], pl, bv[n2][2], bv[n2][3], tag);
        }
#pragma unroll
        for (int n2 = 0; n2 < CH / 2; ++n2) {
          mma16(pv[2 * n2], ph, bv[n2][0], bv[n2][1], tag);
          mma16(pv[2 * n2 + 1], ph, bv[n2][2], bv[n2][3], tag);
        }
      }
#pragma unroll
      for (int n = 0; n < CH; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[c0 + n][e] = fmaf(acc[c0 + n][e], corr[e >> 1], pv[n][e]);
    }
  }
  cp_async_wait<0>();              // the ring's empty trailing groups

  // the quad's shares of each row's sum; out = acc / l; lse in natural
  // log units, m + log(max(l, 1e-37)) of the scaled logits
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float l = row_l[half];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = F16 ? kPUnscale / l : 1.f / l;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][2 * half] *= inv;
      acc[n][2 * half + 1] *= inv;
    }
    const int row = q0 + m0 + g + 8 * half;
    if (lse != nullptr && t == 0 && row < Tq)
      lse[(size_t)bh * Tq + row] =
          row_m[half] * kLn2 + logf(fmaxf(l, 1e-37f));
  }
  store_frags<DP>(out, acc, b, h, q0, Tq, H, D, m0, g, t);
}

// ---------------------------------------------------------------------------
// B9 dK/dV
// ---------------------------------------------------------------------------

// shared memory of dK/dV: lse and delta (kDkvStages stages of kDkvRows
// f32 each), then in bf16 elements k, v, kDkvStages stages of q and of
// dO, rows padded as the forward's
template <int DP>
struct DkvBf16Smem {
  static constexpr int LDS = DP + 8;
  static constexpr int tile = kDkvRows * LDS;
  static constexpr int rows_f32 = 2 * kDkvStages * kDkvRows;
  static constexpr size_t bytes =
      4 * rows_f32 + 2 * (2 + 2 * kDkvStages) * tile;
};

template <int DP, typename E>
__global__ void __launch_bounds__(kDkvThreads, kDkvMinBlocks)
flash_bwd_dkv16_kernel(const E* __restrict__ q, const E* __restrict__ k,
                       const E* __restrict__ v, const E* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       E* __restrict__ dk, E* __restrict__ dv, int H,
                       int Tq, int Tk, int D, int causal, float scale,
                       int vec) {
  using L = DkvBf16Smem<DP>;
  constexpr int LDS = L::LDS;
  constexpr int R = kDkvRows;      // keys of the block, q rows of a tile
  constexpr int NT = kDkvThreads;
  constexpr int NK = DP / 16;      // depth steps of k q^T and v dO^T
  constexpr int NS = R / 8;        // n8 tiles of s^T (queries of a tile)
  constexpr int NO = DP / 8;       // n8 tiles of dk, dv
  constexpr int CH = NO < 8 ? NO : 8;   // dk, dv tiles per pass
  constexpr int S = kDkvStages;
  constexpr bool F16 = kIsF16<E>;
  const E* tag = nullptr;
  extern __shared__ __align__(16) float smem[];
  float* sL = smem;                // lse of the q tiles, S stages
  float* sD = smem + S * R;        // delta
  E* sK = reinterpret_cast<E*>(smem + L::rows_f32);   // the keys
  E* sV = sK + L::tile;
  E* sQ = sV + L::tile;            // S stages
  E* sO = sQ + S * L::tile;        // dO, S stages

  // causal: early k tiles have the most q tiles to visit; blocks run in
  // the order of blockIdx.x + gridDim.x blockIdx.y, so every head's first
  // k tile goes first
  const int k0 = (int)blockIdx.y * R;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = (threadIdx.x >> 5) * 16;
  const float scale2 = scale * kLog2e;
  // this lane's ldmatrix rows (bytes): k's and v's A fragments; q's and
  // dO's B fragments with queries as columns, and with queries as depth
  // (.trans)
  const int a_at = 2 * (m0 * LDS + a_lane<LDS>(lane));
  const unsigned ak_at = smem_u32(sK) + a_at;
  const unsigned av_at = smem_u32(sV) + a_at;
  const unsigned bq_at = smem_u32(sQ) + 2 * b_lane<LDS>(lane);
  const unsigned bo_at = smem_u32(sO) + 2 * b_lane<LDS>(lane);
  const unsigned tq_at = smem_u32(sQ) + 2 * bt_lane<LDS>(lane);
  const unsigned to_at = smem_u32(sO) + 2 * bt_lane<LDS>(lane);

  float ak[NO][4], av[NO][4];      // dk and dv, keys as rows
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[n][e] = av[n][e] = 0.f;
  int row_e[2] = {kEMin, kEMin};   // f16: ds^T's scale of rows g, g + 8

  // causal: q rows below k0 see none of these keys
  const int q_begin = causal ? k0 : 0;
  const int n_tiles = q_begin < Tq ? (Tq - q_begin + R - 1) / R : 0;
  // q tile i's copies into stage s of the ring, as one copy group: q,
  // dO, and lse (threads 0-63) and delta (64-127) of its rows, zero past
  // Tq
  const int rr = threadIdx.x & (R - 1);
  const float* rsrc = threadIdx.x < R ? lse : delta;
  float* rdst = threadIdx.x < R ? sL : sD;
  auto load_q_tile = [&](int i, int s) {
    if (i < n_tiles) {
      const int t0 = q_begin + i * R;
      load_tile<DP, R, NT>(sQ + s * L::tile, q, b, h, t0, Tq, H, D, vec);
      load_tile<DP, R, NT>(sO + s * L::tile, dout, b, h, t0, Tq, H, D, vec);
      const bool ok = t0 + rr < Tq;
      cp_async4(rdst + s * R + rr,
                ok ? rsrc + (size_t)bh * Tq + t0 + rr : rsrc, ok ? 4 : 0);
    }
    cp_async_commit();
  };
  if (n_tiles > 0) {               // k and v go with q tile 0
    load_tile<DP, R, NT>(sK, k, b, h, k0, Tk, H, D, vec);
    load_tile<DP, R, NT>(sV, v, b, h, k0, Tk, H, D, vec);
#pragma unroll
    for (int i = 0; i < S - 1; ++i) load_q_tile(i, i);
  }

  for (int it = 0, st = 0; it < n_tiles; ++it, st = st + 1 < S ? st + 1
                                                                : 0) {
    const int q0 = q_begin + it * R;
    cp_async_wait<S - 2>();        // q tile it (and k, v) has landed ...
    __syncthreads();               // ... for every thread, and every warp
                                   // is done with tile it - 1
    load_q_tile(it + S - 1, st > 0 ? st - 1 : S - 1);   // into its stage
    const unsigned so = st * (2 * L::tile);   // the stage, in bytes
    const float* cL = sL + st * R;
    const float* cD = sD + st * R;

    // transposed scores s^T = k q^T and dp^T = v dO^T: this warp's 16
    // keys x R queries, one MMA per depth step of 16 each (exact products)
    float sT[NS][4], dpT[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sT[n][e] = dpT[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t fk[4], fv[4];
      ldsm_x4(fk, ak_at + 32 * kk);
      ldsm_x4(fv, av_at + 32 * kk);
#pragma unroll
      for (int n2 = 0; n2 < NS / 2; ++n2) {
        uint32_t bq[4], bo[4];
        ldsm_x4(bq, bq_at + so + 2 * (16 * n2 * LDS + 16 * kk));
        ldsm_x4(bo, bo_at + so + 2 * (16 * n2 * LDS + 16 * kk));
        mma16(sT[2 * n2], fk, bq[0], bq[1], tag);
        mma16(sT[2 * n2 + 1], fk, bq[2], bq[3], tag);
        mma16(dpT[2 * n2], fv, bo[0], bo[1], tag);
        mma16(dpT[2 * n2 + 1], fv, bo[2], bo[3], tag);
      }
    }

    // p^T = exp(s scale - lse), ds^T = p^T (dp^T - delta) scale, in place
    // of s^T and dp^T; p^T is 0 where masked (only a tile past Tq or
    // across the diagonal masks)
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const int c = n * 8 + 2 * t;
      const float2 l2 = *reinterpret_cast<const float2*>(cL + c);
      const float ls[2] = {l2.x * kLog2e, l2.y * kLog2e};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        sT[n][e] = exp2_approx(fmaf(sT[n][e], scale2, -ls[e & 1]));
    }
    if (q0 + R > Tq || (causal && q0 < k0 + m0 + 15)) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = k0 + m0 + g + 8 * (e >> 1);
          const int qi = q0 + n * 8 + 2 * t + (e & 1);
          sT[n][e] = qi < Tq && !(causal && qi < kj) ? sT[n][e] : 0.f;
        }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float2 d2 = *reinterpret_cast<const float2*>(cD + n * 8 + 2 * t);
      const float dl[2] = {d2.x, d2.y};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpT[n][e] = sT[n][e] * (dpT[n][e] - dl[e & 1]) * scale;
    }
    if constexpr (F16) rescale_rows(dpT, ak, row_e);

    // dv += p^T dO, dk += ds^T q: p^T and ds^T as bf16 hi + lo A
    // fragments straight from the C fragments (two MMAs each, the small
    // term first), dO and q as B fragments down their rows (.trans); f16:
    // p^T times kPScale, ds^T times its rows' 2^-e
#pragma unroll
    for (int j = 0; j < NS / 2; ++j) {
      uint32_t ph[4], pl[4], sh[4], sl[4];
      if constexpr (F16)
        split_frag<E>(sT[2 * j], sT[2 * j + 1], ph, pl, kPScale);
      else
        split_frag<E>(sT[2 * j], sT[2 * j + 1], ph, pl);
      split_frag<E>(dpT[2 * j], dpT[2 * j + 1], sh, sl);
#pragma unroll
      for (int c0 = 0; c0 < NO; c0 += CH) {
        uint32_t bo[CH / 2][4], bq[CH / 2][4];
#pragma unroll
        for (int n2 = 0; n2 < CH / 2; ++n2) {
          const int at = 2 * (16 * j * LDS + (c0 + 2 * n2) * 8);
          ldsm_x4_t(bo[n2], to_at + so + at);
          ldsm_x4_t(bq[n2], tq_at + so + at);
        }
#pragma unroll
        for (int n2 = 0; n2 < CH / 2; ++n2) {
          mma16(av[c0 + 2 * n2], pl, bo[n2][0], bo[n2][1], tag);
          mma16(av[c0 + 2 * n2 + 1], pl, bo[n2][2], bo[n2][3], tag);
          mma16(ak[c0 + 2 * n2], sl, bq[n2][0], bq[n2][1], tag);
          mma16(ak[c0 + 2 * n2 + 1], sl, bq[n2][2], bq[n2][3], tag);
        }
#pragma unroll
        for (int n2 = 0; n2 < CH / 2; ++n2) {
          mma16(av[c0 + 2 * n2], ph, bo[n2][0], bo[n2][1], tag);
          mma16(av[c0 + 2 * n2 + 1], ph, bo[n2][2], bo[n2][3], tag);
          mma16(ak[c0 + 2 * n2], sh, bq[n2][0], bq[n2][1], tag);
          mma16(ak[c0 + 2 * n2 + 1], sh, bq[n2][2], bq[n2][3], tag);
        }
      }
    }
  }
  cp_async_wait<0>();              // the ring's empty trailing groups
  if constexpr (F16) {
    unscale_rows(ak, row_e);
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) av[n][e] *= kPUnscale;
  }
  store_frags<DP>(dk, ak, b, h, k0, Tk, H, D, m0, g, t);
  store_frags<DP>(dv, av, b, h, k0, Tk, H, D, m0, g, t);
}


// ---------------------------------------------------------------------------
// B9 dQ
// ---------------------------------------------------------------------------

// 4 warps of 16 q rows a block; k and v tiles of kDqKeys keys in a ring of
// kDqStages; 3 blocks per SM up to DP = 64 (at most 168 registers: 10%
// faster than 2 at the training shape on an NVIDIA H100 80GB HBM3 at 700
// W), one at DP = 128 (139 KB of shared memory)
constexpr int kDqRows = 64;
constexpr int kDqThreads = 128;
constexpr int kDqKeys = 64;
constexpr int kDqStages = 2;

// shared memory of dQ, in bf16 elements: q, dO, then kDqStages stages of
// k and of v, rows padded as the forward's
template <int DP>
struct DqBf16Smem {
  static constexpr int LDS = DP + 8;
  static constexpr int q_tile = kDqRows * LDS;
  static constexpr int kv_tile = kDqKeys * LDS;
  static constexpr int total = 2 * q_tile + 2 * kDqStages * kv_tile;
};

template <int DP, typename E>
__global__ void __launch_bounds__(kDqThreads, DP <= 64 ? 3 : 1)
flash_bwd_dq16_kernel(const E* __restrict__ q, const E* __restrict__ k,
                      const E* __restrict__ v, const E* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      E* __restrict__ dq, int H, int Tq, int Tk, int D,
                      int causal, float scale, int vec) {
  using L = DqBf16Smem<DP>;
  constexpr int LDS = L::LDS;
  constexpr int QR = kDqRows;      // q rows of the block
  constexpr int KN = kDqKeys;
  constexpr int NT = kDqThreads;
  constexpr int NK = DP / 16;      // depth steps of q k^T and dO v^T
  constexpr int NS = KN / 8;       // n8 tiles of s and dp (keys of a tile)
  constexpr int NO = DP / 8;       // n8 tiles of dq
  constexpr int CH = NO < 8 ? NO : 8;   // dq tiles per pass
  constexpr int S = kDqStages;
  constexpr bool F16 = kIsF16<E>;
  const E* tag = nullptr;
  extern __shared__ __align__(16) float smem[];
  E* sQ = reinterpret_cast<E*>(smem);
  E* sO = sQ + L::q_tile;          // dO
  E* sK = sO + L::q_tile;          // S stages
  E* sV = sK + S * L::kv_tile;     // S stages

  // blocks run in the order of blockIdx.x + gridDim.x blockIdx.y: every
  // head's heaviest (causal: last) q tile first
  const int q0 = (gridDim.y - 1 - (int)blockIdx.y) * QR;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int m0 = (threadIdx.x >> 5) * 16;
  const float scale2 = scale * kLog2e;
  // this lane's ldmatrix rows (bytes): q's and dO's A fragments; k's and
  // v's B fragments with keys as columns, and k's with keys as depth
  // (.trans)
  const int a_at = 2 * (m0 * LDS + a_lane<LDS>(lane));
  const unsigned aq_at = smem_u32(sQ) + a_at;
  const unsigned ao_at = smem_u32(sO) + a_at;
  const unsigned bk_at = smem_u32(sK) + 2 * b_lane<LDS>(lane);
  const unsigned bv_at = smem_u32(sV) + 2 * b_lane<LDS>(lane);
  const unsigned tk_at = smem_u32(sK) + 2 * bt_lane<LDS>(lane);

  // causal: keys past the block's last row are masked for all its rows
  const int k_end = causal ? min(Tk, q0 + QR) : Tk;
  const int n_tiles = (k_end + KN - 1) / KN;
  // tile i of k and v into stage s of the ring, as one copy group
  auto load_kv = [&](int i, int s) {
    if (i < n_tiles) {
      load_tile<DP, KN, NT>(sK + s * L::kv_tile, k, b, h, i * KN, Tk, H, D,
                            vec);
      load_tile<DP, KN, NT>(sV + s * L::kv_tile, v, b, h, i * KN, Tk, H, D,
                            vec);
    }
    cp_async_commit();
  };
  load_tile<DP, QR, NT>(sQ, q, b, h, q0, Tq, H, D, vec);
  load_tile<DP, QR, NT>(sO, dout, b, h, q0, Tq, H, D, vec);
#pragma unroll
  for (int i = 0; i < S - 1; ++i) load_kv(i, i);   // q, dO go with tile 0

  // lse (times log2 e) and delta of this lane's two rows, in registers for
  // the whole loop
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + m0 + g + 8 * half;
    row_lse[half] = row < Tq ? lse[(size_t)bh * Tq + row] * kLog2e : 0.f;
    row_delta[half] = row < Tq ? delta[(size_t)bh * Tq + row] : 0.f;
  }

  float acc[NO][4];                // dq, this warp's 16 rows
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  int row_e[2] = {kEMin, kEMin};   // f16: ds's scale of rows g, g + 8

  for (int it = 0, st = 0; it < n_tiles; ++it, st = st + 1 < S ? st + 1
                                                                : 0) {
    const int k0 = it * KN;
    cp_async_wait<S - 2>();        // tile it (and q, dO) has landed ...
    __syncthreads();               // ... for every thread, and every warp
                                   // is done with tile it - 1
    load_kv(it + S - 1, st > 0 ? st - 1 : S - 1);   // into its stage
    const unsigned so = st * (2 * L::kv_tile);   // the stage, in bytes

    // s = q k^T and dp = dO v^T, 16 rows x KN keys: one MMA per depth
    // step of 16 each (exact bf16 products summed in f32)
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NK; ++kk) {
      uint32_t aq[4], ao[4];
      ldsm_x4(aq, aq_at + 32 * kk);
      ldsm_x4(ao, ao_at + 32 * kk);
#pragma unroll
      for (int n2 = 0; n2 < NS / 2; ++n2) {
        const unsigned at = so + 2 * (16 * n2 * LDS + 16 * kk);
        uint32_t bk[4], bv[4];
        ldsm_x4(bk, bk_at + at);
        ldsm_x4(bv, bv_at + at);
        mma16(s[2 * n2], aq, bk[0], bk[1], tag);
        mma16(s[2 * n2 + 1], aq, bk[2], bk[3], tag);
        mma16(dp[2 * n2], ao, bv[0], bv[1], tag);
        mma16(dp[2 * n2 + 1], ao, bv[2], bv[3], tag);
      }
    }

    // p = exp(s scale - lse) in exp2 units in place of s, 0 where masked
    // (only a tile past Tk or across the diagonal masks); ds = p (dp -
    // delta) scale in place of dp
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = exp2_approx(fmaf(s[n][e], scale2, -row_lse[e >> 1]));
    const int r0 = q0 + m0;        // this warp's first row
    if (k0 + KN > Tk || (causal && k0 + KN - 1 > r0)) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = r0 + g + 8 * (e >> 1);
          const int kj = k0 + n * 8 + 2 * t + (e & 1);
          s[n][e] = kj < Tk && !(causal && qi < kj) ? s[n][e] : 0.f;
        }
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dp[n][e] = s[n][e] * (dp[n][e] - row_delta[e >> 1]) * scale;
    if constexpr (F16) rescale_rows(dp, acc, row_e);

    // dq += ds k: ds as bf16 hi + lo A fragments straight from the C
    // fragments (two MMAs, the small term first), k as B fragments with
    // keys as depth (.trans); f16: ds times its rows' 2^-e
#pragma unroll
    for (int j = 0; j < NS / 2; ++j) {
      uint32_t sh[4], sl[4];
      split_frag<E>(dp[2 * j], dp[2 * j + 1], sh, sl);
#pragma unroll
      for (int c0 = 0; c0 < NO; c0 += CH) {
        uint32_t bk[CH / 2][4];
#pragma unroll
        for (int n2 = 0; n2 < CH / 2; ++n2)
          ldsm_x4_t(bk[n2],
                    tk_at + so + 2 * (16 * j * LDS + (c0 + 2 * n2) * 8));
#pragma unroll
        for (int n2 = 0; n2 < CH / 2; ++n2) {
          mma16(acc[c0 + 2 * n2], sl, bk[n2][0], bk[n2][1], tag);
          mma16(acc[c0 + 2 * n2 + 1], sl, bk[n2][2], bk[n2][3], tag);
        }
#pragma unroll
        for (int n2 = 0; n2 < CH / 2; ++n2) {
          mma16(acc[c0 + 2 * n2], sh, bk[n2][0], bk[n2][1], tag);
          mma16(acc[c0 + 2 * n2 + 1], sh, bk[n2][2], bk[n2][3], tag);
        }
      }
    }
  }
  cp_async_wait<0>();              // the ring's empty trailing groups
  if constexpr (F16) unscale_rows(acc, row_e);
  store_frags<DP>(dq, acc, b, h, q0, Tq, H, D, m0, g, t);
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

// whole 16-byte copies: D a multiple of the elements in 16 bytes (4 f32,
// 8 bf16) and every (B, T, H, D) operand 16-byte aligned
template <typename T>
int vec_copies(int D, const T* a, const T* b, const T* c, const T* d) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(a) |
                        reinterpret_cast<uintptr_t>(b) |
                        reinterpret_cast<uintptr_t>(c) |
                        reinterpret_cast<uintptr_t>(d);
  return D % (16 / sizeof(T)) == 0 && any % 16 == 0;
}

template <int DP>
int launch_fwd(const float* q, const float* k, const float* v, float* out,
               float* lse, int B, int H, int Tq, int Tk, int D, int causal,
               float scale, cudaStream_t st) {
  const size_t smem = sizeof(float) * FwdSmem<DP>::total;
  cudaError_t rc = prepare(flash_fwd_kernel<DP>, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((Tq + kFwdRows - 1) / kFwdRows, B * H);
  flash_fwd_kernel<DP><<<grid, kFwdThreads, smem, st>>>(
      q, k, v, out, lse, H, Tq, Tk, D, causal, scale,
      vec_copies(D, q, k, v, v));
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* delta,
              float* dq, int B, int H, int Tq, int Tk, int D, int causal,
              float scale, cudaStream_t st) {
  const size_t smem = sizeof(float) * DqSmem<DP>::total;
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
  const size_t smem = sizeof(float) * DkvSmem<DP>::total;
  cudaError_t rc = prepare(flash_bwd_dkv_kernel<DP>, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid((Tk + kB - 1) / kB, B * H);
  flash_bwd_dkv_kernel<DP><<<grid, kBwdThreads, smem, st>>>(
      q, k, v, dout, lse, delta, dk, dv, H, Tq, Tk, D, causal, scale,
      vec_copies(D, q, k, v, dout));
  return static_cast<int>(cudaGetLastError());
}

// B9: the bf16 and f16 kernels (overloads of the f32 launchers above,
// which partial ordering prefers for f32)
template <int DP, typename E>
int launch_fwd(const E* q, const E* k, const E* v, E* out, float* lse,
               int B, int H, int Tq, int Tk, int D, int causal, float scale,
               cudaStream_t st) {
  const size_t smem = sizeof(E) * FwdBf16Smem<DP>::total;
  cudaError_t rc = prepare(flash_fwd16_kernel<DP, E>, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid(B * H, (Tq + kFwdRows16 - 1) / kFwdRows16);
  flash_fwd16_kernel<DP, E><<<grid, kFwdThreads16, smem, st>>>(
      q, k, v, out, lse, H, Tq, Tk, D, causal, scale,
      vec_copies(D, q, k, v, v));
  return static_cast<int>(cudaGetLastError());
}

template <int DP, typename E>
int launch_dq(const E* q, const E* k, const E* v, const E* dout,
              const float* lse, const float* delta, E* dq, int B, int H,
              int Tq, int Tk, int D, int causal, float scale,
              cudaStream_t st) {
  const size_t smem = sizeof(E) * DqBf16Smem<DP>::total;
  cudaError_t rc = prepare(flash_bwd_dq16_kernel<DP, E>, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid(B * H, (Tq + kDqRows - 1) / kDqRows);
  flash_bwd_dq16_kernel<DP, E><<<grid, kDqThreads, smem, st>>>(
      q, k, v, dout, lse, delta, dq, H, Tq, Tk, D, causal, scale,
      vec_copies(D, q, k, v, dout));
  return static_cast<int>(cudaGetLastError());
}

template <int DP, typename E>
int launch_dkv(const E* q, const E* k, const E* v, const E* dout,
               const float* lse, const float* delta, E* dk, E* dv, int B,
               int H, int Tq, int Tk, int D, int causal, float scale,
               cudaStream_t st) {
  const size_t smem = DkvBf16Smem<DP>::bytes;
  cudaError_t rc = prepare(flash_bwd_dkv16_kernel<DP, E>, smem);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid(B * H, (Tk + kDkvRows - 1) / kDkvRows);
  flash_bwd_dkv16_kernel<DP, E><<<grid, kDkvThreads, smem, st>>>(
      q, k, v, dout, lse, delta, dk, dv, H, Tq, Tk, D, causal, scale,
      vec_copies(D, q, k, v, dout));
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int B, int H, int Tq, int Tk, int D) {
  return B <= 0 || H <= 0 || Tq <= 0 || Tk <= 0 || D <= 0 || D > 128 ||
         (long long)B * H > 65535;
}

template <typename T>
int fwd(const T* q, const T* k, const T* v, T* out, float* lse, int B, int H,
        int Tq, int Tk, int D, int causal, float scale, void* stream) {
  if (bad_shape(B, H, Tq, Tk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return launch_fwd<32>(q, k, v, out, lse, B, H, Tq, Tk, D, causal,
                          scale, st);
  if (D <= 64)
    return launch_fwd<64>(q, k, v, out, lse, B, H, Tq, Tk, D, causal,
                          scale, st);
  return launch_fwd<128>(q, k, v, out, lse, B, H, Tq, Tk, D, causal, scale,
                         st);
}

template <typename T>
int bwd_dq(const T* q, const T* k, const T* v, const T* dout,
           const float* lse, const float* delta, T* dq, int B, int H, int Tq,
           int Tk, int D, int causal, float scale, void* stream) {
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

template <typename T>
int bwd_dkv(const T* q, const T* k, const T* v, const T* dout,
            const float* lse, const float* delta, T* dk, T* dv, int B, int H,
            int Tq, int Tk, int D, int causal, float scale, void* stream) {
  if (bad_shape(B, H, Tq, Tk, D))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 32)
    return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk,
                          D, causal, scale, st);
  if (D <= 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk,
                          D, causal, scale, st);
  return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk,
                         D, causal, scale, st);
}

}  // namespace

// out (B, Tq, H, D); lse (B*H, Tq) or null (then it is not written).
extern "C" int mxt_flash_attention_fwd(const float* q, const float* k,
                                       const float* v, float* out,
                                       float* lse, int B, int H, int Tq,
                                       int Tk, int D, int causal,
                                       float scale, void* stream) {
  return fwd(q, k, v, out, lse, B, H, Tq, Tk, D, causal, scale, stream);
}

extern "C" int mxt_flash_attention_bwd_dq(const float* q, const float* k,
                                          const float* v, const float* dout,
                                          const float* lse,
                                          const float* delta, float* dq,
                                          int B, int H, int Tq, int Tk, int D,
                                          int causal, float scale,
                                          void* stream) {
  return bwd_dq(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, D, causal,
                scale, stream);
}

extern "C" int mxt_flash_attention_bwd_dkv(const float* q, const float* k,
                                           const float* v, const float* dout,
                                           const float* lse,
                                           const float* delta, float* dk,
                                           float* dv, int B, int H, int Tq,
                                           int Tk, int D, int causal,
                                           float scale, void* stream) {
  return bwd_dkv(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, D, causal,
                 scale, stream);
}

// B9: the same in bf16 (q, k, v, dO, out, dq, dk, dv); lse and delta f32.
extern "C" int mxt_flash_attention_fwd_bf16(const bf16* q, const bf16* k,
                                            const bf16* v, bf16* out,
                                            float* lse, int B, int H, int Tq,
                                            int Tk, int D, int causal,
                                            float scale, void* stream) {
  return fwd(q, k, v, out, lse, B, H, Tq, Tk, D, causal, scale, stream);
}

extern "C" int mxt_flash_attention_bwd_dq_bf16(
    const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
    const float* lse, const float* delta, bf16* dq, int B, int H, int Tq,
    int Tk, int D, int causal, float scale, void* stream) {
  return bwd_dq(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, D, causal,
                scale, stream);
}

extern "C" int mxt_flash_attention_bwd_dkv_bf16(
    const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
    const float* lse, const float* delta, bf16* dk, bf16* dv, int B, int H,
    int Tq, int Tk, int D, int causal, float scale, void* stream) {
  return bwd_dkv(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, D, causal,
                 scale, stream);
}

// B9 f16: the same in f16 (q, k, v, dO, out, dq, dk, dv); lse and delta f32.
extern "C" int mxt_flash_attention_fwd_f16(const __half* q, const __half* k,
                                           const __half* v, __half* out,
                                           float* lse, int B, int H, int Tq,
                                           int Tk, int D, int causal,
                                           float scale, void* stream) {
  return fwd(q, k, v, out, lse, B, H, Tq, Tk, D, causal, scale, stream);
}

extern "C" int mxt_flash_attention_bwd_dq_f16(
    const __half* q, const __half* k, const __half* v, const __half* dout,
    const float* lse, const float* delta, __half* dq, int B, int H, int Tq,
    int Tk, int D, int causal, float scale, void* stream) {
  return bwd_dq(q, k, v, dout, lse, delta, dq, B, H, Tq, Tk, D, causal,
                scale, stream);
}

extern "C" int mxt_flash_attention_bwd_dkv_f16(
    const __half* q, const __half* k, const __half* v, const __half* dout,
    const float* lse, const float* delta, __half* dk, __half* dv, int B,
    int H, int Tq, int Tk, int D, int causal, float scale, void* stream) {
  return bwd_dkv(q, k, v, dout, lse, delta, dk, dv, B, H, Tq, Tk, D, causal,
                 scale, stream);
}
