// Paged single-query decode attention for Hopper (sm_90a).
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py decode_attention
//   (_decode_attn_pallas / _decode_attn_kernel, the pallas_call at :589).
//
// What it computes: for every decode slot s and head h,
//   out[s,h,:] = softmax(q[s,h,:] . K[s,h,t,:] * scale, t < seq_lens[s]) @ V
// where K/V of logical token t live in the page pool at
//   pool[page_table[s, t / page], h, t % page, :].
//
// What bounds it on the H100: bytes.  Each cached token costs one K row
// and one V row (2 * D * 4 bytes) and 4 * D flops, about 0.5 flop/byte,
// far below the ~20 flop/byte at which the card's f32 pipes would be the
// limit.  The least time is 2 * sum(seq_lens) * H * D * 4 bytes over
// 3.35 TB/s, plus q and out.
//
// What the design does about it:
//  * It reads only live pages.  The TPU kernel's grid walks every page
//    table entry and DMAs the trash page for dead ones (:528-531); here a
//    block stops at ceil(seq_lens[s] / page), so dead pages are never
//    loaded.  A loop inside the block replaces the TPU's sequential page
//    axis, and the block reads page_table[s, j] itself (no prefetch).
//  * One block per (slot, head).  The block copies its slot's live
//    page-table entries to shared memory once; then each warp owns a run
//    of kUnroll tokens at a time and its lanes span D, so a token's K row
//    is one coalesced 128-byte access per 32 dims and kUnroll rows are in
//    flight at once.
//  * Online softmax (running max m, running sum l, accumulator acc) is
//    kept per warp in registers; the warps' states merge once through
//    shared memory at the end.
//  * Masking follows the TPU kernel: running max starts at -1e30
//    (_NEG_BIG), and the row sum is floored at 1e-37 (:559-561), so an
//    inactive slot (seq_lens == 0) returns 0.
//
// Not yet done (later PRs): split-K across blocks for long sequences
// (only S*H = 96 blocks at the full width), cp.async/TMA staging of pages.
//
// Interface: plain C, launched on the caller's stream, allocates nothing,
// returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 8;
constexpr float kNegBig = -1e30f;

template <int DPL>   // dims per lane: D <= 32 * DPL
__global__ void __launch_bounds__(kWarps * 32)
decode_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k_pages,
                        const float* __restrict__ v_pages,
                        const int32_t* __restrict__ page_table,
                        const int32_t* __restrict__ seq_lens,
                        float* __restrict__ out,
                        int H, int D, int page, int max_pages,
                        int num_pages, float scale) {
  const int h = blockIdx.x;
  const int s = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  __shared__ float sm_m[kWarps];
  __shared__ float sm_l[kWarps];
  __shared__ float sm_acc[kWarps][32 * DPL];
  extern __shared__ int32_t sm_pt[];     // the slot's live page ids

  float qv[DPL];
  float acc[DPL];
  const float* qp = q + ((size_t)s * H + h) * D;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < D ? qp[d] * scale : 0.f;
    acc[i] = 0.f;
  }
  float m = kNegBig;
  float l = 0.f;

  int len = seq_lens[s];
  len = len < 0 ? 0 : len;
  const int cap = max_pages * page;
  len = len > cap ? cap : len;
  // the block reads its slot's page-table row once, live pages only,
  // clamped into the pool (an XLA gather clamps out-of-range ids too)
  const int live_pages = (len + page - 1) / page;
  const int32_t* pt = page_table + (size_t)s * max_pages;
  for (int j = threadIdx.x; j < live_pages; j += blockDim.x) {
    const int pid = pt[j];
    sm_pt[j] = pid < 0 ? 0 : (pid >= num_pages ? num_pages - 1 : pid);
  }
  __syncthreads();
  const size_t head_stride = (size_t)page * D;      // one (page, D) plane
  const size_t page_stride = (size_t)H * head_stride;

  for (int base = warp * kUnroll; base < len; base += kWarps * kUnroll) {
    float sc[kUnroll];
    float vv[kUnroll][DPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = base + u;
      float part = 0.f;
      if (t < len) {
        const size_t row = sm_pt[t / page] * page_stride + h * head_stride +
                           (size_t)(t % page) * D;
        const float* kr = k_pages + row;
        const float* vr = v_pages + row;
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          const bool ok = d < D;
          part += ok ? qv[i] * kr[d] : 0.f;
          vv[u][i] = ok ? vr[d] : 0.f;
        }
      } else {
#pragma unroll
        for (int i = 0; i < DPL; ++i) vv[u][i] = 0.f;
      }
      sc[u] = part;
    }
    // all lanes get every token's full dot product
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        sc[u] += __shfl_xor_sync(0xffffffffu, sc[u], off);
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (base + u < len) m_new = fmaxf(m_new, sc[u]);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= corr;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float p = base + u < len ? expf(sc[u] - m_new) : 0.f;
      l += p;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] += p * vv[u][i];
    }
    m = m_new;
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) sm_acc[warp][lane + 32 * i] = acc[i];
  __syncthreads();

  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float M = kNegBig;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w] - M);
      L += sm_l[w] * f;
      A += sm_acc[w][d] * f;
    }
    out[((size_t)s * H + h) * D + d] = A / fmaxf(L, 1e-37f);
  }
}

}  // namespace

extern "C" int mxt_decode_attention(const float* q, const float* k_pages,
                                    const float* v_pages,
                                    const int32_t* page_table,
                                    const int32_t* seq_lens, float* out,
                                    int S, int H, int D, int page,
                                    int max_pages, int num_pages,
                                    float scale, void* stream) {
  const dim3 grid(H, S);
  const dim3 block(kWarps * 32);
  const size_t smem = sizeof(int32_t) * (max_pages > 0 ? max_pages : 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  if (D <= 32) {
    decode_attention_kernel<1><<<grid, block, smem, st>>>(
        q, k_pages, v_pages, page_table, seq_lens, out, H, D, page,
        max_pages, num_pages, scale);
  } else if (D <= 64) {
    decode_attention_kernel<2><<<grid, block, smem, st>>>(
        q, k_pages, v_pages, page_table, seq_lens, out, H, D, page,
        max_pages, num_pages, scale);
  } else if (D <= 128) {
    decode_attention_kernel<4><<<grid, block, smem, st>>>(
        q, k_pages, v_pages, page_table, seq_lens, out, H, D, page,
        max_pages, num_pages, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
