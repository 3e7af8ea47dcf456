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
// 3.35 TB/s, plus q and out: 5 us at the full-width decode step, 15 us
// at its full cache.  At that size the kernel is bound by latency unless
// every SM has loads in flight from the first microsecond.
//
// What the design does about it:
//  * The token axis is split.  Each (slot, head) is cut into n_split <= 8
//    chunks of chunk_pages whole pages; block (c, h, s) takes chunk c.
//    chunk_pages comes from the shapes alone (the wrapper's
//    decode_chunk_pages), never from seq_lens, so the wrapper makes no
//    host sync.  A chunk at or past ceil(seq_lens[s] / page) reads
//    nothing, so dead pages are never loaded (the TPU kernel's grid DMAs
//    the trash page for them, :528-531).
//  * The n_split blocks of one (slot, head) form a thread-block cluster.
//    Each leaves its chunk's (m, l, acc) in its shared memory; block 0
//    reads them over distributed shared memory and merges them in chunk
//    order, so reruns are bit-equal.  One launch, no scratch buffer.
//  * K and V are staged through shared memory in tiles of kTile tokens,
//    double-buffered: cp.async copies tile i + 1 while tile i computes.
//    16-byte copies where D % 4 == 0 and the pools, q and out are
//    16-byte aligned; 4-byte copies otherwise (zero-filled past D), with
//    the same compute code.  K rows are padded so the score reads are
//    free of bank conflicts.
//  * Scores: four lanes per token, each over a quarter of D against q
//    held in registers (scale folded in), two shuffles; then lanes span
//    D for p.V, in groups over the tile's tokens.  f32 FMA throughout:
//    at 0.5 flop/byte the tensor cores would buy nothing.
//  * Online softmax per chunk: the running max is uniform over the
//    block, so the groups' (l, acc) add up without rescaling.
//  * Masking follows the TPU kernel: running max starts at -1e30
//    (_NEG_BIG), the row sum is floored at 1e-37 (:559-561), so an
//    inactive slot (seq_lens == 0) returns 0.  seq_lens is clamped to
//    [0, max_pages * page] and page ids into the pool.
//
// Not yet done (later PRs): the full cache runs at about 1.9x its bytes
// bound; a chunk's first tile waits on two dependent loads (seq_lens and
// the page table, then the pages).  TMA bulk copies of whole (page, head)
// planes, and more than 8 chunks (a non-portable cluster), are untried.
//
// Interface: plain C, launched on the caller's stream, allocates nothing,
// returns cudaGetLastError() of the launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;          // 4 warps
constexpr int kTile = 32;              // tokens per staged tile
constexpr int kLanes = kThreads / kTile;   // lanes per token's score (4)
constexpr float kNegBig = -1e30f;
constexpr int kStages = 2;             // staging slots: 37 KB at D 64
constexpr int kMaxSplit = 8;           // the portable cluster size

struct Args {
  const float* q;
  const float* k;
  const float* v;
  const int32_t* page_table;
  const int32_t* seq_lens;
  float* out;
  int H, D, D4, kst, page, max_pages, num_pages, chunk_pages;
  float scale;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of the latest copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ int live_len(const Args& a, int s) {
  const int len = a.seq_lens[s];
  const int cap = a.max_pages * a.page;
  return len < 0 ? 0 : (len > cap ? cap : len);
}

// Start copying tokens [tok0, tok0 + nrow) of head h into the staging
// tiles ks (row stride a.kst) and vs (row stride D4 * 4); spt holds the
// chunk's page ids from page p0.  Scalar copies zero-fill past D.
template <bool kVec>
__device__ __forceinline__ void stage(const Args& a, float* ks, float* vs,
                                      const int* spt, int p0, int h,
                                      int tok0, int nrow) {
  const int vst = a.D4 * 4;
  const int width = kVec ? a.D4 : vst;       // copies per row
  for (int idx = threadIdx.x; idx < nrow * width; idx += kThreads) {
    const int r = idx / width;
    const int c = idx - r * width;
    const int tok = tok0 + r;
    const int lp = tok / a.page;
    const size_t row =
        (((size_t)spt[lp - p0] * a.H + h) * a.page + (tok - lp * a.page)) *
        a.D;
    if (kVec) {
      cp_async16(ks + r * a.kst + c * 4, a.k + row + c * 4, 16);
      cp_async16(vs + r * vst + c * 4, a.v + row + c * 4, 16);
    } else {
      const bool ok = c < a.D;
      cp_async4(ks + r * a.kst + c, ok ? a.k + row + c : a.k, ok ? 4 : 0);
      cp_async4(vs + r * vst + c, ok ? a.v + row + c : a.v, ok ? 4 : 0);
    }
  }
}

// The page-table entry of chunk c that thread tid stages first, loaded
// beside seq_lens[s] (it does not depend on it).
__device__ __forceinline__ int first_page_id(const Args& a, int s, int c) {
  const int j = c * a.chunk_pages + threadIdx.x;
  return threadIdx.x < a.chunk_pages && j < a.max_pages
             ? a.page_table[(size_t)s * a.max_pages + j]
             : 0;
}

// One chunk of one (slot, head): returns its (m, l) and, in threads
// tid < D4, its accumulator quad tid.  pid0 is first_page_id().  The
// block's shared memory is laid out as launch() counts it.
template <int NQ, bool kVec>
__device__ __forceinline__ void chunk_partial(const Args& a, int s, int h,
                                              int c, int len, int pid0,
                                              float* smem, float& m_out,
                                              float& l_out,
                                              float4& acc_out) {
  const int tid = threadIdx.x;
  const int D4 = a.D4;
  const int vst = D4 * 4;
  float* ks = smem;                              // [kStages][kTile][kst]
  float* vs = ks + kStages * kTile * a.kst;      // [kStages][kTile][vst]
  float* sc = vs + kStages * kTile * vst;         // [kTile]
  float* red_l = sc + kTile;                     // [kThreads]
  int* spt = reinterpret_cast<int*>(red_l + kThreads);   // [chunk_pages]

  const int p0 = c * a.chunk_pages;
  const int t0 = p0 * a.page;
  const int t1 = min(t0 + a.chunk_pages * a.page, len);
  const int live = (t1 - 1) / a.page - p0 + 1;   // live pages of the chunk
  const int32_t* pt = a.page_table + (size_t)s * a.max_pages + p0;
  for (int j = tid; j < live; j += kThreads) {
    const int pid = j == tid ? pid0 : pt[j];
    spt[j] = pid < 0 ? 0 : (pid >= a.num_pages ? a.num_pages - 1 : pid);
  }

  // q in registers, scaled: lane j of a token holds quads j, j + 4, ...
  const int lane4 = tid & (kLanes - 1);
  const float* qp = a.q + ((size_t)s * a.H + h) * a.D;
  float4 qr[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const int cq = i * kLanes + lane4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (cq < D4) {
      if (kVec) {
        x = reinterpret_cast<const float4*>(qp)[cq];
      } else {
        const int d = cq * 4;
        x.x = qp[d];
        x.y = d + 1 < a.D ? qp[d + 1] : 0.f;
        x.z = d + 2 < a.D ? qp[d + 2] : 0.f;
        x.w = d + 3 < a.D ? qp[d + 3] : 0.f;
      }
    }
    qr[i] = make_float4(x.x * a.scale, x.y * a.scale, x.z * a.scale,
                        x.w * a.scale);
  }
  __syncthreads();                               // spt

  // p.V layout: G groups of D4 lanes, group g takes tokens g, g + G, ...
  const int G = min(kThreads / D4, kTile);
  const int g = tid / D4;
  const int cq = tid - g * D4;
  const bool pv = g < G;
  float m = kNegBig, l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);

  const int ntok = t1 - t0;
  const int nt = (ntok + kTile - 1) / kTile;
  auto fetch = [&](int tt) {       // tile tt into slot tt % kStages
    if (tt < nt) {
      const int b = tt % kStages;
      stage<kVec>(a, ks + b * kTile * a.kst, vs + b * kTile * vst, spt, p0,
                  h, t0 + tt * kTile, min(kTile, ntok - tt * kTile));
    }
    cp_async_commit();             // empty past the last tile
  };
#pragma unroll
  for (int tt = 0; tt < kStages - 1; ++tt) fetch(tt);
  for (int tt = 0; tt < nt; ++tt) {
    const int b = tt % kStages;
    const int nrow = min(kTile, ntok - tt * kTile);
    float* kb = ks + b * kTile * a.kst;
    float* vb = vs + b * kTile * vst;
    if constexpr (kStages == 1) {  // unstaged: copy, then wait for it
      __syncthreads();             // every thread is done with tile tt - 1
      fetch(tt);
      cp_async_wait<0>();
    } else {
      cp_async_wait<(kStages > 1 ? kStages - 2 : 0)>();
    }
    // tile tt is visible, and every thread is done with tile tt - 1, so
    // its slot takes tile tt + kStages - 1
    __syncthreads();
    if constexpr (kStages > 1) fetch(tt + kStages - 1);
    {  // scores: kLanes lanes per token
      const int r = tid / kLanes;
      const float4* kr = reinterpret_cast<const float4*>(kb + r * a.kst);
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < NQ; ++i) {
        const int cc = i * kLanes + lane4;
        if (cc < D4) {
          const float4 kv = kr[cc];
          part = fmaf(qr[i].x, kv.x, part);
          part = fmaf(qr[i].y, kv.y, part);
          part = fmaf(qr[i].z, kv.z, part);
          part = fmaf(qr[i].w, kv.w, part);
        }
      }
#pragma unroll
      for (int off = 1; off < kLanes; off <<= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane4 == 0) sc[r] = r < nrow ? part : kNegBig;
    }
    __syncthreads();
    float tmax = kNegBig;
#pragma unroll
    for (int r = 0; r < kTile; r += 4) {
      const float4 x = *reinterpret_cast<const float4*>(sc + r);
      tmax = fmaxf(tmax, fmaxf(fmaxf(x.x, x.y), fmaxf(x.z, x.w)));
    }
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    m = m_new;
    if (pv) {
      l *= corr;
      acc.x *= corr;
      acc.y *= corr;
      acc.z *= corr;
      acc.w *= corr;
      for (int r = g; r < nrow; r += G) {
        const float p = expf(sc[r] - m_new);
        const float4 x = *reinterpret_cast<const float4*>(vb + r * vst +
                                                          cq * 4);
        l += p;
        acc.x = fmaf(p, x.x, acc.x);
        acc.y = fmaf(p, x.y, acc.y);
        acc.z = fmaf(p, x.z, acc.z);
        acc.w = fmaf(p, x.w, acc.w);
      }
    }
  }
  // the groups share m: their (l, acc) add up, in group order.  The
  // first staging slot is free: every tile's copy was waited for, and
  // its last reads came before the last barrier.
  float4* red = reinterpret_cast<float4*>(ks);
  if (pv) {
    red[g * D4 + cq] = acc;
    if (cq == 0) red_l[g] = l;
  }
  __syncthreads();
  if (tid < D4) {
    float4 A = red[tid];
    float L = red_l[0];
    for (int gg = 1; gg < G; ++gg) {
      const float4 x = red[gg * D4 + tid];
      A.x += x.x;
      A.y += x.y;
      A.z += x.z;
      A.w += x.w;
      L += red_l[gg];
    }
    acc_out = A;
    l_out = L;
  }
  m_out = m;
}

__device__ __forceinline__ int live_chunks(const Args& a, int len) {
  const int pages = (len + a.page - 1) / a.page;
  return (pages + a.chunk_pages - 1) / a.chunk_pages;
}

// grid (n_split, H, S) in clusters of n_split blocks along x: block c
// takes chunk c of (slot blockIdx.z, head blockIdx.y); block 0 merges
template <int NQ, bool kVec>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(Args a) {
  extern __shared__ float4 smem4[];
  __shared__ float4 cacc[32];          // this chunk's accumulator
  __shared__ float2 cml;               // and its (max, sum)
  cg::cluster_group cluster = cg::this_cluster();
  const int c = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x;
  const int pid0 = first_page_id(a, s, c);
  const int len = live_len(a, s);
  if (c * a.chunk_pages * a.page < len) {
    float m, l;
    float4 acc;
    chunk_partial<NQ, kVec>(a, s, h, c, len, pid0,
                            reinterpret_cast<float*>(smem4), m, l, acc);
    if (tid < a.D4) cacc[tid] = acc;
    if (tid == 0) cml = make_float2(m, l);
  }
  cluster.sync();
  if (c == 0 && tid < a.D4) {
    // merge the live chunks in chunk order; none (seq_lens 0) gives 0
    const int n = live_chunks(a, len);
    float M = kNegBig;
    for (int r = 0; r < n; ++r)
      M = fmaxf(M, cluster.map_shared_rank(&cml, r)->x);
    float L = 0.f;
    float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < n; ++r) {
      const float2 ml = *cluster.map_shared_rank(&cml, r);
      const float4 x = cluster.map_shared_rank(cacc, r)[tid];
      const float f = expf(ml.x - M);
      L = fmaf(ml.y, f, L);
      A.x = fmaf(x.x, f, A.x);
      A.y = fmaf(x.y, f, A.y);
      A.z = fmaf(x.z, f, A.z);
      A.w = fmaf(x.w, f, A.w);
    }
    const float inv = 1.f / fmaxf(L, 1e-37f);
    float* op = a.out + ((size_t)s * a.H + h) * a.D;
    if (kVec) {
      reinterpret_cast<float4*>(op)[tid] =
          make_float4(A.x * inv, A.y * inv, A.z * inv, A.w * inv);
    } else {
      const int d = tid * 4;
      op[d] = A.x * inv;
      if (d + 1 < a.D) op[d + 1] = A.y * inv;
      if (d + 2 < a.D) op[d + 2] = A.z * inv;
      if (d + 3 < a.D) op[d + 3] = A.w * inv;
    }
  }
  cluster.sync();                      // no block leaves while block 0 reads
}

template <int NQ, bool kVec>
cudaError_t launch(const Args& a, int S, int n_split, cudaStream_t st) {
  const size_t smem =
      sizeof(float) * ((size_t)kStages * kTile * (a.kst + a.D4 * 4) + kTile +
                       kThreads + a.chunk_pages);
  if (smem > 200 * 1024) return cudaErrorInvalidValue;
  auto kern = decode_attention_kernel<NQ, kVec>;
  static size_t granted = 48 * 1024;   // one per instantiation
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    granted = smem;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, a.H, S);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, a);
}

// NQ: q quads per lane, enough for the kLanes lanes of a token to
// cover D4 quads
template <bool kVec>
cudaError_t launch_d(const Args& a, int S, int n_split, cudaStream_t st) {
  const int nq = (a.D4 + kLanes - 1) / kLanes;
  if (nq <= 1) return launch<1, kVec>(a, S, n_split, st);
  if (nq <= 2) return launch<2, kVec>(a, S, n_split, st);
  if (nq <= 4) return launch<4, kVec>(a, S, n_split, st);
  if (nq <= 8) return launch<8, kVec>(a, S, n_split, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// chunk_pages: whole pages per chunk, at least ceil(max_pages / 8).
// vec: D % 4 == 0 and q, the pools and out 16-byte aligned.
extern "C" int mxt_decode_attention(const float* q, const float* k_pages,
                                    const float* v_pages,
                                    const int32_t* page_table,
                                    const int32_t* seq_lens, float* out,
                                    int S, int H, int D, int page,
                                    int max_pages, int num_pages,
                                    int chunk_pages, int vec, float scale,
                                    void* stream) {
  if (S <= 0 || H <= 0 || D <= 0 || D > 128 || page <= 0 ||
      max_pages <= 0 || num_pages <= 0 || chunk_pages <= 0 ||
      (vec && D % 4))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k_pages;
  a.v = v_pages;
  a.page_table = page_table;
  a.seq_lens = seq_lens;
  a.out = out;
  a.H = H;
  a.D = D;
  a.D4 = (D + 3) / 4;
  // K rows padded to kst floats, kst / 4 = kLanes (mod 8): the eight
  // lanes of a 16-byte shared load (two tokens x kLanes) hit distinct
  // bank quads
  a.kst = 4 * (a.D4 + ((kLanes - a.D4) % 8 + 8) % 8);
  a.page = page;
  a.max_pages = max_pages;
  a.num_pages = num_pages;
  a.chunk_pages = chunk_pages < max_pages ? chunk_pages : max_pages;
  a.scale = scale;
  const int n_split = (max_pages + a.chunk_pages - 1) / a.chunk_pages;
  if (n_split > kMaxSplit) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = vec ? launch_d<true>(a, S, n_split, st)
                            : launch_d<false>(a, S, n_split, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
