// Two-bit gradient quantization with error feedback for Hopper (sm_90a),
// one launch over every key of a push.
//
// Replaces: mxnet_tpu/ops/pallas_kernels.py two_bit_compress
//   (_two_bit_kernel / _two_bit_jit, the pallas_call at :121), which the
//   kvstore's _TwoBitCompressor.compress runs on every dense push once
//   set_gradient_compression is set.  Per element, in f32:
//     comp  = g + r
//     q     = t if comp >= t, -t if comp <= -t, else 0
//     new_r = comp - q
//   NaN compares false both ways (q = 0, new_r = NaN); +-inf give q = +-t.
//
// B10: the same kernel over f16, bf16 and f64 gradients (the reference's
// kernel takes any float dtype: it computes g + r in f32, as
// grad.astype(f32), and writes q and the new residual back in the
// gradient's dtype, rounded to nearest even).  One instantiation per
// element type, each its own C entry point (mxt_two_bit_compress_many_f16,
// _bf16, _f64), so a push of mixed dtypes takes one launch per dtype.
//
// What bounds it on the H100: bytes.  Two reads and two writes of 4 bytes
// per element against three float operations: 16 bytes per element at
// 3.35 TB/s (f16 and bf16: 8 bytes, f64: 32).  The 198 keys of a GPT-2-small Module.fit step hold 136.2 M
// elements, 0.650 ms at that rate; 123 of them are vectors of <= 32768
// elements and 49 more are (768, 768) or (1024, 768), each of which
// finishes inside a launch's own latency when it has a launch of its own.
//
// What the design does about it:
//  * One launch for many keys ("segments").  The C entry takes a host
//    array of segment descriptors (g, r, q, new_r, n, vec) and passes up
//    to kMaxSegs of them BY VALUE in the kernel's parameters (a
//    __grid_constant__ struct: CUDA >= 12.1 takes 32,764 bytes of them,
//    680 segments; older toolkits 4 KB, 80), so a launch needs no copy to
//    the device, no allocation and no host sync.  A push of more segments
//    than that takes ceil(count / kMaxSegs) launches; the wrapper reads
//    kMaxSegs from mxt_two_bit_segments_per_launch().
//  * Each block takes a fixed chunk of kChunk = 1024 elements of one
//    segment; the struct holds each segment's first block, and a block
//    finds its segment by a binary search over them (uniform across the
//    block: constant-cache broadcasts).  A (768,) key costs one block,
//    not a launch; a (32768, 768) key 24,576 blocks.  Up to (1024, 768)
//    that is the grid the one-key kernel before it launched (one float4
//    per thread); chunks of 4096 elements (576 blocks at 4 per SM) left
//    a (3072, 768) key a second, nearly empty wave of blocks and ran it
//    5.6% slower alone than that kernel.
//  * Inside a chunk each thread issues all its loads before its first
//    store: one float4 vector of g and of r where all four pointers of
//    the segment are 16-byte aligned (the wrapper checks and says so;
//    neighbouring threads on neighbouring vectors), else 4 single floats.
//    The n % 4 elements past a segment's last vector are done one by one
//    by the thread that owns the partial vector.  The TPU kernel padded
//    the flat array to 1024-lane rows in 256-row blocks for VMEM; nothing
//    of that layout is carried over: the kernel walks each flat array as
//    it lies.
//  * The new residual may be written over the residual it was read from
//    (the compressor owns it and updates it in place): each element is
//    read and written by the same thread, so r and new_r are not marked
//    __restrict__.
//  * The sum and the difference are rounded with __fadd_rn / __fsub_rn:
//    no contraction, the same bits as the f32 reference on any compiler,
//    whatever the segment, the chunk or the vector width.
//  * Other element types: a "vector" is 4 elements, loaded as one 8-byte
//    word for f16 and bf16 and as two 16-byte words for f64, where all
//    four pointers of the segment are aligned to 4 elements (the wrapper
//    checks and says so).  Each element is widened to f32 exactly (f64:
//    rounded to nearest, as astype), quantized as above, and q and the new
//    residual are rounded back to the element type to nearest even
//    (__float2half_rn, __float2bfloat16_rn; f64 exactly).  A strided
//    gradient is made contiguous by the wrapper, not here.
//
// Not yet done (a later PR): the packed 2-bit wire format of the
// reference.
//
// Interface: plain C, launched on the caller's stream, allocates nothing,
// returns cudaGetLastError() of the launches (the first that failed).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecItems = 1;                       // float4 per thread
constexpr int kChunk = kThreads * kVecItems * 4;   // elements per block
constexpr int kScalarItems = kChunk / kThreads;    // floats per thread

// one segment as the kernel reads it (48 bytes)
template <typename T>
struct Seg {
  const T* g;
  const T* r;
  T* q;
  T* nr;
  long long n;
  int first_block;
  int vec;
};

#if CUDART_VERSION >= 12010
constexpr int kMaxSegs = 680;   // 8 + 680 * 48 <= 32,764 bytes
#else
constexpr int kMaxSegs = 80;    // 8 + 80 * 48 <= 4,096 bytes
#endif

template <typename T, int kCap>
struct Batch {
  int count;
  float t;
  Seg<T> seg[kCap];
};

__device__ __forceinline__ void quantize(float g, float r, float t,
                                         float& q, float& nr) {
  const float c = __fadd_rn(g, r);
  q = c >= t ? t : (c <= -t ? -t : 0.0f);
  nr = __fsub_rn(c, q);
}

__device__ __forceinline__ float4 quantize4(float4 a, float4 b, float t,
                                            float4& ro) {
  float4 qo;
  quantize(a.x, b.x, t, qo.x, ro.x);
  quantize(a.y, b.y, t, qo.y, ro.y);
  quantize(a.z, b.z, t, qo.z, ro.z);
  quantize(a.w, b.w, t, qo.w, ro.w);
  return qo;
}

// B10: an element of another type, widened to f32 and rounded back
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(double x) {
  return __double2float_rn(x);
}
__device__ __forceinline__ void from_f32(float x, __half& y) {
  y = __float2half_rn(x);
}
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16& y) {
  y = __float2bfloat16_rn(x);
}
__device__ __forceinline__ void from_f32(float x, double& y) { y = x; }

template <typename T>
__device__ __forceinline__ void quantize(T g, T r, float t, T& q, T& nr) {
  float qf, nrf;
  quantize(to_f32(g), to_f32(r), t, qf, nrf);
  from_f32(qf, q);
  from_f32(nrf, nr);
}

// four elements, aligned as one vector (f16 / bf16: 8 bytes, f64: 32)
template <typename T>
struct alignas(4 * sizeof(T)) Vec4 {
  T x[4];
};

template <typename T>
__device__ __forceinline__ Vec4<T> quantize4(Vec4<T> a, Vec4<T> b, float t,
                                             Vec4<T>& ro) {
  Vec4<T> qo;
#pragma unroll
  for (int e = 0; e < 4; ++e) quantize(a.x[e], b.x[e], t, qo.x[e], ro.x[e]);
  return qo;
}

// the vector type of 4 elements: float4 for f32
template <typename T>
struct VecOf {
  using type = Vec4<T>;
};
template <>
struct VecOf<float> {
  using type = float4;
};

template <typename T, int kCap>
__global__ void __launch_bounds__(kThreads)
two_bit_many_kernel(const __grid_constant__ Batch<T, kCap> b) {
  const int blk = blockIdx.x;
  int lo = 0, hi = b.count - 1;        // last segment starting at <= blk
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (b.seg[mid].first_block <= blk) lo = mid; else hi = mid - 1;
  }
  const Seg<T>& s = b.seg[lo];
  const float t = b.t;
  const long long n = s.n;
  const long long base = (long long)(blk - s.first_block) * kChunk;
  if (s.vec) {
    const long long n4 = n >> 2;
    using V = typename VecOf<T>::type;
    const V* g4 = reinterpret_cast<const V*>(s.g);
    const V* r4 = reinterpret_cast<const V*>(s.r);
    V* q4 = reinterpret_cast<V*>(s.q);
    V* nr4 = reinterpret_cast<V*>(s.nr);
    const long long v0 = (base >> 2) + threadIdx.x;
    V a[kVecItems], c[kVecItems];
#pragma unroll
    for (int k = 0; k < kVecItems; ++k) {
      const long long i = v0 + (long long)k * kThreads;
      if (i < n4) {
        a[k] = g4[i];
        c[k] = r4[i];
      }
    }
#pragma unroll
    for (int k = 0; k < kVecItems; ++k) {
      const long long i = v0 + (long long)k * kThreads;
      if (i < n4) {
        V ro;
        q4[i] = quantize4(a[k], c[k], t, ro);
        nr4[i] = ro;
      } else if (i == n4) {            // the partial vector: the tail
        for (long long j = n4 * 4; j < n; ++j)
          quantize(s.g[j], s.r[j], t, s.q[j], s.nr[j]);
      }
    }
  } else {
    const long long e0 = base + threadIdx.x;
    T a[kScalarItems], c[kScalarItems];
#pragma unroll
    for (int k = 0; k < kScalarItems; ++k) {
      const long long i = e0 + (long long)k * kThreads;
      if (i < n) {
        a[k] = s.g[i];
        c[k] = s.r[i];
      }
    }
#pragma unroll
    for (int k = 0; k < kScalarItems; ++k) {
      const long long i = e0 + (long long)k * kThreads;
      if (i < n) quantize(a[k], c[k], t, s.q[i], s.nr[i]);
    }
  }
}

// launch one Batch<T, kCap> over segs[0, count) (count <= kCap)
template <typename T, int kCap>
int launch(const Seg<T>* segs, int count, float t, cudaStream_t st) {
  Batch<T, kCap> b;
  b.count = count;
  b.t = t;
  long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    b.seg[i] = segs[i];
    b.seg[i].first_block = (int)blocks;
    blocks += (segs[i].n + kChunk - 1) / kChunk;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  }
  two_bit_many_kernel<T, kCap><<<(unsigned)blocks, kThreads, 0, st>>>(b);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int compress_many(const long long* desc, int count, float threshold,
                  void* stream) {
  if (count < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Seg<T> segs[kMaxSegs];
  for (int done = 0; done < count;) {
    const int m = count - done < kMaxSegs ? count - done : kMaxSegs;
    for (int i = 0; i < m; ++i) {
      const long long* d = desc + 6LL * (done + i);
      Seg<T>& s = segs[i];
      s.g = reinterpret_cast<const T*>(d[0]);
      s.r = reinterpret_cast<const T*>(d[1]);
      s.q = reinterpret_cast<T*>(d[2]);
      s.nr = reinterpret_cast<T*>(d[3]);
      s.n = d[4];
      s.vec = (int)d[5];
      s.first_block = 0;
      if (s.n <= 0) return static_cast<int>(cudaErrorInvalidValue);
    }
    // the smallest parameter struct that holds the batch
    const int rc = m <= 1 ? launch<T, 1>(segs, m, threshold, st)
                 : m <= 16 ? launch<T, 16>(segs, m, threshold, st)
                 : launch<T, kMaxSegs>(segs, m, threshold, st);
    if (rc) return rc;
    done += m;
  }
  return 0;
}

}  // namespace


// one segment as the caller passes it: six 64-bit words (g, r, q, new_r,
// n, vec); zero-length segments are the caller's to leave out
extern "C" int mxt_two_bit_segments_per_launch() { return kMaxSegs; }

extern "C" int mxt_two_bit_compress_many(const long long* desc, int count,
                                         float threshold, void* stream) {
  return compress_many<float>(desc, count, threshold, stream);
}

// B10: the same over f16, bf16 and f64 segments (`vec`: all four pointers
// aligned to 4 elements)
extern "C" int mxt_two_bit_compress_many_f16(const long long* desc,
                                             int count, float threshold,
                                             void* stream) {
  return compress_many<__half>(desc, count, threshold, stream);
}

extern "C" int mxt_two_bit_compress_many_bf16(const long long* desc,
                                              int count, float threshold,
                                              void* stream) {
  return compress_many<__nv_bfloat16>(desc, count, threshold, stream);
}

extern "C" int mxt_two_bit_compress_many_f64(const long long* desc,
                                             int count, float threshold,
                                             void* stream) {
  return compress_many<double>(desc, count, threshold, stream);
}
