// Two-bit gradient quantization with error feedback for Hopper (sm_90a).
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
// What bounds it on the H100: bytes.  Two reads and two writes of 4 bytes
// per element against three float operations: 16 bytes per element at
// 3.35 TB/s.  A (32768, 768) push is 0.120 ms at that rate; most pushes
// of a transformer step are (768,) or (768, 768) and finish inside a
// launch's own latency.
//
// What the design does about it:
//  * One grid-stride elementwise pass.  The TPU kernel padded the flat
//    array to 1024-lane rows in 256-row blocks for VMEM; nothing of that
//    layout is carried over: the kernel walks the flat array as it lies.
//  * Where all four pointers are 16-byte aligned (the wrapper checks and
//    says so), each thread moves float4 vectors: 16-byte loads and
//    stores, neighbouring threads on neighbouring vectors; the n % 4
//    elements past the last vector are done by the first threads of the
//    grid, one each.  Otherwise every thread moves single floats.
//  * At most 132 x 8 blocks of 256 threads: enough loads in flight to
//    keep every SM's memory pipe busy on the largest push, and a single
//    block for the (768,) ones.
//  * The new residual may be written over the residual it was read from
//    (the compressor owns it and updates it in place): each element is
//    read and written by the same thread, so r and new_r are not marked
//    __restrict__.
//  * The sum and the difference are rounded with __fadd_rn / __fsub_rn:
//    no contraction, the same bits as the f32 reference on any compiler.
//
// Not yet done (a later PR): one launch for all the keys of a step (198
// launches of a transformer step, 122 of them on <= 3072 elements, are
// latency-bound), and the packed 2-bit wire format of the reference.
//
// Interface: plain C, launched on the caller's stream, allocates nothing,
// returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 8;   // grid-stride beyond this

__device__ __forceinline__ void quantize(float g, float r, float t,
                                         float& q, float& nr) {
  const float c = __fadd_rn(g, r);
  q = c >= t ? t : (c <= -t ? -t : 0.0f);
  nr = __fsub_rn(c, q);
}

__global__ void __launch_bounds__(kThreads)
two_bit_vec_kernel(const float4* __restrict__ g, const float4* r,
                   float4* __restrict__ q, float4* nr, const float* g1,
                   const float* r1, float* q1, float* nr1, long long n4,
                   int tail, float t) {
  const long long first = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  for (long long i = first; i < n4; i += (long long)gridDim.x * blockDim.x) {
    const float4 a = g[i];
    const float4 b = r[i];
    float4 qo, ro;
    quantize(a.x, b.x, t, qo.x, ro.x);
    quantize(a.y, b.y, t, qo.y, ro.y);
    quantize(a.z, b.z, t, qo.z, ro.z);
    quantize(a.w, b.w, t, qo.w, ro.w);
    q[i] = qo;
    nr[i] = ro;
  }
  if (first < tail) {
    const long long j = n4 * 4 + first;
    quantize(g1[j], r1[j], t, q1[j], nr1[j]);
  }
}

__global__ void __launch_bounds__(kThreads)
two_bit_kernel(const float* __restrict__ g, const float* r,
               float* __restrict__ q, float* nr, long long n, float t) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n; i += (long long)gridDim.x * blockDim.x)
    quantize(g[i], r[i], t, q[i], nr[i]);
}

int grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

extern "C" int mxt_two_bit_compress(const float* grad, const float* residual,
                                    float* q, float* new_residual,
                                    long long n, float threshold, int vec,
                                    void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vec) {
    const long long n4 = n / 4;
    const int tail = (int)(n - n4 * 4);
    two_bit_vec_kernel<<<grid_for(n4 > tail ? n4 : tail), kThreads, 0,
                         st>>>(
        reinterpret_cast<const float4*>(grad),
        reinterpret_cast<const float4*>(residual),
        reinterpret_cast<float4*>(q), reinterpret_cast<float4*>(new_residual),
        grad, residual, q, new_residual, n4, tail, threshold);
  } else {
    two_bit_kernel<<<grid_for(n), kThreads, 0, st>>>(
        grad, residual, q, new_residual, n, threshold);
  }
  return static_cast<int>(cudaGetLastError());
}
