// Greedy non-maximum suppression over score-sorted boxes for Hopper
// (sm_90a), one launch over a batch.
//
// Replaces: mxnet_tpu/ops/contrib.py _greedy_nms:154 and the loop of
//   _contrib_box_nms:773 -- no Pallas kernel: the JAX package runs this
//   suppression as a lax.fori_loop over every box, which XLA compiles
//   into one while loop on the device.
// Eager PyTorch has no such loop: the plain version (ops/kernels.py
// greedy_nms_plain) issues ~20 dependent tensor ops per box, ~600,000
// launches for SSD's 30,120 anchors, and no PyTorch call computes a
// greedy NMS.  Its users: MultiBoxDetection
// (SSD's decode, in every training forward of get_symbol_train),
// Proposal / MultiProposal (6,000 boxes per image) and box_nms.
//
// The rule, the JAX loop's: boxes (B, n, 4) corner format, sorted by
// score; box j is suppressed when some box i < j is kept, valid (when a
// valid mask is given), of the same class (when class ids are given)
// and overlaps it with IoU > t.  The IoU is _box_iou's (contrib.py:80),
// operation for operation:
//   iw = max(min(x1i, x1j) - max(x0i, x0j), 0), ih likewise
//   inter = iw * ih
//   area = max((x1 - x0) * (y1 - y0), 0)
//   iou = inter / max(area_i + area_j - inter, 1e-12)
// with __f*_rn / __d*_rn intrinsics, so nvcc cannot contract any of it
// into an FMA (NVCC_FLAGS are global): the keep mask equals the plain
// version's bit for bit, on any compiler.  max / min propagate NaN, as
// torch.maximum and jnp.maximum do.
//
// What bounds it on the H100: the dependence between boxes.  Whether box
// i suppresses anything depends on every earlier decision, so one image
// is one sequential sweep; the IoUs of one kept box against the boxes
// after it are independent.  Bytes are few (n x 4 values in, n flags
// out); operations are ~17 per IoU pair that the greedy rule needs (one
// per kept box and each later box still kept when its turn comes).
//
// What the design does about it, simple first:
//  * One block of 1024 threads per image; the batch is the grid.
//  * The keep flags live in shared memory, one byte per box (n bytes of
//    dynamic shared memory: up to 232,448 boxes per image).
//  * Every thread walks i over the flags itself; a suppressed or invalid
//    i costs one shared read and no barrier, since all threads read the
//    same final flag.  For a kept, valid i each thread tests the boxes j
//    > i it owns (j = i + 1 + tid + k * 1024) that are still kept, then
//    the block meets at one __syncthreads before the next i is read.
//  * A box's four values are read from global memory (L1 / L2 resident
//    after the first sweep); areas are recomputed per pair rather than
//    held in shared memory, which the flags need.
//  * More boxes per image than the flags' shared memory holds fail the
//    launch with cudaErrorInvalidValue.
//
// Not yet done (a later PR): spreading one image over a cluster of
// blocks, or the two-pass 64-bit suppression bitmask.
//
// Interface: plain C, launched on the caller's stream, allocates nothing,
// returns cudaGetLastError() of the launch.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxBoxes = 232448;   // dynamic shared memory of one block

__device__ __forceinline__ float d_add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float d_sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float d_mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float d_div(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double d_add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ double d_sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double d_mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double d_div(double a, double b) {
  return __ddiv_rn(a, b);
}

// NaN-propagating max / min (torch.maximum, jnp.maximum)
template <typename T>
__device__ __forceinline__ T d_max(T a, T b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}
template <typename T>
__device__ __forceinline__ T d_min(T a, T b) {
  return a != a ? a : (b != b ? b : (a < b ? a : b));
}

template <typename T>
__device__ __forceinline__ T area_of(T x0, T y0, T x1, T y1) {
  return d_max(d_mul(d_sub(x1, x0), d_sub(y1, y0)), T(0));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
greedy_nms_kernel(const T* __restrict__ boxes, const T* __restrict__ ids,
                  const unsigned char* __restrict__ valid,
                  unsigned char* __restrict__ keep_out, int n, T thresh) {
  extern __shared__ unsigned char keep[];
  const int b = blockIdx.x;
  const T* bx = boxes + (size_t)b * n * 4;
  const T* id = ids ? ids + (size_t)b * n : nullptr;
  const unsigned char* ok = valid ? valid + (size_t)b * n : nullptr;
  for (int j = threadIdx.x; j < n; j += kThreads) keep[j] = 1;
  __syncthreads();
  const T floor_union = T(1e-12);
  for (int i = 0; i < n; ++i) {
    // uniform across the block: keep[i] was last written before a barrier
    if (!keep[i] || (ok && !ok[i])) continue;
    const T ax0 = bx[4 * i], ay0 = bx[4 * i + 1];
    const T ax1 = bx[4 * i + 2], ay1 = bx[4 * i + 3];
    const T area_a = area_of(ax0, ay0, ax1, ay1);
    const T cls = id ? id[i] : T(0);
    for (int j = i + 1 + threadIdx.x; j < n; j += kThreads) {
      if (!keep[j] || (id && id[j] != cls)) continue;
      const T bx0 = bx[4 * j], by0 = bx[4 * j + 1];
      const T bx1 = bx[4 * j + 2], by1 = bx[4 * j + 3];
      const T iw = d_max(d_sub(d_min(ax1, bx1), d_max(ax0, bx0)), T(0));
      const T ih = d_max(d_sub(d_min(ay1, by1), d_max(ay0, by0)), T(0));
      const T inter = d_mul(iw, ih);
      const T area_b = area_of(bx0, by0, bx1, by1);
      const T uni = d_sub(d_add(area_a, area_b), inter);
      const T iou = d_div(inter, d_max(uni, floor_union));
      if (iou > thresh) keep[j] = 0;
    }
    __syncthreads();
  }
  for (int j = threadIdx.x; j < n; j += kThreads)
    keep_out[(size_t)b * n + j] = keep[j];
}

template <typename T>
int launch(const void* boxes, const void* ids, const void* valid, void* keep,
           int batch, int n, T thresh, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (n > kMaxBoxes) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)n;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        greedy_nms_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  greedy_nms_kernel<T><<<batch, kThreads, smem, (cudaStream_t)stream>>>(
      (const T*)boxes, (const T*)ids, (const unsigned char*)valid,
      (unsigned char*)keep, n, thresh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// boxes (B, n, 4), ids (B, n) or null, valid (B, n) bytes or null, keep
// (B, n) bytes | B, n | threshold | stream
extern "C" int mxt_greedy_nms_f32(const void* boxes, const void* ids,
                                  const void* valid, void* keep, int batch,
                                  int n, float thresh, void* stream) {
  return launch<float>(boxes, ids, valid, keep, batch, n, thresh, stream);
}

extern "C" int mxt_greedy_nms_f64(const void* boxes, const void* ids,
                                  const void* valid, void* keep, int batch,
                                  int n, double thresh, void* stream) {
  return launch<double>(boxes, ids, valid, keep, batch, n, thresh, stream);
}
