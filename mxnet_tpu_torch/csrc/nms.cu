// Greedy non-maximum suppression over score-sorted boxes for Hopper
// (sm_90a), one launch over a batch, each image spread over a cluster of
// thread blocks.
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
// What bounds it on the H100: the chain of kept boxes.  Whether box i
// suppresses anything depends on every earlier decision, so one image is
// a chain of dependent steps, one exchange between the threads that hold
// the image each (SSD's step: ~540 kept boxes per image, 728 in its
// longest); the IoUs of one kept box against the boxes after it are
// independent.  Bytes are few (n x 4 values in, n flags out); operations
// are ~17 per IoU pair that the greedy rule needs.  On this card the
// step's work is issue slots (f64 compares, selects and mask updates of
// 32 warps a CTA, each running as often as its busiest lane) more than
// arithmetic, and the exchange about a third of a step.
//
// What the design does about it:
//  * One image per cluster of C CTAs of 1024 threads (C = 1, 2, 4, 8 or
//    16; one CTA is a plain launch).  Thread g of the cluster owns boxes
//    j = g + k * C * 1024, k = 0, 1, ...: a strided share, so the work
//    stays balanced as the chain walks upward.  The host picks C by
//    shape (make_plan): boxes on chip first, then the least estimated
//    time, waves x (a step's fixed cost + one per flag of a thread), with
//    the clusters the card holds at once from
//    cudaOccupancyMaxActiveClusters (a failed query is returned, not
//    skipped).  chip_smoke.py times every C on the callers' own boxes:
//    the picked one was the fastest of the five on SSD's step boxes (4)
//    and on MultiProposal's (8).  Images are independent, so a batch
//    larger than the resident clusters runs in waves (SSD's 32 images at
//    C = 4: 30 resident, two waves).
//  * Each thread keeps its boxes' flags as bits of 32- or 64-bit
//    registers (still kept; valid; finite; finite and of width and height
//    > 0), so at most 64 boxes per thread: n <= 64 x 1024 x 8 = 524,288
//    boxes per image, past which the launch returns cudaErrorInvalidValue
//    and the wrapper raises.
//  * The boxes stay on chip across the chain: each CTA stages its boxes
//    once in dynamic shared memory (k < Ks slots per thread: 7 in f64,
//    14 in f32; SSD's 30,120 f64 boxes over 4 CTAs are 7 of 8 slots,
//    229,376 bytes a CTA, beside a 2 KB inbox); slots past that are read
//    from global memory.
//  * No sweep over suppressed flags, and up to kCand = 4 boxes settled
//    per exchange.  Each thread takes its 4 least kept, valid boxes after
//    the last step's candidates (find-first-set on its bits), each warp
//    the least 4 of its lanes' (__reduce_min_sync), and after one
//    __syncthreads warp 0 the CTA's least 4; its lane r pushes candidate
//    r (index, area, box, class) into every CTA's inbox with st.async,
//    counted on that CTA's mbarrier.  Every thread waits on its own
//    CTA's mbarrier and takes the cluster's least 4 from the inbox: the
//    next boxes of the greedy order, with no kept box between them.  Six
//    lanes test the pairs among them (an earlier one suppresses a later
//    one only if kept), so each warp knows which stay; then each kept one
//    in turn suppresses the thread's later boxes: on SSD-like boxes 87
//    steps an image where one candidate a step takes 338.  The exchange
//    is one cluster-wide barrier a step: an mbarrier a CTA that completes
//    when every CTA's candidates have landed, cheaper than barrier.cluster
//    (0.49 against 0.72 us a round for one candidate, H100 SXM,
//    tools/nms_variants.py).  Inboxes and
//    mbarriers are double-buffered by the step's parity: a CTA pushes
//    step s + 2 only after it has every push of step s + 1, which each
//    CTA sends after reading step s.  With C = 1 the barrier is
//    __syncthreads.
//  * For t >= 0 (or NaN) and finite boxes (coordinates within 2^500, f32
//    2^60, so that nothing overflows), an IoU of 0 never suppresses: a
//    finite box of width or height <= 0 is skipped, four comparisons tell
//    whether two others overlap, and only those take the full test
//    (compare-and-select min / max, no clamps: suppressed_fast).  Boxes
//    with NaN, infinities or huge coordinates, and t < 0, take the plain
//    operations with NaN-propagating max / min (suppressed_exact).
//  * Divide only where the division decides.  For a normal t > 0, inter
//    is compared with p = t x den bracketed by (1 +- 2^-50) (f32: 2^-21):
//    above the bracket RN(inter / den) > t, below it RN(inter / den) <=
//    t; inside it, or where p is not a normal number, __d*iv_rn decides.
//    tests/test_torch_nms_decision.py holds these rules to the plain
//    comparison on adversarial pairs.
//
// Interface: plain C, launched on the caller's stream, allocates nothing,
// returns the launch's cudaError_t.  mxt_greedy_nms_cluster_* take the
// cluster size (0: the shape's own), mxt_greedy_nms_plan reports the
// layout, mxt_nms_barrier_probe times a step's exchange (or its barrier)
// alone.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstddef>
#include <map>
#include <mutex>
#include <tuple>
#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;             // one CTA
constexpr int kLgThreads = 10;
constexpr int kWarps = kThreads / 32;
constexpr int kBits = 64;                  // flags of one thread
constexpr int kMaxCluster = 16;            // non-portable beyond 8
constexpr int kMaxBoxes = kBits * kThreads * 8;   // portable clusters
constexpr unsigned kNone = 0xffffffffu;
static_assert(kWarps == 32, "a warp reads one slot per warp");

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

// the filter's NaN-dropping min / max (one instruction each)
__device__ __forceinline__ float f_min(float a, float b) {
  return fminf(a, b);
}
__device__ __forceinline__ float f_max(float a, float b) {
  return fmaxf(a, b);
}
__device__ __forceinline__ double f_min(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ double f_max(double a, double b) {
  return fmax(a, b);
}

// the bracket: 1 +- 8u (u = 2^-24 / 2^-53), where p = t * den may take
// it (p * (1 +- 8u) stays normal), and the normal t it holds for; the
// largest coordinate of a finite_pair_safe box, and the t for which every
// such pair's p lies in that range (den from 1e-12 to 2^1003 / 2^123)
template <typename T>
struct Lim;
template <>
struct Lim<float> {
  static constexpr float up = 1.0f + 0x1p-21f, down = 1.0f - 0x1p-21f;
  static constexpr float p_lo = 0x1p-124f, p_hi = 0x1p124f;
  static constexpr float t_lo = FLT_MIN, t_hi = FLT_MAX;
  static constexpr float safe = 0x1p60f;
};
template <>
struct Lim<double> {
  static constexpr double up = 1.0 + 0x1p-50, down = 1.0 - 0x1p-50;
  static constexpr double p_lo = 0x1p-1020, p_hi = 0x1p1020;
  static constexpr double t_lo = DBL_MIN, t_hi = DBL_MAX;
  static constexpr double safe = 0x1p500;
};

template <typename T>
struct Box {
  T x0, y0, x1, y1;
};

// a box in shared memory (16-byte aligned; local or another CTA's)
__device__ __forceinline__ Box<float> load_box_smem(const float* p) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  return {v.x, v.y, v.z, v.w};
}
__device__ __forceinline__ Box<double> load_box_smem(const double* p) {
  const double2 a = reinterpret_cast<const double2*>(p)[0];
  const double2 b = reinterpret_cast<const double2*>(p)[1];
  return {a.x, a.y, b.x, b.y};
}
__device__ __forceinline__ void store_box_smem(float* p, Box<float> b) {
  *reinterpret_cast<float4*>(p) = make_float4(b.x0, b.y0, b.x1, b.y1);
}
__device__ __forceinline__ void store_box_smem(double* p, Box<double> b) {
  reinterpret_cast<double2*>(p)[0] = make_double2(b.x0, b.y0);
  reinterpret_cast<double2*>(p)[1] = make_double2(b.x1, b.y1);
}
// a box in global memory (any alignment of the caller's tensor)
template <typename T>
__device__ __forceinline__ Box<T> load_box_global(const T* p) {
  return {__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3)};
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// a box of this CTA's shared memory at a 32-bit shared address
template <typename T>
__device__ __forceinline__ Box<T> lds_box(unsigned addr);
template <>
__device__ __forceinline__ Box<float> lds_box<float>(unsigned addr) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(addr));
  return {v.x, v.y, v.z, v.w};
}
template <>
__device__ __forceinline__ Box<double> lds_box<double>(unsigned addr) {
  double2 a, b;
  asm volatile("ld.shared.v2.f64 {%0, %1}, [%2];\n"
               : "=d"(a.x), "=d"(a.y) : "r"(addr));
  asm volatile("ld.shared.v2.f64 {%0, %1}, [%2+16];\n"
               : "=d"(b.x), "=d"(b.y) : "r"(addr));
  return {a.x, a.y, b.x, b.y};
}

template <typename T>
__device__ __forceinline__ T area_of(const Box<T>& b) {
  return d_max(d_mul(d_sub(b.x1, b.x0), d_sub(b.y1, b.y0)), T(0));
}

// coordinates of at most 2^500 (f32: 2^60) in magnitude, not NaN: no
// difference, product or sum of the IoU overflows or turns NaN
template <typename T>
__device__ __forceinline__ bool finite_pair_safe(const Box<T>& b) {
  const T s = Lim<T>::safe;
  return fabs(b.x0) <= s && fabs(b.y0) <= s && fabs(b.x1) <= s &&
         fabs(b.y1) <= s;
}

// inter / den > t as the plain version decides it (den > 0 or NaN).
// With the bracket, for a normal t > 0: p = t * den = t * den * (1 + e),
// |e| <= u; inter above p * (1 + 8u) (rounded) is above t * den * (1 + 5u),
// so inter / den lies past the midpoint of t and the next float; below
// p * (1 - 8u) it is below t * den; both where p is normal with room.  The
// division decides inside the bracket, or without it.
template <typename T>
__device__ __forceinline__ bool decide(T inter, T den, T t, bool bracket) {
  if (bracket) {
    const T p = d_mul(t, den);
    if (p >= Lim<T>::p_lo && p <= Lim<T>::p_hi) {
      if (inter > d_mul(p, Lim<T>::up)) return true;
      if (inter < d_mul(p, Lim<T>::down)) return false;
    }
  }
  return d_div(inter, den) > t;
}

// finite_pair_safe boxes a and b, each of width and height > 0: whether
// they overlap.  min(a.x1, b.x1) > max(a.x0, b.x0) is these comparisons
// with the widths > 0, and the exact width, min - max, is then > 0 (a
// difference of two distinct floats never rounds to 0); likewise the
// height.  Not overlapping means an IoU of 0.
template <typename T>
__device__ __forceinline__ bool overlap(const Box<T>& a, const Box<T>& b) {
  return (a.x1 > b.x0) & (b.x1 > a.x0) & (a.y1 > b.y0) & (b.y1 > a.y0);
}

// True when the kept box a (area_a its area) suppresses b, both
// finite_pair_safe and overlapping (so their widths, heights and the
// pair's iw and ih are > 0), t >= 0 or NaN.  No NaN and no infinity can
// arise, so compare-and-select gives the NaN-propagating min / max's
// values (up to the sign of a zero, which reaches neither inter nor den),
// and b's area needs no clamp.
template <typename T>
__device__ __forceinline__ bool suppressed_fast(const Box<T>& a, T area_a,
                                                const Box<T>& b, T t,
                                                bool bracket) {
  const T iw = d_sub(a.x1 < b.x1 ? a.x1 : b.x1, a.x0 > b.x0 ? a.x0 : b.x0);
  const T ih = d_sub(a.y1 < b.y1 ? a.y1 : b.y1, a.y0 > b.y0 ? a.y0 : b.y0);
  const T inter = d_mul(iw, ih);
  const T uni = d_sub(
      d_add(area_a, d_mul(d_sub(b.x1, b.x0), d_sub(b.y1, b.y0))), inter);
  return decide(inter, uni > T(1e-12) ? uni : T(1e-12), t, bracket);
}

// The same for any two boxes and any t (cheap: t >= 0 or NaN), in the
// plain version's operations with NaN-propagating max / min.
template <typename T>
__device__ __forceinline__ bool suppressed_exact(const Box<T>& a, T area_a,
                                                 const Box<T>& b, T t,
                                                 bool cheap, bool bracket) {
  if (cheap) {
    // fmin / fmax give the NaN-propagating min / max's values up to the
    // sign of a zero where no NaN is among the coordinates, so not > 0
    // here means an exact IoU of 0 or NaN; a NaN coordinate makes the
    // exact IoU NaN, so a false here is right
    if (!(d_sub(f_min(a.x1, b.x1), f_max(a.x0, b.x0)) > T(0))) return false;
    if (!(d_sub(f_min(a.y1, b.y1), f_max(a.y0, b.y0)) > T(0))) return false;
  }
  const T iw = d_max(d_sub(d_min(a.x1, b.x1), d_max(a.x0, b.x0)), T(0));
  const T ih = d_max(d_sub(d_min(a.y1, b.y1), d_max(a.y0, b.y0)), T(0));
  const T inter = d_mul(iw, ih);
  const T den = d_max(d_sub(d_add(area_a, area_of(b)), inter), T(1e-12));
  return decide(inter, den, t, bracket);
}

template <typename T>
struct Args {
  const T* boxes;                 // (B, n, 4)
  const T* ids;                   // (B, n) or null
  const unsigned char* valid;     // (B, n) or null
  unsigned char* keep;            // (B, n)
  int n;
  int K;                          // flags per thread
  int Ks;                         // of them with the box in shared memory
  int inbox_at;                   // byte offset of the inbox
  int lg_ct;                      // log2(threads of the cluster)
  T thresh;
  // of the threshold: >= 0 or NaN; normal and > 0 (decide's bracket)
  int cheap, bracket;
};

// a candidate kept box: its index (kNone: none) with its box_bits, its
// area, box and class id
template <typename T>
struct __align__(16) Slot {
  unsigned j;
  T area;
  T box[4];
  T cls;
};
// the bytes of a slot that travel: the class id only with ids
template <typename T>
__host__ __device__ constexpr unsigned slot_bytes(bool ids) {
  return ids ? (unsigned)sizeof(Slot<T>)
             : (unsigned)((offsetof(Slot<T>, cls) + 15) / 16 * 16);
}
constexpr unsigned kSafeBit = 0x80000000u;    // finite_pair_safe
constexpr unsigned kSolidBit = 0x40000000u;   // width and height > 0
constexpr unsigned kIndex = 0x3fffffffu;

// a box's flag bits for its slot
template <typename T>
__device__ __forceinline__ unsigned box_bits(const Box<T>& b) {
  return (finite_pair_safe(b) ? kSafeBit : 0u) |
         (b.x1 > b.x0 && b.y1 > b.y0 ? kSolidBit : 0u);
}
// candidates a step settles: the least kept, valid boxes after the last
// step's, which between them need only kCand (kCand - 1) / 2 IoUs
constexpr int kCand = 4;

// the bits k of thread g whose box g + k * 2^lg_ct lies after box i, in
// a mask of 32 or 64 flags
template <typename M>
__device__ __forceinline__ M after(int i, int g, int lg) {
  if (i < g) return ~M(0);
  const int k = ((i - g) >> lg) + 1;
  return k >= 8 * (int)sizeof(M) ? M(0) : (~M(0) << k);
}
__device__ __forceinline__ int first_bit(unsigned m) { return __ffs(m) - 1; }
__device__ __forceinline__ int first_bit(unsigned long long m) {
  return __ffsll((long long)m) - 1;
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the same shared-memory address in CTA `rank` of the cluster
__device__ __forceinline__ unsigned remote_addr(unsigned a, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}
__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}
// 16 bytes into another CTA's shared memory, counted on its mbarrier
__device__ __forceinline__ void push16(unsigned raddr, uint4 v,
                                       unsigned rbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n"
      :: "r"(raddr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(rbar)
      : "memory");
}

template <typename T>
__device__ __forceinline__ Box<T> box_of(const Slot<T>& s) {
  return {s.box[0], s.box[1], s.box[2], s.box[3]};
}

// The least kCand of the lanes' ascending lists q (kNone-padded), in
// every lane: out[r]; returns where each came from, lane x kCand +
// position, a byte each (0xff: none).
__device__ __forceinline__ unsigned merge_least(unsigned (&q)[kCand],
                                                unsigned (&out)[kCand]) {
  unsigned from = 0, h = 0;
#pragma unroll
  for (int r = 0; r < kCand; ++r) {
    const unsigned m = __reduce_min_sync(0xffffffffu, q[0]);
    const bool pop = q[0] == m && m != kNone;
    const unsigned who = __ballot_sync(0xffffffffu, pop);
    const unsigned src = who ? __ffs(who) - 1 : 0;
    const unsigned at = __shfl_sync(0xffffffffu, h, src);
    from |= (who ? src * kCand + at : 0xffu) << (8 * r);
    out[r] = m;
#pragma unroll
    for (int x = 0; x + 1 < kCand; ++x) q[x] = pop ? q[x + 1] : q[x];
    q[kCand - 1] = pop ? kNone : q[kCand - 1];
    h += pop;
  }
  return from;
}

// candidate y of the step: its slot's byte in `from`
__device__ __forceinline__ int slot_at(unsigned from, int y) {
  return (int)((from >> (8 * y)) & 0xffu);
}

// whether kept candidate sa suppresses sb (the fast or exact test by
// their box_bits, and of one class where there are ids)
template <typename T>
__device__ __forceinline__ bool slot_suppresses(const Slot<T>& sa,
                                                const Slot<T>& sb, T t,
                                                bool ids, const Args<T>& a) {
  if (ids && sa.cls != sb.cls) return false;
  const Box<T> A = box_of(sa), B = box_of(sb);
  if (a.cheap && (sa.j & sb.j & kSafeBit)) {
    // finite boxes: one of width or height <= 0 never overlaps
    if (!(sa.j & sb.j & kSolidBit) || !overlap(A, B)) return false;
    return suppressed_fast(A, sa.area, B, t, (bool)a.bracket);
  }
  return suppressed_exact(A, sa.area, B, t, (bool)a.cheap, (bool)a.bracket);
}

// grid: C x B CTAs, clusters of C along x (kSolo: C = 1, no cluster).
// Dynamic shared memory: Ks x 1024 boxes (slot k of thread tid at
// k * 1024 + tid), then the inbox: [2][C][kCand] slots (kSolo: kCand).
// M holds a thread's flags: 32 or 64 bits.
template <typename T, bool kSolo, typename M>
__global__ void __launch_bounds__(kThreads, 1)
greedy_nms_kernel(const Args<T> a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sbox = reinterpret_cast<T*>(smem_raw);
  Slot<T>* inbox = reinterpret_cast<Slot<T>*>(smem_raw + a.inbox_at);
  __shared__ unsigned wj[kWarps][kCand];      // each warp's least
  __shared__ unsigned long long full[2];      // inbox half p filled
  int C = 1, rank = 0;
  if constexpr (!kSolo) {
    C = (int)cg::this_cluster().num_blocks();
    rank = (int)cg::this_cluster().block_rank();
  }
  const int b = blockIdx.x / C;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = (rank << kLgThreads) + tid;
  const int n = a.n, lg = a.lg_ct, Ks = a.Ks;
  const size_t base = (size_t)b * n;
  const T* bx = a.boxes + base * 4;
  const T* id = a.ids ? a.ids + base : nullptr;
  const unsigned char* ok = a.valid ? a.valid + base : nullptr;
  const T t = a.thresh;
  const bool cheap = a.cheap, bracket = a.bracket;
  const unsigned bytes = slot_bytes<T>(id != nullptr);
  // my slot k: in shared memory for k < Ks (a 32-bit shared address),
  // else in global memory
  constexpr int kLgBox = sizeof(T) == 8 ? 5 : 4;
  const unsigned my_s = smem_addr(sbox) + (tid << kLgBox);
  const T* my_g = bx + 4 * (size_t)g;
  auto my_box = [&](int k) -> Box<T> {
    return k < Ks ? lds_box<T>(my_s + (k << (kLgThreads + kLgBox)))
                  : load_box_global(my_g + ((size_t)k << (lg + 2)));
  };
  // this CTA's box j
  auto box_at = [&](unsigned j) -> Box<T> {
    const int k = (int)(j >> lg), o = (int)(j & (kThreads - 1));
    return k < Ks ? load_box_smem(sbox + 4 * ((k << kLgThreads) + o))
                  : load_box_global(bx + 4 * (size_t)j);
  };

  // my flags: still kept; valid; finite_pair_safe; that and of width and
  // height > 0
  M live = 0, usable = 0, safe = 0, fine = 0;
  for (int k = 0; k < a.K; ++k) {
    const int j = g + (k << lg);
    if (j >= n) break;
    live |= M(1) << k;
    if (!ok || ok[j]) usable |= M(1) << k;
    const Box<T> B = load_box_global(bx + 4 * (size_t)j);
    const unsigned bits = box_bits(B);
    if (bits & kSafeBit) safe |= M(1) << k;
    if (bits == (kSafeBit | kSolidBit)) fine |= M(1) << k;
    if (k < Ks) store_box_smem(sbox + 4 * ((k << kLgThreads) + tid), B);
  }
  if (!kSolo && tid == 0) {
    mbar_init(smem_addr(&full[0]), 1);
    mbar_init(smem_addr(&full[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(smem_addr(&full[0]), C * kCand * bytes);
    mbar_expect(smem_addr(&full[1]), C * kCand * bytes);
  }
  // every CTA of the cluster runs and has staged its boxes
  if constexpr (kSolo) __syncthreads(); else cg::this_cluster().sync();

  int i = -1;   // the last candidate of the step before
  // each step settles at least one box: at most n steps and the last
  for (int s = 0; s <= n; ++s) {
    const int p = s & 1;
    const M later = after<M>(i, g, lg);
    // my kCand least kept, valid boxes after i; the warp's least kCand
    unsigned q[kCand], c[kCand];
    {
      M mine = live & usable & later;
#pragma unroll
      for (int r = 0; r < kCand; ++r) {
        q[r] = mine ? (unsigned)(g + (first_bit(mine) << lg)) : kNone;
        mine &= mine - 1;
      }
    }
    merge_least(q, c);
#pragma unroll
    for (int r = 0; r < kCand; ++r)
      if (lane == r) wj[warp][r] = c[r];
    __syncthreads();
    // warp 0 takes the CTA's least kCand and lane r hands candidate r,
    // with its box, to every CTA of the cluster (kSolo: to this CTA)
    if (warp == 0) {
#pragma unroll
      for (int r = 0; r < kCand; ++r) q[r] = wj[lane][r];
      merge_least(q, c);
      if (lane < kCand) {
        unsigned m = kNone;
#pragma unroll
        for (int r = 0; r < kCand; ++r)
          if (lane == r) m = c[r];
        Slot<T> w;
        w.j = m;
        w.area = w.cls = T(0);
        w.box[0] = w.box[1] = w.box[2] = w.box[3] = T(0);
        if (m != kNone) {
          const Box<T> B = box_at(m);
          w.box[0] = B.x0;
          w.box[1] = B.y0;
          w.box[2] = B.x1;
          w.box[3] = B.y1;
          w.area = area_of(B);
          w.cls = id ? __ldg(id + m) : T(0);
          w.j |= box_bits(B);
        }
        if constexpr (kSolo) {
          inbox[lane] = w;
        } else {
          const uint4* src = reinterpret_cast<const uint4*>(&w);
          const unsigned dst =
              smem_addr(inbox + (p * C + rank) * kCand + lane);
          for (int r = 0; r < C; ++r) {
            const unsigned rd = remote_addr(dst, r);
            const unsigned rb = remote_addr(smem_addr(&full[p]), r);
#pragma unroll
            for (int x = 0; x < (int)(sizeof(Slot<T>) / 16); ++x)
              if (16 * x < (int)bytes) push16(rd + 16 * x, src[x], rb);
          }
        }
      }
    }
    // the cluster's least kCand: `from` says where each slot lies
    const Slot<T>* sl;
    unsigned from;
    if constexpr (kSolo) {
      __syncthreads();
      sl = inbox;
      from = 0x03020100u;
#pragma unroll
      for (int r = 0; r < kCand; ++r)
        if (inbox[r].j == kNone) from |= 0xffu << (8 * r);
    } else {
      mbar_wait(smem_addr(&full[p]), (s >> 1) & 1);
      // the phase after is step s + 2's: its pushes come after this
      // CTA's of step s + 1, so after every thread here passed this wait
      if (warp == 0 && lane == 0)
        mbar_expect(smem_addr(&full[p]), C * kCand * bytes);
      sl = inbox + p * C * kCand;
#pragma unroll
      for (int r = 0; r < kCand; ++r) {
        const unsigned v = lane < C ? sl[lane * kCand + r].j : kNone;
        q[r] = v == kNone ? kNone : v & kIndex;
      }
      from = merge_least(q, c);
    }
    if (slot_at(from, 0) == 0xff) break;
    // which candidates stay: y unless a kept x < y suppresses it; the
    // kCand (kCand - 1) / 2 pairs one a lane: (0,1) (0,2) (0,3) (1,2)
    // (1,3) (2,3)
    static_assert(kCand == 4, "the pairs below are kCand 4's");
    const int px = lane < 3 ? 0 : (lane < 5 ? 1 : 2);
    const int py = lane < 3 ? lane + 1 : (lane < 5 ? lane - 1 : 3);
    bool sup = false;
    if (lane < 6 && slot_at(from, py) != 0xff)
      sup = slot_suppresses(sl[slot_at(from, px)], sl[slot_at(from, py)], t,
                            id != nullptr, a);
    const unsigned pm = __ballot_sync(0xffffffffu, sup);
    unsigned kept = 0;
    int last = 0;
#pragma unroll
    for (int y = 0; y < kCand; ++y) {
      if (slot_at(from, y) == 0xff) break;
      last = y;
      bool dead = false;
#pragma unroll
      for (int x = 0; x < y; ++x) {
        const int pr = x == 0 ? y - 1 : (x == 1 ? y + 1 : 5);
        dead |= ((kept >> x) & (pm >> pr) & 1u) != 0;
      }
      if (!dead) kept |= 1u << y;
    }
    // my candidates are settled: the dead ones are suppressed
    M settled = 0;
#pragma unroll
    for (int y = 0; y < kCand; ++y) {
      if (y > last) break;
      const int j = (int)(sl[slot_at(from, y)].j & kIndex);
      if (j >= g && ((j - g) & ((1 << lg) - 1)) == 0) {
        const M bit = M(1) << ((j - g) >> lg);
        settled |= bit;
        if (!((kept >> y) & 1)) live &= ~bit;
      }
    }
    // each kept candidate, in order, suppresses my later boxes.  For
    // t >= 0 (or NaN) and a finite kept box, a finite box of width or
    // height <= 0, or one that does not overlap (four comparisons), has
    // an IoU of 0 and stays; the finite rest take the fast test, the
    // others the exact one
#pragma unroll 1
    for (int y = 0; y <= last; ++y) {
      if (!((kept >> y) & 1)) continue;
      const Slot<T>& S = sl[slot_at(from, y)];
      const Box<T> A = box_of(S);
      const T area_a = S.area, cls = S.cls;
      const int cj = (int)(S.j & kIndex);
      const M todo = live & after<M>(cj, g, lg) & ~settled;
      M fast = 0, slow = todo;
      if (cheap && (S.j & kSafeBit)) {
        slow = todo & ~safe;
        if (S.j & kSolidBit) fast = todo & fine;
      }
      while (fast) {
        const int k = first_bit(fast);
        fast &= fast - 1;
        const Box<T> B = my_box(k);
        if (!overlap(A, B)) continue;
        if (id && __ldg(id + g + (k << lg)) != cls) continue;
        if (suppressed_fast(A, area_a, B, t, bracket))
          live &= ~(M(1) << k);
      }
      while (slow) {
        const int k = first_bit(slow);
        slow &= slow - 1;
        if (id && __ldg(id + g + (k << lg)) != cls) continue;
        if (suppressed_exact(A, area_a, my_box(k), t, cheap, bracket))
          live &= ~(M(1) << k);
      }
    }
    i = (int)(sl[slot_at(from, last)].j & kIndex);
  }
  for (int k = 0; k < a.K; ++k) {
    const int j = g + (k << lg);
    if (j >= n) break;
    a.keep[base + j] = (unsigned char)((live >> k) & 1);
  }
  // no CTA leaves while another may still write into its shared memory
  if constexpr (!kSolo) cg::this_cluster().sync();
}

// rounds of the per-step exchange alone (every warp kCand candidates,
// f64 boxes, the cluster's least kCand and their pairs' IoUs), or with
// bare: barrier.cluster alone (C = 1: __syncthreads)
template <bool kSolo>
__global__ void __launch_bounds__(kThreads, 1)
barrier_probe_kernel(int rounds, int bare) {
  __shared__ Slot<double> inbox[2 * kMaxCluster * kCand];
  __shared__ unsigned wj[kWarps][kCand];
  __shared__ unsigned long long full[2];
  int C = 1, rank = 0;
  if constexpr (!kSolo) {
    C = (int)cg::this_cluster().num_blocks();
    rank = (int)cg::this_cluster().block_rank();
  }
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned bytes = slot_bytes<double>(false);
  if (!kSolo && tid == 0) {
    mbar_init(smem_addr(&full[0]), 1);
    mbar_init(smem_addr(&full[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(smem_addr(&full[0]), C * kCand * bytes);
    mbar_expect(smem_addr(&full[1]), C * kCand * bytes);
  }
  if constexpr (kSolo) __syncthreads(); else cg::this_cluster().sync();
  unsigned sum = 0;
  for (int s = 0; s < rounds; ++s) {
    if (bare) {
      if constexpr (kSolo) __syncthreads(); else cluster_barrier();
      continue;
    }
    const int p = s & 1;
    unsigned q[kCand], c[kCand];
#pragma unroll
    for (int r = 0; r < kCand; ++r)
      q[r] = (unsigned)((s * 7 + tid * 4 + r + rank) & 0xffff);
    merge_least(q, c);
#pragma unroll
    for (int r = 0; r < kCand; ++r)
      if (lane == r) wj[warp][r] = c[r];
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int r = 0; r < kCand; ++r) q[r] = wj[lane][r];
      merge_least(q, c);
      if (lane < kCand) {
        Slot<double> w;
        w.j = c[0] + lane;
        w.area = 0.25;
        w.cls = 0;
        w.box[0] = w.box[1] = 0.25 * lane;
        w.box[2] = w.box[3] = 0.5 + 0.25 * lane;
        if constexpr (kSolo) {
          inbox[lane] = w;
        } else {
          const uint4* src = reinterpret_cast<const uint4*>(&w);
          const unsigned dst =
              smem_addr(inbox + (p * C + rank) * kCand + lane);
          for (int r = 0; r < C; ++r) {
            const unsigned rd = remote_addr(dst, r);
            const unsigned rb = remote_addr(smem_addr(&full[p]), r);
#pragma unroll
            for (int x = 0; x < (int)(bytes / 16); ++x)
              push16(rd + 16 * x, src[x], rb);
          }
        }
      }
    }
    const Slot<double>* sl;
    if constexpr (kSolo) {
      __syncthreads();
      sl = inbox;
    } else {
      mbar_wait(smem_addr(&full[p]), (s >> 1) & 1);
      if (warp == 0 && lane == 0)
        mbar_expect(smem_addr(&full[p]), C * kCand * bytes);
      sl = inbox + p * C * kCand;
#pragma unroll
      for (int r = 0; r < kCand; ++r)
        q[r] = lane < C ? sl[lane * kCand + r].j : kNone;
      merge_least(q, c);
    }
    bool sup = false;
    if (lane < 6)
      sup = suppressed_fast(box_of(sl[lane % kCand]), 0.25,
                            box_of(sl[(lane + 1) % kCand]), 0.45, true);
    sum += __ballot_sync(0xffffffffu, sup) + c[0];
  }
  if (sum == 0xdeadbeefu) wj[0][0] = sum;   // keep the rounds
  if constexpr (!kSolo) cg::this_cluster().sync();
}

struct Plan {
  int cluster, K, Ks, inbox_at, smem, active, waves;
};

// a launch's time in ns per step of the chain and wave, fitted to the
// H100's times at every cluster size on SSD's and MultiProposal's boxes
// (chip_smoke.py phases 34-35): a step's fixed part (its exchange is 0.1
// us for one CTA, 0.5 for a cluster; the rest is the 32 warps' own
// instructions), then per flag of a thread.  Flags read from global
// memory cost 0.1 to 0.5 us each, the more of them the more: layouts
// with more than one a thread come last.
constexpr int kStep = 1400, kPerFlag = 200;

std::mutex g_mutex;
std::map<int, int> g_ready;                              // device -> done
std::map<std::pair<int, int>, int> g_cap;                // (dev, T) -> bytes
std::map<std::tuple<int, const void*, int, int>, int> g_active;

// the instantiation for one CTA or a cluster, with K flags a thread
template <typename T>
const void* nms_kernel(bool solo, int K) {
  using U32 = unsigned;
  using U64 = unsigned long long;
  if (K <= 32)
    return solo ? (const void*)greedy_nms_kernel<T, true, U32>
                : (const void*)greedy_nms_kernel<T, false, U32>;
  return solo ? (const void*)greedy_nms_kernel<T, true, U64>
              : (const void*)greedy_nms_kernel<T, false, U64>;
}

// dynamic shared memory a CTA of greedy_nms_kernel<T> may take: what a
// block may opt into less the kernel's static slots
template <typename T>
int smem_cap(int dev) {
  return g_cap[std::make_pair(dev, (int)sizeof(T))];
}

// once per device: every instantiation may take the shared memory a
// block may opt into, and the cluster kernels clusters of 16
cudaError_t prepare(int dev) {
  if (g_ready.count(dev)) return cudaSuccess;
  int optin = 0;
  cudaError_t e = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  for (int f = 0; f < 8; ++f) {
    const bool f64 = f & 1, solo = f & 2;
    const int K = f & 4 ? 64 : 32;
    const void* kern = f64 ? nms_kernel<double>(solo, K)
                           : nms_kernel<float>(solo, K);
    cudaFuncAttributes attr;
    e = cudaFuncGetAttributes(&attr, kern);
    if (e != cudaSuccess) return e;
    const int cap = optin - (int)attr.sharedSizeBytes;
    const auto key = std::make_pair(dev, f64 ? 8 : 4);
    if (!g_cap.count(key) || cap < g_cap[key]) g_cap[key] = cap;
  }
  for (int f = 0; f < 8; ++f) {
    const bool f64 = f & 1, solo = f & 2;
    const int K = f & 4 ? 64 : 32;
    const void* kern = f64 ? nms_kernel<double>(solo, K)
                           : nms_kernel<float>(solo, K);
    e = cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             g_cap[std::make_pair(dev, f64 ? 8 : 4)]);
    if (e == cudaSuccess && !solo)
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  e = cudaFuncSetAttribute((const void*)barrier_probe_kernel<false>,
                           cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e != cudaSuccess) return e;
  g_ready[dev] = 1;
  return cudaSuccess;
}

// clusters of C CTAs of `kern` with smem bytes each that the card holds
// at once (0: this size does not fit); a failed query is returned
cudaError_t active_clusters(int dev, const void* kern, int C, int smem,
                            int* out) {
  const auto key = std::make_tuple(dev, kern, C, smem);
  const auto it = g_active.find(key);
  if (it != g_active.end()) {
    *out = it->second;
    return cudaSuccess;
  }
  cudaError_t e;
  if (C == 1) {
    int per_sm = 0, sms = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kThreads, smem);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    *out = per_sm * sms;
  } else {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaOccupancyMaxActiveClusters(out, kern, &cfg);
  }
  if (e != cudaSuccess) {
    (void)cudaGetLastError();
    return e;
  }
  g_active[key] = *out;
  return cudaSuccess;
}

int pow2_at_least(long long v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// the layout of an image of n boxes over C CTAs: its boxes, then the
// inbox of the candidates' slots
template <typename T>
void layout(int n, int C, int cap, Plan* p) {
  const long long per_cta = (long long)C * kThreads;
  const int slot = kThreads * 4 * (int)sizeof(T);
  const int inbox = (C == 1 ? 1 : 2 * C) * kCand * (int)sizeof(Slot<T>);
  p->cluster = C;
  p->K = (int)((n + per_cta - 1) / per_cta);
  p->Ks = p->K < (cap - inbox) / slot ? p->K : (cap - inbox) / slot;
  p->inbox_at = p->Ks * slot;
  p->smem = p->inbox_at + inbox;
}

// force: a cluster size of 1..16 (a power of two), or 0 for the shape's:
// the fewest flags a thread off chip past one, then the least estimated
// time (waves x the cost of a step), then the wider cluster, among those
// that 64 flags a thread allow and no wider than one box a thread
template <typename T>
cudaError_t make_plan(int batch, int n, int force, Plan* out) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  std::lock_guard<std::mutex> lock(g_mutex);
  e = prepare(dev);
  if (e != cudaSuccess) return e;
  const int cap = smem_cap<T>(dev);
  int c_min = pow2_at_least(((long long)n + kBits * kThreads - 1) /
                            (kBits * kThreads));
  int c_max = pow2_at_least(((long long)n + kThreads - 1) / kThreads);
  c_max = c_max < c_min ? c_min : (c_max > kMaxCluster ? kMaxCluster : c_max);
  if (force) {
    if (force < c_min || force > kMaxCluster || (force & (force - 1)))
      return cudaErrorInvalidValue;
    c_min = c_max = force;
  }
  bool found = false;
  int best_off = 0;
  long long best = 0;
  for (int C = c_max; C >= c_min; C >>= 1) {
    Plan p;
    layout<T>(n, C, cap, &p);
    e = active_clusters(dev, nms_kernel<T>(C == 1, p.K), C, p.smem,
                        &p.active);
    if (e != cudaSuccess) return e;
    if (p.active <= 0) continue;
    p.waves = (batch + p.active - 1) / p.active;
    const int off = p.K - p.Ks > 1 ? p.K - p.Ks : 0;
    const long long cost = (long long)p.waves * (kStep + kPerFlag * p.K);
    if (!found || off < best_off || (off == best_off && cost < best)) {
      *out = p;
      best_off = off;
      best = cost;
    }
    found = true;
  }
  return found ? cudaSuccess : cudaErrorInvalidConfiguration;
}

int lg2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

template <typename T>
int launch(const void* boxes, const void* ids, const void* valid, void* keep,
           int batch, int n, int cluster, T thresh, void* stream) {
  if (batch <= 0 || n <= 0) return 0;
  if (n > kMaxBoxes) return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t e = make_plan<T>(batch, n, cluster, &p);
  if (e != cudaSuccess) return (int)e;
  Args<T> a;
  a.boxes = (const T*)boxes;
  a.ids = (const T*)ids;
  a.valid = (const unsigned char*)valid;
  a.keep = (unsigned char*)keep;
  a.n = n;
  a.K = p.K;
  a.Ks = p.Ks;
  a.inbox_at = p.inbox_at;
  a.lg_ct = lg2(p.cluster) + kLgThreads;
  a.thresh = thresh;
  a.cheap = !(T(0) > thresh);
  a.bracket = thresh >= Lim<T>::t_lo && thresh <= Lim<T>::t_hi;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.cluster * (unsigned)batch);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = (cudaStream_t)stream;
  if (p.cluster > 1) {
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
  void* args[] = {&a};
  e = cudaLaunchKernelExC(&cfg, nms_kernel<T>(p.cluster == 1, p.K), args);
  if (e != cudaSuccess) {
    (void)cudaGetLastError();
    return (int)e;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// boxes (B, n, 4), ids (B, n) or null, valid (B, n) bytes or null, keep
// (B, n) bytes | B, n | threshold | stream
extern "C" int mxt_greedy_nms_f32(const void* boxes, const void* ids,
                                  const void* valid, void* keep, int batch,
                                  int n, float thresh, void* stream) {
  return launch<float>(boxes, ids, valid, keep, batch, n, 0, thresh,
                       stream);
}

extern "C" int mxt_greedy_nms_f64(const void* boxes, const void* ids,
                                  const void* valid, void* keep, int batch,
                                  int n, double thresh, void* stream) {
  return launch<double>(boxes, ids, valid, keep, batch, n, 0, thresh,
                        stream);
}

// the same with the cluster size given (0: the shape's own)
extern "C" int mxt_greedy_nms_cluster_f32(const void* boxes, const void* ids,
                                          const void* valid, void* keep,
                                          int batch, int n, int cluster,
                                          float thresh, void* stream) {
  return launch<float>(boxes, ids, valid, keep, batch, n, cluster, thresh,
                       stream);
}

extern "C" int mxt_greedy_nms_cluster_f64(const void* boxes, const void* ids,
                                          const void* valid, void* keep,
                                          int batch, int n, int cluster,
                                          double thresh, void* stream) {
  return launch<double>(boxes, ids, valid, keep, batch, n, cluster, thresh,
                        stream);
}

// the launch's layout for (B, n) boxes of elem_bytes (4 or 8) and a
// cluster size (0: the shape's own): out = cluster, flags per thread, of
// them with the box in shared memory, shared memory bytes per CTA,
// clusters the card holds at once, waves, candidates a step settles
extern "C" int mxt_greedy_nms_plan(int batch, int n, int elem_bytes,
                                   int cluster, int* out) {
  if (batch <= 0 || n <= 0 || n > kMaxBoxes) return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t e = elem_bytes == 8
                            ? make_plan<double>(batch, n, cluster, &p)
                            : make_plan<float>(batch, n, cluster, &p);
  if (e != cudaSuccess) return (int)e;
  out[0] = p.cluster;
  out[1] = p.K;
  out[2] = p.Ks;
  out[3] = p.smem;
  out[4] = p.active;
  out[5] = p.waves;
  out[6] = kCand;
  return 0;
}

// one cluster of C CTAs of 1024 threads passing `rounds` of the kernel's
// per-step exchange, or with bare != 0 of its barrier alone
// (barrier.cluster; C = 1: __syncthreads)
extern "C" int mxt_nms_barrier_probe(int cluster, int rounds, int bare,
                                     void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  {
    std::lock_guard<std::mutex> lock(g_mutex);
    e = prepare(dev);
  }
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = (cudaStream_t)stream;
  if (cluster > 1) {
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, barrier_probe_kernel<false>, rounds, bare);
  } else {
    e = cudaLaunchKernelEx(&cfg, barrier_probe_kernel<true>, rounds, bare);
  }
  if (e != cudaSuccess) (void)cudaGetLastError();
  return (int)e;
}
