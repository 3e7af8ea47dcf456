// User kernels for mx.rtc.CudaModule: the counterparts of the Pallas
// kernels that tests/test_rtc.py launches through the JAX package's
// rtc.TPUModule (mxnet_tpu/rtc.py:74, TPUKernel.launch:53) -- axpy with
// alpha, a doubling over a 2-block grid, split_sign with two outputs and
// ident -- plus the in-place y += alpha * x of the reference's rtc
// docstring and a momentum-SGD update (the ``sgd_mom_update`` op's
// arithmetic).
//
// This file is not built by nvcc with the kernel libraries: it is CUDA
// source that a user of the imperative API would write, compiled at run
// time by NVRTC through rtc.CudaModule (an sm_90a cubin) and launched over
// NDArrays.  Each kernel is elementwise over n f32 values and bound by the
// bytes it moves; one thread per element (a grid-stride loop in
// `doubled`, whose grid is fixed at 2 blocks).  Every multiply and add is
// its own rounded operation when compiled with --fmad=false, so each
// kernel equals its plain PyTorch version (tests/torch_cases.py) bit for
// bit.

extern "C" __global__ void axpy(const float *x, const float *y, float *out,
                                float alpha, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] * alpha + y[i];
}

extern "C" __global__ void doubled(const float *x, float *out, int n) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x)
    out[i] = x[i] * 2.0f;
}

extern "C" __global__ void split_sign(const float *x, float *pos,
                                      float *neg, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    float v = x[i];
    pos[i] = fmaxf(v, 0.0f);
    neg[i] = fminf(v, 0.0f);
  }
}

extern "C" __global__ void ident(const float *x, float *out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i];
}

extern "C" __global__ void axpy_inplace(const float *x, float *y,
                                        float alpha, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) y[i] += alpha * x[i];
}

// w, m updated in place: g' = clip(g * rescale), m = momentum * m -
// lr * (g' + wd * w), w = w + m (the op's order of operations).
extern "C" __global__ void sgd_mom(float *w, const float *g, float *m,
                                   float lr, float momentum, float wd,
                                   float rescale, float clip, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) {
    float gi = g[i] * rescale;
    if (clip > 0.0f) gi = fminf(fmaxf(gi, -clip), clip);
    float wi = w[i];
    float mi = momentum * m[i] - lr * (gi + wd * wi);
    m[i] = mi;
    w[i] = wi + mi;
  }
}
