// gblinear's coordinate update: the elementwise step between the two
// products of one block of the block coordinate-descent sweep.
//
//   gl2 = g + lam * w          hl2 = h + lam          tmp = w - gl2 / hl2
//   pos = max(-(gl2 + alpha) / hl2, -w)
//   neg = min(-(gl2 - alpha) / hl2, -w)
//   dw  = eta * (h < 1e-5 ? 0 : (tmp >= 0 ? pos : neg))
//   w  += dw
//
// g (gradient sums), h (hessian sums) and w (weights, updated in place) are
// (B, K) fp32, contiguous; dw (B, K) is written. A padded feature row has
// h = 0, so its dw is 0.
//
// Replaces the fused elementwise epilogue that XLA made of
// expecto_tpu/models/gblinear.py::_coord_delta (:92-101) and the `eta` scale
// and weight update of its block steps (:125-127, :249-251). There is no
// Pallas kernel there; torch has no fused op for it, and in plain torch it
// is about 20 launches a block step.
//
// What bounds it on an H100: bytes, 20 per element (g, h and w read, w and
// dw written), about 0.67 us at (512, 218) at 3.35 TB/s; at K = 1 the launch
// itself. One thread per element, 256 a block: nothing to share or reuse.
//
// The arithmetic is gblinear_cd.cuh's coord_step, which rounds every
// operation as the plain version does, so the two agree bit for bit.
//
// A second entry, gblinear_cd_planes_launch, is the K-model sweep's update
// on its split route (a process group of more than one rank: the gradient
// all-reduced between the block's two products): the same step, w updated
// in place, and dw written as csrc/gblinear_block_resid.cu's operand, TF32
// hi and lo planes (2, n_pad, b_pad), each model's features contiguous
// (hopper_common.cuh's tf32_rna), in place of dw (B, K). With one rank it
// gives csrc/gblinear_block_grad.cu's fused update bit for bit.

#include <cuda_runtime.h>

#include "gblinear_cd.cuh"
#include "hopper_common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
    gblinear_cd_kernel(const float* __restrict__ g, const float* __restrict__ h, float* __restrict__ w,
                       float* __restrict__ dw, int n, float eta, float lam, float alpha) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const float wi = w[i];
  const float d = gblinear::coord_step(g[i], h[i], wi, eta, lam, alpha);
  dw[i] = d;
  w[i] = __fadd_rn(wi, d);
}

// The update of element i = f K + k of (B, K), dw as planes: [k, f] hi,
// [n_pad + k, f] lo, rows b_pad apart
__global__ void __launch_bounds__(THREADS)
    gblinear_cd_planes_kernel(const float* __restrict__ g, const float* __restrict__ h, float* __restrict__ w,
                              float* __restrict__ planes, int B, int K, int n_pad, int b_pad, float eta, float lam,
                              float alpha) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= (long long)B * K) return;
  const int f = (int)(i / K), k = (int)(i - (long long)f * K);
  const float wi = w[i];
  const float d = gblinear::coord_step(g[i], h[i], wi, eta, lam, alpha);
  w[i] = __fadd_rn(wi, d);
  const float hi = hopper::tf32_rna(d);
  planes[(size_t)k * b_pad + f] = hi;
  planes[((size_t)n_pad + k) * b_pad + f] = hopper::tf32_rna(d - hi);
}

}  // namespace

// g, h, w, dw: n contiguous fp32 each (w updated in place). Launches on
// `stream`, allocates nothing, and returns the CUDA error of the launch (0 on
// success).
extern "C" int gblinear_cd_launch(const void* g, const void* h, void* w, void* dw, int n, float eta, float lam,
                                  float alpha, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  const int grid = (n + THREADS - 1) / THREADS;
  gblinear_cd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(h), static_cast<float*>(w), static_cast<float*>(dw),
      n, eta, lam, alpha);
  return (int)cudaGetLastError();
}

// g, h, w: (B, K) contiguous fp32 (w updated in place); planes: (2, n_pad,
// b_pad) fp32, n_pad >= K and b_pad >= B (the rest left as it is). Launches
// on `stream`, allocates nothing, and returns the CUDA error of the launch
// (0 on success).
extern "C" int gblinear_cd_planes_launch(const void* g, const void* h, void* w, void* planes, int B, int K, int n_pad,
                                         int b_pad, float eta, float lam, float alpha, void* stream) {
  if (B <= 0 || K <= 0 || n_pad < K || b_pad < B || (long long)B * K > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * K;
  gblinear_cd_planes_kernel<<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(h), static_cast<float*>(w), static_cast<float*>(planes),
      B, K, n_pad, b_pad, eta, lam, alpha);
  return (int)cudaGetLastError();
}
