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
// Every operation rounds as the plain torch version's one op at a time does
// (ops/gblinear_cd.py::coord_update_plain), so the two agree bit for bit:
// the explicit __fmul_rn / __fadd_rn / __fdiv_rn keep nvcc from contracting
// a product and a sum into one FMA, and the file is built without
// --use_fast_math. max and min keep torch's NaN rule (a NaN operand wins);
// the hessian guard compares with the fp32 constant 1e-5f, as torch and JAX
// round the Python scalar to fp32.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float torch_max(float a, float b) { return a != a ? a : (b != b ? b : fmaxf(a, b)); }
__device__ __forceinline__ float torch_min(float a, float b) { return a != a ? a : (b != b ? b : fminf(a, b)); }

__global__ void __launch_bounds__(THREADS)
    gblinear_cd_kernel(const float* __restrict__ g, const float* __restrict__ h, float* __restrict__ w,
                       float* __restrict__ dw, int n, float eta, float lam, float alpha) {
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const float gi = g[i], hi = h[i], wi = w[i];
  const float gl2 = __fadd_rn(gi, __fmul_rn(lam, wi));
  const float hl2 = __fadd_rn(hi, lam);
  const float tmp = __fadd_rn(wi, -__fdiv_rn(gl2, hl2));
  const float pos = torch_max(__fdiv_rn(-__fadd_rn(gl2, alpha), hl2), -wi);
  const float neg = torch_min(__fdiv_rn(-__fadd_rn(gl2, -alpha), hl2), -wi);
  const float delta = hi < 1e-5f ? 0.0f : (tmp >= 0.0f ? pos : neg);
  const float d = __fmul_rn(eta, delta);
  dw[i] = d;
  w[i] = __fadd_rn(wi, d);
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
