// gblinear's elastic-net coordinate step, one feature at a time, shared by
// csrc/gblinear_cd.cu (the coordinate update of a block), csrc/gblinear_round.cu
// (one whole round of the K = 1 sweep) and csrc/gblinear_block_grad.cu (the
// K-model block step's gradient kernel, in its epilogue):
//
//   gl2 = g + lam * w          hl2 = h + lam          tmp = w - gl2 / hl2
//   pos = max(-(gl2 + alpha) / hl2, -w)
//   neg = min(-(gl2 - alpha) / hl2, -w)
//   dw  = eta * (h < 1e-5 ? 0 : (tmp >= 0 ? pos : neg))
//
// Every operation rounds as the plain torch version's one op at a time does
// (ops/gblinear_cd.py::coord_update_plain), so the two agree bit for bit:
// the explicit __fmul_rn / __fadd_rn / __fdiv_rn keep nvcc from contracting
// a product and a sum into one FMA, and the files are built without
// --use_fast_math. max and min keep torch's NaN rule (a NaN operand wins);
// the hessian guard compares with the fp32 constant 1e-5f, as torch and JAX
// round the Python scalar to fp32.

#pragma once

namespace gblinear {

__device__ __forceinline__ float torch_max(float a, float b) { return a != a ? a : (b != b ? b : fmaxf(a, b)); }
__device__ __forceinline__ float torch_min(float a, float b) { return a != a ? a : (b != b ? b : fminf(a, b)); }

// dw = eta * coord_delta(g, h, w; lam, alpha): the scaled weight update of
// one feature from its gradient sum g, hessian sum h and weight w.
__device__ __forceinline__ float coord_step(float g, float h, float w, float eta, float lam, float alpha) {
  const float gl2 = __fadd_rn(g, __fmul_rn(lam, w));
  const float hl2 = __fadd_rn(h, lam);
  const float tmp = __fadd_rn(w, -__fdiv_rn(gl2, hl2));
  const float pos = torch_max(__fdiv_rn(-__fadd_rn(gl2, alpha), hl2), -w);
  const float neg = torch_min(__fdiv_rn(-__fadd_rn(gl2, -alpha), hl2), -w);
  const float delta = h < 1e-5f ? 0.0f : (tmp >= 0.0f ? pos : neg);
  return __fmul_rn(eta, delta);
}

}  // namespace gblinear
