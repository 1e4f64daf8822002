// The split pass of the swapped fp32 fc1 kernel
// (csrc/fc1_strided_tf32x3_swap.cu): the frames that a call's windows
// cover, cut once into TF32 hi and lo planes,
//
//   hi[n, f, c] = tf32(buf[n, s0 + f, c]),  lo[n, f, c] = tf32(buf[n, s0 + f, c] - hi[n, f, c])
//
// both rounded to nearest with ties away from zero (fc1_common.cuh's
// tf32_rna; ops/fc1.py::split_tf32 is the plain version, equal bit for bit).
// buf (N, F, C) fp32, samples `ld` elements apart (a splice view goes in
// uncopied) -> planes (2, N, span, C) fp32, contiguous.
//
// Replaces no TPU kernel: it is the windows' half of the operand split of
// the three-pass product that the JAX package runs at Precision.HIGHEST
// (expecto_tpu/ops/spans.py:421). The swapped kernel's consumer warpgroups
// each split their own W columns; the window tile, which both of them
// read, comes split from here. Bound by bytes: one fp32 read and two
// writes an element, 16 bytes a thread a step, a grid-stride loop over 8
// CTAs an SM.

#include <algorithm>

#include "fc1_common.cuh"

namespace {

__global__ void __launch_bounds__(256)
fc1_split_tf32_kernel(const float4* __restrict__ buf, float4* __restrict__ hi, float4* __restrict__ lo,
                      long long ld4, long long first4, long long sample4, long long total4) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total4;
       i += (long long)gridDim.x * blockDim.x) {
    const long long n = i / sample4;
    const float4 v = buf[n * ld4 + first4 + (i - n * sample4)];
    float4 h, l;
    h.x = fc1::tf32_rna(v.x);
    h.y = fc1::tf32_rna(v.y);
    h.z = fc1::tf32_rna(v.z);
    h.w = fc1::tf32_rna(v.w);
    l.x = fc1::tf32_rna(v.x - h.x);
    l.y = fc1::tf32_rna(v.y - h.y);
    l.z = fc1::tf32_rna(v.z - h.z);
    l.w = fc1::tf32_rna(v.w - h.w);
    hi[i] = h;
    lo[i] = l;
  }
}

}  // namespace

// Returns 0 on success or the cudaError_t of a refused launch. buf: n
// samples `ld` elements apart (rows of C channels, 16-byte aligned, C % 4
// == 0, ld % 4 == 0); frames s0 .. s0 + span - 1 of each sample split into
// hi and lo, each (n, span, C) contiguous and 16-byte aligned; `ctas` CTAs
// of 256 threads. Launches on `stream`, allocates nothing.
extern "C" int fc1_split_tf32_launch(const void* buf, void* hi, void* lo, int n, int ld, int C, int s0, int span,
                                     int ctas, void* stream) {
  if (n <= 0 || C <= 0 || C % 4 != 0 || ld <= 0 || ld % 4 != 0 || s0 < 0 || span <= 0 || ctas <= 0 ||
      reinterpret_cast<uintptr_t>(buf) % 16 != 0 || reinterpret_cast<uintptr_t>(hi) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(lo) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const long long sample4 = (long long)span * C / 4, total4 = sample4 * n;
  const long long blocks = std::min<long long>(ctas, (total4 + 255) / 256);
  fc1_split_tf32_kernel<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(buf), static_cast<float4*>(hi), static_cast<float4*>(lo), ld / 4,
      (long long)s0 * C / 4, sample4, total4);
  return (int)cudaGetLastError();
}
