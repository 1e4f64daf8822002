// Width-8 valid 1-D convolution + bias + ReLU for the Beluga conv stack.
//
//   y[n, l, co] = relu( sum_{k<8, ci<Cin} x[n, l+k, ci] * W[k, ci, co] + b[co] )
//
// x (N, L, Cin), W (8, Cin, Cout), b (Cout) -> y (N, L-7, Cout), all
// contiguous, channels last. fp32 or bf16 in and out; the sum is always
// taken in fp32 and the epilogue fuses bias, ReLU and the output cast.
//
// Replaces the TPU kernel expecto_tpu/ops/pallas_conv.py::conv8_relu (the
// JAX package's only Pallas kernel, the same function as
// models/beluga.py::_conv_relu).
//
// What bounds it on an H100: the Beluga layers from conv1 on do 2*8*Cin
// (2,560 to 10,240) operations per output element, far above the card's
// operations-per-byte ridge, so the work is bound by arithmetic, not by
// device memory; conv0 (Cin = 4) alone moves more bytes than it computes.
// This first version computes on the CUDA cores (fp32 FMA, 67 TFLOP/s peak)
// and not on the tensor cores, so in bf16 it stays far from the bf16
// tensor-core bound; a wgmma/TMA redesign is later work.
//
// Design: a classic shared-memory tiled implicit GEMM. Each block of 256
// threads owns TL = 128 output positions x TC = 64 output channels of one
// batch row. It walks Cin in chunks of CK = 16: it stages the TL + 7 input
// rows and the 8 x CK x TC weight slab of the chunk in shared memory (as
// fp32, ~41 KB, under the 48 KB static limit), then every thread
// accumulates an 8 x 4 register micro-tile over the 8 taps and CK channels.
// A thread's rows are ty + 16 i and its columns tx + 16 j, so a warp reads
// the input tile as broadcasts and the weight slab as consecutive words:
// no shared-memory bank conflicts. Edges are masked: Cin = 4 (conv0) fills
// the chunk with zeros, Cout = 480 leaves half of the last channel tile
// idle, and the ragged end of L - 7 is not stored.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KW = 8;     // conv width
constexpr int TL = 128;   // output positions per block
constexpr int TC = 64;    // output channels per block
constexpr int CK = 16;    // input channels per shared-memory stage
constexpr int THREADS = 256;
constexpr int RT = TL / 16;  // rows per thread (8)
constexpr int CT = TC / 16;  // columns per thread (4)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv8_relu_kernel(const T* __restrict__ x, const T* __restrict__ w, const T* __restrict__ b,
                  T* __restrict__ y, int L, int Cin, int Cout) {
  __shared__ float xs[TL + KW - 1][CK];
  __shared__ float ws[KW][CK][TC];

  const int n = blockIdx.z;
  const int l0 = blockIdx.x * TL;
  const int c0 = blockIdx.y * TC;
  const int l_out = L - KW + 1;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const T* xn = x + (size_t)n * L * Cin;

  float acc[RT][CT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[i][j] = 0.f;

  for (int ci0 = 0; ci0 < Cin; ci0 += CK) {
    for (int e = tid; e < (TL + KW - 1) * CK; e += THREADS) {
      const int r = e / CK, c = e % CK;
      const int l = l0 + r, ci = ci0 + c;
      xs[r][c] = (l < L && ci < Cin) ? to_f32(xn[(size_t)l * Cin + ci]) : 0.f;
    }
    for (int e = tid; e < KW * CK * TC; e += THREADS) {
      const int j = e % TC, c = (e / TC) % CK, k = e / (TC * CK);
      const int ci = ci0 + c, co = c0 + j;
      ws[k][c][j] = (ci < Cin && co < Cout) ? to_f32(w[((size_t)k * Cin + ci) * Cout + co]) : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int k = 0; k < KW; ++k) {
#pragma unroll
      for (int c = 0; c < CK; ++c) {
        float a[RT], bw[CT];
#pragma unroll
        for (int i = 0; i < RT; ++i) a[i] = xs[ty + 16 * i + k][c];
#pragma unroll
        for (int j = 0; j < CT; ++j) bw[j] = ws[k][c][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < CT; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  T* yn = y + (size_t)n * l_out * Cout;
#pragma unroll
  for (int j = 0; j < CT; ++j) {
    const int co = c0 + tx + 16 * j;
    if (co >= Cout) continue;
    const float bias = to_f32(b[co]);
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int l = l0 + ty + 16 * i;
      if (l < l_out) yn[(size_t)l * Cout + co] = from_f32<T>(fmaxf(acc[i][j] + bias, 0.f));
    }
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. Launches on `stream`, allocates nothing, and
// returns cudaGetLastError() of the launch (0 on success).
extern "C" int conv8_relu_launch(const void* x, const void* w, const void* b, void* y, int n, int L,
                                 int Cin, int Cout, int dtype, void* stream) {
  const int l_out = L - KW + 1;
  if (n <= 0 || l_out <= 0 || Cin <= 0 || Cout <= 0 || n > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((l_out + TL - 1) / TL, (Cout + TC - 1) / TC, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    conv8_relu_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
        static_cast<float*>(y), L, Cin, Cout);
  } else if (dtype == 1) {
    conv8_relu_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(b), static_cast<__nv_bfloat16*>(y), L, Cin, Cout);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
