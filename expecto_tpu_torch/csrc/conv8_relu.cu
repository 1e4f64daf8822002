// Width-8 valid 1-D convolution + bias + ReLU on Hopper's CUDA cores (fp32
// FFMA): the "simt" route of ops/conv8.py::conv8_relu.
//
//   y[n, l, co] = relu( sum_{k<8, ci<Cin} x[n, l+k, ci] * W[k, ci, co] + b[co] )
//
// x (N, L, Cin) fp32 or bf16; W packed by ops/conv8.py::pack_weights_simt
// (fp32, layout below); b (Cout) in x's type -> y (N, L-7, Cout) in x's type,
// channels last. The sum is fp32 FFMA and never a tensor-core instruction
// (parity mode is defined with TF32 off); the epilogue fuses bias, ReLU and
// the output cast.
//
// Replaces the TPU kernel expecto_tpu/ops/pallas_conv.py::conv8_relu for all
// that the tensor-core kernel csrc/conv8_relu_tc.cu does not take: fp32 at
// any Cin (parity mode's conv1-conv5), bf16 with Cin % 16 != 0 or a data
// pointer off a 16-byte boundary, and a float one-hot at conv0 (Cin = 4).
//
// What bounds it on an H100: Beluga's conv1-conv5 do 2 * 8 * Cin = 5,120 to
// 10,240 operations per output element, far above the ridge of fp32 FFMA
// (67 TFLOP/s) over device memory (3.35 TB/s), 20 operations per byte: the
// work is bound by operations, at the fp32 rate. The design spends the
// instruction slots on FFMA and keeps every SM busy:
//
// - Flat rows. x is read as one (N*L, Cin) matrix, which it already is in
//   memory. The conv over that sequence equals the per-span conv at every
//   flat row m = n*L + l with l < L-7; the 7 rows per span that straddle two
//   spans are computed and never stored. A tile is as full at a 26-row patch
//   sub-span as at a 3,593-row span, and the batch is no longer grid.z.
// - Tiles. A block owns TM flat rows x 160 output channels (160 divides 320,
//   480 and 640; another Cout is padded in the packed weights and masked at
//   the store): TM = 128 (256 threads, two blocks an SM) or TM = 64 (128
//   threads, three an SM). The launcher takes the 64-row tile only where it
//   leaves at least a tenth fewer rows on the busiest SM, as at conv5 on the
//   patch sub-span, whose 128-row tiles fill three quarters of one wave.
// - Register blocking. A thread owns 8 consecutive rows x 10 output channels
//   (80 fp32 accumulators). For each input channel it reads its 15 input
//   values (16, as four 16-byte shared loads) once and reuses them over the 8
//   taps, loading only each tap's 10 weights (two 16-byte and one 8-byte
//   load): 28 shared loads per 640 FFMA in the inner loop. For that, x is
//   held channel-major in shared memory (each channel a row of TM + 8
//   positions, TM + 8 = 8 mod 32 words), so that no warp's loads or stores
//   conflict on a bank; a warp is 8 channel threads x 4 row threads.
// - Copies that overlap compute. A ring of stages of 4 input channels each
//   in dynamic shared memory, one __syncthreads per stage: while a stage is
//   computed, the copies of the next ones are in flight. W arrives as 16-byte
//   cp.async: pack_weights_simt lays it out once per weight tensor as
//   (Cout/160, Cin/4, 8 taps, 4, 160) fp32, one contiguous 20 KB block per
//   (tile, stage), zero-padded past Cin and Cout. fp32 x arrives as 4-byte
//   cp.async, which transpose it into the channel-major layout and zero-fill
//   rows past N*L and channels past Cin, so any Cin and any view of fp32
//   stage asynchronously. bf16 x (not on a main path) is loaded through
//   registers and widened to fp32 when its stage starts; only its W copies
//   overlap compute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int KW = 8;                  // conv width
constexpr int CK = 4;                  // input channels per stage
constexpr int BN = 160;                // output channels per block
constexpr int RT = 8;                  // consecutive rows per thread
constexpr int CT = 10;                 // output channels per thread: 4tx..+3, 64+4tx..+3, 128+2tx..+1
constexpr int TXN = BN / CT;           // threads across a tile's channels
constexpr int W_STAGE = KW * CK * BN;  // floats of W per stage (20,480 bytes)

static_assert(TXN == 16, "two warps of 8 channel threads span the 160 channels");

template <int TM>
struct Tile {
  static constexpr int THREADS = TXN * (TM / RT);       // 256 or 128
  static constexpr int MIN_BLOCKS = TM == 128 ? 2 : 3;  // per SM: <= 128 and <= 168 registers a thread
  static constexpr int STAGES = TM == 128 ? 4 : 3;
  static constexpr int XR = TM + 8;                     // positions per channel: TM + 7 halo rows, rounded
  static constexpr int X_STAGE = CK * XR;               // floats
  static constexpr int STAGE = W_STAGE + X_STAGE;       // floats
  static constexpr int SMEM = STAGES * STAGE * 4;       // bytes
  static constexpr int X_PER_THREAD = (X_STAGE + THREADS - 1) / THREADS;
  static_assert(XR % 32 == 8, "a warp's 4 row threads and 4 staged channels fall on distinct banks");
  static_assert(W_STAGE % (4 * THREADS) == 0, "each thread copies whole 16-byte pieces of W");
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}

// copies 4 bytes, or writes 4 zero bytes when !valid (src is then not read)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// y[co .. co+W-1] = v[0 .. W-1], whole vectors where Cout allows, else per
// channel below Cout
template <int W, typename T>
__device__ __forceinline__ void store_group(T* yrow, int co, const float* v, int Cout) {
  if (Cout % W == 0 && co < Cout) {  // co % W == 0, so the vector is aligned and below Cout
    if constexpr (std::is_same<T, float>::value) {
      if constexpr (W == 4) *reinterpret_cast<float4*>(yrow + co) = make_float4(v[0], v[1], v[2], v[3]);
      else *reinterpret_cast<float2*>(yrow + co) = make_float2(v[0], v[1]);
    } else {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
      if constexpr (W == 4) {
        const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
        uint2 u;
        memcpy(&u.x, &lo, 4);
        memcpy(&u.y, &hi, 4);
        *reinterpret_cast<uint2*>(yrow + co) = u;
      } else {
        *reinterpret_cast<__nv_bfloat162*>(yrow + co) = lo;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if (co + i < Cout) {
        if constexpr (std::is_same<T, float>::value) yrow[co + i] = v[i];
        else yrow[co + i] = __float2bfloat16(v[i]);
      }
    }
  }
}

// acc += the stage's 4 input channels x 8 taps, from shared memory `st`
// (W block, then x channel-major)
template <int XR>
__device__ __forceinline__ void compute_stage(float (&acc)[RT][CT], const float* __restrict__ st, int tx, int ty) {
  const float* xs = st + W_STAGE + RT * ty;
#pragma unroll
  for (int c = 0; c < CK; ++c) {
    float xv[RT + KW];  // positions RT*ty .. +15 of channel c: rows r + k, r < 8, k < 8
    const float4* xp = reinterpret_cast<const float4*>(xs + c * XR);
#pragma unroll
    for (int i = 0; i < (RT + KW) / 4; ++i) {
      const float4 v = xp[i];
      xv[4 * i] = v.x;
      xv[4 * i + 1] = v.y;
      xv[4 * i + 2] = v.z;
      xv[4 * i + 3] = v.w;
    }
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      const float* wk = st + (k * CK + c) * BN;
      const float4 w0 = *reinterpret_cast<const float4*>(wk + 4 * tx);
      const float4 w1 = *reinterpret_cast<const float4*>(wk + 64 + 4 * tx);
      const float2 w2 = *reinterpret_cast<const float2*>(wk + 128 + 2 * tx);
      const float wv[CT] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w, w2.x, w2.y};
#pragma unroll
      for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int j = 0; j < CT; ++j) acc[r][j] = fmaf(xv[r + k], wv[j], acc[r][j]);
    }
  }
}

template <typename T, int TM>
__global__ void __launch_bounds__(Tile<TM>::THREADS, Tile<TM>::MIN_BLOCKS)
conv8_relu_kernel(const T* __restrict__ x, const float* __restrict__ wp, const T* __restrict__ b,
                  T* __restrict__ y, int M, int L, int Cin, int Cout) {
  using Tl = Tile<TM>;
  constexpr bool ASYNC_X = std::is_same<T, float>::value;
  extern __shared__ __align__(16) float smem[];
  const uint32_t sbase = smem_addr(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = (warp & 1) * 8 + (lane & 7);    // channel thread
  const int ty = (warp >> 1) * 4 + (lane >> 3);  // row thread: rows RT*ty .. +7 of the tile
  const long long m0 = (long long)blockIdx.x * TM;
  const int kq = (Cin + CK - 1) / CK;
  const float* wsrc = wp + (size_t)blockIdx.y * kq * W_STAGE;

  // W of stage q into ring slot s: 16-byte copies of one contiguous block
  auto copy_w = [&](int q, int s) {
    const float* src = wsrc + (size_t)q * W_STAGE;
    const uint32_t dst = sbase + s * Tl::STAGE * 4;
#pragma unroll
    for (int i = 0; i < W_STAGE / 4 / Tl::THREADS; ++i) {
      const int e = tid + i * Tl::THREADS;
      cp_async16(dst + 16 * e, src + 4 * e);
    }
  };
  // f(shared index, x index, valid) for each x element that this thread
  // stages in stage q, ring slot s: element e = tid + i * THREADS is halo
  // position e / 4, channel e % 4, stored channel-major; past N*L or past
  // Cin it is not valid and is staged as zero
  auto each_x = [&](int q, int s, auto&& f) {
#pragma unroll
    for (int i = 0; i < Tl::X_PER_THREAD; ++i) {
      const int e = tid + i * Tl::THREADS;
      if (e < Tl::X_STAGE) {
        const int row = e / CK, c = e % CK, ci = q * CK + c;
        const long long m = m0 + row;
        const bool valid = m < M && ci < Cin;
        f(s * Tl::STAGE + W_STAGE + c * Tl::XR + row, valid ? (size_t)m * Cin + ci : 0, valid);
      }
    }
  };
  auto stage = [&](int q, int s) {
    copy_w(q, s);
    if constexpr (ASYNC_X)  // fp32: 4-byte copies, in flight while earlier stages are computed
      each_x(q, s, [&](int dst, size_t at, bool valid) { cp_async4(sbase + 4 * dst, x + at, valid); });
    else  // bf16: loads through registers, widened to fp32
      each_x(q, s, [&](int dst, size_t at, bool valid) { smem[dst] = valid ? to_f32(x[at]) : 0.f; });
  };

  for (int q = 0; q < Tl::STAGES - 1; ++q) {
    if (q < kq) stage(q, q);
    cp_async_commit();
  }

  float acc[RT][CT];
#pragma unroll
  for (int r = 0; r < RT; ++r)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[r][j] = 0.f;

  for (int q = 0; q < kq; ++q) {
    cp_async_wait<Tl::STAGES - 2>();  // stage q has landed (this thread's copies) ...
    __syncthreads();                  // ... everyone's, and slot (q-1) % STAGES is free
    const int qn = q + Tl::STAGES - 1;
    if (qn < kq) stage(qn, qn % Tl::STAGES);
    cp_async_commit();
    compute_stage<Tl::XR>(acc, smem + (q % Tl::STAGES) * Tl::STAGE, tx, ty);
  }

  // output channel of accumulator column j (compute_stage's weight loads)
  auto channel = [&](int j) {
    return (int)blockIdx.y * BN + (j < 4 ? 4 * tx + j : j < 8 ? 64 + 4 * tx + j - 4 : 128 + 2 * tx + j - 8);
  };
  float bias[CT];
#pragma unroll
  for (int j = 0; j < CT; ++j) bias[j] = channel(j) < Cout ? to_f32(b[channel(j)]) : 0.f;
  const int l_out = L - KW + 1;
  long long m = m0 + RT * ty;
  long long n = m / L;
  int l = (int)(m - n * L);
#pragma unroll
  for (int r = 0; r < RT; ++r) {
    if (m < M && l < l_out) {  // rows with l >= L-7 straddle two spans
      T* yrow = y + ((size_t)n * l_out + l) * Cout;
      float v[CT];
#pragma unroll
      for (int j = 0; j < CT; ++j) v[j] = fmaxf(acc[r][j] + bias[j], 0.f);
      store_group<4>(yrow, channel(0), v, Cout);
      store_group<4>(yrow, channel(4), v + 4, Cout);
      store_group<2>(yrow, channel(8), v + 8, Cout);
    }
    ++m;
    if (++l == L) {
      l = 0;
      ++n;
    }
  }
}

// rows that the busiest SM computes, for a grid of `tm`-row tiles
long long busiest_rows(long long m, long long cols, int sms, int tm) {
  const long long blocks = (m + tm - 1) / tm * cols;
  return (blocks + sms - 1) / sms * tm;
}

template <typename T, int TM>
int launch(const void* x, const void* wp, const void* b, void* y, long long m, int L, int Cin, int Cout,
           cudaStream_t stream) {
  using Tl = Tile<TM>;
  const cudaError_t err =
      cudaFuncSetAttribute(conv8_relu_kernel<T, TM>, cudaFuncAttributeMaxDynamicSharedMemorySize, Tl::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((m + TM - 1) / TM), (unsigned)((Cout + BN - 1) / BN));
  conv8_relu_kernel<T, TM><<<grid, Tl::THREADS, Tl::SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(wp), static_cast<const T*>(b), static_cast<T*>(y),
      (int)m, L, Cin, Cout);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tile(const void* x, const void* wp, const void* b, void* y, long long m, int L, int Cin, int Cout,
                cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  // a 64-row tile computes a row at about 0.9 of the 128-row tile's rate
  const long long cols = (Cout + BN - 1) / BN;
  if (10 * busiest_rows(m, cols, sms, 64) <= 9 * busiest_rows(m, cols, sms, 128))
    return launch<T, 64>(x, wp, b, y, m, L, Cin, Cout, stream);
  return launch<T, 128>(x, wp, b, y, m, L, Cin, Cout, stream);
}

}  // namespace

// x (n, L, Cin), b (Cout) and y (n, L-7, Cout) of one dtype (0 = fp32,
// 1 = bf16); wp the packed fp32 weights (ops/conv8.py::pack_weights_simt),
// 16-byte aligned. Launches on `stream`, allocates nothing, and returns 0 on
// success or a cudaError_t of the launch.
extern "C" int conv8_relu_launch(const void* x, const void* wp, const void* b, void* y, int n, int L, int Cin,
                                 int Cout, int dtype, void* stream) {
  const long long m = (long long)n * L;
  if (n <= 0 || L < KW || Cin <= 0 || Cout <= 0 || m > 0x7fffffffLL || reinterpret_cast<uintptr_t>(wp) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_tile<float>(x, wp, b, y, m, L, Cin, Cout, s);
  if (dtype == 1) return launch_tile<__nv_bfloat16>(x, wp, b, y, m, L, Cin, Cout, s);
  return (int)cudaErrorInvalidValue;
}
