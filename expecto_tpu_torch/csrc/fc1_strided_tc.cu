// fc1 of Beluga as a strided product over a conv6 phase buffer, in bf16 on
// Hopper's tensor cores (wgmma):
//
//   y[n, w, o] = sum_{f < 106, c < C} buf[n, s0 + w*stride + f, c] * W[f*C + c, o]
//
// buf (N, F, C) bf16 channels last (C = 640), W (106*C, Nout) bf16 (Nout =
// 2,003) packed by ops/fc1.py (below) -> y (N, n_win, Nout) bf16: fc1's
// pre-activations, no bias or ReLU. The sum is fp32 in registers.
//
// Replaces the XLA step of expecto_tpu/ops/spans.py::fc1_pre_from_phases,
// the strided valid convolution lax.conv_general_dilated (:421) with the
// (106, 640, 2003) kernel, for bf16 (the production dtype). As a GEMM it is
// M = N*n_win windows, N = 2,003 columns, K = 106*640 = 67,840.
//
// What bounds it on an H100: 2*M*67,840*2,003 operations at 989 TFLOP/s
// against the 278 MB of packed weight (and far fewer bytes of windows) at
// 3.35 TB/s. The two meet near M = 300; serving and the h5 step call fc1 at
// M = 227-560 rows a GEMM, the gene path at 800-1,600: around the ridge and
// above it, so the design keeps the tensor cores fed:
//
// - No window copy. Row m = n*n_win + w of A starts at element
//   n*ld + (s0 + w*stride)*C of the buffer and is 67,840 contiguous
//   elements long: the frames of a window are adjacent, channels last.
//   Every thread loads 16-byte pieces of 4 fixed rows straight from the
//   buffer with cp.async; overlapping windows only read memory again (from
//   L2). The (N, n_win, 67,840) tensor that `unfold` + matmul builds is
//   never made.
// - wgmma, A and B from shared memory, in the no-swizzle K-major layout of
//   csrc/conv8_relu_tc.cu: each 8-element K group is a column of 16-byte
//   rows. A's columns are padded by one row (2,064 bytes) so that the 8
//   threads that store the 8 groups of one row hit 8 different bank groups.
//   ops/fc1.py packs W once per weight tensor into (Nout/256, K/64, 8
//   groups, 256, 8), the columns zero-padded to a multiple of 256 (2,003 ->
//   2,048), so one stage of B is one contiguous 32 KB block and every row of
//   it is 16-byte aligned: the unpadded 4,006-byte row stride is what sends
//   cuBLAS to its align1 tiles.
// - Tiles. A block owns 128 rows x 256 columns: each of its two warpgroups
//   runs m64n256k16 over 64 rows (128 fp32 accumulators a thread). Stages
//   of K = 64 (16.1 KB of A, 32 KB of B), four in a cp.async ring, all 256
//   threads loading and then multiplying; each thread fences its copies
//   into the async proxy before the block barrier that hands a stage to
//   wgmma.
// - Small M, split K. At M = 560 there are 5 x 8 tiles for 132 SMs, so the
//   K range is cut into `splits` slices (ops/fc1.py::fc1_splits picks the
//   count from the SM count): each block writes its fp32 partial tile to a
//   workspace, and a second pass sums the slices in a fixed order and
//   rounds to bf16. No atomics: a call gives the same bits every time.
//   With one slice the block rounds and stores y itself.
// - The grid walks row tiles fastest, so the blocks that read one block
//   column of the weight run together and share it in L2: the weight is
//   read from device memory about once a call.
//
// Shared memory: 4 stages x (16,512 B of A + 32,768 B of B) = 197,120 B.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 128;                         // rows a block (2 warpgroups x 64)
constexpr int BN = 256;                         // columns a block
constexpr int KC = 64;                          // K a stage: 8 groups of 8
constexpr int STAGES = 4;
constexpr int THREADS = 256;
constexpr int A_COL = TM * 16 + 16;             // one K group of A, padded one row
constexpr int A_BYTES = 8 * A_COL;              // 16,512
constexpr int B_COL = BN * 16;                  // one K group of B
constexpr int B_BYTES = 8 * B_COL;              // 32,768
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;  // 49,280
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES;
constexpr int ACC = BN / 2;                     // fp32 accumulators a thread
constexpr int A_ROWS_PER_THREAD = TM * 8 / THREADS;     // 4 16-byte pieces of A a stage
constexpr int B_PIECES_PER_THREAD = B_BYTES / 16 / THREADS;  // 8 of B

static_assert(STAGE_BYTES % 128 == 0 && A_BYTES % 16 == 0, "wgmma descriptors need 16-byte aligned tiles");
static_assert(A_ROWS_PER_THREAD * THREADS / 8 == TM, "every row of A is loaded");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(src) : "memory");
}

// 16 bytes from `src` when `valid`, else 16 zero bytes (nothing is read)
__device__ __forceinline__ void cp_async16_or_zero(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// wgmma shared-memory descriptor, no swizzle, K-major: `lbo` is the byte
// stride between the two 8-element K columns of a k16 slice, `sbo` the byte
// stride between 8-row groups along M (or N).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma that owns them.
__device__ __forceinline__ void fence_acc(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256 fp32, this thread's 128) += A (64 x 16 bf16) * B (16 x 256 bf16)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[ACC], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

// One block: rows [128 bx, +128) x columns [256 by, +256) of the product
// over K chunks [kt*bz/splits, kt*(bz+1)/splits) of 64. A K that is not a
// multiple of 64 (Beluga's 67,840 is; narrow test widths need not be) ends
// in a chunk whose groups past K are zero-filled in A, as they are zero in
// the packed B.
__global__ void __launch_bounds__(THREADS, 1)
fc1_strided_tc_kernel(const __nv_bfloat16* __restrict__ buf, const __nv_bfloat16* __restrict__ wp,
                      __nv_bfloat16* __restrict__ y, float* __restrict__ ws, int M, int n_win, long long ld, int C,
                      int s0, int stride, int K, int kt, int splits, int n_out) {
  extern __shared__ __align__(128) uint8_t smem[];
  const uint32_t base = smem_addr(smem);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, wg = warp / 4;
  const int m0 = blockIdx.x * TM, split = blockIdx.z;
  const int kc0 = (int)((long long)kt * split / splits);
  const int nk = (int)((long long)kt * (split + 1) / splits) - kc0;

  // this thread's pieces of A: K group g of rows tid/8 + 32 i; rows past M
  // read row M-1 (in bounds) and are never stored
  const int g = tid % 8;
  const __nv_bfloat16* arow[A_ROWS_PER_THREAD];
  uint32_t adst[A_ROWS_PER_THREAD];
#pragma unroll
  for (int i = 0; i < A_ROWS_PER_THREAD; ++i) {
    const int r = tid / 8 + 32 * i;
    const int m = min(m0 + r, M - 1);
    const int n = m / n_win, w = m - n * n_win;
    arow[i] = buf + n * ld + ((long long)s0 + (long long)w * stride) * C + (long long)kc0 * KC + 8 * g;
    adst[i] = g * A_COL + r * 16;
  }
  // this thread's pieces of B: bytes 16 tid + 4,096 q of each packed block
  const uint8_t* bsrc = reinterpret_cast<const uint8_t*>(wp) + ((size_t)blockIdx.y * kt + kc0) * B_BYTES + 16 * tid;

  auto load = [&](int stage, int j) {
    const uint32_t sa = base + stage * STAGE_BYTES;
    const bool in_k = (kc0 + j) * KC + 8 * g < K;
#pragma unroll
    for (int i = 0; i < A_ROWS_PER_THREAD; ++i)
      cp_async16_or_zero(sa + adst[i], in_k ? arow[i] + (size_t)j * KC : arow[i], in_k);
    const uint8_t* src = bsrc + (size_t)j * B_BYTES;
#pragma unroll
    for (int q = 0; q < B_PIECES_PER_THREAD; ++q) cp_async16(sa + A_BYTES + 16 * tid + q * THREADS * 16, src + q * THREADS * 16);
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();  // an empty group past the end keeps the count
  }

  float d[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) d[i] = 0.f;

  for (int it = 0; it < nk; ++it) {
    cp_async_wait<STAGES - 2>();  // this thread's pieces of stage `it` have landed
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();  // every thread's pieces landed; stage it-1 is free (its wgmma waited)
    const int next = it + STAGES - 1;
    if (next < nk) load(next % STAGES, next);
    cp_async_commit();

    const uint32_t sa = base + (it % STAGES) * STAGE_BYTES;
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk)
      wgmma_m64n256k16(d, smem_desc(sa + 2 * kk * A_COL + wg * 64 * 16, A_COL, 128),
                       smem_desc(sa + A_BYTES + 2 * kk * B_COL, B_COL, 128));
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(d);
  }
  cp_async_wait<0>();

  // epilogue: accumulator (row, col) of m64nN: row 16 w + lane/4 (+8), col
  // 8 j + 2 (lane % 4) (+1), register 4 j + 2 half + {0, 1}
  const int c_base = blockIdx.y * BN + 2 * (lane % 4);
  const int n_pad = gridDim.y * BN;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + wg * 64 + (warp % 4) * 16 + lane / 4 + 8 * half;
    if (m >= M) continue;
    if (splits > 1) {
      float* wrow = ws + ((size_t)split * M + m) * n_pad;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        *reinterpret_cast<float2*>(wrow + c_base + 8 * j) = make_float2(d[4 * j + 2 * half], d[4 * j + 2 * half + 1]);
    } else {
      __nv_bfloat16* yrow = y + (size_t)m * n_out;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = c_base + 8 * j;
        if (c < n_out) yrow[c] = __float2bfloat16(d[4 * j + 2 * half]);
        if (c + 1 < n_out) yrow[c + 1] = __float2bfloat16(d[4 * j + 2 * half + 1]);
      }
    }
  }
}

// y[m, c] = bf16(sum over the slices s in order of ws[s, m, c]): the split-K
// partial tiles summed in a fixed order.
__global__ void fc1_split_sum_kernel(const float* __restrict__ ws, __nv_bfloat16* __restrict__ y, int M, int n_out,
                                     int n_pad, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)M * n_out) return;
  const int m = (int)(i / n_out), c = (int)(i - (long long)m * n_out);
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += ws[((size_t)k * M + m) * n_pad + c];
  y[i] = __float2bfloat16(s);
}

}  // namespace

// Returns 0 on success or the cudaError_t of a refused launch. buf: n
// samples of `ld` elements apart (rows of C channels, 16-byte aligned, C % 8
// == 0); window w of sample n reads frames s0 + w*stride .. + frames - 1;
// wp: the packed weights (ops/fc1.py::pack_weights_fc1) of K = frames * C
// rows padded to a multiple of 64 and n_out columns padded to a multiple of
// 256; y (n, n_win, n_out) bf16; ws: splits x n*n_win x the padded columns
// of fp32 (unused when splits == 1). Launches on `stream`, allocates
// nothing.
extern "C" int fc1_strided_tc_launch(const void* buf, const void* wp, void* y, void* ws, int n, int ld, int C,
                                     int s0, int stride, int n_win, int frames, int n_out, int splits, void* stream) {
  const long long m = (long long)n * n_win, k = (long long)frames * C, kt = (k + KC - 1) / KC;
  if (n <= 0 || n_win <= 0 || C <= 0 || C % 8 != 0 || frames <= 0 || k > 0x7fffffffLL || s0 < 0 || stride <= 0 ||
      ld <= 0 || ld % 8 != 0 || n_out <= 0 || m > 0x7fffffffLL || splits <= 0 || splits > kt ||
      (splits > 1 && ws == nullptr) || reinterpret_cast<uintptr_t>(buf) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wp) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int tiles_n = (n_out + BN - 1) / BN;
  if (tiles_n > 65535 || splits > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);

  cudaError_t err = cudaFuncSetAttribute(fc1_strided_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((m + TM - 1) / TM), (unsigned)tiles_n, (unsigned)splits);
  fc1_strided_tc_kernel<<<grid, THREADS, SMEM_BYTES, st>>>(
      static_cast<const __nv_bfloat16*>(buf), static_cast<const __nv_bfloat16*>(wp), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(ws), (int)m, n_win, (long long)ld, C, s0, stride, (int)k, (int)kt, splits, n_out);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const long long total = m * n_out;
  fc1_split_sum_kernel<<<(unsigned)((total + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<__nv_bfloat16*>(y), (int)m, n_out, tiles_n * BN, splits);
  return (int)cudaGetLastError();
}
