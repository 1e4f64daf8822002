// What the fc1 kernels share (csrc/fc1_strided_tc.cu, bf16;
// csrc/fc1_strided_tf32x3.cu and csrc/fc1_strided_tf32x3_swap.cu, fp32;
// csrc/fc1_split_tf32.cu, the fp32 split pass): the mbarrier ring's
// primitives, the copies into shared memory, the wgmma descriptor and
// synchronisation, the persistent schedule (Params, Place, segment,
// group_of, ops/fc1.py::fc1_schedule's walk), the second pass that sums a
// split tile's parts in group order, the launchers' argument checks, and the
// TF32 rounding of the fp32 kernels' split. Each kernel's head note says
// how it uses them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fc1 {

constexpr int MAX_FRAMES = 256;  // the longest frame walk a kernel keeps in shared memory

struct Params {
  long long ld;  // elements between samples
  long long P;   // positions: (tiles_n / cols) column blocks x kt chunks
  int M, n_win, C, s0, stride, K, kt, nb, frames, n_out;
  int tm, tiles_m, rows, cols, groups;  // tm: rows of A (windows) a tile holds
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Waits for the completion of the barrier's phase of parity `parity`. A
// phase that never completes (a lost arrival) traps after 2^26 polls
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// 16 bytes from `src` when `valid`, else 16 zero bytes (nothing is read)
__device__ __forceinline__ void cp_async16_or_zero(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// the barrier's phase counts one arrival of this thread once all of its
// earlier cp.async have landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle, K-major: rows of 128
// bytes, 8-row groups 1,024 bytes apart; `addr` on a 1,024-byte boundary
// plus 32 bytes per K step (k16 in bf16, k8 in tf32)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Thread 0 sets up the ring: `stages` "full" barriers at full0 (every
// producer thread's cp.async and the bulk copy's expect_tx) and "empty"
// ones at empty0 (one arrival a consumer warp), 8 bytes apart, and the
// frames of a window in walk order (r, r + period, ... for r < period) in
// frame_of.
__device__ __forceinline__ void init_ring(uint32_t full0, uint32_t empty0, int stages, int producers,
                                          int consumer_warps, int* frame_of, int period, int frames) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, producers + 1);
      mbar_init(empty0 + 8 * s, consumer_warps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    int j = 0;
    for (int r = 0; r < period; ++r)
      for (int f = r; f < frames; f += period) frame_of[j++] = f;
  }
  __syncthreads();
}

// This CTA's place in the schedule: group q, column cc of the block, first
// row tile i0, and the group's range [start, end) of positions.
struct Place {
  long long start, end;
  int q, cc, i0;
};

__device__ __forceinline__ Place place(const Params& p) {
  const int per = p.rows * p.cols;
  Place pl;
  pl.q = blockIdx.x / per;
  const int idx = blockIdx.x - pl.q * per;
  pl.cc = idx / p.rows;
  pl.i0 = idx - pl.cc * p.rows;
  pl.start = (long long)pl.q * p.P / p.groups;
  pl.end = (long long)(pl.q + 1) * p.P / p.groups;
  return pl;
}

// The K chunks [k0, k1) of column block cb that the range takes from x on;
// returns the position after them.
__device__ __forceinline__ long long segment(const Params& p, const Place& pl, long long x, int& cb, int& k0,
                                             int& k1) {
  cb = (int)(x / p.kt);
  const long long xe = min(pl.end, (long long)(cb + 1) * p.kt);
  k0 = (int)(x - (long long)cb * p.kt);
  k1 = (int)(xe - (long long)cb * p.kt);
  return xe;
}

// the element offset of K chunk j (kc deep) in a window: by the frame walk
// where a chunk lies inside one frame (nb = C / kc chunks a frame), else in
// order
__device__ __forceinline__ int chunk_offset(const Params& p, const int* frame_of, int j, int kc) {
  return p.nb ? frame_of[j / p.nb] * p.C + (j % p.nb) * kc : j * kc;
}

// the element offset of row m (window w of sample n) in the buffer
__device__ __forceinline__ long long row_offset(const Params& p, int m) {
  const int n = m / p.n_win, w = m - n * p.n_win;
  return n * p.ld + ((long long)p.s0 + (long long)w * p.stride) * p.C;
}

// the group whose range holds position x: the largest q with q*P/groups <= x
__device__ __forceinline__ int group_of(long long x, long long P, int groups) {
  return (int)(((x + 1) * groups - 1) / P);
}

__device__ __forceinline__ void store_out(float* y, float v) { *y = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* y, float v) { *y = __float2bfloat16(v); }

// y[m, c] = the parts of column tile c / BN summed in the order of their
// groups (rounded to T), for the tiles that more than one group took part in
template <typename T, int BN>
__global__ void partial_sum_kernel(const float* __restrict__ ws, T* __restrict__ y, int M, int n_out, int kt,
                                   int cols, int groups, long long P) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)M * n_out) return;
  const int m = (int)(i / n_out), c = (int)(i - (long long)m * n_out);
  const int t = c / BN, cb = t / cols, cc = t - cb * cols;
  const long long x0 = (long long)cb * kt;
  const int qf = group_of(x0, P, groups), ql = group_of(x0 + kt - 1, P, groups);
  if (qf == ql) return;  // one group's range held the whole tile: stored already
  float s = 0.f;
  for (int q = qf; q <= ql; ++q) {
    const int slot = 2 * q + (((long long)q * P / groups) / kt == cb ? 0 : 1);
    s += ws[(((size_t)slot * cols + cc) * M + m) * BN + (c - t * BN)];
  }
  store_out(y + i, s);
}

// x rounded to TF32, to nearest with ties away from zero (cvt.rna's
// rounding), as an fp32 value whose low 13 mantissa bits are zero: adding
// half a TF32 step to the bits carries into the kept ones exactly when the
// magnitude rounds up (ops/fc1.py::split_tf32 does the same)
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// The launchers' checks of a kernel instance's arguments (tiles of at most
// tm_max rows and bn columns, kc-deep K chunks, `per` elements in 16 bytes);
// fills p. Returns cudaSuccess or cudaErrorInvalidValue.
inline cudaError_t make_params(Params& p, const void* buf, const void* wp, const void* ws, int n, int ld, int C,
                               int s0, int stride, int n_win, int frames, int n_out, int period, int tile_rows,
                               int rows, int cols, int groups, int per, int kc, int bn, int tm_max) {
  const long long m = (long long)n * n_win, k = (long long)frames * C, kt = (k + kc - 1) / kc;
  if (n <= 0 || n_win <= 0 || C <= 0 || C % per != 0 || frames <= 0 || frames > MAX_FRAMES || k > 0x7fffffffLL ||
      s0 < 0 || stride <= 0 || ld <= 0 || ld % per != 0 || n_out <= 0 || m > 0x7fffffffLL || period <= 0 ||
      period > frames || (period > 1 && C % kc != 0) || reinterpret_cast<uintptr_t>(buf) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wp) % 16 != 0 || tile_rows <= 0 || tile_rows > tm_max)
    return cudaErrorInvalidValue;
  const long long tiles_m = (m + tile_rows - 1) / tile_rows, tiles_n = (n_out + bn - 1) / bn;
  if (rows <= 0 || rows > tiles_m || cols <= 0 || tiles_n % cols != 0 || groups <= 0 ||
      (long long)groups * rows * cols > 0x7fffffffLL || (groups > 1 && ws == nullptr) ||
      groups > tiles_n / cols * kt)
    return cudaErrorInvalidValue;
  p.ld = ld;
  p.P = tiles_n / cols * kt;
  p.M = (int)m;
  p.n_win = n_win;
  p.C = C;
  p.s0 = s0;
  p.stride = stride;
  p.K = (int)k;
  p.kt = (int)kt;
  p.nb = C % kc == 0 ? C / kc : 0;
  p.frames = frames;
  p.n_out = n_out;
  p.tm = tile_rows;
  p.tiles_m = (int)tiles_m;
  p.rows = rows;
  p.cols = cols;
  p.groups = groups;
  return cudaSuccess;
}

// Launches a warp-specialized kernel on its persistent grid: refuses a build
// with fewer than `launch_regs` registers a thread (its setmaxnreg.inc would
// wait forever for registers the CTA was not launched with), then allows its
// dynamic shared memory. Returns the cudaError_t.
template <typename Kernel, typename... Args>
int launch_persistent(Kernel kernel, int launch_regs, int smem, unsigned grid, int threads, cudaStream_t st,
                      Args... args) {
  cudaFuncAttributes fa;
  cudaError_t err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return (int)err;
  if (fa.numRegs < launch_regs) return (int)cudaErrorInvalidConfiguration;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

// The second pass over a launch's parts, when the schedule split tiles
// between groups (ws: 2 * groups x cols x M x BN fp32).
template <typename T, int BN>
int launch_partial_sum(const float* ws, T* y, const Params& p, cudaStream_t st) {
  if (p.groups == 1) return 0;
  const long long total = (long long)p.M * p.n_out;
  partial_sum_kernel<T, BN><<<(unsigned)((total + 255) / 256), 256, 0, st>>>(ws, y, p.M, p.n_out, p.kt, p.cols,
                                                                            p.groups, p.P);
  return (int)cudaGetLastError();
}

}  // namespace fc1
