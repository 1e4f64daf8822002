// What the fc1 kernels share (csrc/fc1_strided_tc.cu, bf16;
// csrc/fc1_strided_tf32x3.cu and csrc/fc1_strided_tf32x3_swap.cu, fp32;
// csrc/fc1_split_tf32.cu, the fp32 split pass) beyond csrc/hopper_common.cuh
// (the mbarrier ring's primitives, the copies into shared memory, the wgmma
// descriptor, synchronisation and tf32 instances, the TF32 rounding of the
// fp32 kernels' split, the persistent launcher): the ring's set-up with the
// frame order, the persistent schedule (Params, Place, segment, group_of,
// ops/fc1.py::fc1_schedule's walk), the second pass that sums a split tile's
// parts in group order and the launchers' argument checks. Each kernel's
// head note says how it uses them.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_common.cuh"

namespace fc1 {

using namespace hopper;

constexpr int MAX_FRAMES = 256;  // the longest frame walk a kernel keeps in shared memory

struct Params {
  long long ld;  // elements between samples
  long long P;   // positions: (tiles_n / cols) column blocks x kt chunks
  int M, n_win, C, s0, stride, K, kt, nb, frames, n_out;
  int tm, tiles_m, rows, cols, groups;  // tm: rows of A (windows) a tile holds
};

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
