// fc1 of Beluga as a strided product over a conv6 phase buffer, in fp32
// (parity mode), for the calls with few windows (M <= ops/fc1.py's
// SWAP_MAX_M, at most 64): the operands swapped, so that the weight is
// streamed once, as fp32, and the tensor cores do work in proportion to M:
//
//   y[n, w, o] = sum_{f < 106, c < C} buf[n, s0 + w*stride + f, c] * W[f*C + c, o],  computed as  y^T = W^T x windows^T
//
// buf (N, F, C) fp32 channels last (C = 640) reaches the kernel as its TF32
// hi and lo planes (csrc/fc1_split_tf32.cu); W (106*C, Nout) fp32 (Nout =
// 2,003) packed by ops/fc1.py::pack_weights_tf32x3_swap -> y (N, n_win,
// Nout) fp32: fc1's pre-activations, no bias or ReLU.
//
// Replaces, with csrc/fc1_strided_tf32x3.cu (the calls with more windows),
// the XLA step of expecto_tpu/ops/spans.py::fc1_pre_from_phases, the strided
// valid convolution lax.conv_general_dilated (:421) with the (106, 640,
// 2003) kernel, which the JAX package runs at Precision.HIGHEST. As a GEMM
// it is M = N*n_win windows, N = 2,003 columns, K = 106*640 = 67,840; the
// single-variant requests and the ragged tails of chunks and ranks call it
// at M = 4 - 60.
//
// What bounds it on an H100: the function's bytes are fp32 W, 67,840 x
// 2,003 x 4 = 0.5435 GB, 0.162 ms at 3.35 TB/s (the windows and the output
// are a few MB); three TF32 passes cost 3 x 2 x 67,840 x 2,003 flops, 1.647
// us, a row of M at 495 TFLOP/s. So the function is bound by bytes below M
// ~ 98. The kernel it shares the route with (csrc/fc1_strided_tf32x3.cu)
// streams a pre-split W (hi and lo, 1.11 GB, 0.332 ms) and does the tensor
// work of 128-row tiles whatever M is. Here:
//
// - Swapped operands. 64 output columns of W are wgmma's M side (the A
//   operand), one consumer warpgroup's: ops/fc1.py lays W out as rows of 32
//   K (one 128-byte row, K major, 128-byte swizzle) per output column. The
//   windows are wgmma's N side (the B operand, from shared memory), N = M
//   rounded up to 8 (m64nNk8, N = 8 ... 64, picked a launch from the tile's
//   rows): the tensor work follows round8(M), not 128.
// - W read as fp32, once, and split in registers. One bulk copy a stage
//   (128 columns x 32 K, 16 KB) into the ring; each consumer thread loads
//   its A fragments from it (16 floats a stage: rows 16 w + lane/4 and + 8,
//   K lane % 4 and + 4 of each k8 step, bank-conflict free under the
//   swizzle), splits them into hi and lo (fc1_common.cuh's tf32_rna) and
//   hands them to wgmma as register operands. No split is written back:
//   no store, proxy fence or barrier stands between a stage's arrival and
//   its products, and each W element is split once (one window tile). The
//   fragments are loaded all at once, then split.
// - The windows' hi and lo planes by cp.async, read in place from the
//   split pass's output (no window is copied out), 2 producer threads a
//   window row, rows past M zero-filled and rows past round8(M) not read.
// - A ring whose depth follows N: a stage is W and the windows' two planes
//   (N x 128 bytes each), so the ring holds 12 stages at N = 8 and 7 at N
//   = 64, and the bytes in flight to keep HBM busy are there.
// - The 132 SMs filled by split-K over ops/fc1.py::fc1_schedule's fixed
//   schedule (at M <= 64: one window tile, 4 column tiles a block, 33
//   groups of K chunks), the parts summed in group order by the second pass
//   (fc1_common.cuh): a shape gives the same bits on every call.
// - Three chains a stage, promoted every stage. Each stage's 12 k8 products
//   go to three fresh accumulators, one a pass (lo*hi, hi*lo, hi*hi), four
//   dependent wgmma each instead of one chain of twelve: at N <= 64 a
//   wgmma is short and a chain of twelve left the tensor cores waiting on
//   each other's results. The consumer waits for its group
//   (wgmma.wait_group 0), releases the stage and adds (lo*hi + hi*lo) +
//   hi*hi into an fp32 sum in registers (FADD, round to nearest: the tensor
//   cores' own sum drifts 4.7e-4 of max|y| at K = 67,840); the other
//   consumer warpgroup's group overlaps it. Two accumulators alternating a
//   stage (one chain of twelve, wait_group 1) measured slower, and with no
//   products at all the kernel took 99 % of its time at M = 4 and 91 % at
//   M = 64 (PERF.md, section 6): the copies bound it. The accumulators, the
//   sum and the A registers take 160 of the 224 registers a consumer thread
//   holds.
//
// Shared memory: 1 KB of alignment, `stages` x (16 KB of W, 2 x N x 128
// bytes of window planes), the barriers and the frame order.

#include "fc1_common.cuh"

namespace {

using namespace fc1;

constexpr int BN = 128;                                  // W columns a tile: 2 consumer warpgroups x 64
constexpr int TW = 64;                                   // windows a tile at most (wgmma's N)
constexpr int KC = 32;                                   // K a stage: one 128-byte row
constexpr int W_BYTES = BN * KC * 4;                     // 16,384
constexpr int MAX_STAGES = 12;
constexpr int PRODUCERS = 128;                           // warpgroup 0
constexpr int THREADS = PRODUCERS + 256;                 // + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int ACC = TW / 2;                              // fp32 accumulators a consumer thread at N = 64
constexpr int AREGS = 2 * 4 * (KC / 8);                  // a stage's A fragments: hi and lo of 4 k8 steps
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
// registers a thread at launch: the pool setmaxnreg redistributes
constexpr int LAUNCH_REGS = (PRODUCERS * PRODUCER_REGS + (THREADS - PRODUCERS) * CONSUMER_REGS) / THREADS;  // 168
constexpr int SMEM_MAX = 232448;                         // a block's shared memory
// what the ring leaves to the rest: alignment, barriers, frame order
constexpr int SMEM_FIXED = 1024 + 16 * MAX_STAGES + 4 * MAX_FRAMES;

static_assert(LAUNCH_REGS == 168 && LAUNCH_REGS * THREADS <= 65536, "the register split fills one SM");
static_assert(W_BYTES % 1024 == 0 && (8 * KC * 4) % 1024 == 0, "swizzled tiles start on 1,024-byte boundaries");

// A stage at N = nt windows: W, then the windows' hi and lo planes
__host__ __device__ constexpr int stage_bytes(int nt) { return W_BYTES + 2 * nt * KC * 4; }
// the ring's depth at N = nt: as many stages as fit, at most MAX_STAGES
__host__ __device__ constexpr int ring_stages(int nt) {
  return (SMEM_MAX - SMEM_FIXED) / stage_bytes(nt) < MAX_STAGES ? (SMEM_MAX - SMEM_FIXED) / stage_bytes(nt)
                                                                 : MAX_STAGES;
}
static_assert(ring_stages(TW) == 7 && ring_stages(8) == MAX_STAGES, "the ring is 7 deep at N = 64, 12 at N = 8");

// The shared memory a launch works in: the ring of `stages` stages of
// `bytes` at `ring`, its full and empty barriers, the windows a tile.
struct Ring {
  uint32_t ring, full0, empty0;
  int stages, bytes, nt;
};

// One stage's 12 k8 products, a pass an accumulator: lo*hi into d[0],
// hi*lo into d[1], hi*hi into d[2]; this warpgroup's W fragments a (hi of
// k8 step kk at 8 kk, lo at 8 kk + 4), the windows' hi plane at `xa` (lo
// `xlo` further).
template <int N>
__device__ __forceinline__ void stage_products(float (&d)[3][ACC], const uint32_t (&a)[AREGS], uint32_t xa,
                                               uint32_t xlo) {
#pragma unroll
  for (int kk = 0; kk < KC / 8; ++kk) {
    const int h = 8 * kk, l = h + 4;
    Tf32Wgmma<N>::run(d[0], a[l], a[l + 1], a[l + 2], a[l + 3], sw128_desc(xa + 32 * kk), kk > 0);
    Tf32Wgmma<N>::run(d[1], a[h], a[h + 1], a[h + 2], a[h + 3], sw128_desc(xa + xlo + 32 * kk), kk > 0);
    Tf32Wgmma<N>::run(d[2], a[h], a[h + 1], a[h + 2], a[h + 3], sw128_desc(xa + 32 * kk), kk > 0);
  }
}

// Waits for stage `it`, loads this thread's W fragments (rows `row` and
// row + 8 of the stage's 128, K lane % 4 and + 4 of each k8 step), splits
// them into a, and issues the stage's products into d as one wgmma group.
__device__ __forceinline__ void issue_stage(float (&d)[3][ACC], uint32_t (&a)[AREGS], const Ring& g, int it, int row,
                                            int lane) {
  const int s = it % g.stages;
  mbar_wait(g.full0 + 8 * s, (it / g.stages) & 1);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the producers' cp.async, to wgmma
  const uint32_t sa = g.ring + s * g.bytes, xa = sa + W_BYTES, t = lane % 4;
  const uint32_t w0 = sa + row * 128 + 4 * t, w1 = w0 + 8 * 128, sw = (row & 7);
  float v[16];
#pragma unroll
  for (int kk = 0; kk < KC / 8; ++kk) {
    const uint32_t p0 = ((2 * kk) ^ sw) << 4, p1 = ((2 * kk + 1) ^ sw) << 4;
    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v[4 * kk]) : "r"(w0 + p0) : "memory");
    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v[4 * kk + 1]) : "r"(w1 + p0) : "memory");
    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v[4 * kk + 2]) : "r"(w0 + p1) : "memory");
    asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v[4 * kk + 3]) : "r"(w1 + p1) : "memory");
  }
#pragma unroll
  for (int kk = 0; kk < KC / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float hi = tf32_rna(v[4 * kk + e]);
      a[8 * kk + e] = __float_as_uint(hi);
      a[8 * kk + 4 + e] = __float_as_uint(tf32_rna(v[4 * kk + e] - hi));
    }
  const uint32_t xlo = g.nt * 128;
  fence_acc(d[0]);
  fence_acc(d[1]);
  fence_acc(d[2]);
  wgmma_fence();
  switch (g.nt) {
    case 8: stage_products<8>(d, a, xa, xlo); break;
    case 16: stage_products<16>(d, a, xa, xlo); break;
    case 24: stage_products<24>(d, a, xa, xlo); break;
    case 32: stage_products<32>(d, a, xa, xlo); break;
    case 40: stage_products<40>(d, a, xa, xlo); break;
    case 48: stage_products<48>(d, a, xa, xlo); break;
    case 56: stage_products<56>(d, a, xa, xlo); break;
    default: stage_products<64>(d, a, xa, xlo); break;
  }
  wgmma_commit();
}

// Stage `it`'s group is done: its stage goes back to the producer and its
// three accumulators into the sum, (lo*hi + hi*lo) + hi*hi.
__device__ __forceinline__ void retire_stage(float (&sum)[ACC], float (&d)[3][ACC], const Ring& g, int it, int lane) {
  fence_acc(d[0]);
  fence_acc(d[1]);
  fence_acc(d[2]);
  if (lane == 0) mbar_arrive(g.empty0 + 8 * (it % g.stages));
#pragma unroll
  for (int e = 0; e < ACC; ++e) sum[e] = __fadd_rn(sum[e], __fadd_rn(__fadd_rn(d[0][e], d[1][e]), d[2][e]));
}

__global__ void __launch_bounds__(THREADS, 1)
fc1_strided_tf32x3_swap_kernel(const float* __restrict__ a_hi, const float* __restrict__ a_lo,
                               const float* __restrict__ wp, float* __restrict__ y, float* __restrict__ ws,
                               const Params p, int period) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  Ring g;
  g.nt = (p.tm + 7) & ~7;  // the windows wgmma reads: the tile's rows rounded up to 8
  g.bytes = stage_bytes(g.nt);
  g.stages = ring_stages(g.nt);
  g.ring = (raw + 1023) & ~1023u;
  g.full0 = g.ring + g.stages * g.bytes;  // the "full" barriers, then the "empty" ones
  g.empty0 = g.full0 + g.stages * 8;
  int* frame_of = reinterpret_cast<int*>(smem_raw + (g.empty0 + g.stages * 8 - raw));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  init_ring(g.full0, g.empty0, g.stages, PRODUCERS, CONSUMER_WARPS, frame_of, period, p.frames);
  const Place pl = place(p);

  if (warp < PRODUCERS / 32) {
    // producer warpgroup: 128 threads copy the windows' planes, thread 0 also W
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    const int ra = threadIdx.x >> 1, ha = threadIdx.x & 1;  // window row ra; pieces ha + 2e
    const uint8_t* wbytes = reinterpret_cast<const uint8_t*>(wp);
    int it = 0;
    for (int i = pl.i0; i < p.tiles_m; i += p.rows) {
      const int m = i * p.tm + ra;
      const bool row_ok = ra < p.tm && m < p.M, copy = ra < g.nt;
      const long long off = row_offset(p, row_ok ? m : 0);
      for (long long x = pl.start; x < pl.end;) {
        int cb, k0, k1;
        x = segment(p, pl, x, cb, k0, k1);
        const uint8_t* wsrc = wbytes + (size_t)(cb * p.cols + pl.cc) * p.kt * W_BYTES;
        for (int j = k0; j < k1; ++j, ++it) {
          const int s = it % g.stages;
          if (it >= g.stages) mbar_wait(g.empty0 + 8 * s, ((it / g.stages) - 1) & 1);
          const uint32_t sa = g.ring + s * g.bytes;
          if (copy) {
            const int koff = chunk_offset(p, frame_of, j, KC);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int q = ha + 2 * e, k = koff + 4 * q;
              const bool ok = row_ok && k < p.K;
              const uint32_t dst = sa + W_BYTES + ra * 128 + ((q ^ (ra & 7)) << 4);
              cp_async16_or_zero(dst, ok ? a_hi + off + k : a_hi, ok);
              cp_async16_or_zero(dst + g.nt * 128, ok ? a_lo + off + k : a_lo, ok);
            }
          }
          cp_async_arrive(g.full0 + 8 * s);
          if (threadIdx.x == 0) {
            mbar_expect_tx(g.full0 + 8 * s, W_BYTES);
            bulk_load(sa, wsrc + (size_t)j * W_BYTES, W_BYTES, g.full0 + 8 * s);
          }
        }
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  // consumer warpgroups: cw owns W columns 64 cw .. + 63 of each tile, its
  // warp w rows 16 w .. + 15 of them
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int cw = warp / 4 - 1, row = cw * 64 + (warp % 4) * 16 + lane / 4;
  float acc[3][ACC], sum[ACC];
  uint32_t a[AREGS];
  int it = 0;
  for (int i = pl.i0; i < p.tiles_m; i += p.rows) {
    for (long long x = pl.start; x < pl.end;) {
      const bool first = x == pl.start;
      int cb, k0, k1;
      x = segment(p, pl, x, cb, k0, k1);
#pragma unroll
      for (int e = 0; e < ACC; ++e) sum[e] = 0.f;
      for (int j = k0; j < k1; ++j, ++it) {
        issue_stage(acc, a, g, it, row, lane);
        wgmma_wait<0>();
        retire_stage(sum, acc, g, it, lane);
      }

      // epilogue: accumulator (row, col) of m64nN: row 16 w + lane/4 (+8)
      // = W column, col 8 jj + 2 (lane % 4) (+1) = window, register 4 jj +
      // 2 half + {0, 1}
      const int t = cb * p.cols + pl.cc;
      const bool whole = k0 == 0 && k1 == p.kt;
      const size_t slot = (size_t)(2 * pl.q + (first ? 0 : 1)) * p.cols + pl.cc;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int ol = row + 8 * half, o = t * BN + ol;
#pragma unroll
        for (int jj = 0; jj < TW / 8; ++jj) {
          if (8 * jj >= g.nt) break;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int r = 8 * jj + 2 * (lane % 4) + e, m = i * p.tm + r;
            if (r >= p.tm || m >= p.M) continue;
            if (whole) {
              if (o < p.n_out) y[(size_t)m * p.n_out + o] = sum[4 * jj + 2 * half + e];
            } else {
              ws[(slot * p.M + m) * BN + ol] = sum[4 * jj + 2 * half + e];
            }
          }
        }
      }
    }
  }
}

}  // namespace

// Returns 0 on success or the cudaError_t of a refused launch. a_hi, a_lo:
// the windows' planes (csrc/fc1_split_tf32.cu), n samples `ld` elements
// apart (rows of C channels, 16-byte aligned, C % 4 == 0); window w of
// sample n reads frames s0 + w*stride .. + frames - 1; wp: fp32 W
// (ops/fc1.py::pack_weights_tf32x3_swap at this `period`, which must be 1
// unless C % 32 == 0) of K = frames * C rows padded to a multiple of 32 and
// n_out columns padded to a multiple of BN; y (n, n_win, n_out) fp32;
// (tile_rows <= 64, rows, cols, groups) the schedule (ops/fc1.py::
// fc1_schedule at this instance's tiles); ws: 2 * groups x cols x n*n_win
// x BN fp32 (unused when groups == 1). Launches on `stream`, allocates
// nothing.
extern "C" int fc1_strided_tf32x3_swap_launch(const void* a_hi, const void* a_lo, const void* wp, void* y, void* ws,
                                              int n, int ld, int C, int s0, int stride, int n_win, int frames,
                                              int n_out, int period, int tile_rows, int rows, int cols, int groups,
                                              void* stream) {
  Params p;
  const cudaError_t bad = make_params(p, a_hi, wp, ws, n, ld, C, s0, stride, n_win, frames, n_out, period, tile_rows,
                                      rows, cols, groups, 4, KC, BN, TW);
  if (bad != cudaSuccess || reinterpret_cast<uintptr_t>(a_lo) % 16 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<float*>(y);
  auto* part = static_cast<float*>(ws);
  const int nt = (tile_rows + 7) & ~7;
  const int smem = SMEM_FIXED + ring_stages(nt) * stage_bytes(nt);
  const int err = launch_persistent(fc1_strided_tf32x3_swap_kernel, LAUNCH_REGS, smem,
                                    (unsigned)(groups * rows * cols), THREADS, st, static_cast<const float*>(a_hi),
                                    static_cast<const float*>(a_lo), static_cast<const float*>(wp), out, part, p,
                                    period);
  return err != 0 ? err : launch_partial_sum<float, BN>(part, out, p, st);
}
