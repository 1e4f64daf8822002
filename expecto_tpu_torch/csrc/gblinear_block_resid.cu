// The K-model trainer's block step, second kernel: the residual product
// with its add.
//
//   r += dw^T Xb                     (K, n): the residual of K models over n rows
//
// Xb (B, n) fp32, rows `ld` apart (ld % 4 == 0); dw reaches the kernel as
// the first kernel's (or csrc/gblinear_cd.cu's) TF32 hi and lo planes (2,
// n_pad, b_pad), K-major (each model's features contiguous); r (K, n) fp32,
// each model's rows `ld` apart (the transpose of the JAX package's (n,
// K)), updated in place.
//
// Replaces, with csrc/gblinear_block_grad.cu, the block step of
// expecto_tpu/models/gblinear.py::_multi_round_body (:246-251): XLA's
// r + jnp.dot(Xb.T, dw), which the port ran as SGEMM and torch's add. No
// pallas_call.
//
// What bounds it on an H100: three TF32 passes of 2 B n K flops at 495
// TFLOP/s against X read once and r read and written once: at B = 512, n =
// 21,202, K = 218, 28.7 us of tensor work against 24.0 us of bytes. Here:
//
// - X as wgmma's A side from registers (csrc/gblinear_block.cuh), its rows
//   now the M side: a CTA's unit is 128 rows (two consumer warpgroups x 64)
//   by one tile of nt <= 128 models, the contraction the block's features,
//   32 a stage. X (B, n) is M-major for this product: one producer thread
//   copies each stage by tensor map (TMA) as 4 boxes of 32 rows x 32
//   features, each feature's 32 rows one 128-byte swizzled row, and dw's two
//   planes; each consumer thread loads its fragments (rows lane/4 and + 8,
//   features lane % 4 and + 4) across the boxes, at most 2 lanes a bank.
//   Beside the epilogue's tile (below) the ring holds 3 stages at nt = 128,
//   8 at nt = 8.
// - One accumulator chain over the block's B features, not promoted: 16
//   stages at B = 512, whose truncation lands in the increment, not in r
//   (r's add is an FADD, rounded to nearest). A stage's group stays in
//   flight while the next stage's fragments are loaded and split (two sets
//   of A registers, wgmma.wait_group 1).
// - The epilogue in r's own layout: the consumers put their accumulators
//   into a 128-row tile of shared memory a model a row (T, 66 KB beside
//   the ring), then each warp takes
//   whole model rows, a lane 4 data rows: every load and store of r is 512
//   contiguous bytes a warp, and a thread's loads go out before its
//   stores.
// - A persistent grid: row tiles x model tiles units, model tiles fastest
//   (their X rows come again from L2), a CTA an SM, each unit's epilogue
//   overlapping the next unit's copies. No split of the contraction, so no
//   part sums and the same bits every call.
//
// Shared memory: 1 KB of alignment, `stages` x (16 KB of X, 2 x nt x 128
// bytes of planes), the barriers.

#include "gblinear_block.cuh"

namespace {

using namespace gbblock;

// The kernel's arguments beside its two tensor maps (X's rows, dw's planes)
struct ResidParams {
  float* r;  // (K, ld), updated in place
  int ld, K, nt, tiles, n_pad, b_pad, units;
};

// This thread's fragment offsets in a stage's X (4 boxes of 32 rows x 32
// features, feature f's 32 rows of box `rb` at rb * 4096 + f * 128, piece
// q in slot q ^ (f % 8)): features lane % 4 (+4) of a k8 step, rows `row`
// and row + 8
struct XOffsets {
  uint32_t o[4];  // (f, row), (f, row + 8), (f + 4, row), (f + 4, row + 8) at k8 step 0
};

__device__ __forceinline__ uint32_t x_offset(int f, int m) {
  return (m >> 5) * 4096 + f * 128 + ((((m & 31) >> 2) ^ (f & 7)) << 4) + (m & 3) * 4;
}

// Loads a stage's fragment values (k8 step kk at + 8 kk features) and
// splits them into a.
__device__ __forceinline__ void load_split(uint32_t xa, const XOffsets& xo, uint32_t (&a)[AREGS]) {
#pragma unroll
  for (int kk = 0; kk < KC / 8; ++kk) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v[e]) : "r"(xa + xo.o[e] + kk * 8 * 128) : "memory");
    split_fragment(v, a, kk);
  }
}

// Issues stage `it`'s products (A in a) into d as one wgmma group, without
// waiting for it.
__device__ __forceinline__ void issue(float (&d)[ACC], uint32_t (&a)[AREGS], const Ring& g, const XOffsets& xo, int it,
                                      bool fresh) {
  const int slot = it % g.stages;
  mbar_wait(g.full0 + 8 * slot, (it / g.stages) & 1);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  const uint32_t sa = g.ring + slot * g.bytes;
  load_split(sa, xo, a);
  run_products<KC / 8>(d, a, g, sa + X_BYTES, fresh, 0);
}

__device__ __forceinline__ void release(const Ring& g, int it, int lane) {
  if (lane == 0) mbar_arrive(g.empty0 + 8 * (it % g.stages));
}

// The epilogue's tile: a row of TS floats a model, 128 data rows and 4 of
// padding (conflict-free writes of the accumulator fragments)
constexpr int TS = TILE_ROWS + 4;
constexpr int T_BYTES = NT_MAX * TS * 4;  // 67,584
constexpr int EPI_ROWS = NT_MAX / CONSUMER_WARPS;  // model rows a warp at nt = 128

__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 256;" ::: "memory"); }

// One pass of the epilogue over warp cw8's model rows q0 .. q0 + EPI_PASS -
// 1 (of cw8, cw8 + 8, ...), this lane's data rows i0 + 4 lane .. + 3: r's
// values loaded first (a store to r could alias a later load), then r + T
// written. Rows past n lie in r's padding (zero), whose sums stay zero.
constexpr int EPI_PASS = EPI_ROWS / 2;  // two passes: fewer registers live

__device__ __forceinline__ void epilogue_pass(const ResidParams& p, const float* T, int cw8, int lane, int i0, int m0,
                                              int q0) {
  const int m = i0 + 4 * lane;
  if (m >= p.ld) return;
  float4 rv[EPI_PASS];
#pragma unroll
  for (int q = 0; q < EPI_PASS; ++q) {
    const int kl = cw8 + CONSUMER_WARPS * (q0 + q), k = m0 + kl;
    rv[q] = kl < p.nt && k < p.K ? *reinterpret_cast<const float4*>(p.r + (size_t)k * p.ld + m)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int q = 0; q < EPI_PASS; ++q) {
    const int kl = cw8 + CONSUMER_WARPS * (q0 + q), k = m0 + kl;
    if (kl >= p.nt || k >= p.K) continue;
    const float4 a4 = *reinterpret_cast<const float4*>(T + kl * TS + 4 * lane);
    *reinterpret_cast<float4*>(p.r + (size_t)k * p.ld + m) = make_float4(
        __fadd_rn(rv[q].x, a4.x), __fadd_rn(rv[q].y, a4.y), __fadd_rn(rv[q].z, a4.z), __fadd_rn(rv[q].w, a4.w));
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    gblinear_block_resid_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap dwmap,
                                const ResidParams p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Ring g = make_ring(smem_raw, p.nt, T_BYTES, 0);
  // T after the barriers' fixed room (24 bytes a stage at most: 16-byte aligned)
  float* T = reinterpret_cast<float*>(smem_raw + (g.full0 + 24 * MAX_STAGES - smem_addr(smem_raw)));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int f_stages = p.b_pad / KC;

  if (warp < PRODUCERS / 32) {
    // producer warpgroup: thread 0 issues every stage's copies
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x != 0) return;
    int it = 0;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
      const int i0 = (u / p.tiles) * TILE_ROWS, m0 = (u % p.tiles) * p.nt;
      for (int st = 0; st < f_stages; ++st, ++it) {
        const int slot = it % g.stages;
        if (it >= g.stages) mbar_wait(g.empty0 + 8 * slot, ((it / g.stages) - 1) & 1);
        const uint32_t sa = g.ring + slot * g.bytes, bar = g.full0 + 8 * slot;
        mbar_expect_tx(bar, g.bytes);
#pragma unroll
        for (int rb = 0; rb < TILE_ROWS / 32; ++rb) tma_load_2d(sa + rb * 4096, &xmap, bar, i0 + 32 * rb, st * KC);
        load_planes(sa + X_BYTES, &dwmap, bar, st * KC, m0, p.n_pad, p.nt);
      }
    }
    return;
  }

  // consumer warpgroups: cw owns rows 64 cw .. + 63 of the unit, its warp w
  // rows 16 w .. + 15 of them
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int cw = warp / 4 - 1, row = cw * 64 + (warp % 4) * 16 + lane / 4, t4 = lane % 4;
  XOffsets xo;
  xo.o[0] = x_offset(t4, row);
  xo.o[1] = x_offset(t4, row + 8);
  xo.o[2] = x_offset(t4 + 4, row);
  xo.o[3] = x_offset(t4 + 4, row + 8);
  float acc[ACC];
  uint32_t a0[AREGS], a1[AREGS];
#pragma unroll
  for (int e = 0; e < ACC; ++e) acc[e] = 0.f;
  int it = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    const int i0 = (u / p.tiles) * TILE_ROWS, m0 = (u % p.tiles) * p.nt;
    // stages in pairs, A's two register sets alternating: stage st's group
    // stays in flight while st + 1's fragments are loaded and issued
    for (int st = 0; st < f_stages; st += 2) {
      issue(acc, a0, g, xo, it, st == 0);
      if (st > 0) {
        wgmma_wait<1>();
        release(g, it - 1, lane);
      }
      ++it;
      if (st + 1 < f_stages) {
        issue(acc, a1, g, xo, it, false);
        wgmma_wait<1>();
        release(g, it - 1, lane);
        ++it;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    release(g, it - 1, lane);

    // epilogue: accumulator (row, col) of m64nN: row 16 w + lane/4 (+8) =
    // data row, col 8 jj + 2 (lane % 4) (+1) = model, register 4 jj + 2 half
    // + {0, 1}, into T[model][row]; then warp cw8 takes model rows cw8, cw8
    // + 8, ... (epilogue_pass)
    consumer_sync();  // the previous unit's reads of T are done
#pragma unroll
    for (int idx = 0; idx < ACC; ++idx) {
      const int jj = idx / 4, kl = 8 * jj + 2 * t4 + idx % 2;
      if (8 * jj < p.nt) T[kl * TS + row + 8 * ((idx / 2) % 2)] = acc[idx];
    }
    consumer_sync();
    const int cw8 = warp - PRODUCERS / 32;
#pragma unroll
    for (int q0 = 0; q0 < EPI_ROWS; q0 += EPI_PASS) epilogue_pass(p, T, cw8, lane, i0, m0, q0);
  }
}

}  // namespace

// Returns 0 on success or the cudaError_t of a refused launch. x: Xb (B,
// n) fp32 rows `ld` apart, 16-byte aligned; dw: dw's planes (2, tiles * nt,
// b_pad), b_pad a multiple of 32 and zero past B; r (K, n) rows `ld` apart,
// 16-byte aligned, zero in its padding. `grid` CTAs (at most the units:
// ceil(n / 128) row tiles x tiles) on `stream`; allocates nothing.
extern "C" int gblinear_block_resid_launch(const void* x, const void* dw, void* r, int n, int ld, int B, int K, int nt,
                                           int tiles, int b_pad, int grid, void* stream) {
  if (!common_ok(x, n, ld, B, K, nt, tiles, b_pad) || reinterpret_cast<uintptr_t>(dw) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(r) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  ResidParams p;
  p.r = static_cast<float*>(r);
  p.ld = ld;
  p.K = K;
  p.nt = nt;
  p.tiles = tiles;
  p.n_pad = tiles * nt;
  p.b_pad = b_pad;
  p.units = ((n + TILE_ROWS - 1) / TILE_ROWS) * tiles;
  if (grid <= 0 || grid > p.units) return (int)cudaErrorInvalidValue;
  CUtensorMap xmap, dwmap;
  int bad = cached_fp32_rows(&xmap, x, n, B, ld, 32);
  if (bad == 0) bad = cached_fp32_rows(&dwmap, dw, b_pad, 2LL * p.n_pad, b_pad, nt);
  static unsigned prepared = 0;  // a bit a device
  if (bad == 0) bad = prepare_once(gblinear_block_resid_kernel, LAUNCH_REGS, SMEM_MAX, prepared);
  if (bad != 0) return bad;
  gblinear_block_resid_kernel<<<(unsigned)grid, THREADS, smem_bytes(nt, T_BYTES), static_cast<cudaStream_t>(stream)>>>(
      xmap, dwmap, p);
  return (int)cudaGetLastError();
}
