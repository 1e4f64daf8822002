// What the two kernels of the K-model trainer's block step share
// (csrc/gblinear_block_grad.cu, the gradient product with the coordinate
// update; csrc/gblinear_block_resid.cu, the residual product with its add):
// the warp-specialized ring (one producer thread issuing tensor-map copies,
// two consumer warpgroups; a stage 32 deep holds a 128-row tile of X and the
// hi and lo planes of the other operand), the planes' copy, the split of a
// consumer's A fragments in registers, and the three-pass TF32 products of
// a stage on one accumulator chain at the tile's width N.
//
// Both kernels take X as wgmma's A side from registers (each consumer
// thread loads its fragments from the fp32 stage and splits them into TF32
// hi and lo, as csrc/fc1_strided_tf32x3_swap.cu does with W): X is read as
// fp32, once a product, which is the function's bytes. The models are the
// N side, N = the tile's width (a multiple of 8, at most 128), B from
// shared memory as TF32 hi and lo planes, K-major, 128-byte swizzled.

#pragma once

#include "hopper_common.cuh"

namespace gbblock {

using namespace hopper;

constexpr int KC = 32;                          // the contraction a stage: one 128-byte row of fp32
constexpr int TILE_ROWS = 128;                  // a CTA's rows of X's side: 2 consumer warpgroups x 64
constexpr int NT_MAX = 128;                     // models a tile at most (wgmma's N)
constexpr int X_BYTES = TILE_ROWS * KC * 4;     // 16,384
constexpr int MAX_STAGES = 12;
constexpr int PRODUCERS = 128;                  // warpgroup 0
constexpr int CONSUMERS = 256;                  // warpgroups 1 and 2
constexpr int THREADS = PRODUCERS + CONSUMERS;
constexpr int CONSUMER_WARPS = CONSUMERS / 32;
constexpr int ACC = NT_MAX / 2;                 // fp32 accumulators a consumer thread at N = 128
constexpr int AREGS = 2 * 4 * (KC / 8);         // a stage's A fragments: hi and lo of 4 k8 steps
constexpr int PRODUCER_REGS = 48, CONSUMER_REGS = 224;
// registers a thread at launch (__launch_bounds__ of 384 threads): the pool
// setmaxnreg redistributes
constexpr int LAUNCH_REGS = 168;
constexpr int SMEM_MAX = 232448;                // a block's shared memory
constexpr int SMEM_FIXED = 1024 + 24 * MAX_STAGES;  // alignment and three barriers a stage

static_assert(PRODUCERS * PRODUCER_REGS + CONSUMERS * CONSUMER_REGS <= LAUNCH_REGS * THREADS &&
                  LAUNCH_REGS * THREADS <= 65536,
              "the register split fits the pool the CTA is launched with");
static_assert(X_BYTES % 1024 == 0 && (8 * KC * 4) % 1024 == 0, "swizzled tiles start on 1,024-byte boundaries");

// A stage at N = nt: the X tile, then the other operand's hi and lo planes
__host__ __device__ constexpr int stage_bytes(int nt) { return X_BYTES + 2 * nt * KC * 4; }
// the ring's depth at N = nt beside `extra` bytes of a kernel's own: as
// many stages as fit, at most MAX_STAGES
__host__ __device__ constexpr int ring_stages(int nt, int extra) {
  return (SMEM_MAX - SMEM_FIXED - extra) / stage_bytes(nt) < MAX_STAGES
             ? (SMEM_MAX - SMEM_FIXED - extra) / stage_bytes(nt)
             : MAX_STAGES;
}
// a CTA's dynamic shared memory: alignment, the ring, its barriers, then
// `extra` bytes
__host__ __device__ constexpr int smem_bytes(int nt, int extra) {
  return SMEM_FIXED + ring_stages(nt, extra) * stage_bytes(nt) + extra;
}
static_assert(ring_stages(NT_MAX, 0) == 4 && ring_stages(8, 0) == MAX_STAGES, "the ring is 4 deep at N = 128, 12 at 8");

// The ring of a launch: `stages` stages of `bytes` at `ring`, their "full"
// barriers (the producer thread's expect_tx and the copies' bytes),
// "empty" ones (one arrival a consumer warp) and "ready" ones (one arrival
// a warp that prepares a stage after its copies land, where a kernel has
// such warps), 8 bytes apart.
struct Ring {
  uint32_t ring, full0, empty0, ready0;
  int stages, bytes, nt;
};

// Lays the ring out in the dynamic shared memory at N = nt beside `extra`
// bytes (after the barriers), "ready" barriers counting `ready_warps`
// arrivals; thread 0 sets up the barriers, and the block waits for it.
__device__ __forceinline__ Ring make_ring(uint8_t* smem_raw, int nt, int extra, int ready_warps) {
  Ring g;
  g.nt = nt;
  g.bytes = stage_bytes(nt);
  g.stages = ring_stages(nt, extra);
  g.ring = (smem_addr(smem_raw) + 1023) & ~1023u;
  g.full0 = g.ring + g.stages * g.bytes;
  g.empty0 = g.full0 + g.stages * 8;
  g.ready0 = g.empty0 + g.stages * 8;
  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) {
      mbar_init(g.full0 + 8 * s, 1);
      mbar_init(g.empty0 + 8 * s, CONSUMER_WARPS);
      mbar_init(g.ready0 + 8 * s, ready_warps > 0 ? ready_warps : 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  return g;
}

// A stage's planes by tensor map: rows m0 .. m0 + nt - 1 of the hi plane
// and of the lo plane (rows n_pad further) from column c0, 32 values a row,
// into dst (hi) and dst + nt * 128 (lo), completing on `bar`
__device__ __forceinline__ void load_planes(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int m0,
                                            int n_pad, int nt) {
  tma_load_2d(dst, map, bar, c0, m0);
  tma_load_2d(dst + nt * 128, map, bar, c0, n_pad + m0);
}

// The 4 fp32 values of k8 step kk's A fragment (register e: v[e]) split
// into TF32 hi (a[8 kk + e]) and lo (a[8 kk + 4 + e])
template <int R>
__device__ __forceinline__ void split_fragment(const float (&v)[4], uint32_t (&a)[R], int kk) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float hi = tf32_rna(v[e]);
    a[8 * kk + e] = __float_as_uint(hi);
    a[8 * kk + 4 + e] = __float_as_uint(tf32_rna(v[e] - hi));
  }
}

// KK k8 steps' products on one accumulator chain (the stage's steps kk0 ..
// kk0 + KK - 1, A's fragments in a), per step lo*hi, hi*lo, hi*hi (A's
// part times B's): the planes' hi at b, lo `blo` further. `fresh` starts
// the chain from zero.
template <int N, int KK>
__device__ __forceinline__ void stage_products(float (&d)[ACC], const uint32_t (&a)[8 * KK], uint32_t b,
                                               uint32_t blo, bool fresh, int kk0) {
#pragma unroll
  for (int kk = 0; kk < KK; ++kk) {
    const int h = 8 * kk, l = h + 4;
    const uint32_t bk = b + 32 * (kk0 + kk);
    Tf32Wgmma<N>::run(d, a[l], a[l + 1], a[l + 2], a[l + 3], sw128_desc(bk), !(fresh && kk == 0));
    Tf32Wgmma<N>::run(d, a[h], a[h + 1], a[h + 2], a[h + 3], sw128_desc(bk + blo), 1);
    Tf32Wgmma<N>::run(d, a[h], a[h + 1], a[h + 2], a[h + 3], sw128_desc(bk), 1);
  }
}

// Issues KK k8 steps' products (from step kk0) at the ring's width as one
// wgmma group (the planes' hi at b), without waiting for it.
template <int KK>
__device__ __forceinline__ void run_products(float (&d)[ACC], const uint32_t (&a)[8 * KK], const Ring& g, uint32_t b,
                                             bool fresh, int kk0) {
  const uint32_t blo = g.nt * 128;
  fence_acc(d);
  wgmma_fence();
  switch (g.nt) {
    case 8: stage_products<8, KK>(d, a, b, blo, fresh, kk0); break;
    case 16: stage_products<16, KK>(d, a, b, blo, fresh, kk0); break;
    case 24: stage_products<24, KK>(d, a, b, blo, fresh, kk0); break;
    case 32: stage_products<32, KK>(d, a, b, blo, fresh, kk0); break;
    case 40: stage_products<40, KK>(d, a, b, blo, fresh, kk0); break;
    case 48: stage_products<48, KK>(d, a, b, blo, fresh, kk0); break;
    case 56: stage_products<56, KK>(d, a, b, blo, fresh, kk0); break;
    case 64: stage_products<64, KK>(d, a, b, blo, fresh, kk0); break;
    case 72: stage_products<72, KK>(d, a, b, blo, fresh, kk0); break;
    case 80: stage_products<80, KK>(d, a, b, blo, fresh, kk0); break;
    case 88: stage_products<88, KK>(d, a, b, blo, fresh, kk0); break;
    case 96: stage_products<96, KK>(d, a, b, blo, fresh, kk0); break;
    case 104: stage_products<104, KK>(d, a, b, blo, fresh, kk0); break;
    case 112: stage_products<112, KK>(d, a, b, blo, fresh, kk0); break;
    case 120: stage_products<120, KK>(d, a, b, blo, fresh, kk0); break;
    default: stage_products<128, KK>(d, a, b, blo, fresh, kk0); break;
  }
  wgmma_commit();
}

// The checks both launchers make of the common arguments (fills nothing):
// n rows of X `ld` apart (ld % 4 == 0, 16-byte aligned X), B features
// (b_pad a multiple of KC, at least B), K models in `tiles` tiles of nt (a
// multiple of 8, at most NT_MAX).
inline bool common_ok(const void* x, int n, int ld, int B, int K, int nt, int tiles, int b_pad) {
  return n > 0 && ld >= n && ld % 4 == 0 && B > 0 && K > 0 && nt >= 8 && nt <= NT_MAX && nt % 8 == 0 &&
         tiles > 0 && (long long)tiles * nt >= K && (long long)(tiles - 1) * nt < K && b_pad >= B &&
         b_pad % KC == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 && (long long)B * ld < (1LL << 40) &&
         (long long)n * K < 0x7fffffffLL && (long long)B * K < 0x7fffffffLL;
}

}  // namespace gbblock
