// One whole round of gblinear's single-model block coordinate-descent sweep
// in one cooperative launch: the bias step, then for each feature block in
// order the gradient g = Xb @ r, the coordinate update dw = eta *
// coord_delta(g, h, w) (gblinear_cd.cuh), w += dw and r += dw^T Xb.
//
// X (n_blocks * B feature rows of n values, `ld` floats apart, ld a multiple
// of 4: models/gblinear.py::_pad_blocks' layout, the feature rows
// zero-padded to a multiple of B and each row to ld), hess (n_blocks, B) the
// column hessians, w (n_blocks, B), bias (1,) and r (n,) updated in place;
// scratch holds the cross-CTA sums, each beside a tag that says which round
// and phase wrote it (`tag0` onwards: the wrapper's count, so that a tag
// does not repeat in a scratch). A padded feature row has h = 0, so its dw
// is 0; the padded columns [n, ld) are zeros that meet a zero of r and are
// never written to r.
//
// Replaces the XLA program of one round of the JAX package:
// expecto_tpu/models/gblinear.py::_round_body (:104-132, jitted at :169),
// the bias step and a lax.scan over block_step (:122-129). There is no
// Pallas kernel there. In plain torch the same round is two cuBLAS GEMVs,
// the coordinate-update kernel and an add a block: 160 launches a round at
// the published 40 blocks.
//
// What bounds it on an H100: bytes. X is read once a round at best (1.83 GB
// at 22,296 rows x 40 x 512 features: 0.545 ms at 3.35 TB/s). The two
// products do 4 flops a byte of X, some 70 times below the fp32 ridge and
// far below TF32's, so tensor cores cannot help: a three-pass TF32 product
// at N = 1 moves the same bytes. The products stay fp32 FFMA, and the
// design is about keeping HBM busy and each block's chain short:
//  - a persistent grid of one CTA an SM, launched cooperatively (all CTAs
//    co-resident, or the launch fails); CTA c owns the rows of its 4-row
//    quads [c nq / G, (c + 1) nq / G), nq = ceil(n / 4)
//    (ops/gblinear_round.py::row_plan), so every slice of a feature row
//    starts on 16 bytes;
//  - the CTA walks its slice in tiles of at most TMAX columns; a stage is
//    FS feature rows of one tile, one 2-D tensor copy (TMA) into shared
//    memory. Two kinds of slots: `cache` slots hold the first stages of a
//    block's last tile from (A) to (C); the other stages stream through a
//    ring of `slots - cache`. A producer warp fills each kind (full/empty
//    mbarriers). X does not depend on r, so the ring's producer reads
//    block b + 1 ahead while block b's sums cross the grid;
//  - 16 consumer warps: (A) each warp folds a feature row of each stage
//    with r into its partial gradient (a lane's float4 columns, then a
//    shuffle sum; summed over the tiles in order), two stages at a time so
//    that two chains of loads and shuffles overlap, the cached stages first
//    and the streamed ones last; (B) each feature's G partials summed by
//    one warp in a fixed order and its coordinate update written; (C) r +=
//    dw^T Xb over the CTA's rows, each thread owning a float4 column and
//    one of `groups` strided feature groups, the group sums added in group
//    order: the cached stages from shared memory, then the streamed rows
//    again from global memory with 16-byte loads, the last read first, so
//    that L2 still holds them. The cache slots are refilled only when (C)
//    ends: a refill during (C) slows (C)'s reads more than it saves;
//  - no grid barrier: every cross-CTA value (the partial sums of r and of
//    the gradient, the block's dw) is stored as one 8-byte word with its
//    tag, and one warp polls the words it needs (all of them a round, a
//    short sleep between rounds) until every tag is the one it expects:
//    one trip through L2 where a barrier and a read take two. The partial
//    gradients lie feature-major, so a feature's G partials are contiguous.
//    A reader that waits too long traps instead of hanging the card;
//  - two plans, picked by `plan` from n, B and the card: "shared" keeps the
//    CTA's whole slice of r in shared memory for the round (up to
//    R_SHARED floats a CTA), "streamed" keeps r in global memory and
//    stages one tile of it at a time, so any n below 2^31 launches. Past
//    R_SHARED the streamed plan is the faster: r's slice would leave the
//    ring 3-8 slots where the streamed plan has 7 and 6 cache slots
//    (scripts/probe_gblinear_round.py's r_shared_smem variant).
//
// fp32 throughout, in a fixed order: a rerun is bit-equal. The sums run in
// another order than cuBLAS's or the CPU's, so the round agrees with the
// plain version (ops/gblinear_round.py::gblinear_round_plain) within
// stated tolerances, not bit for bit; the coordinate step itself is
// gblinear_cd.cuh's, which rounds as the plain version does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gblinear_cd.cuh"
#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int CONSUMER_WARPS = 16;
constexpr int CONSUMERS = 32 * CONSUMER_WARPS;  // consumer threads
constexpr int THREADS = CONSUMERS + 64;         // and two producer warps
constexpr int FS_MAX = 16;                      // feature rows a stage: one a consumer warp
constexpr int TMAX = 256;                       // columns a tile, at most
constexpr int GROUPS_MAX = 8;                   // feature groups of (C)
constexpr int R_SHARED = 8192;                  // floats of r a CTA keeps in shared memory
constexpr int RING_BYTES = 40960;               // the ring's share of the slots, at least ("shared" plan)
constexpr int RING_BYTES_TILES = 81920;         // and past 2 tiles a CTA, where the cache serves a third of a block
constexpr int RING_BYTES_STREAMED = 114688;     // and in the "streamed" plan, where the cache serves one tile of many
constexpr int SLOTS_MAX = 64;
constexpr int C_BATCH = 16;                     // feature rows of global memory a (C) thread has in flight
constexpr unsigned FULL = 0xffffffffu;
static_assert(FS_MAX <= CONSUMER_WARPS, "(A) folds one feature row of a stage a warp");

struct Params {
  const float* X;
  const float* hess;
  float* w;
  float* bias;
  float* r;
  unsigned long long* scratch;
  long long ld;  // floats between two feature rows of X
  int n_blocks, B, n, G;
  int T;       // tile width (floats, a multiple of 4)
  int FS;      // feature rows a stage
  int NG;      // stages a tile (ceil(B / FS))
  int slots;   // stage slots: `cache` cache slots, then the ring
  int cache;   // cache slots (the cached stages: the first min(cache, NG) of a block's last tile)
  int groups;  // feature groups of (C)
  int r_floats;
  unsigned tag0;  // the first tag of this launch
  float denom, eta, lam, alpha;
};

// The CTA's dynamic shared memory, in this order (each region a multiple
// of 16 bytes): the slots, r (its slice or one tile), dw, the per-feature
// partial gradients, (C)'s group sums, the warp sums, the mbarriers.
struct Layout {
  int slots, r, dw, acc, red, wsum, bars, bytes;
};

__host__ __device__ __forceinline__ int align16(int bytes) { return (bytes + 15) / 16 * 16; }

// bytes between two slots: a stage (FS rows of T floats), on 128 bytes as a
// tensor copy's destination needs
__host__ __device__ __forceinline__ int slot_bytes(int T, int FS) { return (FS * T * 4 + 127) / 128 * 128; }

__host__ __device__ __forceinline__ Layout layout(int T, int FS, int slots, int B, int groups, int r_floats) {
  Layout s;
  s.slots = 0;
  s.r = s.slots + slots * slot_bytes(T, FS);
  s.dw = s.r + align16(4 * r_floats);
  s.acc = s.dw + align16(4 * B);
  s.red = s.acc + align16(4 * B);
  s.wsum = s.red + groups * T * 4;
  s.bars = s.wsum + align16(4 * (CONSUMER_WARPS + 1));
  s.bytes = s.bars + 16 * slots;
  return s;
}

// CTA c's first row: 4 (c nq / G), nq = ceil(n / 4)
__host__ __device__ __forceinline__ int row_lo(int cta, int ctas, int n) {
  const long long nq = (static_cast<long long>(n) + 3) / 4;
  const long long lo = 4 * (static_cast<long long>(cta) * nq / ctas);
  return static_cast<int>(lo < n ? lo : n);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS) : "memory"); }

// A cross-CTA value: its bits and its tag in one 8-byte word, stored and
// loaded whole, so that a reader never sees a value beside another's tag
__device__ __forceinline__ void put(unsigned long long* p, float v, unsigned tag) {
  const unsigned long long word = (static_cast<unsigned long long>(tag) << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(word) : "memory");
}

__device__ __forceinline__ unsigned long long peek(const unsigned long long* p) {
  unsigned long long word;
  asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(word) : "l"(p));
  return word;
}

// One warp polls: a round loads every word once (lane l the words l, l +
// 32, ...), and the warp sleeps a little between rounds, so that a few
// pollers a CTA do not crowd L2 while the writers' stores go through. A
// reader that waits 2^24 rounds traps instead of hanging the card.
__device__ __forceinline__ void backoff(unsigned round) {
  if (round == (1u << 24)) __trap();
  __nanosleep(64);
}

// The warp's sum of p[0 .. count) once every tag is `tag`: lane l adds q =
// l, l + 32, ... in order, then the shuffle sum, all from one round (the
// same order whoever wrote last). A round's loads are issued together, up
// to POLL_WORDS a lane at a time.
constexpr int POLL_WORDS = 8;

__device__ __forceinline__ float take_sum(const unsigned long long* p, int count, unsigned tag, int lane) {
  for (unsigned round = 0;; backoff(++round)) {
    float s = 0.0f;
    bool ready = true;
    for (int base = 0; base < count; base += 32 * POLL_WORDS) {
      unsigned long long word[POLL_WORDS];
#pragma unroll
      for (int k = 0; k < POLL_WORDS; ++k) {
        const int q = base + lane + 32 * k;
        word[k] = q < count ? peek(p + q) : static_cast<unsigned long long>(tag) << 32;
      }
#pragma unroll
      for (int k = 0; k < POLL_WORDS; ++k) {
        ready &= static_cast<unsigned>(word[k] >> 32) == tag;
        if (base + lane + 32 * k < count) s += __uint_as_float(static_cast<unsigned>(word[k]));
      }
    }
    if (__all_sync(FULL, ready)) return warp_sum(s);
  }
}

// out[q] = the value of p[q], q < count, once every tag is `tag` (one warp)
__device__ __forceinline__ void take_all(const unsigned long long* p, int count, unsigned tag, float* out,
                                         int lane) {
  for (unsigned round = 0;; backoff(++round)) {
    bool ready = true;
    for (int base = 0; base < count; base += 32 * POLL_WORDS) {
      unsigned long long word[POLL_WORDS];
#pragma unroll
      for (int k = 0; k < POLL_WORDS; ++k) {
        const int q = base + lane + 32 * k;
        word[k] = q < count ? peek(p + q) : static_cast<unsigned long long>(tag) << 32;
      }
#pragma unroll
      for (int k = 0; k < POLL_WORDS; ++k) {
        const int q = base + lane + 32 * k;
        ready &= static_cast<unsigned>(word[k] >> 32) == tag;
        if (q < count) out[q] = __uint_as_float(static_cast<unsigned>(word[k]));
      }
    }
    if (__all_sync(FULL, ready)) return;
  }
}

// The warp waits for a phase of `bar`: lane 0 polls and the warp meets it
__device__ __forceinline__ void warp_wait(uint32_t bar, uint32_t parity, int lane) {
  if (lane == 0) mbar_wait(bar, parity);
  __syncwarp();
}

__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t pol;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(pol));
  return pol;
}

// tma_load_2d with an L2 eviction policy
__device__ __forceinline__ void tma_load_2d_hint(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1,
                                                 uint64_t pol) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.L2::cache_hint"
      " [%0], [%1, {%2, %3}], [%4], %5;"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar), "l"(pol)
      : "memory");
}

__device__ __forceinline__ float4 ldcg4(const float* p) { return __ldcg(reinterpret_cast<const float4*>(p)); }

__device__ __forceinline__ float dot4(float4 x, float4 v, float acc) {
  acc = fmaf(x.x, v.x, acc);
  acc = fmaf(x.y, v.y, acc);
  acc = fmaf(x.z, v.z, acc);
  return fmaf(x.w, v.w, acc);
}

__device__ __forceinline__ void axpy4(float d, float4 x, float4& acc) {
  acc.x = fmaf(d, x.x, acc.x);
  acc.y = fmaf(d, x.y, acc.y);
  acc.z = fmaf(d, x.z, acc.z);
  acc.w = fmaf(d, x.w, acc.w);
}

template <bool STREAM>
__global__ void __launch_bounds__(THREADS, 1)
    gblinear_round_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ Params p) {
  const int G = p.G, cta = blockIdx.x, B = p.B, T = p.T, Q = T / 4;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lo = row_lo(cta, G, p.n), len = row_lo(cta + 1, G, p.n) - lo;
  const int tiles = (len + T - 1) / T;
  const int cache = p.cache < p.NG ? p.cache : p.NG;
  const Layout L = layout(T, p.FS, p.slots, B, p.groups, p.r_floats);

  extern __shared__ __align__(1024) unsigned char smem[];
  float* stage0 = reinterpret_cast<float*>(smem + L.slots);
  float* r_s = reinterpret_cast<float*>(smem + L.r);
  float* dw_s = reinterpret_cast<float*>(smem + L.dw);
  float* acc_s = reinterpret_cast<float*>(smem + L.acc);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* wsum = reinterpret_cast<float*>(smem + L.wsum);
  const uint32_t full0 = smem_addr(smem + L.bars), empty0 = full0 + 8 * p.slots;
  const int slot_floats = slot_bytes(T, p.FS) / 4;

  // tags: the bias step's sums tag0; block b's partial gradients tag0 + 1 + 2b, its updates tag0 + 2 + 2b
  unsigned long long* part = p.scratch;                  // [B][G] partial gradients, feature-major
  unsigned long long* bias_part = part + (size_t)G * B;  // [G] partial sums of r
  unsigned long long* dw_g = bias_part + G;              // [B] the block's updates

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.slots; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();  // the last CTA-wide barrier: the producer warps leave here

  if (warp >= CONSUMER_WARPS) {
    // the producers, one tensor copy a stage (a box of FS feature rows x T
    // columns; columns past the CTA's slice are read and never used, rows
    // past X arrive as zeros): the first warp's lane 0 the ring's stages in
    // the consumers' order, the second's the cached stages, cache slot s
    // block after block (a warp each, so that neither waits behind the other)
    const uint32_t bytes = 4u * p.FS * T;
    if (lane != 0) return;
    if (warp == CONSUMER_WARPS) {
      int slot = p.cache, use = 0;  // the ring's next slot and its use
      for (int b = 0; b < p.n_blocks; ++b)
        for (int t = 0; t < tiles; ++t)
          for (int s = t == tiles - 1 ? cache : 0; s < p.NG; ++s) {
            if (use > 0) mbar_wait(empty0 + 8 * slot, (use - 1) & 1);
            mbar_expect_tx(full0 + 8 * slot, bytes);
            tma_load_2d(smem_addr(stage0 + slot * slot_floats), &xmap, full0 + 8 * slot, lo + t * T,
                        b * B + s * p.FS);
            if (++slot == p.slots) slot = p.cache, ++use;
          }
    } else if (tiles > 0) {
      const uint64_t pol = evict_first_policy();  // held in shared memory for (C): L2 need not keep it
      for (int b = 0; b < p.n_blocks; ++b)
        for (int s = 0; s < cache; ++s) {
          if (b > 0) mbar_wait(empty0 + 8 * s, (b - 1) & 1);
          mbar_expect_tx(full0 + 8 * s, bytes);
          tma_load_2d_hint(smem_addr(stage0 + s * slot_floats), &xmap, full0 + 8 * s, lo + (tiles - 1) * T,
                           b * B + s * p.FS, pol);
        }
    }
    return;
  }

  const int tc = threadIdx.x;  // consumer thread 0 .. CONSUMERS - 1

  // bias step: db = eta * (-sum(r) / denom), bias += db, r += db
  {
    float v = 0.0f;
    if (STREAM) {
      for (int c = tc; c < len; c += CONSUMERS) v += p.r[lo + c];
    } else {
      for (int c = tc; c < p.r_floats; c += CONSUMERS) {
        const float x = c < len ? p.r[lo + c] : 0.0f;  // columns past the slice stay zero
        r_s[c] = x;
        v += x;
      }
    }
    v = warp_sum(v);
    if (lane == 0) wsum[warp] = v;
    consumer_sync();
    if (warp == 0) {
      const float s = warp_sum(lane < CONSUMER_WARPS ? wsum[lane] : 0.0f);
      if (lane == 0) put(bias_part + cta, s, p.tag0);
      const float total = take_sum(bias_part, G, p.tag0, lane);
      if (lane == 0) {
        const float db = __fmul_rn(p.eta, __fdiv_rn(-total, p.denom));
        wsum[CONSUMER_WARPS] = db;
        if (cta == 0) p.bias[0] = __fadd_rn(p.bias[0], db);
      }
    }
    consumer_sync();
    const float db = wsum[CONSUMER_WARPS];
    for (int c = tc; c < len; c += CONSUMERS) {
      if (STREAM)
        p.r[lo + c] = __fadd_rn(p.r[lo + c], db);
      else
        r_s[c] = __fadd_rn(r_s[c], db);
    }
    consumer_sync();
  }

  // (C)'s thread: float4 column q of a tile, feature group g
  const int q_c = tc % Q, g_c = tc / Q;
  const bool c_thread = g_c < p.groups;
  const float4* stage4 = reinterpret_cast<const float4*>(stage0);
  int ring_slot = p.cache, ring_use = 0;  // the ring's next stage, as its producer counts them
  for (int b = 0; b < p.n_blocks; ++b) {
    const float* Xb = p.X + (size_t)b * B * p.ld + lo;
    const unsigned tag_part = p.tag0 + 1 + 2 * b, tag_dw = tag_part + 1;

    // (A) partial gradients over this CTA's rows, a feature row a warp a
    // stage: the last tile's cached stages first, its streamed ones last
    for (int t = 0; t < tiles; ++t) {
      const int cols = len - t * T < T ? len - t * T : T, q_n = (cols + 3) / 4;
      if (STREAM) {
        for (int c = tc; c < 4 * q_n; c += CONSUMERS) r_s[c] = c < cols ? p.r[lo + t * T + c] : 0.0f;
        consumer_sync();
      }
      const float4* r4 = reinterpret_cast<const float4*>(STREAM ? r_s : r_s + t * T);
      for (int s = 0; s < p.NG; s += 2) {  // two stages at a time: two chains in flight a warp
        const int n_st = s + 1 < p.NG ? 2 : 1;
        int slot[2];
        bool ring_stage[2];
        float acc[2] = {0.0f, 0.0f};
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (u == n_st) break;
          ring_stage[u] = !(t == tiles - 1 && s + u < cache);
          slot[u] = ring_stage[u] ? ring_slot : s + u;
          warp_wait(full0 + 8 * slot[u], (ring_stage[u] ? ring_use : b) & 1, lane);
          if (ring_stage[u] && ++ring_slot == p.slots) ring_slot = p.cache, ++ring_use;
          if (warp < B - (s + u) * p.FS) {  // feature row `warp` of the stage; at most 64 float4 columns
            const float4* x4 = stage4 + (size_t)slot[u] * (slot_floats / 4) + warp * Q;
            if (lane < q_n) acc[u] = dot4(x4[lane], r4[lane], acc[u]);
            if (lane + 32 < q_n) acc[u] = dot4(x4[lane + 32], r4[lane + 32], acc[u]);
          }
        }
        for (int off = 16; off; off >>= 1) {  // the two shuffle sums, interleaved
          acc[0] += __shfl_xor_sync(FULL, acc[0], off);
          acc[1] += __shfl_xor_sync(FULL, acc[1], off);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          if (u == n_st) break;
          const int j = (s + u) * p.FS + warp;
          if (lane == 0 && warp < B - (s + u) * p.FS) acc_s[j] = t == 0 ? acc[u] : acc_s[j] + acc[u];
          if (ring_stage[u]) {
            __syncwarp();
            if (lane == 0) mbar_arrive(empty0 + 8 * slot[u]);
          }
        }
      }
      if (STREAM) consumer_sync();  // r_s is refilled for the next tile
    }
    // the CTA's partials out in one pass (a store before an mbarrier arrival
    // would hold the arrival until the store is done)
    consumer_sync();
    for (int j = tc; j < B; j += CONSUMERS) put(part + (size_t)j * G + cta, tiles ? acc_s[j] : 0.0f, tag_part);

    // (B) each feature's gradient, summed over the CTAs in order, and its update
    for (int j = warp * G + cta; j < B; j += CONSUMER_WARPS * G) {
      const size_t k = (size_t)b * B + j;
      const float wv = p.w[k], hv = p.hess[k];
      const float s = take_sum(part + (size_t)j * G, G, tag_part, lane);
      if (lane == 0) {
        const float d = gblinear::coord_step(s, hv, wv, p.eta, p.lam, p.alpha);
        p.w[k] = __fadd_rn(wv, d);
        put(dw_g + j, d, tag_dw);
      }
    }

    // (C) r += dw^T Xb over this CTA's rows, the tiles last read first: the
    // last tile's cached stages from shared memory, then the rest of each
    // tile from global memory, the features read last in (A) first; each
    // thread's sum over its feature group, the groups added in order. The
    // cache slots are freed for the next block when (C) ends: their refill
    // would compete with (C)'s own reads.
    const size_t step = (size_t)p.groups * p.ld;
    const int j_top = B - 1 - ((B - 1 - g_c) % p.groups + p.groups) % p.groups;  // the last of group g_c
    const int j_cached = cache * p.FS < B ? cache * p.FS : B;  // the last tile's rows [0, j_cached) are cached
    if (warp == 0) take_all(dw_g, B, tag_dw, dw_s, lane);
    consumer_sync();
    for (int t = tiles - 1; t >= 0; --t) {
      const int cols = len - t * T < T ? len - t * T : T, q_n = (cols + 3) / 4;
      const bool active = c_thread && q_c < q_n;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      int j_lo = 0, j = j_top;  // features [j_lo, B) come from global memory, from j down
      if (t == tiles - 1) {
        if (active) {  // the cached rows lie one after another (the plan caches only whole slots): j's at j Q
          const float4* x4 = stage4 + q_c;
#pragma unroll 8
          for (int jc = g_c; jc < j_cached; jc += p.groups) axpy4(dw_s[jc], x4[jc * Q], acc);
        }
        j_lo = j_cached;
      }
      if (active && j >= j_lo) {
        const float* xj = Xb + t * T + 4 * q_c + (size_t)j * p.ld;
        for (; j - (C_BATCH - 1) * p.groups >= j_lo; j -= C_BATCH * p.groups) {  // C_BATCH loads, then the sums
          float4 x[C_BATCH];
#pragma unroll
          for (int u = 0; u < C_BATCH; ++u, xj -= step) x[u] = ldcg4(xj);
#pragma unroll
          for (int u = 0; u < C_BATCH; ++u) axpy4(dw_s[j - u * p.groups], x[u], acc);
        }
        for (; j >= j_lo; j -= p.groups, xj -= step) axpy4(dw_s[j], ldcg4(xj), acc);
      }
      if (c_thread) reinterpret_cast<float4*>(red)[g_c * Q + q_c] = acc;
      consumer_sync();
      for (int c = tc; c < cols; c += CONSUMERS) {
        float s = red[c];
        for (int g = 1; g < p.groups; ++g) s += red[g * T + c];
        if (STREAM)
          p.r[lo + t * T + c] = __fadd_rn(p.r[lo + t * T + c], s);
        else
          r_s[t * T + c] = __fadd_rn(r_s[t * T + c], s);
      }
      consumer_sync();
    }
    if (lane == 0 && tiles > 0)
      for (int s = 0; s < cache; ++s) mbar_arrive(empty0 + 8 * s);
  }

  if (!STREAM)
    for (int c = tc; c < len; c += CONSUMERS) p.r[lo + c] = r_s[c];
}

// The grid and shared-memory plan for n rows and blocks of B features on the
// current device; a CUDA error if the device cannot launch it
// cooperatively.
struct Plan {
  int ctas, rows_max, T, tiles_max, FS, NG, slots, cache, groups, streamed, smem, optin, r_floats;
};

cudaError_t plan(int n, int B, Plan* pl) {
  int dev, sms, coop, optin;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  const long long nq = (static_cast<long long>(n) + 3) / 4, qmax = (nq + sms - 1) / sms;
  pl->optin = optin;
  pl->rows_max = static_cast<int>(4 * qmax);
  pl->tiles_max = static_cast<int>((pl->rows_max + TMAX - 1) / TMAX);
  pl->T = static_cast<int>(4 * ((qmax + pl->tiles_max - 1) / pl->tiles_max));
  pl->FS = B < FS_MAX ? B : FS_MAX;
  pl->NG = (B + pl->FS - 1) / pl->FS;
  const int per = CONSUMERS / (pl->T / 4);
  pl->groups = per < GROUPS_MAX ? per : GROUPS_MAX;
  pl->streamed = static_cast<long long>(pl->tiles_max) * pl->T > R_SHARED;
  pl->r_floats = pl->streamed ? pl->T : pl->tiles_max * pl->T;
  const Layout none = layout(pl->T, pl->FS, 0, B, pl->groups, pl->r_floats);
  const long long per_slot = slot_bytes(pl->T, pl->FS) + 16LL;  // and its two mbarriers
  const long long slots = (optin - static_cast<long long>(none.bytes)) / per_slot;
  if (slots < 2) return cudaErrorInvalidValue;
  pl->slots = static_cast<int>(slots < SLOTS_MAX ? slots : SLOTS_MAX);
  const long long ring_bytes = pl->streamed ? RING_BYTES_STREAMED : pl->tiles_max > 2 ? RING_BYTES_TILES : RING_BYTES;
  long long ring = (ring_bytes + per_slot - 1) / per_slot;
  if (ring < 2) ring = 2;
  pl->cache = pl->slots - ring > 0 ? static_cast<int>(pl->slots - ring) : 0;
  if (pl->cache > pl->NG) pl->cache = pl->NG;
  if (4 * pl->FS * pl->T % 128) pl->cache = 0;  // (C) reads the cache as one run of rows: stages that fill their slots
  pl->smem = layout(pl->T, pl->FS, pl->slots, B, pl->groups, pl->r_floats).bytes;
  const void* fn = pl->streamed ? reinterpret_cast<const void*>(gblinear_round_kernel<true>)
                                : reinterpret_cast<const void*>(gblinear_round_kernel<false>);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, pl->smem);
  if (err != cudaSuccess) return err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, THREADS, pl->smem);
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorCooperativeLaunchTooLarge;
  pl->ctas = sms;
  return cudaSuccess;
}

}  // namespace

// The whole plan for n rows and blocks of B features on the current device
// into out[0 .. 12]: ctas, rows_max, T, tiles_max, FS, NG, slots, cache,
// groups, streamed, smem, optin, r_floats. Returns the CUDA error.
extern "C" int gblinear_round_geometry(int n, int B, int* out) {
  if (n <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  Plan pl;
  const cudaError_t err = plan(n, B, &pl);
  if (err != cudaSuccess) return (int)err;
  const int v[] = {pl.ctas, pl.rows_max, pl.T,      pl.tiles_max, pl.FS,    pl.NG,      pl.slots,
                   pl.cache, pl.groups,  pl.streamed, pl.smem,     pl.optin, pl.r_floats};
  for (int i = 0; i < 13; ++i) out[i] = v[i];
  return 0;
}

// X (n_blocks * B rows of n values, `ld` floats apart: ld >= n, a multiple
// of 4, X 16-byte aligned), hess (n_blocks, B), w (n_blocks, B), bias (1,),
// r (n,) fp32 (w, bias and r updated in place); scratch at least 2 (ctas *
// (B + 1) + B) floats on 8 bytes, zeroed when it was allocated, ctas as
// gblinear_round_geometry says; tag0 above every tag the scratch's earlier
// launches used (they use tag0 ... tag0 + 2 n_blocks). Launches one round on `stream`,
// allocates nothing, and returns the CUDA error of the launch (0 on
// success).
extern "C" int gblinear_round_launch(const void* X, const void* hess, void* w, void* bias, void* r, void* scratch,
                                     int n_blocks, int B, int n, int ld, int ctas, int tag0, float denom,
                                     float eta, float lam, float alpha, void* stream) {
  if (n <= 0 || B <= 0 || n_blocks <= 0 || ld < n || ld % 4 != 0 || reinterpret_cast<uintptr_t>(X) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 8 != 0 || tag0 <= 0)
    return (int)cudaErrorInvalidValue;
  Plan pl;
  cudaError_t err = plan(n, B, &pl);
  if (err != cudaSuccess) return (int)err;
  if (ctas != pl.ctas) return (int)cudaErrorInvalidConfiguration;
  Params p;
  p.X = static_cast<const float*>(X);
  p.hess = static_cast<const float*>(hess);
  p.w = static_cast<float*>(w);
  p.bias = static_cast<float*>(bias);
  p.r = static_cast<float*>(r);
  p.scratch = static_cast<unsigned long long*>(scratch);
  p.ld = ld;
  p.n_blocks = n_blocks;
  p.B = B;
  p.n = n;
  p.G = ctas;
  p.T = pl.T;
  p.FS = pl.FS;
  p.NG = pl.NG;
  p.slots = pl.slots;
  p.cache = pl.cache;
  p.groups = pl.groups;
  p.r_floats = pl.r_floats;
  p.tag0 = static_cast<unsigned>(tag0);
  p.denom = denom;
  p.eta = eta;
  p.lam = lam;
  p.alpha = alpha;
  // X as a 2-D tensor of n_blocks * B rows of ld floats, in boxes of FS rows x T columns
  CUtensorMap xmap;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)ld, (cuuint64_t)n_blocks * B};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)pl.T, (cuuint32_t)pl.FS};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult cr = encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(X), dims, strides, box,
                             elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (cr != CUDA_SUCCESS) return 10000 + (int)cr;
  void* args[] = {&xmap, &p};
  const void* fn = pl.streamed ? reinterpret_cast<const void*>(gblinear_round_kernel<true>)
                               : reinterpret_cast<const void*>(gblinear_round_kernel<false>);
  err = cudaLaunchCooperativeKernel(fn, dim3(ctas), dim3(THREADS), args, pl.smem, static_cast<cudaStream_t>(stream));
  return (int)err;
}
