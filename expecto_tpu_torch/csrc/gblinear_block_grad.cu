// The K-model trainer's block step, first kernel: the block's gradient
// product with the coordinate update folded in.
//
//   G = Xb (rw o r)^T                (B, K): the B features' gradient sums of K models over n rows
//   dw = eta * coord_delta(G, h, w)  w += dw
//
// Xb (B, n) fp32, rows `ld` apart (ld % 4 == 0, the trainer's layout,
// ops/gblinear_block.py::block_layout); r and rw (K, n) fp32, each model's
// rows `ld` apart (transposed_rows: the transpose of the JAX package's (n,
// K)); h, w (B, K) fp32. Writes w in place and dw as the second kernel's
// operand: TF32 hi and lo planes (2, n_pad, b_pad), K-major (each model's
// features contiguous). On the split route (a process group of more than
// one rank) it writes G (B, K) instead; the group sums it, and
// csrc/gblinear_cd.cu's planes entry applies the same coordinate step, so
// one rank gives the fused route's bits.
//
// Replaces, with csrc/gblinear_block_resid.cu, the block step of
// expecto_tpu/models/gblinear.py::_multi_round_body (:246-251): XLA's
// jnp.dot(Xb, row_w * r) and _coord_delta (:92-101) with the eta scale and
// the weight update, which the port ran as torch's elementwise multiply,
// SGEMM and csrc/gblinear_cd.cu. No pallas_call.
//
// What bounds it on an H100: three TF32 passes of 2 B n K flops at 495
// TFLOP/s against X (B n fp32) and rw and r (n K each) read once (h, w and
// dw beside them): at B = 512, n = 21,202, K = 218 (218 tissues) 28.7 us
// of tensor work against 24.5 us of bytes. Here:
//
// - X as wgmma's A side from registers (csrc/gblinear_block.cuh): a CTA
//   takes 128 features (two consumer warpgroups x 64) of one tile of nt <=
//   128 models over one segment of the rows. One producer thread copies
//   each stage by tensor map (TMA): X's 128 features x 32 rows, r's and
//   rw's nt models x 32 rows, 128-byte swizzled as the swapped fc1 kernel's
//   W, rows past n and models past K arriving as zeros; each consumer
//   thread loads its X values and splits them, two k8 steps at a time, and
//   issues their 6 products as one wgmma group (a stage is two groups on
//   one chain: 16 A registers). The ring holds 4 stages at nt = 128, 12 at
//   nt = 8.
// - The other operand made in shared memory: the producer warpgroup's
//   other three warps wait for a stage's copies, then turn r's tile into
//   the TF32 hi of rw o r and rw's into its lo in place (the two tiles
//   share their swizzled layout, so element for element at one offset, 16
//   bytes a thread at a time), and release the stage to the consumers
//   ("ready" barriers). rw o r costs no pass of its own and r and rw are
//   read as they are: 8 bytes an element, as the planes would be.
// - Each stage's chain promoted into an fp32 sum in registers (FADD, round
//   to nearest: the tensor cores' own sum truncates), so 64
//   accumulators and 64 sums a thread at nt = 128, with no spill.
// - The rows split into `segments` to fill the 132 SMs (feature tiles x
//   model tiles x segments units, a CTA each, or more where the units
//   outnumber the SMs); each unit writes its part (S, B, n_pad). Then the
//   consumers of every CTA meet at a grid barrier (a cooperative launch,
//   so every CTA is resident) and share the (B, K) elements: each sums its
//   S parts in segment order, so a shape gives the same bits every call, and
//   applies csrc/gblinear_cd.cuh's coord_step, unchanged: w and dw equal
//   ops/gblinear_cd.py::coord_update_plain applied to this G, bit for bit.
// - No second launch: the block step is this kernel and the residual's.
//
// Shared memory: 1 KB of alignment, `stages` x (16 KB of X, 2 x nt x 128
// bytes of r's and rw's tiles, then rw o r's planes), the barriers.

#include "gblinear_block.cuh"
#include "gblinear_cd.cuh"

namespace {

using namespace gbblock;

// The kernel's arguments beside its two tensor maps (X's rows, V's planes)
struct GradParams {
  const float* h;  // (B, K)
  float* w;        // (B, K), updated in place (fused)
  float* dw;       // dw's planes (2, n_pad, b_pad) (fused)
  float* g;        // G (B, K) (split route)
  float* parts;    // the units' parts (segments, ft * TILE_ROWS, n_pad)
  unsigned* sync;  // the grid barrier's count and generation
  int B, K, nt, tiles, n_pad, b_pad, ft, segments, n_st, units, fused;
  float eta, lam, alpha;
};

// unit u = (segment s, model tile mt, feature tile ft), feature tiles
// fastest: the CTAs of one segment and model tile share V's planes
__device__ __forceinline__ void unit_of(const GradParams& p, int u, int& ft, int& mt, int& s) {
  ft = u % p.ft;
  const int rest = u / p.ft;
  mt = rest % p.tiles;
  s = rest / p.tiles;
}

// the first 32-row stage of segment s (the launcher keeps segments x
// stages below 2^31, so 32-bit arithmetic: no 64-bit division routine)
__device__ __forceinline__ int first_stage(const GradParams& p, int s) { return s * p.n_st / p.segments; }

__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 256;" ::: "memory"); }

// Every CTA's consumers meet here: a count and a generation in global
// memory; the last CTA to arrive zeroes the count and advances the
// generation. A lost arrival traps instead of hanging the card.
__device__ __forceinline__ void grid_barrier(unsigned* sync, unsigned ctas) {
  consumer_sync();
  if (threadIdx.x == PRODUCERS) {
    volatile unsigned* gen = sync + 1;
    const unsigned g0 = *gen;
    __threadfence();
    if (atomicAdd(sync, 1u) == ctas - 1) {
      atomicExch(sync, 0u);
      __threadfence();
      atomicAdd(sync + 1, 1u);
    } else {
      for (unsigned polls = 0; *gen == g0; ++polls) {
        __nanosleep(128);
        if (polls == (1u << 24)) __trap();
      }
    }
    __threadfence();
  }
  consumer_sync();
}

// The producer warps that prepare a stage: warps 1-3 of the producer
// warpgroup (warp 0's thread 0 issues the copies)
constexpr int PREP_WARPS = PRODUCERS / 32 - 1;

__global__ void __launch_bounds__(THREADS, 1)
    gblinear_block_grad_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap rmap,
                               const __grid_constant__ CUtensorMap rwmap, const GradParams p) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const Ring g = make_ring(smem_raw, p.nt, 0, PREP_WARPS);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (warp < PRODUCERS / 32) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (warp == 0 && lane != 0) return;
    const int t = threadIdx.x - 32, chunks = p.nt * 8;  // a tile's 16-byte pieces
    int it = 0;
    for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
      int ft, mt, s;
      unit_of(p, u, ft, mt, s);
      const int f0 = ft * TILE_ROWS, m0 = mt * p.nt, st1 = first_stage(p, s + 1);
      for (int st = first_stage(p, s); st < st1; ++st, ++it) {
        const int slot = it % g.stages;
        const uint32_t sa = g.ring + slot * g.bytes, full = g.full0 + 8 * slot, hi = sa + X_BYTES,
                       lo = hi + p.nt * 128;
        if (warp == 0) {  // thread 0: the copies
          if (it >= g.stages) mbar_wait(g.empty0 + 8 * slot, ((it / g.stages) - 1) & 1);
          mbar_expect_tx(full, g.bytes);
          tma_load_2d(sa, &xmap, full, st * KC, f0);
          tma_load_2d(hi, &rmap, full, st * KC, m0);
          tma_load_2d(lo, &rwmap, full, st * KC, m0);
          continue;
        }
        // warps 1-3: r's tile (at hi) and rw's (at lo) -> hi and lo of rw o r
        mbar_wait(full, (it / g.stages) & 1);
        for (int c = t; c < chunks; c += 32 * PREP_WARPS) {
          float4 r4, w4;
          asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                       : "=f"(r4.x), "=f"(r4.y), "=f"(r4.z), "=f"(r4.w) : "r"(hi + 16 * c) : "memory");
          asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                       : "=f"(w4.x), "=f"(w4.y), "=f"(w4.z), "=f"(w4.w) : "r"(lo + 16 * c) : "memory");
          const float v[4] = {__fmul_rn(w4.x, r4.x), __fmul_rn(w4.y, r4.y), __fmul_rn(w4.z, r4.z),
                              __fmul_rn(w4.w, r4.w)};
          float h[4], l[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            h[e] = tf32_rna(v[e]);
            l[e] = tf32_rna(v[e] - h[e]);
          }
          asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(hi + 16 * c), "f"(h[0]), "f"(h[1]), "f"(h[2]),
                       "f"(h[3]) : "memory");
          asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(lo + 16 * c), "f"(l[0]), "f"(l[1]), "f"(l[2]),
                       "f"(l[3]) : "memory");
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // these writes, to wgmma
        __syncwarp();
        if (lane == 0) mbar_arrive(g.ready0 + 8 * slot);
      }
    }
    return;
  }

  // consumer warpgroups: cw owns features 64 cw .. + 63 of the tile, its
  // warp w rows 16 w .. + 15 of them. A stage in two wgmma groups of two k8
  // steps each, one set of A registers between them: the accumulators, the
  // sums and 16 A registers fit the consumer's registers.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int cw = warp / 4 - 1, row = cw * 64 + (warp % 4) * 16 + lane / 4, t4 = lane % 4;
  float acc[ACC], sum[ACC];
  uint32_t a[AREGS / 2];
#pragma unroll
  for (int e = 0; e < ACC; ++e) acc[e] = 0.f;
  int it = 0;
  for (int u = blockIdx.x; u < p.units; u += gridDim.x) {
    int ft, mt, s;
    unit_of(p, u, ft, mt, s);
    const int st1 = first_stage(p, s + 1);
#pragma unroll
    for (int e = 0; e < ACC; ++e) sum[e] = 0.f;
    for (int st = first_stage(p, s); st < st1; ++st, ++it) {
      const int slot = it % g.stages;
      mbar_wait(g.full0 + 8 * slot, (it / g.stages) & 1);  // X landed
      mbar_wait(g.ready0 + 8 * slot, (it / g.stages) & 1);  // the operand made
      const uint32_t sa = g.ring + slot * g.bytes, w0 = sa + row * 128 + 4 * t4, w1 = w0 + 8 * 128, sw = row & 7;
#pragma unroll
      for (int k0 = 0; k0 < KC / 8; k0 += 2) {
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const uint32_t p0 = ((2 * (k0 + kk)) ^ sw) << 4, p1 = ((2 * (k0 + kk) + 1) ^ sw) << 4;
          float v[4];
          asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v[0]) : "r"(w0 + p0) : "memory");
          asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v[1]) : "r"(w1 + p0) : "memory");
          asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v[2]) : "r"(w0 + p1) : "memory");
          asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v[3]) : "r"(w1 + p1) : "memory");
          split_fragment(v, a, kk);
        }
        run_products<2>(acc, a, g, sa + X_BYTES, k0 == 0, k0);
        wgmma_wait<0>();
        fence_acc(acc);
      }
      if (lane == 0) mbar_arrive(g.empty0 + 8 * slot);
#pragma unroll
      for (int e = 0; e < ACC; ++e) sum[e] = __fadd_rn(sum[e], acc[e]);
    }

    // the unit's part: accumulator (row, col) of m64nN: row 16 w + lane/4
    // (+8) = feature, col 8 jj + 2 (lane % 4) (+1) = model, register 4 jj +
    // 2 half + {0, 1}
    float* part = p.parts + ((size_t)s * p.ft * TILE_ROWS + ft * TILE_ROWS) * p.n_pad + mt * p.nt;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int jj = 0; jj < ACC / 4; ++jj) {
        if (8 * jj >= p.nt) break;
        const int col = 8 * jj + 2 * t4;
        *reinterpret_cast<float2*>(part + (size_t)(row + 8 * half) * p.n_pad + col) =
            make_float2(sum[4 * jj + 2 * half], sum[4 * jj + 2 * half + 1]);
      }
    }
  }
  __threadfence();
  grid_barrier(p.sync, gridDim.x);

  // the (B, K) elements, shared by every consumer: the parts summed in
  // segment order, then the coordinate step (fused) or G (split route).
  // The parts' loads go out 8 at a time ahead of their sums.
  const size_t seg = (size_t)p.ft * TILE_ROWS * p.n_pad;
  const int total = gridDim.x * CONSUMERS, count = p.B * p.K;
  for (int e = blockIdx.x * CONSUMERS + (threadIdx.x - PRODUCERS); e < count; e += total) {
    const int f = e / p.K, k = e - f * p.K;
    const float* src = p.parts + (size_t)f * p.n_pad + k;
    float gs = 0.f;
    for (int s0 = 0; s0 < p.segments; s0 += 8) {
      float part[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) part[j] = s0 + j < p.segments ? __ldcg(src + (s0 + j) * seg) : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (s0 + j < p.segments) gs = s0 + j == 0 ? part[0] : __fadd_rn(gs, part[j]);
    }
    if (p.fused) {
      const float wv = p.w[e];
      const float d = gblinear::coord_step(gs, p.h[e], wv, p.eta, p.lam, p.alpha);
      p.w[e] = __fadd_rn(wv, d);
      const float hi = tf32_rna(d);
      p.dw[(size_t)k * p.b_pad + f] = hi;
      p.dw[((size_t)p.n_pad + k) * p.b_pad + f] = tf32_rna(d - hi);
    } else {
      p.g[e] = gs;
    }
  }
}

}  // namespace

// Returns 0 on success or the cudaError_t of a refused launch. x: Xb (B,
// n) fp32 rows `ld` apart, 16-byte aligned; r, rw: (K, n) fp32 rows `ld`
// apart, 16-byte aligned; fused: h, w (B, K) and dw's planes (2, tiles * nt, b_pad) written;
// else g (B, K) written; parts: segments x ceil(B / 128) x 128 x tiles * nt
// fp32; sync: 2 unsigned ints, zero before the first launch (every launch
// leaves them ready for the next). `grid` CTAs (at most the units, and
// every one resident: a cooperative launch) on `stream`; allocates nothing.
extern "C" int gblinear_block_grad_launch(const void* x, const void* r, const void* rw, const void* h, void* w,
                                          void* dw, void* g, void* parts, void* sync, int n, int ld, int B, int K,
                                          int nt, int tiles, int b_pad, int segments, int grid, int fused, float eta,
                                          float lam, float alpha, void* stream) {
  if (!common_ok(x, n, ld, B, K, nt, tiles, b_pad) || reinterpret_cast<uintptr_t>(r) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(rw) % 16 != 0 ||
      parts == nullptr || sync == nullptr || (fused ? (h == nullptr || w == nullptr || dw == nullptr) : g == nullptr))
    return (int)cudaErrorInvalidValue;
  GradParams p;
  p.h = static_cast<const float*>(h);
  p.w = static_cast<float*>(w);
  p.dw = static_cast<float*>(dw);
  p.g = static_cast<float*>(g);
  p.parts = static_cast<float*>(parts);
  p.sync = static_cast<unsigned*>(sync);
  p.B = B;
  p.K = K;
  p.nt = nt;
  p.tiles = tiles;
  p.n_pad = tiles * nt;
  p.b_pad = b_pad;
  p.ft = (B + TILE_ROWS - 1) / TILE_ROWS;
  p.segments = segments;
  p.n_st = (n + KC - 1) / KC;
  p.units = p.ft * tiles * segments;
  p.fused = fused;
  p.eta = eta;
  p.lam = lam;
  p.alpha = alpha;
  if (segments <= 0 || segments > p.n_st || (long long)segments * p.n_st > 0x7fffffffLL || grid <= 0 ||
      grid > p.units || (long long)grid * CONSUMERS + (long long)B * K > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;

  CUtensorMap xmap, rmap, rwmap;
  int bad = cached_fp32_rows(&xmap, x, n, B, ld, TILE_ROWS);
  if (bad == 0) bad = cached_fp32_rows(&rmap, r, n, K, ld, nt);
  if (bad == 0) bad = cached_fp32_rows(&rwmap, rw, n, K, ld, nt);
  static unsigned prepared = 0;  // a bit a device
  if (bad == 0) bad = prepare_once(gblinear_block_grad_kernel, LAUNCH_REGS, SMEM_MAX, prepared);
  if (bad != 0) return bad;
  void* args[] = {&xmap, &rmap, &rwmap, &p};
  return (int)cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(gblinear_block_grad_kernel), dim3(grid),
                                          dim3(THREADS), args, smem_bytes(nt, 0), static_cast<cudaStream_t>(stream));
}
