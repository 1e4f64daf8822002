// Width-8 valid 1-D convolution + bias + ReLU in fp32 (parity mode) on
// Hopper's TF32 tensor cores, three passes a product: the "tf32x3" route of
// ops/conv8.py::conv8_relu.
//
//   y[n, l, co] = relu( sum_{k<8, ci<Cin} x[n, l+k, ci] * W[k, ci, co] + b[co] )
//
// x (N, L, Cin) fp32, 16-byte aligned, Cin % 4 == 0; W (8, Cin, Cout) fp32
// split and packed by ops/conv8.py::pack_weights_tf32x3 (below); b (Cout)
// fp32 -> y (N, L-7, Cout) fp32, channels last.
//
// Replaces the TPU kernel expecto_tpu/ops/pallas_conv.py::conv8_relu for
// fp32 x that TMA can read (Beluga's conv1-conv5 in every fp32 flow), which
// the JAX package runs at Precision.HIGHEST (expecto_tpu/ops/spans.py): on
// the TPU a multi-pass split of fp32 on the matrix unit. The SIMT kernel
// csrc/conv8_relu.cu keeps the fp32 views off a 16-byte boundary and a Cin
// off the stage width.
//
// The split, as csrc/fc1_strided_tf32x3.cu's head says: each operand is cut
// into hi = tf32(v) and lo = tf32(v - hi), both rounded to nearest, so hi +
// lo holds v within 2^-22 |v|; each k8 step runs lo*hi + hi*lo + hi*hi on
// the tensor cores (lo*lo, 2^-22 of the product, is left out), and each
// stage's chain of tensor-core products starts a fresh accumulator that is
// then added into an fp32 sum in registers (FADD, round to nearest: the
// tensor cores' own fp32 sum truncates, and drifted 4.7e-4 of max|y| over
// fc1's 25,440 chained products).
//
// What bounds it on an H100: 2 * 8 * Cin = 5,120 to 10,240 operations an
// output element, three passes of them at the TF32 rate of 495 TFLOP/s:
// 165 TFLOP/s of fp32 work, 2.46x the 67 TFLOP/s of the FFMA units that
// bound the SIMT kernel. The bytes (x, W and b read once, y written once)
// are a few percent of that: the work is bound by the operations. The
// design keeps the TF32 tensor cores fed:
//
// - Flat rows, as both other conv kernels: x is read as one (N*L, Cin)
//   matrix; rows that straddle two spans are computed and never stored. A
//   GEMM of M = N*L rows, N = Cout, K = 8*Cin.
// - Taps as descriptor offsets. A stage holds KC = 4 input channels: one
//   TMA box of the A halo (TM + 7 rows x 16 bytes, rows past N*L arriving
//   as zeros), a single 16-byte column in the no-swizzle K-major layout, so
//   a shift of k rows is a descriptor start 16k bytes on (as
//   csrc/conv8_relu_tc.cu does). A k8 step takes two taps of the 4
//   channels: its two K core matrices are the column at rows 2j and 2j + 1,
//   one descriptor with a leading byte offset of 16. Four k8 steps cover a
//   stage's 8 taps x 4 channels.
// - A split once a stage in shared memory. The producer warp issues the
//   copies (lane 0), then its 32 lanes split a landed stage's A column in
//   place into hi and a lo column beside it, fence the writes to the async
//   proxy and release the stage to the consumers ("ready" barrier). Each A
//   value is split once and read by 8 taps x 3 passes x 2 warpgroups.
// - B by the copy engine. pack_weights_tf32x3 splits W once per weight
//   tensor and lays each (Cout tile, 4-channel chunk) out as one contiguous
//   40 KB stage: hi, then lo, each 8 tap columns of 160 outputs x 16 bytes,
//   K-major, Cout zero-padded to a multiple of 160. One cp.async.bulk a
//   stage.
// - Tiles. A CTA owns TM = 128 rows x BN = 160 output channels (160
//   divides Beluga's 320, 480 and 640), two consumer warpgroups of 64 rows,
//   m64n160k8 wgmma with both operands from shared memory: 80 accumulators
//   and 80 sums a thread. A five-stage ring (45,312 bytes a stage) with
//   full, ready and empty mbarriers. 384 threads: the consumer warpgroups 0
//   and 1 raise their registers to 224 a thread (setmaxnreg) from the
//   producer warpgroup 2, which keeps 56 and of which one warp works (at
//   288 threads ptxas held every thread to 168 registers and spilled).
//   Each warpgroup drains its own stage's group (wait_group 0), releases
//   the stage and promotes; the other warpgroup's group keeps the tensor
//   cores busy meanwhile. The epilogue stages the tile (post-bias,
//   post-ReLU) in the ring's idle shared memory and the 256 consumers store
//   it 16 bytes a thread, a row's 640 bytes contiguous.
// - Short rows (the consensus patch's conv4 and conv5 fill a third of one
//   wave in 128 x 160 tiles): below two waves of tiles,
//   ops/conv8.py::tf32x3_splits cuts K, the input channels, into `splits`
//   parts (a pure function of M, Cin, Cout and the SMs) that fill the
//   waves best. Each part's CTA writes its sum to a workspace (splits, M,
//   Cout); a second kernel adds the parts in part order, then the bias,
//   ReLU and the store (or the pool): a shape gives the same bits on every
//   call. Past two waves the parts' round trip cost more than the fuller
//   last wave gained (PERF.md).
// - The pooled epilogue (conv8_relu_tf32x3_pool4_launch): Beluga's 4-wide
//   max-pool after conv1 and conv3 (the JAX package's XLA reduce-window
//   expecto_tpu/ops/spans.py:47-51 `_pool4_from`), with the rule of
//   csrc/conv8_relu_tc.cu: tiles step TM - 4 = 124 rows and compute 128, a
//   tile owns the groups that start in its first 124 rows, so no atomics
//   and no zero fill; the consumers store each owned group's max of the
//   staged tile, 16 bytes at a time. The values are the unpooled kernel's,
//   so the bits equal it followed by the pool. With splits the tiles are
//   the unpooled ones and the second kernel pools. The SIMT kernel's rule
//   (atomicMax across tile edges) measured 1.7-3.5 % slower on this kernel
//   over the serving and gene chunks' pooled launches (PERF.md).
//
// Shared memory: 5 stages x (2 x 2,176 B of A + 2 x 20,480 B of B) + 3
// barriers a stage.

#include "hopper_common.cuh"

namespace {

using namespace hopper;

constexpr int KW = 8;                          // conv width
constexpr int TM = 128;                        // flat rows a CTA (2 consumer warpgroups x 64)
constexpr int BN = 160;                        // output channels a CTA
constexpr int KC = 4;                          // input channels a stage: one 16-byte column
constexpr int HALO = 136;                      // A rows a stage: TM + KW - 1, rounded up to 8
constexpr int STEPS = KW * KC / 8;             // k8 steps a stage: tap pairs
constexpr int STAGES = 5;
constexpr int A_PLANE = HALO * 16;             // 2,176: the A column, hi or lo
constexpr int B_COL = BN * 16;                 // 2,560: one tap's 4 channels x 160 outputs
constexpr int B_PLANE = KW * B_COL;            // 20,480
constexpr int A_BYTES = 2 * A_PLANE;           // hi (where the copy lands, split in place), then lo
constexpr int B_BYTES = 2 * B_PLANE;           // hi, then lo: one packed stage
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;  // 45,312
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 3 * STAGES * 8;
constexpr int CONSUMER_THREADS = 256;          // warps 0-7: two warpgroups
constexpr int THREADS = CONSUMER_THREADS + 128;  // warpgroup 2: the producer (warp 8 works)
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
// registers a thread at launch (__launch_bounds__ of 384 threads): the pool
// setmaxnreg redistributes
constexpr int LAUNCH_REGS = 168;
constexpr int ACC = BN / 2;                    // fp32 accumulators a consumer thread
constexpr int POOL_W = 4;                      // max-pool width and stride
constexpr int POOL_LD = BN + 8;                // floats a staged row: a half-warp's 8-byte stores miss no bank
constexpr int REDUCE_THREADS = 256;

static_assert(A_PLANE % 128 == 0 && STAGE_BYTES % 128 == 0 && A_BYTES % 16 == 0, "TMA boxes on 128-byte boundaries");
static_assert(HALO >= TM + KW - 1, "the halo holds every tap's rows");
static_assert(SMEM_BYTES <= 232448, "the ring fits a block's shared memory");
static_assert(TM * POOL_LD * 4 <= STAGES * STAGE_BYTES, "the staged tile fits in the ring");
static_assert(128 * PRODUCER_REGS + CONSUMER_THREADS * CONSUMER_REGS <= LAUNCH_REGS * THREADS &&
                  LAUNCH_REGS * THREADS <= 65536,
              "the register split fits the pool the CTA is launched with");

enum Mode { STORE = 0, POOL = 1, PARTS = 2 };

// Where the results go: y[0] (N, L-7, Cout) with mask 0; else, for each bit
// ph of mask, the pooled phase buffer y[ph] (N, (L-7-ph)/4, Cout); the
// parts' workspace (splits, M, Cout) where K is split.
struct Outputs {
  float* y[POOL_W];
  float* ws;
  int mask;
};

// d (64 x 160 fp32, this thread's 80) = (accumulate ? d : 0) + A (64 x 8
// tf32) * B (8 x 160 tf32), both from shared memory
__device__ __forceinline__ void wgmma_m64n160k8(float (&d)[ACC], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "l"(da), "l"(db), "r"(accumulate));
}

// A stage's A column (HALO rows x 4 fp32 at `at`) split in place: hi there,
// lo A_PLANE bytes further; lane `lane` of the producer warp takes every
// 32nd 16-byte piece
__device__ __forceinline__ void split_column(uint32_t at, int lane) {
  for (int p = lane; p < HALO; p += 32) {
    const uint32_t a = at + 16 * p;
    float v[4], hi[4], lo[4];
    asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
                 : "r"(a)
                 : "memory");
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      hi[e] = tf32_rna(v[e]);
      lo[e] = tf32_rna(v[e] - hi[e]);
    }
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(a), "f"(hi[0]), "f"(hi[1]), "f"(hi[2]), "f"(hi[3])
                 : "memory");
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(a + A_PLANE), "f"(lo[0]), "f"(lo[1]), "f"(lo[2]),
                 "f"(lo[3])
                 : "memory");
  }
}

// out.y[ph] by selects: an index into the kernel parameter would copy the
// struct to local memory
__device__ __forceinline__ float* phase_out(const Outputs& out, int ph) {
  return ph == 0 ? out.y[0] : ph == 1 ? out.y[1] : ph == 2 ? out.y[2] : out.y[3];
}

// The pooled epilogue's second half: the consumers' fp32 tile of TM rows
// staged in `tile` (POOL_LD a row); each (group, 4-channel piece) of the
// groups this tile owns (those starting in its first TM - 4 rows) maxed over
// its 4 rows and stored, 16 bytes where Cout allows.
__device__ __forceinline__ void store_pooled(const float* tile, const Outputs& out, long long m0, int M, int L,
                                             int Cout) {
  constexpr int PIECES = BN / 4;
  const int l_out = L - KW + 1;
  for (int it = threadIdx.x; it < (TM - POOL_W) * PIECES; it += CONSUMER_THREADS) {
    const int i = it / PIECES, q = it % PIECES, c = blockIdx.y * BN + 4 * q;
    if (m0 + i >= M || c >= Cout) continue;
    const int m = (int)(m0 + i), n = m / L, l = m - n * L;
    const int ph = l % POOL_W, j = l / POOL_W, frames = (l_out - ph) / POOL_W;
    if (!((out.mask >> ph) & 1) || j >= frames) continue;  // not a group's first row (or not one asked for)
    const float4* src = reinterpret_cast<const float4*>(tile + i * POOL_LD + 4 * q);
    float4 v = src[0];
#pragma unroll
    for (int r = 1; r < POOL_W; ++r) {
      const float4 u = src[r * POOL_LD / 4];
      v = make_float4(fmaxf(v.x, u.x), fmaxf(v.y, u.y), fmaxf(v.z, u.z), fmaxf(v.w, u.w));
    }
    float* dst = phase_out(out, ph) + ((size_t)n * frames + j) * Cout + c;
    if (Cout % 4 == 0) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float vs[4] = {v.x, v.y, v.z, v.w};
      for (int e = 0; e < 4 && c + e < Cout; ++e) dst[e] = vs[e];
    }
  }
}

// The unpooled epilogue's second half: the consumers' fp32 tile of TM rows
// staged in `tile` (POOL_LD a row), each (row, 4-channel piece) stored, 16
// bytes where Cout allows: into y (N, L-7, Cout), the rows that straddle two
// spans dropped, or with `all_rows` into a part's (M, Cout) workspace.
__device__ __forceinline__ void store_tile(const float* tile, float* dst0, bool all_rows, long long m0, int M, int L,
                                           int Cout) {
  constexpr int PIECES = BN / 4;
  const int l_out = L - KW + 1;
  for (int it = threadIdx.x; it < TM * PIECES; it += CONSUMER_THREADS) {
    const int i = it / PIECES, q = it % PIECES, c = blockIdx.y * BN + 4 * q;
    if (m0 + i >= M || c >= Cout) continue;
    const int m = (int)(m0 + i);
    size_t row = m;
    if (!all_rows) {
      const int n = m / L, l = m - n * L;
      if (l >= l_out) continue;  // straddles two spans
      row = (size_t)n * l_out + l;
    }
    const float4 v = *reinterpret_cast<const float4*>(tile + i * POOL_LD + 4 * q);
    float* dst = dst0 + row * Cout + c;
    if (Cout % 4 == 0) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float vs[4] = {v.x, v.y, v.z, v.w};
      for (int e = 0; e < 4 && c + e < Cout; ++e) dst[e] = vs[e];
    }
  }
}

// A CTA's place: its ring in shared memory (STAGES "full", then "ready",
// then "empty" barriers after the stages), its first flat row and its
// input-channel stages. Each role computes it after its setmaxnreg, so that
// nothing computed before lives across the register change (ptxas spilled
// such values).
struct Place {
  uint32_t base, full0, ready0, empty0;
  long long m0;
  int kt, st0, n_st;
};

template <int MODE>
__device__ __forceinline__ Place place(const uint8_t* smem, int Cin, int splits) {
  Place p;
  p.base = smem_addr(smem);
  p.full0 = p.base + STAGES * STAGE_BYTES;
  p.ready0 = p.full0 + STAGES * 8;
  p.empty0 = p.ready0 + STAGES * 8;
  p.m0 = (long long)blockIdx.x * (MODE == POOL ? TM - POOL_W : TM);
  p.kt = Cin / KC;
  p.st0 = (int)((long long)blockIdx.z * p.kt / splits);
  p.n_st = (int)((long long)(blockIdx.z + 1) * p.kt / splits) - p.st0;
  return p;
}

// grid (row tiles, Cout tiles, splits): rows m0 .. m0 + TM - 1, outputs
// blockIdx.y * BN .. + BN - 1, input-channel stages of part blockIdx.z
template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
conv8_relu_tf32x3_kernel(const __grid_constant__ CUtensorMap xmap, const float* __restrict__ wp,
                         const float* __restrict__ b, const Outputs out, int M, int L, int Cin, int Cout, int splits) {
  extern __shared__ __align__(1024) uint8_t smem[];
  if (threadIdx.x == 0) {
    const Place p = place<MODE>(smem, Cin, splits);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(p.full0 + 8 * s, 1);                        // the producer's expect_tx
      mbar_init(p.ready0 + 8 * s, 1);                       // the producer warp's split
      mbar_init(p.empty0 + 8 * s, CONSUMER_THREADS / 32);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMER_THREADS) {
    // producer warpgroup: its registers go to the consumers, and warp 8
    // alone works. Lane 0 issues stage `it`, then the warp splits the stage
    // issued LAG before it (landed by then, and well ahead of the
    // consumers); the last LAG stages are split after the loop
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x >= CONSUMER_THREADS + 32) return;
    const int lane = threadIdx.x % 32;
    const Place p = place<MODE>(smem, Cin, splits);
    constexpr int LAG = 2;
    const uint8_t* wsrc = reinterpret_cast<const uint8_t*>(wp) + ((size_t)blockIdx.y * p.kt + p.st0) * B_BYTES;
    for (int it = 0; it < p.n_st + LAG; ++it) {
      if (it < p.n_st && lane == 0) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(p.empty0 + 8 * s, ((it / STAGES) + 1) & 1);
        const uint32_t full = p.full0 + 8 * s, dst = p.base + s * STAGE_BYTES;
        mbar_expect_tx(full, A_PLANE + B_BYTES);
        tma_load_2d(dst, &xmap, full, (p.st0 + it) * KC, (int)p.m0);
        bulk_load(dst + A_BYTES, wsrc + (size_t)it * B_BYTES, B_BYTES, full);
      }
      const int sp = it - LAG;
      if (sp < 0) continue;
      const int s = sp % STAGES;
      mbar_wait(p.full0 + 8 * s, (sp / STAGES) & 1);
      split_column(p.base + s * STAGE_BYTES, lane);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // these writes, to wgmma
      __syncwarp();
      if (lane == 0) mbar_arrive(p.ready0 + 8 * s);
    }
    return;
  }

  // consumers: warpgroup wg owns flat rows m0 + 64 wg .. + 63
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = warp / 4;
  const Place p = place<MODE>(smem, Cin, splits);
  float d[ACC], sum[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    d[i] = 0.f;
    sum[i] = 0.f;
  }
  for (int it = 0; it < p.n_st; ++it) {
    const int s = it % STAGES;
    const uint32_t parity = (it / STAGES) & 1;
    mbar_wait(p.full0 + 8 * s, parity);
    mbar_wait(p.ready0 + 8 * s, parity);
    const uint32_t a_hi = p.base + s * STAGE_BYTES + wg * 64 * 16, a_lo = a_hi + A_PLANE;
    const uint32_t b_hi = p.base + s * STAGE_BYTES + A_BYTES, b_lo = b_hi + B_PLANE;
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      // taps 2j and 2j + 1: A's rows 2j on, its second K core matrix one row
      // (16 bytes) further; B's tap columns 2j and 2j + 1
      const uint32_t ar = 2 * j * 16, bo = 2 * j * B_COL;
      wgmma_m64n160k8(d, interleave_desc(a_lo + ar, 16, 128), interleave_desc(b_hi + bo, B_COL, 128), j > 0);
      wgmma_m64n160k8(d, interleave_desc(a_hi + ar, 16, 128), interleave_desc(b_lo + bo, B_COL, 128), 1);
      wgmma_m64n160k8(d, interleave_desc(a_hi + ar, 16, 128), interleave_desc(b_hi + bo, B_COL, 128), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(d);
    if (lane == 0) mbar_arrive(p.empty0 + 8 * s);
#pragma unroll
    for (int i = 0; i < ACC; ++i) sum[i] = __fadd_rn(sum[i], d[i]);
  }

  // epilogue: every consumer's last wgmma has completed, so the ring is
  // free; the tile (post-bias, post-ReLU, or the part's raw sums) is staged
  // there, then stored 16 bytes at a time by all 256 consumers. Accumulator
  // (row, col) of m64nN: row 16 w + lane/4 (+8), col 8 j + 2 (lane % 4)
  // (+1), register 4 j + 2 half + {0, 1}.
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMER_THREADS) : "memory");
  float* tile = reinterpret_cast<float*>(smem);
  const int c_tile = 2 * (lane % 4);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = wg * 64 + (warp % 4) * 16 + lane / 4 + 8 * half;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = blockIdx.y * BN + c_tile + 8 * j;
      float v0 = sum[4 * j + 2 * half], v1 = sum[4 * j + 2 * half + 1];
      if constexpr (MODE != PARTS) {
        v0 = fmaxf(__fadd_rn(v0, c < Cout ? b[c] : 0.f), 0.f);
        v1 = fmaxf(__fadd_rn(v1, c + 1 < Cout ? b[c + 1] : 0.f), 0.f);
      }
      *reinterpret_cast<float2*>(tile + r * POOL_LD + c_tile + 8 * j) = make_float2(v0, v1);
    }
  }
  asm volatile("bar.sync 1, %0;" ::"n"(CONSUMER_THREADS) : "memory");
  if constexpr (MODE == POOL) {
    store_pooled(tile, out, p.m0, M, L, Cout);
  } else {
    store_tile(tile, MODE == PARTS ? out.ws + (size_t)blockIdx.z * M * Cout : out.y[0], MODE == PARTS, p.m0, M, L,
               Cout);
  }
}

// relu(parts summed in part order + b) at flat row m, output c
__device__ __forceinline__ float reduced(const float* __restrict__ ws, const float* __restrict__ b, int splits,
                                         long long M, long long m, int Cout, int c) {
  float v = ws[m * Cout + c];
  for (int s = 1; s < splits; ++s) v = __fadd_rn(v, ws[((long long)s * M + m) * Cout + c]);
  return fmaxf(__fadd_rn(v, b[c]), 0.f);
}

// The second kernel where K is split: grid (blocks, 1 or 4). Mask 0: y[0]
// (N, L-7, Cout); else blockIdx.y = phase ph, skipped unless bit ph of the
// mask is set: the 4-wide max of each group of phase ph into y[ph].
__global__ void __launch_bounds__(REDUCE_THREADS)
conv8_relu_tf32x3_reduce(const float* __restrict__ b, const Outputs out, int splits, int n, int L, int Cout) {
  const int l_out = L - KW + 1, ph = blockIdx.y;
  const long long M = (long long)n * L;
  if (out.mask != 0 && !((out.mask >> ph) & 1)) return;
  const int rows = out.mask == 0 ? l_out : (l_out - ph) / POOL_W;  // a span's output rows or pool frames
  const long long total = (long long)n * rows * Cout;
  for (long long e = (long long)blockIdx.x * REDUCE_THREADS + threadIdx.x; e < total;
       e += (long long)gridDim.x * REDUCE_THREADS) {
    const int c = (int)(e % Cout);
    const long long r = e / Cout;
    const long long sn = r / rows, i = r - sn * rows;
    if (out.mask == 0) {
      out.y[0][e] = reduced(out.ws, b, splits, M, sn * L + i, Cout, c);
    } else {
      const long long m = sn * L + ph + POOL_W * i;
      float v = reduced(out.ws, b, splits, M, m, Cout, c);
      for (int k = 1; k < POOL_W; ++k) v = fmaxf(v, reduced(out.ws, b, splits, M, m + k, Cout, c));
      phase_out(out, ph)[e] = v;
    }
  }
}

template <int MODE>
int launch_main(const CUtensorMap& xmap, const void* wp, const void* b, const Outputs& out, long long m, int L,
                int Cin, int Cout, int splits, cudaStream_t st) {
  static unsigned prepared = 0;  // a bit a device
  const int err = prepare_once(conv8_relu_tf32x3_kernel<MODE>, LAUNCH_REGS, SMEM_BYTES, prepared);
  if (err != 0) return err;
  const int step = MODE == POOL ? TM - POOL_W : TM;
  const dim3 grid((unsigned)((m + step - 1) / step), (unsigned)((Cout + BN - 1) / BN), (unsigned)splits);
  conv8_relu_tf32x3_kernel<MODE><<<grid, THREADS, SMEM_BYTES, st>>>(
      xmap, static_cast<const float*>(wp), static_cast<const float*>(b), out, (int)m, L, Cin, Cout, splits);
  return (int)cudaGetLastError();
}

// The launch of either entry: checks, the tensor map of x, the main kernel
// and (splits > 1) the second one.
int launch(const void* x, const void* wp, const void* b, const Outputs& out, int n, int L, int Cin, int Cout,
           int splits, void* stream) {
  const long long m = (long long)n * L;
  if (n <= 0 || L < KW || Cin <= 0 || Cin % KC != 0 || Cout <= 0 || m > 0x7fffffffLL || splits < 1 ||
      splits > Cin / KC || (splits > 1 && out.ws == nullptr) || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(wp) % 16 != 0 || reinterpret_cast<uintptr_t>(out.ws) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  CUtensorMap xmap;
  const cuuint64_t dims[2] = {(cuuint64_t)Cin, (cuuint64_t)m};
  const cuuint64_t strides[1] = {(cuuint64_t)Cin * sizeof(float)};
  const cuuint32_t box[2] = {KC, HALO};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult cr = encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(x), dims, strides, box,
                             elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (cr != CUDA_SUCCESS) return 10000 + (int)cr;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits == 1)
    return out.mask == 0 ? launch_main<STORE>(xmap, wp, b, out, m, L, Cin, Cout, 1, st)
                         : launch_main<POOL>(xmap, wp, b, out, m, L, Cin, Cout, 1, st);
  const int err = launch_main<PARTS>(xmap, wp, b, out, m, L, Cin, Cout, splits, st);
  if (err != 0) return err;
  const long long most = m * Cout;  // at least any phase's outputs
  const unsigned blocks = (unsigned)((most + REDUCE_THREADS - 1) / REDUCE_THREADS < 8192
                                         ? (most + REDUCE_THREADS - 1) / REDUCE_THREADS
                                         : 8192);
  conv8_relu_tf32x3_reduce<<<dim3(blocks, out.mask == 0 ? 1 : POOL_W), REDUCE_THREADS, 0, st>>>(
      static_cast<const float*>(b), out, splits, n, L, Cout);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0 on success, a cudaError_t of the launch, or 10000 + the CUresult
// of a failed tensor-map encoding. x (n, L, Cin) fp32, 16-byte aligned, Cin
// % 4 == 0; wp the packed weights (ops/conv8.py::pack_weights_tf32x3); b
// (Cout) fp32; y (n, L-7, Cout) fp32; splits the parts of K
// (ops/conv8.py::tf32x3_splits), and with splits > 1 ws (splits, n*L, Cout)
// fp32, 16-byte aligned. Launches on `stream`, allocates nothing.
extern "C" int conv8_relu_tf32x3_launch(const void* x, const void* wp, const void* b, void* y, void* ws, int n, int L,
                                        int Cin, int Cout, int splits, void* stream) {
  const Outputs out = {{static_cast<float*>(y), nullptr, nullptr, nullptr}, static_cast<float*>(ws), 0};
  if (y == nullptr) return (int)cudaErrorInvalidValue;
  return launch(x, wp, b, out, n, L, Cin, Cout, splits, stream);
}

// The pooled epilogue: as conv8_relu_tf32x3_launch, but for each bit ph of
// `mask` (1..15) stores the 4-wide max-pool from phase ph into y<ph> (n,
// (L-7-ph)/4, Cout) fp32, each 16-byte aligned, and the conv's output
// nowhere.
extern "C" int conv8_relu_tf32x3_pool4_launch(const void* x, const void* wp, const void* b, void* y0, void* y1,
                                              void* y2, void* y3, void* ws, int n, int L, int Cin, int Cout,
                                              int splits, int mask, void* stream) {
  const Outputs out = {{static_cast<float*>(y0), static_cast<float*>(y1), static_cast<float*>(y2),
                        static_cast<float*>(y3)},
                       static_cast<float*>(ws), mask};
  if (mask <= 0 || mask >= (1 << POOL_W)) return (int)cudaErrorInvalidValue;
  for (int ph = 0; ph < POOL_W; ++ph)
    if (((mask >> ph) & 1) && (out.y[ph] == nullptr || reinterpret_cast<uintptr_t>(out.y[ph]) % 16 != 0))
      return (int)cudaErrorInvalidValue;
  return launch(x, wp, b, out, n, L, Cin, Cout, splits, stream);
}
