// fc1 of Beluga as a strided product over a conv6 phase buffer, in fp32
// (parity mode) on Hopper's TF32 tensor cores, three passes a product, for
// the calls with many windows (M > ops/fc1.py's SWAP_MAX_M):
//
//   y[n, w, o] = sum_{f < 106, c < C} buf[n, s0 + w*stride + f, c] * W[f*C + c, o]
//
// buf (N, F, C) fp32 channels last (C = 640), W (106*C, Nout) fp32 (Nout =
// 2,003) split and packed by ops/fc1.py (below) -> y (N, n_win, Nout) fp32:
// fc1's pre-activations, no bias or ReLU.
//
// Replaces, with csrc/fc1_strided_tf32x3_swap.cu (the calls with few
// windows), the XLA step of expecto_tpu/ops/spans.py::fc1_pre_from_phases,
// the strided valid convolution lax.conv_general_dilated (:421) with the
// (106, 640, 2003) kernel, for fp32 (parity mode), which the JAX package
// runs at Precision.HIGHEST: on the TPU a multi-pass split of fp32 into
// narrower operands on the matrix unit. As a GEMM it is M = N*n_win
// windows, N = 2,003 columns, K = 106*640 = 67,840.
//
// The split. Each operand x is cut into hi = tf32(x) and lo = tf32(x - hi),
// both rounded to nearest (the MMA would truncate an fp32 operand, leaving
// 2^-10 of x in the rest where rounding leaves 2^-11), so hi + lo holds x
// within 2^-22 |x|. Each k8 step runs three products on the tensor cores,
// lo*hi + hi*lo + hi*hi (the small ones first), into one fp32 accumulator;
// lo*lo (2^-22 of the product) is left out.
//
// What bounds it on an H100: 3 x 2*M*67,840*2,003 operations at the TF32
// rate of 495 TFLOP/s, 1.647 us a row of M (165 TFLOP/s of fp32 work, 2.5
// times the 67 TFLOP/s of the FFMA units that bound SGEMM), against the
// function's bytes, fp32 W once (0.5435 GB, 0.162 ms at 3.35 TB/s): the
// operations pass the bytes at M ~ 98. This kernel streams W split (hi and
// lo, columns padded to 2,048: 1.11 GB, 0.332 ms), which its operations
// pass at M ~ 201, and does the tensor work of whole 128-row tiles; below
// SWAP_MAX_M the calls go to csrc/fc1_strided_tf32x3_swap.cu, which streams
// fp32 W once. Serving and the h5 step call fc1 at M = 500 - 1,135 rows a
// chunk, the gene path at 1,600: bound by the operations. The design keeps
// the TF32 tensor cores fed:
//
// - Warp specialization, as csrc/fc1_strided_tc.cu: warpgroup 0 is the
//   producer (56 registers a thread after setmaxnreg), its 128 threads copy
//   A, one of them B, into a ring of STAGES stages with "full" and "empty"
//   mbarriers; warpgroups 1 and 2 are the consumers (224 registers), each
//   runs m64n128k8 over 64 rows of the 128-row tile.
// - A in place, by cp.async. Row m = n*n_win + w of A starts at element
//   n*ld + (s0 + w*stride)*C and is 67,840 contiguous floats long; a stage
//   is 32 of them (one 128-byte row under the 128-byte swizzle). Each
//   producer thread owns 2 rows and copies 4 16-byte pieces of each a
//   stage, zero-filling rows past M and K past 106*C. The windows are never
//   copied out.
// - A split by the consumers, in shared memory. Once a stage has landed,
//   each consumer warpgroup reads its 64 rows of A (16 floats a thread),
//   writes hi over them and lo into the stage's second A tile (same
//   swizzle), fences the writes to the async proxy and meets its own 128
//   threads at a named barrier before its wgmma read them. A warpgroup has
//   drained its own group of the stage before (below), so its split runs
//   while the other consumer warpgroup's group keeps the tensor cores busy.
//   Each A element is so split once for every column tile that shares its
//   row tile (16 times at Beluga's widths); A split once a call by
//   csrc/fc1_split_tf32.cu and copied as two planes doubles the A bytes a
//   stage brings in, and measured slower on the H100 at every shape of this
//   route (PERF.md, section 6).
// - B by the copy engine. ops/fc1.py splits W once per weight tensor and
//   packs hi and lo into (Nout/128, K/32, 2, 128, 32): one stage of B, hi
//   then lo, is one contiguous block that one thread copies with
//   cp.async.bulk, completing on the stage's full barrier by its byte count.
// - Promoted sums, every stage. The tensor cores' fp32 accumulation does
//   not round to nearest, and K is 8,480 k8 steps deep: left in the
//   accumulator the sum drifts up to 4.7e-4 of max|y| from a float64
//   product (PERF.md, section 6). So each stage's 12 k8 products start a
//   fresh accumulator; the consumer waits for its group (wgmma.wait_group
//   0), releases the stage and adds the accumulator into a separate fp32
//   sum in registers (FADD, round to nearest). Each warpgroup drains its
//   own group every stage; the overlap on the tensor cores comes from the
//   other consumer warpgroup. A second accumulator, promoted while the next
//   stage's group runs (wait_group 1), measured up to 15 % slower on the
//   H100 (PERF.md, section 6).
// - As csrc/fc1_strided_tc.cu: the 128-byte swizzle, the frame walk of
//   period `period` (the stride where C % 32 == 0: a buffer frame's reads
//   by neighbouring windows come a few stages apart and hit L2), the
//   persistent grid on ops/fc1.py::fc1_schedule's fixed schedule, and the
//   second pass that sums the parts of a tile split between groups in group
//   order (csrc/fc1_common.cuh), so a shape gives the same bits on every
//   call.
//
// The instance: 128 x 128 tiles, 3 stages (64 KB a stage: 2 x 16 KB of A,
// 2 x 16 KB of B; a fourth does not fit), a promotion every stage. Measured
// on an H100 against other builds of this design (PERF.md, section
// 6): promoting every stage holds 1e-5 of max|y| of float64 where a
// promotion every 16 stages does not and no promotion misses by 46x, and
// was 1-10 % faster than a promotion every 4 stages; 128 x 256 tiles in 2
// stages, whose registers hold no promoted sum, ran 13-39 % slower.
//
// Shared memory: 1 KB of alignment, STAGES x (2 x A_BYTES + 2 x B_BYTES),
// the barriers and the frame order.

#include "fc1_common.cuh"

namespace {

using namespace fc1;

constexpr int TM = 128;                                  // rows a tile (2 consumer warpgroups x 64)
constexpr int BN = 128;                                  // columns a tile
constexpr int KC = 32;                                   // K a stage: one 128-byte row
constexpr int A_BYTES = TM * KC * 4;                     // 16,384: hi (the copy, split in place), then lo
constexpr int B_BYTES = BN * KC * 4;                     // 16,384: hi, then lo
constexpr int STAGE_BYTES = 2 * A_BYTES + 2 * B_BYTES;
constexpr int STAGES = 3;                                // the ring: a fourth stage does not fit
constexpr int PRODUCERS = 128;                           // warpgroup 0
constexpr int THREADS = PRODUCERS + 256;                 // + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int ACC = BN / 2;                              // fp32 accumulators a consumer thread
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
// registers a thread at launch: the pool setmaxnreg redistributes
constexpr int LAUNCH_REGS = (PRODUCERS * PRODUCER_REGS + (THREADS - PRODUCERS) * CONSUMER_REGS) / THREADS;  // 168

static_assert(LAUNCH_REGS == 168 && LAUNCH_REGS * THREADS <= 65536, "the register split fills one SM");
static_assert(STAGE_BYTES % 1024 == 0 && A_BYTES % 1024 == 0 && B_BYTES % 1024 == 0,
              "swizzled tiles start on 1,024-byte boundaries");

constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 16 * STAGES + 4 * MAX_FRAMES;
static_assert(SMEM_BYTES <= 232448, "the ring fits a block's shared memory");

// Splits the 16-byte piece at shared address `at` in place: hi there, lo
// `lo_off` bytes further.
__device__ __forceinline__ void split_piece(uint32_t at, uint32_t lo_off) {
  float v[4], hi[4], lo[4];
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
               : "r"(at)
               : "memory");
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    hi[e] = tf32_rna(v[e]);
    lo[e] = tf32_rna(v[e] - hi[e]);
  }
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(at), "f"(hi[0]), "f"(hi[1]), "f"(hi[2]),
               "f"(hi[3])
               : "memory");
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(at + lo_off), "f"(lo[0]), "f"(lo[1]), "f"(lo[2]),
               "f"(lo[3])
               : "memory");
}

// d (64 x 128 fp32, this thread's 64) = (accumulate ? d : 0) + A (64 x 8
// tf32) * B (8 x 128 tf32), both from shared memory
__device__ __forceinline__ void wgmma_k8(float (&d)[ACC], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}


__global__ void __launch_bounds__(THREADS, 1)
fc1_strided_tf32x3_kernel(const float* __restrict__ buf, const float* __restrict__ wp, float* __restrict__ y,
                          float* __restrict__ ws, const Params p, int period) {
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t full0 = base + STAGES * STAGE_BYTES;  // STAGES "full" barriers, then STAGES "empty"
  const uint32_t empty0 = full0 + STAGES * 8;
  int* frame_of = reinterpret_cast<int*>(smem_raw + (empty0 + STAGES * 8 - raw));
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  init_ring(full0, empty0, STAGES, PRODUCERS, CONSUMER_WARPS, frame_of, period, p.frames);
  const Place pl = place(p);

  if (warp < PRODUCERS / 32) {
    // producer warpgroup: 128 threads copy A, thread 0 also B (hi and lo)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    const int ra = threadIdx.x >> 1, ha = threadIdx.x & 1;  // rows ra, ra + 64; pieces ha + 2e
    const uint8_t* wbytes = reinterpret_cast<const uint8_t*>(wp);
    int it = 0;
    for (int i = pl.i0; i < p.tiles_m; i += p.rows) {
      long long off[2];
      bool row_ok[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ra + 64 * h, m = i * p.tm + r;
        row_ok[h] = r < p.tm && m < p.M;
        off[h] = row_offset(p, row_ok[h] ? m : 0);
      }
      for (long long x = pl.start; x < pl.end;) {
        int cb, k0, k1;
        x = segment(p, pl, x, cb, k0, k1);
        const uint8_t* bsrc = wbytes + (size_t)(cb * p.cols + pl.cc) * p.kt * (2 * B_BYTES);
        for (int j = k0; j < k1; ++j, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(empty0 + 8 * s, ((it / STAGES) - 1) & 1);
          const int koff = chunk_offset(p, frame_of, j, KC);
          const uint32_t sa = base + s * STAGE_BYTES;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = ra + 64 * h;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int g = ha + 2 * e, k = koff + 4 * g;
              const bool ok = row_ok[h] && k < p.K;
              cp_async16_or_zero(sa + r * 128 + ((g ^ (r & 7)) << 4), ok ? buf + off[h] + k : buf, ok);
            }
          }
          cp_async_arrive(full0 + 8 * s);
          if (threadIdx.x == 0) {
            mbar_expect_tx(full0 + 8 * s, 2 * B_BYTES);
            bulk_load(sa + 2 * A_BYTES, bsrc + (size_t)j * (2 * B_BYTES), 2 * B_BYTES, full0 + 8 * s);
          }
        }
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  // consumer warpgroups: cw owns rows 64 cw .. + 63 of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int cw = warp / 4 - 1, ct = threadIdx.x - PRODUCERS - 128 * cw;
  float d[ACC], sum[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) d[i] = 0.f;
  int it = 0;
  for (int i = pl.i0; i < p.tiles_m; i += p.rows) {
    for (long long x = pl.start; x < pl.end;) {
      const bool first = x == pl.start;
      int cb, k0, k1;
      x = segment(p, pl, x, cb, k0, k1);
#pragma unroll
      for (int e = 0; e < ACC; ++e) sum[e] = 0.f;
      for (int j = k0; j < k1; ++j, ++it) {
        const int s = it % STAGES;
        mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
        const uint32_t sa = base + s * STAGE_BYTES, arows = sa + cw * 64 * 128;
#pragma unroll
        for (int e = 0; e < 4; ++e) split_piece(arows + (ct + 128 * e) * 16, A_BYTES);
        // the split's writes and the producers' cp.async, to wgmma; then
        // every thread of the warpgroup has written its pieces
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        asm volatile("bar.sync %0, 128;" ::"r"(1 + cw) : "memory");
        const uint32_t sb = sa + 2 * A_BYTES;
        fence_acc(d);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KC / 8; ++kk) {
          wgmma_k8(d, sw128_desc(arows + A_BYTES + 32 * kk), sw128_desc(sb + 32 * kk), kk > 0);
          wgmma_k8(d, sw128_desc(arows + 32 * kk), sw128_desc(sb + B_BYTES + 32 * kk), 1);
          wgmma_k8(d, sw128_desc(arows + 32 * kk), sw128_desc(sb + 32 * kk), 1);
        }
        wgmma_commit();
        // the stage's products are done: release its tiles and promote them
        wgmma_wait<0>();
        fence_acc(d);
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
#pragma unroll
        for (int e = 0; e < ACC; ++e) sum[e] = __fadd_rn(sum[e], d[e]);
      }

      // epilogue: accumulator (row, col) of m64n128: row 16 w + lane/4 (+8),
      // col 8 j + 2 (lane % 4) (+1), register 4 j + 2 half + {0, 1}
      const int t = cb * p.cols + pl.cc;
      const bool whole = k0 == 0 && k1 == p.kt;
      const int c_tile = 2 * (lane % 4);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = cw * 64 + (warp % 4) * 16 + lane / 4 + 8 * half, m = i * p.tm + r;
        if (r >= p.tm || m >= p.M) continue;
        if (whole) {
          float* yrow = y + (size_t)m * p.n_out + t * BN;
#pragma unroll
          for (int jj = 0; jj < BN / 8; ++jj) {
            const int c = c_tile + 8 * jj;
            if (t * BN + c < p.n_out) yrow[c] = sum[4 * jj + 2 * half];
            if (t * BN + c + 1 < p.n_out) yrow[c + 1] = sum[4 * jj + 2 * half + 1];
          }
        } else {
          float* wrow = ws + (((size_t)(2 * pl.q + (first ? 0 : 1)) * p.cols + pl.cc) * p.M + m) * BN;
#pragma unroll
          for (int jj = 0; jj < BN / 8; ++jj)
            *reinterpret_cast<float2*>(wrow + c_tile + 8 * jj) =
                make_float2(sum[4 * jj + 2 * half], sum[4 * jj + 2 * half + 1]);
        }
      }
    }
  }
}

}  // namespace

// Returns 0 on success or the cudaError_t of a refused launch. buf: n
// samples `ld` elements apart (rows of C channels, 16-byte aligned, C % 4
// == 0); window w of sample n reads frames s0 + w*stride .. + frames - 1; wp: the split
// weights (ops/fc1.py::pack_weights_tf32x3 at this `period`, which must be
// 1 unless C % 32 == 0) of K = frames * C rows padded to a multiple of 32
// and n_out columns padded to a multiple of BN; y (n, n_win, n_out) fp32;
// (tile_rows, rows, cols, groups) the schedule (ops/fc1.py::fc1_schedule
// at this instance's tiles); ws: 2 * groups x cols x n*n_win x BN fp32
// (unused when groups == 1). Launches on `stream`, allocates nothing.
extern "C" int fc1_strided_tf32x3_launch(const void* buf, const void* wp, void* y, void* ws, int n, int ld, int C,
                                         int s0, int stride, int n_win, int frames, int n_out, int period,
                                         int tile_rows, int rows, int cols, int groups, void* stream) {
  Params p;
  const cudaError_t bad = make_params(p, buf, wp, ws, n, ld, C, s0, stride, n_win, frames, n_out, period, tile_rows,
                                      rows, cols, groups, 4, KC, BN, TM);
  if (bad != cudaSuccess) return (int)bad;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<float*>(y);
  auto* part = static_cast<float*>(ws);
  const int err = launch_persistent(fc1_strided_tf32x3_kernel, LAUNCH_REGS, SMEM_BYTES,
                                    (unsigned)(groups * rows * cols), THREADS, st, static_cast<const float*>(buf),
                                    static_cast<const float*>(wp), out, part, p, period);
  return err != 0 ? err : launch_partial_sum<float, BN>(part, out, p, st);
}
