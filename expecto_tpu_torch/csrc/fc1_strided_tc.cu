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
// against the 272 MB of weight (and far fewer bytes of windows) at 3.35
// TB/s. The two meet near M = 300; serving and the h5 step call fc1 at M =
// 60-1,135 rows a GEMM, the gene path at 1,600: around the ridge and above
// it. A 128 x 256 tile needs 48 KB from L2 for each 4.2 MFLOP stage, so the
// design keeps the tensor cores fed and the shared data in L2:
//
// - Warp specialization. Warpgroup 0 is the producer (56 registers a thread
//   after setmaxnreg): its 128 threads copy A, one of them B, into a ring
//   of 4 stages with "full" and "empty" mbarriers (a ring of 3 was up to
//   13 % slower at serving shapes). Warpgroups 1 and 2 are the consumers
//   (224 registers): each runs m64n256k16 over 64 rows of the 128-row tile
//   (128 fp32 accumulators a thread).
// - One wgmma group in flight. A consumer issues a stage's 4 wgmma, commits,
//   waits until only that group is pending, and only then releases the
//   previous stage to the producer: the tensor cores never wait on a
//   barrier, a copy or the next issue.
// - A in place, by cp.async. Row m = n*n_win + w of A starts at element
//   n*ld + (s0 + w*stride)*C and is 67,840 contiguous elements long. Each
//   producer thread owns 2 rows and copies 4 16-byte pieces of each a stage
//   (two threads cover one 32-byte sector), zero-filling rows past M and K
//   past 106*C; the copies arrive on the stage's full barrier
//   (cp.async.mbarrier.arrive.noinc). The windows are never copied out. A
//   4-D tensor map of the buffer, (channel, frame % stride, frame / stride,
//   sample), names the same rows without overlapping strides, but its box
//   is rectangular in (window, sample): its tiles would hold whole samples
//   (100 of 128 rows at n_win = 100) and its 64 channels one frame (C % 64
//   == 0 only). PERF.md §6 has what such tiles cost this kernel.
// - B by the copy engine. ops/fc1.py packs W once per weight tensor and
//   period into (Nout/256, K/64, 256, 64): one stage of B is one contiguous
//   32 KB block, which one thread copies with cp.async.bulk, completing on
//   the same full barrier by its byte count. Columns are zero-padded to a
//   multiple of 256 (2,003 -> 2,048).
// - 128-byte swizzle. Both tiles are K-major rows of 128 bytes whose
//   16-byte pieces are stored at piece ^ (row % 8) (the packer does it for
//   B, the producer's addresses for A); the wgmma descriptors name that
//   layout, so the reads of the tensor cores hit 8 banks apart.
// - The windows' frames in an order that reuses them. Window w+1 reads at
//   frame f the frame that window w reads at f + stride. Where C is a
//   multiple of 64 the K chunks are walked by frame in the order r, r+p,
//   r+2p, ... for r = 0 .. p-1 (p = `period`, the stride of the flows): the
//   4 reads of a buffer frame by 4 neighbouring windows come 10 stages
//   apart instead of 250, and hit L2. The packer orders B's chunks the same
//   way; the sum is the same products in another fixed order.
// - A persistent grid with a fixed schedule. `groups` x `rows` x `cols`
//   CTAs, at most as many as the card holds at once. Rows are cut into
//   tiles of `tile_rows` (at most 128; the rest of a tile's 128 rows are
//   zero-filled and never stored). The (column block, K chunk) space, P =
//   (tiles_n / cols) x kt positions, is cut into `groups` equal ranges;
//   group q's CTAs each own one row tile (of `rows`, row tiles rows apart
//   past that) and one column of the block, and walk the range in step: the
//   `rows` CTAs of a column share each B stage in L2, the `cols` CTAs of a
//   row tile each A stage. A range that covers a whole column tile stores
//   bf16 directly; a part of one is written as an fp32 partial tile to slot
//   2q (the range's first column block) or 2q + 1 (its last), and a second
//   kernel sums the parts of each tile in the order of q and rounds to
//   bf16. ops/fc1.py::fc1_schedule derives the schedule from (M, Nout, K,
//   the CTAs the card holds) alone: no atomics and no order that depends on
//   timing, so a shape gives the same bits on every call.
//
// Shared memory: 1 KB of alignment, STAGES x (16 KB of A + 32 KB of B),
// the barriers and the frame order. The ring's primitives, the schedule's
// walk and the second pass are csrc/fc1_common.cuh's, shared with the fp32
// kernels.

#include "fc1_common.cuh"

namespace {

using namespace fc1;

constexpr int TM = 128;                          // rows a tile (2 consumer warpgroups x 64)
constexpr int BN = 256;                          // columns a tile
constexpr int KC = 64;                           // K a stage: one 128-byte row
constexpr int A_BYTES = TM * KC * 2;             // 16,384
constexpr int B_BYTES = BN * KC * 2;             // 32,768
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;   // 49,152
constexpr int STAGES = 4;                        // the ring
constexpr int PRODUCERS = 128;                   // warpgroup 0
constexpr int THREADS = PRODUCERS + 256;         // + two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int ACC = BN / 2;                      // fp32 accumulators a consumer thread
constexpr int PRODUCER_REGS = 56, CONSUMER_REGS = 224;
// registers a thread at launch: the pool setmaxnreg redistributes
constexpr int LAUNCH_REGS = (PRODUCERS * PRODUCER_REGS + (THREADS - PRODUCERS) * CONSUMER_REGS) / THREADS;  // 168

static_assert(LAUNCH_REGS == 168 && LAUNCH_REGS * THREADS <= 65536, "the register split fills one SM");
static_assert(STAGE_BYTES % 1024 == 0 && A_BYTES % 1024 == 0, "swizzled tiles start on 1,024-byte boundaries");

constexpr int SMEM_BYTES = 1024 + STAGES * STAGE_BYTES + 16 * STAGES + 4 * MAX_FRAMES;

// d (64 x 256 fp32, this thread's 128) = (accumulate ? d : 0) + A (64 x 16
// bf16) * B (16 x 256 bf16)
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[ACC], uint64_t da, uint64_t db, int accumulate) {
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
      : "l"(da), "l"(db), "r"(accumulate));
}

__global__ void __launch_bounds__(THREADS, 1)
fc1_strided_tc_kernel(const __nv_bfloat16* __restrict__ buf, const __nv_bfloat16* __restrict__ wp,
                      __nv_bfloat16* __restrict__ y, float* __restrict__ ws, const Params p, int period) {
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
    // producer warpgroup: 128 threads copy A, thread 0 also B
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    const int ra = threadIdx.x >> 1, ha = threadIdx.x & 1;  // rows ra, ra + 64; pieces ha + 2e
    const uint8_t* wbytes = reinterpret_cast<const uint8_t*>(wp);
    int it = 0;
    for (int i = pl.i0; i < p.tiles_m; i += p.rows) {
      const __nv_bfloat16* rowp[2];
      bool row_ok[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ra + 64 * h, m = i * p.tm + r;
        row_ok[h] = r < p.tm && m < p.M;
        rowp[h] = buf + row_offset(p, row_ok[h] ? m : 0);
      }
      for (long long x = pl.start; x < pl.end;) {
        int cb, k0, k1;
        x = segment(p, pl, x, cb, k0, k1);
        const uint8_t* bsrc = wbytes + (size_t)(cb * p.cols + pl.cc) * p.kt * B_BYTES;
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
              const int g = ha + 2 * e, k = koff + 8 * g;
              const bool ok = row_ok[h] && k < p.K;
              cp_async16_or_zero(sa + r * 128 + ((g ^ (r & 7)) << 4), ok ? rowp[h] + k : buf, ok);
            }
          }
          cp_async_arrive(full0 + 8 * s);
          if (threadIdx.x == 0) {
            mbar_expect_tx(full0 + 8 * s, B_BYTES);
            bulk_load(sa + A_BYTES, bsrc + (size_t)j * B_BYTES, B_BYTES, full0 + 8 * s);
          }
        }
      }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    return;
  }

  // consumer warpgroups: cw owns rows 64 cw .. + 63 of each tile
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int cw = warp / 4 - 1;
  float d[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) d[i] = 0.f;
  int it = 0;
  for (int i = pl.i0; i < p.tiles_m; i += p.rows) {
    for (long long x = pl.start; x < pl.end;) {
      const bool first = x == pl.start;
      int cb, k0, k1;
      x = segment(p, pl, x, cb, k0, k1);
      for (int j = k0; j < k1; ++j, ++it) {
        const int s = it % STAGES;
        mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");  // the producers' cp.async, to wgmma
        const uint32_t sa = base + s * STAGE_BYTES;
        fence_acc(d);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KC / 16; ++kk)
          wgmma_m64n256k16(d, sw128_desc(sa + cw * 64 * 128 + 32 * kk), sw128_desc(sa + A_BYTES + 32 * kk),
                           (j > k0) | (kk > 0));
        wgmma_commit();
        wgmma_wait<1>();  // stage it-1's group has read its tiles
        fence_acc(d);
        if (j > k0 && lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));
      }
      wgmma_wait<0>();
      fence_acc(d);
      if (lane == 0) mbar_arrive(empty0 + 8 * ((it - 1) % STAGES));

      // epilogue: accumulator (row, col) of m64nN: row 16 w + lane/4 (+8),
      // col 8 j + 2 (lane % 4) (+1), register 4 j + 2 half + {0, 1}
      const int t = cb * p.cols + pl.cc;
      const bool whole = k0 == 0 && k1 == p.kt;
      const int c_tile = 2 * (lane % 4);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = cw * 64 + (warp % 4) * 16 + lane / 4 + 8 * half, m = i * p.tm + r;
        if (r >= p.tm || m >= p.M) continue;
        if (whole) {
          __nv_bfloat16* yrow = y + (size_t)m * p.n_out + t * BN;
#pragma unroll
          for (int jj = 0; jj < BN / 8; ++jj) {
            const int c = c_tile + 8 * jj;
            if (t * BN + c < p.n_out) yrow[c] = __float2bfloat16(d[4 * jj + 2 * half]);
            if (t * BN + c + 1 < p.n_out) yrow[c + 1] = __float2bfloat16(d[4 * jj + 2 * half + 1]);
          }
        } else {
          float* wrow = ws + (((size_t)(2 * pl.q + (first ? 0 : 1)) * p.cols + pl.cc) * p.M + m) * BN;
#pragma unroll
          for (int jj = 0; jj < BN / 8; ++jj)
            *reinterpret_cast<float2*>(wrow + c_tile + 8 * jj) =
                make_float2(d[4 * jj + 2 * half], d[4 * jj + 2 * half + 1]);
        }
      }
    }
  }
}

}  // namespace

// Returns 0 on success or the cudaError_t of a refused launch. buf: n
// samples `ld` elements apart (rows of C channels, 16-byte aligned, C % 8
// == 0); window w of sample n reads frames s0 + w*stride .. + frames - 1;
// wp: the packed weights (ops/fc1.py::pack_weights_fc1 at this `period`,
// which must be 1 unless C % 64 == 0) of K = frames * C rows padded to a
// multiple of 64 and n_out columns padded to a multiple of 256; y (n,
// n_win, n_out) bf16; (tile_rows, rows, cols, groups) the schedule
// (ops/fc1.py::fc1_schedule); ws: 2 * groups x cols x n*n_win x 256 fp32
// (unused when groups == 1). Launches on `stream`, allocates nothing.
extern "C" int fc1_strided_tc_launch(const void* buf, const void* wp, void* y, void* ws, int n, int ld, int C,
                                     int s0, int stride, int n_win, int frames, int n_out, int period, int tile_rows,
                                     int rows, int cols, int groups, void* stream) {
  Params p;
  const cudaError_t bad = make_params(p, buf, wp, ws, n, ld, C, s0, stride, n_win, frames, n_out, period, tile_rows,
                                      rows, cols, groups, 8, KC, BN, TM);
  if (bad != cudaSuccess) return (int)bad;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<__nv_bfloat16*>(y);
  auto* part = static_cast<float*>(ws);
  const int err = launch_persistent(fc1_strided_tc_kernel, LAUNCH_REGS, SMEM_BYTES, (unsigned)(groups * rows * cols),
                                    THREADS, st, static_cast<const __nv_bfloat16*>(buf),
                                    static_cast<const __nv_bfloat16*>(wp), out, part, p, period);
  return err != 0 ? err : launch_partial_sum<__nv_bfloat16, BN>(part, out, p, st);
}
