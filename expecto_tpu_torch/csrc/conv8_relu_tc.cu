// Width-8 valid 1-D convolution + bias + ReLU in bf16 on Hopper's tensor
// cores (wgmma), for the Beluga layers whose Cin is a multiple of 16.
//
//   y[n, l, co] = relu( sum_{k<8, ci<Cin} x[n, l+k, ci] * W[k, ci, co] + b[co] )
//
// x (N, L, Cin) bf16, W (8, Cin, Cout) bf16 packed by ops/conv8.py (below),
// b (Cout) bf16 -> y (N, L-7, Cout) bf16, channels last. The sum is fp32 in
// registers; the epilogue fuses bias, ReLU and the bf16 cast.
//
// Replaces the TPU kernel expecto_tpu/ops/pallas_conv.py::conv8_relu for
// bf16 with Cin % 16 == 0 (conv1-conv5 of Beluga). fp32 and conv0 (Cin = 4)
// stay on the SIMT kernel csrc/conv8_relu.cu.
//
// What bounds it on an H100: 2 * 8 * Cin = 5,120 to 10,240 operations per
// output element, against about 295 operations per byte at the ridge of the
// bf16 tensor cores (989 TFLOP/s) and device memory (3.35 TB/s): the work is
// bound by operations. The design puts every multiply-add on the tensor
// cores and keeps the loads off the threads that issue them:
//
// - Flat rows. x is read as one (N*L, Cin) matrix, which it already is in
//   memory. A valid width-8 conv over the concatenation equals the per-span
//   conv at every flat row m = n*L + l with l < L-7; the 7 rows per span that
//   straddle two spans are computed and never stored. The GEMM is
//   M = N*L, N = Cout, K = 8*Cin, and a tile of TM = 128 rows is as full at a
//   26-row patch sub-span as at a 3,593-row span.
// - wgmma, A and B from shared memory. The 8 taps are 8 K-slices that read
//   one A halo tile (TM + 7 rows x 16 channels) shifted by k rows. A tile is
//   kept in the no-swizzle ("interleave") K-major layout: each 8-channel
//   group is a column of 16-byte rows, so a shift of k rows moves the wgmma
//   descriptor's start address by 16k bytes and stays legal; no swizzle has
//   to be undone by hand. B is the same layout: ops/conv8.py packs W once per
//   weight tensor into (Cout/160, Cin/16, 8 taps, 2 groups, 160, 8), K-major,
//   zero-padded to a multiple of 160 output channels, so one stage of B is one
//   contiguous 40 KB block.
// - TMA and a ring of mbarriers. A producer warp issues, per stage, two 2-D
//   tensor copies of the A halo (one per 8-channel group; rows past N*L read
//   as zeros) and one bulk copy of the B block, all completing on the
//   stage's "full" barrier; the two consumer warpgroups release a stage
//   through its "empty" barrier. Four stages are in flight.
// - Tiles. A block owns 128 rows x 160 output channels: each of its two
//   consumer warpgroups runs m64n160k16 over 64 rows (80 fp32 accumulators a
//   thread). 160 divides Beluga's 320, 480 and 640; another Cout is padded in
//   the packed weights and masked at the store.
//
// Shared memory: 4 stages x (4,352 B of A + 40,960 B of B) + barriers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KW = 8;        // conv width
constexpr int TM = 128;      // flat rows per block (2 warpgroups x 64)
constexpr int BN = 160;      // output channels per block
constexpr int KC = 16;       // input channels per stage (one k16 step a tap)
constexpr int HALO = 136;    // A rows per stage: TM + KW - 1, rounded up to 8
constexpr int STAGES = 4;
constexpr int A_GROUP_BYTES = HALO * 16;            // one 8-channel column
constexpr int A_BYTES = 2 * A_GROUP_BYTES;          // 4,352
constexpr int B_GROUP_BYTES = BN * 16;              // one 8-channel column
constexpr int B_TAP_BYTES = 2 * B_GROUP_BYTES;      // 5,120
constexpr int B_BYTES = KW * B_TAP_BYTES;           // 40,960
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;      // 45,312
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 2 * STAGES * 8;
constexpr int CONSUMER_THREADS = 256;               // warps 0-7: two warpgroups
constexpr int THREADS = CONSUMER_THREADS + 32;      // warp 8: the producer
constexpr int ACC = BN / 2;                         // fp32 accumulators a thread

static_assert(A_GROUP_BYTES % 128 == 0 && STAGE_BYTES % 128 == 0, "TMA needs 128-byte aligned boxes");

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

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
               ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// wgmma shared-memory descriptor, no swizzle, K-major: `lbo` is the byte
// stride between the two 8-element K columns of a k16 slice, `sbo` the byte
// stride between 8-row groups along M (or N).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wgmma_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory"); }

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma that owns them.
__device__ __forceinline__ void fence_acc(float (&d)[ACC]) {
#pragma unroll
  for (int i = 0; i < ACC; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 160 fp32, this thread's 80) += A (64 x 16 bf16) * B (16 x 160 bf16)
__device__ __forceinline__ void wgmma_m64n160k16(float (&d)[ACC], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %82, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
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
      "%72, %73, %74, %75, %76, %77, %78, %79"
      "}, %80, %81, p, 1, 1, 0, 0;\n"
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
      : "l"(da), "l"(db), "r"(1));
}

__global__ void __launch_bounds__(THREADS, 1)
conv8_relu_tc_kernel(const __grid_constant__ CUtensorMap xmap, const __nv_bfloat16* __restrict__ wp,
                     const __nv_bfloat16* __restrict__ b, __nv_bfloat16* __restrict__ y, int M, int L, int Cin,
                     int Cout) {
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t base = smem_addr(smem);
  const uint32_t full0 = base + STAGES * STAGE_BYTES;  // STAGES "full" barriers, then STAGES "empty"
  const uint32_t empty0 = full0 + STAGES * 8;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int m0 = blockIdx.x * TM;
  const int kt = Cin / KC;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);                       // the producer's expect_tx
      mbar_init(empty0 + 8 * s, CONSUMER_THREADS / 32);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_THREADS / 32) {
    // producer: one thread keeps the ring full
    if (lane == 0) {
      const uint8_t* wsrc = reinterpret_cast<const uint8_t*>(wp) + (size_t)blockIdx.y * kt * B_BYTES;
      for (int it = 0; it < kt; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(empty0 + 8 * s, ((it / STAGES) + 1) & 1);
        const uint32_t full = full0 + 8 * s, dst = base + s * STAGE_BYTES;
        mbar_expect_tx(full, STAGE_BYTES);
        tma_load_2d(dst, &xmap, full, it * KC, m0);
        tma_load_2d(dst + A_GROUP_BYTES, &xmap, full, it * KC + 8, m0);
        bulk_load(dst + A_BYTES, wsrc + (size_t)it * B_BYTES, B_BYTES, full);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns flat rows m0 + 64 wg .. + 63
  const int wg = warp / 4;
  float d[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) d[i] = 0.f;

  for (int it = 0; it < kt; ++it) {
    const int s = it % STAGES;
    mbar_wait(full0 + 8 * s, (it / STAGES) & 1);
    const uint32_t a = base + s * STAGE_BYTES + wg * 64 * 16;
    const uint32_t bb = base + s * STAGE_BYTES + A_BYTES;
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < KW; ++k)
      wgmma_m64n160k16(d, smem_desc(a + k * 16, A_GROUP_BYTES, 128), smem_desc(bb + k * B_TAP_BYTES, B_GROUP_BYTES, 128));
    wgmma_commit();
    wgmma_wait_all();
    fence_acc(d);
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
  }

  // epilogue: accumulator (row, col) of m64nN: row 16 w + lane/4 (+8), col
  // 8 j + 2 (lane % 4) (+1), register 4 j + 2 half + {0, 1}
  const int l_out = L - KW + 1;
  const int c_base = blockIdx.y * BN + 2 * (lane % 4);
  const bool pairs = (Cout % 2) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int m = m0 + wg * 64 + (warp % 4) * 16 + lane / 4 + 8 * half;
    if (m >= M) continue;
    const int n = m / L, l = m - n * L;
    if (l >= l_out) continue;  // straddles two spans
    __nv_bfloat16* yrow = y + ((size_t)n * l_out + l) * Cout;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = c_base + 8 * j;
      const float v0 = d[4 * j + 2 * half], v1 = d[4 * j + 2 * half + 1];
      if (pairs && c + 1 < Cout) {
        const float b0 = __bfloat162float(b[c]), b1 = __bfloat162float(b[c + 1]);
        *reinterpret_cast<__nv_bfloat162*>(yrow + c) = __floats2bfloat162_rn(fmaxf(v0 + b0, 0.f), fmaxf(v1 + b1, 0.f));
      } else {
        if (c < Cout) yrow[c] = __float2bfloat16(fmaxf(v0 + __bfloat162float(b[c]), 0.f));
        if (c + 1 < Cout) yrow[c + 1] = __float2bfloat16(fmaxf(v1 + __bfloat162float(b[c + 1]), 0.f));
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API call: reach it through the runtime
// so that the library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

}  // namespace

// Returns 0 on success, a cudaError_t of the launch, or 10000 + the CUresult
// of a failed tensor-map encoding. x (n, L, Cin) bf16 16-byte aligned with
// Cin % 16 == 0; wp the packed weights (ops/conv8.py::pack_weights_tc); b
// (Cout) bf16; y (n, L-7, Cout) bf16. Launches on `stream`, allocates
// nothing.
extern "C" int conv8_relu_tc_launch(const void* x, const void* wp, const void* b, void* y, int n, int L, int Cin,
                                    int Cout, void* stream) {
  const long long m = (long long)n * L;
  if (n <= 0 || L < KW || Cin <= 0 || Cin % KC != 0 || Cout <= 0 || m > 0x7fffffffLL ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 || reinterpret_cast<uintptr_t>(wp) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;

  CUtensorMap xmap;
  const cuuint64_t dims[2] = {(cuuint64_t)Cin, (cuuint64_t)m};
  const cuuint64_t strides[1] = {(cuuint64_t)Cin * sizeof(__nv_bfloat16)};
  const cuuint32_t box[2] = {8, HALO};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUresult cr = encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims, strides, box,
                             elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (cr != CUDA_SUCCESS) return 10000 + (int)cr;

  cudaError_t err = cudaFuncSetAttribute(conv8_relu_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((m + TM - 1) / TM), (unsigned)((Cout + BN - 1) / BN));
  conv8_relu_tc_kernel<<<grid, THREADS, SMEM_BYTES, static_cast<cudaStream_t>(stream)>>>(
      xmap, static_cast<const __nv_bfloat16*>(wp), static_cast<const __nv_bfloat16*>(b),
      static_cast<__nv_bfloat16*>(y), (int)m, L, Cin, Cout);
  return (int)cudaGetLastError();
}
