// One whole round of gblinear's single-model block coordinate-descent sweep
// in one cooperative launch: the bias step, then for each feature block in
// order the gradient g = Xb @ r, the coordinate update dw = eta *
// coord_delta(g, h, w) (gblinear_cd.cuh), w += dw and r += dw^T Xb.
//
// Xt (n_blocks, B, n) fp32 contiguous (models/gblinear.py::_pad_blocks'
// layout: feature rows zero-padded to a multiple of B), hess (n_blocks, B)
// the column hessians, w (n_blocks, B), bias (1,) and r (n,) updated in
// place; scratch holds the cross-CTA sums. A padded feature row has h = 0,
// so its dw is 0.
//
// Replaces the XLA program of one round of the JAX package:
// expecto_tpu/models/gblinear.py::_round_body (:104-132, jitted at :169),
// the bias step and a lax.scan over block_step (:122-129). There is no
// Pallas kernel there. In plain torch the same round is two cuBLAS GEMVs,
// the coordinate-update kernel and an add a block: 160 launches a round at
// the published 40 blocks, which the host cannot launch as fast as the card
// runs them.
//
// What bounds it on an H100: bytes. X is read once a round at best (1.83 GB
// at 22,296 rows x 40 x 512 features: 0.545 ms at 3.35 TB/s); the products
// are 4 flops a byte of X, far below the fp32 ridge. Design:
//  - a persistent grid of one 1024-thread CTA an SM, launched with
//    cudaLaunchCooperativeKernel (co-residency is then guaranteed, or the
//    launch fails) and synchronised with cooperative_groups' grid.sync();
//  - CTA c owns rows [c n / G, (c + 1) n / G) of r (ops/gblinear_round.py::
//    row_plan) and keeps them in shared memory for the whole round, so a
//    block's residual update needs no sync before the next block's gradient;
//  - per block: (A) the CTA's partial gradient sums of the B features over
//    its rows (below); grid sync;
//    (B) each feature's G partials are summed by one warp in a fixed order
//    (the kernel is deterministic, bit-equal run to run) and its coordinate
//    update written; grid sync; (C) every CTA reads the B updates and
//    advances its rows of r by dw^T Xb. 1 + 2 n_blocks grid syncs a round;
//  - in (A) each warp streams four feature rows over the CTA's rows at a
//    time through registers, and the first rows of the CTA's slice of Xb
//    that fit in shared memory (about 290 of 512 at the published shape)
//    are kept there for (C); the others are read last in (A) and again in
//    (C), which the 50 MB L2 may still hold. Loads are 4 bytes a lane (an
//    odd n leaves a row unaligned; TMA or 16-byte loads would need 16-byte
//    row strides), coalesced along the rows;
//  - two shared-memory plans, picked by `plan` from n, B and the device's
//    SMs and opt-in: "shared" above, while a CTA's rows of r and their
//    per-group sums fit (up to 3,799,356 rows at B = 512 on an H100), else
//    "streamed" (STREAM = true): each CTA advances its rows of r in place in
//    global memory, no row of Xb is cached, and (C) sums a column's
//    features in one group, so only dw and the warp sums stay in shared
//    memory and any n below 2^31 launches. X is then read twice a round
//    and r's slice goes through L2.
//
// fp32 throughout: the products are fp32 FFMA (no tensor-core instruction),
// summed in another order than cuBLAS's or the CPU's, so the round agrees
// with the plain version (ops/gblinear_round.py::gblinear_round_plain)
// within stated tolerances, not bit for bit; the coordinate step itself is
// gblinear_cd.cuh's, which rounds as the plain version does.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "gblinear_cd.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int CTAS_PER_SM = 1;
constexpr int GRAD_ROWS = 4;  // feature rows a warp streams at once in (A)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__host__ __device__ __forceinline__ int row_lo(int cta, int ctas, int n) {
  return static_cast<int>(static_cast<long long>(cta) * n / ctas);
}

// floats of shared memory besides the Xb cache in the "shared" plan: r's
// slice, the block's dw, the residual's per-group sums and the warp sums (+ db)
__host__ __device__ __forceinline__ long long base_floats(int len_max, int B) {
  return len_max + B + (len_max > THREADS ? len_max : THREADS) + WARPS + 1LL;
}

// floats of shared memory in the "streamed" plan: the block's dw and the
// warp sums (+ db)
__host__ __device__ __forceinline__ long long streamed_floats(int B) { return B + WARPS + 1LL; }

template <bool STREAM>
__global__ void __launch_bounds__(THREADS, CTAS_PER_SM)
    gblinear_round_kernel(const float* __restrict__ Xt, const float* __restrict__ hess, float* __restrict__ w,
                          float* __restrict__ bias, float* __restrict__ r, float* __restrict__ scratch, int n_blocks,
                          int B, int n, int cache_rows, float denom, float eta, float lam, float alpha) {
  cg::grid_group grid = cg::this_grid();
  const int G = gridDim.x, cta = blockIdx.x;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int lo = row_lo(cta, G, n), len = row_lo(cta + 1, G, n) - lo;
  const int len_max = static_cast<int>((static_cast<long long>(n) + G - 1) / G);

  extern __shared__ float smem[];
  float* r_s = STREAM ? r + lo : smem;              // [len_max]; r itself when streamed
  float* dw_s = STREAM ? smem : r_s + len_max;      // [B]
  float* red = dw_s + B;                            // [max(THREADS, len_max)]; not when streamed
  float* wsum = STREAM ? red : red + (len_max > THREADS ? len_max : THREADS);  // [WARPS + 1]
  float* cache = wsum + WARPS + 1;                  // [cache_rows][len]; cache_rows = 0 when streamed

  float* part = scratch;                          // [G][B] partial gradients
  float* bias_part = part + (size_t)G * B;        // [G] partial sums of r
  float* dw_g = bias_part + G;                    // [B] the block's updates

  if (!STREAM) {
    for (int c = threadIdx.x; c < len; c += THREADS) r_s[c] = r[lo + c];
    __syncthreads();
  }

  // bias step: db = eta * (-sum(r) / denom), bias += db, r += db
  {
    float v = 0.0f;
    for (int c = threadIdx.x; c < len; c += THREADS) v += r_s[c];
    v = warp_sum(v);
    if (lane == 0) wsum[warp] = v;
    __syncthreads();
    if (warp == 0) {
      const float s = warp_sum(wsum[lane]);
      if (lane == 0) bias_part[cta] = s;
    }
    grid.sync();
    if (warp == 0) {
      float s = 0.0f;
      for (int p = lane; p < G; p += 32) s += __ldcg(bias_part + p);
      s = warp_sum(s);
      if (lane == 0) {
        const float db = __fmul_rn(eta, __fdiv_rn(-s, denom));
        wsum[WARPS] = db;
        if (cta == 0) bias[0] = __fadd_rn(bias[0], db);
      }
    }
    __syncthreads();
    const float db = wsum[WARPS];
    for (int c = threadIdx.x; c < len; c += THREADS) r_s[c] = __fadd_rn(r_s[c], db);
    __syncthreads();
  }

  const int tiles = (len + 31) / 32;
  const int groups = STREAM || !tiles ? 1 : (WARPS / tiles > 1 ? WARPS / tiles : 1);
  for (int b = 0; b < n_blocks; ++b) {
    const float* Xb = Xt + (size_t)b * B * n + lo;

    // (A) partial gradients over this CTA's rows, four feature rows a warp at
    // a time; the first cache_rows rows are kept in shared memory for (C)
    for (int j0 = warp * GRAD_ROWS; j0 < B; j0 += WARPS * GRAD_ROWS) {
      const float* rows[GRAD_ROWS];
      float acc[GRAD_ROWS];
#pragma unroll
      for (int u = 0; u < GRAD_ROWS; ++u) {
        rows[u] = Xb + (size_t)(j0 + u < B ? j0 + u : B - 1) * n;  // a row past B is read and dropped
        acc[u] = 0.0f;
      }
#pragma unroll 4  // 16 loads a lane in flight (scripts/probe_gblinear_round.py times 2 and 6)
      for (int c = lane; c < len; c += 32) {
        const float rv = r_s[c];
#pragma unroll
        for (int u = 0; u < GRAD_ROWS; ++u) {
          const float x = rows[u][c];
          if (j0 + u < cache_rows) cache[(j0 + u) * len + c] = x;
          acc[u] = fmaf(x, rv, acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < GRAD_ROWS; ++u) {
        const float s = warp_sum(acc[u]);
        if (lane == 0 && j0 + u < B) part[(size_t)cta * B + j0 + u] = s;
      }
    }
    grid.sync();

    // (B) each feature's gradient, summed over the CTAs in order, and its update
    for (int j = warp * G + cta; j < B; j += WARPS * G) {
      const size_t k = (size_t)b * B + j;
      const float wv = w[k], hv = hess[k];
      float s = 0.0f;
      for (int p = lane; p < G; p += 32) s += __ldcg(part + (size_t)p * B + j);
      s = warp_sum(s);
      if (lane == 0) {
        const float d = gblinear::coord_step(s, hv, wv, eta, lam, alpha);
        w[k] = __fadd_rn(wv, d);
        dw_g[j] = d;
      }
    }
    grid.sync();

    // (C) r += dw^T Xb over this CTA's rows: each column tile's features
    // split into `groups` strided groups, their sums added in group order
    // (streamed: one group, added to r at once)
    for (int j = threadIdx.x; j < B; j += THREADS) dw_s[j] = __ldcg(dw_g + j);
    __syncthreads();
    for (int item = warp; item < tiles * groups; item += WARPS) {
      const int c = (item % tiles) * 32 + lane, jg = item / tiles;
      if (c < len) {
        float acc = 0.0f;
        int j = jg;
        for (; j < cache_rows; j += groups) acc = fmaf(dw_s[j], cache[j * len + c], acc);
        const float* col = Xb + c;
#pragma unroll 8
        for (; j < B; j += groups) acc = fmaf(dw_s[j], col[(size_t)j * n], acc);
        if (STREAM)
          r_s[c] = __fadd_rn(r_s[c], acc);
        else
          red[jg * len + c] = acc;
      }
    }
    __syncthreads();
    if (!STREAM) {
      for (int c = threadIdx.x; c < len; c += THREADS) {
        float s = red[c];
        for (int jg = 1; jg < groups; ++jg) s += red[jg * len + c];
        r_s[c] = __fadd_rn(r_s[c], s);
      }
      __syncthreads();
    }
  }

  if (!STREAM)
    for (int c = threadIdx.x; c < len; c += THREADS) r[lo + c] = r_s[c];
}

// The grid's size, its dynamic shared memory, the cached rows of Xb and
// whether the "streamed" plan runs, for n rows and blocks of B features on
// the current device; a CUDA error if the device cannot launch it
// cooperatively.
cudaError_t plan(int n, int B, int* ctas, size_t* smem, int* cache_rows, bool* streamed) {
  int dev, sms, coop, optin;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  // one CTA an SM: the occupancy query at that CTA's shared memory decides
  // whether it fits, and the grid is that many CTAs an SM (at most one)
  const int G = sms * CTAS_PER_SM;
  const int len_max = static_cast<int>((static_cast<long long>(n) + G - 1) / G);
  const long long base = 4LL * base_floats(len_max, B);
  *streamed = base > optin;
  if (*streamed) {
    *cache_rows = 0;
    *smem = static_cast<size_t>(4LL * streamed_floats(B));
    if (static_cast<long long>(*smem) > optin) return cudaErrorInvalidValue;
  } else {
    const long long rows = len_max ? (optin - base) / (4LL * len_max) : B;
    *cache_rows = static_cast<int>(rows < B ? rows : B);
    *smem = static_cast<size_t>(base + 4LL * *cache_rows * len_max);
  }
  const void* fn = *streamed ? reinterpret_cast<const void*>(gblinear_round_kernel<true>)
                             : reinterpret_cast<const void*>(gblinear_round_kernel<false>);
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(*smem));
  if (err != cudaSuccess) return err;
  int occ = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, THREADS, *smem);
  if (err != cudaSuccess) return err;
  if (occ < 1) return cudaErrorCooperativeLaunchTooLarge;
  *ctas = sms * (occ < CTAS_PER_SM ? occ : CTAS_PER_SM);
  return cudaSuccess;
}

}  // namespace

// The number of CTAs the kernel's grid takes for n rows and blocks of B
// features on the current device, or minus the CUDA error.
extern "C" int gblinear_round_ctas(int n, int B) {
  if (n <= 0 || B <= 0) return -(int)cudaErrorInvalidValue;
  int ctas, cache_rows;
  size_t smem;
  bool streamed;
  const cudaError_t err = plan(n, B, &ctas, &smem, &cache_rows, &streamed);
  return err == cudaSuccess ? ctas : -(int)err;
}

// 1 if the kernel runs n rows and blocks of B features on the current device
// in its "streamed" plan (r's rows in global memory), 0 in its "shared"
// plan, or minus the CUDA error.
extern "C" int gblinear_round_streamed(int n, int B) {
  if (n <= 0 || B <= 0) return -(int)cudaErrorInvalidValue;
  int ctas, cache_rows;
  size_t smem;
  bool streamed;
  const cudaError_t err = plan(n, B, &ctas, &smem, &cache_rows, &streamed);
  return err == cudaSuccess ? (int)streamed : -(int)err;
}

// The dynamic shared memory of one CTA of the kernel (bytes) for n rows and
// blocks of B features on the current device, or minus the CUDA error.
extern "C" int gblinear_round_smem(int n, int B) {
  if (n <= 0 || B <= 0) return -(int)cudaErrorInvalidValue;
  int ctas, cache_rows;
  size_t smem;
  bool streamed;
  const cudaError_t err = plan(n, B, &ctas, &smem, &cache_rows, &streamed);
  return err == cudaSuccess ? static_cast<int>(smem) : -(int)err;
}

// Xt (n_blocks, B, n), hess (n_blocks, B), w (n_blocks, B), bias (1,), r (n,)
// fp32 contiguous (w, bias and r updated in place); scratch at least
// ctas * (B + 1) + B floats, ctas as gblinear_round_ctas returns it. Launches
// one round on `stream`, allocates nothing, and returns the CUDA error of
// the launch (0 on success).
extern "C" int gblinear_round_launch(const void* Xt, const void* hess, void* w, void* bias, void* r, void* scratch,
                                     int n_blocks, int B, int n, int ctas, float denom, float eta, float lam,
                                     float alpha, void* stream) {
  if (n <= 0 || B <= 0 || n_blocks <= 0) return (int)cudaErrorInvalidValue;
  int want, cache_rows;
  size_t smem;
  bool streamed;
  cudaError_t err = plan(n, B, &want, &smem, &cache_rows, &streamed);
  if (err != cudaSuccess) return (int)err;
  if (ctas != want) return (int)cudaErrorInvalidConfiguration;
  const float* xt = static_cast<const float*>(Xt);
  const float* h = static_cast<const float*>(hess);
  float *wp = static_cast<float*>(w), *bp = static_cast<float*>(bias), *rp = static_cast<float*>(r);
  float* sp = static_cast<float*>(scratch);
  void* args[] = {&xt, &h, &wp, &bp, &rp, &sp, &n_blocks, &B, &n, &cache_rows, &denom, &eta, &lam, &alpha};
  const void* fn = streamed ? reinterpret_cast<const void*>(gblinear_round_kernel<true>)
                            : reinterpret_cast<const void*>(gblinear_round_kernel<false>);
  err = cudaLaunchCooperativeKernel(fn, dim3(ctas), dim3(THREADS), args, smem, static_cast<cudaStream_t>(stream));
  return (int)err;
}
