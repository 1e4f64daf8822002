// Beluga's conv0 over int8 base codes: a table gather-sum, with no one-hot.
//
//   y[n, l, c] = relu( b[c] + sum_{k<8} W0[k, code[n, l+k], c] )
//
// codes (N, L) int8, W0 (8, 4, Cout) and b (Cout) in fp32 or bf16 -> y
// (N, L-7, Cout) in the weights' dtype, all contiguous, channels last. A code
// outside 0..3 (N is 4) adds nothing, as jax.nn.one_hot gives it a zero row.
// The sum is taken in fp32, then the bias is added, ReLU applied and the
// result rounded once to the output dtype.
//
// Replaces the TPU kernel expecto_tpu/ops/pallas_conv.py::conv8_relu on the
// only input Beluga's conv0 ever sees, the one-hot of base codes: on it the
// product with W0 is a table lookup, so the kernel reads the codes and no
// float one-hot tensor is built.
//
// What bounds it on an H100: bytes. It does 8 additions per output element
// and writes 2 (bf16) or 4 (fp32) bytes of it; the codes it reads are a
// 640th of that at Cout 320 in bf16. The least time is the output write at
// the card's memory rate, and the design keeps every other cost under it:
//
// - Pair tables. The 8 taps are taken in pairs: row 5a + b of pair table j
//   holds W0[2j, a] + W0[2j+1, b] in fp32, with code index 4 (any code
//   outside 0..3) the zero row. An output is then 4 table reads, not 8: 16
//   bytes of shared memory per output element, which shared memory's 128
//   bytes a clock per SM serves faster than the store stream can take the
//   results. The 4 x 25 rows (128 KB at Cout 320) are built once per block.
// - A persistent grid, one block per SM. Each block owns one contiguous
//   range of flat code positions q = n * L + l and walks it in tiles, so the
//   tables are built 132 times, not once per tile, and the blocks' shares
//   differ by less than 16 positions. Flat position q is the conv over the
//   codes taken as one (N * L) sequence; it is kept where l < L - 7, which
//   also makes a row's start alignment irrelevant.
// - Codes staged with 16-byte loads. A tile's codes are one contiguous byte
//   range. Tiles start at multiples of 16 positions, so on a 16-byte-aligned
//   tensor every load but the buffer's last is one aligned 16-byte load,
//   issued a tile ahead into a register; a misaligned base or the buffer's
//   end takes byte loads for the partial 16 bytes. One pass then packs each
//   position's four pair-row indices into a 32-bit word.
// - Coalesced 16-byte stores. A thread owns one group of 8 output channels
//   and walks positions; neighbouring threads take neighbouring groups of
//   one position, so each store instruction of a warp writes 512 contiguous
//   bytes. In bf16 a group is 8 consecutive channels, one 16-byte store; in
//   fp32 it is two 4-channel quads G groups apart, two 16-byte stores. A
//   table row is laid out as two planes of one quad per group, so the 8
//   threads of a 128-byte shared-memory phase read 8 consecutive 16-byte
//   words: no bank conflicts at Cout 320.
// - No tensor cores, TMA or wgmma: there is no product to feed them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int KW = 8;               // conv width
constexpr int PAIRS = KW / 2;       // taps are looked up in pairs
constexpr int ROWS = 25;            // 5 x 5 code indices a pair, index 4 the zero row
constexpr int MAX_THREADS = 1024;
constexpr int MAX_COUT = 512;       // 128 * 25 * Cout bytes of tables must fit in shared memory
constexpr int POS_PER_THREAD = 16;  // positions a thread takes per tile
constexpr int MAX_POSITIONS = INT_MAX - (1 << 16);  // N * L: flat positions and load offsets stay ints

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// code -> table index: 0..3 are bases, everything else (N = 4, -1, 5, ...) is 4
__device__ __forceinline__ int code_index(int c) { return (unsigned)c < 4u ? c : 4; }

// Bytes [lo, lo + 16) of the codes after flat position q0, as 16 bytes; bytes
// outside the buffer [0, total) read as code 4. lo is such that codes + q0 + lo
// is 16-byte aligned.
__device__ __forceinline__ int4 load_chunk(const int8_t* __restrict__ codes, int q0, int lo, int total) {
  if (lo >= 0 && q0 + lo + 16 <= total) return __ldg(reinterpret_cast<const int4*>(codes + q0 + lo));
  uint32_t v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[k] = 0;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int q = q0 + lo + 4 * k + m;
      const uint32_t byte = (q >= q0 && q < total) ? (uint32_t)(uint8_t)codes[q] : 4u;
      v[k] |= byte << (8 * m);
    }
  }
  return make_int4((int)v[0], (int)v[1], (int)v[2], (int)v[3]);
}

// Channel i of half h of thread group g (G groups). A bf16 thread owns 8
// consecutive channels, one 16-byte store; an fp32 thread owns the 4-channel
// quads g and g + G, two 16-byte stores that each run contiguous across
// neighbouring threads (8 consecutive fp32 channels would leave each store
// instruction writing half of every 32-byte sector it touches).
template <typename T>
__device__ __forceinline__ int channel_of(int g, int h, int i, int G) {
  return sizeof(T) == 2 ? 8 * g + 4 * h + i : 4 * (g + h * G) + i;
}

__device__ __forceinline__ void store_group(float* row, const float (&v)[8], int g, int G, int Cout, bool vec) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c0 = channel_of<float>(g, h, 0, G);
    if (vec) {
      *reinterpret_cast<float4*>(row + c0) = make_float4(v[4 * h], v[4 * h + 1], v[4 * h + 2], v[4 * h + 3]);
    } else {
      for (int i = 0; i < 4; ++i)
        if (c0 + i < Cout) row[c0 + i] = v[4 * h + i];
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

__device__ __forceinline__ void store_group(__nv_bfloat16* row, const float (&v)[8], int g, int G, int Cout,
                                            bool vec) {
  __nv_bfloat16* dst = row + channel_of<__nv_bfloat16>(g, 0, 0, G);
  if (vec) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]),
                                                pack_bf16x2(v[4], v[5]), pack_bf16x2(v[6], v[7]));
  } else {
    for (int i = 0; i < 8; ++i)
      if (8 * g + i < Cout) dst[i] = __float2bfloat16(v[i]);
  }
}

// Block layout: G = ceil(Cout / 8) channel groups x P position lanes. Thread
// (g, p) = (tid % G, tid / G) computes the 8 channels of group g
// (channel_of) at tile positions p, p + P, ... Shared memory: the pair
// tables [PAIRS][ROWS][2][G] float4, entry (h, g) holding channels
// channel_of(g, h, 0..3); then per tile position a word of four pair-row
// indices and the output row (-1 where the window straddles two sequences);
// then the codes.
template <typename T>
__global__ void __launch_bounds__(MAX_THREADS, 1)
conv0_codes_kernel(const int8_t* __restrict__ codes, const T* __restrict__ w, const T* __restrict__ b,
                   T* __restrict__ y, int L, int Cout, int G, int P, int TL, int total, int per_block) {
  extern __shared__ float4 smem[];
  float4* tab = smem;
  uint32_t* words = reinterpret_cast<uint32_t*>(tab + PAIRS * ROWS * 2 * G);
  int* out_row = reinterpret_cast<int*>(words + TL);
  int8_t* cs = reinterpret_cast<int8_t*>(out_row + TL);  // 16-byte aligned: TL is a multiple of 16

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int g = tid % G;
  const int lane_p = tid / G;
  const int l_out = L - KW + 1;
  const int q_begin = blockIdx.x * per_block;
  const int q_end = min(total, q_begin + per_block);

  // the first tile's codes are in flight while the tables are built
  int4 pre = make_int4(0, 0, 0, 0);
  if (q_begin < q_end && tid < P)
    pre = load_chunk(codes, q_begin, 16 * tid - (int)((uintptr_t)(codes + q_begin) & 15), total);

  // pair tables: work item (pair j, channel c) loads its 8 weights and
  // writes its 25 rows, at entry (h, g) = hg of channel_of's inverse
  float* tabf = reinterpret_cast<float*>(tab);
  for (int e = tid; e < PAIRS * 8 * G; e += nthreads) {
    const int c = e % (8 * G), j = e / (8 * G), i = c & 3;
    const int hg = sizeof(T) == 2 ? ((c >> 2) & 1) * G + (c >> 3) : c >> 2;
    float wa[5], wb[5];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      wa[a] = c < Cout ? to_f32(w[((2 * j) * 4 + a) * Cout + c]) : 0.f;
      wb[a] = c < Cout ? to_f32(w[((2 * j + 1) * 4 + a) * Cout + c]) : 0.f;
    }
    wa[4] = wb[4] = 0.f;
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      tabf[(((j * ROWS + r) * 2 * G + hg) << 2) + i] = wa[r / 5] + wb[r % 5];
  }

  float bias[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int c = channel_of<T>(g, k / 4, k % 4, G);
    bias[k] = c < Cout ? to_f32(b[c]) : 0.f;
  }
  const bool vec = Cout % 8 == 0;
  const float4* col = tab + g;

  for (int q0 = q_begin; q0 < q_end; q0 += TL) {
    const int cnt = min(TL, q_end - q0);
    const int mis = (int)((uintptr_t)(codes + q0) & 15);
    const int n_chunks = (mis + cnt + KW - 1 + 15) >> 4;  // <= P <= nthreads (TL = 16 P - 32)
    if (tid < n_chunks) reinterpret_cast<int4*>(cs)[tid] = pre;
    __syncthreads();  // codes staged (and, on the first tile, the tables built)

    for (int i = tid; i < cnt; i += nthreads) {
      const int8_t* s = cs + mis + i;
      uint32_t wd = 0;
#pragma unroll
      for (int j = 0; j < PAIRS; ++j)
        wd |= (uint32_t)(5 * code_index(s[2 * j]) + code_index(s[2 * j + 1])) << (8 * j);
      words[i] = wd;
      const int q = q0 + i, n = q / L, l = q - n * L;
      out_row[i] = l < l_out ? n * l_out + l : -1;
    }

    const int qn = q0 + TL;
    if (qn < q_end && tid < P)
      pre = load_chunk(codes, qn, 16 * tid - (int)((uintptr_t)(codes + qn) & 15), total);
    __syncthreads();  // words and rows ready

    for (int i = lane_p; i < cnt; i += P) {
      const int o = out_row[i];
      if (o < 0) continue;
      const uint32_t wd = words[i];
      float acc[8];
#pragma unroll
      for (int j = 0; j < PAIRS; ++j) {
        const float4* t = col + (j * ROWS + ((wd >> (8 * j)) & 0xff)) * 2 * G;
        const float4 lo = t[0], hi = t[G];
        if (j == 0) {
          acc[0] = lo.x; acc[1] = lo.y; acc[2] = lo.z; acc[3] = lo.w;
          acc[4] = hi.x; acc[5] = hi.y; acc[6] = hi.z; acc[7] = hi.w;
        } else {
          acc[0] += lo.x; acc[1] += lo.y; acc[2] += lo.z; acc[3] += lo.w;
          acc[4] += hi.x; acc[5] += hi.y; acc[6] += hi.z; acc[7] += hi.w;
        }
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) acc[k] = fmaxf(acc[k] + bias[k], 0.f);
      store_group(y + (size_t)o * Cout, acc, g, G, Cout, vec);
    }
    __syncthreads();  // the next tile overwrites the codes, words and rows
  }
}

template <typename T>
int launch(const int8_t* codes, const T* w, const T* b, T* y, int n, int L, int Cout, cudaStream_t s) {
  const int G = (Cout + 7) / 8;
  const int P = MAX_THREADS / G;
  const int TL = POS_PER_THREAD * P - 32;  // a tile's codes fit in P 16-byte chunks
  const int total = n * L;
  const size_t smem = sizeof(float4) * PAIRS * ROWS * 2 * G + 8 * (size_t)TL + 16 * (size_t)P;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(conv0_codes_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // one block per SM, each a contiguous range of a multiple of 16 positions
  int per_block = (total + sms - 1) / sms;
  per_block = (per_block + 15) / 16 * 16;
  const int grid = (total + per_block - 1) / per_block;
  conv0_codes_kernel<T><<<grid, G * P, smem, s>>>(codes, w, b, y, L, Cout, G, P, TL, total, per_block);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16 (W, b and y). Launches on `stream`, allocates
// nothing, and returns the CUDA error of the launch (0 on success).
extern "C" int conv0_codes_launch(const void* codes, const void* w, const void* b, void* y, int n, int L,
                                  int Cout, int dtype, void* stream) {
  if (n <= 0 || L < KW || Cout <= 0 || Cout > MAX_COUT || (long long)n * L > MAX_POSITIONS)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* c = static_cast<const int8_t*>(codes);
  if (dtype == 0)
    return launch(c, static_cast<const float*>(w), static_cast<const float*>(b), static_cast<float*>(y), n, L,
                  Cout, s);
  if (dtype == 1)
    return launch(c, static_cast<const __nv_bfloat16*>(w), static_cast<const __nv_bfloat16*>(b),
                  static_cast<__nv_bfloat16*>(y), n, L, Cout, s);
  return (int)cudaErrorInvalidValue;
}
