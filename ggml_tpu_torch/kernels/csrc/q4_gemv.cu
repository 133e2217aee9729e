// int8 GEMV over packed-nibble planes with multiplied-out group scales, for
// 1 <= M <= 32 rows of x: codes (K/2, Npad) uint8 (low nibble k < K/2, high
// nibble k + K/2), scales (2, K/2/G, Npad) plane-major, offsets (K/G, Npad)
// in logical-k group rows or absent, f32 or bf16, G = 16 or 32.
//
// Replaces (ggml_tpu/kernels/qmatmul.py), one kernel template for the four
// Pallas bodies _q4_gemv (:808) picks from, each with the per-row activation
// quantization before it (:856) and the * sx after it (:1064-1073):
//   _q4gemv_kernel (:292), _q4gemv_off_kernel (:328): the per-group loop;
//   _q4gemv_bd_kernel (:362), _q4gemv_bd_off_kernel (:399): the block-diagonal
//   pair, which only fills the TPU's matrix unit at M = 1 and computes the
//   same sum.
// All compute, per row m and column n, over both half-planes h,
//   y = sx_m * sum_h sum_g ( s_hg * sum_{k in g} xq_k q_kn  +  o_hg * sum_{k in g} xq_k )
// with exact int32 group dots, the int8 activations in the offset term too,
// and f32 everything else.  The low half reads scale rows [0, K/2/G) of plane
// 0 and offset rows [0, K/2/G); the high half plane 1 and offset rows
// [K/2/G, K/G).
//
// Bound on the H100: device-memory bytes.  The planes cost 0.5 B/weight of
// codes plus 2/G (bf16 scale) to 8/G (f32 scale and offset) B/weight of group
// planes, read once; x and y are noise.  At M <= 32 the integer work
// (2*M*K*N int8 ops) is far below the 1979 TOP/s int8 rate.
//
// Design, that of the int8-plane GEMV (q8_gemv.cu) with the nibble split of
// the Q4_K GEMV (q4k_gemv.cu): a block owns 128 columns and walks `iters`
// slabs of 256 packed rows; in a slab each of 8 warps owns 32 packed rows
// (one group of 32 or two of 16 in EACH half-plane) and each lane 4 adjacent
// columns, so a warp's code load is one 128-byte row segment.  A lane loads
// its 32 rows up front, transposes each 4-row x 4-column byte square with
// __byte_perm so a register holds 4 K-consecutive bytes of one column, masks
// out the two nibble planes and runs __dp4a against the int8 activations of
// the matching half of x, staged in shared memory.  The warps' sums meet in
// shared memory in warp order and add up over the slabs in a shared
// accumulator.  K is split across blocks (gridDim.y); the split partial sums
// go to a scratch buffer and the last block of each column strip (atomic
// ticket) adds them in block order: one launch, deterministic result, no
// atomics on the output.  The quantization kernel (common.cuh) runs first on
// the same stream and zeroes the tickets.

#include "common.cuh"

namespace ggml_tpu_torch {
namespace {

constexpr int BN = 128;    // columns per block: 32 lanes x 4 columns
constexpr int SLAB = 256;  // packed rows per step: 8 warps x 32 rows
constexpr int THREADS = QUANT_THREADS;
constexpr int MAX_M = 32;
constexpr int MC = 2;      // rows of x reduced per shared-memory pass

// Two blocks a multiprocessor (at most 128 registers a thread): a lone block
// of 8 warps does not keep enough loads in flight to fill the memory pipe.
template <int G, typename ST>
__global__ void __launch_bounds__(THREADS, 2)
q4_gemv_kernel(const uint8_t* __restrict__ codes, const ST* __restrict__ scales,
               const ST* __restrict__ offsets, const int8_t* __restrict__ xq,
               const float* __restrict__ sx, float* __restrict__ partial,
               unsigned* __restrict__ tickets, float* __restrict__ y,
               int M, int K, int Npad, int iters) {
  constexpr int NG = 32 / G;  // groups in a warp's 32 rows, per half-plane
  constexpr int QG = G / 4;   // 4-row squares per group
  const int K2 = K / 2;
  const int G2 = K2 / G;      // groups per half-plane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * BN;
  const int n = col0 + 4 * lane;  // this lane's first column
  const bool has_off = offsets != nullptr;

  __shared__ __align__(16) int8_t xs[2][MAX_M][SLAB];
  __shared__ __align__(16) float red[THREADS / 32][MC][BN];
  __shared__ float acc[MAX_M * BN];
  __shared__ bool is_last;

  for (int i = threadIdx.x; i < M * BN; i += THREADS) acc[i] = 0.f;

  for (int it = 0; it < iters; ++it) {
    const int r0 = (blockIdx.y * iters + it) * SLAB;  // slab's first packed row
    const int c0 = r0 + warp * 32;                    // warp's first packed row
    const bool active = c0 < K2;  // K2 % 32 == 0: a warp's rows are all inside K2 or all past it
    __syncthreads();              // xs and acc free: the previous slab is summed

    // int8 activations of this slab's rows in both halves of x, zero past K2
    for (int i = threadIdx.x; i < M * (SLAB / 4); i += THREADS) {
      const int m = i / (SLAB / 4), w = i % (SLAB / 4);
      const int* src = reinterpret_cast<const int*>(xq + (size_t)m * K);
      const bool in = r0 + 4 * w < K2;
      reinterpret_cast<int*>(xs[0][m])[w] = in ? src[(r0 >> 2) + w] : 0;
      reinterpret_cast<int*>(xs[1][m])[w] = in ? src[((K2 + r0) >> 2) + w] : 0;
    }

    uint32_t wq[32];
    float sl[NG][4], sh[NG][4], ol[NG][4], oh[NG][4];
    if (active) {
      const uint8_t* cp = codes + (size_t)c0 * Npad + n;
#pragma unroll
      for (int r = 0; r < 32; ++r)
        wq[r] = __ldg(reinterpret_cast<const uint32_t*>(cp + (size_t)r * Npad));
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        const int g = c0 / G + gi;  // group row within a half-plane
        load4(scales + (size_t)g * Npad + n, sl[gi]);
        load4(scales + (size_t)(G2 + g) * Npad + n, sh[gi]);
        if (has_off) {
          load4(offsets + (size_t)g * Npad + n, ol[gi]);
          load4(offsets + (size_t)(G2 + g) * Npad + n, oh[gi]);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) ol[gi][j] = oh[gi][j] = 0.f;
        }
      }
    }
    __syncthreads();  // xs staged

    for (int mb = 0; mb < M; mb += MC) {
#pragma unroll
      for (int mm = 0; mm < MC; ++mm) {
        const int m = mb + mm;
        float res[4] = {0.f, 0.f, 0.f, 0.f};
        if (m < M && active) {
          int pl[NG][4], ph[NG][4], xsl[NG], xsh[NG];
#pragma unroll
          for (int gi = 0; gi < NG; ++gi) {
            xsl[gi] = xsh[gi] = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j) pl[gi][j] = ph[gi][j] = 0;
          }
          const int* xw0 = reinterpret_cast<const int*>(&xs[0][m][warp * 32]);
          const int* xw1 = reinterpret_cast<const int*>(&xs[1][m][warp * 32]);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int gi = q / QG;
            const int a = xw0[q], b = xw1[q];
            xsl[gi] = __dp4a(a, 0x01010101, xsl[gi]);
            xsh[gi] = __dp4a(b, 0x01010101, xsh[gi]);
            // 4 rows x 4 columns of bytes -> one word of 4 rows per column
            const uint32_t t01l = __byte_perm(wq[4 * q], wq[4 * q + 1], 0x5140);
            const uint32_t t01h = __byte_perm(wq[4 * q], wq[4 * q + 1], 0x7362);
            const uint32_t t23l = __byte_perm(wq[4 * q + 2], wq[4 * q + 3], 0x5140);
            const uint32_t t23h = __byte_perm(wq[4 * q + 2], wq[4 * q + 3], 0x7362);
            const uint32_t col[4] = {__byte_perm(t01l, t23l, 0x5410), __byte_perm(t01l, t23l, 0x7632),
                                     __byte_perm(t01h, t23h, 0x5410), __byte_perm(t01h, t23h, 0x7632)};
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              pl[gi][j] = __dp4a((int)(col[j] & 0x0F0F0F0Fu), a, pl[gi][j]);
              ph[gi][j] = __dp4a((int)((col[j] >> 4) & 0x0F0F0F0Fu), b, ph[gi][j]);
            }
          }
#pragma unroll
          for (int gi = 0; gi < NG; ++gi)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              res[j] += (float)pl[gi][j] * sl[gi][j] + (float)xsl[gi] * ol[gi][j];
              res[j] += (float)ph[gi][j] * sh[gi][j] + (float)xsh[gi] * oh[gi][j];
            }
        }
        *reinterpret_cast<float4*>(&red[warp][mm][4 * lane]) = make_float4(res[0], res[1], res[2], res[3]);
      }
      __syncthreads();
      for (int i = threadIdx.x; i < MC * BN; i += THREADS) {
        const int mm = i / BN, c = i % BN, m = mb + mm;
        if (m < M) {
          float t = 0.f;
#pragma unroll
          for (int w = 0; w < THREADS / 32; ++w) t += red[w][mm][c];
          acc[m * BN + c] += t;
        }
      }
      __syncthreads();
    }
  }

  for (int i = threadIdx.x; i < M * BN; i += THREADS)
    partial[((size_t)blockIdx.y * M + i / BN) * Npad + col0 + i % BN] = acc[i];

  // the last block of this column strip adds the K-split partials in order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(&tickets[blockIdx.x], 1u) == gridDim.y - 1;
  __syncthreads();
  if (!is_last) return;
  for (int i = threadIdx.x; i < M * BN; i += THREADS) {
    const int m = i / BN, c = col0 + i % BN;
    float t = 0.f;
    for (int rb = 0; rb < (int)gridDim.y; ++rb) t += __ldcg(&partial[((size_t)rb * M + m) * Npad + c]);
    y[(size_t)m * Npad + c] = t * sx[m];
  }
}

template <int G, typename ST>
void launch(dim3 grid, cudaStream_t stream, const void* codes, const void* scales,
            const void* offsets, const void* xq, const void* sx, void* partial, void* tickets,
            void* y, int M, int K, int Npad, int iters) {
  q4_gemv_kernel<G, ST><<<grid, THREADS, 0, stream>>>(
      static_cast<const uint8_t*>(codes), static_cast<const ST*>(scales),
      static_cast<const ST*>(offsets), static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<float*>(partial), static_cast<unsigned*>(tickets), static_cast<float*>(y),
      M, K, Npad, iters);
}

}  // namespace
}  // namespace ggml_tpu_torch

// x (M, K) bf16 -> y (M, Npad) f32, 1 <= M <= 32, G = 16 or 32, K/2 a
// multiple of 8 * G.  scales (2, K/2/G, Npad) and offsets (K/G, Npad) are f32
// (bf16 with st_bf16) planes; offsets may be null.  Scratch: xq (M, K) int8,
// sx (M) f32, partial (split, M, Npad) f32, tickets (Npad/128) uint32 (zeroed
// here); split divides the number of 256-row slabs of K/2.
extern "C" int q4_gemv(const void* x, const void* codes, const void* scales, const void* offsets,
                       int st_bf16, void* xq, void* sx, void* partial, void* tickets, void* y,
                       int G, int M, int K, int Npad, int split, void* stream) {
  using namespace ggml_tpu_torch;
  const int K2 = K / 2;
  const int slabs = (K2 + SLAB - 1) / SLAB;
  if (M < 1 || M > MAX_M || (G != 16 && G != 32) || K < 2 || K2 % (8 * G) || Npad % BN ||
      split < 1 || slabs % split)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  quant_segments<false><<<M, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq), static_cast<float*>(sx), K,
      static_cast<unsigned*>(tickets), Npad / BN);
  const dim3 grid(Npad / BN, split);
  const int iters = slabs / split;
#define GGML_Q4_GEMV(G_, ST_) \
  launch<G_, ST_>(grid, s, codes, scales, offsets, xq, sx, partial, tickets, y, M, K, Npad, iters)
  if (G == 16) {
    if (st_bf16) GGML_Q4_GEMV(16, __nv_bfloat16); else GGML_Q4_GEMV(16, float);
  } else {
    if (st_bf16) GGML_Q4_GEMV(32, __nv_bfloat16); else GGML_Q4_GEMV(32, float);
  }
#undef GGML_Q4_GEMV
  return (int)cudaGetLastError();
}
