// int8 GEMV over q8 planes (codes (K, Npad) int8, N last), for 1 <= M <= 32
// rows of x.
//
// Replaces (ggml_tpu/kernels/qmatmul.py), one kernel template for all six
// Pallas bodies, each with the per-row activation quantization before it
// (:856) and the * sx after it (:1060-1073):
//   q8_gemv over multiplied-out planes (kernel E)
//     <- _q8gemv_kernel (:189) and _q8gemv_off_kernel (:209): one f32 or bf16
//        scale (and offset) per group of G = 16 or 32 codes;
//   q8_gemv over COMPACT planes (kernel F)
//     <- _q8gemv_sb_kernel (:645), _q8gemv_bd_sb_kernel (:665),
//        _q8gemv_sb_off_kernel (:685), _q8gemv_bd_sb_off_kernel (:708): int8
//        sub-scale (and min) codes per group, d (and dmin) per superblock of
//        sb groups, s = d * sc and o = -dmin * m rebuilt in f32 here.  The
//        block-diagonal bodies only fill the TPU's matrix unit at M = 1;
//        they compute the loop bodies' sum, so one kernel serves both.
// All compute, per row m and column n,
//   y = sx_m * sum_g ( s_g * sum_{k in g} xq_k q_kn  +  o_g * sum_{k in g} xq_k )
// with exact int32 group dots, the int8 activations in the offset term too,
// and f32 everything else.
//
// Bound on the H100: device-memory bytes.  The planes cost 1 B/weight of
// codes plus 2/G (bf16) to 8/G (f32 scale and offset) B/weight of group
// planes, read once; x and y are noise.  At M <= 32 the integer work
// (2*M*K*N int8 ops) is far below the 1979 TOP/s int8 rate.
//
// Design, that of the Q4_K GEMV (q4k_gemv.cu) without the nibble split: a
// block owns 128 columns and walks `iters` slabs of 256 K rows; in a slab
// each of 8 warps owns 32 rows (one group of 32 or two of 16) and each lane
// 4 adjacent columns, so a warp's code load is one 128-byte row segment.  A
// lane loads its 32 rows up front (32 independent loads in flight),
// transposes each 4-row x 4-column byte square with __byte_perm so a
// register holds 4 K-consecutive codes of one column, and runs __dp4a
// against the int8 activations staged in shared memory.  The warps' group
// sums meet in shared memory in warp order and add up over the slabs in a
// shared accumulator.  K is split across blocks (gridDim.y) so N = 4096
// still fills the card; the split partial sums go to a scratch buffer and
// the last block of each column strip (atomic ticket) adds them in block
// order: one launch, deterministic result, no atomics on the output.  The
// quantization kernel (common.cuh) runs first on the same stream and zeroes
// the tickets, so every launch brings its own scratch and counters.

#include "common.cuh"

namespace ggml_tpu_torch {
namespace {

constexpr int BN = 128;    // columns per block: 32 lanes x 4 columns
constexpr int SLAB = 256;  // K rows per step: 8 warps x 32 rows
constexpr int THREADS = QUANT_THREADS;
constexpr int MAX_M = 32;
constexpr int MC = 4;      // rows of x reduced per shared-memory pass

// COMPACT: scales/offsets hold int8 sub-scale/min codes and d/dmin (ST) one
// value per sb groups; else scales/offsets hold ST values.  offsets (and
// dmin) may be null: no offset term.
template <int G, bool COMPACT, typename ST>
__global__ void __launch_bounds__(THREADS)
q8_gemv_kernel(const int8_t* __restrict__ codes, const void* __restrict__ scales,
               const void* __restrict__ offsets, const ST* __restrict__ d,
               const ST* __restrict__ dmin, const int8_t* __restrict__ xq,
               const float* __restrict__ sx, float* __restrict__ partial,
               unsigned* __restrict__ tickets, float* __restrict__ y,
               int M, int K, int Npad, int sb, int iters) {
  constexpr int NG = 32 / G;  // groups in a warp's 32 rows
  constexpr int QG = G / 4;   // 4-row squares per group
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * BN;
  const int n = col0 + 4 * lane;  // this lane's first column
  const bool has_off = offsets != nullptr;

  __shared__ __align__(16) int8_t xs[MAX_M][SLAB];
  __shared__ __align__(16) float red[THREADS / 32][MC][BN];
  __shared__ float acc[MAX_M * BN];
  __shared__ bool is_last;

  for (int i = threadIdx.x; i < M * BN; i += THREADS) acc[i] = 0.f;

  for (int it = 0; it < iters; ++it) {
    const int r0 = (blockIdx.y * iters + it) * SLAB;  // slab's first row
    const int c0 = r0 + warp * 32;                    // warp's first row
    const bool active = c0 < K;  // K % 32 == 0: a warp's rows are all inside K or all past it
    __syncthreads();             // xs and acc free: the previous slab is summed

    // int8 activations of this slab's rows, zero past K
    for (int i = threadIdx.x; i < M * (SLAB / 4); i += THREADS) {
      const int m = i / (SLAB / 4), w = i % (SLAB / 4);
      const int* src = reinterpret_cast<const int*>(xq + (size_t)m * K);
      reinterpret_cast<int*>(xs[m])[w] = r0 + 4 * w < K ? src[(r0 >> 2) + w] : 0;
    }

    uint32_t wq[32];
    float s[NG][4], o[NG][4];
    if (active) {
      const int8_t* cp = codes + (size_t)c0 * Npad + n;
#pragma unroll
      for (int r = 0; r < 32; ++r)
        wq[r] = __ldg(reinterpret_cast<const uint32_t*>(cp + (size_t)r * Npad));
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        const int g = c0 / G + gi;  // group row of the scale planes
        if (COMPACT) {
          float dv[4], scv[4];
          load4(d + (size_t)(g / sb) * Npad + n, dv);
          load4(static_cast<const int8_t*>(scales) + (size_t)g * Npad + n, scv);
#pragma unroll
          for (int j = 0; j < 4; ++j) s[gi][j] = dv[j] * scv[j];
          if (has_off) {
            float mv[4], mcv[4];
            load4(dmin + (size_t)(g / sb) * Npad + n, mv);
            load4(static_cast<const int8_t*>(offsets) + (size_t)g * Npad + n, mcv);
#pragma unroll
            for (int j = 0; j < 4; ++j) o[gi][j] = -mv[j] * mcv[j];
          }
        } else {
          load4(static_cast<const ST*>(scales) + (size_t)g * Npad + n, s[gi]);
          if (has_off) load4(static_cast<const ST*>(offsets) + (size_t)g * Npad + n, o[gi]);
        }
        if (!has_off) {
#pragma unroll
          for (int j = 0; j < 4; ++j) o[gi][j] = 0.f;
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
          int p[NG][4], xsum[NG];
#pragma unroll
          for (int gi = 0; gi < NG; ++gi) {
            xsum[gi] = 0;
#pragma unroll
            for (int j = 0; j < 4; ++j) p[gi][j] = 0;
          }
          const int* xw = reinterpret_cast<const int*>(&xs[m][warp * 32]);
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            const int gi = q / QG;
            const int a = xw[q];
            xsum[gi] = __dp4a(a, 0x01010101, xsum[gi]);
            // 4 rows x 4 columns of bytes -> one word of 4 rows per column
            const uint32_t t01l = __byte_perm(wq[4 * q], wq[4 * q + 1], 0x5140);
            const uint32_t t01h = __byte_perm(wq[4 * q], wq[4 * q + 1], 0x7362);
            const uint32_t t23l = __byte_perm(wq[4 * q + 2], wq[4 * q + 3], 0x5140);
            const uint32_t t23h = __byte_perm(wq[4 * q + 2], wq[4 * q + 3], 0x7362);
            p[gi][0] = __dp4a((int)__byte_perm(t01l, t23l, 0x5410), a, p[gi][0]);
            p[gi][1] = __dp4a((int)__byte_perm(t01l, t23l, 0x7632), a, p[gi][1]);
            p[gi][2] = __dp4a((int)__byte_perm(t01h, t23h, 0x5410), a, p[gi][2]);
            p[gi][3] = __dp4a((int)__byte_perm(t01h, t23h, 0x7632), a, p[gi][3]);
          }
#pragma unroll
          for (int gi = 0; gi < NG; ++gi)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              res[j] += (float)p[gi][j] * s[gi][j] + (float)xsum[gi] * o[gi][j];
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

template <int G, bool COMPACT, typename ST>
void launch(dim3 grid, cudaStream_t stream, const void* codes, const void* scales,
            const void* offsets, const void* d, const void* dmin, const void* xq, const void* sx,
            void* partial, void* tickets, void* y, int M, int K, int Npad, int sb, int iters) {
  q8_gemv_kernel<G, COMPACT, ST><<<grid, THREADS, 0, stream>>>(
      static_cast<const int8_t*>(codes), scales, offsets, static_cast<const ST*>(d),
      static_cast<const ST*>(dmin), static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<float*>(partial), static_cast<unsigned*>(tickets), static_cast<float*>(y),
      M, K, Npad, sb, iters);
}

}  // namespace
}  // namespace ggml_tpu_torch

// x (M, K) bf16 -> y (M, Npad) f32, 1 <= M <= 32, G = 16 or 32, K a multiple
// of 8 * G.  d == null: scales/offsets are f32 (bf16 with st_bf16) planes
// (K/G, Npad); else they are int8 code planes and d/dmin f32 (bf16) planes
// (K/(G*sb), Npad).  offsets (with dmin) may be null.  Scratch: xq (M, K)
// int8, sx (M) f32, partial (split, M, Npad) f32, tickets (Npad/128) uint32
// (zeroed here); split divides the number of 256-row slabs of K.
extern "C" int q8_gemv(const void* x, const void* codes, const void* scales, const void* offsets,
                       const void* d, const void* dmin, int st_bf16, void* xq, void* sx,
                       void* partial, void* tickets, void* y, int G, int sb, int M, int K,
                       int Npad, int split, void* stream) {
  using namespace ggml_tpu_torch;
  const bool compact = d != nullptr;
  const int slabs = (K + SLAB - 1) / SLAB;
  if (M < 1 || M > MAX_M || (G != 16 && G != 32) || K < 1 || K % (8 * G) || Npad % BN ||
      split < 1 || slabs % split || (compact && (sb < 1 || K % (G * sb))) ||
      (compact && (offsets != nullptr) != (dmin != nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  quant_segments<false><<<M, THREADS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq), static_cast<float*>(sx), K,
      static_cast<unsigned*>(tickets), Npad / BN);
  const dim3 grid(Npad / BN, split);
  const int iters = slabs / split;
#define GGML_Q8_GEMV(G_, C_, ST_) \
  launch<G_, C_, ST_>(grid, s, codes, scales, offsets, d, dmin, xq, sx, partial, tickets, y, M, K, Npad, sb, iters)
#define GGML_Q8_GEMV_G(G_)                                                     \
  if (compact) {                                                               \
    if (st_bf16) GGML_Q8_GEMV(G_, true, __nv_bfloat16); else GGML_Q8_GEMV(G_, true, float);   \
  } else {                                                                     \
    if (st_bf16) GGML_Q8_GEMV(G_, false, __nv_bfloat16); else GGML_Q8_GEMV(G_, false, float); \
  }
  if (G == 16) { GGML_Q8_GEMV_G(16) } else { GGML_Q8_GEMV_G(32) }
#undef GGML_Q8_GEMV_G
#undef GGML_Q8_GEMV
  return (int)cudaGetLastError();
}
