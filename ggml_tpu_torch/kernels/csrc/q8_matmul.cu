// Prefill matmul over q8 planes (codes (K, Npad) int8, N last): every M above
// 32, and every M at shapes the int8 GEMV does not take.
//
// Replaces (ggml_tpu/kernels/qmatmul.py) _q8_kernel (:133) / _q8_matmul
// (:142) together with the work the JAX wrapper does around it: the effective
// scale planes of compact weights (_effective_planes, :1014) and the affine
// side product xsum @ eff_o (:1082-1084).  It computes
//   y[m, n] = sum_k x[m, k] * bf16(f32(q[k, n]) * f32(s[k/G, n]))   (bf16 dot, f32 sum)
//           + sum_g f32(sum_{k in g} x[m, k]) * o[g, n]              (f32, from the bf16 x)
// with the weight rounded to bf16 at the same point as :138; for compact
// planes s = d * sc and o = -dmin * m are formed in f32 first (:1019-1025).
//
// Bound on the H100: at M=100 the plane bytes (1 B/weight at 3.35 TB/s)
// take longer than the tensor-core work (2*M*K*N at 989 TFLOP/s bf16); it
// turns compute-bound from about M=150 up.
//
// Design (simple, not fast), that of the Q4_K prefill matmul (q4k_matmul.cu):
// a block computes a 64x64 tile of y with four warps, each a 32x32 quarter as
// 2x2 WMMA bf16 16x16x16 fragments with f32 accumulators.  The K loop steps
// 32 rows at a time (one group of 32 or two of 16): the x tile is copied to
// shared memory, the weight tile is dequantized from the int8 plane into
// shared memory as bf16, and every thread keeps the f32 offset term of its
// 8x4 outputs in registers (xsum per row and group times the offset per
// column).  The epilogue goes through shared memory to add the offset term
// to the fragments.  No double buffering, no TMA, no wgmma: later work.

#include <mma.h>

#include "common.cuh"

namespace ggml_tpu_torch {
namespace {

using namespace nvcuda;

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;
constexpr int LDA = BK + 8;  // bf16, row stride of the x tile
constexpr int LDB = BN + 8;  // bf16, row stride of the weight tile
constexpr int LDC = BN + 4;  // f32, row stride of the epilogue tile

// COMPACT: scales/offsets hold int8 sub-scale/min codes and d/dmin (ST) one
// value per sb groups; else scales/offsets hold ST values.  offsets (and
// dmin) may be null: no offset term.
template <int G, bool COMPACT, typename ST>
__global__ void __launch_bounds__(THREADS)
q8_matmul_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ codes,
                 const void* __restrict__ scales, const void* __restrict__ offsets,
                 const ST* __restrict__ d, const ST* __restrict__ dmin, float* __restrict__ y,
                 int M, int K, int Npad, int sb) {
  constexpr int NG = BK / G;  // groups per K step
  __shared__ __align__(32) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(32) __nv_bfloat16 Bs[BK * LDB];
  __shared__ __align__(32) float Cs[BM * LDC];
  __shared__ float xsum[NG][BM];
  __shared__ float offo[NG][BN];

  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = warp >> 1, wn = warp & 1;
  const bool has_off = offsets != nullptr;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // offset term of this thread's outputs: rows orow..orow+7, columns ocol..ocol+3
  const int orow = (tid >> 4) * 8, ocol = (tid & 15) * 4;
  float off[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) off[i][j] = 0.f;

  // weight-tile role: rows brow..brow+3 of the K step (all in one group),
  // columns bcol..bcol+3
  const int brow = (tid >> 4) * 4, bcol = (tid & 15) * 4;
  const int xrow = tid >> 1, xcol = (tid & 1) * 16;

  for (int k0 = 0; k0 < K; k0 += BK) {
    {  // x tile: 64 rows x 32, zero rows past M
      uint4 v0 = make_uint4(0, 0, 0, 0), v1 = v0;
      if (m0 + xrow < M) {
        const uint4* p = reinterpret_cast<const uint4*>(x + (size_t)(m0 + xrow) * K + k0 + xcol);
        v0 = p[0];
        v1 = p[1];
      }
      *reinterpret_cast<uint4*>(&As[xrow * LDA + xcol]) = v0;
      *reinterpret_cast<uint4*>(&As[xrow * LDA + xcol + 8]) = v1;
    }
    {  // weight tile: bf16(code * f32 scale) for 4 rows x 4 columns
      const int g = k0 / G + brow / G;
      float eff[4];
      if (COMPACT) {
        float dv[4], sv[4];
        load4(d + (size_t)(g / sb) * Npad + n0 + bcol, dv);
        load4(static_cast<const int8_t*>(scales) + (size_t)g * Npad + n0 + bcol, sv);
#pragma unroll
        for (int j = 0; j < 4; ++j) eff[j] = dv[j] * sv[j];
      } else {
        load4(static_cast<const ST*>(scales) + (size_t)g * Npad + n0 + bcol, eff);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(
            codes + (size_t)(k0 + brow + r) * Npad + n0 + bcol));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float q = (float)(int8_t)(w >> (8 * j));
          Bs[(brow + r) * LDB + bcol + j] = __float2bfloat16_rn(q * eff[j]);
        }
      }
      if (has_off && tid < NG * (BN / 4)) {  // offset planes of this step's groups
        const int gi = tid / (BN / 4), c = 4 * (tid % (BN / 4));
        const int go = k0 / G + gi;
        float ov[4];
        if (COMPACT) {
          float dm[4], mv[4];
          load4(dmin + (size_t)(go / sb) * Npad + n0 + c, dm);
          load4(static_cast<const int8_t*>(offsets) + (size_t)go * Npad + n0 + c, mv);
#pragma unroll
          for (int j = 0; j < 4; ++j) ov[j] = -dm[j] * mv[j];
        } else {
          load4(static_cast<const ST*>(offsets) + (size_t)go * Npad + n0 + c, ov);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) offo[gi][c + j] = ov[j];
      }
    }
    __syncthreads();
    if (has_off && tid < BM) {  // f32 activation sum of each row over each group
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        float s = 0.f;
#pragma unroll 8
        for (int e = 0; e < G; ++e) s += __bfloat162float(As[tid * LDA + gi * G + e]);
        xsum[gi][tid] = s;
      }
    }
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) wmma::load_matrix_sync(a[i], &As[(wm * 32 + 16 * i) * LDA + kk], LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::load_matrix_sync(b[j], &Bs[kk * LDB + wn * 32 + 16 * j], LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // xsum written
    if (has_off) {
#pragma unroll
      for (int gi = 0; gi < NG; ++gi)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) off[i][j] += xsum[gi][orow + i] * offo[gi][ocol + j];
    }
    __syncthreads();  // tiles and xsum free for the next step
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(&Cs[(wm * 32 + 16 * i) * LDC + wn * 32 + 16 * j], acc[i][j], LDC,
                              wmma::mem_row_major);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + orow + i;
    if (m >= M) break;
    float4 v;
    v.x = Cs[(orow + i) * LDC + ocol + 0] + off[i][0];
    v.y = Cs[(orow + i) * LDC + ocol + 1] + off[i][1];
    v.z = Cs[(orow + i) * LDC + ocol + 2] + off[i][2];
    v.w = Cs[(orow + i) * LDC + ocol + 3] + off[i][3];
    *reinterpret_cast<float4*>(&y[(size_t)m * Npad + n0 + ocol]) = v;
  }
}

template <int G, bool COMPACT, typename ST>
void launch(dim3 grid, cudaStream_t stream, const void* x, const void* codes, const void* scales,
            const void* offsets, const void* d, const void* dmin, void* y, int M, int K, int Npad,
            int sb) {
  q8_matmul_kernel<G, COMPACT, ST><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(codes), scales, offsets,
      static_cast<const ST*>(d), static_cast<const ST*>(dmin), static_cast<float*>(y), M, K, Npad, sb);
}

}  // namespace
}  // namespace ggml_tpu_torch

// x (M, K) bf16 -> y (M, Npad) f32, G = 16 or 32, K a multiple of 32.  Planes
// as for q8_gemv: d == null means f32 (bf16 with st_bf16) scale/offset planes,
// else int8 code planes with f32 (bf16) d/dmin per sb groups; offsets (with
// dmin) may be null.
extern "C" int q8_matmul(const void* x, const void* codes, const void* scales, const void* offsets,
                         const void* d, const void* dmin, int st_bf16, int G, int sb, void* y,
                         int M, int K, int Npad, void* stream) {
  using namespace ggml_tpu_torch;
  const bool compact = d != nullptr;
  if (M < 1 || (G != 16 && G != 32) || K < 1 || K % BK || Npad % BN ||
      (compact && (sb < 1 || K % (G * sb))) ||
      (compact && (offsets != nullptr) != (dmin != nullptr)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Npad / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GGML_Q8_MATMUL(G_, C_, ST_) \
  launch<G_, C_, ST_>(grid, s, x, codes, scales, offsets, d, dmin, y, M, K, Npad, sb)
#define GGML_Q8_MATMUL_G(G_)                                                       \
  if (compact) {                                                                   \
    if (st_bf16) GGML_Q8_MATMUL(G_, true, __nv_bfloat16); else GGML_Q8_MATMUL(G_, true, float);   \
  } else {                                                                         \
    if (st_bf16) GGML_Q8_MATMUL(G_, false, __nv_bfloat16); else GGML_Q8_MATMUL(G_, false, float); \
  }
  if (G == 16) { GGML_Q8_MATMUL_G(16) } else { GGML_Q8_MATMUL_G(32) }
#undef GGML_Q8_MATMUL_G
#undef GGML_Q8_MATMUL
  return (int)cudaGetLastError();
}
