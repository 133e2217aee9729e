// Prefill matmul over packed-nibble planes, for M > 32 rows (and every M
// where the nibble GEMVs have no legal tile): compact Q4_K planes, or planes
// with multiplied-out scales and offsets (Q4_0, Q4_1, Q2_K, Q3_K, Q4_K at
// K % 512 != 0; f32 or bf16, groups of 16 or 32, offsets optional).
//
// Replaces (ggml_tpu/kernels/qmatmul.py) _q4_kernel (:79) / _q4_matmul (:94)
// together with the work the JAX wrapper does around it: the effective scale
// planes (_effective_planes, :1014) and the affine side product xsum @ eff_o
// (:1082-1084).  It computes
//   y[m, n] = sum_k x[m, k] * bf16(q[k, n] * s[k/G, n])        (bf16 dot, f32 sum)
//           + sum_g f32(sum_{k in g} x[m, k]) * o[g, n]           (f32)
// with s = f32(d*sc), o = -dmin*m for compact planes and the planes' values
// (bf16 widened to f32) otherwise, and the weight rounded to bf16 at the same
// point as :87-88.
//
// Bound on the H100: at M=100 the tensor-core work (2*M*K*N at 989 TFLOP/s
// bf16) is above the plane bytes at 3.35 TB/s; it is compute-bound from
// about M=60 up.
//
// Design (simple, not fast): a block computes a 64x64 tile of y with four
// warps, each a 32x32 quarter as 2x2 WMMA bf16 16x16x16 fragments with f32
// accumulators.  The K loop steps 32 elements at a time (one group of 32 or
// two of 16, never across the two half-planes): the x tile is copied to
// shared memory, the weight tile is dequantized from the nibble planes into
// shared memory as bf16 (one scale per column per group), and every thread
// keeps the f32 offset term of its 8x4 outputs in registers (xsum per row of
// the x tile and group times the offset per column).  The epilogue goes
// through shared memory to add the offset term to the fragments.  No
// double buffering, no TMA, no wgmma: those are later work.

#include <mma.h>

#include "common.cuh"

namespace ggml_tpu_torch {
namespace {

using namespace nvcuda;

constexpr int BM = 64, BN = 64, BK = 32, THREADS = 128;
constexpr int LDA = BK + 8;  // bf16, row stride of the x tile
constexpr int LDB = BN + 8;  // bf16, row stride of the weight tile
constexpr int LDC = BN + 4;  // f32, row stride of the epilogue tile

// COMPACT: sc/mc hold int8 sub-scale/min codes and d/dmin (DT) one value per
// 8 groups of 32.  Else sc/mc hold DT scale and offset planes per group of G
// (mc may be null: no offset term) and d/dmin are unused.
template <typename DT, bool COMPACT, int G>
__global__ void __launch_bounds__(THREADS)
q4k_matmul_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ codes,
                  const void* __restrict__ sc, const void* __restrict__ mc,
                  const DT* __restrict__ d, const DT* __restrict__ dmin, float* __restrict__ y,
                  int M, int K, int Npad) {
  constexpr int NG = BK / G;  // groups per K step
  __shared__ __align__(32) __nv_bfloat16 As[BM * LDA];
  __shared__ __align__(32) __nv_bfloat16 Bs[BK * LDB];
  __shared__ __align__(32) float Cs[BM * LDC];
  __shared__ float xsum[NG][BM];
  __shared__ float offo[NG][BN];
  const bool has_off = mc != nullptr;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int K2 = K / 2, G2 = K2 / 32, SB2 = K2 / 256;  // steps and superblocks per half-plane
  const int GH = K2 / G;                               // groups per half-plane
  const int wm = warp >> 1, wn = warp & 1;

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

  // weight-tile role: rows brow..brow+3 of the 32-group, columns bcol..bcol+3
  const int brow = (tid >> 4) * 4, bcol = (tid & 15) * 4;
  const int xrow = tid >> 1, xcol = (tid & 1) * 16;

  for (int kg = 0; kg < K / BK; ++kg) {  // natural 32-element steps of K
    const int h = kg >= G2 ? 1 : 0;      // half-plane
    const int gh = kg - h * G2;          // step within the half-plane
    const int k0 = kg * BK;

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
    {  // weight tile: bf16(code * f32(scale)) for 4 rows x 4 columns
      float eff[4];
      if (COMPACT) {
        float dv[4], sv[4];
        load4(d + (size_t)(h * SB2 + gh / 8) * Npad + n0 + bcol, dv);
        load4(static_cast<const int8_t*>(sc) + (size_t)(h * G2 + gh) * Npad + n0 + bcol, sv);
#pragma unroll
        for (int j = 0; j < 4; ++j) eff[j] = dv[j] * sv[j];
      } else {  // plane-major scales: row h * GH + this row's group within the half-plane
        load4(static_cast<const DT*>(sc) + (size_t)(h * GH + (gh * 32 + brow) / G) * Npad + n0 + bcol, eff);
      }
      const int shift = 4 * h;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const uint32_t w = __ldg(reinterpret_cast<const uint32_t*>(
            codes + (size_t)(gh * 32 + brow + r) * Npad + n0 + bcol));
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float q = (float)((w >> (8 * j + shift)) & 0xFu);
          Bs[(brow + r) * LDB + bcol + j] = __float2bfloat16_rn(q * eff[j]);
        }
      }
      if (has_off && tid < NG * (BN / 4)) {  // offsets of this step's groups, natural group rows
        const int gi = tid / (BN / 4), c = 4 * (tid % (BN / 4));
        if (COMPACT) {
          float dm[4], mv[4];
          load4(dmin + (size_t)(h * SB2 + gh / 8) * Npad + n0 + c, dm);
          load4(static_cast<const int8_t*>(mc) + (size_t)kg * Npad + n0 + c, mv);
#pragma unroll
          for (int j = 0; j < 4; ++j) offo[gi][c + j] = -dm[j] * mv[j];
        } else {
          float ov[4];
          load4(static_cast<const DT*>(mc) + (size_t)(kg * NG + gi) * Npad + n0 + c, ov);
#pragma unroll
          for (int j = 0; j < 4; ++j) offo[gi][c + j] = ov[j];
        }
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
    __syncthreads();  // tiles and xsum free for the next group
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

}  // namespace
}  // namespace ggml_tpu_torch

// x (M, K) bf16 -> y (M, Npad) f32.  d != null: compact planes (sc/mc int8
// codes, d/dmin f32, or bf16 with d_bf16; G = 32; K % 512 == 0).  d == null:
// sc (2, K/2/G, Npad) and mc (K/G, Npad) or null are f32 (bf16 with d_bf16)
// planes, G = 16 or 32, K % 64 == 0.
extern "C" int q4k_matmul(const void* x, const void* codes, const void* sc, const void* mc,
                          const void* d, const void* dmin, int d_bf16, int G, void* y, int M, int K,
                          int Npad, void* stream) {
  using namespace ggml_tpu_torch;
  const bool compact = d != nullptr;
  if (M < 1 || K < 64 || Npad % BN || (G != 16 && G != 32) || (K / 2) % 32 ||
      (compact && (K % 512 || G != 32 || mc == nullptr || dmin == nullptr)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(Npad / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GGML_Q4K_MATMUL(DT_, C_, G_)                                                 \
  q4k_matmul_kernel<DT_, C_, G_><<<grid, THREADS, 0, s>>>(                           \
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(codes), sc, mc, \
      static_cast<const DT_*>(d), static_cast<const DT_*>(dmin), static_cast<float*>(y), M, K, Npad)
#define GGML_Q4K_MATMUL_T(C_, G_) \
  if (d_bf16) GGML_Q4K_MATMUL(__nv_bfloat16, C_, G_); else GGML_Q4K_MATMUL(float, C_, G_)
  if (compact) {
    GGML_Q4K_MATMUL_T(true, 32);
  } else if (G == 16) {
    GGML_Q4K_MATMUL_T(false, 16);
  } else {
    GGML_Q4K_MATMUL_T(false, 32);
  }
#undef GGML_Q4K_MATMUL_T
#undef GGML_Q4K_MATMUL
  return (int)cudaGetLastError();
}
