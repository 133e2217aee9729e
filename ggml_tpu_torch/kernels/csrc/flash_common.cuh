// Device helpers shared by the flash-attention kernels (flash_attn.cu: the
// all-f32 sets of J and K; flash_attn_sm90.cu: J and K; flash_attn_bwd.cu: L
// and M's f32 set; flash_bwd_sm90.cu: M): the fold of the JAX wrappers' kv
// padding, the hi + lo bf16 split, and L's tile loads into shared memory,
// m16n8k16 bf16 tensor-core product and operand fragments.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ggml_tpu_torch {
namespace {

constexpr float NEG_SENTINEL = -1e30f;
constexpr int BQ = 64, BKV = 64, FA_THREADS = 128, PAD = 8;

// The JAX wrappers (flash_attention, _fa_setup) pad kv to a multiple of 32
// with zero rows masked -1e30 times the slope; a padded column's score is
// then slope * -1e30 (0 from the zero k, also under softcap).  fold_padding
// folds those n_pad columns into a finished row (m, l): m' = max(m, slope *
// -1e30), l' = l e^(m - m') + n_pad e^(slope * -1e30 - m'); c = e^(m - m') is
// what the row's accumulator is multiplied by.  Live rows are untouched (c =
// 1, the pad terms exactly 0); a row masked -1e30 everywhere averages v over
// the padded length, as in JAX.
__device__ __forceinline__ void fold_padding(float& m, float& l, float& c, int n_pad, float slope) {
  c = 1.f;
  if (n_pad == 0) return;
  const float mp = slope * NEG_SENTINEL;
  const float mn = fmaxf(m, mp);
  c = expf(m - mn);
  l = l * c + (float)n_pad * expf(mp - mn);
  m = mn;
}

__device__ __forceinline__ int kv_padding(int nkv) { return (nkv + 31) / 32 * 32 - nkv; }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half), .y = hi
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x and y rounded to bf16 (the hi word) and what the rounding left (the lo word)
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - __low2float(h), y - __high2float(h));
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 bf16 matrices of shared memory, transposed: the B operand of
// m16n8k16 when B's k index runs along the rows of a [k][n] tile
__device__ __forceinline__ void ldsm_x4_trans(const __nv_bfloat16* p, uint32_t& b0, uint32_t& b1,
                                              uint32_t& b2, uint32_t& b3) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
               : "r"(addr));
}

// rows x HD tile of bf16 rows (row stride src_ld elements, `cols` valid
// columns, `rows` valid rows) -> shared tile [64][HD + PAD], zero elsewhere
template <int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src, int rows,
                                          int cols, size_t src_ld) {
  constexpr int CH = HD / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < 64 * CH; i += FA_THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < rows && c < cols) v = *reinterpret_cast<const uint4*>(src + (size_t)r * src_ld + c);
    *reinterpret_cast<uint4*>(dst + r * (HD + PAD) + c) = v;
  }
}

// the A operand of m16n8k16 (rows g and g + 8, columns 2t.. and 2t + 8..) at qp
__device__ __forceinline__ void load_a_frag(uint32_t a[4], const __nv_bfloat16* qp, int ld) {
  a[0] = *reinterpret_cast<const uint32_t*>(qp);
  a[1] = *reinterpret_cast<const uint32_t*>(qp + 8 * ld);
  a[2] = *reinterpret_cast<const uint32_t*>(qp + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(qp + 8 * ld + 8);
}

// C = A B^T over HD columns for one warp: A's 16 rows from row a_row of the
// shared tile As, B's 64 rows (the 64 columns of C) from Bs; both [64][HD + PAD].
// C lands in 8 accumulator tiles of 16 x 8, which are also the A operand
// layout of a following product over C's columns.
template <int HD>
__device__ __forceinline__ void mma_abt(float c[BKV / 8][4], const __nv_bfloat16* As, int a_row,
                                        const __nv_bfloat16* Bs, int g, int t) {
  constexpr int LD = HD + PAD;
#pragma unroll
  for (int j = 0; j < BKV / 8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    load_a_frag(a, As + a_row * LD + kk * 16 + 2 * t, LD);
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      const __nv_bfloat16* bp = Bs + (j * 8 + g) * LD + kk * 16 + 2 * t;
      mma_bf16(c[j], a, *reinterpret_cast<const uint32_t*>(bp), *reinterpret_cast<const uint32_t*>(bp + 8));
    }
  }
}

// acc += X B over 64 k rows for one warp, X an f32 16 x 64 tile in the
// accumulator layout of mma_abt (x[j][e]) and B the shared tile [64][HD + PAD]
// (k rows, HD columns).  X is not rounded to bf16: it goes in as hi + lo,
// two products, the small one first, so that what is lost (the rounding of
// lo) is below 2^-16 of each term.
template <int HD>
__device__ __forceinline__ void mma_split_xb(float acc[HD / 8][4], float x[BKV / 8][4],
                                             const __nv_bfloat16* Bs, int lane) {
  constexpr int LD = HD + PAD;
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) {
    uint32_t hi[4], lo[4];
    split_bf16(x[2 * kk][0], x[2 * kk][1], hi[0], lo[0]);
    split_bf16(x[2 * kk][2], x[2 * kk][3], hi[1], lo[1]);
    split_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1], hi[2], lo[2]);
    split_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3], hi[3], lo[3]);
    // lanes 0-15 address the 16 k rows at column 16 * jj, lanes 16-31 at 16 * jj + 8
    const __nv_bfloat16* bp = Bs + (kk * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
    for (int jj = 0; jj < HD / 16; ++jj) {
      uint32_t b0, b1, b2, b3;
      ldsm_x4_trans(bp + jj * 16, b0, b1, b2, b3);
      mma_bf16(acc[2 * jj], lo, b0, b1);
      mma_bf16(acc[2 * jj + 1], lo, b2, b3);
      mma_bf16(acc[2 * jj], hi, b0, b1);
      mma_bf16(acc[2 * jj + 1], hi, b2, b3);
    }
  }
}

}  // namespace
}  // namespace ggml_tpu_torch
