// Device helpers shared by the flash-attention kernels (flash_attn.cu: the
// all-f32 sets of J and K; flash_attn_sm90.cu: J and K; flash_bwd_sm90.cu: L
// and M): the finite sentinel, the fold of the JAX wrappers' kv padding and
// the hi + lo bf16 split.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ggml_tpu_torch {
namespace {

constexpr float NEG_SENTINEL = -1e30f;

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

}  // namespace
}  // namespace ggml_tpu_torch
