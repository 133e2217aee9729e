// Flash attention forward for f32 q, k and v (online softmax over key/value
// tiles): kernel J's all-f32 set (the prefill) and kernel K's (the training
// forward, which also gives the logsumexp).  J's bf16 and f32-q/k sets and
// K's bf16 set run on Hopper's wgmma in flash_attn_sm90.cu.
//
// For f32 inputs J replaces (ggml_tpu/kernels/flash_attn.py) _fa_kernel
// (:30) and K replaces _fa_fwd_lse_kernel (:180), each with the work its
// wrapper does around it (flash_attention :75, _fa_forward_lse :338: the
// padding of ragged rows, the GQA map; K's 128-lane LSE broadcast is
// dropped).  Per batch b, head h (kv head h / (H / Hkv)) and query row i
//   s_j = q_i . k_j * scale + slope_h * mask[i, j]        (if a mask is given;
//         J: tanh(q_i . k_j * scale / softcap) * softcap before the mask)
//   out_i = sum_j softmax_j(s) * v_j,   K: lse_i = m + log(l)
// as the online-softmax recurrence: running max m (starting at the finite
// sentinel -1e30, so a mask value of -inf never makes NaN), running sum l,
// f32 sums.  The JAX wrappers pad kv to a multiple of 32 with zero rows
// masked -1e30 (times the slope): the epilogue folds those columns in
// (fold_padding).  Dead rows: J's are those whose folded max is at or below
// -5e29, K's those with l' = 0 (o = 0, lse = +1e30, so the backward's
// exp(s - lse) is 0).
//
// Bound: f32 FMAs (67 TFLOP/s on the H100); these kernels serve the f32
// reference paths (the CPU tests' type, the tiny f32 models), not the bf16
// training and prefill.  Design (simple, not fast): a warp per query row, a
// lane per key of a 32-key tile for the scores and per output column
// (stride 32, up to 256 columns) for p . v.  No tile is skipped.

#include "common.cuh"
#include "flash_common.cuh"

namespace ggml_tpu_torch {
namespace {

constexpr int F32_ROWS = 4, F32_MAXC = 8;  // rows per block; output columns per lane (dv <= 256)

// LSE: kernel K (no softcap, dead rows l' = 0, lse written); else kernel J
// (softcap, rows whose folded max m' <= -5e29 give zeros).
template <bool LSE>
__global__ void __launch_bounds__(32 * F32_ROWS)
flash_attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const float* __restrict__ mask,
                      const float* __restrict__ slopes, float* __restrict__ out, float* __restrict__ lse,
                      int H, int Hkv, int nq, int nkv, int d, int dv, float scale, float softcap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [F32_ROWS][d]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int row = blockIdx.x * F32_ROWS + warp;
  const float slope = slopes[h];
  if (row < nq) {
    const float* qp = q + ((size_t)(b * H + h) * nq + row) * d;
    for (int i = lane; i < d; i += 32) qs[warp * d + i] = qp[i];
  }
  __syncwarp();
  if (row >= nq) return;
  const float* qr = qs + warp * d;
  const float* kb = k + (size_t)(b * Hkv + hk) * nkv * d;
  const float* vb = v + (size_t)(b * Hkv + hk) * nkv * dv;

  float m = NEG_SENTINEL, l = 0.f, o[F32_MAXC];
#pragma unroll
  for (int c = 0; c < F32_MAXC; ++c) o[c] = 0.f;

  for (int kv0 = 0; kv0 < nkv; kv0 += 32) {
    const int j = kv0 + lane;
    float sv = -INFINITY;
    if (j < nkv) {
      const float* kp = kb + (size_t)j * d;
      float dot = 0.f;
      for (int i = 0; i < d; ++i) dot = fmaf(qr[i], kp[i], dot);
      sv = !LSE && softcap != 0.f ? tanhf(dot * scale) * softcap : dot * scale;
      if (mask != nullptr) sv += slope * mask[(size_t)row * nkv + j];
    }
    const float mn = fmaxf(m, warp_max(sv));
    const float p = expf(sv - mn), alpha = expf(m - mn);
    m = mn;
    l = l * alpha + warp_sum(p);
    const int n_keys = min(32, nkv - kv0);
#pragma unroll
    for (int c = 0; c < F32_MAXC; ++c) {
      if (c * 32 >= dv) break;
      const int col = c * 32 + lane;
      float acc = 0.f;
      for (int jj = 0; jj < n_keys; ++jj) {
        const float pj = __shfl_sync(0xffffffffu, p, jj);
        if (col < dv) acc = fmaf(pj, vb[(size_t)(kv0 + jj) * dv + col], acc);
      }
      o[c] = o[c] * alpha + acc;
    }
  }
  float cf;
  fold_padding(m, l, cf, kv_padding(nkv), slope);
  bool dead = m <= 0.5f * NEG_SENTINEL;  // J: JAX's test on the padded row
  if constexpr (LSE) {
    dead = l == 0.f;
    if (lane == 0) lse[((size_t)b * H + h) * nq + row] = dead ? -NEG_SENTINEL : m + logf(l);
  }
  if (l == 0.f) l = 1.f;
  float* op = out + ((size_t)(b * nq + row) * H + h) * dv;
#pragma unroll
  for (int c = 0; c < F32_MAXC; ++c) {
    const int col = c * 32 + lane;
    if (col < dv) op[col] = dead ? 0.f : o[c] * cf / l;
  }
}

bool bad_shape(int B, int H, int Hkv, int nq, int nkv, int d, int dv, int top) {
  return B < 1 || H < 1 || Hkv < 1 || H % Hkv || nq < 1 || nkv < 1 || d < 8 || dv < 8 || d % 8 || dv % 8 ||
         d > top || dv > top || H > 65535 || B > 65535;
}

template <bool LSE>
int launch_f32(cudaStream_t s, const void* q, const void* k, const void* v, const void* mask, const void* slopes,
               void* out, float* lse, int B, int H, int Hkv, int nq, int nkv, int d, int dv, float scale,
               float softcap) {
  const dim3 grid((nq + F32_ROWS - 1) / F32_ROWS, H, B);
  flash_attn_f32_kernel<LSE><<<grid, 32 * F32_ROWS, F32_ROWS * d * sizeof(float), s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(mask), static_cast<const float*>(slopes), static_cast<float*>(out), lse, H, Hkv,
      nq, nkv, d, dv, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ggml_tpu_torch

// q (B, H, nq, d), k (B, Hkv, nkv, d), v (B, Hkv, nkv, dv) -> out (B, nq, H,
// dv), contiguous f32.  mask: f32 (>= nq rows, nkv columns, row stride nkv)
// or null; slopes: f32 (H).  d and dv: multiples of 8 up to 256.
// lse null: kernel J (score_scale is `scale`, or scale / softcap where
// softcap != 0).  lse f32 (B, H, nq): kernel K (softcap must be 0).
extern "C" int flash_attn_f32(const void* q, const void* k, const void* v, const void* mask, const void* slopes,
                              void* out, void* lse, int B, int H, int Hkv, int nq, int nkv, int d, int dv,
                              float score_scale, float softcap, void* stream) {
  using namespace ggml_tpu_torch;
  if (bad_shape(B, H, Hkv, nq, nkv, d, dv, 256) || (lse != nullptr && softcap != 0.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(lse);
  if (lp != nullptr)
    return launch_f32<true>(s, q, k, v, mask, slopes, out, lp, B, H, Hkv, nq, nkv, d, dv, score_scale, 0.f);
  return launch_f32<false>(s, q, k, v, mask, slopes, out, nullptr, B, H, Hkv, nq, nkv, d, dv, score_scale, softcap);
}
