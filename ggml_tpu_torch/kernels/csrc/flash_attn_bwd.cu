// Flash attention backward for f32 q, k and v: kernel L (dq) and kernel M
// (dk, dv).  The bf16 sets of both run on Hopper's wgmma in
// flash_bwd_sm90.cu.
//
// Replace (ggml_tpu/kernels/flash_attn.py) _fa_bwd_dq_kernel (:222) and
// _fa_bwd_dkv_kernel (:254), for f32 inputs, with the work _fa_train_bwd
// (:407) does around them: the padding of ragged rows (bounds are checked
// here instead), the GQA head map, the 128-lane broadcast of lse and delta
// (one f32 per row here), and the transpose of dO (read here in the (b, nq,
// h, dv) layout the forward's output has).  Per batch b, q head h (kv head h
// / (H / Hkv)), query row i and key row j, from the forward's lse and
// delta_i = rowsum(dO_i . O_i):
//   s_ij  = q_i . k_j * scale + slope_h * mask[i, j]
//   p_ij  = exp(s_ij - lse_i)
//   ds_ij = p_ij * (dO_i . v_j - delta_i) * scale
//   L: dq_i = sum_j ds_ij k_j
//   M: dv_j = sum_i p_ij dO_i,  dk_j = sum_i ds_ij q_i   (per q head: the
//      caller sums the heads that share a kv head, as the JAX wrapper does)
//
// Bound on the H100: f32 FMAs, 67 TFLOP/s outside the tensor cores.  These
// kernels serve the f32 reference paths (the tiny f32 models of the tests
// and the f32 finetune), not the bf16 training step, so they stay simple: a
// warp per row, a lane per key (L) or per query row (M) of a 32-row tile,
// lanes over output columns for the sums.

#include <cuda_runtime.h>

namespace ggml_tpu_torch {
namespace {

constexpr int F32_ROWS = 4, F32_MAXC = 8;  // rows per block; output columns per lane (d <= 256)

__device__ __forceinline__ float dot_f32(const float* a, const float* b, int n) {
  float acc = 0.f;
  for (int i = 0; i < n; ++i) acc = fmaf(a[i], b[i], acc);
  return acc;
}

// Kernel L, f32: a warp per query row, a lane per key of a 32-key tile
__global__ void __launch_bounds__(32 * F32_ROWS)
fa_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ mask, const float* __restrict__ slopes,
                     const float* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dq, int H, int Hkv, int nq, int nkv,
                     int d, int dv, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [F32_ROWS][d]
  float* os = qs + F32_ROWS * d;                   // [F32_ROWS][dv]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int row = blockIdx.x * F32_ROWS + warp;
  const float slope = slopes[h];
  if (row < nq) {
    for (int i = lane; i < d; i += 32) qs[warp * d + i] = q[((size_t)(b * H + h) * nq + row) * d + i];
    for (int i = lane; i < dv; i += 32) os[warp * dv + i] = dout[((size_t)b * nq + row) * H * dv + (size_t)h * dv + i];
  }
  __syncwarp();
  if (row >= nq) return;
  const float *qr = qs + warp * d, *orow = os + warp * dv;
  const float* kb = k + (size_t)(b * Hkv + hk) * nkv * d;
  const float* vb = v + (size_t)(b * Hkv + hk) * nkv * dv;
  const float l_i = lse[(size_t)(b * H + h) * nq + row], d_i = delta[(size_t)(b * H + h) * nq + row];

  float acc[F32_MAXC];
#pragma unroll
  for (int c = 0; c < F32_MAXC; ++c) acc[c] = 0.f;
  for (int kv0 = 0; kv0 < nkv; kv0 += 32) {
    const int j = kv0 + lane;
    float ds = 0.f;
    if (j < nkv) {
      float sv = dot_f32(qr, kb + (size_t)j * d, d) * scale;
      if (mask != nullptr) sv += slope * mask[(size_t)row * nkv + j];
      const float p = expf(sv - l_i);
      ds = p * (dot_f32(orow, vb + (size_t)j * dv, dv) - d_i) * scale;
    }
    const int n_keys = min(32, nkv - kv0);
#pragma unroll
    for (int c = 0; c < F32_MAXC; ++c) {
      if (c * 32 >= d) break;
      const int col = c * 32 + lane;
      float a = 0.f;
      for (int jj = 0; jj < n_keys; ++jj) {
        const float dsj = __shfl_sync(0xffffffffu, ds, jj);
        if (col < d) a = fmaf(dsj, kb[(size_t)(kv0 + jj) * d + col], a);
      }
      acc[c] += a;
    }
  }
  float* op = dq + ((size_t)(b * H + h) * nq + row) * d;
#pragma unroll
  for (int c = 0; c < F32_MAXC; ++c) {
    const int col = c * 32 + lane;
    if (col < d) op[col] = acc[c];
  }
}

// Kernel M, f32: a warp per key row (for one q head), a lane per query row of a 32-row tile
__global__ void __launch_bounds__(32 * F32_ROWS)
fa_bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                      const float* __restrict__ mask, const float* __restrict__ slopes,
                      const float* __restrict__ dout, const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dvo, int H,
                      int Hkv, int nq, int nkv, int d, int dv, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // [F32_ROWS][d]
  float* vs = ks + F32_ROWS * d;                   // [F32_ROWS][dv]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int j = blockIdx.x * F32_ROWS + warp;
  const float slope = slopes[h];
  if (j < nkv) {
    for (int i = lane; i < d; i += 32) ks[warp * d + i] = k[((size_t)(b * Hkv + hk) * nkv + j) * d + i];
    for (int i = lane; i < dv; i += 32) vs[warp * dv + i] = v[((size_t)(b * Hkv + hk) * nkv + j) * dv + i];
  }
  __syncwarp();
  if (j >= nkv) return;
  const float *kr = ks + warp * d, *vr = vs + warp * dv;
  const float* qb = q + (size_t)(b * H + h) * nq * d;
  const float* ob = dout + (size_t)b * nq * H * dv + (size_t)h * dv;  // row i at i * H * dv
  const size_t o_ld = (size_t)H * dv;

  float dk_acc[F32_MAXC], dv_acc[F32_MAXC];
#pragma unroll
  for (int c = 0; c < F32_MAXC; ++c) dk_acc[c] = dv_acc[c] = 0.f;
  for (int q0 = 0; q0 < nq; q0 += 32) {
    const int i = q0 + lane;
    float p = 0.f, ds = 0.f;
    if (i < nq) {
      float sv = dot_f32(qb + (size_t)i * d, kr, d) * scale;
      if (mask != nullptr) sv += slope * mask[(size_t)i * nkv + j];
      const size_t at = (size_t)(b * H + h) * nq + i;
      p = expf(sv - lse[at]);
      ds = p * (dot_f32(ob + i * o_ld, vr, dv) - delta[at]) * scale;
    }
    const int n_rows = min(32, nq - q0);
#pragma unroll
    for (int c = 0; c < F32_MAXC; ++c) {
      if (c * 32 >= d && c * 32 >= dv) break;
      const int col = c * 32 + lane;
      float av = 0.f, ak = 0.f;
      for (int ii = 0; ii < n_rows; ++ii) {
        const float pi = __shfl_sync(0xffffffffu, p, ii), dsi = __shfl_sync(0xffffffffu, ds, ii);
        if (col < dv) av = fmaf(pi, ob[(q0 + ii) * o_ld + col], av);
        if (col < d) ak = fmaf(dsi, qb[(size_t)(q0 + ii) * d + col], ak);
      }
      dv_acc[c] += av;
      dk_acc[c] += ak;
    }
  }
#pragma unroll
  for (int c = 0; c < F32_MAXC; ++c) {
    const int col = c * 32 + lane;
    if (col < d) dk[((size_t)(b * H + h) * nkv + j) * d + col] = dk_acc[c];
    if (col < dv) dvo[((size_t)(b * H + h) * nkv + j) * dv + col] = dv_acc[c];
  }
}

bool bad_shape(int B, int H, int Hkv, int nq, int nkv, int d, int dv) {
  return B < 1 || H < 1 || Hkv < 1 || H % Hkv || nq < 1 || nkv < 1 || d < 8 || dv < 8 || d % 8 || dv % 8 ||
         d > 256 || dv > 256 || H > 65535 || B > 65535;
}

}  // namespace
}  // namespace ggml_tpu_torch

// Kernel L, f32: q (B, H, nq, d), k (B, Hkv, nkv, d), v (B, Hkv, nkv, dv),
// dout (B, nq, H, dv), lse and delta (B, H, nq), all contiguous; mask
// (>= nq rows, nkv columns, row stride nkv) or null; slopes (H).  Writes dq
// (B, H, nq, d); d and dv multiples of 8 up to 256.
extern "C" int flash_attn_bwd_dq_f32(const void* q, const void* k, const void* v, const void* mask,
                                     const void* slopes, const void* dout, const void* lse, const void* delta, void* dq,
                                     int B, int H, int Hkv, int nq, int nkv, int d, int dv, float scale, void* stream) {
  using namespace ggml_tpu_torch;
  if (bad_shape(B, H, Hkv, nq, nkv, d, dv)) return (int)cudaErrorInvalidValue;
  const dim3 grid((nq + F32_ROWS - 1) / F32_ROWS, H, B);
  fa_bwd_dq_f32_kernel<<<grid, 32 * F32_ROWS, F32_ROWS * (d + dv) * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(mask), static_cast<const float*>(slopes), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<float*>(dq), H, Hkv, nq, nkv, d, dv,
      scale);
  return (int)cudaGetLastError();
}

// Kernel M, f32: dk (B, H, nkv, d) and dv (B, H, nkv, dv), per q head; d and
// dv multiples of 8 up to 256.
extern "C" int flash_attn_bwd_dkv_f32(const void* q, const void* k, const void* v, const void* mask,
                                      const void* slopes, const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv_out, int B, int H, int Hkv, int nq, int nkv, int d, int dv,
                                      float scale, void* stream) {
  using namespace ggml_tpu_torch;
  if (bad_shape(B, H, Hkv, nq, nkv, d, dv)) return (int)cudaErrorInvalidValue;
  const dim3 grid((nkv + F32_ROWS - 1) / F32_ROWS, H, B);
  fa_bwd_dkv_f32_kernel<<<grid, 32 * F32_ROWS, F32_ROWS * (d + dv) * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(mask), static_cast<const float*>(slopes), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv_out), H, Hkv, nq, nkv, d, dv, scale);
  return (int)cudaGetLastError();
}
