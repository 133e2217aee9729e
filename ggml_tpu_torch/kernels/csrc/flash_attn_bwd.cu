// Flash attention backward: kernel L (dq, bf16 and f32) and kernel M's f32
// set (dk, dv).  M's bf16 set runs on Hopper's wgmma in flash_bwd_sm90.cu.
//
// Replace (ggml_tpu/kernels/flash_attn.py) _fa_bwd_dq_kernel (:222) and, for
// f32 inputs, _fa_bwd_dkv_kernel (:254) with the work _fa_train_bwd (:407)
// does around them: the padding of ragged rows (bounds are checked here
// instead), the GQA head map, the 128-lane broadcast of lse and delta (one
// f32 per row here), and the transpose of dO (read here in the (b, nq, h,
// dv) layout the forward's output has).  Per batch b, q head h (kv head h /
// (H / Hkv)), query row i and key row j, from the forward's lse and delta_i =
// rowsum(dO_i . O_i):
//   s_ij  = q_i . k_j * scale + slope_h * mask[i, j]
//   p_ij  = exp(s_ij - lse_i)                    (f32, never rounded)
//   ds_ij = p_ij * (dO_i . v_j - delta_i) * scale
//   L: dq_i = sum_j ds_ij k_j
//   M: dv_j = sum_i p_ij dO_i,  dk_j = sum_i ds_ij q_i   (per q head: the
//      caller sums the heads that share a kv head, as the JAX wrapper does)
// Outputs in the inputs' type.
//
// Bound of L on the H100 at GPT-2-medium's training shape (b=8, h=16,
// nq=nkv=512, d=64, causal, bf16): bytes, q, k, v, dO, the mask, lse and
// delta read and dq written (43.5 MB, 13 us); the causal half's three
// products (64 x 64 x 64 per pair of tiles) take 6.5 us at the bf16
// tensor-core rate.
//
// Design of L's bf16 kernel (simple, not fast): a block of 4 warps owns 64
// query rows, a warp 16 of them, and walks the kv rows in tiles of 64; Q, dO,
// K and V tiles sit in shared memory as bf16 rows padded by 16 bytes, head
// dims padded with zeros to HD = 64 or 128.  S = Q K^T and dP = dO V^T come
// from mma.sync m16n8k16 with f32 accumulators, whose layout is the A operand
// of the next product.  ds stays f32, as in the JAX kernel: it enters dS K as
// hi + lo bf16 pairs, two products, so what is lost is below 2^-16 of a term
// where one bf16 product would lose 2^-9.  The accumulators stay in
// registers.  The slope-scaled mask tile is staged in shared memory once per
// step.  A tile whose mask entries are all at or below -5e29 is skipped where
// every row's lse of the block is above -2.5e29: every p in it is then
// exactly 0.  A row masked with the finite -1e30 everywhere has lse about
// -1e30 and p = 1 on every column (the JAX kernels' arithmetic); where the
// block holds one, nothing is skipped.  No cp.async, no double buffering, no
// wgmma.
//
// f32 inputs take plain-FMA kernels (bound: f32 FMAs; they serve the f32
// reference paths): a warp per row, a lane per key (L) or per query row (M)
// of a 32-row tile, lanes over output columns for the sums.

#include "flash_common.cuh"

namespace ggml_tpu_torch {
namespace {

constexpr int MLD = BKV + 1;  // row stride of the staged mask tile (floats)

template <int HD>
constexpr int bwd_smem_bytes() {
  return 4 * 64 * (HD + PAD) * (int)sizeof(__nv_bfloat16) + BQ * MLD * (int)sizeof(float);
}

// Kernel L, bf16: dq for 64 query rows of one head
template <int HD>
__global__ void __launch_bounds__(FA_THREADS)
fa_bwd_dq_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
                      const float* __restrict__ slopes, const __nv_bfloat16* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      __nv_bfloat16* __restrict__ dq, int H, int Hkv, int nq, int nkv, int d, int dv,
                      float scale) {
  constexpr int LD = HD + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Os = Qs + 64 * LD;  // dO
  __nv_bfloat16* Ks = Os + 64 * LD;
  __nv_bfloat16* Vs = Ks + 64 * LD;
  float* Ms = reinterpret_cast<float*>(Vs + 64 * LD);  // [BQ][MLD] slope * mask

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const float slope = slopes[h];
  const bool have_mask = mask != nullptr;
  const int rows = min(BQ, nq - q0);

  load_tile<HD>(Qs, q + ((size_t)(b * H + h) * nq + q0) * d, rows, d, d);
  load_tile<HD>(Os, dout + ((size_t)b * nq + q0) * H * dv + (size_t)h * dv, rows, dv, (size_t)H * dv);
  const __nv_bfloat16* kb = k + (size_t)(b * Hkv + hk) * nkv * d;
  const __nv_bfloat16* vb = v + (size_t)(b * Hkv + hk) * nkv * dv;

  // this thread's two rows r_lo = 16 * warp + g and r_lo + 8; a row past nq
  // gets lse = +1e30, so its p is 0
  const int r_lo = 16 * warp + g;
  float lse_r[2], del_r[2];
  bool low = false;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r_lo + 8 * half;
    lse_r[half] = row < nq ? lse[(size_t)(b * H + h) * nq + row] : -NEG_SENTINEL;
    del_r[half] = row < nq ? delta[(size_t)(b * H + h) * nq + row] : 0.f;
    low = low || lse_r[half] <= 0.25f * NEG_SENTINEL;
  }
  const bool may_skip = have_mask && !__syncthreads_or(low);

  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int kv0 = 0; kv0 < nkv; kv0 += BKV) {
    const int cols = min(BKV, nkv - kv0);
    __syncthreads();  // the previous tile's K, V and mask are read
    if (have_mask) {
      int live = 0;
      for (int i = threadIdx.x; i < BQ * BKV; i += FA_THREADS) {
        const int r = i / BKV, c = i % BKV;
        float m = -INFINITY;
        if (r < rows && c < cols) {
          m = slope * mask[(size_t)(q0 + r) * nkv + kv0 + c];
          live |= m > 0.5f * NEG_SENTINEL;
        }
        Ms[r * MLD + c] = m;
      }
      if (may_skip && !__syncthreads_or(live)) continue;
    }
    load_tile<HD>(Ks, kb + (size_t)kv0 * d, cols, d, d);
    load_tile<HD>(Vs, vb + (size_t)kv0 * dv, cols, dv, dv);
    __syncthreads();

    float s[BKV / 8][4], dp[BKV / 8][4];
    mma_abt<HD>(s, Qs, r_lo, Ks, g, t);   // S = Q K^T
    mma_abt<HD>(dp, Os, r_lo, Vs, g, t);  // dP = dO V^T
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = j * 8 + 2 * t + (e & 1), half = e >> 1;
        float ds = 0.f;
        if (c < cols) {
          float sv = s[j][e] * scale;
          if (have_mask) sv += Ms[(r_lo + 8 * half) * MLD + c];
          const float p = expf(sv - lse_r[half]);
          ds = p * (dp[j][e] - del_r[half]) * scale;
        }
        s[j][e] = ds;
      }
    }
    mma_split_xb<HD>(acc, s, Ks, lane);  // dQ += dS K
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r_lo + 8 * half;
    if (row >= nq) continue;
    __nv_bfloat16* op = dq + ((size_t)(b * H + h) * nq + row) * d;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (col < d)
        *reinterpret_cast<__nv_bfloat162*>(op + col) = __floats2bfloat162_rn(acc[j][2 * half], acc[j][2 * half + 1]);
    }
  }
}

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

template <int HD>
int launch_dq_bf16(dim3 grid, cudaStream_t s, const void* q, const void* k, const void* v, const void* mask,
                   const void* slopes, const void* dout, const void* lse, const void* delta, void* dq, int H, int Hkv,
                   int nq, int nkv, int d, int dv, float scale) {
  using bf = __nv_bfloat16;
  constexpr int smem = bwd_smem_bytes<HD>();
  const cudaError_t rc = cudaFuncSetAttribute(fa_bwd_dq_bf16_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              smem);
  if (rc != cudaSuccess) return (int)rc;
  fa_bwd_dq_bf16_kernel<HD><<<grid, FA_THREADS, smem, s>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v), static_cast<const float*>(mask),
      static_cast<const float*>(slopes), static_cast<const bf*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf*>(dq), H, Hkv, nq, nkv, d, dv, scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int H, int Hkv, int nq, int nkv, int d, int dv, int top) {
  return B < 1 || H < 1 || Hkv < 1 || H % Hkv || nq < 1 || nkv < 1 || d < 8 || dv < 8 || d % 8 || dv % 8 ||
         d > top || dv > top || H > 65535 || B > 65535;
}

}  // namespace
}  // namespace ggml_tpu_torch

// q (B, H, nq, d), k (B, Hkv, nkv, d), v (B, Hkv, nkv, dv), dout (B, nq, H, dv),
// lse and delta f32 (B, H, nq), all contiguous; mask f32 (>= nq rows, nkv
// columns, row stride nkv) or null; slopes f32 (H).
// Kernel L: dq (B, H, nq, d).  types: 0 = all f32 (d, dv multiples of 8 up
// to 256), 1 = all bf16 (up to 128).
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* mask, const void* slopes,
                                 const void* dout, const void* lse, const void* delta, void* dq, int types, int B,
                                 int H, int Hkv, int nq, int nkv, int d, int dv, float scale, void* stream) {
  using namespace ggml_tpu_torch;
  if (types < 0 || types > 1 || bad_shape(B, H, Hkv, nq, nkv, d, dv, types == 0 ? 256 : 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (types == 0) {
    const dim3 grid((nq + F32_ROWS - 1) / F32_ROWS, H, B);
    fa_bwd_dq_f32_kernel<<<grid, 32 * F32_ROWS, F32_ROWS * (d + dv) * sizeof(float), s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(mask), static_cast<const float*>(slopes), static_cast<const float*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<float*>(dq), H, Hkv, nq, nkv, d,
        dv, scale);
    return (int)cudaGetLastError();
  }
  const dim3 grid((nq + 63) / 64, H, B);
  if ((d > dv ? d : dv) <= 64)
    return launch_dq_bf16<64>(grid, s, q, k, v, mask, slopes, dout, lse, delta, dq, H, Hkv, nq, nkv, d, dv, scale);
  return launch_dq_bf16<128>(grid, s, q, k, v, mask, slopes, dout, lse, delta, dq, H, Hkv, nq, nkv, d, dv, scale);
}

// Kernel M, f32: dk (B, H, nkv, d) and dv (B, H, nkv, dv), per q head; d and
// dv multiples of 8 up to 256.
extern "C" int flash_attn_bwd_dkv_f32(const void* q, const void* k, const void* v, const void* mask,
                                      const void* slopes, const void* dout, const void* lse, const void* delta,
                                      void* dk, void* dv_out, int B, int H, int Hkv, int nq, int nkv, int d, int dv,
                                      float scale, void* stream) {
  using namespace ggml_tpu_torch;
  if (bad_shape(B, H, Hkv, nq, nkv, d, dv, 256)) return (int)cudaErrorInvalidValue;
  const dim3 grid((nkv + F32_ROWS - 1) / F32_ROWS, H, B);
  fa_bwd_dkv_f32_kernel<<<grid, 32 * F32_ROWS, F32_ROWS * (d + dv) * sizeof(float), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(mask), static_cast<const float*>(slopes), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv_out), H, Hkv, nq, nkv, d, dv, scale);
  return (int)cudaGetLastError();
}
