// Flash attention forward (online softmax over key/value tiles): kernel K
// (the training forward, which also gives the logsumexp) and the f32 type
// set of kernel J (the prefill).  J's bf16 and f32-q/k sets run in
// flash_attn_sm90.cu.
//
// K replaces (ggml_tpu/kernels/flash_attn.py) _fa_fwd_lse_kernel (:180) with
// the work _fa_forward_lse (:338) does around it (GQA map; the 128-lane LSE
// broadcast is dropped).  Per batch b, head h (kv head h / (H / Hkv)) and
// query row i it computes
//   s_j = q_i . k_j * scale + slope_h * mask[i, j]        (if a mask is given)
//   out_i = sum_j softmax_j(s) * v_j,   lse_i = m + log(l)
// as the online-softmax recurrence over kv tiles: running max m (starting at
// the finite sentinel -1e30, so a mask value of -inf never makes NaN),
// running sum l, p = exp(s - m) rounded to v's type before p . v, f32 sums.
// _fa_setup (:291) pads kv to a multiple of 32 with zero rows whose mask is
// -1e30 (times the slope, with or without a mask): the epilogue folds those
// n_pad columns in, m' = max(m, slope * -1e30), l' = l e^(m - m') + n_pad
// e^(slope * -1e30 - m'), o = acc e^(m - m') / l'.  Live rows are untouched
// (their pad terms are exactly 0); a row masked -1e30 everywhere averages v
// over the padded length, as in JAX.  Dead rows are those with l' = 0 (every
// score -inf and no padding): o = 0 and lse = +1e30, so the backward's
// exp(s - lse) is 0.
//
// Two kernels:
//   bf16 q/k/v: tensor cores, mma.sync m16n8k16 bf16 with f32 accumulation.
//     bf16 products are exact in f32, so the scores equal the TPU kernel's
//     f32 dots up to the order of the sums.
//   f32 q/k/v (what the reference tests feed; also J's f32 set, replacing
//     _fa_kernel (:30) for f32 inputs): plain FMAs, one warp per row.
//
// Bound on the H100 at GPT-2-medium's training shape (b=8, h=16, nq=nkv=512,
// d=64, bf16, causal): bytes, q, k, v, o, the mask and the lse (10.4 us).
//
// Design of the bf16 kernel (simple, not fast): a block of 4 warps owns 64
// query rows of one head, a warp 16 of them; it walks the kv rows in tiles of
// 64.  Q, K and V tiles sit in shared memory as bf16 rows padded by 16 bytes
// (conflict-free fragment loads), head dims padded with zeros to HD = 64 or
// 128.  S = Q K^T lands in mma accumulators whose layout is the A-operand
// layout of the next product, so P goes from registers straight into P V; V
// fragments come through ldmatrix.trans.  The output accumulators, m and l
// stay in registers.  A kv tile whose mask entries (times the slope) are all
// at or below -5e29 for the block's rows is skipped before K and V are
// loaded.  The skip is exact only for rows whose max ends above -2.5e29 (the
// skipped scores sit 2.5e29 below it, so their p and the terms they would
// have added before the row came alive are exactly 0): if a tile was skipped
// and a row of the block ends at or below that, the block walks every tile
// again without skipping.  No cp.async, no double buffering, no wgmma.

#include "common.cuh"
#include "flash_common.cuh"

namespace ggml_tpu_torch {
namespace {

template <int HD>
__global__ void __launch_bounds__(FA_THREADS)
flash_attn_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
                       const float* __restrict__ slopes, __nv_bfloat16* __restrict__ out,
                       float* __restrict__ lse, int H, int Hkv, int nq, int nkv, int d, int dv, float scale) {
  constexpr int LD = HD + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + 64 * LD;
  __nv_bfloat16* Vs = Ks + 64 * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const float slope = slopes[h];
  const bool have_mask = mask != nullptr;

  load_tile<HD>(Qs, q + ((size_t)(b * H + h) * nq + q0) * d, min(BQ, nq - q0), d, d);
  const __nv_bfloat16* kb = k + (size_t)(b * Hkv + hk) * nkv * d;
  const __nv_bfloat16* vb = v + (size_t)(b * Hkv + hk) * nkv * dv;

  // this thread's two rows: r_lo = 16 * warp + g and r_lo + 8 of the block
  const int r_lo = 16 * warp + g;
  const int row_lo = min(q0 + r_lo, nq - 1), row_hi = min(q0 + r_lo + 8, nq - 1);  // clamped for mask reads
  float m_lo, m_hi, l_lo, l_hi;
  float o[HD / 8][4];
  bool may_skip = have_mask;
  for (;;) {  // one walk over the kv tiles; again without skipping where that was not exact
  m_lo = m_hi = NEG_SENTINEL;
  l_lo = l_hi = 0.f;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  bool skipped = false;

  for (int kv0 = 0; kv0 < nkv; kv0 += BKV) {
    if (may_skip) {  // skip a tile that is masked out for every row of the block
      int live = 0;
      const int rows = min(BQ, nq - q0), cols = min(BKV, nkv - kv0);
      for (int i = threadIdx.x; i < rows * BKV; i += FA_THREADS) {
        const int r = i / BKV, c = i % BKV;
        if (c < cols && slope * mask[(size_t)(q0 + r) * nkv + kv0 + c] > 0.5f * NEG_SENTINEL) live = 1;
      }
      if (!__syncthreads_or(live)) {
        skipped = true;
        continue;
      }
    }
    __syncthreads();  // the previous tile's K and V are read
    load_tile<HD>(Ks, kb + (size_t)kv0 * d, min(BKV, nkv - kv0), d, d);
    load_tile<HD>(Vs, vb + (size_t)kv0 * dv, min(BKV, nkv - kv0), dv, dv);
    __syncthreads();

    // S = Q K^T: 16 rows x 64 kv columns per warp, 8 accumulator tiles of 16 x 8
    float s[BKV / 8][4];
    mma_abt<HD>(s, Qs, r_lo, Ks, g, t);

    // scores: scale, mask, kv columns past nkv out
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + j * 8 + 2 * t + (e & 1);
        float sv = s[j][e] * scale;
        if (col >= nkv) {
          sv = -INFINITY;
        } else if (have_mask) {
          sv += slope * mask[(size_t)(e < 2 ? row_lo : row_hi) * nkv + col];
        }
        s[j][e] = sv;
        if (e < 2) mx_lo = fmaxf(mx_lo, sv); else mx_hi = fmaxf(mx_hi, sv);
      }
    }
    // a row lives in the 4 lanes of a quad
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float al_lo = expf(m_lo - mn_lo), al_hi = expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float ps_lo = 0.f, ps_hi = 0.f;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
      s[j][0] = expf(s[j][0] - mn_lo);
      s[j][1] = expf(s[j][1] - mn_lo);
      s[j][2] = expf(s[j][2] - mn_hi);
      s[j][3] = expf(s[j][3] - mn_hi);
      ps_lo += s[j][0] + s[j][1];
      ps_hi += s[j][2] + s[j][3];
    }
    // each lane keeps the sum of its own columns; the quad's lanes share alpha
    l_lo = l_lo * al_lo + ps_lo;
    l_hi = l_hi * al_hi + ps_hi;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[j][0] *= al_lo;
      o[j][1] *= al_lo;
      o[j][2] *= al_hi;
      o[j][3] *= al_hi;
    }

    // O += P V, P rounded to bf16 (v's type) in the A-operand layout
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      // lanes 0-15 address the 16 kv rows at dv column 16 * jj, lanes 16-31 at 16 * jj + 8
      const __nv_bfloat16* vp = Vs + (kk * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int jj = 0; jj < HD / 16; ++jj) {
        uint32_t b0, b1, b2, b3;
        ldsm_x4_trans(vp + jj * 16, b0, b1, b2, b3);
        mma_bf16(o[2 * jj], a, b0, b1);
        mma_bf16(o[2 * jj + 1], a, b2, b3);
      }
    }
  }
  // skipped is the same in every thread; rows past nq do not count
  const bool low = (q0 + r_lo < nq && m_lo <= 0.25f * NEG_SENTINEL) ||
                   (q0 + r_lo + 8 < nq && m_hi <= 0.25f * NEG_SENTINEL);
  if (!__syncthreads_or(skipped && low)) break;
  may_skip = false;
  }

  // a row's l is spread over its quad
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  const int n_pad = kv_padding(nkv);
  float c_lo, c_hi;
  fold_padding(m_lo, l_lo, c_lo, n_pad, slope);
  fold_padding(m_hi, l_hi, c_hi, n_pad, slope);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r_lo + 8 * half;
    if (row >= nq) continue;
    const float m = half ? m_hi : m_lo, c = half ? c_hi : c_lo;
    const bool dead = (half ? l_hi : l_lo) == 0.f;  // o = 0, lse = +1e30
    const float l = dead ? 1.f : (half ? l_hi : l_lo);
    if (t == 0) lse[((size_t)b * H + h) * nq + row] = dead ? -NEG_SENTINEL : m + logf(l);
    __nv_bfloat16* op = out + ((size_t)(b * nq + row) * H + h) * dv;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (col < dv) {
        const float x0 = dead ? 0.f : o[j][2 * half] * c / l, x1 = dead ? 0.f : o[j][2 * half + 1] * c / l;
        *reinterpret_cast<__nv_bfloat162*>(op + col) = __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

// f32 inputs: a warp per query row, a lane per key of a 32-key tile for the
// scores and per output column (stride 32, up to 256 columns) for p . v.
// No tile is skipped.  Both fold in the JAX wrappers' kv padding.  LSE:
// kernel K (no softcap, dead rows l' = 0, lse written); else kernel J
// (softcap, rows whose folded max m' <= -5e29 give zeros).
constexpr int F32_ROWS = 4, F32_MAXC = 8;

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

template <int HD>
int launch_bf16(dim3 grid, cudaStream_t s, const void* q, const void* k, const void* v, const void* mask,
                const void* slopes, void* out, float* lse, int H, int Hkv, int nq, int nkv, int d, int dv,
                float scale) {
  constexpr int smem = 3 * 64 * (HD + PAD) * (int)sizeof(__nv_bfloat16);
  const cudaError_t rc = cudaFuncSetAttribute(flash_attn_bf16_kernel<HD>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  using bf = __nv_bfloat16;
  flash_attn_bf16_kernel<HD><<<grid, FA_THREADS, smem, s>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const float*>(mask), static_cast<const float*>(slopes), static_cast<bf*>(out), lse, H, Hkv,
      nq, nkv, d, dv, scale);
  return (int)cudaGetLastError();
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

// Kernel J, f32 q/k/v.  q (B, H, nq, d), k (B, Hkv, nkv, d), v (B, Hkv, nkv,
// dv) -> out (B, nq, H, dv), contiguous f32.  mask: f32 (>= nq rows, nkv
// columns, row stride nkv) or null; slopes: f32 (H).  score_scale is
// `scale`, or scale / softcap where softcap != 0.  d and dv: multiples of 8
// up to 256.
extern "C" int flash_attn_f32(const void* q, const void* k, const void* v, const void* mask, const void* slopes,
                              void* out, int B, int H, int Hkv, int nq, int nkv, int d, int dv, float score_scale,
                              float softcap, void* stream) {
  using namespace ggml_tpu_torch;
  if (bad_shape(B, H, Hkv, nq, nkv, d, dv, 256)) return (int)cudaErrorInvalidValue;
  return launch_f32<false>(static_cast<cudaStream_t>(stream), q, k, v, mask, slopes, out, nullptr, B, H, Hkv, nq,
                           nkv, d, dv, score_scale, softcap);
}

// Kernel K: J's arguments without softcap, and lse, f32 (B, H, nq).
// types: 0 = all f32 (d, dv up to 256), 1 = all bf16 (d, dv up to 128).
extern "C" int flash_attn_fwd_lse(const void* q, const void* k, const void* v, const void* mask,
                                  const void* slopes, void* out, void* lse, int types, int B, int H, int Hkv,
                                  int nq, int nkv, int d, int dv, float scale, void* stream) {
  using namespace ggml_tpu_torch;
  if (lse == nullptr || types < 0 || types > 1 || bad_shape(B, H, Hkv, nq, nkv, d, dv, types == 0 ? 256 : 128))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lp = static_cast<float*>(lse);
  if (types == 0) return launch_f32<true>(s, q, k, v, mask, slopes, out, lp, B, H, Hkv, nq, nkv, d, dv, scale, 0.f);
  const dim3 grid((nq + BQ - 1) / BQ, H, B);
  const int hd = d > dv ? d : dv;
  if (hd <= 64) return launch_bf16<64>(grid, s, q, k, v, mask, slopes, out, lp, H, Hkv, nq, nkv, d, dv, scale);
  return launch_bf16<128>(grid, s, q, k, v, mask, slopes, out, lp, H, Hkv, nq, nkv, d, dv, scale);
}
