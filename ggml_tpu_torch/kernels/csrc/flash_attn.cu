// Flash attention forward (online softmax over key/value tiles), kernels J
// (prefill) and K (the training forward, which also gives the logsumexp).
//
// J replaces (ggml_tpu/kernels/flash_attn.py) _fa_kernel (:30) with the work
// flash_attention (:75) does around it: the padding of ragged q rows and kv
// columns (bounds are checked here instead), the GQA head map and the final
// transpose (the output is written as (b, nq, h, d_v) directly).  Per batch
// b, head h (kv head h / (H / Hkv)) and query row i it computes
//   s_j = softcap ? tanh(q_i . k_j * (scale / softcap)) * softcap : q_i . k_j * scale
//   s_j += slope_h * mask[i, j]                                    (if a mask is given)
//   out_i = sum_j softmax_j(s) * v_j
// as the online-softmax recurrence over kv tiles: running max m (starting at
// the finite sentinel -1e30, so a mask value of -inf never makes NaN),
// running sum l, p = exp(s - m) rounded to v's type before p . v, f32 sums;
// rows whose max never leaves the sentinel give zeros.
//
// K replaces _fa_fwd_lse_kernel (:180) with the work _fa_forward_lse (:338)
// does around it (padding, GQA map; the 128-lane LSE broadcast is dropped):
// the same recurrence without softcap, plus lse_i = m + log(l) as one f32
// per row in (b, h, nq).  Its dead rows are those with l = 0 (every p was
// exp(-inf)): o = 0 and lse = +1e30, so the backward's exp(s - lse) is 0.  A
// row masked with the finite -1e30 everywhere is NOT dead there: every p is
// exp(0) = 1, o is the mean of v and lse about -1e30, as in the JAX kernel.
// K is the LSE instance of J's two kernels, for bf16 q/k/v and for f32.
//
// Two kernels, three type sets:
//   bf16 q/k/v: tensor cores, mma.sync m16n8k16 bf16 with f32 accumulation.
//     bf16 products are exact in f32, so the scores equal the TPU kernel's
//     f32 dots up to the order of the sums.
//   f32 q/k with bf16 v (the bf16 model's prefill: RoPE leaves q and k in
//     f32, v is bf16; the TPU kernel widens q and k and multiplies in f32):
//     the same kernel with q and k each split into two bf16 terms,
//     x = hi + lo, hi = bf16(x), lo = bf16(x - hi), and the scores summed
//     from three products, lo.hi + hi.lo + hi.hi.  What is dropped (lo.lo
//     and the rounding of lo) is below 2^-16 of |q_i k_i| per product, against
//     2^-9 had q and k been rounded to bf16.  p . v runs in bf16 as above;
//     the output is f32 (q's type).
//   f32 q/k/v (what the reference tests feed): plain FMAs, one warp per row.
//
// Bound on the H100 at the prefill shapes (h=16, d=256, nq=nkv >= 1024):
// operations, 4*h*d per unmasked (q, k) pair at the bf16 tensor-core rate;
// q, k, v, out and the mask are a few MB.
//
// Design of the bf16 kernel (simple, not fast): a block of 4 warps owns 64
// query rows of one head, a warp 16 of them; it walks the kv rows in tiles of
// 64.  Q, K and V tiles sit in shared memory as bf16 rows padded by 16 bytes
// (conflict-free fragment loads), head dims padded with zeros to HD = 64, 128
// or 256; at HD = 256 that is 99 KB of dynamic shared memory (opt-in above
// 48 KB), 165 KB with the lo tiles of f32 q and k.  S = Q K^T lands in mma accumulators whose layout is the A-operand
// layout of the next product, so P goes from registers straight into P V; V
// fragments come through ldmatrix.trans.  The output accumulators (16 x HD
// per warp, 128 registers a thread at HD = 256), m and l stay in registers.
// A kv tile whose mask entries (times the slope) are all at or below -5e29
// for the block's rows is skipped before K and V are loaded: every p in it
// would be exp(-1e30 - m) = 0 for a live row, and a row that is dead so far
// stays dead; a causal prefill so does half the work.  For K the skip is
// exact only for rows whose max ends above -2.5e29 (the skipped scores sit
// 2.5e29 below it, so their p and the terms they would have added before the
// row came alive are exactly 0): if a tile was skipped and a row of the block
// ends at or below that, the block walks every tile again without skipping.
// No cp.async, no double buffering, no wgmma: later work.

#include <type_traits>

#include "common.cuh"
#include "flash_common.cuh"

namespace ggml_tpu_torch {
namespace {

// load_tile from f32 rows, split into two tiles: hi = bf16(x) and lo = bf16(x - hi)
template <int HD>
__device__ __forceinline__ void load_tile_split(__nv_bfloat16* hi, __nv_bfloat16* lo, const float* src,
                                                int rows, int cols, int src_ld) {
  constexpr int CH = HD / 8;
  for (int i = threadIdx.x; i < 64 * CH; i += FA_THREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    __align__(16) float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r < rows && c < cols) {
      *reinterpret_cast<float4*>(x) = *reinterpret_cast<const float4*>(src + (size_t)r * src_ld + c);
      *reinterpret_cast<float4*>(x + 4) = *reinterpret_cast<const float4*>(src + (size_t)r * src_ld + c + 4);
    }
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 hv = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
      h[e] = *reinterpret_cast<const uint32_t*>(&hv);
      l[e] = pack_bf16(x[2 * e] - __low2float(hv), x[2 * e + 1] - __high2float(hv));
    }
    *reinterpret_cast<uint4*>(hi + r * (HD + PAD) + c) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + r * (HD + PAD) + c) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// QK32: q and k are f32 (TQ = float), split into hi and lo bf16 tiles, and
// the output is f32; else q, k and the output are bf16.  v is bf16 in both.
// LSE: kernel K (no softcap, K's dead rows, lse written); else kernel J.
template <int HD, bool QK32, bool LSE, typename TQ>
__global__ void __launch_bounds__(FA_THREADS)
flash_attn_bf16_kernel(const TQ* __restrict__ q, const TQ* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
                       const float* __restrict__ slopes, TQ* __restrict__ out, float* __restrict__ lse,
                       int H, int Hkv, int nq, int nkv, int d, int dv, float scale, float softcap) {
  constexpr int LD = HD + PAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + 64 * LD;
  __nv_bfloat16* Vs = Ks + 64 * LD;
  __nv_bfloat16* Ql = Vs + 64 * LD;  // the lo tiles, QK32 only
  __nv_bfloat16* Kl = Ql + 64 * LD;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const float slope = slopes[h];
  const bool have_mask = mask != nullptr;

  const TQ* qb = q + ((size_t)(b * H + h) * nq + q0) * d;
  if constexpr (QK32) load_tile_split<HD>(Qs, Ql, qb, min(BQ, nq - q0), d, d);
  else load_tile<HD>(Qs, qb, min(BQ, nq - q0), d, d);
  const TQ* kb = k + (size_t)(b * Hkv + hk) * nkv * d;
  const __nv_bfloat16* vb = v + (size_t)(b * Hkv + hk) * nkv * dv;

  // this thread's two rows: r_lo = 16 * warp + g and r_lo + 8 of the block
  const int r_lo = 16 * warp + g;
  const int row_lo = min(q0 + r_lo, nq - 1), row_hi = min(q0 + r_lo + 8, nq - 1);  // clamped for mask reads
  float m_lo, m_hi, l_lo, l_hi;
  float o[HD / 8][4];
  bool may_skip = have_mask;
  for (;;) {  // one walk over the kv tiles; K walks again without skipping where that was not exact
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
    if constexpr (QK32) load_tile_split<HD>(Ks, Kl, kb + (size_t)kv0 * d, min(BKV, nkv - kv0), d, d);
    else load_tile<HD>(Ks, kb + (size_t)kv0 * d, min(BKV, nkv - kv0), d, d);
    load_tile<HD>(Vs, vb + (size_t)kv0 * dv, min(BKV, nkv - kv0), dv, dv);
    __syncthreads();

    // S = Q K^T: 16 rows x 64 kv columns per warp, 8 accumulator tiles of 16 x 8
    float s[BKV / 8][4];
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 4
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int q_at = r_lo * LD + kk * 16 + 2 * t;
      uint32_t a[4], al[4];
      load_a_frag(a, Qs + q_at, LD);
      if constexpr (QK32) load_a_frag(al, Ql + q_at, LD);
#pragma unroll
      for (int j = 0; j < BKV / 8; ++j) {
        const int k_at = (j * 8 + g) * LD + kk * 16 + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(Ks + k_at);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(Ks + k_at + 8);
        if constexpr (QK32) {  // the small terms first
          mma_bf16(s[j], al, b0, b1);
          mma_bf16(s[j], a, *reinterpret_cast<const uint32_t*>(Kl + k_at),
                   *reinterpret_cast<const uint32_t*>(Kl + k_at + 8));
        }
        mma_bf16(s[j], a, b0, b1);
      }
    }

    // scores: scale or softcap, mask, kv columns past nkv out
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = kv0 + j * 8 + 2 * t + (e & 1);
        float sv = !LSE && softcap != 0.f ? tanhf(s[j][e] * scale) * softcap : s[j][e] * scale;
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
        const uint32_t addr = (uint32_t)__cvta_generic_to_shared(vp + jj * 16);
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                     : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
                     : "r"(addr));
        mma_bf16(o[2 * jj], a, b0, b1);
        mma_bf16(o[2 * jj + 1], a, b2, b3);
      }
    }
  }
  if constexpr (!LSE) break;
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
  if constexpr (LSE) {
    // K's dead rows: l = 0; o = 0 and lse = +1e30 (the backward's p underflows to 0)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = q0 + r_lo + 8 * half;
      const float l = half ? l_hi : l_lo, m = half ? m_hi : m_lo;
      if (row < nq && t == 0) lse[((size_t)b * H + h) * nq + row] = l == 0.f ? -NEG_SENTINEL : m + logf(l);
    }
    m_lo = l_lo == 0.f ? NEG_SENTINEL : 0.f;  // reused below as the dead flag of J
    m_hi = l_hi == 0.f ? NEG_SENTINEL : 0.f;
  }
  if (l_lo == 0.f) l_lo = 1.f;
  if (l_hi == 0.f) l_hi = 1.f;
  const bool dead_lo = m_lo <= 0.5f * NEG_SENTINEL, dead_hi = m_hi <= 0.5f * NEG_SENTINEL;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r_lo + 8 * half;
    if (row >= nq) continue;
    const float l = half ? l_hi : l_lo;
    const bool dead = half ? dead_hi : dead_lo;
    TQ* op = out + ((size_t)(b * nq + row) * H + h) * dv;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (col < dv) {
        const float x0 = dead ? 0.f : o[j][2 * half] / l, x1 = dead ? 0.f : o[j][2 * half + 1] / l;
        if constexpr (QK32) *reinterpret_cast<float2*>(op + col) = make_float2(x0, x1);
        else *reinterpret_cast<__nv_bfloat162*>(op + col) = __floats2bfloat162_rn(x0, x1);
      }
    }
  }
}

// f32 inputs: a warp per query row, a lane per key of a 32-key tile for the
// scores and per output column (stride 32, up to 256 columns) for p . v.
// No tile is skipped.  LSE: kernel K, as in the bf16 kernel.
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
  bool dead = m <= 0.5f * NEG_SENTINEL;
  if constexpr (LSE) {  // K's dead rows: l = 0
    dead = l == 0.f;
    if (lane == 0) lse[((size_t)b * H + h) * nq + row] = dead ? -NEG_SENTINEL : m + logf(l);
  }
  if (l == 0.f) l = 1.f;
  float* op = out + ((size_t)(b * nq + row) * H + h) * dv;
#pragma unroll
  for (int c = 0; c < F32_MAXC; ++c) {
    const int col = c * 32 + lane;
    if (col < dv) op[col] = dead ? 0.f : o[c] / l;
  }
}

template <int HD, bool QK32, bool LSE>
int launch_mma(dim3 grid, cudaStream_t s, const void* q, const void* k, const void* v,
               const void* mask, const void* slopes, void* out, float* lse, int H, int Hkv, int nq,
               int nkv, int d, int dv, float scale, float softcap) {
  using TQ = typename std::conditional<QK32, float, __nv_bfloat16>::type;
  constexpr int smem = (QK32 ? 5 : 3) * 64 * (HD + PAD) * (int)sizeof(__nv_bfloat16);
  const cudaError_t rc = cudaFuncSetAttribute(flash_attn_bf16_kernel<HD, QK32, LSE, TQ>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  flash_attn_bf16_kernel<HD, QK32, LSE, TQ><<<grid, FA_THREADS, smem, s>>>(
      static_cast<const TQ*>(q), static_cast<const TQ*>(k), static_cast<const __nv_bfloat16*>(v),
      static_cast<const float*>(mask), static_cast<const float*>(slopes), static_cast<TQ*>(out), lse, H,
      Hkv, nq, nkv, d, dv, scale, softcap);
  return (int)cudaGetLastError();
}

template <bool QK32, bool LSE>
int launch_by_head_dim(int hd, dim3 grid, cudaStream_t s, const void* q, const void* k, const void* v,
                       const void* mask, const void* slopes, void* out, float* lse, int H, int Hkv,
                       int nq, int nkv, int d, int dv, float scale, float softcap) {
  if (hd <= 64)
    return launch_mma<64, QK32, LSE>(grid, s, q, k, v, mask, slopes, out, lse, H, Hkv, nq, nkv, d, dv, scale, softcap);
  if (hd <= 128)
    return launch_mma<128, QK32, LSE>(grid, s, q, k, v, mask, slopes, out, lse, H, Hkv, nq, nkv, d, dv, scale, softcap);
  return launch_mma<256, QK32, LSE>(grid, s, q, k, v, mask, slopes, out, lse, H, Hkv, nq, nkv, d, dv, scale, softcap);
}

// J, or K where lse is given (types 0 or 1 only, softcap 0)
int launch(const void* q, const void* k, const void* v, const void* mask, const void* slopes, void* out,
           float* lse, int types, int B, int H, int Hkv, int nq, int nkv, int d, int dv, float score_scale,
           float softcap, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || nq < 1 || nkv < 1 || d < 8 || dv < 8 || d % 8 || dv % 8 ||
      d > 256 || dv > 256 || H > 65535 || B > 65535 || types < 0 || types > 2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (types == 0) {
    const dim3 grid((nq + F32_ROWS - 1) / F32_ROWS, H, B);
    const size_t smem = F32_ROWS * d * sizeof(float);
    const float *qf = static_cast<const float*>(q), *kf = static_cast<const float*>(k),
                *vf = static_cast<const float*>(v), *mf = static_cast<const float*>(mask),
                *sf = static_cast<const float*>(slopes);
    if (lse != nullptr)
      flash_attn_f32_kernel<true><<<grid, 32 * F32_ROWS, smem, s>>>(
          qf, kf, vf, mf, sf, static_cast<float*>(out), lse, H, Hkv, nq, nkv, d, dv, score_scale, 0.f);
    else
      flash_attn_f32_kernel<false><<<grid, 32 * F32_ROWS, smem, s>>>(
          qf, kf, vf, mf, sf, static_cast<float*>(out), nullptr, H, Hkv, nq, nkv, d, dv, score_scale, softcap);
    return (int)cudaGetLastError();
  }
  const dim3 grid((nq + BQ - 1) / BQ, H, B);
  const int hd = d > dv ? d : dv;
  if (lse != nullptr)
    return types == 1 ? launch_by_head_dim<false, true>(hd, grid, s, q, k, v, mask, slopes, out, lse, H, Hkv, nq,
                                                        nkv, d, dv, score_scale, 0.f)
                      : (int)cudaErrorInvalidValue;
  if (types == 2)
    return launch_by_head_dim<true, false>(hd, grid, s, q, k, v, mask, slopes, out, nullptr, H, Hkv, nq, nkv, d,
                                           dv, score_scale, softcap);
  return launch_by_head_dim<false, false>(hd, grid, s, q, k, v, mask, slopes, out, nullptr, H, Hkv, nq, nkv, d, dv,
                                          score_scale, softcap);
}

}  // namespace
}  // namespace ggml_tpu_torch

// Kernel J.  q (B, H, nq, d), k (B, Hkv, nkv, d), v (B, Hkv, nkv, dv) -> out
// (B, nq, H, dv), contiguous.  types: 0 = all f32, 1 = all bf16, 2 = q, k and
// out f32 with bf16 v.  mask: f32 (>= nq rows, nkv columns, row stride nkv)
// or null; slopes: f32 (H).  score_scale is `scale`, or scale / softcap where
// softcap != 0.  d and dv: multiples of 8 up to 256.
extern "C" int flash_attn(const void* q, const void* k, const void* v, const void* mask,
                          const void* slopes, void* out, int types, int B, int H, int Hkv, int nq,
                          int nkv, int d, int dv, float score_scale, float softcap, void* stream) {
  return ggml_tpu_torch::launch(q, k, v, mask, slopes, out, nullptr, types, B, H, Hkv, nq, nkv, d, dv,
                                score_scale, softcap, stream);
}

// Kernel K: J's arguments (types 0 or 1, no softcap) and lse, f32 (B, H, nq).
extern "C" int flash_attn_fwd_lse(const void* q, const void* k, const void* v, const void* mask,
                                  const void* slopes, void* out, void* lse, int types, int B, int H, int Hkv,
                                  int nq, int nkv, int d, int dv, float scale, void* stream) {
  if (lse == nullptr) return (int)cudaErrorInvalidValue;
  return ggml_tpu_torch::launch(q, k, v, mask, slopes, out, static_cast<float*>(lse), types, B, H, Hkv, nq, nkv,
                                d, dv, scale, 0.f, stream);
}
