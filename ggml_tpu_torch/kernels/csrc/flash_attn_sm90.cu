// Kernel J on Hopper: the prefill's flash attention forward for bf16 q/k/v
// and for f32 q/k with a bf16 v, with its two helper kernels; and kernel K,
// the training forward for bf16 q/k/v, as J's kernel with K's rules.
//
// J replaces (ggml_tpu/kernels/flash_attn.py) _fa_kernel (:30) with the work
// flash_attention (:75) does around it: the padding of ragged q rows and kv
// columns (bounds are checked here instead), the GQA head map and the final
// transpose (the output is written as (b, nq, h, d_v) directly).  Per batch
// b, head h (kv head h / (H / Hkv)) and query row i it computes
//   s_j = softcap ? tanh(q_i . k_j * (scale / softcap)) * softcap : q_i . k_j * scale
//   s_j += slope_h * mask[i, j]                                    (if a mask is given)
//   out_i = sum_j softmax_j(s) * v_j
// as the online-softmax recurrence over kv tiles (64 rows for bf16 q/k, 32
// for f32 q/k): running max m (starting at the finite sentinel -1e30, so a
// mask value of -inf never makes NaN), running sum l, p = e^(s - m) rounded
// to bf16 (v's type) before p . v, f32 sums.  The n_pad zero kv columns the
// JAX wrapper pads to a multiple of 32 (masked slope * -1e30) are folded into
// each finished row (fold_padding), and rows whose folded max is at or below
// -5e29 give zeros, as JAX's test on its padded row.  f32 q and k (what a bf16 model's RoPE hands over)
// enter as hi + lo bf16, hi = bf16(x), lo = bf16(x - hi), and each score is
// summed from three products, lo.hi + hi.lo + hi.hi: what is dropped (lo.lo
// and the rounding of lo) is below 2^-16 of |q_i k_i| per product; the
// output is then f32.  (J's all-f32 set runs on plain FMAs in flash_attn.cu.)
//
// K replaces _fa_fwd_lse_kernel (:180) with the work _fa_forward_lse (:338)
// does around it (the 128-lane LSE broadcast is dropped: one f32 per row).
// It computes J's function without softcap, also writes lse_i = m + log(l),
// and keeps the JAX training kernel's own rules, which are not J's: a dead
// row is one with l' = 0 after the padding fold (every score -inf and no
// padding), which gives o = 0 and lse = +1e30 (so the backward's exp(s -
// lse) is 0); a row masked with the finite -1e30 everywhere stays live (p =
// 1 on every column, lse about -1e30).  Skipping a tile is exact only for
// rows whose max ends above -2.5e29; where a row of the block ends at or
// below that after a walk that skipped, the block walks every tile again
// without skipping (K's f32 set runs on plain FMAs in flash_attn.cu).
//
// Bound on the H100 at the prefill shape (h=16, d=256, nq=nkv=1024, causal):
// bytes, q, k, v, out and the mask (18.8 us with f32 q/k, 11.3 us bf16);
// the causal half's products (3 + 1 or 1 + 1 of 2 d flop a pair) take 17.4
// and 8.7 us at the bf16 tensor-core rate.  K at GPT-2-medium's training
// shape (b=8, h=16, nq=nkv=512, d=64, causal): bytes, q, k, v, o, the mask
// and the lse (10.4 us); its products take 4.3 us.  At d=64 a tile's two
// products are small next to its softmax, so the softmax's instructions and
// the blocks' start-up (the first loads come from device memory all at
// once) set K's pace.
//
// Design.
// - Helper 1, flash_split: one pass writes f32 k as hi and lo bf16 planes
//   (contiguous), reading k in whatever row layout the caller has (no copy
//   of the head view first), so the main kernel reads bf16 K tiles only and
//   converts nothing in its loop (every q tile of a head reads all of K).  Q
//   is read by one block only: that block splits it as it loads it.  Bound:
//   bytes.
// - Helper 2, flash_mask_ranges: one pass over the (nq, nkv) mask, shared by
//   every head and batch row, gives each (64-row q tile, 64-column kv tile)
//   the min and max of its entries.  The main kernel skips a tile where
//   slope * max <= -5e29 (the old per-entry test, as the slope is > 0), adds
//   slope * min to every score of a tile where min = max without reading the
//   mask (a causal mask off the diagonal), and reads entries only in mixed
//   (diagonal) tiles.  Every score gets the mask arithmetic it had before.
//   The models compute the ranges once per forward and hand them to every
//   layer.  Bound: bytes, the mask read once (4.2 MB, 1.3 us at 1024^2), so
//   the design keeps the bytes in flight: 16-byte loads, a block per strip
//   of 64 rows by two tiles (128 blocks at 1024^2, 32 KB in flight each),
//   min and max reduced together by shuffles with one shared-memory exchange.
// - Main kernel: one warpgroup (128 threads) owns 64 query rows of one head;
//   two blocks share an SM (96 KB of shared memory each for bf16 at HD =
//   256: Q, K and V tiles; 112 KB for f32 q/k: Q hi and lo, K hi and lo and V
//   of 32 rows), so one block's softmax hides behind the other's products.
//   The tiles are in wgmma's 128-byte-swizzle layout, written by TMA boxes of
//   64 columns that one thread starts, each tile counted by an mbarrier (the
//   threads' own cp.async copies cost 250-500 cycles an instruction to start
//   and were most of the time).  An f32 q is split into its hi and lo tiles
//   by the block as it reads it.  S = Q K^T is wgmma m64nBKVk16 from shared
//   memory (three per k step for f32 q/k, the small terms first).  Its
//   accumulators are, per warp, the m16n8k16 layout, so P goes from registers
//   into P V as wgmma's register A operand; V is the B operand in its row
//   layout (MN-major, 16-bit types allow it), so nothing is transposed.  The
//   next tile's K loads once S has read this one's, during the softmax and P
//   V; the next V during the next S.  O (64 x HD f32, 128 registers a thread
//   at HD = 256), m and l stay in registers; O is rescaled only where a row's
//   max moved.  The q tiles launch longest-work first (the last tiles of a
//   causal mask see the most keys).
// - K's instances (HD = 64 or 128) differ where the softmax is the cost:
//   five blocks share an SM at HD = 64 (96 registers a thread), exp2 is one
//   flush-to-zero instruction, and where a tile adds nothing (no mask, or a
//   mask tile of zeros) the scale goes into the exponent's one fma instead
//   of a multiply of every score.

#include "common.cuh"
#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace ggml_tpu_torch {
namespace {

constexpr float NEG = -1e30f;  // the finite sentinel
constexpr float LOG2E = 1.4426950408889634f;
constexpr int TILE = 64;       // q rows of a tile, and the side of a mask-range tile
constexpr int WG = 128;        // one warpgroup

// e^x as 2^(x log2 e): K's flush-to-zero exp2 is one instruction, J keeps exp2f
template <bool FTZ>
__device__ __forceinline__ float exp2_(float x) {
  if constexpr (FTZ) return ex2_ftz(x);
  else return exp2f(x);
}

// TMA maps of bf16 q (unused for f32 q), k (its hi plane for f32 k), k's lo
// plane, and v: 4-d (column, row, head, batch), boxes of 64 columns
struct FaMaps {
  CUtensorMap q, kh, kl, v;
};

struct FaArgs {
  const float* q32;                 // f32 q, split in the kernel; else null
  long long q_sb, q_sh, q_sn;       // its element strides (batch, head, row)
  const float* mask;    // (>= nq rows, nkv columns, row stride nkv) or null
  const float* ranges;  // (2, nqt, nkt): min, max of each 64 x 64 tile's mask entries
  const float* slopes;  // (H)
  void* out;            // (B, nq, H, dv): f32 for f32 q/k, else bf16
  float* lse;           // K: (B, H, nq); J: null
  int B, H, Hkv, nq, nkv, d, dv, nqt, nkt;
  float scale, softcap;
};

// the kv tile: 32 rows for f32 q/k, whose hi and lo planes take twice the
// shared memory, so that two blocks fit on an SM either way
template <bool QK32>
__host__ __device__ constexpr int fa_bkv() { return QK32 ? 32 : 64; }

// the tiles, then two mbarriers
template <int HD, bool QK32>
__host__ __device__ constexpr int fa_smem_bytes() {
  return ((QK32 ? 2 : 1) * TILE + (QK32 ? 2 : 1) * fa_bkv<QK32>() + fa_bkv<QK32>()) * HD * 2 + 16;
}

// LSE: kernel K (bf16 only, no softcap, LSE written, dead rows l' = 0, the
// re-walk without skipping; five blocks an SM at HD = 64); else kernel J
template <int HD, bool QK32, bool LSE>
__global__ void __launch_bounds__(WG, (LSE && HD == 64) ? 5 : 2)
    fa_sm90_kernel(const __grid_constant__ FaArgs a, const __grid_constant__ FaMaps maps) {
  static_assert(!(LSE && QK32), "K takes bf16 q, k and v");
  constexpr int BKV = fa_bkv<QK32>();
  constexpr int NS = BKV / 2;       // accumulators of S a thread holds
  constexpr int NB = HD / 64;       // 64-column blocks of O
  constexpr int QB = TILE * HD * 2, KB = BKV * HD * 2;  // bytes of a Q and of a K or V tile
  extern __shared__ __align__(1024) unsigned char smem[];
  // Q hi, K hi, V, then (f32 q/k) Q lo and K lo
  unsigned char* Qh = smem;
  unsigned char* Kh = smem + QB;
  unsigned char* Vs = smem + QB + KB;
  unsigned char* Ql = smem + QB + 2 * KB;
  unsigned char* Kl = smem + 2 * QB + 2 * KB;
  uint64_t& bar_k = *reinterpret_cast<uint64_t*>(smem + fa_smem_bytes<HD, QK32>() - 16);  // Q and K arrived
  uint64_t& bar_v = *reinterpret_cast<uint64_t*>(smem + fa_smem_bytes<HD, QK32>() - 8);   // V arrived

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int bh = blockIdx.x % (a.B * a.H);
  const int qt = a.nqt - 1 - blockIdx.x / (a.B * a.H);  // longest work first
  const int b = bh / a.H, h = bh % a.H, hk = h / (a.H / a.Hkv);
  const int q0 = qt * TILE;
  const int n_tiles = (a.nkv + BKV - 1) / BKV;
  const float slope = a.slopes[h];
  const bool have_mask = a.mask != nullptr;
  // the mask's min and max over the 64 x 64 tile that holds kv tile kt
  const float* mn_row = have_mask ? a.ranges + (size_t)qt * a.nkt : nullptr;
  const float* mx_row = have_mask ? a.ranges + ((size_t)a.nqt + qt) * a.nkt : nullptr;
  auto range_of = [&](int kt) { return kt * BKV / TILE; };
  // the first live kv tile at or after kt (no mask, or K's re-walk: every
  // tile); `skipped` records that a tile was passed over
  bool may_skip = have_mask, skipped = false;
  auto next_live = [&](int kt) {
    if (may_skip)
      while (kt < n_tiles && !(slope * mx_row[range_of(kt)] > 0.5f * NEG)) {
        ++kt;
        skipped = true;
      }
    return kt;
  };

  // TMA copies, started by thread 0 only; each is announced to its barrier
  constexpr uint32_t K_BYTES = (QK32 ? 2 : 1) * KB;
  auto load_k = [&](int kt) {
    tma_tile<HD, BKV>(Kh, &maps.kh, &bar_k, kt * BKV, hk, b);
    if constexpr (QK32) tma_tile<HD, BKV>(Kl, &maps.kl, &bar_k, kt * BKV, hk, b);
  };
  auto load_v = [&](int kt) { tma_tile<HD, BKV>(Vs, &maps.v, &bar_v, kt * BKV, hk, b); };

  // descriptors, advanced by adding to the start address (16-byte units): k
  // step kk of Q and K is panel kk / 4, 32 bytes times kk % 4 into its rows
  const uint64_t d_qh = sw128_desc(Qh, 16), d_ql = sw128_desc(Ql, 16);
  const uint64_t d_kh = sw128_desc(Kh, 16), d_kl = sw128_desc(Kl, 16);
  const uint64_t d_v = sw128_desc(Vs, BKV * 128);

  // this thread's rows r_lo = 16 warp + g and r_lo + 8 of the tile; in each
  // accumulator block of S and O, register 4 j + e holds column 8 j + 2 t +
  // (e & 1) of row r_lo (e < 2) or r_lo + 8
  const int r_lo = 16 * warp + (lane >> 2);
  const int row_lo = min(q0 + r_lo, a.nq - 1), row_hi = min(q0 + r_lo + 8, a.nq - 1);  // clamped for mask reads
  float m_lo = NEG, m_hi = NEG, l_lo = 0.f, l_hi = 0.f;
  float o[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[nb][i] = 0.f;
  const int k_steps = (a.d + 15) / 16;

  // A bf16 Q comes with the first K; then the next K starts once S has
  // read this one, the next V once P V has.  Each barrier completes once per
  // tile: its phase parity flips.
  if (tid == 0) {
    mbar_init(&bar_k);
    mbar_init(&bar_v);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  int cur = next_live(0);
  uint32_t phase = 0;
  if (cur < n_tiles && tid == 0) {
    mbar_expect(&bar_k, (QK32 ? 0 : QB) + K_BYTES);
    if constexpr (!QK32) tma_tile<HD, TILE>(Qh, &maps.q, &bar_k, q0, h, b);
    load_k(cur);
    mbar_expect(&bar_v, KB);
    load_v(cur);
  }
  if constexpr (QK32) {
    // f32 Q, read once by this block alone, split here into its hi and lo
    // tiles: thread i takes 8 columns, consecutive threads a row's
    // consecutive 32 bytes, and 8 of them write one swizzled 128-byte row
    if (cur < n_tiles) {
      const float* qb = a.q32 + b * a.q_sb + h * a.q_sh + (long long)q0 * a.q_sn;
      const int rows = min(TILE, a.nq - q0);
#pragma unroll 4
      for (int i = tid; i < TILE * HD / 8; i += WG) {
        const int r = i / (HD / 8), c = i % (HD / 8);
        float4 x0 = make_float4(0.f, 0.f, 0.f, 0.f), x1 = x0;
        if (r < rows && c * 8 < a.d) {
          const float4* src = reinterpret_cast<const float4*>(qb + r * a.q_sn + c * 8);
          x0 = src[0];
          x1 = src[1];
        }
        const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
        uint32_t hw[4], lw[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const __nv_bfloat162 hv = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
          hw[e] = *reinterpret_cast<const uint32_t*>(&hv);
          lw[e] = pack2_bf16(x[2 * e] - __low2float(hv), x[2 * e + 1] - __high2float(hv));
        }
        const int at = (c >> 3) * TILE * 128 + r * 128 + (((c & 7) ^ (r & 7)) << 4);
        *reinterpret_cast<uint4*>(Qh + at) = make_uint4(hw[0], hw[1], hw[2], hw[3]);
        *reinterpret_cast<uint4*>(Ql + at) = make_uint4(lw[0], lw[1], lw[2], lw[3]);
      }
      fence_proxy_async();  // these generic-proxy writes, read by wgmma
    }
    __syncthreads();
  }
  bool q_loaded = cur < n_tiles;  // (bf16 q: it comes with the first K)
  for (;;) {  // one walk over the kv tiles; K walks again without skipping where that was not exact
  while (cur < n_tiles) {
    const int nxt = next_live(cur + 1);
    mbar_wait(&bar_k, phase);  // Q and this tile's K are here (V may still be in flight)

    // S = Q K^T
    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    fence_regs(s);
    wg_fence();
    for (int kk = 0; kk < k_steps; ++kk) {
      const uint64_t qk = (kk >> 2) * (TILE * 8) + (kk & 3) * 2, kv = (kk >> 2) * (BKV * 8) + (kk & 3) * 2;
      if constexpr (QK32) {  // the small terms first
        wgmma_ss(s, d_ql + qk, d_kh + kv);
        wgmma_ss(s, d_qh + qk, d_kl + kv);
      }
      wgmma_ss(s, d_qh + qk, d_kh + kv);
    }
    wg_commit();
    wg_wait0();
    fence_regs(s);
    __syncthreads();  // every thread's products have read K
    if (nxt < n_tiles && tid == 0) {
      mbar_expect(&bar_k, K_BYTES);
      load_k(nxt);
    }

    // scores: scale or softcap, the tile's mask, kv columns past nkv out; each
    // branch is taken by the whole tile
    const int kv0 = cur * BKV;
    const int rt = range_of(cur);
    // K folds the scale into the exponent's one fma where the tile adds
    // nothing (no mask, or a mask tile of zeros): the max of the scaled
    // scores is the scaled max, as rounding keeps the order
    const bool fold = LSE && a.scale > 0.f && (!have_mask || (mn_row[rt] == 0.f && mx_row[rt] == 0.f));
    if (fold) {
    } else if (!LSE && a.softcap != 0.f) {
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = tanhf(s[i] * a.scale) * a.softcap;
    } else {
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] *= a.scale;
    }
    if (fold) {
    } else if (have_mask && mn_row[rt] != mx_row[rt]) {  // mixed: the mask's own entries
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int col = kv0 + (i >> 2) * 8 + 2 * t + (i & 1);
        if (col < a.nkv) s[i] += slope * a.mask[(size_t)((i & 2) ? row_hi : row_lo) * a.nkv + col];
      }
    } else if (have_mask) {  // uniform: one value for the whole tile
      const float bias = slope * mn_row[rt];
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] += bias;
    }
    if (kv0 + BKV > a.nkv) {
#pragma unroll
      for (int i = 0; i < NS; ++i)
        if (kv0 + (i >> 2) * 8 + 2 * t + (i & 1) >= a.nkv) s[i] = -INFINITY;
    }
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      if (i & 2) mx_hi = fmaxf(mx_hi, s[i]); else mx_lo = fmaxf(mx_lo, s[i]);
    }
    // a row lives in the 4 lanes of a quad
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 1));
    mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, 2));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 1));
    mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, 2));
    if (fold) {
      mx_lo *= a.scale;
      mx_hi *= a.scale;
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    // e^x as 2^(x log2 e): one multiply and the hardware's exp2
    const float al_lo = exp2_<LSE>((m_lo - mn_lo) * LOG2E), al_hi = exp2_<LSE>((m_hi - mn_hi) * LOG2E);
    m_lo = mn_lo;
    m_hi = mn_hi;
    float ps_lo = 0.f, ps_hi = 0.f;
    if (fold) {
      const float c = a.scale * LOG2E, o_lo = -mn_lo * LOG2E, o_hi = -mn_hi * LOG2E;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        s[i] = exp2_<LSE>(fmaf(s[i], c, (i & 2) ? o_hi : o_lo));
        if (i & 2) ps_hi += s[i]; else ps_lo += s[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        s[i] = exp2_<LSE>((s[i] - ((i & 2) ? mn_hi : mn_lo)) * LOG2E);
        if (i & 2) ps_hi += s[i]; else ps_lo += s[i];
      }
    }
    // each lane keeps the sum of its own columns; the quad's lanes share alpha
    l_lo = l_lo * al_lo + ps_lo;
    l_hi = l_hi * al_hi + ps_hi;
    // P rounded to bf16, in the A-fragment layout: k step kk covers columns 16 kk ..
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      pa[kk][0] = pack2_bf16(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack2_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack2_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack2_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
    if (al_lo != 1.f || al_hi != 1.f) {  // the running max moved: rescale O
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[nb][i] *= (i & 2) ? al_hi : al_lo;
    }

    mbar_wait(&bar_v, phase);  // this tile's V is here (the next K may still be in flight)
    // O += P V: k step kk takes V's rows 16 kk .., block nb its panel nb
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(o[nb]);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) wgmma_rs(o[nb], pa[kk], d_v + nb * (BKV * 8) + kk * 128);
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(o[nb]);
    __syncthreads();  // every thread's products have read V
    if (nxt < n_tiles && tid == 0) {
      mbar_expect(&bar_v, KB);
      load_v(nxt);
    }
    cur = nxt;
    phase ^= 1;
  }
  if constexpr (!LSE) break;
  // K: a skipped tile is exact only for rows whose max ends above -2.5e29
  // (the skipped scores sit 2.5e29 below it, so their p and the terms they
  // would have added before the row came alive are exactly 0); where a row
  // of the block (below nq) ends at or below that, walk every tile again
  const bool low = (q0 + r_lo < a.nq && m_lo <= 0.25f * NEG) || (q0 + r_lo + 8 < a.nq && m_hi <= 0.25f * NEG);
  if (!__syncthreads_or(skipped && low)) break;
  may_skip = skipped = false;
  m_lo = m_hi = NEG;
  l_lo = l_hi = 0.f;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[nb][i] = 0.f;
  cur = 0;
  if (tid == 0) {
    mbar_expect(&bar_k, (q_loaded ? 0 : QB) + K_BYTES);
    if (!q_loaded) tma_tile<HD, TILE>(Qh, &maps.q, &bar_k, q0, h, b);
    load_k(0);
    mbar_expect(&bar_v, KB);
    load_v(0);
  }
  q_loaded = true;
  }

  // a row's l is spread over its quad
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 1);
  l_lo += __shfl_xor_sync(0xffffffffu, l_lo, 2);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 1);
  l_hi += __shfl_xor_sync(0xffffffffu, l_hi, 2);
  // the JAX wrapper's kv padding folded in; dead rows give zeros: J's are
  // those whose folded max is at or below -5e29 (JAX's test on its padded
  // row), K's those with l' = 0 (every score -inf and no padding), which get
  // lse = +1e30 so that the backward's exp(s - lse) is 0
  const int n_pad = kv_padding(a.nkv);
  float c_lo, c_hi;
  fold_padding(m_lo, l_lo, c_lo, n_pad, slope);
  fold_padding(m_hi, l_hi, c_hi, n_pad, slope);
  const bool dead_lo = LSE ? l_lo == 0.f : m_lo <= 0.5f * NEG, dead_hi = LSE ? l_hi == 0.f : m_hi <= 0.5f * NEG;
  const float inv_lo = dead_lo ? 0.f : c_lo / l_lo, inv_hi = dead_hi ? 0.f : c_hi / l_hi;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + r_lo + 8 * half;
    if (row >= a.nq) continue;
    const float inv = half ? inv_hi : inv_lo;
    if (LSE && t == 0)
      a.lse[((size_t)b * a.H + h) * a.nq + row] =
          (half ? dead_hi : dead_lo) ? -NEG : (half ? m_hi : m_lo) + logf(half ? l_hi : l_lo);
    const size_t base = ((size_t)(b * a.nq + row) * a.H + h) * a.dv;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * nb + 8 * j + 2 * t;
        if (col < a.dv) {
          const float x0 = o[nb][4 * j + 2 * half] * inv, x1 = o[nb][4 * j + 2 * half + 1] * inv;
          if constexpr (QK32)
            *reinterpret_cast<float2*>(static_cast<float*>(a.out) + base + col) = make_float2(x0, x1);
          else
            *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.out) + base + col) =
                __floats2bfloat162_rn(x0, x1);
        }
      }
  }
}

// f32 rows -> hi and lo bf16 planes.  Input element (b, h, n, c) at b sb +
// h sh + n sn + c; the planes are contiguous (B, Hx, N, d): hi at `hi`, lo at
// hi + B Hx N d.  A thread takes 8 columns at a time, 4 such loads in flight.
struct SplitArgs {
  const float* x;
  __nv_bfloat16* hi;
  long long sb, sh, sn;
  int B, Hx, N, d;
};

__global__ void __launch_bounds__(256) flash_split_kernel(const __grid_constant__ SplitArgs a) {
  constexpr int U = 4;  // chunks a thread has in flight
  const int cpr = a.d / 8;  // 8-element chunks per row
  const long long n_chunks = (long long)a.B * a.Hx * a.N * cpr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i0 = (long long)blockIdx.x * blockDim.x + threadIdx.x; i0 < n_chunks; i0 += U * stride) {
    float4 x0[U], x1[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = i0 + u * stride;
      if (i < n_chunks) {
        const int c = (int)(i % cpr);
        const long long r = i / cpr;  // row of (B, Hx, N)
        const int n = (int)(r % a.N);
        const long long bh = r / a.N;
        const int hh = (int)(bh % a.Hx), bb = (int)(bh / a.Hx);
        const float4* src = reinterpret_cast<const float4*>(a.x + bb * a.sb + hh * a.sh + n * a.sn + c * 8);
        x0[u] = src[0];
        x1[u] = src[1];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long i = i0 + u * stride;
      if (i >= n_chunks) break;
      const float x[8] = {x0[u].x, x0[u].y, x0[u].z, x0[u].w, x1[u].x, x1[u].y, x1[u].z, x1[u].w};
      uint32_t hw[4], lw[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 hv = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
        hw[e] = *reinterpret_cast<const uint32_t*>(&hv);
        lw[e] = pack2_bf16(x[2 * e] - __low2float(hv), x[2 * e + 1] - __high2float(hv));
      }
      *reinterpret_cast<uint4*>(a.hi + i * 8) = make_uint4(hw[0], hw[1], hw[2], hw[3]);
      *reinterpret_cast<uint4*>(a.hi + n_chunks * 8 + i * 8) = make_uint4(lw[0], lw[1], lw[2], lw[3]);
    }
  }
}

// min and max of each (64-row, 64-column) tile of the (nq, nkv) mask (row
// stride nkv): ranges[0][qt][kt], ranges[1][qt][kt], nkt = ceil(nkv / 64).
// A block owns a strip of 64 rows by two tiles (MR_COLS columns); warp w
// reads rows w, w + 8, ..., each as one 512-byte segment, 4 columns a lane,
// all its MR_ROWS loads in flight before the first min.  VEC: each lane's 4
// columns are one 16-byte load (nkv % 4 == 0 and the mask 16-byte aligned);
// else four scalar loads with a column test each (a ragged nkv).  Lanes 0-15
// hold the first tile, 16-31 the second: min and max reduce together over a
// half-warp by shuffles, then across the 8 warps through one shared-memory
// exchange.
constexpr int MR_THREADS = 256;
constexpr int MR_COLS = 2 * TILE;
constexpr int MR_ROWS = TILE / (MR_THREADS / 32);

template <bool VEC>
__global__ void __launch_bounds__(MR_THREADS) flash_mask_ranges_kernel(const float* __restrict__ mask,
                                                                       float* __restrict__ ranges, int nq, int nkv,
                                                                       int nkt) {
  __shared__ float2 part[MR_THREADS / 32][2];  // (min, max) of each warp's rows of each tile
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, qt = blockIdx.y;
  const int c0 = blockIdx.x * MR_COLS + 4 * lane;
  float v[MR_ROWS][4];
  bool ok[MR_ROWS][4];
#pragma unroll
  for (int i = 0; i < MR_ROWS; ++i) {
    const int r = qt * TILE + warp + (MR_THREADS / 32) * i;
    const float* p = mask + (size_t)r * nkv + c0;
#pragma unroll
    for (int e = 0; e < 4; ++e) ok[i][e] = r < nq && c0 + (VEC ? 0 : e) < nkv;
    if constexpr (VEC) {
      const float4 t = ok[i][0] ? __ldg(reinterpret_cast<const float4*>(p)) : make_float4(0.f, 0.f, 0.f, 0.f);
      v[i][0] = t.x; v[i][1] = t.y; v[i][2] = t.z; v[i][3] = t.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[i][e] = ok[i][e] ? __ldg(p + e) : 0.f;
    }
  }
  float lo = INFINITY, hi = -INFINITY;
#pragma unroll
  for (int i = 0; i < MR_ROWS; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (ok[i][e]) {
        lo = fminf(lo, v[i][e]);
        hi = fmaxf(hi, v[i][e]);
      }
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {  // within a half-warp: one tile
    lo = fminf(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = fmaxf(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if ((lane & 15) == 0) part[warp][lane >> 4] = make_float2(lo, hi);
  __syncthreads();
  const int half = threadIdx.x & 1, kt = 2 * blockIdx.x + half;
  if (threadIdx.x < 4 && kt < nkt) {  // threads 0, 1: the two tiles' min; 2, 3: their max
    const bool is_max = threadIdx.x >= 2;
    float x = is_max ? part[0][half].y : part[0][half].x;
#pragma unroll
    for (int w = 1; w < MR_THREADS / 32; ++w) x = is_max ? fmaxf(x, part[w][half].y) : fminf(x, part[w][half].x);
    ranges[((size_t)is_max * gridDim.y + qt) * nkt + kt] = x;
  }
}

template <int HD, bool QK32, bool LSE = false>
int launch_fa(const FaArgs& a, const FaMaps& maps, cudaStream_t s) {
  constexpr int smem = fa_smem_bytes<HD, QK32>();
  const cudaError_t rc = cudaFuncSetAttribute(fa_sm90_kernel<HD, QK32, LSE>,
                                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  fa_sm90_kernel<HD, QK32, LSE><<<a.nqt * a.H * a.B, WG, smem, s>>>(a, maps);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ggml_tpu_torch

// Kernel J for bf16 q/k/v (qk32 = 0: q and k bf16; out bf16) or f32 q and k
// (qk32 = 1: q f32, split in the kernel; k as its hi and lo planes kh, kl
// from flash_split; out f32), v bf16.  Strides in elements (of q: multiples
// of 4; the others: of 8), rows contiguous, 16-byte aligned.
// ranges: from flash_mask_ranges (null where mask is null).  score_scale is
// `scale`, or scale / softcap where softcap != 0.  d, dv: multiples of 8 up
// to 256.  out: (B, nq, H, dv) contiguous.
extern "C" int flash_attn_sm90(const void* q, const void* kh, const void* kl, const void* v,
                               long long q_sb, long long q_sh, long long q_sn, long long k_sb, long long k_sh,
                               long long k_sn, long long v_sb, long long v_sh, long long v_sn, const void* mask,
                               const void* ranges, const void* slopes, void* out, int qk32, int B, int H, int Hkv,
                               int nq, int nkv, int d, int dv, float score_scale, float softcap, void* stream) {
  using namespace ggml_tpu_torch;
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || nq < 1 || nkv < 1 || d < 8 || dv < 8 || d % 8 || dv % 8 ||
      d > 256 || dv > 256 || (mask != nullptr && ranges == nullptr) || (qk32 && kl == nullptr))
    return (int)cudaErrorInvalidValue;
  FaArgs a{qk32 ? static_cast<const float*>(q) : nullptr, q_sb, q_sh, q_sn, static_cast<const float*>(mask),
           static_cast<const float*>(ranges), static_cast<const float*>(slopes), out, nullptr,
           B, H, Hkv, nq, nkv, d, dv, (nq + TILE - 1) / TILE, (nkv + TILE - 1) / TILE, score_scale, softcap};
  if ((long long)a.nqt * H * B > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int bkv = qk32 ? fa_bkv<true>() : fa_bkv<false>();
  FaMaps maps{};
  if ((!qk32 && !make_map(&maps.q, q, B, H, nq, d, q_sb, q_sh, q_sn, TILE)) ||
      !make_map(&maps.kh, kh, B, Hkv, nkv, d, k_sb, k_sh, k_sn, bkv) ||
      !make_map(&maps.v, v, B, Hkv, nkv, dv, v_sb, v_sh, v_sn, bkv) ||
      (qk32 && !make_map(&maps.kl, kl, B, Hkv, nkv, d, k_sb, k_sh, k_sn, bkv)))
    return (int)cudaErrorInvalidValue;  // no cuTensorMapEncodeTiled, or a layout TMA cannot describe
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hd = d > dv ? d : dv;
  if (qk32) {
    if (hd <= 64) return launch_fa<64, true>(a, maps, s);
    if (hd <= 128) return launch_fa<128, true>(a, maps, s);
    return launch_fa<256, true>(a, maps, s);
  }
  if (hd <= 64) return launch_fa<64, false>(a, maps, s);
  if (hd <= 128) return launch_fa<128, false>(a, maps, s);
  return launch_fa<256, false>(a, maps, s);
}

// Kernel K for bf16 q/k/v: J's arguments without softcap and the f32 k
// planes, and lse, f32 (B, H, nq) contiguous.  d, dv: multiples of 8 up to
// 128.  out: (B, nq, H, dv) bf16 contiguous.
extern "C" int flash_attn_fwd_lse(const void* q, const void* k, const void* v, long long q_sb, long long q_sh,
                                  long long q_sn, long long k_sb, long long k_sh, long long k_sn, long long v_sb,
                                  long long v_sh, long long v_sn, const void* mask, const void* ranges,
                                  const void* slopes, void* out, void* lse, int B, int H, int Hkv, int nq, int nkv,
                                  int d, int dv, float scale, void* stream) {
  using namespace ggml_tpu_torch;
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || nq < 1 || nkv < 1 || d < 8 || dv < 8 || d % 8 || dv % 8 ||
      d > 128 || dv > 128 || (mask != nullptr && ranges == nullptr) || lse == nullptr)
    return (int)cudaErrorInvalidValue;
  FaArgs a{nullptr, 0, 0, 0, static_cast<const float*>(mask), static_cast<const float*>(ranges),
           static_cast<const float*>(slopes), out, static_cast<float*>(lse), B, H, Hkv, nq, nkv, d, dv,
           (nq + TILE - 1) / TILE, (nkv + TILE - 1) / TILE, scale, 0.f};
  if ((long long)a.nqt * H * B > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  FaMaps maps{};
  if (!make_map(&maps.q, q, B, H, nq, d, q_sb, q_sh, q_sn, TILE) ||
      !make_map(&maps.kh, k, B, Hkv, nkv, d, k_sb, k_sh, k_sn, fa_bkv<false>()) ||
      !make_map(&maps.v, v, B, Hkv, nkv, dv, v_sb, v_sh, v_sn, fa_bkv<false>()))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((d > dv ? d : dv) <= 64) return launch_fa<64, false, true>(a, maps, s);
  return launch_fa<128, false, true>(a, maps, s);
}

// Helper of J: split an f32 (B, H, N, d) tensor with element strides (sb,
// sh, sn), rows contiguous and 16-byte aligned, into hi and lo bf16 planes:
// `planes` receives 2 x B H N d bf16 (hi, then lo).
extern "C" int flash_split(const void* x, void* planes, int B, int H, int N, long long sb, long long sh, long long sn,
                           int d, void* stream) {
  using namespace ggml_tpu_torch;
  if (d < 8 || d % 8 || B < 1 || H < 1 || N < 1) return (int)cudaErrorInvalidValue;
  const SplitArgs a{static_cast<const float*>(x), static_cast<__nv_bfloat16*>(planes), sb, sh, sn, B, H, N, d};
  const long long chunks = (long long)B * H * N * d / 8;
  const int blocks = (int)(chunks / 256 + 1 < 132 * 16 ? chunks / 256 + 1 : 132 * 16);
  flash_split_kernel<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// Helper of J: ranges (2, ceil(nq / 64), ceil(nkv / 64)) f32 of the mask
// (>= nq rows, nkv columns, row stride nkv).
extern "C" int flash_mask_ranges(const void* mask, void* ranges, int nq, int nkv, void* stream) {
  using namespace ggml_tpu_torch;
  if (nq < 1 || nkv < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((nkv + MR_COLS - 1) / MR_COLS, (nq + TILE - 1) / TILE);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  const int nkt = (nkv + TILE - 1) / TILE;
  const auto* m = static_cast<const float*>(mask);
  auto* out = static_cast<float*>(ranges);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nkv % 4 == 0 && reinterpret_cast<uintptr_t>(mask) % 16 == 0)
    flash_mask_ranges_kernel<true><<<grid, MR_THREADS, 0, s>>>(m, out, nq, nkv, nkt);
  else
    flash_mask_ranges_kernel<false><<<grid, MR_THREADS, 0, s>>>(m, out, nq, nkv, nkt);
  return (int)cudaGetLastError();
}
