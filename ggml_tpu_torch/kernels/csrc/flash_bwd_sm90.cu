// Kernels L and M on Hopper: dq, and dk and dv, of the training attention
// for bf16 q, k, v.
//
// L replaces (ggml_tpu/kernels/flash_attn.py) _fa_bwd_dq_kernel (:222) and M
// _fa_bwd_dkv_kernel (:254), each with its part of _fa_train_bwd (:407): the
// padding of ragged rows (bounds are checked here instead), the GQA head
// map, the 128-lane broadcast of lse and delta (one f32 per row here) and the
// transpose of dO (read here in the (b, nq, h, dv) layout the forward's
// output has).  Per batch b, q head h (kv head h / (H / Hkv)), query row i
// and key row j, from the forward's lse and delta_i = rowsum(dO_i . O_i):
//   s_ij  = q_i . k_j * scale + slope_h * mask[i, j]
//   p_ij  = exp(s_ij - lse_i)                    (f32, never rounded)
//   ds_ij = p_ij * (dO_i . v_j - delta_i) * scale
//   L: dq_i = sum_j ds_ij k_j
//   M: dv_j = sum_i p_ij dO_i,  dk_j = sum_i ds_ij q_i
// per q head (the caller sums M's heads that share a kv head, as the JAX
// wrapper does), in bf16.  (The f32 sets run on plain FMAs in
// flash_attn_bwd.cu.)
//
// Bounds on the H100 at GPT-2-medium's training shape (b=8, h=16,
// nq=nkv=512, d=64, causal): bytes.  L reads q, k, v, dO, the mask, lse and
// delta and writes dq (43.5 MB, 13 us); its three products over the causal
// half (64 x 64 x 64 per pair of tiles) take 6.5 us at the bf16 tensor-core
// rate, 8.7 us with ds as hi + lo (below).  M reads q, k, v, dO, lse and
// delta and writes dk, dv (52 MB, 15.5 us); its four products take 8.7 us,
// 13 us with p and ds as hi + lo.  What sets the pace of both is the work
// between the products: a tile's p and ds and their hi + lo splits, 32
// exponentials and up to 64 conversions to bf16 a thread, and each block's
// start-up.
//
// Shared by both.
// - One warpgroup (128 threads) a block; tiles in wgmma's 128-byte-swizzle
//   layout, written by TMA boxes of 64 columns that one thread starts, each
//   counted by an mbarrier.  dO is read through a 4-d map with the (b, nq,
//   h, dv) strides of the forward's output.
// - The score products S (or S^T) and dP (or dP^T) are wgmma from shared
//   memory, issued as two groups so that p is built while dP runs.  Their
//   accumulators are, per warp, the m16n8k16 layout, so p and ds are built
//   in registers and enter the next products as wgmma's register A operand
//   (split_frags); the other operand is a tile in its row layout (MN-major,
//   legal for 16-bit types), so nothing is transposed in memory.  p and ds
//   stay f32, as in the JAX kernels: each enters as hi + lo bf16, two
//   products, the small one first (wgmma_hi_lo), so what is lost is below
//   2^-16 of a term where one bf16 product would lose 2^-9.
// - The mask from its 64 x 64 tile ranges (flash_mask_ranges, computed once
//   per layer by the forward): a tile is skipped where slope * max <= -5e29
//   and every row of it has lse above -2.5e29 (every p in it is then exactly
//   0; a row masked with the finite -1e30 everywhere has lse about -1e30 and
//   p = 1 on every column, so its tiles are walked); where min = max the
//   tile adds slope * min to every score without reading the mask; only
//   mixed (diagonal) tiles read entries.  Rows past nq get lse = +1e30 and
//   delta = 0 (TMA's zero rows would give p = e^s), so their p and ds are 0.
//
// Design of L.  A block owns 64 q rows of one head.  Q and dO arrive once,
// by TMA; K and V tiles of 64 key rows stream through a ring of two stages,
// the tile after next loaded as soon as a tile's products are done.  S = Q
// K^T and dP = dO V^T; p = e^(s - lse) as 2^x with the scale folded into the
// exponent's one fma where the tile adds nothing (no mask, or a mask tile of
// zeros); ds in place of dP; dQ += dS K with K's tile as the MN-major B
// operand.  dQ (64 x HD f32) stays in registers: 32 a thread at HD = 64
// (three blocks an SM), 64 at HD = 128 (two).  Columns past nkv, which TMA
// fills with zero keys, get p = 0 explicitly (e^(0 - lse) may be +inf where
// lse is about -1e30).  The q tiles launch longest-work first (the last
// tiles of a causal mask see the most keys).  dq is written once, in a
// fixed order: the result does not depend on the order blocks finish in.
//
// Design of M.
// - A block owns 64 key rows of one q head and walks the q rows in tiles of
//   BQ = 64 (32 at HD = 128, so that dK and dV, 128 f32 registers a thread
//   there, fit beside the tile's S^T and dP^T).  K and V arrive once; Q and
//   dO tiles stream through a ring of two stages, the tile after next loaded
//   as soon as a tile's products are done, so a load has a whole tile's work
//   to land in.  lse and delta of the next tile are read at the start of a
//   tile and staged in shared memory at its end.
// - The product runs transposed: S^T = K Q^T and dP^T = V dO^T, K and V as
//   the A operand, Q and dO tiles as B (their rows, K-major).  p^T and ds^T
//   are then the register A operand of dV += P^T dO and dK += dS^T Q.  The
//   tensor cores overlap the elementwise work: p^T is built while dP^T runs,
//   ds^T while dV's products run, and three blocks share an SM at HD = 64
//   (two at HD = 128).
// - The block decides every q tile's fate before its walk (all threads read
//   the ranges and every row's lse at once), so it loads only live tiles,
//   first to last.  Blocks launch longest work first: under a causal mask
//   the first key tiles see the most q rows.

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace ggml_tpu_torch {
namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr int KT = 64;   // key rows of an M block, q rows of an L block, and the side of a mask-range tile
constexpr int WG = 128;  // one warpgroup

// TMA maps: 4-d (column, row, head, batch), boxes of 64 columns
struct BwdMaps {
  CUtensorMap q, k, v, dout;
};

// x (KQ k16 steps of 16 accumulator columns, 8 values each) as hi + lo bf16
// register A operands: k step kk holds columns 16 kk .. 16 kk + 15
template <int KQ>
__device__ __forceinline__ void split_frags(const float (&x)[8 * KQ], uint32_t (&hi)[KQ][4], uint32_t (&lo)[KQ][4]) {
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) split_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1], hi[kk][e], lo[kk][e]);
}

// acc += X B with X as hi + lo (split_frags), the small terms first; B is
// MN-major in shared memory at descriptor db: k step kk is 16 rows on,
// column block nb is `panel` (16-byte units) on
template <int KQ, int NB>
__device__ __forceinline__ void wgmma_hi_lo(float (&acc)[NB][32], const uint32_t (&hi)[KQ][4],
                                            const uint32_t (&lo)[KQ][4], uint64_t db, int panel) {
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) wgmma_rs(acc[nb], lo[kk], db + nb * panel + kk * 128);
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) wgmma_rs(acc[nb], hi[kk], db + nb * panel + kk * 128);
}

struct DkvArgs {
  const float* mask;    // (>= nq rows, nkv columns, row stride nkv) or null
  const float* ranges;  // (2, nqr, nkt): min, max of each 64 x 64 tile's mask entries
  const float* slopes;  // (H)
  const float* lse;     // (B, H, nq)
  const float* delta;   // (B, H, nq)
  __nv_bfloat16* dk;    // (B, H, nkv, d)
  __nv_bfloat16* dv;    // (B, H, nkv, dv)
  int B, H, Hkv, nq, nkv, d, dvd, nqt, nqr, nkt;  // nqt: tiles of BQ q rows; nqr, nkt: of the ranges
  float scale;
};

// q rows of a tile
template <int HD>
__host__ __device__ constexpr int dkv_bq() { return HD == 64 ? 64 : 32; }

// K and V, two stages of Q and dO, two of lse and delta, three mbarriers;
// two flags per q tile follow
template <int HD>
__host__ __device__ constexpr int dkv_smem_fixed() {
  return 2 * KT * HD * 2 + 4 * dkv_bq<HD>() * HD * 2 + 4 * dkv_bq<HD>() * 4 + 3 * 8;
}

// three blocks an SM at HD = 64 (168 registers a thread), two at HD = 128
template <int HD>
__global__ void __launch_bounds__(WG, HD == 64 ? 3 : 2)
    fa_bwd_dkv_sm90_kernel(const __grid_constant__ DkvArgs a, const __grid_constant__ BwdMaps maps) {
  constexpr int BQ = dkv_bq<HD>();
  constexpr int NS = BQ / 2;   // accumulators of S^T (and of dP^T) a thread holds
  constexpr int KQ = BQ / 16;  // k16 steps of the dV and dK products
  constexpr int NB = HD / 64;  // 64-column blocks of dK and dV
  constexpr int KB = KT * HD * 2, QB = BQ * HD * 2;  // bytes of a K or V tile, of a Q or dO tile
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + KB;
  unsigned char* Qs = smem + 2 * KB;            // stage st at Qs + st * QB
  unsigned char* Os = smem + 2 * KB + 2 * QB;   // dO, stage st at Os + st * QB
  float* LD = reinterpret_cast<float*>(smem + 2 * KB + 4 * QB);  // per stage: lse of the BQ rows, then delta
  uint64_t* bars = reinterpret_cast<uint64_t*>(LD + 4 * BQ);     // K and V, then stage 0 and 1
  // per q tile: an entry of its mask tile (times the slope) above -5e29; a
  // row with lse at or below -2.5e29 (a row masked with the finite -1e30
  // everywhere: p = 1 on every column).  Either makes the tile live.
  unsigned char* live = reinterpret_cast<unsigned char*>(bars + 3);
  unsigned char* low = live + a.nqt;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int bh = blockIdx.x % (a.B * a.H);
  const int kt = blockIdx.x / (a.B * a.H);  // longest work first
  const int b = bh / a.H, h = bh % a.H, hk = h / (a.H / a.Hkv);
  const int k0 = kt * KT;
  const float slope = a.slopes[h];
  const bool have_mask = a.mask != nullptr;
  // the mask's min and max over the 64 x 64 tile of q range-row rq: at [rq * nkt]
  const float* mn_col = have_mask ? a.ranges + kt : nullptr;
  const float* mx_col = have_mask ? a.ranges + (size_t)a.nqr * a.nkt + kt : nullptr;
  const float* lse_bh = a.lse + (size_t)bh * a.nq;
  const float* del_bh = a.delta + (size_t)bh * a.nq;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = tid; i < a.nqt; i += WG) low[i] = 0;
  __syncthreads();
  if (tid == 0) {
    mbar_expect(&bars[0], 2 * KB);
    tma_tile<HD, KT>(Ks, &maps.k, &bars[0], k0, hk, b);
    tma_tile<HD, KT>(Vs, &maps.v, &bars[0], k0, hk, b);
  }

  // which q tiles are live, from the ranges and every row's lse read at
  // once (one round trip before the first tile's loads)
  for (int i = tid; i < a.nqt; i += WG)
    live[i] = !have_mask || slope * mx_col[(size_t)(i * BQ / KT) * a.nkt] > 0.5f * NEG_SENTINEL;
  if (have_mask) {
#pragma unroll 4
    for (int row = tid; row < a.nq; row += WG)
      if (lse_bh[row] <= 0.25f * NEG_SENTINEL) low[row / BQ] = 1;
  }
  __syncthreads();
  auto next_live = [&](int qt) {
    while (qt < a.nqt && !live[qt] && !low[qt]) ++qt;
    return qt;
  };
  // TMA copies of a q tile's Q and dO into stage st, started by thread 0
  auto load_q = [&](int qt, int st) {
    mbar_expect(&bars[1 + st], 2 * QB);
    tma_tile<HD, BQ>(Qs + st * QB, &maps.q, &bars[1 + st], qt * BQ, h, b);
    tma_tile<HD, BQ>(Os + st * QB, &maps.dout, &bars[1 + st], qt * BQ, h, b);
  };
  // what this thread stages of q tile qt: threads 0..BQ-1 its rows' lse,
  // BQ..2BQ-1 their delta; rows past nq lse = +1e30, delta = 0
  auto lse_delta = [&](int qt) {
    const int row = qt * BQ + tid % BQ;
    if (row >= a.nq) return tid < BQ ? -NEG_SENTINEL : 0.f;
    return tid < BQ ? lse_bh[row] : del_bh[row];
  };

  int cur = next_live(0), nxt = next_live(cur + 1);
  if (tid == 0) {
    if (cur < a.nqt) load_q(cur, 0);
    if (nxt < a.nqt) load_q(nxt, 1);
  }
  if (cur < a.nqt && tid < 2 * BQ) LD[tid] = lse_delta(cur);
  __syncthreads();

  // descriptors, advanced by adding to the start address (16-byte units).
  // K and V are A (K-major); Q and dO are B of S^T and dP^T (K-major: k step
  // kk is panel kk / 4, 32 bytes times kk % 4 into its rows) and B of dK and
  // dV (MN-major: k step kk is 16 rows on, block nb is panel nb)
  const uint64_t d_k = sw128_desc(Ks, 16), d_v = sw128_desc(Vs, 16);
  const uint64_t d_q = sw128_desc(Qs, 16), d_o = sw128_desc(Os, 16);
  const uint64_t d_qt = sw128_desc(Qs, BQ * 128), d_ot = sw128_desc(Os, BQ * 128);

  // this thread's key rows r_lo = 16 warp + g and r_lo + 8 of the block; in
  // each accumulator block, register 4 j + e holds column 8 j + 2 t + (e & 1)
  // of row r_lo (e < 2) or r_lo + 8
  const int r_lo = 16 * warp + (lane >> 2);
  const bool ok_lo = k0 + r_lo < a.nkv, ok_hi = k0 + r_lo + 8 < a.nkv;  // key rows past nkv: p = 0
  const int key_lo = min(k0 + r_lo, a.nkv - 1), key_hi = min(k0 + r_lo + 8, a.nkv - 1);  // clamped for mask reads
  float dk[NB][32], dv[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[nb][i] = dv[nb][i] = 0.f;
  const int k_steps = (a.d + 15) / 16, v_steps = (a.dvd + 15) / 16;

  mbar_wait(&bars[0], 0);  // K and V are here
  int st = 0;
  uint32_t phases = 0;  // bit st: the parity stage st's barrier completes next
  while (cur < a.nqt) {
    const float pre = lse_delta(nxt);  // staged for the next tile at the end of this one
    mbar_wait(&bars[1 + st], (phases >> st) & 1);
    phases ^= 1u << st;
    const uint64_t so = (uint64_t)(st * QB) >> 4;

    // S^T = K Q^T, dP^T = V dO^T, two groups: p is built while dP^T runs
    float s[NS], dp[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wg_fence();
    for (int kk = 0; kk < k_steps; ++kk)
      wgmma_ss(s, d_k + (kk >> 2) * (KT * 8) + (kk & 3) * 2, d_q + so + (kk >> 2) * (BQ * 8) + (kk & 3) * 2);
    wg_commit();
    for (int kk = 0; kk < v_steps; ++kk)
      wgmma_ss(dp, d_v + (kk >> 2) * (KT * 8) + (kk & 3) * 2, d_o + so + (kk >> 2) * (BQ * 8) + (kk & 3) * 2);
    wg_commit();
    wg_wait1();
    fence_regs(s);

    // scores: scale and the tile's mask (each branch taken by the whole
    // tile), then p^T in place
    const int q0 = cur * BQ;
    const size_t rq = (size_t)(q0 / KT) * a.nkt;
    if (have_mask && mn_col[rq] != mx_col[rq]) {  // mixed: the mask's own entries
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int row = min(q0 + (i >> 2) * 8 + 2 * t + (i & 1), a.nq - 1);
        s[i] = s[i] * a.scale + slope * a.mask[(size_t)row * a.nkv + ((i & 2) ? key_hi : key_lo)];
      }
    } else if (have_mask) {  // uniform: one value for the whole tile
      const float bias = slope * mn_col[rq];
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] = s[i] * a.scale + bias;
    } else {
#pragma unroll
      for (int i = 0; i < NS; ++i) s[i] *= a.scale;
    }
    const float* Lt = LD + st * 2 * BQ;  // lse of the tile's rows, then delta
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int c = (i >> 2) * 8 + 2 * t + (i & 1);
      // e^x as 2^(x log2 e): one multiply and the hardware's exp2
      s[i] = ((i & 2) ? ok_hi : ok_lo) ? ex2_ftz((s[i] - Lt[c]) * LOG2E) : 0.f;
    }
    // p^T and ds^T as hi + lo bf16 in the A-fragment layout (k step kk
    // covers q rows 16 kk ..); the small terms go first.  dV += P^T dO runs
    // while ds^T is built.
    uint32_t ph[KQ][4], pl[KQ][4], dh[KQ][4], dl[KQ][4];
    split_frags(s, ph, pl);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(dv[nb]);
    wg_fence();
    wgmma_hi_lo(dv, ph, pl, d_ot + so, BQ * 8);
    wg_commit();
    wg_wait1();  // dP^T is here
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int c = (i >> 2) * 8 + 2 * t + (i & 1);
      dp[i] = s[i] * (dp[i] - Lt[BQ + c]) * a.scale;
    }
    split_frags(dp, dh, dl);
    // dK += dS^T Q
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(dk[nb]);
    wg_fence();
    wgmma_hi_lo(dk, dh, dl, d_qt + so, BQ * 8);
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      fence_regs(dv[nb]);
      fence_regs(dk[nb]);
    }
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(dh);
    fence_regs(dl);

    if (nxt < a.nqt && tid < 2 * BQ) LD[(st ^ 1) * 2 * BQ + tid] = pre;
    __syncthreads();  // every product has read this stage; the next tile's lse and delta are staged
    const int nxt2 = next_live(nxt + 1);
    if (nxt2 < a.nqt && tid == 0) load_q(nxt2, st);
    cur = nxt;
    nxt = nxt2;
    st ^= 1;
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = k0 + r_lo + 8 * half;
    if (row >= a.nkv) continue;
    __nv_bfloat16* kp = a.dk + ((size_t)bh * a.nkv + row) * a.d;
    __nv_bfloat16* vp = a.dv + ((size_t)bh * a.nkv + row) * a.dvd;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * nb + 8 * j + 2 * t;
        if (col < a.d)
          *reinterpret_cast<__nv_bfloat162*>(kp + col) =
              __floats2bfloat162_rn(dk[nb][4 * j + 2 * half], dk[nb][4 * j + 2 * half + 1]);
        if (col < a.dvd)
          *reinterpret_cast<__nv_bfloat162*>(vp + col) =
              __floats2bfloat162_rn(dv[nb][4 * j + 2 * half], dv[nb][4 * j + 2 * half + 1]);
      }
  }
}

template <int HD>
int launch_dkv(const DkvArgs& a, const BwdMaps& maps, cudaStream_t s) {
  const int smem = dkv_smem_fixed<HD>() + (2 * a.nqt + 15) / 16 * 16;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const cudaError_t rc = cudaFuncSetAttribute(fa_bwd_dkv_sm90_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              smem);
  if (rc != cudaSuccess) return (int)rc;
  fa_bwd_dkv_sm90_kernel<HD><<<a.nkt * a.H * a.B, WG, smem, s>>>(a, maps);
  return (int)cudaGetLastError();
}

struct DqArgs {
  const float* mask;    // (>= nq rows, nkv columns, row stride nkv) or null
  const float* ranges;  // (2, nqt, nkt): min, max of each 64 x 64 tile's mask entries
  const float* slopes;  // (H)
  const float* lse;     // (B, H, nq)
  const float* delta;   // (B, H, nq)
  __nv_bfloat16* dq;    // (B, H, nq, d)
  int B, H, Hkv, nq, nkv, d, dvd, nqt, nkt;  // nqt, nkt: 64-row tiles of q and of kv (those of the ranges)
  float scale;
};

// Q and dO, two stages of K and V (each tile 64 rows x HD), three mbarriers
template <int HD>
__host__ __device__ constexpr int dq_smem_bytes() {
  return 6 * KT * HD * 2 + 3 * 8;
}

// three blocks an SM at HD = 64 (168 registers a thread), two at HD = 128
template <int HD>
__global__ void __launch_bounds__(WG, HD == 64 ? 3 : 2)
    fa_bwd_dq_sm90_kernel(const __grid_constant__ DqArgs a, const __grid_constant__ BwdMaps maps) {
  constexpr int NB = HD / 64;      // 64-column blocks of dQ
  constexpr int TB = KT * HD * 2;  // bytes of a tile
  extern __shared__ __align__(1024) unsigned char smem[];
  unsigned char* Qs = smem;
  unsigned char* Os = smem + TB;       // dO
  unsigned char* KV = smem + 2 * TB;   // stage st: K at KV + 2 st TB, then V
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 6 * TB);  // Q and dO, then stage 0 and 1

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = lane & 3;
  const int bh = blockIdx.x % (a.B * a.H);
  const int qt = a.nqt - 1 - blockIdx.x / (a.B * a.H);  // longest work first
  const int b = bh / a.H, h = bh % a.H, hk = h / (a.H / a.Hkv);
  const int q0 = qt * KT;
  const float slope = a.slopes[h];
  const bool have_mask = a.mask != nullptr;
  // the mask's min and max over the 64 x 64 tile of kv tile kt: at [kt]
  const float* mn_row = have_mask ? a.ranges + (size_t)qt * a.nkt : nullptr;
  const float* mx_row = have_mask ? a.ranges + ((size_t)a.nqt + qt) * a.nkt : nullptr;

  // this thread's q rows r_lo = 16 warp + g and r_lo + 8 of the block; in
  // each accumulator block, register 4 j + e holds column 8 j + 2 t + (e & 1)
  // of row r_lo (e < 2) or r_lo + 8.  Rows past nq: lse = +1e30, delta = 0.
  const int r_lo = 16 * warp + (lane >> 2);
  const int row_lo = q0 + r_lo, row_hi = row_lo + 8;
  const size_t at = (size_t)bh * a.nq;
  const float lse_lo = row_lo < a.nq ? a.lse[at + row_lo] : -NEG_SENTINEL;
  const float lse_hi = row_hi < a.nq ? a.lse[at + row_hi] : -NEG_SENTINEL;
  const float del_lo = row_lo < a.nq ? a.delta[at + row_lo] : 0.f;
  const float del_hi = row_hi < a.nq ? a.delta[at + row_hi] : 0.f;
  const int mrow_lo = min(row_lo, a.nq - 1), mrow_hi = min(row_hi, a.nq - 1);  // clamped for mask reads
  const int n_kt = (a.nkv + KT - 1) / KT;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // a row with lse at or below -2.5e29 (masked with the finite -1e30
  // everywhere: p = 1 on every column) makes the block walk every tile
  const bool may_skip = have_mask && !__syncthreads_or(lse_lo <= 0.25f * NEG_SENTINEL ||
                                                        lse_hi <= 0.25f * NEG_SENTINEL);
  auto next_live = [&](int kt) {
    if (may_skip)
      while (kt < n_kt && !(slope * mx_row[kt] > 0.5f * NEG_SENTINEL)) ++kt;
    return kt;
  };
  // TMA copies of kv tile kt's K and V into stage st, started by thread 0
  auto load_kv = [&](int kt, int st) {
    mbar_expect(&bars[1 + st], 2 * TB);
    tma_tile<HD, KT>(KV + 2 * st * TB, &maps.k, &bars[1 + st], kt * KT, hk, b);
    tma_tile<HD, KT>(KV + (2 * st + 1) * TB, &maps.v, &bars[1 + st], kt * KT, hk, b);
  };

  int cur = next_live(0), nxt = next_live(cur + 1);
  if (tid == 0 && cur < n_kt) {
    mbar_expect(&bars[0], 2 * TB);
    tma_tile<HD, KT>(Qs, &maps.q, &bars[0], q0, h, b);
    tma_tile<HD, KT>(Os, &maps.dout, &bars[0], q0, h, b);
    load_kv(cur, 0);
    if (nxt < n_kt) load_kv(nxt, 1);
  }

  // descriptors, advanced by adding to the start address (16-byte units).
  // Q, dO (A) and the K, V tiles (B) of S and dP are K-major: k step kk is
  // panel kk / 4, 32 bytes times kk % 4 into its rows; K is B of dQ too,
  // MN-major: k step kk is 16 rows on, block nb is panel nb
  const uint64_t d_q = sw128_desc(Qs, 16), d_o = sw128_desc(Os, 16);
  const uint64_t d_kv = sw128_desc(KV, 16), d_kt = sw128_desc(KV, KT * 128);
  float dq[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[nb][i] = 0.f;
  const int k_steps = (a.d + 15) / 16, v_steps = (a.dvd + 15) / 16;
  // p = 2^(s scale log2 e - lse log2 e) where a tile adds nothing
  const float c_fold = a.scale * LOG2E, o_lo = -lse_lo * LOG2E, o_hi = -lse_hi * LOG2E;

  if (cur < n_kt) mbar_wait(&bars[0], 0);  // Q and dO are here
  int st = 0;
  uint32_t phases = 0;  // bit st: the parity stage st's barrier completes next
  while (cur < n_kt) {
    mbar_wait(&bars[1 + st], (phases >> st) & 1);
    phases ^= 1u << st;
    const uint64_t ko = (uint64_t)(2 * st * TB) >> 4, vo = (uint64_t)((2 * st + 1) * TB) >> 4;

    // S = Q K^T, dP = dO V^T, two groups: p is built while dP runs
    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wg_fence();
    for (int kk = 0; kk < k_steps; ++kk) {
      const uint64_t o = (kk >> 2) * (KT * 8) + (kk & 3) * 2;
      wgmma_ss(s, d_q + o, d_kv + ko + o);
    }
    wg_commit();
    for (int kk = 0; kk < v_steps; ++kk) {
      const uint64_t o = (kk >> 2) * (KT * 8) + (kk & 3) * 2;
      wgmma_ss(dp, d_o + o, d_kv + vo + o);
    }
    wg_commit();
    wg_wait1();
    fence_regs(s);

    // p in place of s: scale and the tile's mask (each branch taken by the
    // whole tile), e^x as 2^(x log2 e)
    const int kv0 = cur * KT;
    if (have_mask && mn_row[cur] != mx_row[cur]) {  // mixed: the mask's own entries
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = min(kv0 + (i >> 2) * 8 + 2 * t + (i & 1), a.nkv - 1);
        const float sv = s[i] * a.scale + slope * a.mask[(size_t)((i & 2) ? mrow_hi : mrow_lo) * a.nkv + col];
        s[i] = ex2_ftz((sv - ((i & 2) ? lse_hi : lse_lo)) * LOG2E);
      }
    } else if (have_mask && mn_row[cur] != 0.f) {  // uniform: one value for the whole tile
      const float bias = slope * mn_row[cur];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = ex2_ftz((s[i] * a.scale + bias - ((i & 2) ? lse_hi : lse_lo)) * LOG2E);
    } else {  // the tile adds nothing: the scale goes into the exponent's one fma
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = ex2_ftz(fmaf(s[i], c_fold, (i & 2) ? o_hi : o_lo));
    }
    if (kv0 + KT > a.nkv) {  // key columns past nkv: zero rows of K, p = 0
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (kv0 + (i >> 2) * 8 + 2 * t + (i & 1) >= a.nkv) s[i] = 0.f;
    }
    wg_wait0();  // dP is here
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = s[i] * (dp[i] - ((i & 2) ? del_hi : del_lo)) * a.scale;
    // dQ += dS K
    uint32_t dh[4][4], dl[4][4];
    split_frags(dp, dh, dl);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(dq[nb]);
    wg_fence();
    wgmma_hi_lo(dq, dh, dl, d_kt + ko, KT * 8);
    wg_commit();
    wg_wait0();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) fence_regs(dq[nb]);
    fence_regs(dh);
    fence_regs(dl);

    __syncthreads();  // every product has read this stage
    const int nxt2 = next_live(nxt + 1);
    if (nxt2 < n_kt && tid == 0) load_kv(nxt2, st);
    cur = nxt;
    nxt = nxt2;
    st ^= 1;
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = half ? row_hi : row_lo;
    if (row >= a.nq) continue;
    __nv_bfloat16* op = a.dq + ((size_t)bh * a.nq + row) * a.d;
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * nb + 8 * j + 2 * t;
        if (col < a.d)
          *reinterpret_cast<__nv_bfloat162*>(op + col) =
              __floats2bfloat162_rn(dq[nb][4 * j + 2 * half], dq[nb][4 * j + 2 * half + 1]);
      }
  }
}

template <int HD>
int launch_dq(const DqArgs& a, const BwdMaps& maps, cudaStream_t s) {
  constexpr int smem = dq_smem_bytes<HD>();
  const cudaError_t rc = cudaFuncSetAttribute(fa_bwd_dq_sm90_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              smem);
  if (rc != cudaSuccess) return (int)rc;
  fa_bwd_dq_sm90_kernel<HD><<<a.nqt * a.H * a.B, WG, smem, s>>>(a, maps);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int H, int Hkv, int nq, int nkv, int d, int dv) {
  return B < 1 || H < 1 || Hkv < 1 || H % Hkv || nq < 1 || nkv < 1 || d < 8 || dv < 8 || d % 8 || dv % 8 ||
         d > 128 || dv > 128;
}

// the TMA maps of q (B, H, nq, d), k (B, Hkv, nkv, d), v (B, Hkv, nkv, dv)
// and dout (B, nq, H, dv), all contiguous; boxes of q_rows rows for q and
// dout, 64 for k and v
bool make_bwd_maps(BwdMaps* maps, const void* q, const void* k, const void* v, const void* dout, int B, int H, int Hkv,
                   int nq, int nkv, int d, int dv, int q_rows) {
  const long long n_q = nq, n_kv = nkv;
  return make_map(&maps->q, q, B, H, nq, d, H * n_q * d, n_q * d, d, q_rows) &&
         make_map(&maps->k, k, B, Hkv, nkv, d, Hkv * n_kv * d, n_kv * d, d, KT) &&
         make_map(&maps->v, v, B, Hkv, nkv, dv, Hkv * n_kv * dv, n_kv * dv, dv, KT) &&
         make_map(&maps->dout, dout, B, H, nq, dv, n_q * H * dv, dv, (long long)H * dv, q_rows);
}

}  // namespace
}  // namespace ggml_tpu_torch

// Kernel M for bf16 q/k/v: q (B, H, nq, d), k (B, Hkv, nkv, d), v (B, Hkv,
// nkv, dv), dout (B, nq, H, dv), lse and delta f32 (B, H, nq), all
// contiguous; mask f32 (>= nq rows, nkv columns, row stride nkv) or null,
// with its ranges from flash_mask_ranges; slopes f32 (H).  d, dv: multiples
// of 8 up to 128.  Writes dk (B, H, nkv, d) and dv (B, H, nkv, dv) in bf16,
// per q head.
extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v, const void* mask, const void* ranges,
                                  const void* slopes, const void* dout, const void* lse, const void* delta, void* dk,
                                  void* dv_out, int B, int H, int Hkv, int nq, int nkv, int d, int dv, float scale,
                                  void* stream) {
  using namespace ggml_tpu_torch;
  if (bad_shape(B, H, Hkv, nq, nkv, d, dv) || (mask != nullptr && ranges == nullptr)) return (int)cudaErrorInvalidValue;
  const bool narrow = (d > dv ? d : dv) <= 64;
  const int bq = narrow ? dkv_bq<64>() : dkv_bq<128>();
  DkvArgs a{static_cast<const float*>(mask), static_cast<const float*>(ranges), static_cast<const float*>(slopes),
            static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
            static_cast<__nv_bfloat16*>(dv_out), B, H, Hkv, nq, nkv, d, dv, (nq + bq - 1) / bq,
            (nq + KT - 1) / KT, (nkv + KT - 1) / KT, scale};
  if ((long long)a.nkt * H * B > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  BwdMaps maps{};
  if (!make_bwd_maps(&maps, q, k, v, dout, B, H, Hkv, nq, nkv, d, dv, bq))
    return (int)cudaErrorInvalidValue;  // no cuTensorMapEncodeTiled, or a layout TMA cannot describe
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return narrow ? launch_dkv<64>(a, maps, s) : launch_dkv<128>(a, maps, s);
}

// Kernel L for bf16 q/k/v: M's arguments, and dq (B, H, nq, d) bf16 in
// place of dk and dv.
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v, const void* mask, const void* ranges,
                                 const void* slopes, const void* dout, const void* lse, const void* delta, void* dq,
                                 int B, int H, int Hkv, int nq, int nkv, int d, int dv, float scale, void* stream) {
  using namespace ggml_tpu_torch;
  if (bad_shape(B, H, Hkv, nq, nkv, d, dv) || (mask != nullptr && ranges == nullptr)) return (int)cudaErrorInvalidValue;
  DqArgs a{static_cast<const float*>(mask), static_cast<const float*>(ranges), static_cast<const float*>(slopes),
           static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq),
           B, H, Hkv, nq, nkv, d, dv, (nq + KT - 1) / KT, (nkv + KT - 1) / KT, scale};
  if ((long long)a.nqt * H * B > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  BwdMaps maps{};
  if (!make_bwd_maps(&maps, q, k, v, dout, B, H, Hkv, nq, nkv, d, dv, KT)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (d > dv ? d : dv) <= 64 ? launch_dq<64>(a, maps, s) : launch_dq<128>(a, maps, s);
}
