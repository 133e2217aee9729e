// The prefill matmul pipeline of kernels C (q4k_matmul.cu, packed-nibble
// planes) and G (q8_matmul.cu, int8 planes) on Hopper (sm_90a).  Both compute
//   y[m, n] = sum_k x[m, k] * bf16(f32(q[k, n]) * f32(s[k/G, n]))   (bf16 products, f32 sums)
//           + sum_g f32(sum_{k in g} x[m, k]) * o[g, n]              (the offset term)
// for bf16 x (M, K) and y (M, Npad) f32, with s = d * sub-scale and o = -dmin
// * min code formed in f32 for compact planes, else the planes' own values
// (f32, or bf16 widened); the weight is rounded to bf16 at the same point as
// the TPU kernels (ggml_tpu/kernels/qmatmul.py:87-88, :138).  The two differ
// only in how a stage's code rows become bf16 weights (the dequant policy
// below): a nibble byte gives the low-half-plane weight of x column k2 and
// the high one of column K/2 + k2; an int8 code gives one weight.
//
// Bound on the H100: at M=100 the plane bytes at 3.35 TB/s (qkvup: 23.9 us
// over nibble planes, 40.9 over int8 planes); at M=1024 the 2 M K N bf16
// products at 989 TFLOP/s (243.2 us).  At M=1 (the decode of IQ1_M, TQ1_0
// and TQ2_0, whose groups the GEMVs do not take) the plane bytes: qkvup 70.1
// us over IQ1_M planes (2 bytes a weight), 35.6 over TQ2_0 planes.
//
// Design.
// - The product runs transposed, y^T = W^T x^T, so that the weights, which
//   are built on the fly, are wgmma's register operand A and never pass
//   through shared memory, and x, which TMA brings, is the shared-memory
//   operand B (K-major: x's rows as stored, in the 128-byte swizzle).  A
//   block owns 128 columns x 128 rows of y: two consumer warpgroups of 64
//   columns each, one wgmma m64n128k16 accumulator (64 f32 registers a
//   thread) each, and one producer warp.  Blocks walk M fastest, so the
//   blocks that share a strip of weights run together and the weights leave
//   device memory once.
// - A weight stage is 128 values of K in two sub-tiles of 64, each an x box
//   and 4 k16 steps: 64 rows of a nibble plane (each byte serves both
//   sub-tiles), 128 rows of an int8 plane.  A sub-tile's scale box holds its
//   64 / G group rows: 8 at groups of 8, where a k16 step's fragment rows k,
//   k + 1 and k + 8, k + 9 lie in two groups and take a scale pair each
//   (Frag); one row at groups of 256, which a 64-row sub-tile never crosses.  Stages go through a ring of
//   shared-memory slots (as many as fit, up to 8): the producer's one thread
//   starts TMA boxes (x, zero columns past K, and zero rows past M in the
//   last row tile; below 128 rows the box is M rows and the tile's other
//   rows keep what the slot held, which only y's unwritten rows read: TMA's
//   zero fill of rows outside the tensor costs time, and with 127 of them
//   G at M = 1 ran slower than at M = 100 over the same planes; the raw
//   code tile, also swizzled so that the consumers' reads do not collide;
//   the scale rows, and d of compact planes) that an mbarrier counts, and
//   refills a slot once all 8 consumer warps have released it.
// - A thread builds the A fragments of its warp's 16 columns: fragment rows
//   g and g + 8 of a warp are the adjacent plane columns 2 g and 2 g + 1
//   (the epilogue puts them back), so the code tile read as 16-bit elements
//   and transposed by ldmatrix gives each thread exactly its codes, two k16
//   steps an instruction.  Codes become floats by a byte
//   permute into a float's mantissa (no integer conversion) and one fma
//   (Frag below).  Two sets of A registers alternate: a stage is built
//   while the tensor cores run the previous one's products; the warpgroups
//   need no barrier between them.  For nibble planes a code byte gives the
//   low-half-plane weight (against the x box at column k2) and the high one
//   (against the box at K/2 + k2), so each code is read once, as the TPU
//   kernel feeds x_lo and x_hi.  Stages that lie wholly inside the plane
//   are built without a bounds test, so all their loads go out together.
// - The offset term runs on the tensor cores too: after the weight stages,
//   stages of 64 groups add xsum_hi o_hi + xsum_hi o_lo + xsum_lo o_hi with
//   hi = bf16(v), lo = bf16(v - hi) (what is dropped is below 2^-16 of each
//   term).  A small pass writes the group sums of x as (M, 2 Gp) bf16
//   [hi | lo] (Gp = K/G rounded up to 64, zeros past K/G); the consumers
//   build o_hi and o_lo fragments from the offset planes.
// - Where the tiles would not fill the card (M=100 at N = 4096), blocks split
//   the stages (split-K): each writes its f32 partial to a scratch buffer,
//   and the last block of a tile to arrive (a counter that each launch
//   leaves at zero) adds the partials in the fixed order 0, 1, ... and
//   writes y, so the result does not depend on arrival order.
#pragma once

#include "common.cuh"
#include "sm90_common.cuh"

namespace ggml_tpu_torch {
namespace {

constexpr int QM_BM = 128, QM_BN = 128, QM_BK = 64;  // rows and columns of y a block owns; values of K a sub-tile
constexpr int QM_CONSUMERS = 256;                    // two warpgroups, 64 columns of y each
constexpr int QM_THREADS = QM_CONSUMERS + 32;        // and the producer warp
constexpr int QM_MAX_STAGES = 8;
constexpr int QM_XBOX = QM_BM * 128;                 // bytes of an x box: 128 rows x 64 bf16
constexpr int QM_SMEM_MAX = 232448;                  // dynamic shared memory a block may have

// TMA maps: x (M, K); the code plane (rows, Npad) u8; the scale plane viewed
// as (rows, Npad) (sub-scale codes of compact planes); the offset plane (K/G,
// Npad) (min codes of compact planes); the group sums (M, 2 Gp) bf16; the
// superblock scales d and dmin of compact planes (rows, Npad)
struct QmMaps {
  CUtensorMap x, codes, scales, offsets, xs, d, dmin;
};

struct QmArgs {
  float* y;          // (M, Npad)
  float* partial;    // (split, M, Npad) where split > 1
  int* counters;     // one per tile, zero
  int M, K, Npad;
  int krows;         // rows of the code plane: K/2 (nibbles) or K
  int n_main;        // weight stages, ceil(krows / CODE_ROWS)
  int n_off;         // offset stages, Gp / 64 (0: no offsets)
  int ng, ngp;       // groups K/G, and Gp
  int sb;            // groups per superblock (compact planes)
  int ndo;           // rows of dmin an offset stage's 64 groups span (compact planes)
  int xshort;        // bytes an x (or xs) box falls short of QM_XBOX: (128 - M) rows where M < 128
  int split;         // blocks along the stages of a tile
  int stages, slot;  // the ring: slots, and bytes a slot
};

// The dequant policy.  A stage is 128 values of K in two sub-tiles of 64,
// each an x box and 4 k16 steps of A fragments.  Q4: a code byte holds two
// nibbles, the low-half-plane weight of x column k2 and the high one of K/2
// + k2, so a stage reads 64 code rows for both sub-tiles; else one int8 code
// a weight, 128 code rows, 64 a sub-tile.  COMPACT: the scale plane holds
// int8 sub-scale codes (times d), the offset plane int8 min codes (times
// -dmin); else both hold ST values.  G: 16 or 32 codes a scale; int8 planes
// with multiplied-out scales also 8 (IQ1_M) and 256 (TQ1_0, TQ2_0).
template <bool Q4, bool COMPACT, typename ST, int G>
struct QmPolicy {
  static_assert(G == 16 || G == 32 || (!Q4 && !COMPACT && (G == 8 || G == 256)), "group size");
  static constexpr int NSUB = 2;                            // x boxes a weight stage
  static constexpr int CODE_ROWS = Q4 ? QM_BK : 2 * QM_BK;  // plane rows a stage
  static constexpr int CODES = CODE_ROWS * QM_BN;           // bytes of its code tile (one byte a code)
  static constexpr int ES = COMPACT ? 1 : (int)sizeof(ST);  // bytes of a scale or offset
  static constexpr int S_ROWS = G < QM_BK ? QM_BK / G : 1;  // scale rows a sub-tile spans
  static constexpr int S_BOX = S_ROWS * QM_BN * ES;         // a sub-tile's scale rows
  static constexpr int O_BOX = QM_BK * QM_BN * ES;          // an offset stage's 64 group rows
  // compact planes: the superblock scales d of a stage's groups (one row a group at most)
  static constexpr int D_BOX = COMPACT ? S_ROWS * QM_BN * (int)sizeof(ST) : 0;
  static constexpr int MAIN_BYTES = NSUB * QM_XBOX + CODES + NSUB * S_BOX + NSUB * D_BOX;
  // xs hi and lo boxes, the offsets, and (compact planes) `ndo` rows of dmin
  static constexpr int OFF_BYTES = 2 * QM_XBOX + O_BOX;
};

// two adjacent plane values as f32
__device__ __forceinline__ float2 pair(const float* p) { return *reinterpret_cast<const float2*>(p); }
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 pair(const int8_t* p) {
  const char2 v = *reinterpret_cast<const char2*>(p);
  return make_float2((float)v.x, (float)v.y);
}

// byte j of w in the low mantissa bits of 2^23: the float 2^23 + byte
__device__ __forceinline__ float magic_f32(uint32_t w, int j) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | j));
}

// Frag: the A fragment of one k16 step from w01 = codes of rows k, k + 1
// and w89 = rows k + 8, k + 9 (bytes: column c, c + 1 of the first row,
// then of the second), scaled by e (columns c and c + 1: fragment rows g
// and g + 8); at groups of 8 the rows of w89 take a pair of their own.
// Each weight is bf16(f32(q) * e) as the TPU kernel rounds it; lower k in
// the low half of a register.
//  - nibbles with bf16 scales: the two codes of a register go into bf16
//    128 + q (a byte permute), and one bf16x2 fma (128 + q) e - 128 e gives
//    q e rounded once (the exact product has at most 12 significant bits);
//  - nibbles with f32 scales: 2^23 + q as f32 (a byte permute) and one f32
//    fma (2^23 + q) e - 2^23 e, exact, then the rounding to bf16;
//  - int8 codes: biased by 128 first; 2^23 + q + 128 less 2^23 + 128 is q
//    (exact), times e (e8 for w89), then the rounding to bf16.
template <bool Q4, bool BF16>
struct Frag;

// nibbles, bf16 scales: e = (s_c, s_c1) as bf16 pairs and their -128 multiples
template <>
struct Frag<true, true> {
  __nv_bfloat162 s0, s1, c0, c1;  // (s_c, s_c), (s_c1, s_c1), -128 times each (exact)
  // from the bf16 scales of columns c, c + 1 as stored (one 32-bit word)
  __device__ __forceinline__ void set(uint32_t e) {
    const uint32_t e0 = __byte_perm(e, 0u, 0x1010u), e1 = __byte_perm(e, 0u, 0x3232u);
    const __nv_bfloat162 m = __floats2bfloat162_rn(-128.f, -128.f);
    s0 = *reinterpret_cast<const __nv_bfloat162*>(&e0);
    s1 = *reinterpret_cast<const __nv_bfloat162*>(&e1);
    c0 = __hmul2(s0, m);
    c1 = __hmul2(s1, m);
  }
  __device__ __forceinline__ uint32_t mk(uint32_t w, uint32_t sel, __nv_bfloat162 s, __nv_bfloat162 c) const {
    const uint32_t m = __byte_perm(w, 0x00004343u, sel);  // bf16 128 + q in each half
    const __nv_bfloat162 r = __hfma2(*reinterpret_cast<const __nv_bfloat162*>(&m), s, c);
    return *reinterpret_cast<const uint32_t*>(&r);
  }
  __device__ __forceinline__ void build(uint32_t w01, uint32_t w89, uint32_t (&a)[4]) const {
    a[0] = mk(w01, 0x5240u, s0, c0);  // bytes 0, 2: column c, rows k, k + 1
    a[1] = mk(w01, 0x5341u, s1, c1);  // bytes 1, 3: column c + 1
    a[2] = mk(w89, 0x5240u, s0, c0);
    a[3] = mk(w89, 0x5341u, s1, c1);
  }
};

// nibbles, f32 scales
template <>
struct Frag<true, false> {
  float2 s, c;  // (s_c, s_c1) and -2^23 times each
  __device__ __forceinline__ void set(float2 e) {
    s = e;
    c = make_float2(-8388608.f * e.x, -8388608.f * e.y);
  }
  __device__ __forceinline__ void build(uint32_t w01, uint32_t w89, uint32_t (&a)[4]) const {
    a[0] = pack2_bf16(fmaf(magic_f32(w01, 0), s.x, c.x), fmaf(magic_f32(w01, 2), s.x, c.x));
    a[1] = pack2_bf16(fmaf(magic_f32(w01, 1), s.y, c.y), fmaf(magic_f32(w01, 3), s.y, c.y));
    a[2] = pack2_bf16(fmaf(magic_f32(w89, 0), s.x, c.x), fmaf(magic_f32(w89, 2), s.x, c.x));
    a[3] = pack2_bf16(fmaf(magic_f32(w89, 1), s.y, c.y), fmaf(magic_f32(w89, 3), s.y, c.y));
  }
};

// int8 codes (any scale type); the bytes come biased by 128.  s scales the
// rows of w01, s8 those of w89 (the same pair but at groups of 8)
template <bool BF16>
struct Frag<false, BF16> {
  float2 s, s8;
  __device__ __forceinline__ void set(float2 e) { s = s8 = e; }
  __device__ __forceinline__ void set(float2 e, float2 e8) {
    s = e;
    s8 = e8;
  }
  __device__ __forceinline__ float q(uint32_t w, int j) const { return magic_f32(w, j) - 8388736.f; }
  __device__ __forceinline__ void build(uint32_t w01, uint32_t w89, uint32_t (&a)[4]) const {
    a[0] = pack2_bf16(q(w01, 0) * s.x, q(w01, 2) * s.x);
    a[1] = pack2_bf16(q(w01, 1) * s.y, q(w01, 3) * s.y);
    a[2] = pack2_bf16(q(w89, 0) * s8.x, q(w89, 2) * s8.x);
    a[3] = pack2_bf16(q(w89, 1) * s8.y, q(w89, 3) * s8.y);
  }
};

// The code words of 2 k16 steps of a warp's 16 plane columns (16-byte chunk
// `chunk` of the rows, which TMA wrote with the 128-byte swizzle: chunk q of
// row r at q ^ (r % 8)) at code rows r .. r + 31, in one ldmatrix: read as
// 16-bit elements (two adjacent columns), transposed, lane (g, t) receives
// rows 2 t and 2 t + 1 of column pair g, the w01 of a Frag: w[0]
// and w[1] rows r + 2 t (+ 1) and r + 8 + 2 t (+ 1), w[2] and w[3] the same
// 16 rows further.  Lanes 8 j .. 8 j + 7 address the 8 rows of matrix j.
__device__ __forceinline__ void code_words(const unsigned char* tile, int r, int chunk, int lane, uint32_t (&w)[4]) {
  const int row = r + (lane & 7) + 8 * (lane >> 3);
  const uint32_t at = smem_addr(tile + row * 128 + ((chunk ^ (row & 7)) << 4));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(w[0]), "=r"(w[1]), "=r"(w[2]), "=r"(w[3])
               : "r"(at));
}

// Per-thread state of a consumer: its warp's 16 columns of y are plane
// columns c0 = 64 wg + 16 w + 2 g (fragment row g) and c0 + 1 (row g + 8)
// of the block; t = lane % 4 picks the fragment's k columns.
struct QmThread {
  int c0, t, lane;
};

// A weight stage: plane rows r0 .. r0 + CODE_ROWS - 1 as the A fragments
// of 2 x 4 k16 steps.  FULL: every row lies inside the plane (all stages but
// a ragged last one), so nothing is tested and the loads of all steps can be
// started together.
template <bool Q4, bool COMPACT, typename ST, int G, bool FULL>
__device__ __forceinline__ void build_weights(const QmArgs& a, const unsigned char* slot, int r0, const QmThread& th,
                                              uint32_t (&A)[8][4]) {
  using P = QmPolicy<Q4, COMPACT, ST, G>;
  const unsigned char* codes = slot + P::NSUB * QM_XBOX;
  const unsigned char* srows = codes + P::CODES;
  const unsigned char* drows = srows + P::NSUB * P::S_BOX;
  // every code word of the stage first: 2 ldmatrix a sub-tile (one for nibbles, whose halves share them)
  uint32_t words[Q4 ? 1 : P::NSUB][2][4];
#pragma unroll
  for (int h = 0; h < (Q4 ? 1 : P::NSUB); ++h)
#pragma unroll
    for (int p = 0; p < 2; ++p) code_words(codes, QM_BK * h + 32 * p, th.c0 >> 4, th.lane, words[h][p]);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int rk = 16 * kk;
    // the code words of this step: rows 16 kk + 2 t (+ 1), + 8 (+ 9) of each sub-tile
    uint32_t w01[P::NSUB], w89[P::NSUB];
#pragma unroll
    for (int h = 0; h < (Q4 ? 1 : P::NSUB); ++h) {
      w01[h] = words[h][kk >> 1][2 * (kk & 1)];
      w89[h] = words[h][kk >> 1][2 * (kk & 1) + 1];
    }
    Frag<Q4, !COMPACT && sizeof(ST) == 2> f[P::NSUB];
    bool live[P::NSUB];
#pragma unroll
    for (int h = 0; h < P::NSUB; ++h) {
      // plane row of the step: the same code rows for both nibble halves
      const int kr = r0 + (Q4 ? 0 : QM_BK * h) + rk;
      live[h] = FULL || kr < a.krows;  // krows is a multiple of 32: a step is all in or all out
      if (!live[h]) continue;
      if constexpr (COMPACT) {  // d * sub-scale in f32; d of the stage's superblock (nibbles) or of the group's
        const float2 sc = pair(reinterpret_cast<const int8_t*>(srows + h * P::S_BOX) + (rk / G) * QM_BN + th.c0);
        const int dl = Q4 ? 0 : (kr / G) / a.sb - ((r0 + QM_BK * h) / G) / a.sb;
        const float2 dv = pair(reinterpret_cast<const ST*>(drows + h * P::D_BOX) + dl * QM_BN + th.c0);
        f[h].set(make_float2(dv.x * sc.x, dv.y * sc.y));
      } else if constexpr (Q4 && sizeof(ST) == 2) {  // the bf16 pair as stored
        f[h].set(*reinterpret_cast<const uint32_t*>(srows + h * P::S_BOX + ((rk / G) * QM_BN + th.c0) * 2));
      } else if constexpr (G == 8) {  // rows k, k + 1 in group 2 kk of the box, k + 8, k + 9 in the next
        const ST* sr = reinterpret_cast<const ST*>(srows + h * P::S_BOX) + (rk / 8) * QM_BN + th.c0;
        f[h].set(pair(sr), pair(sr + QM_BN));
      } else {  // at groups of 256 the box's one row (rk / G = 0)
        f[h].set(pair(reinterpret_cast<const ST*>(srows + h * P::S_BOX) + (rk / G) * QM_BN + th.c0));
      }
    }
#pragma unroll
    for (int h = 0; h < P::NSUB; ++h) {
      if (!live[h]) {
        A[4 * h + kk][0] = A[4 * h + kk][1] = A[4 * h + kk][2] = A[4 * h + kk][3] = 0u;
        continue;
      }
      if (Q4 && h == 1) continue;  // built with h = 0 from the same bytes
      if constexpr (Q4) {
        f[0].build(w01[0] & 0x0F0F0F0Fu, w89[0] & 0x0F0F0F0Fu, A[kk]);
        f[1].build((w01[0] >> 4) & 0x0F0F0F0Fu, (w89[0] >> 4) & 0x0F0F0F0Fu, A[4 + kk]);
      } else {  // int8: biased by 128 first
        f[h].build(w01[h] ^ 0x80808080u, w89[h] ^ 0x80808080u, A[4 * h + kk]);
      }
    }
  }
}

// An offset stage: groups g0 .. g0 + 63 as the o_hi and o_lo fragments of 4
// k16 steps
template <bool Q4, bool COMPACT, typename ST, int G>
__device__ __forceinline__ void build_offsets(const QmArgs& a, const unsigned char* slot, int g0, const QmThread& th,
                                              uint32_t (&H)[4][4], uint32_t (&L)[4][4]) {
  using P = QmPolicy<Q4, COMPACT, ST, G>;
  const unsigned char* orows = slot + 2 * QM_XBOX;
  const unsigned char* dmrows = orows + P::O_BOX;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    float2 o[4];  // group rows 16 kk + 2 t + {0, 1, 8, 9}
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = 16 * kk + 2 * th.t + (q & 1) + 8 * (q >> 1);
      if constexpr (COMPACT) {  // -dmin * min code; zero past K/G (TMA fill)
        const float2 m = pair(reinterpret_cast<const int8_t*>(orows) + r * QM_BN + th.c0);
        const int dl = (g0 + r) / a.sb - g0 / a.sb;
        const float2 dm = pair(reinterpret_cast<const ST*>(dmrows) + dl * QM_BN + th.c0);
        o[q] = make_float2(-(dm.x * m.x), -(dm.y * m.y));
      } else {
        o[q] = pair(reinterpret_cast<const ST*>(orows) + r * QM_BN + th.c0);  // zero past K/G (TMA fill)
      }
    }
    float2 hi[4], lo[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      hi[q] = make_float2(__bfloat162float(__float2bfloat16_rn(o[q].x)), __bfloat162float(__float2bfloat16_rn(o[q].y)));
      lo[q] = make_float2(o[q].x - hi[q].x, o[q].y - hi[q].y);
    }
    H[kk][0] = pack2_bf16(hi[0].x, hi[1].x);
    H[kk][1] = pack2_bf16(hi[0].y, hi[1].y);
    H[kk][2] = pack2_bf16(hi[2].x, hi[3].x);
    H[kk][3] = pack2_bf16(hi[2].y, hi[3].y);
    L[kk][0] = pack2_bf16(lo[0].x, lo[1].x);
    L[kk][1] = pack2_bf16(lo[0].y, lo[1].y);
    L[kk][2] = pack2_bf16(lo[2].x, lo[3].x);
    L[kk][3] = pack2_bf16(lo[2].y, lo[3].y);
  }
}

// The ring: slot s = i % stages, phase (i / stages) & 1, kept as counters.
struct QmRing {
  unsigned char* base;
  uint64_t* full;
  uint64_t* empty;
  int stages, slot;
};

struct QmPos {
  int i, s;        // stage of this block, and its slot
  uint32_t phase;  // parity of the slot's fills so far
  __device__ __forceinline__ void next(int stages) {
    ++i;
    if (++s == stages) {
      s = 0;
      phase ^= 1u;
    }
  }
};

// Stage i (index j) of a consumer: wait for its data, build its fragments in
// `cur` while the products of stage i - 1 run, start its products, then
// release stage i - 1's slot once they are done (`prev`, their fragments,
// stay untouched until then).
template <bool Q4, bool COMPACT, typename ST, int G>
__device__ __forceinline__ void weight_stage(const QmArgs& a, const QmRing& ring, const QmPos& pos, int prev_s, int j,
                                             const QmThread& th, float (&acc)[64],
                                             uint32_t (&cur)[8][4], uint32_t (&prev)[8][4]) {
  using P = QmPolicy<Q4, COMPACT, ST, G>;
  const unsigned char* slot = ring.base + pos.s * ring.slot;
  mbar_wait(&ring.full[pos.s], pos.phase);
  const int r0 = j * P::CODE_ROWS;
  if (r0 + P::CODE_ROWS <= a.krows)
    build_weights<Q4, COMPACT, ST, G, true>(a, slot, r0, th, cur);
  else
    build_weights<Q4, COMPACT, ST, G, false>(a, slot, r0, th, cur);
  wg_fence();
#pragma unroll
  for (int h = 0; h < P::NSUB; ++h) {
    const uint64_t db = sw128_desc(slot + h * QM_XBOX, 16);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_n128(acc, cur[4 * h + kk], db + 2 * kk);
  }
  wg_commit();
  wg_wait1();
  fence_regs(prev);
  if (th.lane == 0 && pos.i > 0) mbar_arrive(&ring.empty[prev_s]);
}

template <bool Q4, bool COMPACT, typename ST, int G>
__device__ __forceinline__ void offset_stage(const QmArgs& a, const QmRing& ring, const QmPos& pos, int prev_s, int j,
                                             const QmThread& th, float (&acc)[64], uint32_t (&ch)[4][4],
                                             uint32_t (&cl)[4][4], uint32_t (&ph)[4][4], uint32_t (&pl)[4][4]) {
  const unsigned char* slot = ring.base + pos.s * ring.slot;
  mbar_wait(&ring.full[pos.s], pos.phase);
  build_offsets<Q4, COMPACT, ST, G>(a, slot, (j - a.n_main) * QM_BK, th, ch, cl);
  wg_fence();
  const uint64_t d_hi = sw128_desc(slot, 16), d_lo = sw128_desc(slot + QM_XBOX, 16);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {  // xsum_hi o_hi + xsum_hi o_lo + xsum_lo o_hi, small terms first
    wgmma_rs_n128(acc, cl[kk], d_hi + 2 * kk);
    wgmma_rs_n128(acc, ch[kk], d_lo + 2 * kk);
    wgmma_rs_n128(acc, ch[kk], d_hi + 2 * kk);
  }
  wg_commit();
  wg_wait1();
  fence_regs(ph);
  fence_regs(pl);
  if (th.lane == 0 && pos.i > 0) mbar_arrive(&ring.empty[prev_s]);
}

template <bool Q4, bool COMPACT, typename ST, int G>
__device__ __forceinline__ void qmm_body(const QmArgs& a, const QmMaps& maps) {
  using P = QmPolicy<Q4, COMPACT, ST, G>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  QmRing ring{smem, reinterpret_cast<uint64_t*>(smem + a.stages * a.slot), nullptr, a.stages, a.slot};
  ring.empty = ring.full + QM_MAX_STAGES;
  int* last_flag = reinterpret_cast<int*>(ring.empty + QM_MAX_STAGES);

  const int tid = threadIdx.x;
  // the warp, read from lane 0 so that the compiler knows it to be the same
  // across a warp (the roles branch on it)
  const int warp_id = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int m0 = blockIdx.x * QM_BM, n0 = blockIdx.y * QM_BN, z = blockIdx.z;
  const int total = a.n_main + a.n_off;
  const int j0 = (int)((long long)total * z / a.split), j1 = (int)((long long)total * (z + 1) / a.split);

  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&ring.full[s]);
      mbar_init(&ring.empty[s], QM_CONSUMERS / 32);  // every consumer warp releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp_id >= QM_CONSUMERS / 32) {  // the producer warp: one thread starts every copy
    if (tid == QM_CONSUMERS) {
      QmPos pos{0, 0, 0u};
      for (int j = j0; j < j1; ++j, pos.next(a.stages)) {
        uint64_t* full = &ring.full[pos.s];
        mbar_wait(&ring.empty[pos.s], pos.phase ^ 1u);
        unsigned char* slot = ring.base + pos.s * a.slot;
        if (j < a.n_main) {
          const int r0 = j * P::CODE_ROWS;
          mbar_expect(full, P::MAIN_BYTES - P::NSUB * a.xshort);
          unsigned char* codes = slot + P::NSUB * QM_XBOX;
          tma_load(codes, &maps.codes, full, n0, r0);
#pragma unroll
          for (int h = 0; h < P::NSUB; ++h) {
            // x columns and scale rows of sub-tile h: the low and the high half-plane
            // (K/2 columns, K/2/G scale rows apart), or the stage's two halves of 64 rows
            const int kx = Q4 ? h * a.krows + r0 : r0 + QM_BK * h;
            tma_load(slot + h * QM_XBOX, &maps.x, full, kx, m0);
            tma_load(codes + P::CODES + h * P::S_BOX, &maps.scales, full, n0, kx / G);
            // d: the half-plane's superblock (256 rows), or the row of the sub-tile's first group
            if constexpr (COMPACT)
              tma_load(codes + P::CODES + P::NSUB * P::S_BOX + h * P::D_BOX, &maps.d, full, n0,
                       Q4 ? kx / 256 : (kx / G) / a.sb);
          }
        } else {
          const int g0 = (j - a.n_main) * QM_BK;
          mbar_expect(full, P::OFF_BYTES - 2 * a.xshort + (COMPACT ? a.ndo * QM_BN * (int)sizeof(ST) : 0));
          tma_load(slot, &maps.xs, full, g0, m0);
          tma_load(slot + QM_XBOX, &maps.xs, full, a.ngp + g0, m0);
          tma_load(slot + 2 * QM_XBOX, &maps.offsets, full, n0, g0);
          if constexpr (COMPACT) tma_load(slot + 2 * QM_XBOX + P::O_BOX, &maps.dmin, full, n0, g0 / a.sb);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns plane columns 64 wg .. 64 wg + 63 of the block
  const int wg = warp_id >> 2, lane = tid & 31;
  const QmThread th{64 * wg + 16 * (warp_id & 3) + 2 * (lane >> 2), lane & 3, lane};
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  QmPos pos{0, 0, 0u};
  int prev_s = 0;  // the slot of the stage before
  {  // weight stages, two at a time so that the two sets of fragments are registers of their own
    uint32_t A0[8][4], A1[8][4];
    const int jm = min(j1, a.n_main);
    for (int j = j0; j < jm; j += 2) {
      weight_stage<Q4, COMPACT, ST, G>(a, ring, pos, prev_s, j, th, acc, A0, A1);
      prev_s = pos.s;
      pos.next(a.stages);
      if (j + 1 >= jm) break;
      weight_stage<Q4, COMPACT, ST, G>(a, ring, pos, prev_s, j + 1, th, acc, A1, A0);
      prev_s = pos.s;
      pos.next(a.stages);
    }
    wg_wait0();
    fence_regs(A0);
    fence_regs(A1);
  }
  if (j1 > a.n_main) {  // offset stages
    uint32_t H0[4][4], L0[4][4], H1[4][4] = {}, L1[4][4] = {};
    for (int j = max(j0, a.n_main); j < j1; j += 2) {
      offset_stage<Q4, COMPACT, ST, G>(a, ring, pos, prev_s, j, th, acc, H0, L0, H1, L1);
      prev_s = pos.s;
      pos.next(a.stages);
      if (j + 1 >= j1) break;
      offset_stage<Q4, COMPACT, ST, G>(a, ring, pos, prev_s, j + 1, th, acc, H1, L1, H0, L0);
      prev_s = pos.s;
      pos.next(a.stages);
    }
    wg_wait0();
    fence_regs(H0);
    fence_regs(L0);
    fence_regs(H1);
    fence_regs(L1);
  }
  fence_regs(acc);

  // accumulator 4 jj + e (e < 2): column c0, row m0 + 8 jj + 2 t + e; 4 jj + 2 + e: column c0 + 1
  const int col = n0 + th.c0, rowb = m0 + 2 * th.t;
  float* out = a.split == 1 ? a.y : a.partial + (size_t)z * a.M * a.Npad;
#pragma unroll
  for (int jj = 0; jj < 16; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = rowb + 8 * jj + e;
      if (row < a.M)
        *reinterpret_cast<float2*>(out + (size_t)row * a.Npad + col) = make_float2(acc[4 * jj + e], acc[4 * jj + 2 + e]);
    }
  if (a.split == 1) return;
  // split-K: the last block of this tile to arrive adds the partials in order
  __threadfence();
  named_sync(1, QM_CONSUMERS);
  if (tid == 0) {
    int* counter = a.counters + blockIdx.y * gridDim.x + blockIdx.x;
    const int last = atomicAdd(counter, 1) == a.split - 1;
    if (last) *counter = 0;  // zero again for the next launch
    *last_flag = last;
  }
  named_sync(1, QM_CONSUMERS);
  if (!*last_flag) return;
  __threadfence();
#pragma unroll 4
  for (int jj = 0; jj < 16; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = rowb + 8 * jj + e;
      if (row >= a.M) continue;
      const size_t at = (size_t)row * a.Npad + col;
      float2 sum = __ldcg(reinterpret_cast<const float2*>(a.partial + at));
      for (int zz = 1; zz < a.split; ++zz) {
        const float2 p = __ldcg(reinterpret_cast<const float2*>(a.partial + (size_t)zz * a.M * a.Npad + at));
        sum.x += p.x;
        sum.y += p.y;
      }
      *reinterpret_cast<float2*>(a.y + at) = sum;
    }
}

// The group sums of x: xs (M, 2 Gp) bf16 = [hi | lo] of the f32 sum of each
// row's G consecutive values, zero for groups past K/G; a thread a group,
// one 16-byte load per 8 values (one at groups of 8).
template <int G>
__global__ void __launch_bounds__(256) qmatmul_xsum_kernel(const __nv_bfloat16* __restrict__ x,
                                                           __nv_bfloat16* __restrict__ xs, int M, int K, int ng,
                                                           int ngp) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= (long long)M * ngp) return;
  const int m = (int)(i / ngp), g = (int)(i % ngp);
  float s = 0.f;
  if (g < ng) {
    const uint4* p = reinterpret_cast<const uint4*>(x + (size_t)m * K + (size_t)g * G);
#pragma unroll
    for (int c = 0; c < G / 8; ++c) {
      const uint4 w = p[c];
      const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s += __uint_as_float(ws[e] << 16);
        s += __uint_as_float(ws[e] & 0xFFFF0000u);
      }
    }
  }
  const __nv_bfloat16 hi = __float2bfloat16_rn(s);
  __nv_bfloat16* row = xs + (size_t)m * 2 * ngp;
  row[g] = hi;
  row[ngp + g] = __float2bfloat16_rn(s - __bfloat162float(hi));
}

// Host side: the planes as the C entry points get them.
struct QmPlanes {
  const void* x;
  const void* codes;
  const void* scales;   // scale plane, or compact sub-scale codes
  const void* offsets;  // offset plane, or compact min codes; null: no offset term
  const void* d;
  const void* dmin;
  void* y;
  void* xs;             // (M, 2 Gp) bf16 scratch where offsets != null
  void* partial;        // (split, M, Npad) f32 scratch where split > 1
  void* counters;       // at least ceil(M / 128) Npad / 128 int32, zero
  int M, K, Npad, sb, split;
};

// Launch `kernel` (a __global__ that runs qmm_body<Q4, COMPACT, ST, G>).
template <bool Q4, bool COMPACT, typename ST, int G>
int qmm_launch(void (*kernel)(QmArgs, QmMaps), const QmPlanes& p, cudaStream_t stream) {
  using P = QmPolicy<Q4, COMPACT, ST, G>;
  QmArgs a{};
  a.y = static_cast<float*>(p.y);
  a.partial = static_cast<float*>(p.partial);
  a.counters = static_cast<int*>(p.counters);
  a.M = p.M;
  a.K = p.K;
  a.Npad = p.Npad;
  a.krows = Q4 ? p.K / 2 : p.K;
  a.n_main = (a.krows + P::CODE_ROWS - 1) / P::CODE_ROWS;
  a.ng = p.K / G;
  a.ngp = (a.ng + 63) / 64 * 64;
  a.n_off = p.offsets != nullptr ? a.ngp / 64 : 0;
  a.sb = p.sb;
  a.split = p.split;
  a.ndo = COMPACT ? (63 / p.sb + 2 < 64 ? 63 / p.sb + 2 : 64) : 0;
  const int xrows = p.M < QM_BM ? p.M : QM_BM;  // rows of an x box
  a.xshort = (QM_BM - xrows) * 128;
  // the ring: slots as large as the larger kind of stage, as many as fit (the
  // barriers, flag and alignment take the last 1280 bytes), up to 8
  const int off_bytes = P::OFF_BYTES + a.ndo * QM_BN * (int)sizeof(ST);
  const int need = p.offsets != nullptr && off_bytes > P::MAIN_BYTES ? off_bytes : P::MAIN_BYTES;
  a.slot = (need + 1023) / 1024 * 1024;
  a.stages = (QM_SMEM_MAX - 1280) / a.slot;
  if (a.stages > QM_MAX_STAGES) a.stages = QM_MAX_STAGES;
  const int smem = a.stages * a.slot + 1280;
  const long long m_tiles = (p.M + QM_BM - 1) / QM_BM;
  if (p.split < 1 || p.split > a.n_main + a.n_off || m_tiles > 0x7fffffffLL || p.Npad / QM_BN > 65535 ||
      p.split > 65535 || (p.split > 1 && (p.partial == nullptr || p.counters == nullptr)) ||
      (p.offsets != nullptr && p.xs == nullptr) || a.stages < 2)
    return (int)cudaErrorInvalidValue;

  const CUtensorMapDataType st_type = sizeof(ST) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapDataType plane_type = COMPACT ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : st_type;
  const long long plane_row = (long long)p.Npad * P::ES;
  QmMaps maps{};
  bool ok = make_map_2d(&maps.x, p.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.M, p.K, (long long)p.K * 2, 64, xrows,
                        CU_TENSOR_MAP_SWIZZLE_128B) &&
            make_map_2d(&maps.codes, p.codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.krows, p.Npad, p.Npad, QM_BN, P::CODE_ROWS,
                        CU_TENSOR_MAP_SWIZZLE_128B) &&
            make_map_2d(&maps.scales, p.scales, plane_type, (long long)(Q4 ? 2 : 1) * a.krows / G, p.Npad, plane_row,
                        QM_BN, P::S_ROWS, CU_TENSOR_MAP_SWIZZLE_NONE);
  // compact planes: d and dmin, one row a superblock (of 256 weights for nibbles, sb groups for int8)
  const long long sup_rows = Q4 ? p.K / 256 : a.ng / (p.sb > 0 ? p.sb : 1);
  if (ok && COMPACT)
    ok = make_map_2d(&maps.d, p.d, st_type, sup_rows, p.Npad, (long long)p.Npad * sizeof(ST), QM_BN, P::S_ROWS,
                     CU_TENSOR_MAP_SWIZZLE_NONE) &&
         (p.offsets == nullptr || make_map_2d(&maps.dmin, p.dmin, st_type, sup_rows, p.Npad,
                                              (long long)p.Npad * sizeof(ST), QM_BN, a.ndo,
                                              CU_TENSOR_MAP_SWIZZLE_NONE));
  if (ok && p.offsets != nullptr)
    ok = make_map_2d(&maps.offsets, p.offsets, plane_type, a.ng, p.Npad, plane_row, QM_BN, QM_BK,
                     CU_TENSOR_MAP_SWIZZLE_NONE) &&
         make_map_2d(&maps.xs, p.xs, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.M, 2LL * a.ngp, 4LL * a.ngp, 64, xrows,
                     CU_TENSOR_MAP_SWIZZLE_128B);
  if (!ok) return (int)cudaErrorInvalidValue;  // no cuTensorMapEncodeTiled, or a layout TMA cannot describe

  if (p.offsets != nullptr) {
    const long long n = (long long)p.M * a.ngp;
    qmatmul_xsum_kernel<G><<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(p.x), static_cast<__nv_bfloat16*>(p.xs), p.M, p.K, a.ng, a.ngp);
  }
  const cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<dim3((unsigned)m_tiles, p.Npad / QM_BN, p.split), QM_THREADS, smem, stream>>>(a, maps);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ggml_tpu_torch
