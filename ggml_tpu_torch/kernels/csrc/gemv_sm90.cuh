// The GEMV pipeline of kernels A, B and the int8-x entry (q4k_gemv.cu), E and
// F (q8_gemv.cu) and H (q4_gemv.cu) on Hopper (sm_90a): y (M, Npad) f32 for
// 1 <= M <= 32 rows of x, over quantized weight planes with N last.  Every
// kernel computes, per row m and column n,
//   y = sum_segments sx * sum_g ( s_g * sum_{k in g} xq_k q_kn  +  o_g * sum_{k in g} xq_k )
// with exact int32 group dots (__dp4a), the int8 activations in the offset
// term too, and f32 everything else.  What differs from kernel to kernel is
// a plane layout (Planes below) and an activation quantizer (Quant):
//   layout                       NIB  COMPACT  kernels
//   multiplied-out nibbles        x            H (q4_gemv)
//   compact nibbles (Q4_K)        x     x      A, B, the int8-x entry
//   multiplied-out int8                        E (q8_gemv)
//   compact int8 (Q6_K, Q5_K)           x      F (q8_gemv_sb)
// Nibble planes pack two half-planes: the low nibble of packed row r is K
// row r, the high one K row K/2 + r.  Multiplied-out planes carry an f32 or
// bf16 scale (and offset) per group of G = 16 or 32; compact planes carry
// int8 sub-scale (and min) codes per group and an f32 or bf16 d (and dmin)
// per superblock of sb groups, and the kernel rebuilds s = d * sc and o =
// -dmin * m in f32.
//   quantizer   segment of one scale sx               arithmetic
//   ROWS        a row of x (B, E, F, H)               amax / 127, correctly rounded
//   TILES       kt packed rows of a half-plane (A)    amax * f32(1/127) (XLA folds /127)
//   NONE        x is int8 already (the int8-x entry)  sx = 1: the un-scaled sum
// with codes clip(rint(x / sx), -127, 127) by a correctly rounded division
// (1 where amax = 0): quantize_rows in kernels/qmatmul.py, bit for bit.
//
// Bound on the H100: device-memory bytes.  The planes cost 0.5 (nibbles) or
// 1 (int8) B/weight of codes plus their group and superblock planes, read
// once; x and y are noise.  At M <= 32 the integer work (2*M*K*N int8 ops)
// is far below the 1979 TOP/s int8 rate of the tensor cores, but __dp4a
// issues it on the integer pipes: from M = 8 on, those instructions take
// longer than the bytes.
//
// Design: keep the memory busy, with no launch before the kernel and no
// scratch in device memory.
// - A block (8 warps) owns a strip of 128 columns, a range of K and up to MT
//   = 8 rows of x.  Its slabs of 256 code rows arrive by TMA through a ring
//   of two stages counted by mbarriers: a 2-d box of 128 bytes x 256 rows of
//   codes, and the slab's group rows (scales, offsets) and, for compact
//   planes, its superblock row (d, dmin), one box each per half-plane.  A
//   slab's copies start as soon as the slab two before it is read; two
//   blocks share an SM, so an SM has up to 2 x 80 KB of planes in flight.
// - The block's first x values are loaded before the plane copies start, so
//   they do not queue behind the ring of every SM; while the copies land,
//   the block quantizes x into shared memory (the activation quantization
//   needs no launch of its own) with an exact reciprocal product, falling
//   back to the division only within 2^-12 of a rounding tie.  ROWS takes
//   the amax of the block's K range, which the blocks of a cluster push to
//   each other (their ranges cover K), so each strip reads x once.  TILES
//   reads the whole of each tile its range touches (4 KB of bf16 a tile and
//   half-plane at kt = 2048) for the tile's amax, which needs no exchange.
//   The groups' sums of the int8 activations (the offset term's factor) are
//   taken once, into shared memory.
// - In a slab each warp owns 32 code rows (one group of 32 or two of 16 in
//   each half-plane) and each lane 4 adjacent columns.  A lane reads its 32
//   code words from shared memory (a warp reads one 128-byte row: no bank
//   conflicts), transposes each 4-row x 4-column byte square with
//   __byte_perm so that a word holds 4 K-consecutive bytes of one column,
//   masks out the nibble planes where there are two, and runs __dp4a
//   against the int8 activations of each row of x.  A lane keeps its f32 sums in registers
//   over the block's slabs; the warps' sums meet in shared memory, in warp
//   order, at the end.
// - Where the strips alone do not fill the card's SMs, K is split over a
//   thread-block cluster of up to 8 blocks (gridDim.y).  Its ranks push
//   their amax, and at the end their sums, into each other's shared memory
//   (st.async, counted by the receiver's mbarrier), and the owner of each
//   share of y adds the ranks' sums in rank order: one launch, a
//   deterministic result, no scratch in device memory, no atomics on y, and
//   no cluster-wide barrier while copies are in flight (on the H100 its
//   release waited for them).
// - Rows of x beyond 8 go to further blocks (gridDim.x), which read the same
//   codes again, mostly from L2.
#pragma once

#include <type_traits>

#include "common.cuh"
#include "sm90_common.cuh"

namespace ggml_tpu_torch {
namespace {
namespace gemv {

constexpr int BN = 128;       // columns of a strip: 32 lanes x 4
constexpr int SLAB = 256;     // code rows of a stage: 8 warps x 32
constexpr int THREADS = 256;
constexpr int NST = 2;        // stages of the ring
constexpr int MAX_M = 32;
constexpr int MAX_MT = 8;     // rows of x a block takes
constexpr int MAX_SPLIT = 8;  // blocks of a cluster (the portable limit)
constexpr int HEADER = 1024;  // mbarriers, sx and the amax of warps and ranks, after the stages

enum Quant { ROWS, TILES, NONE };

struct Maps {
  CUtensorMap codes, scales, offsets, d, dmin;  // 2-d: (Npad columns, rows); boxes of BN columns
};

struct Args {
  const void* x;  // (M, K): bf16, int8 for NONE
  float* y;       // (M, Npad)
  int M, K, Npad;
  int xr;         // code rows of a block's K range (slabs per block x SLAB)
  int has_off;
  int kt;         // TILES: packed rows of a quantization tile
  int sbr;        // compact planes: code rows of a superblock (G * sb), a multiple of SLAB
};

template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return std::is_same<T, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : std::is_same<T, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                 : CU_TENSOR_MAP_DATA_TYPE_UINT8;
}

// a * b summed over 4 bytes: unsigned bytes of a (nibbles in place, up to
// 0xF0), signed bytes of b
__device__ __forceinline__ int dp4a_us(uint32_t a, int b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// A plane layout: what a stage holds besides its codes, and how a group's
// scale, offset and codes decode.  ST is the type of the float planes
// (scales and offsets, or d and dmin of compact planes).  A stage is
//   [codes SLAB x BN][scale rows][offset rows][d rows][dmin rows]
// with R group rows and one superblock row per half-plane (the offset and
// dmin rows are reserved where the weight has none).
template <bool NIB, bool COMPACT, int G_, typename ST>
struct Planes {
  static constexpr int G = G_;
  static constexpr int HALVES = NIB ? 2 : 1;
  static constexpr bool IS_COMPACT = COMPACT;
  using FT = ST;
  static constexpr int R = SLAB / G;  // group rows of a slab, per half-plane
  using SC = typename std::conditional<COMPACT, int8_t, ST>::type;
  static constexpr int GROUP_BYTES = HALVES * R * BN * (int)sizeof(SC);
  static constexpr int SUPER_BYTES = COMPACT ? HALVES * BN * (int)sizeof(ST) : 0;
  static constexpr int STAGE = SLAB * BN + 2 * GROUP_BYTES + 2 * SUPER_BYTES;

  static __device__ int expect_bytes(bool has_off) {
    return SLAB * BN + (has_off ? 2 : 1) * (GROUP_BYTES + SUPER_BYTES);
  }

  // the copies of the slab at code row r (kr code rows a half-plane) into sp
  static __device__ __forceinline__ void load(unsigned char* sp, const Maps& maps, uint64_t* bar, const Args& a,
                                              int kr, int col0, int r) {
    const int g = r / G, gr = kr / G;
    tma_load(sp, &maps.codes, bar, col0, r);
#pragma unroll
    for (int h = 0; h < HALVES; ++h) {
      tma_load(sp + SLAB * BN + h * (GROUP_BYTES / HALVES), &maps.scales, bar, col0, h * gr + g);
      if (a.has_off) tma_load(sp + SLAB * BN + GROUP_BYTES + h * (GROUP_BYTES / HALVES), &maps.offsets, bar, col0, h * gr + g);
    }
    if constexpr (COMPACT) {
      const int s = r / a.sbr, sr = kr / a.sbr;
      unsigned char* dp = sp + SLAB * BN + 2 * GROUP_BYTES;
#pragma unroll
      for (int h = 0; h < HALVES; ++h) {
        tma_load(dp + h * (SUPER_BYTES / HALVES), &maps.d, bar, col0, h * sr + s);
        if (a.has_off) tma_load(dp + SUPER_BYTES + h * (SUPER_BYTES / HALVES), &maps.dmin, bar, col0, h * sr + s);
      }
    }
  }

  // scale and offset of group row gr of the stage's half-plane h, for the
  // lane's 4 columns
  static __device__ __forceinline__ void group(const unsigned char* sp, int h, int gr, int lane, bool has_off,
                                               float s[4], float o[4]) {
    const SC* sc = reinterpret_cast<const SC*>(sp + SLAB * BN) + (h * R + gr) * BN + 4 * lane;
    load4(sc, s);
    if (has_off) {
      load4(reinterpret_cast<const SC*>(sp + SLAB * BN + GROUP_BYTES) + (h * R + gr) * BN + 4 * lane, o);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) o[j] = 0.f;
    }
    if (NIB && h == 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] *= 0.0625f;
    }
    if constexpr (COMPACT) {
      const ST* dp = reinterpret_cast<const ST*>(sp + SLAB * BN + 2 * GROUP_BYTES) + h * BN + 4 * lane;
      float d[4];
      load4(dp, d);
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] = d[j] * s[j];
      if (has_off) {
        load4(reinterpret_cast<const ST*>(reinterpret_cast<const unsigned char*>(dp) + SUPER_BYTES), d);
#pragma unroll
        for (int j = 0; j < 4; ++j) o[j] = -d[j] * o[j];
      }
    }
  }

  // a word of 4 K-consecutive code bytes of one column -> its codes of
  // half-plane h; the high nibbles stay in place, so their dot is 16 times
  // theirs (group() divides their scale by 16, exactly)
  static __device__ __forceinline__ uint32_t codes(uint32_t w, int h) {
    return NIB ? w & (h ? 0xF0F0F0F0u : 0x0F0F0F0Fu) : w;
  }
  // c + the dot of x's 4 int8 codes with such codes
  static __device__ __forceinline__ int dot(uint32_t c4, int x, int c) {
    if constexpr (NIB) return dp4a_us(c4, x, c);
    return __dp4a((int)c4, x, c);
  }
};

// One int8 activation code: clip(rint(x / s), -127, 127) with x / s
// correctly rounded.  r = RN(1 / s) (0 where s is too small or too large
// for it): x r lies within 2^-15 of RN(x / s) for |x / s| <= 128, so the
// two round to the same integer unless x r is within 2^-12 of a half, and
// there the correctly rounded division decides.
__device__ __forceinline__ int act_code(float x, float s, float r) {
  const float t = x * r;
  float q = rintf(t);
  if (r == 0.f || fabsf(t - q) > 0.5f - 0x1p-12f) q = rintf(__fdiv_rn(x, s));
  return (int)fminf(fmaxf(q, -127.f), 127.f);
}

__device__ __forceinline__ float act_rcp(float s) { return s >= 0x1p-100f && s <= 0x1p100f ? __frcp_rn(s) : 0.f; }

constexpr int XV = 8;  // x chunks of 8 values a thread loads before the copies of the planes start

// Two blocks a multiprocessor (at most 128 registers a thread)
template <class P, int QUANT, int MT>
__global__ void __launch_bounds__(THREADS, 2) gemv_sm90_kernel(const __grid_constant__ Args a,
                                                               const __grid_constant__ Maps maps) {
  constexpr int H = P::HALVES;
  constexpr int G = P::G;
  constexpr int NG = 32 / G;  // groups in a warp's 32 rows, per half-plane
  constexpr int QG = G / 4;   // 4-row squares per group
  constexpr int STAGE = P::STAGE;
  static_assert(THREADS / 32 * MT * BN * 4 <= SLAB * BN && MT * BN * 4 <= STAGE, "the sums fit in the stages");
  static_assert(QUANT != TILES || MT == 1, "per-tile scales are for one row of x");
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + NST * STAGE);  // [NST]: the stages' copies
  uint64_t* xbar = bars + NST;      // the ranks' amax received (ROWS)
  uint64_t* ebar = bars + NST + 1;  // the ranks' sums received
  float* sx = reinterpret_cast<float*>(smem + NST * STAGE + 64);  // [MT]
  float* rx = sx + MAX_MT;                                          // [MT]: RN(1 / sx)
  float* wmax = rx + MAX_MT;                                        // [warp][MT]
  float* bmax = wmax + THREADS / 32 * MAX_MT;                       // [MT]: the block's amax
  float* xmax = bmax + MAX_MT;                                      // [rank][MT]: the ranks' amax
  const int split = gridDim.y;
  float* recv = reinterpret_cast<float*>(smem + NST * STAGE + HEADER);  // [rank][MT * BN / split]: the ranks' sums
  int8_t* xq = reinterpret_cast<int8_t*>(recv + (split > 1 ? MT * BN : 0));  // [MT][half][xr]
  int* xsums = reinterpret_cast<int*>(xq + MT * H * a.xr);          // [MT][half][xr / G]: the groups' sums of xq
  float* tsx = reinterpret_cast<float*>(xsums + MT * H * (a.xr / G));  // TILES: [half][nt], the touched tiles' scales

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kr = a.K / H;                                // code rows of a half-plane
  const int m0 = blockIdx.x * MT, nm = min(MT, a.M - m0);  // this block's rows of x
  const int rank = blockIdx.y;
  const int col0 = blockIdx.z * BN;
  const int row0 = rank * a.xr;                          // the block's first code row
  const int rows = max(0, min(a.xr, kr - row0));         // and how many it walks (a multiple of 32)
  const int iters = (rows + SLAB - 1) / SLAB;
  const int chunks = rows / 8;                           // chunks of 8 values of x in a half-plane's range

  // x (bf16) chunk i of what the quantizer reads: ROWS the block's range,
  // over its halves and its rows mm of x; TILES (one row) the whole of each
  // tile the range touches, over the halves (nt tiles from t0: a warp's 32
  // chunks lie in one tile, kt / 8 being a multiple of 32)
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(a.x);
  int t0 = 0, nt = 0;
  if (QUANT == TILES && rows > 0) {
    t0 = row0 / a.kt;
    nt = (row0 + rows - 1) / a.kt - t0 + 1;
  }
  const int tc = QUANT == TILES ? a.kt / 8 : 1;
  const int nx = QUANT == ROWS ? nm * H * chunks : QUANT == TILES ? H * nt * tc : 0;
  auto x8 = [&](int i) {
    const __nv_bfloat16* p;
    if constexpr (QUANT == ROWS)
      p = xb + (size_t)(m0 + i / (H * chunks)) * a.K + (i / chunks % H) * kr + row0 + 8 * (i % chunks);
    else
      p = xb + (i / tc / nt) * kr + (t0 + i / tc % nt) * a.kt + 8 * (i % tc);
    return __ldg(reinterpret_cast<const uint4*>(p));
  };
  auto absmax8 = [](const uint4& v) {  // the max of bf16 magnitudes is one of them: exact
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&v);
    const __nv_bfloat162 m = __hmax2(__hmax2(__habs2(h2[0]), __habs2(h2[1])), __hmax2(__habs2(h2[2]), __habs2(h2[3])));
    return fmaxf(__low2float(m), __high2float(m));
  };
  // x values -> 8 int8 codes at scale s (r = RN(1 / s)), stored at chunk c
  // of half h of row mm
  auto store8 = [&](const uint4& v, float s, float r, int mm, int h, int c) {
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&v);
    uint32_t codes[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h2[e]);
      const int q0 = act_code(f.x, s, r), q1 = act_code(f.y, s, r);
      codes[e / 2] |= ((uint32_t)(q0 & 0xff) | ((uint32_t)(q1 & 0xff) << 8)) << (16 * (e % 2));
    }
    *reinterpret_cast<uint2*>(xq + (size_t)(H * mm + h) * a.xr + 8 * c) = make_uint2(codes[0], codes[1]);
  };

  // the first x chunks of every thread go out before the copies of the
  // planes: behind a ring of slabs from every SM, the few lines of x would
  // wait for device memory
  uint4 v[XV];
#pragma unroll
  for (int u = 0; u < XV; ++u)
    if (tid + u * THREADS < nx) v[u] = x8(tid + u * THREADS);

  // the TMA copies of slab `it` into its stage, started by thread 0; rows
  // past the planes arrive as zeros and belong to warps that skip the slab
  auto load = [&](int it) {
    const int st = it % NST;
    mbar_expect(&bars[st], P::expect_bytes(a.has_off));
    P::load(smem + st * STAGE, maps, &bars[st], a, kr, col0, row0 + it * SLAB);
  };
  // Where K is split, the ranks of the cluster push their amax and their
  // sums into each other's shared memory (st.async), each counted by the
  // receiver's mbarrier: after the barriers are initialized, no rank waits
  // for another at a cluster barrier while the copies are in flight
  if (tid == 0) {
    for (int i = 0; i < NST + 2; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (split > 1) {
      if (QUANT == ROWS) mbar_expect(xbar, split * MT * 4);
      mbar_expect(ebar, MT * BN * 4);
    }
  }
  if (split > 1) cluster_arrive_relaxed();  // every rank waits for this before it pushes
  if (tid == 0)
    for (int it = 0; it < min(NST, iters); ++it) load(it);

  if constexpr (QUANT == ROWS) {
    // the amax of each row of x: over the block's range, then (where K is
    // split) over the amax that every rank pushes to every rank
    float amax[MT];
#pragma unroll
    for (int mm = 0; mm < MT; ++mm) amax[mm] = 0.f;
    auto row_max = [&](const uint4& x, int i) {
      const float m = absmax8(x);
#pragma unroll
      for (int r = 0; r < MT; ++r) amax[r] = fmaxf(amax[r], r == i / (H * chunks) ? m : 0.f);
    };
#pragma unroll
    for (int u = 0; u < XV; ++u)
      if (tid + u * THREADS < nx) row_max(v[u], tid + u * THREADS);
    for (int i = tid + XV * THREADS; i < nx; i += THREADS) row_max(x8(i), i);
#pragma unroll
    for (int mm = 0; mm < MT; ++mm) {
      const float w = warp_max(amax[mm]);
      if (lane == 0) wmax[warp * MT + mm] = w;
    }
    __syncthreads();  // (also: the mbarriers are initialized)
    if (tid < MT) {
      float m = 0.f;
      for (int w = 0; w < THREADS / 32; ++w) m = fmaxf(m, wmax[w * MT + tid]);
      bmax[tid] = m;
    }
    __syncthreads();
    if (split > 1) {  // the block's amax to every rank, whose ranges cover K
      cluster_wait();
      if (tid < MT * split)
        st_async(cluster_addr(&xmax[rank * MT + tid % MT], tid / MT), bmax[tid % MT], cluster_addr(xbar, tid / MT));
    }
    if (tid < MT) {
      float m = bmax[tid];
      if (split > 1) {
        mbar_wait(xbar, 0);
        for (int r = 0; r < split; ++r) m = fmaxf(m, xmax[r * MT + tid]);
      }
      const float s = m == 0.f ? 1.f : m / 127.f;
      sx[tid] = s;
      rx[tid] = act_rcp(s);
    }
    __syncthreads();
    // the block's x values as int8: the first chunks from registers, the
    // rest read again (mostly from L1)
    auto quant = [&](const uint4& x, int i) {
      const int mm = i / (H * chunks);
      store8(x, sx[mm], rx[mm], mm, i / chunks % H, i % chunks);
    };
#pragma unroll
    for (int u = 0; u < XV; ++u)
      if (tid + u * THREADS < nx) quant(v[u], tid + u * THREADS);
    for (int i = tid + XV * THREADS; i < nx; i += THREADS) quant(x8(i), i);
  } else if constexpr (QUANT == TILES) {
    // the amax of each touched tile, as the bits of a non-negative float
    unsigned* tmax = reinterpret_cast<unsigned*>(tsx);
    for (int i = tid; i < H * nt; i += THREADS) tmax[i] = 0u;
    __syncthreads();  // (also: the mbarriers are initialized)
    auto tile_max = [&](const uint4& x, int i) {  // whole warps
      const float m = warp_max(absmax8(x));
      if (lane == 0) atomicMax(&tmax[i / tc], __float_as_uint(m));
    };
#pragma unroll
    for (int u = 0; u < XV; ++u)
      if (tid + u * THREADS < nx) tile_max(v[u], tid + u * THREADS);
    for (int i = tid + XV * THREADS; i < nx; i += THREADS) tile_max(x8(i), i);
    __syncthreads();
    for (int i = tid; i < H * nt; i += THREADS) {
      const float m = __uint_as_float(tmax[i]);
      tsx[i] = m == 0.f ? 1.f : m * (1.f / 127.f);
    }
    __syncthreads();
    // the block's range as int8 (read again, mostly from L1)
    for (int i = tid; i < H * chunks; i += THREADS) {
      const int h = i / chunks, c = i % chunks, r = row0 + 8 * c;
      const float s = tsx[h * nt + r / a.kt - t0];
      store8(__ldg(reinterpret_cast<const uint4*>(xb + h * kr + r)), s, act_rcp(s), 0, h, c);
    }
  } else {
    // int8 x: the block's range as it is
    const int8_t* xi = static_cast<const int8_t*>(a.x);
    __syncthreads();  // the mbarriers are initialized
    for (int i = tid; i < H * chunks; i += THREADS) {
      const int h = i / chunks, c = i % chunks;
      *reinterpret_cast<uint2*>(xq + (size_t)h * a.xr + 8 * c) =
          __ldg(reinterpret_cast<const uint2*>(xi + h * kr + row0 + 8 * c));
    }
  }
  if (QUANT != ROWS && split > 1) cluster_wait();  // before the sums are pushed
  __syncthreads();
  // each group's sum of int8 activations (the offset term's factor), once
  const int ng = rows / G;  // groups of the range, per half-plane
  for (int i = tid; i < nm * H * ng; i += THREADS) {
    const int4* q = reinterpret_cast<const int4*>(xq + (size_t)(i / ng) * a.xr + (i % ng) * G);
    int t = 0;
#pragma unroll
    for (int w = 0; w < G / 16; ++w) {
      const int4 x4 = q[w];
      t = __dp4a(x4.x, 0x01010101, __dp4a(x4.y, 0x01010101, __dp4a(x4.z, 0x01010101, __dp4a(x4.w, 0x01010101, t))));
    }
    xsums[(i / ng) * (a.xr / G) + i % ng] = t;
  }
  __syncthreads();

  float acc[MT][4];
#pragma unroll
  for (int mm = 0; mm < MT; ++mm) acc[mm][0] = acc[mm][1] = acc[mm][2] = acc[mm][3] = 0.f;
  for (int it = 0; it < iters; ++it) {
    const int st = it % NST;
    mbar_wait(&bars[st], (it / NST) & 1);
    if (row0 + it * SLAB + warp * 32 < kr) {  // kr % 32 == 0: a warp's rows are all inside or all past it
      const unsigned char* sp = smem + st * STAGE;
      const unsigned char* cp = sp + warp * 32 * BN + 4 * lane;
      // 4 rows x 4 columns of bytes -> one word of 4 rows per column
      uint32_t cw[8][4];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const uint32_t w0 = *reinterpret_cast<const uint32_t*>(cp + (4 * q) * BN);
        const uint32_t w1 = *reinterpret_cast<const uint32_t*>(cp + (4 * q + 1) * BN);
        const uint32_t w2 = *reinterpret_cast<const uint32_t*>(cp + (4 * q + 2) * BN);
        const uint32_t w3 = *reinterpret_cast<const uint32_t*>(cp + (4 * q + 3) * BN);
        const uint32_t t01l = __byte_perm(w0, w1, 0x5140), t01h = __byte_perm(w0, w1, 0x7362);
        const uint32_t t23l = __byte_perm(w2, w3, 0x5140), t23h = __byte_perm(w2, w3, 0x7362);
        cw[q][0] = __byte_perm(t01l, t23l, 0x5410);
        cw[q][1] = __byte_perm(t01l, t23l, 0x7632);
        cw[q][2] = __byte_perm(t01h, t23h, 0x5410);
        cw[q][3] = __byte_perm(t01h, t23h, 0x7632);
      }
      float hs[H];  // TILES: the scale of the tile the slab lies in, per half-plane
#pragma unroll
      for (int h = 0; h < H; ++h) hs[h] = QUANT == TILES ? tsx[h * nt + (row0 + it * SLAB) / a.kt - t0] : 1.f;
      const int r0 = it * SLAB + warp * 32;  // the warp's first row in the block's range
      // per group and half-plane, every row of x
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        const int gr = warp * NG + gi;  // the group's row in the slab's group rows
        float s[H][4], o[H][4];
#pragma unroll
        for (int h = 0; h < H; ++h) P::group(sp, h, gr, lane, a.has_off, s[h], o[h]);
#pragma unroll
        for (int h = 0; h < H; ++h) {
#pragma unroll
          for (int mm = 0; mm < MT; ++mm) {
            if (mm >= nm) break;
            int p[4] = {0, 0, 0, 0};
            const int4* xw = reinterpret_cast<const int4*>(xq + (size_t)(H * mm + h) * a.xr + r0 + gi * G);
#pragma unroll
            for (int w = 0; w < G / 16; ++w) {
              const int4 x4 = xw[w];
              const int xa[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
              for (int e = 0; e < 4; ++e)
#pragma unroll
                for (int j = 0; j < 4; ++j) p[j] = P::dot(P::codes(cw[gi * QG + 4 * w + e][j], h), xa[e], p[j]);
            }
            const float xs = (float)xsums[(H * mm + h) * (a.xr / G) + r0 / G + gi];
#pragma unroll
            for (int j = 0; j < 4; ++j) {  // per accumulator: the low half's group, then the high half's
              const float c = (float)p[j] * s[h][j] + xs * o[h][j];
              if constexpr (QUANT == TILES)
                acc[mm][j] += c * hs[h];
              else
                acc[mm][j] += c;
            }
          }
        }
      }
    }
    __syncthreads();  // every warp has read this stage
    if (tid == 0 && it + NST < iters) load(it + NST);
  }

  // the warps' sums in warp order; every copy has landed and been read, so
  // the stages hold them.  ROWS scales the finished sum by its row's sx.
  float* red = reinterpret_cast<float*>(smem);  // [warp][MT][BN], in stage 0
  auto out = [&](int i, float t) {
    if (i / BN < nm) a.y[(size_t)(m0 + i / BN) * a.Npad + col0 + i % BN] = QUANT == ROWS ? t * sx[i / BN] : t;
  };
#pragma unroll
  for (int mm = 0; mm < MT; ++mm)
    *reinterpret_cast<float4*>(&red[(warp * MT + mm) * BN + 4 * lane]) =
        make_float4(acc[mm][0], acc[mm][1], acc[mm][2], acc[mm][3]);
  __syncthreads();
  for (int i = tid; i < MT * BN; i += THREADS) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < THREADS / 32; ++w) t += red[(w * MT + i / BN) * BN + i % BN];
    if (split == 1) {
      out(i, t);
    } else {  // the cluster's K split: rank r owns outputs [r per, (r + 1) per)
      const int per = MT * BN / split, r = i / per;
      st_async(cluster_addr(&recv[rank * per + i % per], r), t, cluster_addr(ebar, r));
    }
  }
  if (split == 1) return;
  // the owner adds the ranks' sums in rank order; no rank leaves before
  // every push into its shared memory has landed
  const int per = MT * BN / split;
  mbar_wait(ebar, 0);
  for (int i = tid; i < per; i += THREADS) {
    float t = 0.f;
    for (int r = 0; r < split; ++r) t += recv[r * per + i];
    out(rank * per + i, t);
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

// How a launch walks the planes: blocks of mt rows of x (mchunks of them),
// K split over `split` blocks of a cluster, each walking per_block slabs.
// K is split until the blocks fill the SMs and a block's quantized x takes
// at most 16 KB of shared memory, as long as every block keeps a ring's
// worth (NST slabs) to walk.
struct Plan {
  int mt, mchunks, split, per_block;
};

Plan plan(int M, int kr, int halves, int Npad) {
  Plan p{};
  const int slabs = (kr + SLAB - 1) / SLAB, strips = Npad / BN;
  p.mt = M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : MAX_MT;
  p.mchunks = (M + p.mt - 1) / p.mt;
  p.split = 1;
  while (p.split < MAX_SPLIT && 2 * p.split * NST <= slabs &&
         (strips * p.mchunks * p.split < sm_count() || (slabs + p.split - 1) / p.split * p.mt * halves > 64))
    p.split *= 2;
  p.per_block = (slabs + p.split - 1) / p.split;
  return p;
}

template <class P, int QUANT, int MT>
int launch_mt(const Args& a, const Maps& maps, const Plan& p, cudaStream_t stream) {
  const int tiles = QUANT == TILES ? 4 * P::HALVES * (p.per_block + 1) : 0;  // a range touches per_block + 1 tiles at most
  const int recv = p.split > 1 ? MT * BN * 4 : 0;
  const int smem = NST * P::STAGE + HEADER + recv + MT * P::HALVES * (a.xr + 4 * (a.xr / P::G)) + tiles;  // stages, xq, xsums
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const auto kernel = gemv_sm90_kernel<P, QUANT, MT>;
  const cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  cudaLaunchAttribute cluster{};
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = p.split;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(p.mchunks, p.split, a.Npad / BN);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = p.split > 1 ? 1 : 0;  // a cluster only where K is split
  return (int)cudaLaunchKernelEx(&cfg, kernel, a, maps);
}

// One launch of layout P with quantizer QUANT: builds the tensor maps of the
// planes and plans the grid.  codes (K/H, Npad) (H half-planes packed in a
// byte for nibbles); scales and offsets (H * K/H/G, Npad); d and dmin (H *
// K/H/sbr, Npad), compact planes only; offsets (and dmin) may be null.  x
// (M, K) bf16 (int8 for NONE), y (M, Npad) f32, all contiguous and 16-byte
// aligned.  kt: TILES' tile of packed rows; sbr: code rows of a superblock.
template <class P, int QUANT>
int run(const void* x, const void* codes, const void* scales, const void* offsets, const void* d,
        const void* dmin, void* y, int M, int K, int Npad, int kt, int sbr, cudaStream_t stream) {
  using SC = typename P::SC;
  using FT = typename P::FT;
  constexpr int H = P::HALVES;
  constexpr bool compact = P::IS_COMPACT;
  const int kr = K / H;
  if (M < 1 || M > MAX_M || K < 1 || K % H || kr % (8 * P::G) || Npad < BN || Npad % BN ||
      (compact && (d == nullptr || sbr < SLAB || sbr % SLAB || kr % sbr || (offsets == nullptr) != (dmin == nullptr))) ||
      (QUANT == TILES && (M != 1 || kt < SLAB || kt % SLAB || kr % kt)) || (QUANT == NONE && M != 1))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(M, kr, H, Npad);
  const Args a{x, static_cast<float*>(y), M, K, Npad, p.per_block * SLAB, offsets != nullptr, kt, sbr};
  const int es = (int)sizeof(SC);
  Maps maps{};
  if (!make_map_2d(&maps.codes, codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, kr, Npad, Npad, BN, SLAB,
                   CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map_2d(&maps.scales, scales, tma_type<SC>(), H * (kr / P::G), Npad, (long long)Npad * es, BN, P::R,
                   CU_TENSOR_MAP_SWIZZLE_NONE) ||
      (offsets != nullptr && !make_map_2d(&maps.offsets, offsets, tma_type<SC>(), H * (kr / P::G), Npad,
                                          (long long)Npad * es, BN, P::R, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return (int)cudaErrorInvalidValue;  // no cuTensorMapEncodeTiled, or a layout TMA cannot describe
  if (compact && (!make_map_2d(&maps.d, d, tma_type<FT>(), H * (kr / sbr), Npad, (long long)Npad * sizeof(FT), BN, 1,
                               CU_TENSOR_MAP_SWIZZLE_NONE) ||
                  (dmin != nullptr && !make_map_2d(&maps.dmin, dmin, tma_type<FT>(), H * (kr / sbr), Npad,
                                                   (long long)Npad * sizeof(FT), BN, 1, CU_TENSOR_MAP_SWIZZLE_NONE))))
    return (int)cudaErrorInvalidValue;
  if constexpr (QUANT != ROWS) {
    return launch_mt<P, QUANT, 1>(a, maps, p, stream);  // M == 1
  } else {
    switch (p.mt) {
      case 1: return launch_mt<P, ROWS, 1>(a, maps, p, stream);
      case 2: return launch_mt<P, ROWS, 2>(a, maps, p, stream);
      case 4: return launch_mt<P, ROWS, 4>(a, maps, p, stream);
      default: return launch_mt<P, ROWS, MAX_MT>(a, maps, p, stream);
    }
  }
}

}  // namespace gemv
}  // namespace
}  // namespace ggml_tpu_torch
