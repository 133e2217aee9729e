// Kernel H: int8 GEMV over packed-nibble planes with multiplied-out group
// scales, for 1 <= M <= 32 rows of x, with their per-row int8 quantization
// folded in: codes (K/2, Npad) uint8 (low nibble k < K/2, high nibble k +
// K/2), scales (2, K/2/G, Npad) plane-major, offsets (K/G, Npad) in logical-k
// group rows or absent, f32 or bf16, G = 16 or 32.
//
// Replaces (ggml_tpu/kernels/qmatmul.py) the four Pallas bodies _q4_gemv
// (:808) picks from, with the per-row activation quantization before them
// (_quantize_activations_per_row, :856) and the * sx after them
// (:1064-1073):
//   _q4gemv_kernel (:292), _q4gemv_off_kernel (:328): the per-group loop;
//   _q4gemv_bd_kernel (:362), _q4gemv_bd_off_kernel (:399): the block-diagonal
//   pair, which only fills the TPU's matrix unit at M = 1 and computes the
//   same sum.
// All compute, per row m and column n, over both half-planes h,
//   y = sx_m * sum_h sum_g ( s_hg * sum_{k in g} xq_k q_kn  +  o_hg * sum_{k in g} xq_k )
// with exact int32 group dots, the int8 activations in the offset term too,
// and f32 everything else.  xq = clip(rint(x / sx), -127, 127) with sx =
// amax / 127 (1 where amax = 0) and a correctly rounded division: the
// arithmetic of quant_segments<false> (common.cuh), bit for bit.  The low
// half reads scale rows [0, K/2/G) of plane 0 and offset rows [0, K/2/G);
// the high half plane 1 and offset rows [K/2/G, K/G).
//
// Bound on the H100: device-memory bytes.  The planes cost 0.5 B/weight of
// codes plus 2/G (bf16 scale) to 8/G (f32 scale and offset) B/weight of group
// planes, read once; x and y are noise (GPT-J's attn_qkvup, K = 4096, N =
// 28672, bf16 scales and offsets per 32: 73.4 MB, 21.9 us at 3.35 TB/s).  At
// M <= 32 the integer work (2*M*K*N int8 ops) is far below the 1979 TOP/s
// int8 rate of the tensor cores, but __dp4a issues it on the integer pipes:
// from M = 8 on, those instructions take longer than the bytes.
//
// Design: keep the memory busy, with no launch before the kernel.
// - A block (8 warps) owns a strip of 128 columns, a range of K and up to MT
//   = 8 rows of x.  Its slabs of 256 packed rows arrive by TMA through a
//   ring of two stages counted by mbarriers: a 2-d box of 128 bytes x 256
//   rows of codes, and the slab's scale (and offset) rows of both halves,
//   two boxes each.  A slab's copies start as soon as the slab two before it
//   is read; two blocks share an SM, so an SM has up to 2 x 80 KB of planes
//   in flight.
// - While the first copies land, the block reads the x values of its K
//   range (from L2) for their amax, which the blocks of a cluster exchange
//   through distributed shared memory (their ranges cover K), and quantizes
//   them into shared memory: the activation quantization needs no launch of
//   its own, and each strip reads x once.
// - In a slab each warp owns 32 packed rows (one group of 32 or two of 16 in
//   each half-plane) and each lane 4 adjacent columns.  A lane reads its 32
//   code words from shared memory (a warp reads one 128-byte row: no bank
//   conflicts), transposes each 4-row x 4-column byte square with
//   __byte_perm so that a word holds 4 K-consecutive bytes of one column,
//   masks out the two nibble planes and runs __dp4a against the int8
//   activations.  A lane keeps its f32 sums in registers over the block's
//   slabs; the warps' sums meet in shared memory, in warp order, at the end.
// - Where the strips alone do not fill the card's SMs, K is split over a
//   thread-block cluster of up to 8 blocks (gridDim.y), which add their
//   sums in rank order through distributed shared memory: one launch, a
//   deterministic result, no scratch in device memory, no atomics.
// - Rows of x beyond 8 go to further blocks (gridDim.x), which read the
//   same codes again, mostly from L2.

#include <cooperative_groups.h>

#include "common.cuh"
#include "sm90_common.cuh"

namespace ggml_tpu_torch {
namespace {

namespace cg = cooperative_groups;

constexpr int BN = 128;       // columns of a strip: 32 lanes x 4
constexpr int SLAB = 256;     // packed rows of a stage: 8 warps x 32
constexpr int THREADS = 256;
constexpr int NST = 2;        // stages of the ring
constexpr int MAX_M = 32;
constexpr int MAX_MT = 8;     // rows of x a block takes
constexpr int MAX_SPLIT = 8;  // blocks of a cluster (the portable limit)
constexpr int HEADER = 512;   // mbarriers, sx and the warps' amax, after the stages

struct GemvMaps {
  CUtensorMap codes, scales, offsets;  // 2-d: (Npad columns, rows); boxes of BN columns
};

struct GemvArgs {
  const __nv_bfloat16* x;  // (M, K)
  float* y;                // (M, Npad)
  int M, K, Npad;
  int xr;                  // packed rows of a block's K range (slabs per block x SLAB)
  int has_off;
};

// bytes of a slab's scale (or offset) rows, both halves
template <int G, typename ST>
__host__ __device__ constexpr int plane_bytes() {
  return 2 * (SLAB / G) * BN * (int)sizeof(ST);
}

// a stage: codes, scale rows, offset rows
template <int G, typename ST>
__host__ __device__ constexpr int stage_bytes() {
  return SLAB * BN + 2 * plane_bytes<G, ST>();
}

// Two blocks a multiprocessor (at most 128 registers a thread)
template <int G, typename ST, int MT>
__global__ void __launch_bounds__(THREADS, 2)
    q4_gemv_sm90_kernel(const __grid_constant__ GemvArgs a, const __grid_constant__ GemvMaps maps) {
  constexpr int NG = 32 / G;  // groups in a warp's 32 rows, per half-plane
  constexpr int QG = G / 4;   // 4-row squares per group
  constexpr int R = SLAB / G;  // group rows of a slab, per half-plane
  constexpr int PB = plane_bytes<G, ST>();
  constexpr int STAGE = stage_bytes<G, ST>();
  static_assert(THREADS / 32 * MT * BN * 4 <= SLAB * BN && MT * BN * 4 <= STAGE, "the sums fit in the stages");
  extern __shared__ __align__(1024) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + NST * STAGE);
  float* sx = reinterpret_cast<float*>(smem + NST * STAGE + 64);  // [MT]
  float* wmax = sx + MAX_MT;                                        // [warp][MT]
  float* bmax = wmax + THREADS / 32 * MAX_MT;                       // [MT]: the block's amax, read by the cluster
  int8_t* xq = reinterpret_cast<int8_t*>(smem + NST * STAGE + HEADER);  // [MT][half][xr]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int K2 = a.K / 2, G2 = K2 / G;
  const int m0 = blockIdx.x * MT, nm = min(MT, a.M - m0);  // this block's rows of x
  const int rank = blockIdx.y, split = gridDim.y;
  const int col0 = blockIdx.z * BN;
  const int row0 = rank * a.xr;                          // the block's first packed row
  const int rows = max(0, min(a.xr, K2 - row0));         // and how many it walks (a multiple of 32)
  const int iters = (rows + SLAB - 1) / SLAB;

  // the TMA copies of slab `it` into its stage, started by thread 0; rows
  // past the planes arrive as zeros and belong to warps that skip the slab
  auto load = [&](int it) {
    const int st = it % NST;
    unsigned char* sp = smem + st * STAGE;
    const int r = row0 + it * SLAB, g = r / G;
    mbar_expect(&bars[st], SLAB * BN + (a.has_off ? 2 : 1) * PB);
    tma_load(sp, &maps.codes, &bars[st], col0, r);
    tma_load(sp + SLAB * BN, &maps.scales, &bars[st], col0, g);
    tma_load(sp + SLAB * BN + PB / 2, &maps.scales, &bars[st], col0, G2 + g);
    if (a.has_off) {
      tma_load(sp + SLAB * BN + PB, &maps.offsets, &bars[st], col0, g);
      tma_load(sp + SLAB * BN + PB + PB / 2, &maps.offsets, &bars[st], col0, G2 + g);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < NST; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int it = 0; it < min(NST, iters); ++it) load(it);
  }

  // x, 8 values a load: chunk i of this block's K range, both halves, of
  // its row mm of x
  const int chunks = rows / 8, nx = nm * 2 * chunks;
  auto x8 = [&](int i, int& mm) {
    mm = i / (2 * chunks);
    return __ldg(reinterpret_cast<const uint4*>(a.x + (size_t)(m0 + mm) * a.K + (i / chunks % 2) * K2 + row0 +
                                                8 * (i % chunks)));
  };
  // the amax of each row of x: over the block's range, then over the
  // cluster's ranks, whose ranges cover K, through distributed shared memory
  float amax[MT];
#pragma unroll
  for (int mm = 0; mm < MT; ++mm) amax[mm] = 0.f;
  for (int i0 = tid; i0 < nx; i0 += 4 * THREADS) {
    uint4 v[4];
    int mv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)  // four loads in flight
      if (i0 + u * THREADS < nx) v[u] = x8(i0 + u * THREADS, mv[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (i0 + u * THREADS >= nx) break;
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&v[u]);
      float m = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h2[e]);
        m = fmaxf(m, fmaxf(fabsf(f.x), fabsf(f.y)));
      }
#pragma unroll
      for (int r = 0; r < MT; ++r) amax[r] = fmaxf(amax[r], r == mv[u] ? m : 0.f);
    }
  }
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
  if (split > 1)
    cg::this_cluster().sync();  // every rank's amax is in its shared memory
  else
    __syncthreads();
  if (tid < MT) {
    float m = bmax[tid];
    if (split > 1)
      for (int r = 0; r < split; ++r) m = fmaxf(m, cg::this_cluster().map_shared_rank(bmax, r)[tid]);
    sx[tid] = m == 0.f ? 1.f : m / 127.f;
  }
  __syncthreads();
  // the block's x values as int8 (a second read, mostly from L1)
  for (int i = tid; i < nx; i += THREADS) {
    int mm;
    const uint4 v = x8(i, mm);
    const int c = i % chunks, half = i / chunks % 2;
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&v);
    const float s = sx[mm];
    uint32_t codes[2] = {0u, 0u};  // 8 int8 codes
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 f = __bfloat1622float2(h2[e]);
      const int q0 = (int)fminf(fmaxf(rintf(__fdiv_rn(f.x, s)), -127.f), 127.f);
      const int q1 = (int)fminf(fmaxf(rintf(__fdiv_rn(f.y, s)), -127.f), 127.f);
      codes[e / 2] |= ((uint32_t)(q0 & 0xff) | ((uint32_t)(q1 & 0xff) << 8)) << (16 * (e % 2));
    }
    *reinterpret_cast<uint2*>(xq + (size_t)(2 * mm + half) * a.xr + 8 * c) = make_uint2(codes[0], codes[1]);
  }
  __syncthreads();

  float acc[MT][4];
#pragma unroll
  for (int mm = 0; mm < MT; ++mm) acc[mm][0] = acc[mm][1] = acc[mm][2] = acc[mm][3] = 0.f;
  for (int it = 0; it < iters; ++it) {
    const int st = it % NST;
    mbar_wait(&bars[st], (it / NST) & 1);
    if (row0 + it * SLAB + warp * 32 < K2) {  // K2 % 32 == 0: a warp's rows are all inside or all past it
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
      const ST* sc = reinterpret_cast<const ST*>(sp + SLAB * BN);  // [half][R][BN]
      const ST* of = reinterpret_cast<const ST*>(sp + SLAB * BN + PB);
      const int8_t* xs = xq + it * SLAB + warp * 32;
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        const int gr = warp * NG + gi;  // the group's row in the slab's scale rows
        float sl[4], sh[4], ol[4] = {0.f, 0.f, 0.f, 0.f}, oh[4] = {0.f, 0.f, 0.f, 0.f};
        load4(sc + gr * BN + 4 * lane, sl);
        load4(sc + (R + gr) * BN + 4 * lane, sh);
        if (a.has_off) {
          load4(of + gr * BN + 4 * lane, ol);
          load4(of + (R + gr) * BN + 4 * lane, oh);
        }
#pragma unroll
        for (int mm = 0; mm < MT; ++mm) {
          if (mm >= nm) break;
          const int* x0 = reinterpret_cast<const int*>(xs + (size_t)(2 * mm) * a.xr + gi * G);
          const int* x1 = reinterpret_cast<const int*>(xs + (size_t)(2 * mm + 1) * a.xr + gi * G);
          int pl[4] = {0, 0, 0, 0}, ph[4] = {0, 0, 0, 0}, xsl = 0, xsh = 0;
#pragma unroll
          for (int qq = 0; qq < QG; ++qq) {
            const int q = gi * QG + qq, xa = x0[qq], xb = x1[qq];
            xsl = __dp4a(xa, 0x01010101, xsl);
            xsh = __dp4a(xb, 0x01010101, xsh);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              pl[j] = __dp4a((int)(cw[q][j] & 0x0F0F0F0Fu), xa, pl[j]);
              ph[j] = __dp4a((int)((cw[q][j] >> 4) & 0x0F0F0F0Fu), xb, ph[j]);
            }
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[mm][j] += (float)pl[j] * sl[j] + (float)xsl * ol[j];
            acc[mm][j] += (float)ph[j] * sh[j] + (float)xsh * oh[j];
          }
        }
      }
    }
    __syncthreads();  // every warp has read this stage
    if (tid == 0 && it + NST < iters) load(it + NST);
  }

  // the warps' sums in warp order; every copy has landed and been read, so
  // the stages hold them
  float* red = reinterpret_cast<float*>(smem);          // [warp][MT][BN], in stage 0
  float* part = reinterpret_cast<float*>(smem + STAGE);  // [MT][BN], in stage 1
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
      if (i / BN < nm) a.y[(size_t)(m0 + i / BN) * a.Npad + col0 + i % BN] = t * sx[i / BN];
    } else {
      part[i] = t;
    }
  }
  if (split == 1) return;
  // the cluster's K split: each rank adds a share of the outputs over the
  // ranks' sums, in rank order, and writes it
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int per = MT * BN / split;
  for (int i = rank * per + tid; i < (rank + 1) * per; i += THREADS) {
    float t = 0.f;
    for (int r = 0; r < split; ++r) t += cluster.map_shared_rank(part, r)[i];
    if (i / BN < nm) a.y[(size_t)(m0 + i / BN) * a.Npad + col0 + i % BN] = t * sx[i / BN];
  }
  cluster.sync();  // no block leaves while another reads its sums (or its amax)
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

template <int G, typename ST, int MT>
int launch(const GemvArgs& a, const GemvMaps& maps, dim3 grid, cudaStream_t stream) {
  const int smem = NST * stage_bytes<G, ST>() + HEADER + MT * 2 * a.xr;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const auto kernel = q4_gemv_sm90_kernel<G, ST, MT>;
  const cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc != cudaSuccess) return (int)rc;
  cudaLaunchAttribute cluster{};
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = grid.y;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = grid.y > 1 ? 1 : 0;  // a cluster only where K is split
  return (int)cudaLaunchKernelEx(&cfg, kernel, a, maps);
}

template <int G, typename ST>
int launch_mt(const GemvArgs& a, const GemvMaps& maps, dim3 grid, int mt, cudaStream_t stream) {
  switch (mt) {
    case 1: return launch<G, ST, 1>(a, maps, grid, stream);
    case 2: return launch<G, ST, 2>(a, maps, grid, stream);
    case 4: return launch<G, ST, 4>(a, maps, grid, stream);
    default: return launch<G, ST, 8>(a, maps, grid, stream);
  }
}

}  // namespace
}  // namespace ggml_tpu_torch

// x (M, K) bf16 -> y (M, Npad) f32, 1 <= M <= 32, G = 16 or 32, K/2 a
// multiple of 8 * G, Npad a multiple of 128.  scales (2, K/2/G, Npad) and
// offsets (K/G, Npad) are f32 (bf16 with st_bf16) planes; offsets may be
// null.  All contiguous and 16-byte aligned.
extern "C" int q4_gemv(const void* x, const void* codes, const void* scales, const void* offsets, int st_bf16,
                       void* y, int G, int M, int K, int Npad, void* stream) {
  using namespace ggml_tpu_torch;
  const int K2 = K / 2;
  if (M < 1 || M > MAX_M || (G != 16 && G != 32) || K < 2 || K % 2 || K2 % (8 * G) || Npad < BN || Npad % BN)
    return (int)cudaErrorInvalidValue;
  const int slabs = (K2 + SLAB - 1) / SLAB, strips = Npad / BN;
  const int mt = M <= 1 ? 1 : M <= 2 ? 2 : M <= 4 ? 4 : MAX_MT;
  const int mchunks = (M + mt - 1) / mt;
  // split K over a cluster until the blocks fill the SMs and a block's
  // quantized x takes at most 16 KB of shared memory
  int split = 1;
  while (split < MAX_SPLIT && 2 * split <= slabs &&
         (strips * mchunks * split < sm_count() || (slabs + split - 1) / split * mt > 32))
    split *= 2;
  const int per_block = (slabs + split - 1) / split;
  const GemvArgs a{static_cast<const __nv_bfloat16*>(x), static_cast<float*>(y), M, K, Npad, per_block * SLAB,
                   offsets != nullptr};
  const CUtensorMapDataType st = st_bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  const int es = st_bf16 ? 2 : 4;
  GemvMaps maps{};
  if (!make_map_2d(&maps.codes, codes, CU_TENSOR_MAP_DATA_TYPE_UINT8, K2, Npad, Npad, BN, SLAB,
                   CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map_2d(&maps.scales, scales, st, 2 * (K2 / G), Npad, (long long)Npad * es, BN, SLAB / G,
                   CU_TENSOR_MAP_SWIZZLE_NONE) ||
      (offsets != nullptr && !make_map_2d(&maps.offsets, offsets, st, 2 * (K2 / G), Npad, (long long)Npad * es, BN,
                                          SLAB / G, CU_TENSOR_MAP_SWIZZLE_NONE)))
    return (int)cudaErrorInvalidValue;  // no cuTensorMapEncodeTiled, or a layout TMA cannot describe
  const dim3 grid(mchunks, split, strips);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (G == 16)
    return st_bf16 ? launch_mt<16, __nv_bfloat16>(a, maps, grid, mt, s) : launch_mt<16, float>(a, maps, grid, mt, s);
  return st_bf16 ? launch_mt<32, __nv_bfloat16>(a, maps, grid, mt, s) : launch_mt<32, float>(a, maps, grid, mt, s);
}
