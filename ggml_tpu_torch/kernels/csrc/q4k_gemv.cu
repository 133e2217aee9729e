// Q4_K GEMV over compact packed-nibble planes, for 1 <= M <= 32 rows of x.
//
// Replaces (ggml_tpu/kernels/qmatmul.py):
//   q4k_gemv_qact  <- _q4gemv_bd_sb_qact_kernel (:523), the M=1 decode GEMV,
//                     with its in-kernel activation quantization: one int8
//                     scale per K-tile per half-plane, tile =
//                     _sb_gemv_k_tile(K/2, 32, 8) (:578);
//   q4k_gemv_rows  <- _q4gemv_sb_kernel (:446) for 2 <= M <= 32, together
//                     with the per-row quantization before it (:856) and the
//                     * sx after it (:1054-1059);
//   q4k_gemv_i8    <- _q4gemv_bd_sb_kernel (:482), what _q4_gemv_sb (:588)
//                     runs at M=1 for x that is int8 already: no quantization
//                     and no activation scale, the caller multiplies by its
//                     own.  planar_matmul never reaches it (at M=1 it hands
//                     bf16 x to the first entry).
// Both compute, per column n and half-plane h,
//   y = sum_g sx * ( d*sc * sum_{k in g} xq_k q_kn  +  (-dmin*m) * sum_{k in g} xq_k )
// with exact int32 group dots and f32 everything else.
//
// Bound on the H100: device-memory bytes.  The planes cost 0.578 B/weight at
// bf16 d/dmin (codes 0.5, sc and m 1/32 each, d and dmin 1/128 each), read
// once; x and y are noise.  At 1 <= M <= 32 the integer work (2*M*K*N int8
// ops) is far below the 1979 TOP/s int8 rate.
//
// Design: a block owns 128 columns x 256 packed rows (= 8 groups of 32, one
// group per warp; each lane owns 4 adjacent columns, so a warp's code load is
// one 128-byte row segment and the sc/m/d/dmin loads are single aligned
// words).  A warp loads its 32 code rows up front (32 independent loads in
// flight per thread), transposes each 4-row x 4-column byte square with
// __byte_perm so each register holds 4 K-consecutive codes of one column,
// and runs __dp4a against the int8 activations staged in shared memory.
// K is split across blocks (gridDim.y = K/512) so even N=4096 launches
// 256-1024 blocks; the split partial sums go to a scratch buffer and the last
// block of each column strip (counted with an atomic ticket) adds them in a
// fixed order: one launch, deterministic result, no atomics on the output.
// Activation quantization (amax, rint-to-even, clip +-127; quant_segments in
// common.cuh) runs in a small kernel before the GEMV, one block per scale
// segment; it also zeroes the tickets, so every launch brings its own scratch
// and counters and no launch depends on what an earlier one left behind.

#include "common.cuh"

namespace ggml_tpu_torch {
namespace {

constexpr int BN = 128;      // columns per block: 32 lanes x 4 columns
constexpr int ROWS = 256;    // packed rows per block: 8 warps x one 32-row group
constexpr int THREADS = QUANT_THREADS;
constexpr int MAX_M = 32;
constexpr int MC = 4;        // rows of x reduced per shared-memory pass

// QACT: M == 1 and sx holds one scale per (half, K-tile): [lo tiles, hi tiles].
// !QACT: sx holds one scale per row, applied to the finished sum; null: the
// activations came quantized and the sum goes out un-scaled.
template <typename DT, bool QACT>
__global__ void __launch_bounds__(THREADS)
q4k_gemv_kernel(const uint8_t* __restrict__ codes, const int8_t* __restrict__ sc,
                const int8_t* __restrict__ mc, const DT* __restrict__ d,
                const DT* __restrict__ dmin, const int8_t* __restrict__ xq,
                const float* __restrict__ sx, float* __restrict__ partial,
                unsigned* __restrict__ tickets, float* __restrict__ y,
                int M, int K, int Npad, int kt2) {
  const int K2 = K / 2;
  const int G2 = K2 / 32;    // groups per half-plane
  const int SB2 = K2 / 256;  // superblocks per half-plane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col0 = blockIdx.x * BN;
  const int n = col0 + 4 * lane;           // this lane's first column
  const int r0 = blockIdx.y * ROWS;        // block's first packed row
  const int g = (r0 >> 5) + warp;          // warp's group in each half-plane
  const int c0 = g * 32;                   // warp's first packed row

  __shared__ __align__(16) int8_t xs[2][MAX_M][ROWS];
  __shared__ __align__(16) float red[THREADS / 32][MC][BN];
  __shared__ bool is_last;

  // int8 activations of this block's rows, both halves
  for (int i = threadIdx.x; i < M * (ROWS / 4); i += THREADS) {
    const int m = i / (ROWS / 4), w = i % (ROWS / 4);
    const int* src = reinterpret_cast<const int*>(xq + (size_t)m * K);
    reinterpret_cast<int*>(xs[0][m])[w] = src[(r0 >> 2) + w];
    reinterpret_cast<int*>(xs[1][m])[w] = src[((K2 + r0) >> 2) + w];
  }

  uint32_t wq[32];
  const uint8_t* cp = codes + (size_t)c0 * Npad + n;
#pragma unroll
  for (int r = 0; r < 32; ++r)
    wq[r] = __ldg(reinterpret_cast<const uint32_t*>(cp + (size_t)r * Npad));

  // effective group scale (d*sc) and offset (-dmin*m) of both halves
  float sl[4], sh[4], ol[4], oh[4];
  {
    float dl[4], dh[4], ml[4], mh[4], scl[4], sch[4], mcl[4], mch[4];
    load4(d + (size_t)(g >> 3) * Npad + n, dl);
    load4(d + (size_t)(SB2 + (g >> 3)) * Npad + n, dh);
    load4(dmin + (size_t)(g >> 3) * Npad + n, ml);
    load4(dmin + (size_t)(SB2 + (g >> 3)) * Npad + n, mh);
    load4(sc + (size_t)g * Npad + n, scl);         // sc[0][g]
    load4(sc + (size_t)(G2 + g) * Npad + n, sch);  // sc[1][g]
    load4(mc + (size_t)g * Npad + n, mcl);         // m natural row g
    load4(mc + (size_t)(G2 + g) * Npad + n, mch);  // m natural row K/64 + g
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sl[j] = dl[j] * scl[j];
      sh[j] = dh[j] * sch[j];
      ol[j] = -ml[j] * mcl[j];
      oh[j] = -mh[j] * mch[j];
    }
  }
  float sx_lo = 1.f, sx_hi = 1.f;
  if (QACT) {
    sx_lo = sx[c0 / kt2];
    sx_hi = sx[K2 / kt2 + c0 / kt2];
  }
  __syncthreads();  // xs staged

  for (int mb = 0; mb < M; mb += MC) {
#pragma unroll
    for (int mm = 0; mm < MC; ++mm) {
      const int m = mb + mm;
      float res[4] = {0.f, 0.f, 0.f, 0.f};
      if (m < M) {
        int pl[4] = {0, 0, 0, 0}, ph[4] = {0, 0, 0, 0}, xsl = 0, xsh = 0;
        const int* xw0 = reinterpret_cast<const int*>(&xs[0][m][warp * 32]);
        const int* xw1 = reinterpret_cast<const int*>(&xs[1][m][warp * 32]);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int a = xw0[q], b = xw1[q];
          xsl = __dp4a(a, 0x01010101, xsl);
          xsh = __dp4a(b, 0x01010101, xsh);
          // 4 rows x 4 columns of bytes -> one word of 4 rows per column
          const uint32_t t01l = __byte_perm(wq[4 * q], wq[4 * q + 1], 0x5140);
          const uint32_t t01h = __byte_perm(wq[4 * q], wq[4 * q + 1], 0x7362);
          const uint32_t t23l = __byte_perm(wq[4 * q + 2], wq[4 * q + 3], 0x5140);
          const uint32_t t23h = __byte_perm(wq[4 * q + 2], wq[4 * q + 3], 0x7362);
          const uint32_t col[4] = {__byte_perm(t01l, t23l, 0x5410), __byte_perm(t01l, t23l, 0x7632),
                                   __byte_perm(t01h, t23h, 0x5410), __byte_perm(t01h, t23h, 0x7632)};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            pl[j] = __dp4a((int)(col[j] & 0x0F0F0F0Fu), a, pl[j]);
            ph[j] = __dp4a((int)((col[j] >> 4) & 0x0F0F0F0Fu), b, ph[j]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float lo = (float)pl[j] * sl[j] + (float)xsl * ol[j];
          const float hi = (float)ph[j] * sh[j] + (float)xsh * oh[j];
          res[j] = QACT ? lo * sx_lo + hi * sx_hi : lo + hi;
        }
      }
      *reinterpret_cast<float4*>(&red[warp][mm][4 * lane]) = make_float4(res[0], res[1], res[2], res[3]);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < MC * BN; i += THREADS) {
      const int mm = i / BN, c = i % BN, m = mb + mm;
      if (m < M) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < THREADS / 32; ++w) s += red[w][mm][c];
        partial[((size_t)blockIdx.y * M + m) * Npad + col0 + c] = s;
      }
    }
    __syncthreads();
  }

  // the last block of this column strip adds the K-split partials in order
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(&tickets[blockIdx.x], 1u) == gridDim.y - 1;
  __syncthreads();
  if (!is_last) return;
  for (int i = threadIdx.x; i < M * BN; i += THREADS) {
    const int m = i / BN, c = col0 + i % BN;
    float s = 0.f;
    for (int rb = 0; rb < (int)gridDim.y; ++rb) s += __ldcg(&partial[((size_t)rb * M + m) * Npad + c]);
    y[(size_t)m * Npad + c] = (QACT || sx == nullptr) ? s : s * sx[m];
  }
}

// xq == null: x is int8 already (sx is then null too) and the tickets are
// zeroed with a memset; else x is bf16 and quant_segments fills xq and sx.
template <bool QACT>
int launch(const void* x, const void* codes, const void* sc, const void* mc, const void* d,
           const void* dmin, int d_bf16, void* xq, void* sx, void* partial, void* tickets,
           void* y, int M, int K, int Npad, int kt2, cudaStream_t stream) {
  if (M < 1 || M > MAX_M || K % 512 || Npad % BN || (QACT && (M != 1 || kt2 % ROWS || (K / 2) % kt2)))
    return (int)cudaErrorInvalidValue;
  if (xq == nullptr) {
    const cudaError_t rc = cudaMemsetAsync(tickets, 0, sizeof(unsigned) * (Npad / BN), stream);
    if (rc != cudaSuccess) return (int)rc;
    xq = const_cast<void*>(x);
  } else {
    const int n_seg = QACT ? K / kt2 : M;
    quant_segments<QACT><<<n_seg, THREADS, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<int8_t*>(xq), static_cast<float*>(sx),
        QACT ? kt2 : K, static_cast<unsigned*>(tickets), Npad / BN);
  }
  const dim3 grid(Npad / BN, (K / 2) / ROWS);
  if (d_bf16)
    q4k_gemv_kernel<__nv_bfloat16, QACT><<<grid, THREADS, 0, stream>>>(
        static_cast<const uint8_t*>(codes), static_cast<const int8_t*>(sc),
        static_cast<const int8_t*>(mc), static_cast<const __nv_bfloat16*>(d),
        static_cast<const __nv_bfloat16*>(dmin), static_cast<const int8_t*>(xq),
        static_cast<const float*>(sx), static_cast<float*>(partial),
        static_cast<unsigned*>(tickets), static_cast<float*>(y), M, K, Npad, kt2);
  else
    q4k_gemv_kernel<float, QACT><<<grid, THREADS, 0, stream>>>(
        static_cast<const uint8_t*>(codes), static_cast<const int8_t*>(sc),
        static_cast<const int8_t*>(mc), static_cast<const float*>(d),
        static_cast<const float*>(dmin), static_cast<const int8_t*>(xq),
        static_cast<const float*>(sx), static_cast<float*>(partial),
        static_cast<unsigned*>(tickets), static_cast<float*>(y), M, K, Npad, kt2);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace ggml_tpu_torch

// x (1, K) bf16 -> y (1, Npad) f32.  Scratch: xq (1, K) int8, sx (K/kt2) f32,
// partial (K/512, 1, Npad) f32, tickets (Npad/128) uint32 (zeroed here).
extern "C" int q4k_gemv_qact(const void* x, const void* codes, const void* sc, const void* mc,
                             const void* d, const void* dmin, int d_bf16, void* xq, void* sx,
                             void* partial, void* tickets, void* y, int K, int Npad, int kt2,
                             void* stream) {
  return ggml_tpu_torch::launch<true>(x, codes, sc, mc, d, dmin, d_bf16, xq, sx, partial, tickets,
                                      y, 1, K, Npad, kt2, static_cast<cudaStream_t>(stream));
}

// x (M, K) bf16 -> y (M, Npad) f32, 1 <= M <= 32.  Scratch as above with
// xq (M, K), sx (M) and partial (K/512, M, Npad).
extern "C" int q4k_gemv_rows(const void* x, const void* codes, const void* sc, const void* mc,
                             const void* d, const void* dmin, int d_bf16, void* xq, void* sx,
                             void* partial, void* tickets, void* y, int M, int K, int Npad,
                             void* stream) {
  return ggml_tpu_torch::launch<false>(x, codes, sc, mc, d, dmin, d_bf16, xq, sx, partial, tickets,
                                       y, M, K, Npad, 0, static_cast<cudaStream_t>(stream));
}

// x (1, K) int8 -> y (1, Npad) f32, the un-scaled sum.  Scratch: partial
// (K/512, 1, Npad) f32, tickets (Npad/128) uint32 (zeroed here).
extern "C" int q4k_gemv_i8(const void* xq, const void* codes, const void* sc, const void* mc,
                           const void* d, const void* dmin, int d_bf16, void* partial,
                           void* tickets, void* y, int K, int Npad, void* stream) {
  return ggml_tpu_torch::launch<false>(xq, codes, sc, mc, d, dmin, d_bf16, nullptr, nullptr, partial,
                                       tickets, y, 1, K, Npad, 0, static_cast<cudaStream_t>(stream));
}
