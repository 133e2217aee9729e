// Q4_K GEMV over compact packed-nibble planes, for 1 <= M <= 32 rows of x:
// codes (K/2, Npad) uint8 (low nibble k < K/2, high nibble k + K/2), int8
// sub-scale codes sc (2, K/64, Npad) plane-major, int8 min codes m (K/32,
// Npad) in logical-k group rows (the low half's group g at row g, the high
// half's at K/64 + g), d and dmin (2, K/512, Npad) f32 or bf16, one per
// superblock of 8 groups of 32.
//
// Replaces (ggml_tpu/kernels/qmatmul.py):
//   q4k_gemv_qact  <- _q4gemv_bd_sb_qact_kernel (:523), the M=1 decode GEMV
//                     (kernel A), with its in-kernel activation quantization:
//                     one int8 scale per K-tile per half-plane, tile =
//                     _sb_gemv_k_tile(K/2, 32, 8) (:578);
//   q4k_gemv_rows  <- _q4gemv_sb_kernel (:446) for 2 <= M <= 32 (kernel B),
//                     together with the per-row quantization before it (:856)
//                     and the * sx after it (:1054-1059);
//   q4k_gemv_i8    <- _q4gemv_bd_sb_kernel (:482), what _q4_gemv_sb (:588)
//                     runs at M=1 for x that is int8 already: no quantization
//                     and no activation scale, the caller multiplies by its
//                     own.  planar_matmul never reaches it (at M=1 it hands
//                     bf16 x to the first entry).
// All compute, per column n and half-plane h,
//   y = sum_segments sx * sum_g ( d*sc * sum_{k in g} xq_k q_kn  +  (-dmin*m) * sum_{k in g} xq_k )
// with exact int32 group dots and f32 everything else: the GEMV pipeline of
// gemv_sm90.cuh over its compact nibble layout, with the per-tile quantizer
// (TILES: amax * f32(1/127), as XLA compiles the TPU kernel's amax / 127),
// the per-row one (ROWS) or none.
//
// Bound on the H100: device-memory bytes.  The planes cost 0.578 B/weight at
// bf16 d/dmin (codes 0.5, sc and m 1/32 each, d and dmin 1/128 each), read
// once (attn_qkvup, K = 4096, N = 28672: 68 MB, 20.3 us at 3.35 TB/s).

#include "gemv_sm90.cuh"

namespace ggml_tpu_torch {
namespace {

constexpr int Q4K_SUPER = 256;  // packed rows of a Q4_K superblock: 8 groups of 32

template <int QUANT>
int q4k_run(const void* x, const void* codes, const void* sc, const void* mc, const void* d, const void* dmin,
            int d_bf16, void* y, int M, int K, int Npad, int kt2, void* stream) {
  using namespace gemv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d_bf16)
    return run<Planes<true, true, 32, __nv_bfloat16>, QUANT>(x, codes, sc, mc, d, dmin, y, M, K, Npad, kt2,
                                                            Q4K_SUPER, s);
  return run<Planes<true, true, 32, float>, QUANT>(x, codes, sc, mc, d, dmin, y, M, K, Npad, kt2, Q4K_SUPER, s);
}

}  // namespace
}  // namespace ggml_tpu_torch

// x (1, K) bf16 -> y (1, Npad) f32, K a multiple of 512, kt2 the tile of
// packed rows (a multiple of 256 that divides K/2), Npad a multiple of 128.
extern "C" int q4k_gemv_qact(const void* x, const void* codes, const void* sc, const void* mc, const void* d,
                             const void* dmin, int d_bf16, void* y, int K, int Npad, int kt2, void* stream) {
  using namespace ggml_tpu_torch;
  return q4k_run<gemv::TILES>(x, codes, sc, mc, d, dmin, d_bf16, y, 1, K, Npad, kt2, stream);
}

// x (M, K) bf16 -> y (M, Npad) f32, 1 <= M <= 32.
extern "C" int q4k_gemv_rows(const void* x, const void* codes, const void* sc, const void* mc, const void* d,
                             const void* dmin, int d_bf16, void* y, int M, int K, int Npad, void* stream) {
  using namespace ggml_tpu_torch;
  return q4k_run<gemv::ROWS>(x, codes, sc, mc, d, dmin, d_bf16, y, M, K, Npad, 0, stream);
}

// x (1, K) int8 -> y (1, Npad) f32, the un-scaled sum.
extern "C" int q4k_gemv_i8(const void* xq, const void* codes, const void* sc, const void* mc, const void* d,
                           const void* dmin, int d_bf16, void* y, int K, int Npad, void* stream) {
  using namespace ggml_tpu_torch;
  return q4k_run<gemv::NONE>(xq, codes, sc, mc, d, dmin, d_bf16, y, 1, K, Npad, 0, stream);
}
