// Kernel C: the prefill matmul over packed-nibble planes, for M > 32 rows
// (and every M where the nibble GEMVs have no legal tile): compact Q4_K
// planes, or planes with multiplied-out scales and offsets (Q4_0, Q4_1,
// Q2_K, Q3_K, Q4_K at K % 512 != 0; f32 or bf16, groups of 16 or 32, offsets
// optional).
//
// Replaces (ggml_tpu/kernels/qmatmul.py) _q4_kernel (:79) / _q4_matmul (:94)
// together with the work the JAX wrapper does around it: the effective scale
// planes (_effective_planes, :1014) and the affine side product xsum @ eff_o
// (:1082-1084).  The pipeline, its bound and its design are in
// qmatmul_sm90.cuh; this file is its nibble policy: a code byte of row k2
// holds the weight of x column k2 (low nibble) and of column K/2 + k2 (high
// nibble), so a stage reads one code tile and two x boxes.  Compact planes:
// sub-scale codes (2, K/2/32, Npad) int8 times d (2, K/512, Npad), min codes
// (K/32, Npad) int8 times -dmin (natural superblock order).

#include "qmatmul_sm90.cuh"

namespace ggml_tpu_torch {
namespace {

template <bool COMPACT, typename ST, int G>
__global__ void __launch_bounds__(QM_THREADS, 1)
    q4k_matmul_kernel(const __grid_constant__ QmArgs a, const __grid_constant__ QmMaps maps) {
  qmm_body<true, COMPACT, ST, G>(a, maps);
}

template <bool COMPACT, typename ST, int G>
int launch(const QmPlanes& p, cudaStream_t s) {
  return qmm_launch<true, COMPACT, ST, G>(q4k_matmul_kernel<COMPACT, ST, G>, p, s);
}

}  // namespace
}  // namespace ggml_tpu_torch

// x (M, K) bf16 -> y (M, Npad) f32.  d != null: compact planes (sc/mc int8
// codes, d/dmin f32, or bf16 with d_bf16; G = 32; K % 512 == 0).  d == null:
// sc (2, K/2/G, Npad) and mc (K/G, Npad) or null are f32 (bf16 with d_bf16)
// planes, G = 16 or 32, K % 64 == 0.  Scratch from the caller: xs (M, 3 Gp)
// bf16 where there are offsets (Gp = K/G rounded up to 64), partial (split,
// M, Npad) f32 and counters (ceil(M / 128) Npad / 128 int32, zero) where
// split > 1.  All 16-byte aligned.
extern "C" int q4k_matmul(const void* x, const void* codes, const void* sc, const void* mc, const void* d,
                          const void* dmin, int d_bf16, int G, void* y, int M, int K, int Npad, void* xs,
                          void* partial, void* counters, int split, void* stream) {
  using namespace ggml_tpu_torch;
  const bool compact = d != nullptr;
  if (M < 1 || K < 64 || K % 64 || Npad < QM_BN || Npad % QM_BN || (G != 16 && G != 32) ||
      (compact && (K % 512 || G != 32 || mc == nullptr || dmin == nullptr)))
    return (int)cudaErrorInvalidValue;
  const QmPlanes p{x, codes, sc, mc, d, dmin, y, xs, partial, counters, M, K, Npad, 8, split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (compact) return d_bf16 ? launch<true, bf, 32>(p, s) : launch<true, float, 32>(p, s);
  if (G == 16) return d_bf16 ? launch<false, bf, 16>(p, s) : launch<false, float, 16>(p, s);
  return d_bf16 ? launch<false, bf, 32>(p, s) : launch<false, float, 32>(p, s);
}
