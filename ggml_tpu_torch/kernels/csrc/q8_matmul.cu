// Kernel G: the prefill matmul over int8 planes (codes (K, Npad) int8, N
// last): every M above 32, and every M at shapes the int8 GEMV does not take.
//
// Replaces (ggml_tpu/kernels/qmatmul.py) _q8_kernel (:133) / _q8_matmul
// (:142) together with the work the JAX wrapper does around it: the effective
// scale planes of compact weights (_effective_planes, :1014) and the affine
// side product xsum @ eff_o (:1082-1084).  The pipeline, its bound and its
// design are in qmatmul_sm90.cuh; this file is its int8 policy: one code a
// weight, 128 code rows a stage in two sub-tiles of 64.  Multiplied-out
// planes come in groups of 8 (IQ1_M, with offsets), 16, 32 and 256 (TQ1_0,
// TQ2_0; K a multiple of 256).  Compact planes (groups of 16 and 32):
// sub-scale codes (K/G, Npad) int8 times d (K/G/sb, Npad), min codes (K/G,
// Npad) int8 times -dmin.

#include "qmatmul_sm90.cuh"

namespace ggml_tpu_torch {
namespace {

template <bool COMPACT, typename ST, int G>
__global__ void __launch_bounds__(QM_THREADS, 1)
    q8_matmul_kernel(const __grid_constant__ QmArgs a, const __grid_constant__ QmMaps maps) {
  qmm_body<false, COMPACT, ST, G>(a, maps);
}

template <bool COMPACT, typename ST, int G>
int launch(const QmPlanes& p, cudaStream_t s) {
  return qmm_launch<false, COMPACT, ST, G>(q8_matmul_kernel<COMPACT, ST, G>, p, s);
}

template <bool COMPACT, typename ST>
int launch_g(int G, const QmPlanes& p, cudaStream_t s) {
  if constexpr (!COMPACT) {
    if (G == 8) return launch<false, ST, 8>(p, s);
    if (G == 256) return launch<false, ST, 256>(p, s);
  }
  return G == 16 ? launch<COMPACT, ST, 16>(p, s) : launch<COMPACT, ST, 32>(p, s);
}

}  // namespace
}  // namespace ggml_tpu_torch

// x (M, K) bf16 -> y (M, Npad) f32, K a multiple of 32 and of G: G = 16 or
// 32, and for multiplied-out planes also 8 or 256.  Planes
// as for q8_gemv: d == null means f32 (bf16 with st_bf16) scale/offset planes,
// else int8 code planes with f32 (bf16) d/dmin per sb groups; offsets (with
// dmin) may be null.  Scratch as for q4k_matmul.
extern "C" int q8_matmul(const void* x, const void* codes, const void* scales, const void* offsets, const void* d,
                         const void* dmin, int st_bf16, int G, int sb, void* y, int M, int K, int Npad, void* xs,
                         void* partial, void* counters, int split, void* stream) {
  using namespace ggml_tpu_torch;
  const bool compact = d != nullptr;
  const bool group_ok = G == 16 || G == 32 || (!compact && (G == 8 || G == 256));
  if (M < 1 || !group_ok || K < 32 || K % 32 || K % G || Npad < QM_BN || Npad % QM_BN ||
      (compact && (sb < 1 || K % (G * sb))) || (compact && (offsets != nullptr) != (dmin != nullptr)))
    return (int)cudaErrorInvalidValue;
  const QmPlanes p{x, codes, scales, offsets, d, dmin, y, xs, partial, counters, M, K, Npad, sb, split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf = __nv_bfloat16;
  if (compact) return st_bf16 ? launch_g<true, bf>(G, p, s) : launch_g<true, float>(G, p, s);
  return st_bf16 ? launch_g<false, bf>(G, p, s) : launch_g<false, float>(G, p, s);
}
