// int8 GEMV over q8 planes (codes (K, Npad) int8, N last), for 1 <= M <= 32
// rows of x, with their per-row int8 quantization folded in.
//
// Replaces (ggml_tpu/kernels/qmatmul.py), one entry for all six Pallas
// bodies, each with the per-row activation quantization before it (:856) and
// the * sx after it (:1060-1073):
//   q8_gemv over multiplied-out planes (kernel E)
//     <- _q8gemv_kernel (:189) and _q8gemv_off_kernel (:209): one f32 or bf16
//        scale (and offset) per group of G = 16 or 32 codes;
//   q8_gemv over COMPACT planes (kernel F)
//     <- _q8gemv_sb_kernel (:645), _q8gemv_bd_sb_kernel (:665),
//        _q8gemv_sb_off_kernel (:685), _q8gemv_bd_sb_off_kernel (:708): int8
//        sub-scale (and min) codes per group, d (and dmin) per superblock of
//        sb groups, s = d * sc and o = -dmin * m rebuilt in f32 here.  The
//        block-diagonal bodies only fill the TPU's matrix unit at M = 1;
//        they compute the loop bodies' sum, so one kernel serves both.
// All compute, per row m and column n,
//   y = sx_m * sum_g ( s_g * sum_{k in g} xq_k q_kn  +  o_g * sum_{k in g} xq_k )
// with exact int32 group dots, the int8 activations in the offset term too,
// and f32 everything else: the GEMV pipeline of gemv_sm90.cuh over its int8
// layouts with the per-row quantizer (ROWS).
//
// Bound on the H100: device-memory bytes.  The planes cost 1 B/weight of
// codes plus 2/G (bf16) to 8/G (f32 scale and offset) B/weight of group
// planes, or for compact planes 1/G (Q6_K) to 2/G (Q5_K) of sub-scale and min
// codes and 4/(G sb) of d (and dmin), read once (attn_qkvup over compact
// Q6_K: 126.6 MB, 37.8 us at 3.35 TB/s).

#include "gemv_sm90.cuh"

// x (M, K) bf16 -> y (M, Npad) f32, 1 <= M <= 32, G = 16 or 32, K a multiple
// of 8 * G, Npad a multiple of 128.  d == null: scales/offsets are f32 (bf16
// with st_bf16) planes (K/G, Npad); else they are int8 code planes and d/dmin
// f32 (bf16) planes (K/(G*sb), Npad), G * sb a multiple of 256.  offsets
// (with dmin) may be null.  All contiguous and 16-byte aligned.
extern "C" int q8_gemv(const void* x, const void* codes, const void* scales, const void* offsets, const void* d,
                       const void* dmin, int st_bf16, void* y, int G, int sb, int M, int K, int Npad, void* stream) {
  using namespace ggml_tpu_torch::gemv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool compact = d != nullptr;
#define GGML_Q8(C_, G_, ST_) \
  run<Planes<false, C_, G_, ST_>, ROWS>(x, codes, scales, offsets, d, dmin, y, M, K, Npad, 0, G * sb, s)
#define GGML_Q8_G(G_)                                                                         \
  if (compact) return st_bf16 ? GGML_Q8(true, G_, __nv_bfloat16) : GGML_Q8(true, G_, float); \
  return st_bf16 ? GGML_Q8(false, G_, __nv_bfloat16) : GGML_Q8(false, G_, float);
  if (G == 16) { GGML_Q8_G(16) }
  if (G == 32) { GGML_Q8_G(32) }
#undef GGML_Q8_G
#undef GGML_Q8
  return (int)cudaErrorInvalidValue;
}
