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
// with exact int32 group dots and the per-row quantizer (ROWS): the GEMV
// pipeline of gemv_sm90.cuh over its multiplied-out nibble layout.  The low
// half reads scale rows [0, K/2/G) of plane 0 and offset rows [0, K/2/G);
// the high half plane 1 and offset rows [K/2/G, K/G).
//
// Bound on the H100: device-memory bytes, 0.5 B/weight of codes plus 2/G
// (bf16 scale) to 8/G (f32 scale and offset) B/weight of group planes
// (GPT-J's attn_qkvup, K = 4096, N = 28672, bf16 scales and offsets per 32:
// 73.4 MB, 21.9 us at 3.35 TB/s).

#include "gemv_sm90.cuh"

// x (M, K) bf16 -> y (M, Npad) f32, 1 <= M <= 32, G = 16 or 32, K/2 a
// multiple of 8 * G, Npad a multiple of 128.  scales (2, K/2/G, Npad) and
// offsets (K/G, Npad) are f32 (bf16 with st_bf16) planes; offsets may be
// null.  All contiguous and 16-byte aligned.
extern "C" int q4_gemv(const void* x, const void* codes, const void* scales, const void* offsets, int st_bf16,
                       void* y, int G, int M, int K, int Npad, void* stream) {
  using namespace ggml_tpu_torch::gemv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define GGML_H(G_, ST_) run<Planes<true, false, G_, ST_>, ROWS>(x, codes, scales, offsets, nullptr, nullptr, y, M, K, Npad, 0, 0, s)
  if (G == 16) return st_bf16 ? GGML_H(16, __nv_bfloat16) : GGML_H(16, float);
  if (G == 32) return st_bf16 ? GGML_H(32, __nv_bfloat16) : GGML_H(32, float);
#undef GGML_H
  return (int)cudaErrorInvalidValue;
}
