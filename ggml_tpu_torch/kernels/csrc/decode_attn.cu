// Single-token decode attention over a bf16 KV cache.
//
// Replaces ggml_tpu/kernels/decode_attn.py _kernel (:37), the body of
// fused_decode_attention (:76).  For one new query token at position pos:
//   s_j = scale * q . k_j   for j <= pos, with row pos taken from k_new
//   out = softmax(s) @ v    with row pos taken from v_new
// over the cache as it was BEFORE this step's row write (the caller writes
// the row in place outside, as the JAX package does).  Dots, softmax and the
// output are f32.  GQA: query head h reads KV head h / (hq / hkv).  Keys past
// pos are skipped: they would contribute exactly 0 after the -inf mask.
// pos is read from device memory by the kernel itself, so a launch needs no
// host value and the decode loop can later be captured in a CUDA graph.
//
// Bound on the H100: bytes, 2*hkv*(pos+1)*d*2 of cache window (about 4.2 MB
// for GPT-J-6B at pos=255, 1.3 us at 3.35 TB/s).  At that size the kernel is
// bound by latency, not bandwidth: one block per query head (16 for GPT-J)
// leaves most of the 132 SMs idle, and each warp walks its share of the keys
// in order.  Splitting the key range across blocks (flash-decoding) is later
// work.
//
// Design: 256 threads (8 warps) per query head.  Each lane keeps its slice
// of q in registers (D/64 bf16 pairs).  Scores: each warp takes 4 keys at a
// time, loads all four rows before reducing, and writes scale*q.k to shared
// memory.  The block reduces max and sum for the softmax and normalises the
// probabilities in shared memory.  Values: each warp accumulates p_j * v_j
// over its own keys (4 rows in flight) into per-lane registers, and the 8
// partial rows are added through shared memory.  A first version walked the
// value rows serially in every thread and took 102 us at pos=255 (PERF.md).

#include "common.cuh"

namespace ggml_tpu_torch {
namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KEYS = 4;  // rows each warp has in flight

// DP: bf16 pairs of the head per lane, D = 64 * DP.
template <int DP>
__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ k_new,
                   const __nv_bfloat16* __restrict__ v_new, const __nv_bfloat16* __restrict__ kc,
                   const __nv_bfloat16* __restrict__ vc, const int* __restrict__ pos_ptr,
                   float* __restrict__ out, int rep, int S, float scale) {
  constexpr int D = 64 * DP;
  extern __shared__ float smem[];  // partial outputs (WARPS x D), then probabilities (S)
  __shared__ float scratch[32];
  float* red = smem;
  float* p = smem + WARPS * D;
  const int h = blockIdx.x, kvh = h / rep;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pos = *pos_ptr;
  const int n_keys = min(pos + 1, S);  // a position past the window sees all S rows
  const __nv_bfloat162* kbase = reinterpret_cast<const __nv_bfloat162*>(kc + (size_t)kvh * S * D);
  const __nv_bfloat162* vbase = reinterpret_cast<const __nv_bfloat162*>(vc + (size_t)kvh * S * D);
  const __nv_bfloat162* kn = reinterpret_cast<const __nv_bfloat162*>(k_new + (size_t)kvh * D);
  const __nv_bfloat162* vn = reinterpret_cast<const __nv_bfloat162*>(v_new + (size_t)kvh * D);
  auto row = [&](const __nv_bfloat162* base, const __nv_bfloat162* fresh, int j) {
    return j == pos ? fresh : base + (size_t)j * (D / 2);
  };

  float2 qv[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i)
    qv[i] = reinterpret_cast<const float2*>(q + (size_t)h * D)[lane + 32 * i];

  for (int j0 = warp * KEYS; j0 < n_keys; j0 += WARPS * KEYS) {
    float s[KEYS];
#pragma unroll
    for (int u = 0; u < KEYS; ++u) {
      s[u] = 0.f;
      if (j0 + u < n_keys) {
        const __nv_bfloat162* kr = row(kbase, kn, j0 + u);
#pragma unroll
        for (int i = 0; i < DP; ++i) {
          const float2 kv = __bfloat1622float2(kr[lane + 32 * i]);
          s[u] += qv[i].x * kv.x + qv[i].y * kv.y;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < KEYS; ++u) {
      const float t = warp_sum(s[u]);
      if (lane == 0 && j0 + u < n_keys) p[j0 + u] = t * scale;
    }
  }
  __syncthreads();

  float mx = __int_as_float(0xff800000);
  for (int j = threadIdx.x; j < n_keys; j += THREADS) mx = fmaxf(mx, p[j]);
  mx = block_reduce<true>(mx, scratch);
  float sum = 0.f;
  for (int j = threadIdx.x; j < n_keys; j += THREADS) {
    const float ev = expf(p[j] - mx);
    p[j] = ev;
    sum += ev;
  }
  sum = block_reduce<false>(sum, scratch);
  for (int j = threadIdx.x; j < n_keys; j += THREADS) p[j] = p[j] / sum;
  __syncthreads();

  float2 acc[DP];
#pragma unroll
  for (int i = 0; i < DP; ++i) acc[i] = make_float2(0.f, 0.f);
  for (int j0 = warp * KEYS; j0 < n_keys; j0 += WARPS * KEYS) {
#pragma unroll
    for (int u = 0; u < KEYS; ++u) {
      if (j0 + u < n_keys) {
        const __nv_bfloat162* vr = row(vbase, vn, j0 + u);
        const float pj = p[j0 + u];
#pragma unroll
        for (int i = 0; i < DP; ++i) {
          const float2 vv = __bfloat1622float2(vr[lane + 32 * i]);
          acc[i].x += pj * vv.x;
          acc[i].y += pj * vv.y;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < DP; ++i)
    reinterpret_cast<float2*>(red + warp * D)[lane + 32 * i] = acc[i];
  __syncthreads();
  for (int e = threadIdx.x; e < D; e += THREADS) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) o += red[w * D + e];
    out[(size_t)h * D + e] = o;
  }
}

}  // namespace
}  // namespace ggml_tpu_torch

// q (hq, D) f32; k_new/v_new (hkv, D) bf16; kc/vc (hkv, S, D) bf16;
// pos: one int32 in device memory -> out (hq, D) f32.  D in {64, 128, 256, 512}.
extern "C" int decode_attn(const void* q, const void* k_new, const void* v_new, const void* kc,
                           const void* vc, const void* pos, void* out, int hq, int hkv, int S,
                           int D, float scale, void* stream) {
  using namespace ggml_tpu_torch;
  const size_t smem = (size_t)(WARPS * D + S) * sizeof(float);
  if (hq < 1 || hkv < 1 || hq % hkv || S < 1 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const float*>(q);
  const auto* knp = static_cast<const __nv_bfloat16*>(k_new);
  const auto* vnp = static_cast<const __nv_bfloat16*>(v_new);
  const auto* kcp = static_cast<const __nv_bfloat16*>(kc);
  const auto* vcp = static_cast<const __nv_bfloat16*>(vc);
  const auto* pp = static_cast<const int*>(pos);
  auto* op = static_cast<float*>(out);
  const int rep = hq / hkv;
  switch (D) {
    case 64: decode_attn_kernel<1><<<hq, THREADS, smem, st>>>(qp, knp, vnp, kcp, vcp, pp, op, rep, S, scale); break;
    case 128: decode_attn_kernel<2><<<hq, THREADS, smem, st>>>(qp, knp, vnp, kcp, vcp, pp, op, rep, S, scale); break;
    case 256: decode_attn_kernel<4><<<hq, THREADS, smem, st>>>(qp, knp, vnp, kcp, vcp, pp, op, rep, S, scale); break;
    case 512: decode_attn_kernel<8><<<hq, THREADS, smem, st>>>(qp, knp, vnp, kcp, vcp, pp, op, rep, S, scale); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
