// Single-token decode attention over a bf16 KV cache, split over the keys
// (flash-decoding).
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
// Bound on the H100: bytes, 2*hkv*(pos+1)*d*2 of cache window (33.5 MB for
// GPT-J-6B at pos=2047, 10 us at 3.35 TB/s).
//
// Design: one launch.  The grid is (key chunk of CHUNK = 64 rows, kv head x
// head group), sized by the window S, not by pos: a block whose chunk starts
// past pos exits at once.  A block takes all query heads of its kv head (up
// to HB of them; more heads make more groups), so each K/V byte is read once
// per group.  Scores: a row of d bf16 is read as 16-byte loads by d/8 lanes
// (several rows per warp where d < 256), every load of the warp's 16 rows
// in flight before the dots; a lane keeps its q slices of every head in
// registers.  The chunk's value rows load into shared memory by cp.async
// meanwhile.  The chunk's softmax (max m_c, sum l_c) and its p . v (a thread
// per 8 output columns and a group of rows, the row groups summed in shared
// memory) give the partial (m_c, l_c, o_c) in f32, written
// to a scratch the wrapper allocates.  The last block to finish for a kv head
// (an arrival counter, reset by that block) merges the live chunks:
//   out = sum_c e^(m_c - M) o_c / sum_c e^(m_c - M) l_c,   M = max_c m_c,
// with a thread per chunk for M and the weights, a thread per output column
// for the sums.
// No shared-memory vector of the window: S is bounded by the grid only.

#include "common.cuh"

namespace ggml_tpu_torch {
namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 64;               // keys per block
constexpr int KEYS_PER_WARP = CHUNK / WARPS;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"((uint32_t)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void bf16x8_to_float(const uint4& u, float f[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

// D: head dim; HB: query heads a block takes (all rep heads of its kv head, or
// a group of HB of them).  part: per (unit, chunk) HB x D outputs, then HB
// (m, l) pairs.
template <int D, int HB>
__global__ void __launch_bounds__(THREADS)
decode_attn_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ k_new,
                   const __nv_bfloat16* __restrict__ v_new, const __nv_bfloat16* __restrict__ kc,
                   const __nv_bfloat16* __restrict__ vc, const int* __restrict__ pos_ptr,
                   float* __restrict__ out, float* __restrict__ part, int* __restrict__ counters,
                   int rep, int groups, int S, float scale) {
  constexpr int CH = D / 8;                   // 16-byte chunks per row
  constexpr int LPR = CH < 32 ? CH : 32;      // lanes per row
  constexpr int CPL = CH / LPR;               // chunks per lane
  constexpr int RPW = 32 / LPR;               // rows per warp step
  constexpr int STEPS = KEYS_PER_WARP / RPW;  // warp steps over the warp's keys
  constexpr int UNROLL = (STEPS * CPL <= 16) ? STEPS : 16 / CPL;  // loads in flight per lane
  constexpr int RG = THREADS / CH;            // row groups of the value pass
  constexpr int PART = HB * (D + 2);
  static_assert(CH <= THREADS && STEPS % UNROLL == 0, "head dim outside the kernel's range");

  extern __shared__ uint4 v_s[];  // the chunk's value rows, CHUNK x CH
  __shared__ float p_s[HB][CHUNK];
  __shared__ float ml_s[HB][2];
  __shared__ __align__(16) float red[RG][HB * D];
  __shared__ float w_s[THREADS];  // the merge's chunk weights
  __shared__ float scratch[32];
  __shared__ int is_last;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int unit = blockIdx.y, kvh = unit / groups, grp = unit % groups;
  const int h0 = kvh * rep + grp * HB;
  const int nh = min(HB, rep - grp * HB);
  const int pos = *pos_ptr;
  const int n_keys = min(pos + 1, S);  // a position past the window sees all S rows
  const int n_live = (n_keys + CHUNK - 1) / CHUNK;
  const int c = blockIdx.x;
  if (c >= n_live) return;
  const int j0 = c * CHUNK, nk = min(CHUNK, n_keys - j0);
  const uint4* kbase = reinterpret_cast<const uint4*>(kc + (size_t)kvh * S * D);
  const uint4* vbase = reinterpret_cast<const uint4*>(vc + (size_t)kvh * S * D);
  const uint4* kn = reinterpret_cast<const uint4*>(k_new + (size_t)kvh * D);
  const uint4* vn = reinterpret_cast<const uint4*>(v_new + (size_t)kvh * D);
  auto row = [&](const uint4* base, const uint4* fresh, int j) {
    return j == pos ? fresh : base + (size_t)j * CH;
  };

  // the chunk's value rows go to shared memory while the scores are computed
  for (int i = tid; i < nk * CH; i += THREADS) cp_async16(v_s + i, row(vbase, vn, j0 + i / CH) + i % CH);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // scores: lane sub = lane % LPR reads chunks sub + LPR * i of row r = lane / LPR
  const int sub = lane % LPR, r_in = lane / LPR;
  float qv[HB][CPL][8];
#pragma unroll
  for (int hb = 0; hb < HB; ++hb)
#pragma unroll
    for (int i = 0; i < CPL; ++i) {
      const int h = h0 + min(hb, nh - 1);
      const float4* qp = reinterpret_cast<const float4*>(q + (size_t)h * D + (sub + LPR * i) * 8);
      const float4 a = qp[0], b = qp[1];
      qv[hb][i][0] = a.x; qv[hb][i][1] = a.y; qv[hb][i][2] = a.z; qv[hb][i][3] = a.w;
      qv[hb][i][4] = b.x; qv[hb][i][5] = b.y; qv[hb][i][6] = b.z; qv[hb][i][7] = b.w;
    }
#pragma unroll
  for (int s0 = 0; s0 < STEPS; s0 += UNROLL) {
    uint4 kr[UNROLL][CPL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int jl = warp * KEYS_PER_WARP + (s0 + u) * RPW + r_in;
      if (jl < nk) {
        const uint4* rp = row(kbase, kn, j0 + jl);
#pragma unroll
        for (int i = 0; i < CPL; ++i) kr[u][i] = rp[sub + LPR * i];
      } else {
#pragma unroll
        for (int i = 0; i < CPL; ++i) kr[u][i] = make_uint4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      float dot[HB];
#pragma unroll
      for (int hb = 0; hb < HB; ++hb) dot[hb] = 0.f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        float kf[8];
        bf16x8_to_float(kr[u][i], kf);
#pragma unroll
        for (int hb = 0; hb < HB; ++hb)
#pragma unroll
          for (int e = 0; e < 8; ++e) dot[hb] += qv[hb][i][e] * kf[e];
      }
      const int jl = warp * KEYS_PER_WARP + (s0 + u) * RPW + r_in;
#pragma unroll
      for (int hb = 0; hb < HB; ++hb) {
#pragma unroll
        for (int o = LPR / 2; o > 0; o >>= 1) dot[hb] += __shfl_xor_sync(0xffffffffu, dot[hb], o);
        if (sub == 0 && jl < nk) p_s[hb][jl] = dot[hb] * scale;
      }
    }
  }
  __syncthreads();

  // the chunk's softmax: a warp per head
  for (int hb = warp; hb < HB; hb += WARPS) {
    float mx = -INFINITY;
    for (int j = lane; j < nk; j += 32) mx = fmaxf(mx, p_s[hb][j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < nk; j += 32) {
      const float e = expf(p_s[hb][j] - mx);
      p_s[hb][j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      ml_s[hb][0] = mx;
      ml_s[hb][1] = sum;
    }
  }
  __syncthreads();

  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // values: thread (cc, rg) sums p . v over rows rg, rg + RG, ... for 8 columns
  const int cc = tid % CH, rg = tid / CH;
  float acc[HB][8];
#pragma unroll
  for (int hb = 0; hb < HB; ++hb)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[hb][e] = 0.f;
#pragma unroll 4
  for (int jl = rg; jl < nk; jl += RG) {
    float vf[8];
    bf16x8_to_float(v_s[jl * CH + cc], vf);
#pragma unroll
    for (int hb = 0; hb < HB; ++hb) {
      const float pj = p_s[hb][jl];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[hb][e] += pj * vf[e];
    }
  }
#pragma unroll
  for (int hb = 0; hb < HB; ++hb) {
    float4* rp = reinterpret_cast<float4*>(&red[rg][hb * D + cc * 8]);
    rp[0] = make_float4(acc[hb][0], acc[hb][1], acc[hb][2], acc[hb][3]);
    rp[1] = make_float4(acc[hb][4], acc[hb][5], acc[hb][6], acc[hb][7]);
  }
  __syncthreads();

  float* mine = part + ((size_t)unit * gridDim.x + c) * PART;
  for (int i = tid; i < nh * D; i += THREADS) {
    float o = 0.f;
#pragma unroll
    for (int g = 0; g < RG; ++g) o += red[g][i];
    mine[i] = o;
  }
  if (tid < nh) {
    mine[HB * D + 2 * tid] = ml_s[tid][0];
    mine[HB * D + 2 * tid + 1] = ml_s[tid][1];
  }

  // the last block of this unit to arrive merges the live chunks
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&counters[unit], 1) == n_live - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // per head: a thread per chunk keeps a running (max, sum) of its chunks,
  // two block reductions give M and L; the chunks' weights go to shared
  // memory THREADS at a time, and each output column is summed over the
  // chunks with its loads in flight together
  const float* base = part + (size_t)unit * gridDim.x * PART;
  auto ml_of = [&](int cj, int hb) { return base + (size_t)cj * PART + HB * D + 2 * hb; };
  constexpr int OUT = (D + THREADS - 1) / THREADS;  // output columns a thread takes
  for (int hb = 0; hb < nh; ++hb) {
    float mt = -INFINITY, lt = 0.f, m_first = -INFINITY;
    for (int cj = tid; cj < n_live; cj += THREADS) {
      const float mc = __ldcg(ml_of(cj, hb)), lc = __ldcg(ml_of(cj, hb) + 1);
      if (cj == tid) m_first = mc;
      const float mn = fmaxf(mt, mc);
      lt = lt * expf(mt - mn) + lc * expf(mc - mn);
      mt = mn;
    }
    const float M = block_reduce<true>(mt, scratch);
    const float L = block_reduce<false>(lt == 0.f ? 0.f : lt * expf(mt - M), scratch);
    float acc[OUT];
#pragma unroll
    for (int u = 0; u < OUT; ++u) acc[u] = 0.f;
    for (int c0 = 0; c0 < n_live; c0 += THREADS) {
      __syncthreads();  // the previous batch's weights are read
      if (c0 + tid < n_live) w_s[tid] = expf((c0 == 0 ? m_first : __ldcg(ml_of(c0 + tid, hb))) - M);
      __syncthreads();
      const int nc = min(THREADS, n_live - c0);
#pragma unroll
      for (int u = 0; u < OUT; ++u) {
        const int e = tid + u * THREADS;
        if (e < D) {
          const float* pe = base + (size_t)c0 * PART + hb * D + e;
#pragma unroll 8
          for (int j = 0; j < nc; ++j) acc[u] += w_s[j] * __ldcg(pe + (size_t)j * PART);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < OUT; ++u)
      if (tid + u * THREADS < D) out[(size_t)(h0 + hb) * D + tid + u * THREADS] = acc[u] / L;
  }
  if (tid == 0) counters[unit] = 0;  // ready for the next launch
}

template <int D, int HB>
int launch(dim3 grid, cudaStream_t st, const float* q, const __nv_bfloat16* kn, const __nv_bfloat16* vn,
           const __nv_bfloat16* kc, const __nv_bfloat16* vc, const int* pos, float* out, float* part,
           int* counters, int rep, int groups, int S, float scale) {
  constexpr int smem = CHUNK * D * 2;  // the value rows; above 48 KB with the static arrays at D = 512
  const cudaError_t rc = cudaFuncSetAttribute(decode_attn_kernel<D, HB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                              smem);
  if (rc != cudaSuccess) return (int)rc;
  decode_attn_kernel<D, HB><<<grid, THREADS, smem, st>>>(q, kn, vn, kc, vc, pos, out, part, counters, rep, groups,
                                                         S, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_by_heads(int hb, dim3 grid, cudaStream_t st, const float* q, const __nv_bfloat16* kn,
                    const __nv_bfloat16* vn, const __nv_bfloat16* kc, const __nv_bfloat16* vc, const int* pos,
                    float* out, float* part, int* counters, int rep, int groups, int S, float scale) {
  switch (hb) {
    case 1: return launch<D, 1>(grid, st, q, kn, vn, kc, vc, pos, out, part, counters, rep, groups, S, scale);
    case 2: return launch<D, 2>(grid, st, q, kn, vn, kc, vc, pos, out, part, counters, rep, groups, S, scale);
    case 4: return launch<D, 4>(grid, st, q, kn, vn, kc, vc, pos, out, part, counters, rep, groups, S, scale);
    case 8:
      if constexpr (D <= 256)
        return launch<D, 8>(grid, st, q, kn, vn, kc, vc, pos, out, part, counters, rep, groups, S, scale);
      else
        return (int)cudaErrorInvalidValue;
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace ggml_tpu_torch

// Query heads a block takes for GQA factor rep and head dim D (the wrapper
// sizes the scratch with it): 1, 2, 4 or 8 (4 at D = 512), never more than
// rep rounded up to a power of two.
extern "C" int decode_attn_heads_per_block(int rep, int D) {
  const int top = D >= 512 ? 4 : 8;
  int hb = 1;
  while (hb < rep && hb < top) hb *= 2;
  return hb;
}

// q (hq, D) f32; k_new/v_new (hkv, D) bf16; kc/vc (hkv, S, D) bf16;
// pos: one int32 in device memory -> out (hq, D) f32.  D in {64, 128, 256, 512}.
// part: f32 scratch of hkv * groups * ceil(S / 64) * hb * (D + 2), groups =
// ceil(rep / hb), hb = decode_attn_heads_per_block(rep, D); counters: hkv *
// groups int32, zero before the launch (the launch leaves them zero).
extern "C" int decode_attn(const void* q, const void* k_new, const void* v_new, const void* kc, const void* vc,
                           const void* pos, void* out, void* part, void* counters, int hq, int hkv, int S, int D,
                           float scale, void* stream) {
  using namespace ggml_tpu_torch;
  if (hq < 1 || hkv < 1 || hq % hkv || S < 1) return (int)cudaErrorInvalidValue;
  const int rep = hq / hkv;
  const int hb = decode_attn_heads_per_block(rep, D);
  const int groups = (rep + hb - 1) / hb;
  if ((long long)hkv * groups > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((S + CHUNK - 1) / CHUNK, hkv * groups);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qp = static_cast<const float*>(q);
  const auto* knp = static_cast<const __nv_bfloat16*>(k_new);
  const auto* vnp = static_cast<const __nv_bfloat16*>(v_new);
  const auto* kcp = static_cast<const __nv_bfloat16*>(kc);
  const auto* vcp = static_cast<const __nv_bfloat16*>(vc);
  const auto* pp = static_cast<const int*>(pos);
  auto* op = static_cast<float*>(out);
  auto* pt = static_cast<float*>(part);
  auto* ct = static_cast<int*>(counters);
  switch (D) {
    case 64: return launch_by_heads<64>(hb, grid, st, qp, knp, vnp, kcp, vcp, pp, op, pt, ct, rep, groups, S, scale);
    case 128: return launch_by_heads<128>(hb, grid, st, qp, knp, vnp, kcp, vcp, pp, op, pt, ct, rep, groups, S, scale);
    case 256: return launch_by_heads<256>(hb, grid, st, qp, knp, vnp, kcp, vcp, pp, op, pt, ct, rep, groups, S, scale);
    case 512: return launch_by_heads<512>(hb, grid, st, qp, knp, vnp, kcp, vcp, pp, op, pt, ct, rep, groups, S, scale);
    default: return (int)cudaErrorInvalidValue;
  }
}
