// Shared device helpers of the port's kernels: block reductions and loads of
// four adjacent plane columns (the planes are N-last, so four columns are one
// aligned 4-, 8- or 16-byte word).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ggml_tpu_torch {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Reduce over the whole block (blockDim.x a multiple of 32, at most 1024).
// Every thread gets the result.  `scratch` holds 32 floats of shared memory.
template <bool IS_MAX>
__device__ __forceinline__ float block_reduce(float v, float* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  v = IS_MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();  // scratch may still be read by a previous reduction
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float r = lane < n_warps ? scratch[lane] : (IS_MAX ? __int_as_float(0xff800000) : 0.f);
  return IS_MAX ? warp_max(r) : warp_sum(r);
}

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(q[0]);
  const float2 b = __bfloat1622float2(q[1]);
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

__device__ __forceinline__ void load4(const int8_t* p, float v[4]) {
  const char4 t = *reinterpret_cast<const char4*>(p);
  v[0] = (float)t.x; v[1] = (float)t.y; v[2] = (float)t.z; v[3] = (float)t.w;
}

}  // namespace ggml_tpu_torch
