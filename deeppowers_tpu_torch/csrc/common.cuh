// Shared helpers for the hand-written Hopper kernels of deeppowers_tpu_torch.
//
// Every kernel is reached through a plain `extern "C"` launcher that returns
// cudaGetLastError(), so the library builds with one nvcc call and binds with
// ctypes (no PyTorch headers).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define DPT_NEG_INF (-1e30f)

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float bf2f(bf16 v) { return __bfloat162float(v); }

// round to nearest even, as torch's .to(torch.bfloat16)
__device__ __forceinline__ bf16 f2bf(float v) { return __float2bfloat16_rn(v); }

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
