// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel source exposes `extern "C"` entry points with plain pointer /
// int / float arguments, so the Python side binds them with ctypes (no
// PyTorch headers in the build). Each entry launches on the stream it is
// given, allocates nothing, does not synchronise, and returns
// cudaGetLastError() so the caller can raise on a refused launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// dtype codes shared with repro_torch/kernels/build.py
enum DType : int { kF32 = 0, kBF16 = 1 };

// activation codes shared with repro_torch/kernels/expert_gemm.py
enum Act : int { kSilu = 0, kGelu = 1, kRelu = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// jax.nn.gelu's default is the tanh approximation; jax.nn.silu is x·σ(x).
__device__ __forceinline__ float activate(float h, int act) {
  if (act == kSilu) return h / (1.0f + expf(-h));
  if (act == kGelu) {
    const float c = 0.7978845608028654f;  // sqrt(2/pi)
    return 0.5f * h * (1.0f + tanhf(c * (h + 0.044715f * h * h * h)));
  }
  return fmaxf(h, 0.0f);
}

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

}  // namespace rt
