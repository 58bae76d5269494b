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

#include <atomic>

namespace rt {

// dtype codes shared with repro_torch/kernels/build.py
enum DType : int { kF32 = 0, kBF16 = 1 };

// activation codes shared with repro_torch/kernels/expert_gemm.py
enum Act : int { kSilu = 0, kGelu = 1, kRelu = 2, kRelu2 = 3 };

// GEMM epilogue codes shared with repro_torch/kernels/expert_gemm.py: store
// the product, activate it, or multiply it by the activated second product
enum Epilogue : int { kStore = 0, kAct = 1, kGlu = 2 };

// weight formats of the expert GEMMs: the working dtype, int8 with one fp32
// scale per output column (applied to the fp32 product), or nibble-packed
// int4 with one fp32 scale per group of contraction rows per column
// (applied to each weight before the product)
enum WFmt : int { kFp = 0, kInt8 = 1, kInt4 = 2 };

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
  const float r = fmaxf(h, 0.0f);
  return act == kRelu2 ? r * r : r;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// c += a · b on the tensor cores: one m16n8k16 tile, bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values as one bf16 pair (lo in the low half), the layout of an
// mma fragment register
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 16 bytes from global into shared memory, asynchronously; the bytes past
// src_bytes (0 or 16) are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// every thread of every block of the thread-block cluster is here, and the
// shared-memory writes before it are visible to the cluster (a block
// launched without a cluster is a cluster of one)
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the address of p in the shared memory of the cluster's block `rank`
__device__ __forceinline__ uint32_t cluster_addr(const void* p, uint32_t rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(addr) : "r"(smem_u32(p)), "r"(rank));
  return addr;
}

// the float at p in the shared memory of the cluster's block `rank`
__device__ __forceinline__ float ld_cluster(const float* p, uint32_t rank) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(cluster_addr(p, rank)) : "memory");
  return v;
}

// v into the shared memory of a block of the cluster, at a cluster_addr
__device__ __forceinline__ void st_cluster(uint32_t addr, float v) {
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(addr), "f"(v) : "memory");
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

constexpr int MAX_SMEM = 232448;   // dynamic shared memory a block may use
constexpr int MAX_DEVICES = 64;    // devices a process may launch on

// the shared-memory limit is an attribute of each kernel on each device:
// raise it to MAX_SMEM, less the kernel's static shared memory, once per
// (kernel, device); `set` is the kernel's own flags, one a device
inline cudaError_t allow_smem(const void* kernel, std::atomic<bool>* set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!set[dev].load(std::memory_order_acquire)) {
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, kernel);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               MAX_SMEM - static_cast<int>(fa.sharedSizeBytes));
    if (err != cudaSuccess) return err;
    set[dev].store(true, std::memory_order_release);
  }
  return cudaSuccess;
}

// The bf16 expert GEMM on Hopper's TMA and wgmma (csrc/expert_ffn_sm90.cu):
// C[e] = epilogue(A[e] @ W[e] [, A[e] @ W2[e]]) on a bm x bn tile per block
// through a ring of `stages` shared-memory stages, with the contraction
// split `split` ways into the fp32 workspace ws [split, E, M, N] and summed
// in a fixed order when split > 1. W is bf16 [E, K, N] (kFp), int8 [E, K, N]
// with column scales bs [E, N] (kInt8), or packed int4 [E, K/2, N] with
// group scales bs [E, K/gs, N] (kInt4); b2/b2s the gate's, or null.
int sm90_expert_gemm(int fmt, const void* a, const void* b, const float* bs, const void* b2,
                     const float* b2s, void* c, void* ws, int E, int M, int N, int K, int gs,
                     int bm, int bn, int split, int stages, int epilogue, int act,
                     cudaStream_t stream);

}  // namespace rt
