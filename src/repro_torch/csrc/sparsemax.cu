// Row-wise SparseMax (Euclidean projection onto the simplex) for Hopper.
//
// Replaces: src/repro/kernels/sparsemax.py::sparsemax (body
// _sparsemax_kernel), which finds the threshold tau by 60 bisection steps
// on g(tau) = sum(max(z - tau, 0)) - 1 over blocks of 256 rows, reading z as
// fp32 and writing z's dtype.
//
// What bounds it on the H100: one read and one write of the scores (4 MB at
// the batch serve's 8 x 256 x 256 fp32) against a few flops an element, so
// HBM bytes bound it in principle. In practice a served row is short and
// the whole call is one wave, so what the kernel costs beyond its bytes is
// the dependent chain of reductions that finds tau; the design shortens
// that chain.
//
// tau is found exactly by support shrinking (Michelot's projection, as
// Condat 2016 analyses it), not by bisection:
//   tau_0 = max(z) - 1 (a lower bound of tau*),
//   tau_{k+1} = (sum_{z > tau_k} z - 1) / |{z > tau_k}|.
// From a lower bound tau rises monotonically and stays below tau*; it is
// tau* once the support {z > tau} stops shrinking, and is then the closed
// form over the support that the sort-based reference computes. A pass
// continues only when some value of the support at tau leaves it at the
// next tau, so the count falls at every pass that does not end the loop,
// and the loop ends after at most L passes whatever the rounding does,
// with no iteration cap. Values are read as fp32 (fp32, bf16 or fp16 in
// memory), computed in fp32 and written in z's dtype, as the Pallas body.
//
// Two kernels share that loop:
// - L <= 1024: one warp owns one row and keeps it in registers (VPT values
//   a lane), loaded and stored four values a lane (16 bytes fp32, 8 bytes
//   bf16 / fp16) where the row allows. A pass costs one ballot per register
//   slot for the count, a pairwise tree over the lane's values and one
//   5-shuffle sum; whether the support shrinks at the new tau is one vote,
//   so the pass that would confirm the last tau is never spent.
// - L > 1024 (TKD's draft head over long sequences): one block of 512
//   threads owns one row. The row is held as fp32 in shared memory while it
//   fits a block's opt-in 227 KB (57,856 values); past that every pass reads
//   it again from global memory, where L2 serves it. A pass is one sweep
//   that counts and sums the support at the next tau and, in the same
//   sweep, counts the values that leave it; one block-wide reduction (warp
//   shuffles, then the 16 warp partials read in a fixed order by every
//   thread from a double-buffered shared array) makes all three
//   block-uniform, so every thread takes the same branch.
#include <cuda_fp16.h>

#include <cstdint>
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFullMask = 0xffffffffu;

// dtype codes shared with repro_torch/kernels/sparsemax.py
enum ZType : int { kZF32 = 0, kZBF16 = 1, kZF16 = 2 };

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) { return __bfloat162float(p[0]); }
__device__ __forceinline__ float load1(const __half* p) { return __half2float(p[0]); }

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store1(__half* p, float v) { *p = __float2half_rn(v); }

// four consecutive values from an address aligned to four of them
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  __nv_bfloat162 a, b;
  memcpy(&a, &u.x, 4);
  memcpy(&b, &u.y, 4);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  __half2 a, b;
  memcpy(&a, &u.x, 4);
  memcpy(&b, &u.y, 4);
  const float2 fa = __half22float2(a), fb = __half22float2(b);
  return make_float4(fa.x, fa.y, fb.x, fb.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y), b = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  memcpy(&u.x, &a, 4);
  memcpy(&u.y, &b, 4);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store4(__half* p, float4 v) {
  const __half2 a = __floats2half2_rn(v.x, v.y), b = __floats2half2_rn(v.z, v.w);
  uint2 u;
  memcpy(&u.x, &a, 4);
  memcpy(&u.y, &b, 4);
  *reinterpret_cast<uint2*>(p) = u;
}

// ---------------------------------------------------------------------------
// L <= 1024: a warp a row, the row in registers
// ---------------------------------------------------------------------------

// Pairwise reduction of a lane's N values (N a power of two): log2(N)
// dependent operations instead of N. Overwrites a. Called with W = N / 2;
// each level is its own instantiation, so every index is a constant and
// the array stays in registers.
template <bool kMax, int W, int N>
__device__ __forceinline__ float tree_reduce(float (&a)[N]) {
  if constexpr (W == 0) {
    return a[0];
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) a[i] = kMax ? fmaxf(a[i], a[i + W]) : a[i] + a[i + W];
    return tree_reduce<kMax, W / 2>(a);
  }
}

// The support {z > tau} of the warp's row: its size (exact, from ballots) and
// the sum of its values, both warp-uniform.
template <int VPT>
__device__ __forceinline__ void support(const float (&v)[VPT], float tau, int& cnt,
                                        float& sum) {
  float s[VPT];
  int c = 0;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const bool in = v[i] > tau;
    c += __popc(__ballot_sync(kFullMask, in));
    s[i] = in ? v[i] : 0.f;
  }
  cnt = c;
  sum = rt::warp_sum(tree_reduce<false, VPT / 2>(s));
}

// Lane `lane`'s slots of a row: with VEC, vector j holds columns
// 4 * (lane + 32 j) .. +3 (L % 4 == 0, rows aligned to four values);
// otherwise slot i holds column lane + 32 i. Columns past L read as -inf.
template <int VPT, bool VEC, typename T>
__device__ __forceinline__ void load_row(const T* __restrict__ zr, int L, int lane,
                                         float (&v)[VPT]) {
  if constexpr (VEC) {
#pragma unroll
    for (int j = 0; j < VPT / 4; ++j) {
      const int c = 4 * (lane + 32 * j);
      const float4 q = c < L ? load4(zr + c)
                             : make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      v[4 * j] = q.x;
      v[4 * j + 1] = q.y;
      v[4 * j + 2] = q.z;
      v[4 * j + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = lane + 32 * i;
      v[i] = c < L ? load1(zr + c) : -INFINITY;
    }
  }
}

template <int VPT, bool VEC, typename T>
__device__ __forceinline__ void store_row(T* __restrict__ orow, int L, int lane,
                                          const float (&v)[VPT], float tau) {
  if constexpr (VEC) {
#pragma unroll
    for (int j = 0; j < VPT / 4; ++j) {
      const int c = 4 * (lane + 32 * j);
      if (c < L)
        store4(orow + c,
               make_float4(fmaxf(v[4 * j] - tau, 0.f), fmaxf(v[4 * j + 1] - tau, 0.f),
                           fmaxf(v[4 * j + 2] - tau, 0.f), fmaxf(v[4 * j + 3] - tau, 0.f)));
    }
  } else {
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = lane + 32 * i;
      if (c < L) store1(orow + c, fmaxf(v[i] - tau, 0.f));
    }
  }
}

template <int VPT, bool VEC, typename T>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sparsemax_warp_kernel(const T* __restrict__ z, T* __restrict__ out, int rows, int L) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp exits together: every vote below is warp-wide
  float v[VPT];
  load_row<VPT, VEC>(z + (size_t)row * L, L, lane, v);
  float m[VPT];
#pragma unroll
  for (int i = 0; i < VPT; ++i) m[i] = v[i];
  const float zmax = rt::warp_max(tree_reduce<true, VPT / 2>(m));

  float tau = zmax - 1.0f;
  int cnt;
  float sum;
  support(v, tau, cnt, sum);
  // |max| >= 2^24: max - 1 rounds to max and the support is empty; the JAX
  // kernel's bisection bracket [max - 1, max] collapses to max as well
  if (cnt == 0) tau = zmax;
  while (cnt > 0) {
    const float next = (sum - 1.0f) / (float)cnt;
    bool drops = false;  // a value of the support at tau leaves it at next
#pragma unroll
    for (int i = 0; i < VPT; ++i) drops |= (v[i] > tau) & (v[i] <= next);
    tau = next;
    // support stable: tau is exact up to rounding. On this last pass next
    // may round below the previous tau; values in (next, previous tau] then
    // come back with outputs of rounding size, so a row sums to 1 within
    // rounding, not exactly (the tests hold the sum to 1e-5).
    if (!__any_sync(kFullMask, drops)) break;
    support(v, tau, cnt, sum);                 // it shrank: cnt fell by at least 1
  }
  store_row<VPT, VEC>(out + (size_t)row * L, L, lane, v, tau);
}

// ---------------------------------------------------------------------------
// L > 1024: a block a row
// ---------------------------------------------------------------------------

constexpr int kRowThreads = 512;
constexpr int kRowWarps = kRowThreads / 32;
// the longest row held in shared memory: a block's opt-in limit, less a
// margin for the static reduction scratch
constexpr int kRowSmemMax = (rt::MAX_SMEM - 1024) / 4;

// One pass's three block-wide quantities, summed over the warps. The two
// buffers alternate between consecutive reductions, so a reduction's writes
// never meet the previous one's reads and one barrier each suffices.
struct Partials {
  float sum[2][kRowWarps];
  int cnt[2][kRowWarps];
  int drops[2][kRowWarps];
};

__device__ __forceinline__ int warp_isum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFullMask, v, o);
  return v;
}

// Block-wide (cnt, sum, drops): every thread reads the 16 warp partials in
// the same order, so all threads hold the same, run-to-run stable result.
__device__ __forceinline__ void block_reduce(Partials& red, int& parity, int& cnt, float& sum,
                                             int& drops) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = warp_isum(cnt), d = warp_isum(drops);
  const float s = rt::warp_sum(sum);
  if (lane == 0) {
    red.cnt[parity][warp] = c;
    red.sum[parity][warp] = s;
    red.drops[parity][warp] = d;
  }
  __syncthreads();
  cnt = 0;
  sum = 0.f;
  drops = 0;
#pragma unroll
  for (int w = 0; w < kRowWarps; ++w) {
    cnt += red.cnt[parity][w];
    sum += red.sum[parity][w];
    drops += red.drops[parity][w];
  }
  parity ^= 1;
}

template <bool kSmem, typename T>
__device__ __forceinline__ float row_at(const float* srow, const T* __restrict__ zr, int i) {
  if constexpr (kSmem) return srow[i];
  else return load1(zr + i);
}

template <bool kSmem, typename T>
__global__ void __launch_bounds__(kRowThreads)
sparsemax_row_kernel(const T* __restrict__ z, T* __restrict__ out, int L) {
  extern __shared__ float srow[];           // the row as fp32 (kSmem only)
  __shared__ Partials red;
  __shared__ float wmax[kRowWarps];
  const T* __restrict__ zr = z + (size_t)blockIdx.x * L;
  T* __restrict__ orow = out + (size_t)blockIdx.x * L;
  const int tid = threadIdx.x;
  int parity = 0;

  float m = -INFINITY;
  for (int i = tid; i < L; i += kRowThreads) {
    const float x = load1(zr + i);
    if constexpr (kSmem) srow[i] = x;
    m = fmaxf(m, x);
  }
  m = rt::warp_max(m);
  if ((tid & 31) == 0) wmax[tid >> 5] = m;
  __syncthreads();                         // also publishes srow
  float zmax = -INFINITY;
#pragma unroll
  for (int w = 0; w < kRowWarps; ++w) zmax = fmaxf(zmax, wmax[w]);

  // the support at tau_0 = max - 1
  float tau = zmax - 1.0f;
  int cnt = 0, drops = 0;
  float sum = 0.f;
  for (int i = tid; i < L; i += kRowThreads) {
    const float x = row_at<kSmem>(srow, zr, i);
    if (x > tau) {
      ++cnt;
      sum += x;
    }
  }
  block_reduce(red, parity, cnt, sum, drops);
  if (cnt == 0) tau = zmax;                // |max| >= 2^24, as the warp kernel
  while (cnt > 0) {
    const float next = (sum - 1.0f) / (float)cnt;
    // one sweep: the support at next, and the values that leave it
    int c = 0, d = 0;
    float s = 0.f;
    for (int i = tid; i < L; i += kRowThreads) {
      const float x = row_at<kSmem>(srow, zr, i);
      if (x > next) {
        ++c;
        s += x;
      } else if (x > tau) {
        ++d;
      }
    }
    block_reduce(red, parity, c, s, d);
    tau = next;
    if (d == 0) break;                     // support stable: tau exact up to rounding
    cnt = c;                               // it shrank: cnt fell by at least d >= 1
    sum = s;
  }
  for (int i = tid; i < L; i += kRowThreads)
    store1(orow + i, fmaxf(row_at<kSmem>(srow, zr, i) - tau, 0.f));
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <int VPT, bool VEC, typename T>
void launch_warp(const T* z, T* out, int rows, int L, cudaStream_t s) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sparsemax_warp_kernel<VPT, VEC, T><<<blocks, kWarpsPerBlock * 32, 0, s>>>(z, out, rows, L);
}

template <int VPT, typename T>
void launch_any(const T* z, T* out, int rows, int L, bool vec, cudaStream_t s) {
  if constexpr (VPT >= 4) {
    if (vec) return launch_warp<VPT, true>(z, out, rows, L, s);
  }
  launch_warp<VPT, false>(z, out, rows, L, s);
}

std::atomic<bool> row_smem_set[3][rt::MAX_DEVICES];

template <typename T>
cudaError_t launch_typed(const void* zv, void* ov, int rows, int L, int code, cudaStream_t s) {
  const T* z = static_cast<const T*>(zv);
  T* out = static_cast<T*>(ov);
  if (L > 1024) {
    if (L <= kRowSmemMax) {
      auto kern = sparsemax_row_kernel<true, T>;
      const cudaError_t err =
          rt::allow_smem(reinterpret_cast<const void*>(kern), row_smem_set[code]);
      if (err != cudaSuccess) return err;
      kern<<<rows, kRowThreads, (size_t)L * sizeof(float), s>>>(z, out, L);
    } else {
      sparsemax_row_kernel<false, T><<<rows, kRowThreads, 0, s>>>(z, out, L);
    }
    return cudaGetLastError();
  }
  // four values a lane: 16 bytes (fp32) or 8 bytes (bf16 / fp16) a load
  const bool vec = L % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(zv) | reinterpret_cast<uintptr_t>(ov)) %
                    (4 * sizeof(T))) == 0;
  if (L <= 32) launch_any<1>(z, out, rows, L, vec, s);
  else if (L <= 64) launch_any<2>(z, out, rows, L, vec, s);
  else if (L <= 128) launch_any<4>(z, out, rows, L, vec, s);
  else if (L <= 256) launch_any<8>(z, out, rows, L, vec, s);
  else if (L <= 512) launch_any<16>(z, out, rows, L, vec, s);
  else launch_any<32>(z, out, rows, L, vec, s);
  return cudaGetLastError();
}

}  // namespace

// out[r, :] = sparsemax(z[r, :]) for r < rows; z, out [rows, L] of one
// dtype (code 0 fp32, 1 bf16, 2 fp16), contiguous, L >= 1 (checked by the
// Python wrapper). Rows of up to 1024 take the warp kernel, longer rows the
// block kernel (the row in shared memory up to 57,856 values, re-read from
// global memory past that).
extern "C" int rt_sparsemax(const void* z, void* out, int rows, int L, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return static_cast<int>(cudaGetLastError());
  cudaError_t err;
  switch (dtype) {
    case kZF32: err = launch_typed<float>(z, out, rows, L, dtype, s); break;
    case kZBF16: err = launch_typed<__nv_bfloat16>(z, out, rows, L, dtype, s); break;
    case kZF16: err = launch_typed<__half>(z, out, rows, L, dtype, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
