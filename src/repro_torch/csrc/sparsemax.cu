// Row-wise SparseMax (Euclidean projection onto the simplex) for Hopper.
//
// Replaces: src/repro/kernels/sparsemax.py::sparsemax (body
// _sparsemax_kernel), which finds the threshold tau by 60 bisection steps
// on g(tau) = sum(max(z - tau, 0)) - 1 over blocks of 256 rows.
//
// What bounds it on the H100: one read and one write of the fp32 scores
// (4 MB at the batch serve's 8 x 256 x 256) against a few flops an element,
// so HBM bytes bound it in principle. In practice a row is short and the
// whole call is one wave, so what the kernel costs beyond its bytes is the
// dependent chain of reductions that finds tau; the design shortens that
// chain.
//
// Design. One warp owns one row and keeps it in registers (VPT values a
// lane, L <= 32 * VPT <= 1024), loaded and stored 16 bytes a lane where the
// row allows. tau is found exactly by support shrinking (Michelot's
// projection, as Condat 2016 analyses it), not by bisection:
//   tau_0 = max(z) - 1 (a lower bound of tau*),
//   tau_{k+1} = (sum_{z > tau_k} z - 1) / |{z > tau_k}|.
// From a lower bound tau rises monotonically and stays below tau*; it is
// tau* once the support {z > tau} stops shrinking, and is then the closed
// form over the support that the sort-based reference computes. A pass
// costs one ballot per register slot for the count (warp-uniform at once,
// no shuffle chain), a pairwise tree over the lane's values and one
// 5-shuffle sum. Whether the support shrinks at the new tau is one vote,
// so the pass that would confirm the last tau is never spent. The count
// falls at every pass that does not end the loop, so the loop ends after
// at most L passes whatever the rounding does, with no iteration cap.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFullMask = 0xffffffffu;

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

// Lane `lane`'s slots of a row: with VEC, float4 j holds columns
// 4 * (lane + 32 j) .. +3 (L % 4 == 0, 16-byte aligned rows); otherwise
// slot i holds column lane + 32 i. Columns past L read as -inf.
template <int VPT, bool VEC>
__device__ __forceinline__ void load_row(const float* __restrict__ zr, int L, int lane,
                                         float (&v)[VPT]) {
  if constexpr (VEC) {
#pragma unroll
    for (int j = 0; j < VPT / 4; ++j) {
      const int c = 4 * (lane + 32 * j);
      const float4 q = c < L ? __ldg(reinterpret_cast<const float4*>(zr + c))
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
      v[i] = c < L ? __ldg(zr + c) : -INFINITY;
    }
  }
}

template <int VPT, bool VEC>
__device__ __forceinline__ void store_row(float* __restrict__ orow, int L, int lane,
                                          const float (&v)[VPT], float tau) {
  if constexpr (VEC) {
#pragma unroll
    for (int j = 0; j < VPT / 4; ++j) {
      const int c = 4 * (lane + 32 * j);
      if (c < L)
        *reinterpret_cast<float4*>(orow + c) =
            make_float4(fmaxf(v[4 * j] - tau, 0.f), fmaxf(v[4 * j + 1] - tau, 0.f),
                        fmaxf(v[4 * j + 2] - tau, 0.f), fmaxf(v[4 * j + 3] - tau, 0.f));
    }
  } else {
#pragma unroll
    for (int i = 0; i < VPT; ++i) {
      const int c = lane + 32 * i;
      if (c < L) orow[c] = fmaxf(v[i] - tau, 0.f);
    }
  }
}

template <int VPT, bool VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sparsemax_kernel(const float* __restrict__ z, float* __restrict__ out, int rows, int L) {
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

template <int VPT, bool VEC>
void launch(const float* z, float* out, int rows, int L, cudaStream_t s) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sparsemax_kernel<VPT, VEC><<<blocks, kWarpsPerBlock * 32, 0, s>>>(z, out, rows, L);
}

template <int VPT>
void launch_any(const float* z, float* out, int rows, int L, bool vec, cudaStream_t s) {
  if constexpr (VPT >= 4) {
    if (vec) return launch<VPT, true>(z, out, rows, L, s);
  }
  launch<VPT, false>(z, out, rows, L, s);
}

}  // namespace

// out[r, :] = sparsemax(z[r, :]) for r < rows; z, out fp32 [rows, L],
// contiguous, 1 <= L <= 1024 (checked by the Python wrapper). Rows are
// loaded 16 bytes a lane when L % 4 == 0 and both pointers are 16-byte
// aligned, 4 bytes a lane otherwise.
extern "C" int rt_sparsemax(const void* z, void* out, int rows, int L, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* zi = static_cast<const float*>(z);
  float* o = static_cast<float*>(out);
  const bool vec = L % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(z) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  if (rows > 0) {
    if (L <= 32) launch_any<1>(zi, o, rows, L, vec, s);
    else if (L <= 64) launch_any<2>(zi, o, rows, L, vec, s);
    else if (L <= 128) launch_any<4>(zi, o, rows, L, vec, s);
    else if (L <= 256) launch_any<8>(zi, o, rows, L, vec, s);
    else if (L <= 512) launch_any<16>(zi, o, rows, L, vec, s);
    else launch_any<32>(zi, o, rows, L, vec, s);
  }
  return static_cast<int>(cudaGetLastError());
}
