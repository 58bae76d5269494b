// Row-wise SparseMax (Euclidean projection onto the simplex) for Hopper.
//
// Replaces: src/repro/kernels/sparsemax.py::sparsemax (body
// _sparsemax_kernel), which finds the threshold tau by 60 bisection steps
// on g(tau) = sum(max(z - tau, 0)) - 1 over blocks of 256 rows.
//
// What bounds it on the H100: one read and one write of the fp32 scores
// (B*S rows of length S; 4 MB at the serving shape 8 x 256 x 256) against a
// few hundred flops per element, so HBM bytes bound it; the bisection loop
// only has to stay on chip.
//
// Design. One warp owns one row and keeps it in registers (VPT values per
// lane, L <= 32 * VPT <= 1024), so every bisection step is an on-register
// sum plus five shuffles, with no shared memory and no block barrier. After
// the bisection isolates the support {z > tau}, tau is recomputed exactly as
// (sum of the support - 1) / |support| — the closed form the sort-based
// reference uses — so the result matches it to rounding, not to the
// bisection bracket.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kBisectIters = 40;  // the bracket reaches fp32 resolution well before

template <int VPT>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sparsemax_kernel(const float* __restrict__ z, float* __restrict__ out, int rows, int L) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // whole warp exits together: no barrier below
  const float* zr = z + (size_t)row * L;
  float v[VPT];
  float zmax = -INFINITY;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    v[i] = c < L ? zr[c] : -INFINITY;
    zmax = fmaxf(zmax, v[i]);
  }
  zmax = rt::warp_max(zmax);

  float lo = zmax - 1.0f, hi = zmax;
  for (int it = 0; it < kBisectIters; ++it) {
    const float mid = 0.5f * (lo + hi);
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < VPT; ++i) s += fmaxf(v[i] - mid, 0.f);
    if (rt::warp_sum(s) - 1.0f > 0.f) lo = mid;
    else hi = mid;
  }
  float tau = 0.5f * (lo + hi);

  float cnt = 0.f, sum = 0.f;
#pragma unroll
  for (int i = 0; i < VPT; ++i)
    if (v[i] > tau) {
      cnt += 1.f;
      sum += v[i];
    }
  cnt = rt::warp_sum(cnt);
  sum = rt::warp_sum(sum);
  tau = (sum - 1.0f) / fmaxf(cnt, 1.f);

  float* orow = out + (size_t)row * L;
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int c = lane + 32 * i;
    if (c < L) orow[c] = fmaxf(v[i] - tau, 0.f);
  }
}

template <int VPT>
void launch(const float* z, float* out, int rows, int L, cudaStream_t s) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sparsemax_kernel<VPT><<<blocks, kWarpsPerBlock * 32, 0, s>>>(z, out, rows, L);
}

}  // namespace

// out[r, :] = sparsemax(z[r, :]) for r < rows; z, out fp32 [rows, L],
// contiguous, 1 <= L <= 1024 (checked by the Python wrapper).
extern "C" int rt_sparsemax(const void* z, void* out, int rows, int L, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* zi = static_cast<const float*>(z);
  float* o = static_cast<float*>(out);
  if (rows > 0) {
    if (L <= 32) launch<1>(zi, o, rows, L, s);
    else if (L <= 64) launch<2>(zi, o, rows, L, s);
    else if (L <= 128) launch<4>(zi, o, rows, L, s);
    else if (L <= 256) launch<8>(zi, o, rows, L, s);
    else if (L <= 512) launch<16>(zi, o, rows, L, s);
    else launch<32>(zi, o, rows, L, s);
  }
  return static_cast<int>(cudaGetLastError());
}
