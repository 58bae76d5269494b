// Slot-stacked expert FFN GEMMs for Hopper (sm_90a), over fp, int8 or int4
// weights: the C entry points, and the fp32 kernel.
//
// Replaces: src/repro/kernels/expert_gemm.py::expert_ffn (body _ffn_kernel),
// the TPU kernel that tiles xe [E, C, d] -> act(xe @ w_in) @ w_out through
// VMEM with the output block accumulating across F tiles; and
// expert_gemm.py::expert_ffn_q (body _ffn_kernel_q), the same FFN over
// int8-resident weights whose tiles widen in VMEM, with the per-output-
// channel f32 scale applied to the f32 product before the activation and
// after the down-projection; and expert_gemm.py::expert_ffn_q4 (body
// _ffn_kernel_q4), the FFN over nibble-packed int4 warm-tier weights with
// one f32 scale per group of contraction rows per output channel, which the
// TPU kernel applies to per-group partial products in its f32 epilogue.
//
// What bounds it on the H100: at the batch serving shapes (E = 4 slots,
// C = 640, d = 768, F = 3072, bf16) the two products are 24.2 GFLOP against
// 45.6 MB of operands, ~530 FLOP/byte, so the tensor cores bound it, not HBM.
// At decode (C = 8 rows a slot) the same weights do 0.3 GFLOP: HBM bytes
// bound it, and int8 weights halve them (18.9 MB instead of 37.7 MB);
// int4 weights halve them again (3 warm slots: 8.0 MB with the scale
// planes, 2.4 us at 3.35 TB/s).
//
// Design. A block has no 16 MB of fast memory to hold the [C, F] hidden
// tile the TPU kernel keeps in VMEM, so the FFN runs as two GEMM launches:
// the up-projection with the activation (and the GLU gate product) fused
// into its epilogue writes h once in the working dtype — the same rounding
// point as the TPU kernel's h.astype(x.dtype) — and the down-projection
// reads it back.
// - bf16, over bf16, int8 or int4 weights, goes to the Hopper GEMM of
//   csrc/expert_ffn_sm90.cu: a TMA ring of shared-memory stages under
//   mbarriers, one producer warp, and wgmma consumer warpgroups, tiles and
//   a split of the contraction chosen per shape and weight format by
//   kernels/expert_gemm.py::gemm_plan. int8 and int4 weights cross HBM in
//   their own bytes and are widened to bf16 in shared memory after they
//   land. Its note says what bounds it and how.
// - fp32 runs a SIMT tile with fmaf below, so fp32 results stay IEEE (no
//   TF32), over every format: int8 weights widen exactly and the column
//   scale multiplies the fp32 product in the epilogue, as _ffn_kernel_q
//   does (x @ (q·s) == (x @ q)·s for a per-output-channel s); int4 weights
//   become q·s[k / group, n] in fp32 as they are staged. Per-group scales do
//   not commute with the whole contraction, so unlike int8 they cannot wait
//   for the epilogue; dequantising at staging (instead of the TPU kernel's
//   per-group partial sums) keeps one accumulator and takes any group size,
//   the whole axis included.
// The capacity axis M is masked per row, so any C works (the Pallas kernel
// asserted C % bc == 0); N and K must be multiples of 64.
#include "common.cuh"

namespace {

using rt::kAct;
using rt::kFp;
using rt::kGlu;
using rt::kInt4;
using rt::kInt8;
using rt::kStore;

constexpr int BM = 64, BN = 64;   // the fp32 kernel's output tile

// value of row k, column n of a packed int4 matrix [K/2, N], dequantised
__device__ __forceinline__ float q4_at(const uint8_t* B, const float* sc, int gs, int k, int n,
                                       int N) {
  const int byte = B[(size_t)(k >> 1) * N + n];
  int v = (k & 1) ? (byte >> 4) : (byte & 0xF);
  v = v >= 8 ? v - 16 : v;
  return (float)v * sc[(size_t)(k / gs) * N + n];
}

template <int FMT> struct WType;
template <> struct WType<kFp> { using f32 = float; };
template <> struct WType<kInt8> { using f32 = int8_t; };
template <> struct WType<kInt4> { using f32 = uint8_t; };

// offsets of slot e's weights, [K, N] (fp, int8) or [K/2, N] packed (int4),
// and of its scales, [N] per column (int8) or [K/gs, N] per group (int4)
template <int FMT>
__device__ __forceinline__ size_t weight_offset(int e, int N, int K) {
  return (size_t)e * (FMT == kInt4 ? K / 2 : K) * N;
}
template <int FMT>
__device__ __forceinline__ size_t scale_offset(int e, int N, int K, int gs) {
  return FMT == kInt8 ? (size_t)e * N : FMT == kInt4 ? (size_t)e * (K / gs) * N : 0;
}

// ---------------------------------------------------------------------------
// fp32: SIMT tile, 4x4 outputs per thread (IEEE fp32, no TF32)
// ---------------------------------------------------------------------------
constexpr int FBK = 16;

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(int8_t x) { return (float)x; }

template <int EPI, int FMT>
__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ A, const typename WType<FMT>::f32* __restrict__ B,
                const typename WType<FMT>::f32* __restrict__ B2, const float* __restrict__ sc,
                const float* __restrict__ sc2, float* __restrict__ C,
                int M, int N, int K, int gs, int act) {
  constexpr bool GLU = EPI == kGlu;
  constexpr bool Q = FMT == kInt8;
  __shared__ float sA[FBK][BM + 4];  // transposed [k][m]
  __shared__ float sB[FBK][BN];
  __shared__ float sB2[GLU ? FBK : 1][BN];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  A += (size_t)e * M * K;
  B += weight_offset<FMT>(e, N, K);
  if (GLU) B2 += weight_offset<FMT>(e, N, K);
  if (FMT != kFp) {
    sc += scale_offset<FMT>(e, N, K, gs);
    if (GLU) sc2 += scale_offset<FMT>(e, N, K, gs);
  }
  C += (size_t)e * M * N;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  float acc[4][4], accg[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = accg[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += FBK) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int idx = tid + j * 256;
      const int r = idx >> 4, c = idx & 15;
      sA[c][r] = (m0 + r < M) ? A[(size_t)(m0 + r) * K + k0 + c] : 0.f;
      const int rb = idx >> 6, cb = idx & 63;
      if constexpr (FMT == kInt4) {
        sB[rb][cb] = q4_at(B, sc, gs, k0 + rb, n0 + cb, N);
        if (GLU) sB2[rb][cb] = q4_at(B2, sc2, gs, k0 + rb, n0 + cb, N);
      } else {
        sB[rb][cb] = widen(B[(size_t)(k0 + rb) * N + n0 + cb]);
        if (GLU) sB2[rb][cb] = widen(B2[(size_t)(k0 + rb) * N + n0 + cb]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < FBK; ++k) {
      float a[4], b[4], b2[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sA[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[j] = sB[k][tx + 16 * j];
        if (GLU) b2[j] = sB2[k][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
          if (GLU) accg[i][j] = fmaf(a[i], b2[j], accg[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      float v = acc[i][j], g = accg[i][j];
      if (Q) {
        v *= sc[col];
        if (GLU) g *= sc2[col];
      }
      if (EPI == kAct) v = rt::activate(v, act);
      else if (EPI == kGlu) v *= rt::activate(g, act);
      C[(size_t)row * N + col] = v;
    }
  }
}

template <int EPI, int FMT>
void launch_f32(const void* a, const void* b, const void* b2, const float* sc, const float* sc2,
                void* c, int E, int M, int N, int K, int gs, int act, cudaStream_t s) {
  using WF = typename WType<FMT>::f32;
  const dim3 grid(N / BN, (M + BM - 1) / BM, E);
  gemm_f32_kernel<EPI, FMT><<<grid, 256, 0, s>>>(
      static_cast<const float*>(a), static_cast<const WF*>(b), static_cast<const WF*>(b2),
      sc, sc2, static_cast<float*>(c), M, N, K, gs, act);
}

// bf16 runs rt::sm90_expert_gemm on the plan (bm, bn, split, stages) of
// kernels/expert_gemm.py::gemm_plan, with ws an fp32 workspace
// [split, E, M, N] when split > 1; fp32 runs the SIMT kernel, which takes
// no plan
template <int FMT>
int gemm(const void* a, const void* b, const float* bs, const void* b2, const float* b2s,
         void* c, void* ws, int E, int M, int N, int K, int gs, int bm, int bn, int split,
         int stages, int dtype, int epilogue, int act, cudaStream_t s) {
  if (dtype == rt::kBF16)
    return rt::sm90_expert_gemm(FMT, a, b, bs, b2, b2s, c, ws, E, M, N, K, gs, bm, bn, split,
                                stages, epilogue, act, s);
  if (M > 0 && E > 0) {
    if (epilogue == kStore) launch_f32<kStore, FMT>(a, b, b2, bs, b2s, c, E, M, N, K, gs, act, s);
    else if (epilogue == kAct) launch_f32<kAct, FMT>(a, b, b2, bs, b2s, c, E, M, N, K, gs, act, s);
    else launch_f32<kGlu, FMT>(a, b, b2, bs, b2s, c, E, M, N, K, gs, act, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C[e] = epilogue(A[e] @ B[e] [, A[e] @ B2[e]]) for e < E.
// A [E, M, K], B/B2 [E, K, N], C [E, M, N], all contiguous, 16-byte aligned
// and of one dtype. Requires N % 64 == 0 and K % 64 == 0 (checked by the
// Python wrapper). (bm, bn, split, stages) is the bf16 plan and ws its
// workspace (see gemm above).
extern "C" int rt_expert_gemm(const void* a, const void* b, const void* b2, void* c, void* ws,
                              int E, int M, int N, int K, int bm, int bn, int split, int stages,
                              int dtype, int epilogue, int act, void* stream) {
  return gemm<kFp>(a, b, nullptr, b2, nullptr, c, ws, E, M, N, K, 1, bm, bn, split, stages,
                   dtype, epilogue, act, static_cast<cudaStream_t>(stream));
}

// The same over int8 weights: C[e] = epilogue((A[e] @ Bq[e]) * bs[e] [, ...]).
// Bq/B2q [E, K, N] int8, bs/b2s [E, N] fp32 per-output-channel scales; A and
// C in the working dtype. Same shape rules and plan as rt_expert_gemm.
extern "C" int rt_expert_gemm_q(const void* a, const void* bq, const void* bs,
                                const void* b2q, const void* b2s, void* c, void* ws, int E,
                                int M, int N, int K, int bm, int bn, int split, int stages,
                                int dtype, int epilogue, int act, void* stream) {
  return gemm<kInt8>(a, bq, static_cast<const float*>(bs), b2q, static_cast<const float*>(b2s),
                     c, ws, E, M, N, K, 1, bm, bn, split, stages, dtype, epilogue, act,
                     static_cast<cudaStream_t>(stream));
}

// The same over nibble-packed int4 weights with group scales:
// C[e] = epilogue(A[e] @ dequant(Bq[e]) [, ...]), dequant(Bq)[k, n] =
// q[k, n] · bs[k / gs, n]. Bq/B2q [E, K/2, N] uint8 (byte i = rows 2i, 2i+1,
// low nibble first), bs/b2s [E, K/gs, N] fp32; gs divides K. Same shape rules
// and plan as rt_expert_gemm.
extern "C" int rt_expert_gemm_q4(const void* a, const void* bq, const void* bs,
                                 const void* b2q, const void* b2s, void* c, void* ws, int E,
                                 int M, int N, int K, int gs, int bm, int bn, int split,
                                 int stages, int dtype, int epilogue, int act, void* stream) {
  return gemm<kInt4>(a, bq, static_cast<const float*>(bs), b2q, static_cast<const float*>(b2s),
                     c, ws, E, M, N, K, gs, bm, bn, split, stages, dtype, epilogue, act,
                     static_cast<cudaStream_t>(stream));
}
