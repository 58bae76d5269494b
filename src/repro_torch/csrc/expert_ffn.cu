// Slot-stacked expert FFN GEMMs for Hopper (sm_90a), over fp, int8 or int4
// weights.
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
// - bf16 weights go to the Hopper GEMM of csrc/expert_ffn_sm90.cu: a TMA
//   ring of shared-memory stages under mbarriers, one producer warp, and
//   wgmma consumer warpgroups, tiles and a split of the contraction chosen
//   per shape by kernels/expert_gemm.py::gemm_plan. Its note says what
//   bounds it.
// - fp32 runs a SIMT tile with fmaf below, so fp32 results stay IEEE (no
//   TF32).
// - int8 weights (Q) in bf16 run on the tensor cores through mma.sync
//   m16n8k16 with fp32 accumulation. They stream from HBM as int8 and widen
//   to the compute type as they are staged into shared memory — exact,
//   |q| <= 127 fits bf16's mantissa — and the epilogue multiplies the fp32
//   product by the column's scale, as _ffn_kernel_q does (x @ (q·s) ==
//   (x @ q)·s for a per-output-channel s).
// - int4 weights (Q4) stream as packed bytes (one byte = contraction rows 2i
//   and 2i+1 of a column, low nibble first, two's complement) through the
//   same mma.sync kernel and are dequantised as they are staged: each value
//   becomes q·s[k / group, n] in fp32 and is rounded to the compute type
//   before the product. Per-group scales do not commute with the whole
//   contraction, so unlike the int8 path they cannot wait for the epilogue;
//   dequantising at staging (instead of the TPU kernel's per-group partial
//   sums) keeps one accumulator and takes any group size, the whole axis
//   included, and it rounds the weights where the plain version rounds them,
//   so the two differ only in summation order.
// The capacity axis M is masked per row, so any C works (the Pallas kernel
// asserted C % bc == 0); N and K must be multiples of 64. The int8 / int4
// mma.sync kernel has no cp.async pipeline, wgmma or TMA yet.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

using rt::kAct;
using rt::kGlu;
using rt::kStore;
// weight formats: the working dtype, int8 with per-column scales applied in
// the epilogue, or nibble-packed int4 with group scales applied at staging
enum WFmt : int { kFp = 0, kInt8 = 1, kInt4 = 2 };

// value of row k, column n of a packed int4 matrix [K/2, N], dequantised
__device__ __forceinline__ float q4_at(const uint8_t* B, const float* sc, int gs, int k, int n,
                                       int N) {
  const int byte = B[(size_t)(k >> 1) * N + n];
  int v = (k & 1) ? (byte >> 4) : (byte & 0xF);
  v = v >= 8 ? v - 16 : v;
  return (float)v * sc[(size_t)(k / gs) * N + n];
}

// ---------------------------------------------------------------------------
// int8 / int4 weights in bf16: tensor cores via mma.sync.m16n8k16 (fp32
// accumulate)
// ---------------------------------------------------------------------------
constexpr int BM = 64, BN = 64, BK = 32;
constexpr int LDS = BK + 8;  // padded smem row (80 bytes: 16B aligned, conflict-free)

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

using rt::mma_bf16;

// int8 B tile [BK, BN] -> smem transposed [BN][LDS], so the mma B fragment
// (two consecutive k at one n) is one 32-bit load: one 16-byte load a
// thread, widened to bf16 (exact) as it is stored.
__device__ __forceinline__ void load_b_tile_t(bf16* sB, const int8_t* B, int k0, int n0,
                                              int N, int tid) {
  const int r = tid >> 2, c = (tid & 3) * 16;
  const uint4 v = *reinterpret_cast<const uint4*>(B + (size_t)(k0 + r) * N + n0 + c);
  const int8_t* pv = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
  for (int i = 0; i < 16; ++i) sB[(c + i) * LDS + r] = __float2bfloat16_rn((float)pv[i]);
}

// packed int4 B tile [BK, BN]: 8 bytes (16 values of two rows) a thread,
// dequantised with the rows' group scales and stored transposed like the
// int8 tile. The rounding to bf16 is the plain version's.
__device__ __forceinline__ void load_b_tile_q4(bf16* sB, const uint8_t* B, const float* sc,
                                               int gs, int k0, int n0, int N, int tid) {
  const int pr = tid >> 3, c = (tid & 7) * 8;          // packed row 0..15, 8 columns
  const uint2 v = *reinterpret_cast<const uint2*>(B + (size_t)(k0 / 2 + pr) * N + n0 + c);
  const uint8_t* pv = reinterpret_cast<const uint8_t*>(&v);
  const int r = 2 * pr;
  const float* s0 = sc + (size_t)((k0 + r) / gs) * N + n0 + c;
  const float* s1 = sc + (size_t)((k0 + r + 1) / gs) * N + n0 + c;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int lo = pv[i] & 0xF, hi = pv[i] >> 4;
    sB[(c + i) * LDS + r] = __float2bfloat16_rn((float)(lo >= 8 ? lo - 16 : lo) * s0[i]);
    sB[(c + i) * LDS + r + 1] = __float2bfloat16_rn((float)(hi >= 8 ? hi - 16 : hi) * s1[i]);
  }
}

template <int FMT> struct WType;
template <> struct WType<kFp> { using f32 = float; };
template <> struct WType<kInt8> { using bf = int8_t; using f32 = int8_t; };
template <> struct WType<kInt4> { using bf = uint8_t; using f32 = uint8_t; };

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

// FMT: the weights' format (kInt8 or kInt4); sc/sc2 their scales, gs the
// int4 group
template <int EPI, int FMT>
__global__ void __launch_bounds__(128)
gemm_bf16_kernel(const bf16* __restrict__ A, const typename WType<FMT>::bf* __restrict__ B,
                 const typename WType<FMT>::bf* __restrict__ B2, const float* __restrict__ sc,
                 const float* __restrict__ sc2, bf16* __restrict__ C,
                 int M, int N, int K, int gs, int act) {
  constexpr bool GLU = EPI == kGlu;
  constexpr bool Q = FMT == kInt8;
  __shared__ __align__(16) bf16 sA[BM * LDS];
  __shared__ __align__(16) bf16 sB[BN * LDS];
  __shared__ __align__(16) bf16 sB2[GLU ? BN * LDS : 8];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  A += (size_t)e * M * K;
  B += weight_offset<FMT>(e, N, K);
  if (GLU) B2 += weight_offset<FMT>(e, N, K);
  sc += scale_offset<FMT>(e, N, K, gs);
  if (GLU) sc2 += scale_offset<FMT>(e, N, K, gs);
  C += (size_t)e * M * N;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, t4 = (lane & 3) * 2;

  float acc[2][4][4], accg[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = accg[mi][ni][r] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // A tile [BM, BK], ragged rows -> zeros
      const int idx = tid + j * 128;
      const int r = idx >> 2, c = (idx & 3) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M) v = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0 + c);
      *reinterpret_cast<uint4*>(&sA[r * LDS + c]) = v;
    }
    if constexpr (FMT == kInt4) {
      load_b_tile_q4(sB, B, sc, gs, k0, n0, N, tid);
      if (GLU) load_b_tile_q4(sB2, B2, sc2, gs, k0, n0, N, tid);
    } else {   // kInt8
      load_b_tile_t(sB, B, k0, n0, N, tid);
      if (GLU) load_b_tile_t(sB2, B2, k0, n0, N, tid);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const bf16* p = &sA[(wm + mi * 16 + g) * LDS + kk + t4];
        af[mi][0] = ld32(p);
        af[mi][1] = ld32(p + 8 * LDS);
        af[mi][2] = ld32(p + 8);
        af[mi][3] = ld32(p + 8 * LDS + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int off = (wn + ni * 8 + g) * LDS + kk + t4;
        const uint32_t b0 = ld32(&sB[off]), b1 = ld32(&sB[off + 8]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][ni], af[mi], b0, b1);
        if (GLU) {
          const uint32_t g0 = ld32(&sB2[off]), g1 = ld32(&sB2[off + 8]);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) mma_bf16(accg[mi][ni], af[mi], g0, g1);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + mi * 16 + g + half * 8;
        if (row >= M) continue;
        const int col = n0 + wn + ni * 8 + t4;
        float v0 = acc[mi][ni][half * 2], v1 = acc[mi][ni][half * 2 + 1];
        float g0 = accg[mi][ni][half * 2], g1 = accg[mi][ni][half * 2 + 1];
        if (Q) {
          v0 *= sc[col];
          v1 *= sc[col + 1];
          if (GLU) {
            g0 *= sc2[col];
            g1 *= sc2[col + 1];
          }
        }
        if (EPI == kAct) {
          v0 = rt::activate(v0, act);
          v1 = rt::activate(v1, act);
        } else if (EPI == kGlu) {
          v0 *= rt::activate(g0, act);
          v1 *= rt::activate(g1, act);
        }
        *reinterpret_cast<__nv_bfloat162*>(C + (size_t)row * N + col) =
            __floats2bfloat162_rn(v0, v1);
      }
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
void launch(const void* a, const void* b, const void* b2, const float* sc, const float* sc2,
            void* c, int E, int M, int N, int K, int gs, int dtype, int act, cudaStream_t s) {
  using WF = typename WType<FMT>::f32;
  const dim3 grid(N / BN, (M + BM - 1) / BM, E);
  if constexpr (FMT != kFp) {   // bf16 over fp weights is rt::sm90_expert_gemm's
    using WB = typename WType<FMT>::bf;
    if (dtype == rt::kBF16) {
      gemm_bf16_kernel<EPI, FMT><<<grid, 128, 0, s>>>(
          static_cast<const bf16*>(a), static_cast<const WB*>(b), static_cast<const WB*>(b2),
          sc, sc2, static_cast<bf16*>(c), M, N, K, gs, act);
      return;
    }
  }
  gemm_f32_kernel<EPI, FMT><<<grid, 256, 0, s>>>(
      static_cast<const float*>(a), static_cast<const WF*>(b), static_cast<const WF*>(b2),
      sc, sc2, static_cast<float*>(c), M, N, K, gs, act);
}

template <int FMT>
int gemm(const void* a, const void* b, const void* b2, const float* sc, const float* sc2,
         void* c, int E, int M, int N, int K, int gs, int dtype, int epilogue, int act,
         cudaStream_t s) {
  if (M > 0 && E > 0) {
    if (epilogue == kStore) launch<kStore, FMT>(a, b, b2, sc, sc2, c, E, M, N, K, gs, dtype, act, s);
    else if (epilogue == kAct) launch<kAct, FMT>(a, b, b2, sc, sc2, c, E, M, N, K, gs, dtype, act, s);
    else launch<kGlu, FMT>(a, b, b2, sc, sc2, c, E, M, N, K, gs, dtype, act, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C[e] = epilogue(A[e] @ B[e] [, A[e] @ B2[e]]) for e < E.
// A [E, M, K], B/B2 [E, K, N], C [E, M, N], all contiguous, 16-byte aligned
// and of one dtype. Requires N % 64 == 0 and K % 64 == 0 (checked by the
// Python wrapper). bf16 runs rt::sm90_expert_gemm on the plan (bm, bn,
// split, stages) of kernels/expert_gemm.py::gemm_plan, with ws an fp32
// workspace [split, E, M, N] when split > 1; fp32 ignores the plan.
extern "C" int rt_expert_gemm(const void* a, const void* b, const void* b2, void* c, void* ws,
                              int E, int M, int N, int K, int bm, int bn, int split, int stages,
                              int dtype, int epilogue, int act, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kBF16)
    return rt::sm90_expert_gemm(a, b, b2, c, ws, E, M, N, K, bm, bn, split, stages, epilogue,
                                act, s);
  return gemm<kFp>(a, b, b2, nullptr, nullptr, c, E, M, N, K, 1, dtype, epilogue, act, s);
}

// The same over int8 weights: C[e] = epilogue((A[e] @ Bq[e]) * bs[e] [, ...]).
// Bq/B2q [E, K, N] int8, bs/b2s [E, N] fp32 per-output-channel scales; A and
// C in the working dtype. Same shape rules as rt_expert_gemm.
extern "C" int rt_expert_gemm_q(const void* a, const void* bq, const void* bs,
                                const void* b2q, const void* b2s, void* c, int E, int M,
                                int N, int K, int dtype, int epilogue, int act,
                                void* stream) {
  return gemm<kInt8>(a, bq, b2q, static_cast<const float*>(bs), static_cast<const float*>(b2s),
                     c, E, M, N, K, 1, dtype, epilogue, act, static_cast<cudaStream_t>(stream));
}

// The same over nibble-packed int4 weights with group scales:
// C[e] = epilogue(A[e] @ dequant(Bq[e]) [, ...]), dequant(Bq)[k, n] =
// q[k, n] · bs[k / gs, n]. Bq/B2q [E, K/2, N] uint8 (byte i = rows 2i, 2i+1,
// low nibble first), bs/b2s [E, K/gs, N] fp32; gs divides K. Same shape rules
// as rt_expert_gemm (N % 64 == 0, K % 64 == 0).
extern "C" int rt_expert_gemm_q4(const void* a, const void* bq, const void* bs,
                                 const void* b2q, const void* b2s, void* c, int E, int M,
                                 int N, int K, int gs, int dtype, int epilogue, int act,
                                 void* stream) {
  return gemm<kInt4>(a, bq, b2q, static_cast<const float*>(bs), static_cast<const float*>(b2s),
                     c, E, M, N, K, gs, dtype, epilogue, act, static_cast<cudaStream_t>(stream));
}
