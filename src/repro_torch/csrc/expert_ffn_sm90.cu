// The slot-stacked expert GEMM on Hopper's TMA and wgmma (sm_90a), over
// bf16, int8 or nibble-packed int4 weights, for the bf16 working type.
//
// Replaces: src/repro/kernels/expert_gemm.py::expert_ffn (body _ffn_kernel),
// ::expert_ffn_q (body _ffn_kernel_q: int8 weights, one fp32 scale per
// output channel on the fp32 product) and ::expert_ffn_q4 (bodies
// _ffn_kernel_q4 and _unpack_nibbles: int4 weights, one fp32 scale per
// group of contraction rows per channel); csrc/expert_ffn.cu's
// rt_expert_gemm, rt_expert_gemm_q and rt_expert_gemm_q4 send their bf16
// calls here. The FFN stays two launches (three with a split of the 64-row
// tile; the decode tile sums its splits in a cluster): the
// up-projection with the activation (or the GLU product) in its epilogue
// writes h once in bf16 — the TPU kernel's rounding point,
// h.astype(x.dtype) — and the down-projection reads it back. Accumulation
// is fp32 over the whole contraction (or over each split of it, summed in
// fp32).
//
// What bounds it on the H100: at the batch shape (E = 4 slots, C = 640,
// d = 768, F = 3072) the two products are 24.2 GFLOP against 45.6 MB of
// bf16 operands, ~530 FLOP/byte, above the bf16 ridge (~295): the tensor
// cores bound it, 0.0244 ms at 989 TFLOP/s, whatever the weight format. At
// decode (C = 8) they are 0.30 GFLOP against the weights' bytes: HBM bounds
// it — 37.7 MB bf16 (0.0113 ms at 3.35 TB/s), 18.9 MB int8 at 4 slots, and
// for 3 warm int4 slots 8.0 MB with the scale planes (0.0024 ms).
//
// Design (one block per bm x bn output tile of one slot):
// - A producer warp keeps a ring of `stages` shared-memory stages full with
//   TMA loads; each stage has a full and an empty mbarrier. One or two
//   consumer warpgroups (64 rows each) issue wgmma.mma_async m64n{bn}k16 on
//   the stage that has landed, keep one stage's products in flight, and
//   release the one before. Loads and tensor-core work overlap.
// - A is described to TMA as [E, M, K] and bf16 B as [E, K, N] (N
//   contiguous), both with 128-byte swizzle, so a box never crosses into
//   the next slot and TMA's zero fill masks the ragged capacity axis: any C
//   works. B is read by wgmma MN-major (the transpose bit), so nothing
//   transposes it.
// - Quantised weights cross HBM in their own bytes: the producer loads the
//   raw tile (int8 [64, bn], or packed int4 [32, bn] with the stage's group
//   scale rows [srows, bn] fp32) through unswizzled UINT8 / FLOAT32 maps of
//   [E, K, N], [E, K/2, N] and [E, K/gs, N]. After it lands, the consumer
//   warpgroups widen it into the stage's bf16 tile in the 128-byte-swizzled
//   layout TMA would have written, fence the generic-proxy writes for the
//   async proxy, meet at a barrier and run the same wgmma. The widening is
//   byte permutes and magic-number arithmetic, not one int->float
//   conversion a value (the SMs' conversion rate would cost about the byte
//   bound by itself): a byte q + 128 (or nibble q + 8) permuted under the
//   exponent of 2^23 is the fp32 2^23 + 128 + q, and one subtraction makes
//   it q exactly. int8 then packs two values' upper halves into a bf16 pair
//   (exact, |q| <= 127); int4 multiplies q by its group scale in fp32 and
//   rounds each pair to bf16 (cvt.rn.bf16x2), the plain version's rounding
//   point, so the two differ only in summation order. Any group size works,
//   the whole axis included; a group of 48 straddles the 64-row stages.
//   int8's column scale multiplies the fp32 product in the epilogue, before
//   the activation (x @ (q·s) == (x @ q)·s for a per-channel s).
// - Tiles come from kernels/expert_gemm.py::gemm_plan (E, M, N, K, format):
//   bm 64 or 128 rows, bn 64 or 128 columns, and a split of K into `split`
//   blocks when too few tiles would leave SMs idle (the bf16 decode
//   down-projection: 24 tiles -> 96 blocks). A split writes fp32 partials
//   to a workspace and a second kernel sums them in a fixed order
//   (deterministic, no atomics), applies int8's column scale and the
//   epilogue.
// - Quantised weights at decode (M <= 16 tokens a slot) take the decode tile
//   (sm90_swap_kernel below, bm 8 or 16): the weights are wgmma's A and the
//   tokens its N, two warpgroups widen 64 columns each, and the split
//   blocks of a tile sum in a thread-block cluster. Its note says why.
// - The epilogue applies GELU-tanh, SiLU or ReLU to the fp32 accumulators
//   in registers (tanh and exp from the MUFU unit: their ~2^-11 relative
//   error is far under bf16's rounding), rounds them to bf16 into a padded
//   tile in the drained ring, and writes the rows < M out in 16-byte pieces.
// The tensor maps are encoded on the host per call by cuTensorMapEncodeTiled,
// looked up at run time through the runtime's entry-point query, so the
// library links no libcuda.
#include <cuda.h>

#include <algorithm>
#include <atomic>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;                     // contraction depth of a stage: one 128-byte row
constexpr int SUB = 64;                    // B columns of one TMA box (128 bytes)
constexpr int SUB_BYTES = BK * SUB * 2;    // 8 KB
constexpr int MAX_STAGES = 16;
using rt::allow_smem;
using rt::cluster_sync;
using rt::kFp;
using rt::kInt4;
using rt::kInt8;
using rt::ld_cluster;
using rt::MAX_DEVICES;
using rt::MAX_SMEM;

template <int BM, int BN, bool GLU, int FMT>
struct Cfg {
  static constexpr int NC = BM / 64;                  // consumer warpgroups
  static constexpr int THREADS = NC * 128 + 32;       // + one producer warp
  static constexpr int NB = GLU ? 2 : 1;              // weight tiles a stage
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;         // the bf16 tile wgmma reads
  // the raw tile as it crosses HBM: int8 [BK, BN], or int4 [BK / 2, BN]
  static constexpr int RAW_BYTES = FMT == kInt8 ? BK * BN : FMT == kInt4 ? BK / 2 * BN : 0;
  static constexpr int RAW_OFF = A_BYTES + NB * B_BYTES;
  static constexpr int SC_OFF = RAW_OFF + NB * RAW_BYTES;   // int4 group scales [srows, BN]
  // a stage, 1024-aligned for the swizzle; srows scale rows a weight tile
  __host__ __device__ static constexpr int stage(int srows) {
    return (SC_OFF + (FMT == kInt4 ? NB * srows * BN * 4 : 0) + 1023) / 1024 * 1024;
  }
  // the bytes TMA lands in a stage
  __host__ __device__ static constexpr int tx(int srows) {
    return A_BYTES +
           NB * (FMT == kFp ? B_BYTES : RAW_BYTES + (FMT == kInt4 ? srows * BN * 4 : 0));
  }
  // the ring, its alignment slack and its barriers
  __host__ __device__ static constexpr int smem(int stages, int srows) {
    return stages * stage(srows) + 1024 + 2 * stages * 8;
  }
};

// the most group-scale rows [k0 / gs, (k0 + BK - 1) / gs] a stage of BK
// contraction rows touches; kernels/expert_gemm.py::scale_rows is the same
inline int scale_rows(int K, int gs) {
  int r = 1;
  for (int k0 = 0; k0 < K; k0 += BK) r = std::max(r, (k0 + BK - 1) / gs - k0 / gs + 1);
  return r;
}

// ---------------------------------------------------------------------------
// mbarrier, TMA and wgmma primitives (PTX)
// ---------------------------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(rt::smem_u32(bar)), "r"(count)
               : "memory");
}

// arrive once and expect `bytes` of TMA traffic before the phase completes
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   rt::smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(rt::smem_u32(bar)) : "memory");
}

// wait until the phase of parity `parity` has completed; a phase that never
// completes (a lost arrival) traps after ~2^26 polls instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = rt::smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (polls == (1u << 26)) __trap();
  }
}

// one box of a 3-D tensor map into shared memory; completion lands on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(rt::smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(rt::smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// shared-memory matrix descriptor of a 128-byte-swizzled operand: lbo and sbo
// in bytes (for K-major A the 8-row group stride is sbo and lbo is unused;
// for MN-major B, lbo steps 64 columns and sbo 8 contraction rows)
__device__ __forceinline__ uint64_t sw128_desc(const void* p, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((rt::smem_u32(p) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the consumer warpgroups' own barrier (the producer warp has left)
template <int THREADS>
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(THREADS) : "memory");
}

// the activations on the tensor-core path, whose output is bf16: the tanh
// and exp of the MUFU unit (relative error ~2^-11, far under bf16's 2^-8)
__device__ __forceinline__ float tanh_approx(float x) {
  float y;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float activate_bf16(float h, int act) {
  if (act == rt::kSilu) return __fdividef(h, 1.0f + __expf(-h));
  if (act == rt::kGelu) {
    const float c = 0.7978845608028654f;  // sqrt(2/pi), as rt::activate
    return 0.5f * h * (1.0f + tanh_approx(c * (h + 0.044715f * h * h * h)));
  }
  const float r = fmaxf(h, 0.0f);
  return act == rt::kRelu2 ? r * r : r;
}

// pins the accumulators at this point of the program, so the compiler moves
// none of them while a wgmma that writes them is in flight
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d += A(64 x 16, K-major) · B(16 x BN, MN-major), both from shared memory
template <int BN> struct Wgmma;

template <> struct Wgmma<64> {
  __device__ static __forceinline__ void mma(float (&d)[32], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <> struct Wgmma<128> {
  __device__ static __forceinline__ void mma(float (&d)[64], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
          "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
          "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
          "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
          "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(1));
  }
};

// ---------------------------------------------------------------------------
// widening a landed int8 / int4 tile into the bf16 tile wgmma reads
// ---------------------------------------------------------------------------
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

// byte I of x (an offset value u in 0..255) as the fp32 2^23 + u: the byte
// becomes the low mantissa bits under the exponent of 2^23 (0x4B000000)
template <int I>
__device__ __forceinline__ float magic(uint32_t x) {
  return __uint_as_float(prmt(x, 0x4B000000u, 0x7440u | I));
}

// two fp32 values that are exact in bf16, as a bf16 pair (lo in the low
// half): their upper halves, one permute
__device__ __forceinline__ uint32_t hi_halves(float lo, float hi) {
  return prmt(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

// bytes I, I + 1 of w (two's complement int8) as a bf16 pair, exactly
template <int I>
__device__ __forceinline__ uint32_t int8_pair(uint32_t x) {   // x = w ^ 0x80808080
  constexpr float kBias = 8388608.f + 128.f;                    // 2^23 + 128
  return hi_halves(magic<I>(x) - kBias, magic<I + 1>(x) - kBias);
}

// bytes I, I + 1 of x (nibbles q + 8, one a byte) as q · s in fp32, rounded
// to a bf16 pair as the plain version rounds them
template <int I>
__device__ __forceinline__ uint32_t int4_pair(uint32_t x, float s0, float s1) {
  constexpr float kBias = 8388608.f + 8.f;                      // 2^23 + 8
  return rt::pack_bf16((magic<I>(x) - kBias) * s0, (magic<I + 1>(x) - kBias) * s1);
}

// floor(a / b) for 0 <= a < 2^24, b >= 1, from b's fp32 reciprocal
__device__ __forceinline__ int div_floor(int a, int b, float inv) {
  int q = __float2int_rz(__int2float_rn(a) * inv);
  q += (q + 1) * b <= a;
  q -= q * b > a;
  return q;
}

// byte offset of 8 bf16 columns (16 bytes) of contraction row k in a bf16
// tile of 64-column boxes of 64 rows x 128 bytes: 16-byte chunks
// XOR-swizzled by k % 8, as TMA's 128-byte swizzle writes them (the boxes
// are 1024-aligned)
__device__ __forceinline__ int swizzled(int k, int c8) {
  return (c8 >> 3) * SUB_BYTES + k * 128 + (((c8 & 7) ^ (k & 7)) << 4);
}

// int8 unit: 8 columns of one row (8 bytes, two's complement) widened into
// one 16-byte bf16 chunk
__device__ __forceinline__ void widen_int8(const uint8_t* raw, uint8_t* dst) {
  const uint2 v = *reinterpret_cast<const uint2*>(raw);
  const uint32_t x0 = v.x ^ 0x80808080u, x1 = v.y ^ 0x80808080u;
  *reinterpret_cast<uint4*>(dst) =
      make_uint4(int8_pair<0>(x0), int8_pair<2>(x0), int8_pair<0>(x1), int8_pair<2>(x1));
}

// int4 unit: 4 columns of one packed row (4 bytes: rows 2p and 2p + 1,
// low nibble first) widened into two 8-byte bf16 pieces, each value times
// its group's scale (a for row 2p, c for row 2p + 1)
__device__ __forceinline__ void widen_int4(const uint8_t* raw, const float4& a, const float4& c,
                                           uint8_t* dst0, uint8_t* dst1) {
  const uint32_t x = *reinterpret_cast<const uint32_t*>(raw) ^ 0x88888888u;   // nibbles q + 8
  const uint32_t lo = x & 0x0F0F0F0Fu, hi = (x >> 4) & 0x0F0F0F0Fu;            // rows 2p, 2p + 1
  *reinterpret_cast<uint2*>(dst0) = make_uint2(int4_pair<0>(lo, a.x, a.y), int4_pair<2>(lo, a.z, a.w));
  *reinterpret_cast<uint2*>(dst1) = make_uint2(int4_pair<0>(hi, c.x, c.y), int4_pair<2>(hi, c.z, c.w));
}

// the scale rows of the groups of contraction rows k and k + 1 (k even),
// counted from group g_base, for a group size gs that does not divide 64
__device__ __forceinline__ int2 group_rows(int k, int gs, float inv_gs, int g_base) {
  const int g0 = div_floor(k, gs, inv_gs) - g_base;
  return make_int2(g0, g0 + (k + 1 == (g_base + g0 + 1) * gs));   // row k + 1 opens a group
}

// NT threads widen a landed raw weight tile of a stage whose first row is
// kr into the bf16 tile at bf (COLS / 64 boxes of 64 rows): raw is int8
// [64, COLS], or int4 packed [32, COLS] with its group scales scl [srows,
// COLS] fp32 from group kr / gs on
template <int FMT, int COLS, int NT>
__device__ __forceinline__ void widen_tile(uint8_t* bf, const uint8_t* raw, const float* scl,
                                           int kr, int gs, float inv_gs, int tid) {
  constexpr int UNITS = BK * COLS / 8;
  static_assert(UNITS % NT == 0, "whole units a thread");
  if constexpr (FMT == kInt8) {
#pragma unroll
    for (int i = 0; i < UNITS / NT; ++i) {
      const int u = tid + i * NT, k = u / (COLS / 8), c8 = u % (COLS / 8);
      widen_int8(raw + k * COLS + c8 * 8, bf + swizzled(k, c8));
    }
  } else {
    const bool one_group = gs % BK == 0;   // the stage lies in one group: scale row 0
    const int g_base = one_group ? 0 : div_floor(kr, gs, inv_gs);
#pragma unroll
    for (int i = 0; i < UNITS / NT; ++i) {
      const int u = tid + i * NT, p = u / (COLS / 4), c4 = u % (COLS / 4);
      const int2 g = one_group ? make_int2(0, 0) : group_rows(kr + 2 * p, gs, inv_gs, g_base);
      const int half = (c4 & 1) * 8;   // bytes into the 16-byte chunk
      widen_int4(raw + p * COLS + c4 * 4,
                 *reinterpret_cast<const float4*>(scl + g.x * COLS + c4 * 4),
                 *reinterpret_cast<const float4*>(scl + g.y * COLS + c4 * 4),
                 bf + swizzled(2 * p, c4 >> 1) + half, bf + swizzled(2 * p + 1, c4 >> 1) + half);
    }
  }
}

// ---------------------------------------------------------------------------
// the GEMM: grid (N / BN, ceil(M / BM), E * split)
// ---------------------------------------------------------------------------
// tm_b / tm_b2: the weights (bf16 with 128-byte swizzle, or raw int8 / packed
// int4 bytes); tm_s / tm_s2: int4's group scales; sc / sc2: int8's column
// scales [E, N]; srows: int4 scale rows a stage (1 otherwise)
template <int BM, int BN, bool GLU, int FMT>
__global__ void __launch_bounds__(Cfg<BM, BN, GLU, FMT>::THREADS)
sm90_gemm_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                 const __grid_constant__ CUtensorMap tm_b2,
                 const __grid_constant__ CUtensorMap tm_s,
                 const __grid_constant__ CUtensorMap tm_s2, const float* __restrict__ sc,
                 const float* __restrict__ sc2, bf16* __restrict__ C, float* __restrict__ ws,
                 int E, int M, int N, int kblocks, int split, int stages, int srows, int gs,
                 int epi, int act) {
  using G = Cfg<BM, BN, GLU, FMT>;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: stages start on that boundary
  uint8_t* smem = smem_raw + ((1024 - (rt::smem_u32(smem_raw) & 1023)) & 1023);
  const int stage = G::stage(srows);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * stage);
  uint64_t* empty = full + stages;

  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int e = blockIdx.z / split, ks = blockIdx.z % split;
  const int kb0 = ks * kblocks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], G::NC * 4);   // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= G::NC * 128) {   // producer warp: one lane issues every load
    if (threadIdx.x == G::NC * 128) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_a)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_b)) : "memory");
      const int tx = G::tx(srows);
      for (int kb = 0, s = 0, ph = 0; kb < kblocks; ++kb) {
        mbar_wait(&empty[s], ph ^ 1);
        uint8_t* st = smem + s * stage;
        mbar_expect_tx(&full[s], tx);
        const int k0 = (kb0 + kb) * BK;
        tma_load_3d(st, &tm_a, &full[s], k0, m0, e);
        if constexpr (FMT == kFp) {
#pragma unroll
          for (int j = 0; j < BN / SUB; ++j) {
            tma_load_3d(st + G::A_BYTES + j * SUB_BYTES, &tm_b, &full[s], n0 + j * SUB, k0, e);
            if constexpr (GLU)
              tma_load_3d(st + G::A_BYTES + G::B_BYTES + j * SUB_BYTES, &tm_b2, &full[s],
                          n0 + j * SUB, k0, e);
          }
        } else {   // one box of raw weight bytes a tile, and int4's scale rows
          const int row = FMT == kInt8 ? k0 : k0 / 2;
          tma_load_3d(st + G::RAW_OFF, &tm_b, &full[s], n0, row, e);
          if constexpr (GLU) tma_load_3d(st + G::RAW_OFF + G::RAW_BYTES, &tm_b2, &full[s], n0, row, e);
          if constexpr (FMT == kInt4) {
            tma_load_3d(st + G::SC_OFF, &tm_s, &full[s], n0, k0 / gs, e);
            if constexpr (GLU)
              tma_load_3d(st + G::SC_OFF + srows * BN * 4, &tm_s2, &full[s], n0, k0 / gs, e);
          }
        }
        if (++s == stages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows wg·64 .. wg·64 + 63 of the tile
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const float inv_gs = 1.0f / (float)gs;
  float acc[BN / 2], accg[GLU ? BN / 2 : 1];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (GLU ? BN / 2 : 1); ++i) accg[i] = 0.f;

  for (int kb = 0, s = 0, ph = 0, prev = 0; kb < kblocks; ++kb) {
    mbar_wait(&full[s], ph);
    uint8_t* st = smem + s * stage;
    if constexpr (FMT != kFp) {
      // widen the landed bytes into the bf16 tile, make the generic-proxy
      // writes visible to wgmma (the async proxy), and wait for the whole tile
#pragma unroll
      for (int t = 0; t < G::NB; ++t)
        widen_tile<FMT, BN, G::NC * 128>(
            st + G::A_BYTES + t * G::B_BYTES, st + G::RAW_OFF + t * G::RAW_BYTES,
            reinterpret_cast<const float*>(st + G::SC_OFF) + t * srows * BN, (kb0 + kb) * BK,
            gs, inv_gs, threadIdx.x);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      consumer_sync<G::NC * 128>();
    }
    fence_regs(acc);
    if constexpr (GLU) fence_regs(accg);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // A: 16 contraction columns = 32 bytes along each 128-byte row;
      // B: 16 contraction rows = 2048 bytes down each 64-column box
      const uint64_t da = sw128_desc(st + wg * 64 * BK * 2 + kk * 32, 16, 1024);
      Wgmma<BN>::mma(acc, da, sw128_desc(st + G::A_BYTES + kk * 2048, SUB_BYTES, 1024));
      if constexpr (GLU)
        Wgmma<BN>::mma(accg, da,
                       sw128_desc(st + G::A_BYTES + G::B_BYTES + kk * 2048, SUB_BYTES, 1024));
    }
    wgmma_commit();
    wgmma_wait<1>();   // the stage before this one is read: hand it back
    fence_regs(acc);
    if constexpr (GLU) fence_regs(accg);
    if (kb > 0 && lane == 0) mbar_arrive(&empty[prev]);
    prev = s;
    if (++s == stages) {
      s = 0;
      ph ^= 1;
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if constexpr (GLU) fence_regs(accg);

  // accumulator i of n8 block j: row (lane / 4) [+ 8 for i % 4 >= 2],
  // column 8j + 2 (lane % 4) [+ 1 for odd i], of this warp's 16 rows
  const int lrow = wg * 64 + warp * 16 + (lane >> 2), lcol = 2 * (lane & 3);
  if (ws != nullptr) {   // split: fp32 partials, summed (and scaled) by splitk_reduce_kernel
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + lrow + half * 8;
        if (row < M)
          *reinterpret_cast<float2*>(ws + ((size_t)(ks * E + e) * M + row) * N + n0 + lcol + 8 * j) =
              make_float2(acc[4 * j + 2 * half], acc[4 * j + 2 * half + 1]);
      }
    return;
  }
  // The bf16 tile goes out through shared memory, so that it leaves in whole
  // 16-byte row pieces instead of 4-byte scraps of eight rows a store. Every
  // consumer warpgroup is past its last wgmma first: the ring becomes the
  // tile [BM][BN + 8] (the padding spreads a warp's eight rows over the banks).
  constexpr int LDC = BN + 8;
  static_assert(BM * LDC * 2 <= 2 * (G::A_BYTES + G::B_BYTES), "the C tile must fit two stages");
  bf16* tile = reinterpret_cast<bf16*>(smem);
  consumer_sync<G::NC * 128>();
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    float2 s = make_float2(1.f, 1.f), s2 = s;   // int8's column scales
    if constexpr (FMT == kInt8) {
      s = *reinterpret_cast<const float2*>(sc + (size_t)e * N + n0 + lcol + 8 * j);
      if constexpr (GLU) s2 = *reinterpret_cast<const float2*>(sc2 + (size_t)e * N + n0 + lcol + 8 * j);
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float v0 = acc[4 * j + 2 * half] * s.x, v1 = acc[4 * j + 2 * half + 1] * s.y;
      if constexpr (GLU) {
        v0 *= activate_bf16(accg[4 * j + 2 * half] * s2.x, act);
        v1 *= activate_bf16(accg[4 * j + 2 * half + 1] * s2.y, act);
      } else if (epi == rt::kAct) {
        v0 = activate_bf16(v0, act);
        v1 = activate_bf16(v1, act);
      }
      *reinterpret_cast<__nv_bfloat162*>(tile + (lrow + half * 8) * LDC + lcol + 8 * j) =
          __floats2bfloat162_rn(v0, v1);
    }
  }
  consumer_sync<G::NC * 128>();
  constexpr int CHUNKS = BN / 8;   // 16-byte pieces a row
  for (int i = threadIdx.x; i < BM * CHUNKS; i += G::NC * 128) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    if (m0 + r < M)
      *reinterpret_cast<uint4*>(C + ((size_t)e * M + m0 + r) * N + n0 + c) =
          *reinterpret_cast<const uint4*>(tile + r * LDC + c);
  }
}

// ---------------------------------------------------------------------------
// the decode tile of quantised weights (swap AB): grid (N / 128, 1, E * split)
// ---------------------------------------------------------------------------
// d += A(64 x 16, MN-major) · B(16 x N, K-major): the weights as A (64 output
// columns of the layer, read through the transpose bit), the NTOK token
// rows as B
template <int NTOK> struct WgmmaT;

template <> struct WgmmaT<8> {
  __device__ static __forceinline__ void mma(float (&d)[4], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %6, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {%0, %1, %2, %3}, %4, %5, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "l"(da), "l"(db), "r"(1));
  }
};

template <> struct WgmmaT<16> {
  __device__ static __forceinline__ void mma(float (&d)[8], uint64_t da, uint64_t db) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
          "+f"(d[7])
        : "l"(da), "l"(db), "r"(1));
  }
};

// Shared memory of the decode tile: each consumer warpgroup's ring of BUFS
// bf16 boxes a weight tile (64 contraction rows x its 64 columns, swizzled),
// then the TMA ring, whose stages hold only the NTOK x 64 token tile and the
// raw bytes, the barriers, and int8's staged column scales.
template <int NTOK, bool GLU, int FMT>
struct SwapCfg {
  static constexpr int BN = 128;   // output columns a block: 128-byte rows of raw weights
  static constexpr int NW = BN / 64;                  // consumer warpgroups: 64 columns each
  static constexpr int THREADS = NW * 128 + 32;       // + a producer warp
  static constexpr int NB = GLU ? 2 : 1;
  static constexpr int BUFS = 3;   // a box is rewritten two stages after its wgmma was waited
  static constexpr int BUF_BYTES = NW * NB * BUFS * SUB_BYTES;
  static constexpr int X_BYTES = NTOK * BK * 2;
  static constexpr int RAW_BYTES = FMT == kInt8 ? BK * BN : BK / 2 * BN;
  static constexpr int RAW_OFF = (X_BYTES + 1023) / 1024 * 1024;
  static constexpr int SC_OFF = RAW_OFF + NB * RAW_BYTES;
  __host__ __device__ static constexpr int stage(int srows) {
    return (SC_OFF + (FMT == kInt4 ? NB * srows * BN * 4 : 0) + 1023) / 1024 * 1024;
  }
  __host__ __device__ static constexpr int tx(int srows) {
    return X_BYTES + NB * (RAW_BYTES + (FMT == kInt4 ? srows * BN * 4 : 0));
  }
  static constexpr int SCALE_BYTES = NB * BN * 4;   // int8's column scales, staged
  __host__ __device__ static constexpr int smem(int stages, int srows) {
    return BUF_BYTES + stages * stage(srows) + 2 * stages * 8 + SCALE_BYTES + 1024;
  }
};

// At decode (M <= NTOK tokens a slot, 8 or 16) the 64-row tile of the kernel
// above would leave 7/8 of each product idle and spend a third of a stage
// on zero rows. Here the weights are wgmma's A and the tokens its N. A
// block owns 128 output columns, so each raw row it loads is 128 bytes
// (HBM serves 64-byte row pieces at a third of its rate), and each of its
// two consumer warpgroups widens its own 64 columns into its own box ring
// and waits only for its own 128 threads. Widening is what bounds the
// tile once the bytes stream (about 6 instructions a value, issue-bound):
// its per-thread offsets are fixed before the loop, and the plan splits K
// so that the stages the busiest SM widens are few. The split blocks of a
// tile form a thread-block cluster: each keeps its fp32 partial tile in
// shared memory, and block r sums its share of the tile over the cluster's
// blocks in rank order through distributed shared memory (reruns are
// bit-identical), then applies the epilogue. So the split costs no
// workspace and no second launch. The accumulators are the transposed
// tile: row = output column, column = token.
template <int NTOK, bool GLU, int FMT>
__global__ void __launch_bounds__(SwapCfg<NTOK, GLU, FMT>::THREADS)
sm90_swap_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_b,
                 const __grid_constant__ CUtensorMap tm_b2,
                 const __grid_constant__ CUtensorMap tm_s,
                 const __grid_constant__ CUtensorMap tm_s2, const float* __restrict__ sc,
                 const float* __restrict__ sc2, bf16* __restrict__ C, int E, int M, int N,
                 int kblocks, int split, int stages, int srows, int gs, int epi, int act) {
  using G = SwapCfg<NTOK, GLU, FMT>;
  constexpr int BN = G::BN, NC = G::NW * 128;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (rt::smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* ring = smem + G::BUF_BYTES;
  const int stage = G::stage(srows);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + stages * stage);
  uint64_t* empty = full + stages;
  float* scs = reinterpret_cast<float*>(empty + stages);   // int8's column scales [NB][BN]

  const int n0 = blockIdx.x * BN;
  const int e = blockIdx.z / split, ks = blockIdx.z % split;   // ks: the rank in the cluster
  const int kb0 = ks * kblocks;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC / 32);   // lane 0 of every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if constexpr (FMT == kInt8) {   // read after the loop, loaded ahead of it
    if (threadIdx.x < BN) {
      scs[threadIdx.x] = sc[(size_t)e * N + n0 + threadIdx.x];
      if constexpr (GLU) scs[BN + threadIdx.x] = sc2[(size_t)e * N + n0 + threadIdx.x];
    }
  }
  __syncthreads();

  // the partial tile [NTOK][BN] fp32 (the gate's after it), in the box
  // rings once every warpgroup's last wgmma is waited
  float* part = reinterpret_cast<float*>(smem);
  constexpr int TILE_N = NTOK * BN;
  static_assert((GLU ? 2 : 1) * TILE_N * 4 <= G::BUF_BYTES, "the partials must fit the boxes");
  if (threadIdx.x >= NC) {   // producer warp: one lane issues every load
    if (threadIdx.x == NC) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_x)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&tm_b)) : "memory");
      const int tx = G::tx(srows);
      for (int kb = 0, s = 0, ph = 0; kb < kblocks; ++kb) {
        mbar_wait(&empty[s], ph ^ 1);
        uint8_t* st = ring + s * stage;
        mbar_expect_tx(&full[s], tx);
        const int k0 = (kb0 + kb) * BK;
        tma_load_3d(st, &tm_x, &full[s], k0, 0, e);
        const int row = FMT == kInt8 ? k0 : k0 / 2;
        tma_load_3d(st + G::RAW_OFF, &tm_b, &full[s], n0, row, e);
        if constexpr (GLU) tma_load_3d(st + G::RAW_OFF + G::RAW_BYTES, &tm_b2, &full[s], n0, row, e);
        if constexpr (FMT == kInt4) {
          tma_load_3d(st + G::SC_OFF, &tm_s, &full[s], n0, k0 / gs, e);
          if constexpr (GLU)
            tma_load_3d(st + G::SC_OFF + srows * BN * 4, &tm_s2, &full[s], n0, k0 / gs, e);
        }
        if (++s == stages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    __syncwarp();
  } else {
    // warpgroup f: columns 64f .. 64f + 63
    const int f = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
    const int tid = threadIdx.x & 127;
    const float inv_gs = 1.0f / (float)gs;
    auto box = [&](int t, int b) { return smem + ((f * G::NB + t) * G::BUFS + b) * SUB_BYTES; };
    // this thread's units, the same every stage: byte offsets of its raw
    // bytes and scales in a stage and of its bf16 pieces in a box. int8:
    // 8 columns of one row; int4: 4 columns of one packed row (rows 2p, 2p + 1)
    constexpr int UNITS = BK * 64 / 8 / 128;
    int roff[UNITS], soff[UNITS], d0[UNITS], d1[UNITS], rloc[UNITS];
#pragma unroll
    for (int i = 0; i < UNITS; ++i) {
      const int u = tid + i * 128;
      if constexpr (FMT == kInt8) {
        const int k = u / 8, c8 = u % 8;
        roff[i] = G::RAW_OFF + k * BN + 64 * f + c8 * 8;
        d0[i] = swizzled(k, c8);
        soff[i] = d1[i] = rloc[i] = 0;
      } else {
        const int p = u / 16, c4 = u % 16, k = 2 * p;
        roff[i] = G::RAW_OFF + p * BN + 64 * f + c4 * 4;
        soff[i] = G::SC_OFF + (64 * f + c4 * 4) * 4;
        d0[i] = swizzled(k, c4 >> 1) + (c4 & 1) * 8;
        d1[i] = swizzled(k + 1, c4 >> 1) + (c4 & 1) * 8;
        rloc[i] = k;
      }
    }
    const bool one_group = gs % BK == 0;   // every stage lies in one group: scale row 0
    float acc[NTOK / 2], accg[GLU ? NTOK / 2 : 1];
#pragma unroll
    for (int i = 0; i < NTOK / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < (GLU ? NTOK / 2 : 1); ++i) accg[i] = 0.f;

    for (int kb = 0, s = 0, ph = 0, prev = 0, b = 0; kb < kblocks; ++kb) {
      mbar_wait(&full[s], ph);
      const uint8_t* st = ring + s * stage;
      const int kr = (kb0 + kb) * BK;
      const int g_base = FMT == kInt4 && !one_group ? div_floor(kr, gs, inv_gs) : 0;
#pragma unroll
      for (int t = 0; t < G::NB; ++t) {
        const uint8_t* raw = st + t * G::RAW_BYTES;
        const uint8_t* scl = st + t * srows * BN * 4;
        uint8_t* bx = box(t, b);
#pragma unroll
        for (int i = 0; i < UNITS; ++i) {
          if constexpr (FMT == kInt8) {
            widen_int8(raw + roff[i], bx + d0[i]);
          } else {
            const int2 g = one_group ? make_int2(0, 0) : group_rows(kr + rloc[i], gs, inv_gs, g_base);
            widen_int4(raw + roff[i], *reinterpret_cast<const float4*>(scl + soff[i] + g.x * BN * 4),
                       *reinterpret_cast<const float4*>(scl + soff[i] + g.y * BN * 4), bx + d0[i],
                       bx + d1[i]);
          }
        }
      }
      // the generic-proxy writes, visible to wgmma (the async proxy); the box is whole
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" ::"r"(1 + f) : "memory");
      fence_regs(acc);
      if constexpr (GLU) fence_regs(accg);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        // A: 16 rows = 2048 bytes down the box; B: the same 16 contraction
        // columns, 32 bytes along each token's 128-byte row
        const uint64_t db = sw128_desc(st + kk * 32, 16, 1024);
        WgmmaT<NTOK>::mma(acc, sw128_desc(box(0, b) + kk * 2048, SUB_BYTES, 1024), db);
        if constexpr (GLU)
          WgmmaT<NTOK>::mma(accg, sw128_desc(box(1, b) + kk * 2048, SUB_BYTES, 1024), db);
      }
      wgmma_commit();
      wgmma_wait<1>();   // the stage before this one is read: hand it back
      fence_regs(acc);
      if constexpr (GLU) fence_regs(accg);
      if (kb > 0 && lane == 0) mbar_arrive(&empty[prev]);
      prev = s;
      if (++s == stages) {
        s = 0;
        ph ^= 1;
      }
      if (++b == G::BUFS) b = 0;
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if constexpr (GLU) fence_regs(accg);
    asm volatile("bar.sync 3, %0;\n" ::"n"(NC) : "memory");   // every warpgroup is past its last wgmma
    // accumulator i of n8 block j: output column (lane / 4) [+ 8 for i % 4 >= 2]
    // of this warp's 16, token 8j + 2 (lane % 4) [+ 1 for odd i]
#pragma unroll
    for (int i = 0; i < NTOK / 2; ++i) {
      const int tok = 8 * (i / 4) + 2 * (lane & 3) + (i & 1);
      const int col = 64 * f + warp * 16 + (lane >> 2) + 8 * ((i >> 1) & 1);
      part[tok * BN + col] = acc[i];
      if constexpr (GLU) part[TILE_N + tok * BN + col] = accg[i];
    }
  }
  // every block's partial tiles are whole (a cluster of one: this block's)
  if (split > 1) cluster_sync();
  else __syncthreads();
  // block ks sums elements [ks, ks + 1) · TILE_N / split of the tile over
  // the cluster's blocks, in rank order
  const int share = TILE_N / split;
  for (int i = ks * share + threadIdx.x; i < (ks + 1) * share; i += G::THREADS) {
    const int tok = i / BN, col = i % BN;
    if (tok >= M) continue;
    float v = part[i];   // split 1: this block's own
    if (split > 1) {
      v = ld_cluster(part + i, 0);
      for (int r = 1; r < split; ++r) v += ld_cluster(part + i, r);
    }
    if constexpr (FMT == kInt8) v *= scs[col];
    if constexpr (GLU) {   // split 1: the gate's partial is this block's own
      float g = part[TILE_N + i];
      if constexpr (FMT == kInt8) g *= scs[BN + col];
      v *= activate_bf16(g, act);
    } else if (epi == rt::kAct) {
      v = activate_bf16(v, act);
    }
    C[((size_t)e * M + tok) * N + n0 + col] = __float2bfloat16_rn(v);
  }
  if (split > 1) cluster_sync();   // no block leaves while another still reads its partials
}

// C = epilogue(sum over s of ws[s], times int8's column scale sc [E, N]
// where sc is not null), s in order; n4 = E·M·N / 4, MN = M·N
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float4* __restrict__ ws, const float* __restrict__ sc,
                     bf16* __restrict__ C, int n4, int MN, int N, int split, int epi, int act) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += gridDim.x * blockDim.x) {
    float4 v = ws[i];
    for (int s = 1; s < split; ++s) {
      const float4 p = ws[(size_t)s * n4 + i];
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
    }
    if (sc != nullptr) {   // four columns of one row: N % 4 == 0
      const int flat = 4 * i;
      const float4 s = *reinterpret_cast<const float4*>(sc + (size_t)(flat / MN) * N + flat % N);
      v.x *= s.x;
      v.y *= s.y;
      v.z *= s.z;
      v.w *= s.w;
    }
    if (epi == rt::kAct) {
      v.x = activate_bf16(v.x, act);
      v.y = activate_bf16(v.y, act);
      v.z = activate_bf16(v.z, act);
      v.w = activate_bf16(v.w, act);
    }
    __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(C) + 2 * (size_t)i;
    out[0] = __floats2bfloat162_rn(v.x, v.y);
    out[1] = __floats2bfloat162_rn(v.z, v.w);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_fn() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// a tensor [E, rows, cols] (cols contiguous) of `type` (esize bytes an
// element) read in boxes of box_rows x box_cols of one slot; out-of-range
// rows and columns read as zeros. bf16 operands are 128-byte swizzled in
// boxes of 64 columns; raw weight bytes and scales land unswizzled
bool encode_3d(CUtensorMap* map, CUtensorMapDataType type, int esize, const void* ptr, int E,
               int rows, int cols, int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * esize, (cuuint64_t)rows * cols * esize};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool encode_bf16(CUtensorMap* map, const void* ptr, int E, int rows, int cols, int box_rows) {
  return encode_3d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, ptr, E, rows, cols, SUB, box_rows,
                   CU_TENSOR_MAP_SWIZZLE_128B);
}

// the maps of one weight tensor: bf16 [E, K, N]; int8 [E, K, N]; packed
// int4 [E, K/2, N] with its group scales [E, K/gs, N] fp32 in `ms`
bool encode_weights(CUtensorMap* mb, CUtensorMap* ms, int fmt, const void* w, const float* scale,
                    int E, int N, int K, int gs, int bn, int srows) {
  if (fmt == kFp) return encode_bf16(mb, w, E, K, N, BK);
  if (fmt == kInt8)
    return encode_3d(mb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, E, K, N, bn, BK,
                     CU_TENSOR_MAP_SWIZZLE_NONE);
  return encode_3d(mb, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, E, K / 2, N, bn, BK / 2,
                   CU_TENSOR_MAP_SWIZZLE_NONE) &&
         encode_3d(ms, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, scale, E, K / gs, N, bn, srows,
                   CU_TENSOR_MAP_SWIZZLE_NONE);
}

struct Args {
  CUtensorMap ma, mb, mb2, ms, ms2;
  const float *sc, *sc2;   // int8's column scales
  bf16* c;
  float* ws;
  int E, M, N, K, split, stages, srows, gs, epi, act;
};

template <int BM, int BN, bool GLU, int FMT>
cudaError_t launch(const Args& g, cudaStream_t s) {
  using G = Cfg<BM, BN, GLU, FMT>;
  const int smem = G::smem(g.stages, g.srows);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  static std::atomic<bool> attr_set[MAX_DEVICES];
  const cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(sm90_gemm_kernel<BM, BN, GLU, FMT>), attr_set);
  if (err != cudaSuccess) return err;
  const dim3 grid(g.N / BN, (g.M + BM - 1) / BM, g.E * g.split);
  sm90_gemm_kernel<BM, BN, GLU, FMT><<<grid, G::THREADS, smem, s>>>(
      g.ma, g.mb, g.mb2, g.ms, g.ms2, g.sc, g.sc2, g.c, g.ws, g.E, g.M, g.N,
      g.K / BK / g.split, g.split, g.stages, g.srows, g.gs, g.epi, g.act);
  return cudaGetLastError();
}

// the decode tile: the split blocks of each (column tile, slot) are one
// cluster of `split` blocks along z
template <int NTOK, bool GLU, int FMT>
cudaError_t launch_swap(const Args& g, cudaStream_t s) {
  using G = SwapCfg<NTOK, GLU, FMT>;
  const int smem = G::smem(g.stages, g.srows);
  if (smem > MAX_SMEM || g.split > 8 || (GLU && g.split != 1)) return cudaErrorInvalidValue;
  static std::atomic<bool> attr_set[MAX_DEVICES];
  cudaError_t err =
      allow_smem(reinterpret_cast<const void*>(sm90_swap_kernel<NTOK, GLU, FMT>), attr_set);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(g.N / G::BN, 1, g.E * g.split);
  cfg.blockDim = dim3(G::THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = g.split;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, sm90_swap_kernel<NTOK, GLU, FMT>, g.ma, g.mb, g.mb2, g.ms, g.ms2,
                           g.sc, g.sc2, g.c, g.E, g.M, g.N, g.K / BK / g.split, g.split, g.stages,
                           g.srows, g.gs, g.epi, g.act);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// bm 8 or 16: the decode tile of quantised weights (bn 128); else bm 64 or
// 128 rows of the tile above
template <int FMT>
cudaError_t launch_tile(const Args& g, int bm, int bn, bool glu, cudaStream_t s) {
  if constexpr (FMT != kFp) {
    if (bm == 8) return glu ? launch_swap<8, true, FMT>(g, s) : launch_swap<8, false, FMT>(g, s);
    if (bm == 16) return glu ? launch_swap<16, true, FMT>(g, s) : launch_swap<16, false, FMT>(g, s);
  }
  if (glu) return bm == 64 ? launch<64, 64, true, FMT>(g, s) : launch<128, 64, true, FMT>(g, s);
  if (bm == 64) return bn == 64 ? launch<64, 64, false, FMT>(g, s) : launch<64, 128, false, FMT>(g, s);
  return bn == 64 ? launch<128, 64, false, FMT>(g, s) : launch<128, 128, false, FMT>(g, s);
}

}  // namespace

namespace rt {

int sm90_expert_gemm(int fmt, const void* a, const void* b, const float* bs, const void* b2,
                     const float* b2s, void* c, void* ws, int E, int M, int N, int K, int gs,
                     int bm, int bn, int split, int stages, int epilogue, int act,
                     cudaStream_t stream) {
  const bool glu = epilogue == kGlu;
  const bool swap = bm == 8 || bm == 16;   // the decode tile: quantised, M <= bm, bn 128
  const bool tile = swap ? fmt != kFp && M <= bm && bn == 128 && split <= 8 && (!glu || split == 1)
                         : (bm == 64 || bm == 128) && (bn == 64 || (bn == 128 && !glu));
  const bool scales = fmt == kFp || (bs != nullptr && (!glu || b2s != nullptr));
  const bool ok = tile && (fmt == kFp || fmt == kInt8 || fmt == kInt4) && scales &&
                  (fmt != kInt4 || (gs >= 1 && K % gs == 0)) && N % bn == 0 && split >= 1 &&
                  K % (BK * split) == 0 && stages >= 2 && stages <= MAX_STAGES &&
                  (glu ? b2 != nullptr : true) && (split == 1 || swap || (ws != nullptr && !glu));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || E <= 0) return static_cast<int>(cudaGetLastError());
  Args g;
  g.srows = fmt == kInt4 ? scale_rows(K, gs) : 1;
  if (!encode_bf16(&g.ma, a, E, M, K, bm) ||
      !encode_weights(&g.mb, &g.ms, fmt, b, bs, E, N, K, gs, bn, g.srows))
    return static_cast<int>(cudaErrorInvalidValue);
  if (fmt != kInt4) g.ms = g.mb;   // unread
  if (!glu) {   // unread without the gate
    g.mb2 = g.mb;
    g.ms2 = g.ms;
  } else if (!encode_weights(&g.mb2, &g.ms2, fmt, b2, b2s, E, N, K, gs, bn, g.srows)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (fmt != kInt4) g.ms2 = g.mb;
  g.sc = fmt == kInt8 ? bs : nullptr;
  g.sc2 = fmt == kInt8 ? b2s : nullptr;
  g.c = static_cast<bf16*>(c);
  g.ws = split > 1 && !swap ? static_cast<float*>(ws) : nullptr;
  g.E = E;
  g.M = M;
  g.N = N;
  g.K = K;
  g.split = split;
  g.stages = stages;
  g.gs = fmt == kInt4 ? gs : 1;
  g.epi = epilogue;
  g.act = act;
  cudaError_t err = fmt == kFp     ? launch_tile<kFp>(g, bm, bn, glu, stream)
                    : fmt == kInt8 ? launch_tile<kInt8>(g, bm, bn, glu, stream)
                                   : launch_tile<kInt4>(g, bm, bn, glu, stream);
  if (err != cudaSuccess || split == 1 || swap) return static_cast<int>(err);   // summed in the cluster
  const int n4 = E * M * N / 4;
  const int blocks = (n4 + 255) / 256 < 1024 ? (n4 + 255) / 256 : 1024;
  splitk_reduce_kernel<<<blocks, 256, 0, stream>>>(static_cast<const float4*>(ws), g.sc, g.c, n4,
                                                   M * N, N, split, epilogue, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rt
