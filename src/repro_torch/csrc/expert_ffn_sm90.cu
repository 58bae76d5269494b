// The bf16 slot-stacked expert GEMM on Hopper's TMA and wgmma (sm_90a).
//
// Replaces: src/repro/kernels/expert_gemm.py::expert_ffn (body _ffn_kernel)
// for the bf16 working type; csrc/expert_ffn.cu's rt_expert_gemm sends its
// bf16 calls here. The FFN stays two launches: the up-projection with the
// activation (or the GLU product) in its epilogue writes h once in bf16 —
// the TPU kernel's rounding point, h.astype(x.dtype) — and the
// down-projection reads it back. Accumulation is fp32 over the whole
// contraction (or over each split of it, summed in fp32).
//
// What bounds it on the H100: at the batch shape (E = 4 slots, C = 640,
// d = 768, F = 3072) the two products are 24.2 GFLOP against 45.6 MB of
// operands, ~530 FLOP/byte, above the bf16 ridge (~295): the tensor cores
// bound it, 0.0244 ms at 989 TFLOP/s. At decode (C = 8) they are 0.30 GFLOP
// against 37.7 MB of weights: HBM bound it, 0.0113 ms at 3.35 TB/s.
//
// Design (one block per bm x bn output tile of one slot):
// - A producer warp keeps a ring of STAGES shared-memory stages full with
//   TMA loads; each stage has a full and an empty mbarrier. One or two
//   consumer warpgroups (64 rows each) issue wgmma.mma_async m64n{bn}k16 on
//   the stage that has landed, keep one stage's products in flight, and
//   release the one before. Loads and tensor-core work overlap.
// - A is described to TMA as [E, M, K] and B as [E, K, N] (N contiguous),
//   both with 128-byte swizzle, so a box never crosses into the next slot
//   and TMA's zero fill masks the ragged capacity axis: any C works. B is
//   read by wgmma MN-major (the transpose bit), so nothing transposes it.
// - Tiles come from kernels/expert_gemm.py::gemm_plan (E, M, N, K): bm 64 or
//   128 rows, bn 64 or 128 columns, and a split of K into `split` blocks
//   when too few tiles would leave SMs idle (the decode down-projection:
//   24 tiles -> 96 blocks). A split writes fp32 partials to a workspace
//   and a second kernel sums them in a fixed order (deterministic, no
//   atomics) and applies the epilogue.
// - The epilogue applies GELU-tanh, SiLU or ReLU to the fp32 accumulators
//   in registers (tanh and exp from the MUFU unit: their ~2^-11 relative
//   error is far under bf16's rounding), rounds them to bf16 into a padded
//   tile in the drained ring, and writes the rows < M out in 16-byte pieces.
// The tensor maps are encoded on the host per call by cuTensorMapEncodeTiled,
// looked up at run time through the runtime's entry-point query, so the
// library links no libcuda.
#include <cuda.h>

#include <atomic>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BK = 64;                     // contraction depth of a stage: one 128-byte row
constexpr int SUB = 64;                    // B columns of one TMA box (128 bytes)
constexpr int SUB_BYTES = BK * SUB * 2;    // 8 KB
constexpr int MAX_STAGES = 8;
constexpr int MAX_SMEM = 232448;           // dynamic shared memory a block may use
constexpr int MAX_DEVICES = 64;            // devices a process may launch on

template <int BM, int BN, bool GLU>
struct Cfg {
  static constexpr int NC = BM / 64;                  // consumer warpgroups
  static constexpr int THREADS = NC * 128 + 32;       // + one producer warp
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BYTES = BK * BN * 2;
  static constexpr int STAGE = A_BYTES + (GLU ? 2 : 1) * B_BYTES;
  // the ring, its alignment slack and its barriers
  static constexpr int smem(int stages) { return stages * STAGE + 1024 + 2 * stages * 8; }
};

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
  return fmaxf(h, 0.0f);
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
// the GEMM: grid (N / BN, ceil(M / BM), E * split)
// ---------------------------------------------------------------------------
template <int BM, int BN, bool GLU>
__global__ void __launch_bounds__(Cfg<BM, BN, GLU>::THREADS)
sm90_gemm_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                 const __grid_constant__ CUtensorMap tm_b2, bf16* __restrict__ C,
                 float* __restrict__ ws, int E, int M, int N, int kblocks, int split,
                 int stages, int epi, int act) {
  using G = Cfg<BM, BN, GLU>;
  extern __shared__ uint8_t smem_raw[];
  // 128-byte swizzle repeats every 1024 bytes: stages start on that boundary
  uint8_t* smem = smem_raw + ((1024 - (rt::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + stages * G::STAGE);
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
      for (int kb = 0, s = 0, ph = 0; kb < kblocks; ++kb) {
        mbar_wait(&empty[s], ph ^ 1);
        uint8_t* st = smem + s * G::STAGE;
        mbar_expect_tx(&full[s], G::STAGE);
        const int k0 = (kb0 + kb) * BK;
        tma_load_3d(st, &tm_a, &full[s], k0, m0, e);
#pragma unroll
        for (int j = 0; j < BN / SUB; ++j) {
          tma_load_3d(st + G::A_BYTES + j * SUB_BYTES, &tm_b, &full[s], n0 + j * SUB, k0, e);
          if constexpr (GLU)
            tma_load_3d(st + G::A_BYTES + G::B_BYTES + j * SUB_BYTES, &tm_b2, &full[s],
                        n0 + j * SUB, k0, e);
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
  float acc[BN / 2], accg[GLU ? BN / 2 : 1];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (GLU ? BN / 2 : 1); ++i) accg[i] = 0.f;

  for (int kb = 0, s = 0, ph = 0, prev = 0; kb < kblocks; ++kb) {
    mbar_wait(&full[s], ph);
    const uint8_t* st = smem + s * G::STAGE;
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
  if (ws != nullptr) {   // split: fp32 partials, summed by splitk_reduce_kernel
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
  static_assert(BM * LDC * 2 <= 2 * G::STAGE, "the C tile must fit two stages");
  bf16* tile = reinterpret_cast<bf16*>(smem);
  consumer_sync<G::NC * 128>();
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float v0 = acc[4 * j + 2 * half], v1 = acc[4 * j + 2 * half + 1];
      if constexpr (GLU) {
        v0 *= activate_bf16(accg[4 * j + 2 * half], act);
        v1 *= activate_bf16(accg[4 * j + 2 * half + 1], act);
      } else if (epi == rt::kAct) {
        v0 = activate_bf16(v0, act);
        v1 = activate_bf16(v1, act);
      }
      *reinterpret_cast<__nv_bfloat162*>(tile + (lrow + half * 8) * LDC + lcol + 8 * j) =
          __floats2bfloat162_rn(v0, v1);
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

// C = epilogue(sum over s of ws[s]), s in order; n4 = E·M·N / 4
__global__ void __launch_bounds__(256)
splitk_reduce_kernel(const float4* __restrict__ ws, bf16* __restrict__ C, int n4, int split,
                     int epi, int act) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n4; i += gridDim.x * blockDim.x) {
    float4 v = ws[i];
    for (int s = 1; s < split; ++s) {
      const float4 p = ws[(size_t)s * n4 + i];
      v.x += p.x;
      v.y += p.y;
      v.z += p.z;
      v.w += p.w;
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

// a bf16 tensor [E, rows, cols] (cols contiguous) read in boxes of
// box_rows x 64 columns of one slot, 128-byte swizzled; out-of-range rows
// and columns read as zeros
bool encode_3d(CUtensorMap* map, const void* ptr, int E, int rows, int cols, int box_rows) {
  const EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)E};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2, (cuuint64_t)rows * cols * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM, int BN, bool GLU>
cudaError_t launch(const CUtensorMap& ma, const CUtensorMap& mb, const CUtensorMap& mb2, bf16* c,
                   float* ws, int E, int M, int N, int K, int split, int stages, int epi,
                   int act, cudaStream_t s) {
  using G = Cfg<BM, BN, GLU>;
  if (G::smem(stages) > MAX_SMEM) return cudaErrorInvalidValue;
  // the shared-memory limit is an attribute of the kernel on each device
  static std::atomic<bool> attr_set[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!attr_set[dev].load(std::memory_order_acquire)) {
    err = cudaFuncSetAttribute(sm90_gemm_kernel<BM, BN, GLU>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
    if (err != cudaSuccess) return err;
    attr_set[dev].store(true, std::memory_order_release);
  }
  const dim3 grid(N / BN, (M + BM - 1) / BM, E * split);
  sm90_gemm_kernel<BM, BN, GLU><<<grid, G::THREADS, G::smem(stages), s>>>(
      ma, mb, mb2, c, ws, E, M, N, K / BK / split, split, stages, epi, act);
  return cudaGetLastError();
}

}  // namespace

namespace rt {

int sm90_expert_gemm(const void* a, const void* b, const void* b2, void* c, void* ws, int E,
                     int M, int N, int K, int bm, int bn, int split, int stages, int epilogue,
                     int act, cudaStream_t stream) {
  const bool glu = epilogue == kGlu;
  const bool tile = (bm == 64 || bm == 128) && (bn == 64 || (bn == 128 && !glu));
  const bool ok = tile && N % bn == 0 && split >= 1 && K % (BK * split) == 0 &&
                  stages >= 2 && stages <= MAX_STAGES && (glu ? b2 != nullptr : true) &&
                  (split == 1 || (ws != nullptr && !glu));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  if (M <= 0 || E <= 0) return static_cast<int>(cudaGetLastError());
  CUtensorMap ma, mb, mb2;
  if (!encode_3d(&ma, a, E, M, K, bm) || !encode_3d(&mb, b, E, K, N, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  if (!glu)
    mb2 = mb;  // unread without the gate
  else if (!encode_3d(&mb2, b2, E, K, N, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  bf16* out = static_cast<bf16*>(c);
  float* part = split > 1 ? static_cast<float*>(ws) : nullptr;
  cudaError_t err;
#define RT_LAUNCH(BM_, BN_, GLU_)                                                          \
  launch<BM_, BN_, GLU_>(ma, mb, mb2, out, part, E, M, N, K, split, stages, epilogue, act, \
                         stream)
  if (glu)
    err = bm == 64 ? RT_LAUNCH(64, 64, true) : RT_LAUNCH(128, 64, true);
  else if (bm == 64)
    err = bn == 64 ? RT_LAUNCH(64, 64, false) : RT_LAUNCH(64, 128, false);
  else
    err = bn == 64 ? RT_LAUNCH(128, 64, false) : RT_LAUNCH(128, 128, false);
#undef RT_LAUNCH
  if (err != cudaSuccess || split == 1) return static_cast<int>(err);
  const int n4 = E * M * N / 4;
  const int blocks = (n4 + 255) / 256 < 1024 ? (n4 + 255) / 256 : 1024;
  splitk_reduce_kernel<<<blocks, 256, 0, stream>>>(static_cast<const float4*>(ws), out, n4, split,
                                                   epilogue, act);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace rt
