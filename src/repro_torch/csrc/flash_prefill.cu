// GQA flash-attention forward (prefill) for Hopper.
//
// Replaces: src/repro/kernels/flash_prefill.py::flash_prefill (body
// _prefill_kernel): causal masking, sliding window, tanh logit softcap and
// an online softmax whose (m, l, acc) carry lives in VMEM scratch across the
// sequential KV-tile grid axis.
//
// What bounds it on the H100: at the serving shape (B 8, S 256, H = K = 12,
// D 64, bf16, causal) the work is ~0.81 GFLOP of QK^T and PV against
// 12.6 MB of q/k/v/o, ~64 FLOP/byte — far under the bf16 tensor-core ridge
// (~295), so HBM bounds it: 0.0038 ms at 3.35 TB/s.
//
// Blocks run in parallel in no order, so the TPU's sequential KV grid axis
// becomes a loop inside the block, which only visits the key tiles its rows
// can see (the causal upper bound, the window's lower bound) and masks only
// the tiles that straddle a boundary (the diagonal, the window's edge, or
// keys >= S_kv). A tile with no visible key for a row leaves its carry
// untouched — the Pallas kernel's zeroing of fully-masked tiles. Any S works:
// rows are masked against S and keys against S_kv (the Pallas kernel asserted
// S % bq == 0). The key side has a length of its own, S_kv, for
// cross-attention over an encoder's output; it differs from S only unmasked
// (not causal, no window: the Python wrapper refuses the rest), so a key-side
// bound reads S_kv and a mask compares positions only where S_kv == S.
//
// bf16: FlashAttention-2's register layout on the tensor cores. A block
// owns 64 query rows of one (batch, head), four warps of 16 rows; its Q
// fragments are loaded once into registers. K/V come in 64-key tiles,
// double buffered by cp.async into padded (conflict-free) shared memory, so
// each K/V tile serves 64 rows. S = Q K^T runs on mma.sync m16n8k16 with fp32
// accumulation (K fragments by ldmatrix); the scale and softcap apply to
// fp32 S, and the online softmax keeps (m, l) in registers with quad
// shuffles, in the log2 domain (a multiply and a MUFU ex2 a logit). P is
// rounded to bf16 in registers and fed straight back as the A operand of
// P V (V fragments by ldmatrix.trans) — the rounding point of
// models/attention.py, w.to(v.dtype); the Pallas kernel keeps P in fp32 —
// and the output is rounded once. At this shape the tensor-core work is far
// under the bytes' bound, so mma.sync suffices; wgmma / TMA
// (FlashAttention-3) wait for longer prompts, where this kernel trails
// SDPA (PERF.md §6). Head dims 32, 64, 128, 160 (stablelm-12b: 10 k-steps
// of 16) and 256 (gemma2-9b). At 256 the Q fragments (64 registers) and
// the output accumulators (128) would not fit beside the scores, so Q is
// staged once in shared memory and its fragments are read from there for
// each key tile (165 KB of shared memory, one block an SM).
//
// fp32 keeps the SIMT kernel: one warp owns one query row and keeps (m, l)
// in registers and its D/32 slice of acc per lane; a block of kRows warps
// shares each K/V tile of kTile keys through (dynamic: 72 KB at D 256)
// shared memory. Lane j scores
// key j of the tile, the warp reduces the tile max / sum with shuffles, and
// broadcasts each p_j to the lanes for the PV update; probabilities stay
// fp32, as flash_prefill.py keeps them.
#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using rt::cp_async16;
using rt::cp_async_commit;
using rt::cp_async_wait;

// ---------------------------------------------------------------------------
// fp32: a warp a query row on the CUDA cores (IEEE fp32, no TF32)
// ---------------------------------------------------------------------------
constexpr int kRows = 8;   // query rows (warps) per block
constexpr int kTile = 32;  // keys per shared-memory tile (one per lane)

// shared memory: q rows [kRows][D], K [kTile][D + 1] (+1: lane j reads row
// j, conflict-free), V [kTile][D]
template <int D> struct F32 {
  static constexpr int BYTES = 4 * (kRows * D + kTile * (D + 1) + kTile * D);
};

template <int D>
__global__ void __launch_bounds__(kRows * 32)
flash_prefill_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         int S, int Skv, int H, int KH, int window, float cap, int causal,
                         float scale) {
  constexpr int DL = D / 32;  // acc values per lane
  extern __shared__ __align__(16) float fsm[];
  float (*qs)[D] = reinterpret_cast<float (*)[D]>(fsm);
  float (*ks)[D + 1] = reinterpret_cast<float (*)[D + 1]>(fsm + kRows * D);
  float (*vs)[D] = reinterpret_cast<float (*)[D]>(fsm + kRows * D + kTile * (D + 1));

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int row = q0 + w;
  const bool row_ok = row < S;

  for (int i = tid; i < kRows * D; i += kRows * 32) {
    const int r = i / D, c = i % D;
    qs[r][c] = (q0 + r < S) ? q[(((size_t)b * S + q0 + r) * H + h) * D + c] : 0.f;
  }

  // key range any row of this block can see
  const int q_last = min(q0 + kRows, S) - 1;
  const int k_end = causal ? q_last + 1 : Skv;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  float m = -INFINITY, l = 0.f, acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) acc[i] = 0.f;

  for (int t0 = k_begin; t0 < k_end; t0 += kTile) {
    __syncthreads();  // previous tile fully consumed (and qs written)
    for (int i = tid; i < kTile * D; i += kRows * 32) {
      const int r = i / D, c = i % D;
      float kv = 0.f, vv = 0.f;
      if (t0 + r < Skv) {
        const size_t off = (((size_t)b * Skv + t0 + r) * KH + kh) * D + c;
        kv = k[off];
        vv = v[off];
      }
      ks[r][c] = kv;
      vs[r][c] = vv;
    }
    __syncthreads();
    if (!row_ok) continue;

    const int j = t0 + lane;
    bool ok = j < k_end;
    if (causal) ok = ok && j <= row;
    if (window > 0) ok = ok && j > row - window;
    float s = -INFINITY;
    if (ok) {
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot = fmaf(qs[w][d], ks[lane][d], dot);
      s = dot * scale;
      if (cap > 0.f) s = cap * tanhf(s / cap);
    }
    const float tmax = rt::warp_max(s);
    if (tmax == -INFINITY) continue;  // no visible key in this tile for this row
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);  // m = -inf on the first visible tile -> 0
    const float p = ok ? expf(s - m_new) : 0.f;
    l = l * alpha + rt::warp_sum(p);
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[i] *= alpha;
#pragma unroll 8
    for (int jj = 0; jj < kTile; ++jj) {
      const float pj = __shfl_sync(0xffffffffu, p, jj);
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[i] = fmaf(pj, vs[jj][lane + 32 * i], acc[i]);
    }
    m = m_new;
  }

  if (row_ok) {
    const float inv = 1.0f / fmaxf(l, 1e-30f);
    float* orow = o + (((size_t)b * S + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DL; ++i) orow[lane + 32 * i] = acc[i] * inv;
  }
}


// ---------------------------------------------------------------------------
// bf16: tensor cores via mma.sync m16n8k16, 64 query rows a block
// ---------------------------------------------------------------------------
constexpr int QT = 64;   // query rows per block
constexpr int KT = 64;   // keys per tile
constexpr float kLog2e = 1.4426950408889634f;

// A warp owns 16 query rows (one m16 tile), four warps a block. A row of a
// K or V tile in shared memory is D values + 8 of padding, so the eight
// 16-byte rows an ldmatrix reads fall in distinct banks; K/V are double
// buffered. Blocks an SM the registers are capped for (without spilling):
// four at D = 32, three at D = 64 (at four it spills), whatever fits at 128
// and above. QSM: Q lives in shared memory ([QT][LD] after K and V), not in
// registers (D = 256).
template <int D> struct Tc {
  static constexpr int THREADS = 128;
  static constexpr int MIN_BLOCKS = D == 32 ? 4 : D == 64 ? 3 : 1;
  static constexpr int LD = D + 8;
  static constexpr int TILE = KT * LD;                 // elements
  static constexpr int STAGES = 2;
  static constexpr bool QSM = D > 160;
  static constexpr int BYTES = STAGES * 2 * TILE * 2 + (QSM ? QT * LD * 2 : 0);
};

// 2^x on the MUFU unit (inputs <= 0 here: p and the carry's rescale)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

// grid (ceil(S / QT), H, B), 128 threads: warp w owns rows q0 + 16w + [0, 16)
template <int D>
__global__ void __launch_bounds__(Tc<D>::THREADS, Tc<D>::MIN_BLOCKS)
flash_prefill_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o, int S, int Skv, int H,
                        int KH, int window, float cap, int causal, float scale) {
  using T = Tc<D>;
  constexpr int LD = T::LD, TILE = T::TILE, STAGES = T::STAGES;
  constexpr int DC = D / 16;   // 16-wide contraction chunks of Q K^T
  constexpr int DB = D / 8;    // 8-wide column blocks of O
  constexpr int NB = KT / 8;   // 8-key column blocks of S
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);   // [STAGES][KT][LD]
  bf16* sv = sk + STAGES * TILE;                  // [STAGES][KT][LD]
  bf16* sq = sv + STAGES * TILE;                  // QSM: [QT][LD]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QT;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row[2] = {q0 + 16 * w + g, q0 + 16 * w + g + 8};   // this thread's two rows

  // Q as mma A fragments: a0 (row g, cols 2t..), a1 (row g+8), a2 / a3 the
  // same 8 columns on. In registers, loaded once; or (QSM) the block's 64
  // rows copied once into shared memory (rows >= S zero-filled, in the
  // first tile's cp.async group) and each fragment read from there
  const size_t rs = (size_t)H * D;
  const bf16* qb = q + ((size_t)b * S * H + h) * D;
  uint32_t qf[T::QSM ? 1 : DC][4];
  if constexpr (T::QSM) {
    constexpr int CH = D / 8;
    for (int i = tid; i < QT * CH; i += T::THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = q0 + r < S;
      cp_async16(rt::smem_u32(sq + r * LD + c), qb + (size_t)(ok ? q0 + r : 0) * rs + c,
                 ok ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int col = 16 * c + 2 * t;
      qf[c][0] = ld_pair(qb + row[0] * rs + col, row[0] < S);
      qf[c][1] = ld_pair(qb + row[1] * rs + col, row[1] < S);
      qf[c][2] = ld_pair(qb + row[0] * rs + col + 8, row[0] < S);
      qf[c][3] = ld_pair(qb + row[1] * rs + col + 8, row[1] < S);
    }
  }
  auto q_frag = [&](int c, uint32_t (&a)[4]) {
    if constexpr (T::QSM) {
      const bf16* r0 = sq + (16 * w + g) * LD + 16 * c + 2 * t;
      a[0] = *reinterpret_cast<const uint32_t*>(r0);
      a[1] = *reinterpret_cast<const uint32_t*>(r0 + 8 * LD);
      a[2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
      a[3] = *reinterpret_cast<const uint32_t*>(r0 + 8 * LD + 8);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qf[c][i];
    }
  };

  // the key tiles any row of this block can see
  const int q_last = min(q0 + QT, S) - 1;
  const int k_end = causal ? q_last + 1 : Skv;
  const int t_begin = window > 0 ? (max(0, q0 - window + 1) / KT) * KT : 0;
  const int n_tiles = (k_end - t_begin + KT - 1) / KT;

  // K/V tile rows t0 .. t0 + KT - 1 into ring slot `buf`, one cp.async
  // group; keys >= S_kv read zeros
  const size_t ks_ = (size_t)KH * D;
  const bf16* kb = k + ((size_t)b * Skv * KH + kh) * D;
  const bf16* vb = v + ((size_t)b * Skv * KH + kh) * D;
  auto load_tile = [&](int buf, int t0) {
    constexpr int CH = D / 8;   // 16-byte chunks a row
#pragma unroll
    for (int i = tid; i < KT * CH; i += T::THREADS) {
      const int r = i / CH, c = (i % CH) * 8;
      const bool ok = t0 + r < Skv;
      const size_t off = (size_t)(ok ? t0 + r : 0) * ks_ + c;
      const int so = buf * TILE + r * LD + c;
      cp_async16(rt::smem_u32(sk + so), kb + off, ok ? 16 : 0);
      cp_async16(rt::smem_u32(sv + so), vb + off, ok ? 16 : 0);
    }
    cp_async_commit();
  };

  // the softmax runs in the log2 domain: x = logit · log2(e), p = 2^(x - m)
  const float sl2 = scale * kLog2e, cap_l2 = cap * kLog2e, inv_cap = cap > 0.f ? 1.f / cap : 0.f;
  float oacc[DB][4];
#pragma unroll
  for (int i = 0; i < DB; ++i) oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  // the first STAGES - 1 tiles (an empty group stands in for a tile past the
  // end, so that the groups still count tiles)
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n_tiles) load_tile(i, t_begin + i * KT);
    else cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = t_begin + it * KT;
    cp_async_wait<STAGES - 2>();   // this thread's part of tile `it` has landed
    __syncthreads();               // everyone's has; and slot it - 1 is read
    const int nxt = it + STAGES - 1;
    if (nxt < n_tiles) load_tile(nxt % STAGES, t_begin + nxt * KT);
    else cp_async_commit();
    const bf16* kt = sk + (it % STAGES) * TILE;
    const bf16* vt = sv + (it % STAGES) * TILE;

    // S = Q K^T: this warp's 16 rows x 64 keys. ldmatrix x4 takes, per
    // 16-wide chunk c, the B fragments of key blocks nb and nb + 1.
    float s[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      uint32_t qa[4];
      q_frag(c, qa);
#pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        const int mi = lane >> 3;
        const int key = 8 * (nb + (mi >> 1)) + (lane & 7), col = 16 * c + 8 * (mi & 1);
        uint32_t bfr[4];
        ldsm_x4(bfr, rt::smem_u32(kt + key * LD + col));
        rt::mma_bf16(s[nb], qa, bfr[0], bfr[1]);
        rt::mma_bf16(s[nb + 1], qa, bfr[2], bfr[3]);
      }
    }

    // to the log2 domain, with the softcap; then the mask, only where the
    // tile straddles a boundary (the diagonal, the window's edge, or S_kv)
    if (cap > 0.f) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nb][i] = cap_l2 * tanhf(s[nb][i] * scale * inv_cap);
    } else {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nb][i] *= sl2;
    }
    if ((causal && t0 + KT - 1 > q0) || (window > 0 && t0 <= q_last - window) || t0 + KT > Skv) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = t0 + 8 * nb + 2 * t + (i & 1), r = row[i >> 1];
          if (j >= Skv || (causal && j > r) || (window > 0 && j <= r - window))
            s[nb][i] = -INFINITY;
        }
    }

    // online softmax: each row's max over the quad that holds it
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      tmax[0] = fmaxf(tmax[0], fmaxf(s[nb][0], s[nb][1]));
      tmax[1] = fmaxf(tmax[1], fmaxf(s[nb][2], s[nb][3]));
    }
    float alpha[2], mu[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 1));
      tmax[r] = fmaxf(tmax[r], __shfl_xor_sync(0xffffffffu, tmax[r], 2));
      const float m_new = fmaxf(m[r], tmax[r]);
      // no visible key yet: keep every p and the carry at 0 (no inf - inf)
      mu[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = ex2(m[r] - mu[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ex2(s[nb][i] - mu[i >> 1]);
        s[nb][i] = p;
        l[i >> 1] += p;
      }
#pragma unroll
    for (int db = 0; db < DB; ++db) {
      oacc[db][0] *= alpha[0];
      oacc[db][1] *= alpha[0];
      oacc[db][2] *= alpha[1];
      oacc[db][3] *= alpha[1];
    }

    // O += P V: the S accumulators of key blocks 2kc, 2kc + 1, rounded to
    // bf16, are the A fragment of keys 16kc .. 16kc + 15; ldmatrix.trans
    // takes the B fragments of column blocks db and db + 1
#pragma unroll
    for (int kc = 0; kc < KT / 16; ++kc) {
      const uint32_t pa[4] = {rt::pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              rt::pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              rt::pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              rt::pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int db = 0; db < DB; db += 2) {
        const int mi = lane >> 3;
        const int key = 16 * kc + 8 * (mi & 1) + (lane & 7), col = 8 * (db + (mi >> 1));
        uint32_t bfr[4];
        ldsm_x4_t(bfr, rt::smem_u32(vt + key * LD + col));
        rt::mma_bf16(oacc[db], pa, bfr[0], bfr[1]);
        rt::mma_bf16(oacc[db + 1], pa, bfr[2], bfr[3]);
      }
    }
  }

  bf16* ob = o + ((size_t)b * S * H + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const float inv = 1.0f / fmaxf(lr, 1e-30f);
    if (row[r] >= S) continue;
#pragma unroll
    for (int db = 0; db < DB; ++db)
      *reinterpret_cast<__nv_bfloat162*>(ob + row[r] * rs + 8 * db + 2 * t) =
          __floats2bfloat162_rn(oacc[db][2 * r] * inv, oacc[db][2 * r + 1] * inv);
  }
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, int B, int S,
                      int Skv, int H, int KH, int window, float cap, int causal,
                      cudaStream_t s) {
  using T = Tc<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_prefill_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, T::BYTES);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + QT - 1) / QT, H, B);
  flash_prefill_tc_kernel<D><<<grid, T::THREADS, T::BYTES, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), S, Skv, H, KH, window, cap, causal, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o, int B, int S,
                       int Skv, int H, int KH, int window, float cap, int causal,
                       cudaStream_t s) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_prefill_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, F32<D>::BYTES);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_prefill_f32_kernel<D><<<grid, kRows * 32, F32<D>::BYTES, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), S, Skv, H, KH, window, cap, causal, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o, int B, int S, int Skv,
                     int H, int KH, int window, float cap, int causal, bool bf, cudaStream_t s) {
  return bf ? launch_tc<D>(q, k, v, o, B, S, Skv, H, KH, window, cap, causal, s)
            : launch_f32<D>(q, k, v, o, B, S, Skv, H, KH, window, cap, causal, s);
}

}  // namespace

// o = attention(q, k, v): q/o [B, S, H, D], k/v [B, Skv, KH, D], contiguous,
// H % KH == 0, D in {32, 64, 128, 160, 256}, Skv == S unless unmasked
// (checked by the Python wrapper).
extern "C" int rt_flash_prefill(const void* q, const void* k, const void* v, void* o,
                                int B, int S, int Skv, int H, int KH, int D, int window,
                                float cap, int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  if (KH <= 0 || H % KH || Skv <= 0) return static_cast<int>(cudaErrorInvalidValue);
  if (Skv != S && (causal || window > 0)) return static_cast<int>(cudaErrorInvalidValue);
  const bool bf = dtype == rt::kBF16;
  cudaError_t err;
  switch (D) {
    case 32: err = launch_d<32>(q, k, v, o, B, S, Skv, H, KH, window, cap, causal, bf, s); break;
    case 64: err = launch_d<64>(q, k, v, o, B, S, Skv, H, KH, window, cap, causal, bf, s); break;
    case 128: err = launch_d<128>(q, k, v, o, B, S, Skv, H, KH, window, cap, causal, bf, s); break;
    case 160: err = launch_d<160>(q, k, v, o, B, S, Skv, H, KH, window, cap, causal, bf, s); break;
    case 256: err = launch_d<256>(q, k, v, o, B, S, Skv, H, KH, window, cap, causal, bf, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
