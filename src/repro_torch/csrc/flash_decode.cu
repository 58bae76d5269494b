// Single-token GQA decode attention over a ring K/V cache for Hopper (sm_90a),
// split over the keys (flash-decoding) with the merge inside one cluster.
//
// Replaces: src/repro/kernels/flash_decode.py::flash_decode (body
// _decode_kernel): one query token per batch lane against a [B, S, K, D]
// cache whose slots carry global positions (a slot is valid iff
// 0 <= slot_pos <= pos, and slot_pos > pos - window when windowed), tanh
// logit softcap, and an online softmax whose (m, l, acc) carry lives in VMEM
// scratch across a sequential S grid axis.
//
// What bounds it on the H100: each cached K and V element is read once and
// used for 2·G flops (about one flop a byte), so HBM bytes bound it. At the
// decode path's shape (B 8, S 512, H = K = 12, D 64, bf16) K + V are
// 12.6 MB: 3.8 us at 3.35 TB/s. To come near that the card needs tens of KB
// of loads in flight on every SM at once, from the first microsecond, and
// a launch this short also pays its fixed costs (the launch itself, the
// merge) in full.
//
// Design. One (lane, kv head) is a thread-block cluster of `splits` blocks
// (grid (KH, B, splits), cluster (1, 1, splits), splits <= 8, from
// kernels/flash_decode.py::decode_plan). The keys are cut into tiles of
// 8 KB of K rows (at D 160 5 KB in bf16, 10 in fp32; at D 256 in fp32 16;
// as many of V);
// block r of the cluster owns a
// contiguous, balanced run of those tiles. It streams them through a
// double buffer of two shared-memory stages by cp.async, K and V as they are
// in HBM (bf16 or fp32, widened only on read), so the loads of the next tile
// are in flight while a tile is scored; a kv head's row is a contiguous
// D-element piece at stride KH·D, in the ring cache and in a page alike.
//
// Inside a block (four warps) a key row is spread over its 16-byte pieces,
// D / 8 (bf16) or D / 4 (fp32) of them: over that many lanes when the count
// divides 32, so a warp holds 32 / that rows at once and reads shared memory
// in whole rows; else (D 160, and fp32 at D 256) over the whole warp, each
// lane taking pieces tx, tx + 32, ..., and the lanes past the last piece
// holding zeros (at D 160 in bf16, 12 of 32 lanes idle: simple, not fast). Each lane copies its own pieces of
// its own keys into the ring and reads only those back, so the ring needs
// no barrier between the block's threads: a lane waits for its own copies
// (a key's position is copied once, by the row's first lane, and passed to
// the others by a shuffle). The lanes of a row dot their pieces with the G query heads of the kv
// head (q is held in registers; each K and V row is read once for all G
// heads) and sum by xor shuffles; every row keeps its own fp32 (m, l, acc)
// and folds its four keys of each tile into it at once. At the end the rows
// of a warp merge by shuffles and the four warps through shared memory, in
// a fixed order, into the block's partial, which goes into rank 0's shared
// memory through distributed shared memory; rank 0 counts the cluster's
// threads in on an mbarrier and merges the partials in rank order (the
// safe-softmax merge of attention._merge_partials), dividing and rounding
// once to q's dtype. The one cluster barrier (rank 0's mbarrier is ready)
// is entered at the start and left at the end, so its latency hides behind
// the keys. One launch, no workspace, and reruns are bit-identical.
//
// Masking is the reference's, not the usual -inf: an invalid slot's logit
// is -1e30 and m starts at -1e30, so a lane whose slots are all invalid gets
// the uniform average of V, as flash_decode_ref does (every partial then
// has m = -1e30, each merge scale is 1, and the counts add). A block whose
// keys are all masked while another's are not is scaled by
// exp(-1e30 - m) = 0; a block with no keys at all has l = 0 and adds
// nothing. Only keys past the block's run get p = 0 exactly, so any S works
// (the Pallas kernel asserted S % bs == 0).
//
// Groups. A block holds the query heads of its kv head in registers, up to
// eight (GM = 1, 4 or 8); a larger group (up to 16: qwen3-moe's 64 query
// heads over 4 kv heads) is cut into blocks of eight, each its own cluster
// that streams the kv head's keys once more, mostly from L2. The Pallas
// kernel takes any group in one block of VMEM.
//
// Paged variant. Replaces src/repro/kernels/flash_decode.py::
// flash_decode_paged (body _paged_decode_kernel): the same token reads K/V
// through a page table [B, Mp] into a shared pool [P+1, page, K, D] whose
// last page is the trash page; slot j of table entry p holds position
// p·page + j, and an entry of -1 (unallocated or spilled) is masked. The TPU
// kernel takes the table by scalar prefetch and DMAs one page per step of
// its sequential grid. Here each block reads its lane's table row itself
// and compacts the live entries (allocated, and overlapping the causal /
// window band) into a page list in shared memory, in table order, with a
// warp-ballot prefix sum. The key stream is then the list's pages back to
// back, and the split divides those live keys, not the table (the plan,
// though, comes from the table's capacity), so each live page's K and V are
// read once, by one block, for all G query heads.
// Skipping dead entries is exact only for a lane with a valid key (a masked
// key's weight is then exp(-1e30 - m) = 0); a lane with none walks every
// entry, -1 through the trash page, and averages V over all of them as the
// reference does. A key's page is j / page by a multiply and a shift (the
// host's magic number), and its position goes into the ring beside it.
#include "common.cuh"

namespace {

using rt::cp_async16;
using rt::cp_async_commit;
using rt::cp_async_wait;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKeysPerRow = 4;     // keys each row of lanes takes from a ring stage
constexpr int kStages = 2;         // the ring's depth: a double buffer
constexpr int kMaxSplits = 8;      // the portable cluster size
constexpr int kMaxGroup = 16;      // query heads a kv head, in blocks of at most 8
constexpr float kNeg = -1e30f;     // the reference's masked logit and m's start

// How a tile of keys spreads over the block: a key row is P 16-byte pieces
// (VEC elements each); TX lanes span a row, lane tx taking pieces tx,
// tx + TX, ... (NP slots, the ones past P empty), a warp holds TY rows at
// once and the block ROWS. A ring stage holds BK keys, KPR for each row of
// lanes: key u·ROWS + w·TY + ty for warp w's row ty. A lane copies its own
// pieces of its own keys into the ring and reads only those back, so the
// ring needs no barrier between the block's threads.
template <typename T, int D>
struct Geo {
  static constexpr int VEC = 16 / (int)sizeof(T);
  static constexpr int P = D / VEC;
  static constexpr int TX = (P <= 32 && 32 % P == 0) ? P : 32;
  static constexpr int NP = (P + TX - 1) / TX;
  static constexpr int NE = NP * VEC;   // a lane's elements of a row
  static constexpr int TY = 32 / TX;
  static constexpr int ROWS = kWarps * TY;
  static constexpr int KPR = kKeysPerRow;
  static constexpr int BK = ROWS * KPR;
  static_assert(D % VEC == 0 && TX * TY == 32, "geometry");
};

// Shared memory, in bytes (kernels/flash_decode.py::_smem_bytes writes it
// out): the ring, kStages x [K tile BK x D][V tile BK x D][the keys'
// positions, BK ints] (about 16 KB a stage); the warps' partials
// [kWarps][GM] m, l and [kWarps][GM][D] acc, which reuse the ring once it
// is drained; the cluster's block partials [splits][GM m, GM l,
// GM x D acc], which only rank 0's copy holds; the mbarrier on which rank 0
// counts their arrival; the paged variant's page list, 2 x Mp ints.
template <typename T, int D, int GM, bool PAGED>
struct Layout {
  using Ge = Geo<T, D>;
  static constexpr int STAGE = 2 * Ge::BK * D * (int)sizeof(T) + Ge::BK * 4;
  static constexpr int MERGE = kWarps * GM * (D + 2) * 4;
  static constexpr int PART = GM * (D + 2) * 4;
  static constexpr int WORK = kStages * STAGE > MERGE ? kStages * STAGE : MERGE;
  __host__ __device__ static constexpr int bar(int splits) { return WORK + splits * PART; }
  __host__ __device__ static constexpr int bytes(int splits, int Mp) {
    return bar(splits) + 8 + (PAGED ? 8 * Mp : 0);
  }
};

// 4 bytes from global into shared memory, asynchronously (slot positions)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               "fence.mbarrier_init.release.cluster;\n" ::"r"(rt::smem_u32(bar)), "r"(count)
               : "memory");
}

// one arrival on the mbarrier at a cluster_addr, after this thread's writes
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t addr) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(addr)
               : "memory");
}

// wait for phase 0 of this block's mbarrier, and see the writes of the
// cluster's threads that arrived on it
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar) {
  const uint32_t addr = rt::smem_u32(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], 0;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr)
        : "memory");
    if (polls == (1u << 26)) __trap();
  }
}

// a 16-byte piece of a q, K or V row, widened to fp32
template <typename T> struct Piece;
template <> struct Piece<float> {
  __device__ static void load(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
};
template <> struct Piece<__nv_bfloat16> {
  __device__ static void load(const __nv_bfloat16* p, float* out) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// Where the keys of lane b live. Ring: key j is cache slot j, valid per
// slot_pos. Paged: key j is slot j % page of the (j / page)-th page of the
// block's page list (table index pidx, pool page ppid).
struct Paged {
  const int* table;   // [B, Mp]
  int Mp, page, trash;
  unsigned long long magic;   // ceil(2^40 / page): j / page == j · magic >> 40 for j · page < 2^40

  __device__ int page_of(int j) const {
    return static_cast<int>((static_cast<unsigned long long>(j) * magic) >> 40);
  }
};

// Build the block's page list in shared memory (pidx / ppid, Mp ints each)
// and return how many pages it holds; *none says the lane has no valid key.
// The table row is read kThreads entries at a time, the first before any
// barrier, and each chunk costs one barrier (its warps' counts alternate
// between two buffers, so a chunk never overwrites counts still being read).
__device__ int build_page_list(const Paged& pg, int b, int p, int window, int* pidx,
                               int* ppid, bool* none) {
  __shared__ int warp_cnt[2][kWarps];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int* row = pg.table + (size_t)b * pg.Mp;
  const int lo = window > 0 ? p - window + 1 : 0;    // lowest valid position
  int total = 0;
  for (int c0 = 0, it = 0; c0 < pg.Mp; c0 += kThreads, it ^= 1) {
    const int i = c0 + tid;
    int ent = -1;
    bool live = false;
    if (i < pg.Mp) {
      ent = row[i];
      live = ent >= 0 && i * pg.page <= p && i * pg.page + pg.page - 1 >= lo;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    if (lane == 0) warp_cnt[it][w] = __popc(bal);
    __syncthreads();
    int off = total + __popc(bal & ((1u << lane) - 1u));
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) {
      const int c = warp_cnt[it][ww];
      if (ww < w) off += c;
      total += c;
    }
    if (live) {
      pidx[off] = i;
      ppid[off] = ent;
    }
  }
  *none = total == 0;
  if (total == 0) {
    // no valid key: every entry, -1 through the trash page, all masked
    for (int i = tid; i < pg.Mp; i += kThreads) {
      const int ent = row[i];
      pidx[i] = i;
      ppid[i] = ent >= 0 ? ent : pg.trash;
    }
  }
  __syncthreads();
  return total == 0 ? pg.Mp : total;
}

// GM: the query heads a block holds, the instantiated width (1, 4 or 8); a
// group above GM runs in ceil(G / GM) blocks of GM heads (blockIdx.x =
// kh · blocks + which). PAGED: k / v are the page pool and pg the table;
// else a ring [B, S, KH, D] with slot_pos. The cluster is the blocks of one
// (kh, head block, b): blockIdx.z is the rank, gridDim.z the split.
template <typename T, int D, int GM, bool PAGED>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ slot_pos,
                    const int* __restrict__ pos, T* __restrict__ o, Paged pg, int S, int KH,
                    int G, int window, float cap, float scale) {
  using Ge = Geo<T, D>;
  using Ly = Layout<T, D, GM, PAGED>;
  constexpr int VEC = Ge::VEC, TX = Ge::TX, TY = Ge::TY, BK = Ge::BK, NP = Ge::NP, NE = Ge::NE;
  extern __shared__ __align__(16) unsigned char smem[];
  const int hblocks = (G + GM - 1) / GM;
  const int kh = blockIdx.x / hblocks, g0 = (blockIdx.x % hblocks) * GM;
  const int b = blockIdx.y, rank = blockIdx.z, splits = gridDim.z;
  const int H = KH * G, Gb = min(GM, G - g0);   // this block's heads kh·G + g0 + [0, Gb)
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int tx = lane % TX, ty = lane / TX;
  // this lane's piece slots: piece tx + i·TX of a row, if there is one
  bool has[NP];
#pragma unroll
  for (int i = 0; i < NP; ++i) has[i] = tx + i * TX < Ge::P;
  float* parts = reinterpret_cast<float*>(smem + Ly::WORK);   // [splits][PART / 4]
  uint64_t* arrived = reinterpret_cast<uint64_t*>(smem + Ly::bar(splits));
  int* pidx = reinterpret_cast<int*>(arrived + 1);                     // paged: [Mp]
  int* ppid = pidx + (PAGED ? pg.Mp : 0);                              // paged: [Mp]

  // rank 0 counts every thread of the cluster in as it delivers its share
  // of a block partial; the cluster barrier that makes the count visible is
  // entered here and left only at the end, so its latency hides behind the
  // keys
  if (tid == 0) mbar_init(arrived, splits * kThreads);
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int p = pos[b];

  // this lane's pieces of each query head of the block (zeros elsewhere)
  float qr[GM][NE];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (g < Gb && has[i]) {
        Piece<T>::load(q + ((size_t)b * H + kh * G + g0 + g) * D + (tx + i * TX) * VEC,
                       qr[g] + i * VEC);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) qr[g][i * VEC + e] = 0.f;
      }
    }
  }

  bool none = false;
  int nkeys = S;
  if constexpr (PAGED) nkeys = build_page_list(pg, b, p, window, pidx, ppid, &none) * pg.page;
  // this block's keys: tiles [t_lo, t_hi) of the lane's, keys below k_hi
  const int ntiles = (nkeys + BK - 1) / BK;
  const int t_lo = rank * ntiles / splits, t_hi = (rank + 1) * ntiles / splits;
  const int n = t_hi - t_lo;
  const int k_hi = min(nkeys, t_hi * BK);

  // the block's tile t into ring stage t % kStages, as one commit group
  // (empty past the block's last tile): this lane's pieces of K and V of
  // its keys, and (the row's first lane) each key's position
  auto fetch = [&](int t) {
    if (t < n) {
      unsigned char* st = smem + (t % kStages) * Ly::STAGE;
      T* ks = reinterpret_cast<T*>(st);
      T* vs = ks + BK * D;
      int* ps = reinterpret_cast<int*>(vs + BK * D);
      const int j0 = (t_lo + t) * BK;
#pragma unroll
      for (int u = 0; u < Ge::KPR; ++u) {
        const int kk = u * Ge::ROWS + w * TY + ty, j = j0 + kk;
        if (j < k_hi) {
          size_t row = (size_t)b * S + j;
          if constexpr (PAGED) {
            const int pi = pg.page_of(j), slot = j - pi * pg.page;
            row = (size_t)ppid[pi] * pg.page + slot;
            if (tx == 0) ps[kk] = none ? -1 : pidx[pi] * pg.page + slot;
          } else if (tx == 0) {
            cp_async4(rt::smem_u32(ps + kk), slot_pos + row);
          }
#pragma unroll
          for (int i = 0; i < NP; ++i) {
            if (!has[i]) continue;
            const int e0 = (tx + i * TX) * VEC;
            const size_t off = (row * KH + kh) * D + e0;
            cp_async16(rt::smem_u32(ks + kk * D + e0), k + off, 16);
            cp_async16(rt::smem_u32(vs + kk * D + e0), v + off, 16);
          }
        }
      }
    }
    cp_async_commit();
  };

  float m[GM], l[GM], acc[GM][NE];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < NE; ++e) acc[g][e] = 0.f;
  }

  // this lane's pieces of ring row kk, widened (zeros in the empty slots)
  auto row_pieces = [&](const T* base, int kk, float* out) {
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      if (has[i]) {
        Piece<T>::load(base + kk * D + (tx + i * TX) * VEC, out + i * VEC);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) out[i * VEC + e] = 0.f;
      }
    }
  };

  for (int t = 0; t < kStages - 1; ++t) fetch(t);
  for (int t = 0; t < n; ++t) {
    cp_async_wait<kStages - 2>();   // this lane's pieces of tile t have landed
    fetch(t + kStages - 1);         // into the stage this lane read last
    const unsigned char* st = smem + (t % kStages) * Ly::STAGE;
    const T* ks = reinterpret_cast<const T*>(st);
    const T* vs = ks + BK * D;
    const int* ps = reinterpret_cast<const int*>(vs + BK * D);
    const int j0 = (t_lo + t) * BK;
    // score this row's KPR keys of the tile for every head
    float x[Ge::KPR][GM];
    bool in[Ge::KPR];
#pragma unroll
    for (int u = 0; u < Ge::KPR; ++u) {
      const int kk = u * Ge::ROWS + w * TY + ty;
      in[u] = j0 + kk < k_hi;
      float kf[NE];
      row_pieces(ks, kk, kf);
      float s[GM];
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        s[g] = 0.f;
#pragma unroll
        for (int e = 0; e < NE; ++e) s[g] = fmaf(qr[g][e], kf[e], s[g]);
#pragma unroll
        for (int off = TX / 2; off > 0; off >>= 1) s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
      }
      // the key's position, from the row's first lane (-1 past k_hi)
      int sp = tx == 0 && in[u] ? ps[kk] : -1;
      sp = __shfl_sync(0xffffffffu, sp, 0, TX);
      const bool valid = sp >= 0 && sp <= p && (window <= 0 || sp > p - window);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        float xv = s[g] * scale;
        if (cap > 0.f) xv = cap * tanhf(xv / cap);
        x[u][g] = valid ? xv : kNeg;
      }
    }
    // fold them into the row's carry
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float m_new = m[g];
#pragma unroll
      for (int u = 0; u < Ge::KPR; ++u)
        if (in[u]) m_new = fmaxf(m_new, x[u][g]);
      const float alpha = expf(m[g] - m_new);   // 1 while every key so far is masked
      m[g] = m_new;
      l[g] *= alpha;
#pragma unroll
      for (int e = 0; e < NE; ++e) acc[g][e] *= alpha;
    }
#pragma unroll
    for (int u = 0; u < Ge::KPR; ++u) {
      if (!in[u]) continue;
      float vf[NE];
      row_pieces(vs, u * Ge::ROWS + w * TY + ty, vf);
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float pr = expf(x[u][g] - m[g]);
        l[g] += pr;
#pragma unroll
        for (int e = 0; e < NE; ++e) acc[g][e] = fmaf(pr, vf[e], acc[g][e]);
      }
    }
  }
  cp_async_wait<0>();

  // merge the warp's rows (lanes tx + TX·ty) by xor shuffles over ty
#pragma unroll
  for (int off = TX; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
      const float mm = fmaxf(m[g], mo);
      const float sa = expf(m[g] - mm), sb = expf(mo - mm);
      l[g] = l[g] * sa + lo * sb;
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const float ao = __shfl_xor_sync(0xffffffffu, acc[g][e], off);
        acc[g][e] = acc[g][e] * sa + ao * sb;
      }
      m[g] = mm;
    }
  }
  // the warps' partials into the drained ring, then the block's in order
  __syncthreads();   // every lane's ring reads are done
  float* wm = reinterpret_cast<float*>(smem);   // [kWarps][GM]
  float* wl = wm + kWarps * GM;                 // [kWarps][GM]
  float* wa = wl + kWarps * GM;                 // [kWarps][GM][D]
  if (ty == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (tx == 0) {
        wm[w * GM + g] = m[g];
        wl[w * GM + g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        if (!has[i]) continue;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          wa[(w * GM + g) * D + (tx + i * TX) * VEC + e] = acc[g][i * VEC + e];
      }
    }
  }
  __syncthreads();
  // every block has started, so rank 0's mbarrier is ready: this block's
  // partial, merged over its warps in order, goes into rank 0's slot `rank`
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  constexpr int PS = Ly::PART / 4;
  float* slot = parts + rank * PS;   // m [GM], l [GM], acc [GM][D]
  for (int i = tid; i < Gb * D; i += kThreads) {
    const int g = i / D;
    float mb = kNeg;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) mb = fmaxf(mb, wm[ww * GM + g]);
    float lb = 0.f, ab = 0.f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) {
      const float sc = expf(wm[ww * GM + g] - mb);
      lb = fmaf(wl[ww * GM + g], sc, lb);
      ab = fmaf(wa[(ww * GM + g) * D + i % D], sc, ab);
    }
    rt::st_cluster(rt::cluster_addr(slot + 2 * GM + i, 0), ab);
    if (i % D == 0) {
      rt::st_cluster(rt::cluster_addr(slot + g, 0), mb);
      rt::st_cluster(rt::cluster_addr(slot + GM + g, 0), lb);
    }
  }
  mbar_arrive_cluster(rt::cluster_addr(arrived, 0));
  if (rank != 0) return;

  // rank 0: every partial has arrived; merge them in rank order
  mbar_wait_cluster(arrived);
  for (int i = tid; i < Gb * D; i += kThreads) {
    const int g = i / D;
    float mg = kNeg;
    for (int r = 0; r < splits; ++r) mg = fmaxf(mg, parts[r * PS + g]);
    float lg = 0.f, ag = 0.f;
    for (int r = 0; r < splits; ++r) {
      const float sc = expf(parts[r * PS + g] - mg);
      lg = fmaf(parts[r * PS + GM + g], sc, lg);
      ag = fmaf(parts[r * PS + 2 * GM + i], sc, ag);
    }
    o[((size_t)b * H + kh * G + g0) * D + i] = rt::from_f32<T>(ag / fmaxf(lg, 1e-30f));
  }
}

struct Args {
  const void *q, *k, *v;
  const int *sp, *pos;
  void* o;
  Paged pg;
  int B, S, KH, G, splits, window;
  float cap;
};

template <typename T, int D, int GM, bool PAGED>
cudaError_t launch(const Args& a, cudaStream_t s) {
  auto kern = flash_decode_kernel<T, D, GM, PAGED>;
  const int bytes = Layout<T, D, GM, PAGED>::bytes(a.splits, a.pg.Mp);
  if (bytes > rt::MAX_SMEM) return cudaErrorInvalidValue;
  static std::atomic<bool> attr_set[rt::MAX_DEVICES];
  cudaError_t err = rt::allow_smem(reinterpret_cast<const void*>(kern), attr_set);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.KH * ((a.G + GM - 1) / GM), a.B, a.splits);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = a.splits;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                           static_cast<const T*>(a.v), a.sp, a.pos, static_cast<T*>(a.o), a.pg,
                           a.S, a.KH, a.G, a.window, a.cap, 1.0f / sqrtf((float)D));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T, int D, bool PAGED>
cudaError_t dispatch_g(const Args& a, cudaStream_t s) {
  if (a.G == 1) return launch<T, D, 1, PAGED>(a, s);
  if (a.G <= 4) return launch<T, D, 4, PAGED>(a, s);
  return launch<T, D, 8, PAGED>(a, s);
}

template <typename T, bool PAGED>
cudaError_t dispatch_d(const Args& a, int D, cudaStream_t s) {
  if (D == 32) return dispatch_g<T, 32, PAGED>(a, s);
  if (D == 64) return dispatch_g<T, 64, PAGED>(a, s);
  if (D == 128) return dispatch_g<T, 128, PAGED>(a, s);
  if (D == 160) return dispatch_g<T, 160, PAGED>(a, s);
  return dispatch_g<T, 256, PAGED>(a, s);
}

template <bool PAGED>
int decode(const Args& a, int H, int D, int dtype, cudaStream_t s) {
  if (a.B <= 0 || a.S <= 0) return static_cast<int>(cudaGetLastError());
  if (a.splits < 1 || a.splits > kMaxSplits || a.KH <= 0 || H % a.KH || a.G < 1 ||
      a.G > kMaxGroup || (D != 32 && D != 64 && D != 128 && D != 160 && D != 256))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = dtype == rt::kBF16 ? dispatch_d<__nv_bfloat16, PAGED>(a, D, s)
                                           : dispatch_d<float, PAGED>(a, D, s);
  return static_cast<int>(e);
}

}  // namespace

// o = decode attention(q, k, v): q/o [B, H, D], k/v [B, S, KH, D], slot_pos
// [B, S] int32, pos [B] int32, all contiguous and q, k, v 16-byte aligned;
// H % KH == 0, H / KH <= 16, D in {32, 64, 128, 160, 256}, S >= 1; the keys split over
// a cluster of `splits` (1..8) blocks (kernels/flash_decode.py::decode_plan).
extern "C" int rt_flash_decode(const void* q, const void* k, const void* v,
                               const void* slot_pos, const void* pos, void* o, int B, int S,
                               int H, int KH, int D, int window, float cap, int splits,
                               int dtype, void* stream) {
  const Args a{q, k, v, static_cast<const int*>(slot_pos), static_cast<const int*>(pos), o,
               Paged{nullptr, 0, 1, 0, 0}, B, S, KH, KH > 0 ? H / KH : 0, splits, window,
               cap};
  return decode<false>(a, H, D, dtype, static_cast<cudaStream_t>(stream));
}

// o = decode attention(q, kp, vp) through a page table: q/o [B, H, D], kp/vp
// [P1, page, KH, D] (page P1 - 1 is the trash page), table [B, Mp] int32
// with entries in [-1, P1 - 2], pos [B] int32, all contiguous; the same
// rules as rt_flash_decode, the split dividing each lane's live keys,
// Mp·page² < 2^40, and 2·Mp ints of shared memory on top.
extern "C" int rt_flash_decode_paged(const void* q, const void* kp, const void* vp,
                                     const void* table, const void* pos, void* o, int B,
                                     int Mp, int page, int P1, int H, int KH, int D,
                                     int window, float cap, int splits, int dtype,
                                     void* stream) {
  if (page < 1 || (long long)Mp * page * page >= (1ll << 40))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, kp, vp, nullptr, static_cast<const int*>(pos), o,
               Paged{static_cast<const int*>(table), Mp, page, P1 - 1,
                     ((1ull << 40) + page - 1) / page},
               B, Mp * page, KH, KH > 0 ? H / KH : 0, splits, window, cap};
  return decode<true>(a, H, D, dtype, static_cast<cudaStream_t>(stream));
}
