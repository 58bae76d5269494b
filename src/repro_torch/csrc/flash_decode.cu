// Single-token GQA decode attention over a ring K/V cache for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_decode.py::flash_decode (body
// _decode_kernel): one query token per batch lane against a [B, S, K, D]
// cache whose slots carry global positions (a slot is valid iff
// 0 <= slot_pos <= pos, and slot_pos > pos - window when windowed), tanh
// logit softcap, and an online softmax whose (m, l, acc) carry lives in VMEM
// scratch across a sequential S grid axis.
//
// What bounds it on the H100: each cached K and V element is read once and
// used for 2·G flops, so HBM bytes bound it. At the decode path's shape
// (B 8, S 512, H = K = 12, D 64, bf16) K + V are 12.6 MB: 3.8 us at
// 3.35 TB/s.
//
// Design. Blocks run in parallel in no order, so the TPU's sequential S axis
// becomes a loop inside the block. One block per (batch lane, kv head), four
// warps; warp w walks the 32-key tiles w, w + 4, ... of S. A warp stages its
// tile of K and V in shared memory (widened to fp32 once) and all G query
// heads of the kv head score against that one copy: lane j scores key j for
// every head, the warp reduces the tile max and sum with shuffles, and each
// p_j is broadcast for the PV update (lane i owns d = i + 32·t). (m, l, acc)
// stay in fp32 registers; at the end the four warps merge their partials
// through shared memory (the safe-softmax merge of
// attention._merge_partials) and one thread per output element divides and
// rounds once to q's dtype.
// Masking is the reference's, not the usual -inf: an invalid slot's logit
// is -1e30 and m starts at -1e30, so a lane whose slots are all invalid gets
// the uniform average of V, as flash_decode_ref does. Only keys past S (the
// ragged last tile) get p = 0 exactly, so any S works (the Pallas kernel
// asserted S % bs == 0). With B·K blocks (96 on the path) the card is
// under-filled; splitting S across blocks (flash-decoding) is later work.
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
// back, walked in the same 32-key tiles, so each live page's K and V are
// read once for all G query heads and a page smaller than a tile costs no
// idle lanes. Bytes bound it as above: at the decode path's shape (page 16,
// 32 entries a lane, 8 lanes) it reads the same 12.6 MB. Skipping dead
// entries is exact only for a lane with a valid key (a masked key's weight
// is then exp(-1e30 - m) = 0); a lane with none walks every entry, -1
// through the trash page, and averages V over all of them as the reference
// does.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kTile = 32;          // keys per warp tile, one per lane
constexpr float kNeg = -1e30f;     // the reference's masked logit and m's start

// 16-byte vector loads of a K/V row, widened to fp32
template <typename T> struct Row;
template <> struct Row<float> {
  static constexpr int N = 4;
  __device__ static void load(const float* p, float* out) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
  }
};
template <> struct Row<__nv_bfloat16> {
  static constexpr int N = 8;
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

template <int D, int GM>
__host__ __device__ constexpr size_t smem_floats() {
  constexpr size_t tiles = (size_t)kWarps * kTile * ((D + 1) + D);
  constexpr size_t merge = (size_t)kWarps * GM * (D + 2);
  return (size_t)GM * D + (tiles > merge ? tiles : merge);
}

// Where the keys of lane b live. Ring: key j is cache slot j, valid per
// slot_pos. Paged: key j is slot j % page of the (j / page)-th page of the
// block's page list (table index pidx, pool page ppid).
struct Paged {
  const int* table;   // [B, Mp]
  int Mp, page, trash;
};

// Build the block's page list in shared memory (pidx / ppid, Mp ints each)
// and return how many pages it holds; *none says the lane has no valid key.
__device__ int build_page_list(const Paged& pg, int b, int p, int window, int* pidx,
                               int* ppid, bool* none) {
  __shared__ int warp_cnt[kWarps];
  __shared__ int total;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int* row = pg.table + (size_t)b * pg.Mp;
  const int lo = window > 0 ? p - window + 1 : 0;    // lowest valid position
  if (tid == 0) total = 0;
  __syncthreads();
  for (int c0 = 0; c0 < pg.Mp; c0 += kWarps * 32) {
    const int i = c0 + tid;
    int ent = -1;
    bool live = false;
    if (i < pg.Mp) {
      ent = row[i];
      live = ent >= 0 && i * pg.page <= p && i * pg.page + pg.page - 1 >= lo;
    }
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    if (lane == 0) warp_cnt[w] = __popc(bal);
    __syncthreads();
    int off = total;
    for (int ww = 0; ww < w; ++ww) off += warp_cnt[ww];
    off += __popc(bal & ((1u << lane) - 1u));
    if (live) {
      pidx[off] = i;
      ppid[off] = ent;
    }
    __syncthreads();
    if (tid == 0) {
      int add = 0;
      for (int ww = 0; ww < kWarps; ++ww) add += warp_cnt[ww];
      total += add;
    }
    __syncthreads();
  }
  const int n = total;
  *none = n == 0;
  if (n > 0) return n;
  // no valid key: every entry, -1 through the trash page, all masked
  for (int i = tid; i < pg.Mp; i += kWarps * 32) {
    const int ent = row[i];
    pidx[i] = i;
    ppid[i] = ent >= 0 ? ent : pg.trash;
  }
  __syncthreads();
  return pg.Mp;
}

// GM: query heads per kv head rounded up to the instantiated width (G <= GM).
// PAGED: k / v are the page pool and pg the table; else a ring [B, S, KH, D]
// with slot_pos.
template <typename T, int D, int GM, bool PAGED>
__global__ void __launch_bounds__(kWarps * 32)
flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ slot_pos,
                    const int* __restrict__ pos, T* __restrict__ o, Paged pg,
                    int S, int KH, int G, int window, float cap, float scale) {
  constexpr int DL = D / 32;         // acc values per lane per head
  constexpr int VN = Row<T>::N;
  constexpr int KP = D + 1;          // K row pitch: lane j reads row j conflict-free
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [GM][D]
  float* work = smem + GM * D;

  const int kh = blockIdx.x, b = blockIdx.y;
  const int H = KH * G;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  float* ks = work + (size_t)w * kTile * (KP + D);   // this warp's K tile [32][KP]
  float* vs = ks + kTile * KP;                       // and V tile [32][D]

  for (int i = tid; i < GM * D; i += kWarps * 32) {
    const int g = i / D, c = i % D;
    qs[i] = g < G ? rt::to_f32(q[((size_t)b * H + kh * G + g) * D + c]) : 0.f;
  }
  __syncthreads();

  const int p = pos[b];
  int* pidx = reinterpret_cast<int*>(smem + smem_floats<D, GM>());   // paged: [Mp]
  int* ppid = pidx + (PAGED ? pg.Mp : 0);                            // paged: [Mp]
  bool none = false;
  if constexpr (PAGED) S = build_page_list(pg, b, p, window, pidx, ppid, &none) * pg.page;
  float m[GM], l[GM], acc[GM][DL];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNeg;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[g][i] = 0.f;
  }

  for (int t0 = w * kTile; t0 < S; t0 += kWarps * kTile) {
    __syncwarp();  // the previous tile is consumed
    for (int i = lane; i < kTile * (D / VN); i += 32) {
      const int r = i / (D / VN), c = (i % (D / VN)) * VN;
      float kv[VN], vv[VN];
      if (t0 + r < S) {
        size_t row_id = (size_t)b * S + t0 + r;
        if constexpr (PAGED) {
          const int pi = (t0 + r) / pg.page;
          row_id = (size_t)ppid[pi] * pg.page + (t0 + r - pi * pg.page);
        }
        const size_t off = (row_id * KH + kh) * D + c;
        Row<T>::load(k + off, kv);
        Row<T>::load(v + off, vv);
      } else {
#pragma unroll
        for (int e = 0; e < VN; ++e) kv[e] = vv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VN; ++e) {
        ks[r * KP + c + e] = kv[e];
        vs[r * D + c + e] = vv[e];
      }
    }
    __syncwarp();

    const int j = t0 + lane;
    const bool in = j < S;
    bool valid = false;
    if (in) {
      int sp;
      if constexpr (PAGED) {
        const int pi = j / pg.page;
        sp = none ? -1 : pidx[pi] * pg.page + (j - pi * pg.page);
      } else {
        sp = slot_pos[(size_t)b * S + j];
      }
      valid = sp >= 0 && sp <= p && (window <= 0 || sp > p - window);
    }
    float s[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) s[g] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      const float kd = ks[lane * KP + d];
#pragma unroll
      for (int g = 0; g < GM; ++g) s[g] = fmaf(qs[g * D + d], kd, s[g]);
    }
    float pr[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      float x = s[g] * scale;
      if (cap > 0.f) x = cap * tanhf(x / cap);
      if (!valid) x = kNeg;
      const float m_new = fmaxf(m[g], rt::warp_max(x));
      const float alpha = expf(m[g] - m_new);   // 1 while every slot so far is masked
      pr[g] = in ? expf(x - m_new) : 0.f;
      l[g] = l[g] * alpha + rt::warp_sum(pr[g]);
#pragma unroll
      for (int i = 0; i < DL; ++i) acc[g][i] *= alpha;
      m[g] = m_new;
    }
#pragma unroll 4
    for (int jj = 0; jj < kTile; ++jj) {
      float vv[DL];
#pragma unroll
      for (int i = 0; i < DL; ++i) vv[i] = vs[jj * D + lane + 32 * i];
#pragma unroll
      for (int g = 0; g < GM; ++g) {
        const float pj = __shfl_sync(0xffffffffu, pr[g], jj);
#pragma unroll
        for (int i = 0; i < DL; ++i) acc[g][i] = fmaf(pj, vv[i], acc[g][i]);
      }
    }
  }

  // merge the warps' partials; the tile area is free once every warp is here
  __syncthreads();
  float* ms = work;                    // [kWarps][GM]
  float* ls = ms + kWarps * GM;        // [kWarps][GM]
  float* as = ls + kWarps * GM;        // [kWarps][GM][D]
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (lane == 0) {
      ms[w * GM + g] = m[g];
      ls[w * GM + g] = l[g];
    }
#pragma unroll
    for (int i = 0; i < DL; ++i) as[(w * GM + g) * D + lane + 32 * i] = acc[g][i];
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kWarps * 32) {
    const int g = i / D, c = i % D;
    float mg = kNeg;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) mg = fmaxf(mg, ms[ww * GM + g]);
    float lg = 0.f, ag = 0.f;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) {
      const float sc = expf(ms[ww * GM + g] - mg);
      lg = fmaf(ls[ww * GM + g], sc, lg);
      ag = fmaf(as[(ww * GM + g) * D + c], sc, ag);
    }
    o[((size_t)b * H + kh * G + g) * D + c] = rt::from_f32<T>(ag / fmaxf(lg, 1e-30f));
  }
}

template <typename T, int D, int GM, bool PAGED>
cudaError_t launch(const void* q, const void* k, const void* v, const int* sp, const int* pos,
                   void* o, const Paged& pg, int B, int S, int KH, int G, int window,
                   float cap, cudaStream_t s) {
  auto kern = flash_decode_kernel<T, D, GM, PAGED>;
  const size_t bytes = sizeof(float) * smem_floats<D, GM>() + (PAGED ? 2 * sizeof(int) * pg.Mp : 0);
  static size_t attr_bytes = 0;   // per instantiation (> 48 KB needs the opt-in)
  if (bytes > attr_bytes) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    attr_bytes = bytes;
  }
  kern<<<dim3(KH, B), kWarps * 32, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), sp, pos,
      static_cast<T*>(o), pg, S, KH, G, window, cap, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename T, int D, bool PAGED>
cudaError_t dispatch_g(const void* q, const void* k, const void* v, const int* sp,
                       const int* pos, void* o, const Paged& pg, int B, int S, int KH, int G,
                       int window, float cap, cudaStream_t s) {
  if (G == 1) return launch<T, D, 1, PAGED>(q, k, v, sp, pos, o, pg, B, S, KH, G, window, cap, s);
  if (G <= 4) return launch<T, D, 4, PAGED>(q, k, v, sp, pos, o, pg, B, S, KH, G, window, cap, s);
  return launch<T, D, 8, PAGED>(q, k, v, sp, pos, o, pg, B, S, KH, G, window, cap, s);
}

template <typename T, bool PAGED>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, const int* sp,
                       const int* pos, void* o, const Paged& pg, int B, int S, int KH, int G,
                       int D, int window, float cap, cudaStream_t s) {
  if (D == 32) return dispatch_g<T, 32, PAGED>(q, k, v, sp, pos, o, pg, B, S, KH, G, window, cap, s);
  if (D == 64) return dispatch_g<T, 64, PAGED>(q, k, v, sp, pos, o, pg, B, S, KH, G, window, cap, s);
  return dispatch_g<T, 128, PAGED>(q, k, v, sp, pos, o, pg, B, S, KH, G, window, cap, s);
}

template <bool PAGED>
int decode(const void* q, const void* k, const void* v, const int* sp, const int* pos, void* o,
           const Paged& pg, int B, int S, int H, int KH, int D, int window, float cap,
           int dtype, cudaStream_t s) {
  if (B <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  const int G = H / KH;
  const cudaError_t e =
      dtype == rt::kBF16
          ? dispatch_d<__nv_bfloat16, PAGED>(q, k, v, sp, pos, o, pg, B, S, KH, G, D, window, cap, s)
          : dispatch_d<float, PAGED>(q, k, v, sp, pos, o, pg, B, S, KH, G, D, window, cap, s);
  return static_cast<int>(e);
}

}  // namespace

// o = decode attention(q, k, v): q/o [B, H, D], k/v [B, S, KH, D], slot_pos
// [B, S] int32, pos [B] int32, all contiguous; H % KH == 0, H / KH <= 8,
// D in {32, 64, 128}, S >= 1 (checked by the Python wrapper).
extern "C" int rt_flash_decode(const void* q, const void* k, const void* v,
                               const void* slot_pos, const void* pos, void* o, int B, int S,
                               int H, int KH, int D, int window, float cap, int dtype,
                               void* stream) {
  return decode<false>(q, k, v, static_cast<const int*>(slot_pos), static_cast<const int*>(pos),
                       o, Paged{nullptr, 0, 1, 0}, B, S, H, KH, D, window, cap, dtype,
                       static_cast<cudaStream_t>(stream));
}

// o = decode attention(q, kp, vp) through a page table: q/o [B, H, D], kp/vp
// [P1, page, KH, D] (page P1 - 1 is the trash page), table [B, Mp] int32
// with entries in [-1, P1 - 2], pos [B] int32, all contiguous; the same
// H / KH / D rules as rt_flash_decode, and 2·Mp ints of shared memory on top.
extern "C" int rt_flash_decode_paged(const void* q, const void* kp, const void* vp,
                                     const void* table, const void* pos, void* o, int B,
                                     int Mp, int page, int P1, int H, int KH, int D,
                                     int window, float cap, int dtype, void* stream) {
  return decode<true>(q, kp, vp, nullptr, static_cast<const int*>(pos), o,
                      Paged{static_cast<const int*>(table), Mp, page, P1 - 1}, B, Mp, H, KH,
                      D, window, cap, dtype, static_cast<cudaStream_t>(stream));
}
