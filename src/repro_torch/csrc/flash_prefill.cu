// GQA flash-attention forward (prefill) for Hopper.
//
// Replaces: src/repro/kernels/flash_prefill.py::flash_prefill (body
// _prefill_kernel): causal masking, sliding window, tanh logit softcap and
// an online softmax whose (m, l, acc) carry lives in VMEM scratch across the
// sequential KV-tile grid axis.
//
// What bounds it on the H100: at the serving shape (B 8, S 256, H = K = 12,
// D 64, bf16, causal) the work is ~0.8 GFLOP of QK^T and PV against ~4.7 MB
// of q/k/v/o, ~170 FLOP/byte — under the tensor-core ridge, so a tuned kernel
// is bound by HBM; this first version runs on the fp32 CUDA cores, which
// bound it instead.
//
// Design. Blocks run in parallel in no order, so the TPU's sequential KV
// grid axis becomes a loop inside the block. One warp owns one query row and
// keeps (m, l) in registers and its D/32 slice of acc per lane; a block of
// kRows warps shares each K/V tile of kTile keys through shared memory
// (converted to fp32 once). Lane j scores key j of the tile, the warp
// reduces the tile max / sum with shuffles, and broadcasts each p_j to the
// lanes for the PV update. The block only visits key tiles its rows can see
// (causal upper bound, window lower bound); keys masked inside a visited
// tile get p = 0 exactly, and a tile with no visible key for a row leaves
// its carry untouched — the Pallas kernel's zeroing of fully-masked tiles.
// Probabilities stay fp32 (as flash_prefill.py keeps them) and the output is
// rounded once to the input dtype. Any S works: rows and keys are masked
// against S (the Pallas kernel asserted S % bq == 0).
#include "common.cuh"

namespace {

constexpr int kRows = 8;   // query rows (warps) per block
constexpr int kTile = 32;  // keys per shared-memory tile (one per lane)

template <typename T, int D>
__global__ void __launch_bounds__(kRows * 32)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     int S, int H, int KH, int window, float cap, int causal,
                     float scale) {
  constexpr int DL = D / 32;  // acc values per lane
  __shared__ float qs[kRows][D];
  __shared__ float ks[kTile][D + 1];  // +1: lane j reads row j, conflict-free
  __shared__ float vs[kTile][D];

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kRows;
  const int kh = h / (H / KH);
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int row = q0 + w;
  const bool row_ok = row < S;

  for (int i = tid; i < kRows * D; i += kRows * 32) {
    const int r = i / D, c = i % D;
    qs[r][c] = (q0 + r < S) ? rt::to_f32(q[(((size_t)b * S + q0 + r) * H + h) * D + c]) : 0.f;
  }

  // key range any row of this block can see
  const int q_last = min(q0 + kRows, S) - 1;
  const int k_end = causal ? q_last + 1 : S;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) : 0;

  float m = -INFINITY, l = 0.f, acc[DL];
#pragma unroll
  for (int i = 0; i < DL; ++i) acc[i] = 0.f;

  for (int t0 = k_begin; t0 < k_end; t0 += kTile) {
    __syncthreads();  // previous tile fully consumed (and qs written)
    for (int i = tid; i < kTile * D; i += kRows * 32) {
      const int r = i / D, c = i % D;
      float kv = 0.f, vv = 0.f;
      if (t0 + r < S) {
        const size_t off = (((size_t)b * S + t0 + r) * KH + kh) * D + c;
        kv = rt::to_f32(k[off]);
        vv = rt::to_f32(v[off]);
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
    T* orow = o + (((size_t)b * S + row) * H + h) * D;
#pragma unroll
    for (int i = 0; i < DL; ++i) orow[lane + 32 * i] = rt::from_f32<T>(acc[i] * inv);
  }
}

template <typename T, int D>
void launch(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
            int KH, int window, float cap, int causal, cudaStream_t s) {
  dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_prefill_kernel<T, D><<<grid, kRows * 32, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, KH, window, cap, causal, 1.0f / sqrtf((float)D));
}

template <typename T>
void dispatch_d(const void* q, const void* k, const void* v, void* o, int B, int S, int H,
                int KH, int D, int window, float cap, int causal, cudaStream_t s) {
  if (D == 32) launch<T, 32>(q, k, v, o, B, S, H, KH, window, cap, causal, s);
  else if (D == 64) launch<T, 64>(q, k, v, o, B, S, H, KH, window, cap, causal, s);
  else launch<T, 128>(q, k, v, o, B, S, H, KH, window, cap, causal, s);
}

}  // namespace

// o = attention(q, k, v): q/o [B, S, H, D], k/v [B, S, KH, D], contiguous,
// H % KH == 0, D in {32, 64, 128} (checked by the Python wrapper).
extern "C" int rt_flash_prefill(const void* q, const void* k, const void* v, void* o,
                                int B, int S, int H, int KH, int D, int window,
                                float cap, int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B > 0 && S > 0) {
    if (dtype == rt::kBF16)
      dispatch_d<__nv_bfloat16>(q, k, v, o, B, S, H, KH, D, window, cap, causal, s);
    else
      dispatch_d<float>(q, k, v, o, B, S, H, KH, D, window, cap, causal, s);
  }
  return static_cast<int>(cudaGetLastError());
}
