"""Launch wrappers for the hand-written expert FFN kernels (`csrc/expert_ffn.cu`,
`csrc/expert_ffn_sm90.cu`).

Port of `repro/kernels/expert_gemm.py::expert_ffn`: xe [E, C, d] ->
act(xe @ w_in) @ w_out per slot (or act(xe @ w_gate) * (xe @ w_in) when
gated). Two GEMM launches: the up-projection with the activation fused
writes h [E, C, F] once in the working dtype, then the down-projection. In
bf16 both run the Hopper TMA + wgmma GEMM on the tiles `gemm_plan` picks for
their shape. `expert_ffn_q` (port of `expert_gemm.py::expert_ffn_q`) is
the same over int8-resident weights with per-output-channel fp32 scales,
which the kernel applies to the fp32 product, and `expert_ffn_q4` (port of
`expert_gemm.py::expert_ffn_q4`) the same over nibble-packed int4 weights
with per-group fp32 scales, which the kernel applies to each weight as it
widens the landed tile. In bf16 the quantised weights run the same Hopper
GEMM, crossing HBM in their own bytes. Callers go through
`repro_torch.kernels.ops`.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import build

ACT_CODES = {"silu": 0, "gelu": 1, "relu": 2, "relu2": 3}
_STORE, _ACT, _GLU = 0, 1, 2   # epilogue codes of rt_expert_gemm
TILE = 64                      # d and F must be multiples of the kernel's N/K tiles
SMS = 132                      # streaming multiprocessors of an H100 SXM
SMEM_ONE, SMEM_TWO = 220 * 1024, 110 * 1024   # shared memory of a block alone on its SM, or of two


def _scale_rows(K: int, group: int) -> int:
    """The most int4 group-scale rows one 64-row stage of the contraction
    touches (csrc/expert_ffn_sm90.cu::scale_rows): 1 when the group is a
    multiple of 64, 2 for 32 or 48, 64 for a group of 1."""
    return max((k0 + TILE - 1) // group - k0 // group + 1 for k0 in range(0, K, TILE))


def _stage_bytes(bm: int, bn: int, gated: bool = False, fmt: str = "fp", srows: int = 1) -> int:
    """Shared-memory bytes of one TMA ring stage of the Hopper GEMM
    (`Cfg::stage`, `SwapCfg::stage`). Per weight tile (two when gated) a
    stage holds, for bf16, the 64 x bn bf16 tile; for int8 the raw 64 x bn
    bytes as they land; for int4 the packed 32 x bn bytes and `srows` fp32
    scale rows. Beside them the bm x 64 bf16 activation tile, and where bm
    is 64 or 128 also the bf16 tile each quantised tile widens into (bm 8
    or 16, the decode tile, widens into `_box_bytes` instead). Rounded up to
    1024 for the 128-byte swizzle."""
    raw = {"fp": 0, "int8": TILE * bn, "int4": TILE // 2 * bn + srows * bn * 4}[fmt]
    if bm < 64:
        return -(-bm * TILE * 2 // 1024) * 1024 + -(-(2 if gated else 1) * raw // 1024) * 1024
    bf16 = TILE * bn * 2
    b = bm * TILE * 2 + (2 if gated else 1) * (bf16 + raw)
    return -(-b // 1024) * 1024


def _box_bytes(bm: int, gated: bool = False) -> int:
    """The decode tile's bf16 box rings (`SwapCfg::BUF_BYTES`): for each of
    its two warpgroups three boxes of 64 x 64 per weight tile; none for bm
    64 or 128."""
    return 2 * 3 * (2 if gated else 1) * TILE * TILE * 2 if bm < 64 else 0


@functools.lru_cache(maxsize=256)
def gemm_plan(E: int, M: int, N: int, K: int, gated: bool = False, fmt: str = "fp",
              group: int = 0) -> tuple[int, int, int, int]:
    """(bm, bn, split, stages) of the bf16 Hopper GEMM C[e] = A[e] [M, K] @ B[e] [K, N],
    B bf16 (`fmt` "fp"), int8, or int4 in groups of `group` contraction rows.

    Quantised weights at M <= 16 take the decode tile (bm 8 or 16: the
    weights are wgmma's A and the M tokens its N), wherever two of its
    stages fit: bn 128 columns a block, two warpgroups of 64 columns each.
    Its split (up to 8, the blocks of a
    cluster) evens out the stages the busiest SM widens; the splits of a
    tile sum in their cluster. Its ring is as deep as fits (up
    to 16 stages) in the SM's shared memory divided among the blocks it
    holds.

    Otherwise bm: 64 rows (one consumer warpgroup) when M fits, else 128
    (two). bn: 128 columns (m64n128 wgmma, fewer shared-memory bytes a
    product), or 64 for a gated up-projection (two accumulators) and where
    128 would leave more than half the SMs without a tile and no split can
    make up for it. split: with few rows (fp32 partials small beside the
    weights, 32·split·M <= K) the contraction is cut in two until the
    blocks cover ~0.7 of the SMs — the bf16 decode down-projection, 24
    tiles of [8, 3072] x [3072, 128], runs as 96 blocks; each split keeps
    at least 4 stages of 64 rows. stages: the depth of the TMA ring — as
    deep as fits (up to 8) when each SM holds one block, half that when
    blocks outnumber the SMs so that two share one; quantised weights
    always take a whole SM, as their stages also hold the bf16 tile they
    widen into. Memoised: the wrapper asks twice a call, and decode asks
    the same shapes every step."""
    srows = _scale_rows(K, group) if fmt == "int4" else 1
    kb = K // TILE
    if (fmt != "fp" and M <= 16 and N % 128 == 0     # two stages and the box rings must fit
            and 2 * _stage_bytes(8, 128, gated, fmt, srows) + _box_bytes(8, gated) <= SMEM_ONE):
        bm, bn = (8 if M <= 8 else 16), 128
        tiles = E * (N // bn)
        # of the splits (1, 2, 4 or 8) that keep 2 stages or more a block and
        # 2 blocks or fewer an SM (each with a deep ring), the one that gives
        # the busiest SM the fewest stages (blocks an SM x stages a block),
        # and of those the most blocks
        split = min((s for s in (1, 2, 4, 8)[:1 if gated else 4]
                     if s == 1 or (kb % s == 0 and kb // s >= 2 and tiles * s <= 2 * SMS)),
                    key=lambda s: (-(-tiles * s // SMS) * (kb // s), -s))
        per_sm = min(3, -(-tiles * split // SMS))
        # an SM's 228 KB over its blocks, less each one's reserved 1 KB, the
        # alignment slack, the barriers, the staged column scales and the box rings
        budget = 228 * 1024 // per_sm - 2048 - 256 - 1024 - _box_bytes(bm, gated)
        return bm, bn, split, max(2, min(16, budget // _stage_bytes(bm, bn, gated, fmt, srows)))
    bm = 64 if M <= 64 else 128
    m_tiles = -(-M // bm)
    bn = 64 if gated or N % 128 else 128
    if bn == 128 and E * m_tiles * (N // 128) < SMS // 2 and 64 * M > K:
        bn = 64
    split = 1
    while (not gated and E * m_tiles * (N // bn) * split < 0.7 * SMS
           and 32 * 2 * split * M <= K
           and kb % (2 * split) == 0 and kb // (2 * split) >= 4):
        split *= 2
    stage = _stage_bytes(bm, bn, gated, fmt, srows)
    budget = SMEM_ONE if E * m_tiles * (N // bn) * split <= SMS or fmt != "fp" else SMEM_TWO
    return bm, bn, split, max(2, min(8, budget // stage))


def _workspace(plan, E: int, C: int, N: int, like: torch.Tensor) -> Optional[torch.Tensor]:
    """The fp32 split-K partials [split, E, C, N] a plan needs, or None: the
    decode tile (bm < 64) sums its splits in the cluster."""
    bm, _, split, _ = plan
    if split == 1 or bm < 64:
        return None
    return torch.empty((split, E, C, N), dtype=torch.float32, device=like.device)


def _check(name: str, t: torch.Tensor, shape, ref: torch.Tensor,
           dtype: Optional[torch.dtype] = None, fn: str = "expert_ffn") -> None:
    dtype = ref.dtype if dtype is None else dtype
    if t.device != ref.device or t.dtype != dtype:
        raise ValueError(f"{fn}: {name} is {t.dtype} on {t.device}, "
                         f"expected {dtype} on {ref.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} must be contiguous and 16-byte aligned")


def _check_x(fn: str, xe: torch.Tensor, act: str) -> None:
    if xe.dtype not in build.DTYPE_CODES:
        raise ValueError(f"{fn}: dtype {xe.dtype} not supported (float32, bfloat16)")
    if act not in ACT_CODES:
        raise ValueError(f"{fn}: unknown activation {act!r}")
    if xe.dim() != 3:
        raise ValueError(f"{fn}: xe [E, C, d] expected")


def _check_cuda(fn: str, xe: torch.Tensor) -> None:
    """Last of a wrapper's checks, so a CPU tensor meets the others first."""
    if xe.device.type != "cuda":
        raise ValueError(f"{fn}_cuda needs CUDA tensors, got {xe.device}")


def expert_ffn_cuda(
    xe: torch.Tensor,                 # [E, C, d]
    w_in: torch.Tensor,               # [E, d, F]
    w_gate: Optional[torch.Tensor],   # [E, d, F] or None (non-gated)
    w_out: torch.Tensor,              # [E, F, d]
    act: str = "silu",
) -> torch.Tensor:
    _check_x("expert_ffn", xe, act)
    if w_in.dim() != 3:
        raise ValueError("expert_ffn: w_in [E, d, F] expected")
    E, C, d = xe.shape
    F = w_in.shape[-1]
    if d % TILE or F % TILE:
        raise ValueError(f"expert_ffn: d={d} and F={F} must be multiples of {TILE}")
    _check("xe", xe, (E, C, d), xe)
    _check("w_in", w_in, (E, d, F), xe)
    if w_gate is not None:
        _check("w_gate", w_gate, (E, d, F), xe)
    _check("w_out", w_out, (E, F, d), xe)
    _check_cuda("expert_ffn", xe)

    lib = build.library()
    dt = build.DTYPE_CODES[xe.dtype]
    gated = w_gate is not None
    h = torch.empty((E, C, F), dtype=xe.dtype, device=xe.device)
    y = torch.empty((E, C, d), dtype=xe.dtype, device=xe.device)
    with torch.cuda.device(xe.device):
        stream = build.stream_handle(xe)
        for name, a, b, b2, out, N, K, epi in (
            ("expert_ffn up", xe, w_in, w_gate, h, F, d, _GLU if gated else _ACT),
            ("expert_ffn down", h, w_out, None, y, d, F, _STORE),
        ):
            # fp32 runs the SIMT kernel, which takes no plan
            plan = (gemm_plan(E, C, N, K, gated=epi == _GLU)
                    if xe.dtype == torch.bfloat16 else (0, 0, 1, 0))
            bm, bn, split, stages = plan
            ws = _workspace(plan, E, C, N, xe)
            build.check(name, lib.rt_expert_gemm(
                a.data_ptr(), b.data_ptr(), b2.data_ptr() if b2 is not None else None,
                out.data_ptr(), ws.data_ptr() if ws is not None else None,
                E, C, N, K, bm, bn, split, stages, dt, epi, ACT_CODES[act], stream,
            ))
    return y


def expert_ffn_q_cuda(
    xe: torch.Tensor,                       # [E, C, d] bf16 / fp32
    w_in_q: torch.Tensor,                   # [E, d, F] int8
    w_in_scale: torch.Tensor,               # [E, 1, F] or [E, F] fp32
    w_gate_q: Optional[torch.Tensor],       # [E, d, F] int8 or None (non-gated)
    w_gate_scale: Optional[torch.Tensor],   # [E, 1, F] or [E, F] fp32, or None
    w_out_q: torch.Tensor,                  # [E, F, d] int8
    w_out_scale: torch.Tensor,              # [E, 1, d] or [E, d] fp32
    act: str = "silu",
) -> torch.Tensor:
    """Returns [E, C, d] in xe's dtype; h is rounded to xe's dtype between
    the two products, as `_ffn_kernel_q` rounds it."""
    _check_x("expert_ffn_q", xe, act)
    if w_in_q.dim() != 3:
        raise ValueError("expert_ffn_q: w_in_q [E, d, F] expected")
    E, C, d = xe.shape
    F = w_in_q.shape[-1]
    if d % TILE or F % TILE:
        raise ValueError(f"expert_ffn_q: d={d} and F={F} must be multiples of {TILE}")
    gated = w_gate_q is not None
    if gated != (w_gate_scale is not None):
        raise ValueError("expert_ffn_q: w_gate_q and w_gate_scale go together")
    _check("xe", xe, (E, C, d), xe, fn="expert_ffn_q")
    _check("w_in_q", w_in_q, (E, d, F), xe, torch.int8, "expert_ffn_q")
    _check("w_out_q", w_out_q, (E, F, d), xe, torch.int8, "expert_ffn_q")
    w_in_scale = w_in_scale.reshape(E, F)
    w_out_scale = w_out_scale.reshape(E, d)
    _check("w_in_scale", w_in_scale, (E, F), xe, torch.float32, "expert_ffn_q")
    _check("w_out_scale", w_out_scale, (E, d), xe, torch.float32, "expert_ffn_q")
    if gated:
        w_gate_scale = w_gate_scale.reshape(E, F)
        _check("w_gate_q", w_gate_q, (E, d, F), xe, torch.int8, "expert_ffn_q")
        _check("w_gate_scale", w_gate_scale, (E, F), xe, torch.float32, "expert_ffn_q")
    _check_cuda("expert_ffn_q", xe)

    lib = build.library()
    dt = build.DTYPE_CODES[xe.dtype]
    h = torch.empty((E, C, F), dtype=xe.dtype, device=xe.device)
    y = torch.empty((E, C, d), dtype=xe.dtype, device=xe.device)
    with torch.cuda.device(xe.device):
        stream = build.stream_handle(xe)
        for name, a, b, bs, b2, b2s, out, N, K, epi in (
            ("expert_ffn_q up", xe, w_in_q, w_in_scale, w_gate_q, w_gate_scale, h, F, d,
             _GLU if gated else _ACT),
            ("expert_ffn_q down", h, w_out_q, w_out_scale, None, None, y, d, F, _STORE),
        ):
            plan = (gemm_plan(E, C, N, K, gated=epi == _GLU, fmt="int8")
                    if xe.dtype == torch.bfloat16 else (0, 0, 1, 0))
            bm, bn, split, stages = plan
            ws = _workspace(plan, E, C, N, xe)
            build.check(name, lib.rt_expert_gemm_q(
                a.data_ptr(), b.data_ptr(), bs.data_ptr(),
                b2.data_ptr() if b2 is not None else None,
                b2s.data_ptr() if b2s is not None else None, out.data_ptr(),
                ws.data_ptr() if ws is not None else None,
                E, C, N, K, bm, bn, split, stages, dt, epi, ACT_CODES[act], stream,
            ))
    return y


def _group(name: str, scale: torch.Tensor, k: int) -> int:
    """The int4 group size along a contraction axis of length k, from the
    scale plane [E, k / group, n]."""
    ng = scale.shape[1] if scale.dim() == 3 else 0
    if ng < 1 or k % ng:
        raise ValueError(f"expert_ffn_q4: {name} has {ng} groups, which do not tile {k} rows")
    return k // ng


def expert_ffn_q4_cuda(
    xe: torch.Tensor,                       # [E, C, d] bf16 / fp32
    w_in_q4: torch.Tensor,                  # [E, d/2, F] uint8
    w_in_scale: torch.Tensor,               # [E, d/g, F] fp32
    w_gate_q4: Optional[torch.Tensor],      # [E, d/2, F] uint8 or None (non-gated)
    w_gate_scale: Optional[torch.Tensor],   # [E, d/g, F] fp32, or None
    w_out_q4: torch.Tensor,                 # [E, F/2, d] uint8
    w_out_scale: torch.Tensor,              # [E, F/g', d] fp32
    act: str = "silu",
) -> torch.Tensor:
    """Returns [E, C, d] in xe's dtype; each weight is dequantised to
    q·s in xe's dtype as the kernel widens its landed tile, and h is rounded
    to xe's dtype between the two products, as the plain version rounds
    them."""
    fn = "expert_ffn_q4"
    _check_x(fn, xe, act)
    if w_in_q4.dim() != 3:
        raise ValueError("expert_ffn_q4: w_in_q4 [E, d/2, F] expected")
    E, C, d = xe.shape
    F = w_in_q4.shape[-1]
    if d % TILE or F % TILE:
        raise ValueError(f"expert_ffn_q4: d={d} and F={F} must be multiples of {TILE}")
    gated = w_gate_q4 is not None
    if gated != (w_gate_scale is not None):
        raise ValueError("expert_ffn_q4: w_gate_q4 and w_gate_scale go together")
    g_in, g_out = _group("w_in_scale", w_in_scale, d), _group("w_out_scale", w_out_scale, F)
    _check("xe", xe, (E, C, d), xe, fn=fn)
    _check("w_in_q4", w_in_q4, (E, d // 2, F), xe, torch.uint8, fn)
    _check("w_in_scale", w_in_scale, (E, d // g_in, F), xe, torch.float32, fn)
    _check("w_out_q4", w_out_q4, (E, F // 2, d), xe, torch.uint8, fn)
    _check("w_out_scale", w_out_scale, (E, F // g_out, d), xe, torch.float32, fn)
    if gated:
        _check("w_gate_q4", w_gate_q4, (E, d // 2, F), xe, torch.uint8, fn)
        _check("w_gate_scale", w_gate_scale, (E, d // g_in, F), xe, torch.float32, fn)
    _check_cuda(fn, xe)

    lib = build.library()
    dt = build.DTYPE_CODES[xe.dtype]
    h = torch.empty((E, C, F), dtype=xe.dtype, device=xe.device)
    y = torch.empty((E, C, d), dtype=xe.dtype, device=xe.device)
    with torch.cuda.device(xe.device):
        stream = build.stream_handle(xe)
        for name, a, b, bs, b2, b2s, out, N, K, g, epi in (
            ("expert_ffn_q4 up", xe, w_in_q4, w_in_scale, w_gate_q4, w_gate_scale, h, F, d,
             g_in, _GLU if gated else _ACT),
            ("expert_ffn_q4 down", h, w_out_q4, w_out_scale, None, None, y, d, F, g_out, _STORE),
        ):
            plan = (gemm_plan(E, C, N, K, gated=epi == _GLU, fmt="int4", group=g)
                    if xe.dtype == torch.bfloat16 else (0, 0, 1, 0))
            bm, bn, split, stages = plan
            ws = _workspace(plan, E, C, N, xe)
            build.check(name, lib.rt_expert_gemm_q4(
                a.data_ptr(), b.data_ptr(), bs.data_ptr(),
                b2.data_ptr() if b2 is not None else None,
                b2s.data_ptr() if b2s is not None else None, out.data_ptr(),
                ws.data_ptr() if ws is not None else None,
                E, C, N, K, g, bm, bn, split, stages, dt, epi, ACT_CODES[act], stream,
            ))
    return y
