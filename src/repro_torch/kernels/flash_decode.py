"""Launch wrapper for the hand-written decode attention kernel
(`csrc/flash_decode.cu`).

Port of `repro/kernels/flash_decode.py::flash_decode`: one query token per
batch lane against a ring K/V cache whose slots carry global positions,
with sliding window and tanh logit softcap; and of
`flash_decode.py::flash_decode_paged`, the same read through a page table
into a shared page pool. The kernel splits each (lane, kv head)'s keys over
a thread-block cluster and merges the blocks' partials inside it;
`decode_plan` picks the split. A block holds up to `GROUP_BLOCK` query
heads of its kv head; a larger group runs in blocks of that many. Callers
go through `repro_torch.kernels.ops`.
"""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.expert_gemm import SMS

HEAD_DIMS = (32, 64, 128, 160, 256)
MAX_GROUP = 16                  # query heads per kv head the kernel takes
GROUP_BLOCK = 8                 # query heads a block holds in registers
SMEM_LIMIT = 227 * 1024 - 256   # dynamic shared memory a block may take (less the static)
WARPS = 4                       # warps a block
KEYS_PER_ROW = 4                # keys a row of lanes takes from each ring stage
MAX_SPLITS = 8                  # blocks a cluster (the portable cluster size)
STAGES = 2                      # the depth of each block's cp.async ring: a double buffer
MIN_BLOCKS = 2 * SMS            # the split aims at two blocks an SM or more


def _check_q(fn: str, q: torch.Tensor, K: int) -> None:
    """q's type and shape, then its device, so a CPU tensor meets the shape
    refusals first."""
    if q.dtype not in build.DTYPE_CODES:
        raise ValueError(f"{fn}: dtype {q.dtype} not supported (float32, bfloat16)")
    if q.dim() != 3:
        raise ValueError(f"{fn}: q [B, H, D] expected")
    H, D = q.shape[1], q.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"{fn}: head_dim {D} not in {HEAD_DIMS}")
    if K == 0 or H % K or H // K > MAX_GROUP:
        raise ValueError(f"{fn}: {H} query heads over {K} kv heads "
                         f"(need a group of 1..{MAX_GROUP})")
    if q.device.type != "cuda":
        raise ValueError(f"{fn}_cuda needs CUDA tensors, got {q.device}")


def _row_lanes(D: int, esize: int) -> int:
    """Lanes that span a key row (csrc/flash_decode.cu `Geo::TX`): one a
    16-byte piece when the pieces divide a warp, else the whole warp."""
    pieces = D * esize // 16
    return pieces if pieces <= 32 and 32 % pieces == 0 else 32


def _head_blocks(G: int) -> int:
    """Blocks a (lane, kv head) runs its G query heads in."""
    return -(-G // GROUP_BLOCK)


def _tile_keys(D: int, esize: int) -> int:
    """Keys of one ring stage: KEYS_PER_ROW for each row of lanes that a
    block of WARPS warps holds at once."""
    return WARPS * (32 // _row_lanes(D, esize)) * KEYS_PER_ROW


def _smem_bytes(G: int, D: int, esize: int, splits: int, Mp: Optional[int] = None) -> int:
    """The kernel's dynamic shared memory (csrc/flash_decode.cu `Layout`),
    for elements of `esize` bytes: the ring, `STAGES` x (K and V tiles and
    each key's int position), or the warps' fp32 partials [4][GM][D + 2],
    which reuse it, whichever is larger; the cluster's block partials
    [splits][GM][D + 2] (rank 0's are merged); the 8-byte mbarrier; and for
    the paged kernel (`Mp` entries a table row) the page list, 2 x Mp ints.
    GM is the heads a block holds, G rounded up to 1, 4 or 8 (8 above 8)."""
    gm = 1 if G == 1 else 4 if G <= 4 else 8
    bk = _tile_keys(D, esize)
    stage = 2 * bk * D * esize + 4 * bk
    work = max(STAGES * stage, WARPS * gm * (D + 2) * 4)
    return work + splits * gm * (D + 2) * 4 + 8 + (8 * Mp if Mp is not None else 0)


@functools.lru_cache(maxsize=256)
def decode_plan(B: int, KH: int, S: int, G: int, D: int,
                dtype: torch.dtype) -> int:
    """The split of the decode kernel for B lanes x KH kv heads over S keys a
    lane (the ring's slots, or the table's Mp x page), G query heads a kv
    head, head dim D: the blocks of a cluster that share one (lane, kv
    head, head block)'s keys, 1, 2, 4 or 8. The fewest that give the grid
    at least two blocks an SM (`MIN_BLOCKS`), while every block of a full
    ring keeps a tile of its own (2 x splits <= the tiles of S before each
    doubling). So the served [8 lanes, 12 kv heads] over 512 keys runs
    96 x 4 blocks, and a tiny S runs unsplit. G counts only through its
    head blocks (two at G 16). Memoised: decode asks the same shapes every
    step."""
    tiles = -(-S // _tile_keys(D, 2 if dtype == torch.bfloat16 else 4))
    units = B * KH * _head_blocks(G)
    splits = 1
    while splits < MAX_SPLITS and 2 * splits <= tiles and units * splits < MIN_BLOCKS:
        splits *= 2
    return splits


def flash_decode_cuda(
    q: torch.Tensor,          # [B, H, D]
    k: torch.Tensor,          # [B, S, K, D]
    v: torch.Tensor,          # [B, S, K, D]
    slot_pos: torch.Tensor,   # [B, S] int32, -1 = invalid
    pos: torch.Tensor,        # [B] int32
    window: int = 0,
    cap: float = 0.0,
) -> torch.Tensor:
    """Returns [B, H, D] in q's dtype."""
    if k.dim() != 4:
        raise ValueError("flash_decode: q [B, H, D] and k, v [B, S, K, D] expected")
    _check_q("flash_decode", q, k.shape[2])
    B, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    if S < 1:
        raise ValueError("flash_decode: the cache needs at least one slot")
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (B, S, K, D) or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_decode: {name} is {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}, expected {(B, S, K, D)} {q.dtype} on {q.device}")
    for name, t, shape in (("slot_pos", slot_pos, (B, S)), ("pos", pos, (B,))):
        if tuple(t.shape) != shape or t.dtype != torch.int32 or t.device != q.device:
            raise ValueError(f"flash_decode: {name} is {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}, expected {shape} int32 on {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v), ("slot_pos", slot_pos), ("pos", pos)):
        if not t.is_contiguous():
            raise ValueError(f"flash_decode: {name} must be contiguous")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_decode: q, k and v must be 16-byte aligned (vector loads)")
    if window < 0 or cap < 0:
        raise ValueError("flash_decode: window and cap must be >= 0")
    splits = decode_plan(B, K, S, H // K, D, q.dtype)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        build.check("flash_decode", build.library().rt_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), slot_pos.data_ptr(), pos.data_ptr(),
            out.data_ptr(), B, S, H, K, D, int(window), float(cap), splits,
            build.DTYPE_CODES[q.dtype], build.stream_handle(q),
        ))
    return out


def flash_decode_paged_cuda(
    q: torch.Tensor,            # [B, H, D]
    kp: torch.Tensor,           # [P+1, page, K, D] (page P is the trash page)
    vp: torch.Tensor,           # [P+1, page, K, D]
    page_table: torch.Tensor,   # [B, Mp] int32, entries in [-1, P-1]
    pos: torch.Tensor,          # [B] int32
    window: int = 0,
    cap: float = 0.0,
) -> torch.Tensor:
    """Returns [B, H, D] in q's dtype. The table's entries are not checked
    on the device: one past the pool reads foreign memory."""
    fn = "flash_decode_paged"
    if kp.dim() != 4:
        raise ValueError(f"{fn}: kp, vp [P+1, page, K, D] expected")
    P1, page, K, D = kp.shape
    _check_q(fn, q, K)
    B, H = q.shape[0], q.shape[1]
    if q.shape[2] != D or page < 1 or P1 < 1:
        raise ValueError(f"{fn}: pool {tuple(kp.shape)} does not fit q {tuple(q.shape)}")
    for name, t in (("kp", kp), ("vp", vp)):
        if tuple(t.shape) != (P1, page, K, D) or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{fn}: {name} is {tuple(t.shape)} {t.dtype} on {t.device}, "
                             f"expected {(P1, page, K, D)} {q.dtype} on {q.device}")
    if page_table.dim() != 2 or page_table.shape[0] != B or page_table.shape[1] < 1:
        raise ValueError(f"{fn}: page_table [B, Mp] expected, got {tuple(page_table.shape)}")
    Mp = page_table.shape[1]
    for name, t, shape in (("page_table", page_table, (B, Mp)), ("pos", pos, (B,))):
        if tuple(t.shape) != shape or t.dtype != torch.int32 or t.device != q.device:
            raise ValueError(f"{fn}: {name} is {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}, expected {shape} int32 on {q.device}")
    for name, t in (("q", q), ("kp", kp), ("vp", vp), ("page_table", page_table), ("pos", pos)):
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if q.data_ptr() % 16 or kp.data_ptr() % 16 or vp.data_ptr() % 16:
        raise ValueError(f"{fn}: q, kp and vp must be 16-byte aligned (vector loads)")
    if window < 0 or cap < 0:
        raise ValueError(f"{fn}: window and cap must be >= 0")
    if Mp * page * page >= 1 << 40:
        raise ValueError(f"{fn}: a table of {Mp} pages of {page} is past the kernel's page "
                         f"arithmetic (Mp * page^2 < 2^40)")
    splits = decode_plan(B, K, Mp * page, H // K, D, q.dtype)
    if _smem_bytes(H // K, D, q.element_size(), splits, Mp) > SMEM_LIMIT:
        raise ValueError(f"{fn}: a table of {Mp} pages a lane needs more shared memory "
                         f"than a block has")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        build.check(fn, build.library().rt_flash_decode_paged(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), page_table.data_ptr(), pos.data_ptr(),
            out.data_ptr(), B, Mp, page, P1, H, K, D, int(window), float(cap), splits,
            build.DTYPE_CODES[q.dtype], build.stream_handle(q),
        ))
    return out
