"""Launch wrapper for the hand-written decode attention kernel
(`csrc/flash_decode.cu`).

Port of `repro/kernels/flash_decode.py::flash_decode`: one query token per
batch lane against a ring K/V cache whose slots carry global positions,
with sliding window and tanh logit softcap; and of
`flash_decode.py::flash_decode_paged`, the same read through a page table
into a shared page pool. Callers go through `repro_torch.kernels.ops`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8   # query heads per kv head the kernel is instantiated for
SMEM_LIMIT = 227 * 1024 - 256   # dynamic shared memory a block may take (less the static)


def _check_q(fn: str, q: torch.Tensor, K: int) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{fn}_cuda needs CUDA tensors, got {q.device}")
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


def _smem_bytes(G: int, D: int) -> int:
    """The kernel's dynamic shared memory before the page list
    (csrc/flash_decode.cu smem_floats)."""
    gm = 1 if G == 1 else 4 if G <= 4 else 8
    return 4 * (gm * D + max(4 * 32 * (2 * D + 1), 4 * gm * (D + 2)))


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
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_decode: k and v must be 16-byte aligned (vector loads)")
    if window < 0 or cap < 0:
        raise ValueError("flash_decode: window and cap must be >= 0")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        build.check("flash_decode", build.library().rt_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), slot_pos.data_ptr(), pos.data_ptr(),
            out.data_ptr(), B, S, H, K, D, int(window), float(cap),
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
    if kp.data_ptr() % 16 or vp.data_ptr() % 16:
        raise ValueError(f"{fn}: kp and vp must be 16-byte aligned (vector loads)")
    if window < 0 or cap < 0:
        raise ValueError(f"{fn}: window and cap must be >= 0")
    if _smem_bytes(H // K, D) + 8 * Mp > SMEM_LIMIT:
        raise ValueError(f"{fn}: a table of {Mp} pages a lane needs more shared memory "
                         f"than a block has")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        build.check(fn, build.library().rt_flash_decode_paged(
            q.data_ptr(), kp.data_ptr(), vp.data_ptr(), page_table.data_ptr(), pos.data_ptr(),
            out.data_ptr(), B, Mp, page, P1, H, K, D, int(window), float(cap),
            build.DTYPE_CODES[q.dtype], build.stream_handle(q),
        ))
    return out
