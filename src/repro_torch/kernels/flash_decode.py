"""Launch wrapper for the hand-written decode attention kernel
(`csrc/flash_decode.cu`).

Port of `repro/kernels/flash_decode.py::flash_decode`: one query token per
batch lane against a ring K/V cache whose slots carry global positions,
with sliding window and tanh logit softcap. Callers go through
`repro_torch.kernels.ops.flash_decode`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8   # query heads per kv head the kernel is instantiated for


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
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode_cuda needs CUDA tensors, got {q.device}")
    if q.dtype not in build.DTYPE_CODES:
        raise ValueError(f"flash_decode: dtype {q.dtype} not supported (float32, bfloat16)")
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError("flash_decode: q [B, H, D] and k, v [B, S, K, D] expected")
    B, H, D = q.shape
    S, K = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_decode: head_dim {D} not in {HEAD_DIMS}")
    if K == 0 or H % K or H // K > MAX_GROUP:
        raise ValueError(f"flash_decode: {H} query heads over {K} kv heads "
                         f"(need a group of 1..{MAX_GROUP})")
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
