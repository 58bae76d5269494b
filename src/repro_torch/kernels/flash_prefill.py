"""Launch wrapper for the hand-written prefill attention kernel
(`csrc/flash_prefill.cu`).

Port of `repro/kernels/flash_prefill.py::flash_prefill`: full-sequence GQA
flash attention with causal masking, sliding window and tanh logit softcap.
bf16 runs on the tensor cores (64 query rows a block, P rounded to bf16
before P V; at head_dim 256 Q is read from shared memory); fp32 on the CUDA
cores, in IEEE fp32. The keys may be fewer or more than the queries
(cross-attention over an encoder's output) when nothing is masked: no
causal mask and no window.
Callers go through `repro_torch.kernels.ops.flash_prefill`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 128, 160, 256)


def check_key_length(S: int, S_kv: int, window: int, causal: bool) -> None:
    """A key length of its own (S_kv != S) only in cross-attention's form:
    a causal mask or a window compares query and key positions, which two
    sequences of different lengths do not share."""
    if S_kv != S and (causal or window):
        raise ValueError(f"flash_prefill: {S} queries over {S_kv} keys needs causal=False "
                         f"and window=0 (cross-attention), got causal={causal}, window={window}")


def flash_prefill_cuda(
    q: torch.Tensor,   # [B, S, H, D]
    k: torch.Tensor,   # [B, S_kv, K, D]
    v: torch.Tensor,   # [B, S_kv, K, D]
    window: int = 0,
    cap: float = 0.0,
    causal: bool = True,
) -> torch.Tensor:
    """Returns [B, S, H, D] in q's dtype. Shapes and types are checked before
    the device, so a CPU tensor meets those refusals first."""
    if q.dtype not in build.DTYPE_CODES:
        raise ValueError(f"flash_prefill: dtype {q.dtype} not supported (float32, bfloat16)")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_prefill: q [B, S, H, D] and k, v [B, S_kv, K, D] expected")
    B, S, H, D = q.shape
    S_kv, K = k.shape[1], k.shape[2]
    check_key_length(S, S_kv, window, causal)
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_prefill: head_dim {D} not in {HEAD_DIMS}")
    if K == 0 or H % K:
        raise ValueError(f"flash_prefill: {H} query heads do not group over {K} kv heads")
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (B, S_kv, K, D) or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_prefill: {name} is {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}, expected {(B, S_kv, K, D)} {q.dtype} on {q.device}")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_prefill: q, k, v must be contiguous and 16-byte aligned")
    if window < 0 or cap < 0:
        raise ValueError("flash_prefill: window and cap must be >= 0")
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill_cuda needs CUDA tensors, got {q.device}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        build.check("flash_prefill", build.library().rt_flash_prefill(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, S, S_kv, H, K, D, int(window), float(cap), int(bool(causal)),
            build.DTYPE_CODES[q.dtype], build.stream_handle(q),
        ))
    return out
