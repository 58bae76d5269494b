"""Launch wrapper for the hand-written prefill attention kernel
(`csrc/flash_prefill.cu`).

Port of `repro/kernels/flash_prefill.py::flash_prefill`: full-sequence GQA
flash attention with causal masking, sliding window and tanh logit softcap.
bf16 runs on the tensor cores (64 query rows a block, P rounded to bf16
before P V; at head_dim 256 Q is read from shared memory); fp32 on the CUDA
cores, in IEEE fp32.
Callers go through `repro_torch.kernels.ops.flash_prefill`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

HEAD_DIMS = (32, 64, 128, 160, 256)


def flash_prefill_cuda(
    q: torch.Tensor,   # [B, S, H, D]
    k: torch.Tensor,   # [B, S, K, D]
    v: torch.Tensor,   # [B, S, K, D]
    window: int = 0,
    cap: float = 0.0,
    causal: bool = True,
) -> torch.Tensor:
    """Returns [B, S, H, D] in q's dtype. Shapes and types are checked before
    the device, so a CPU tensor meets those refusals first."""
    if q.dtype not in build.DTYPE_CODES:
        raise ValueError(f"flash_prefill: dtype {q.dtype} not supported (float32, bfloat16)")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("flash_prefill: q [B, S, H, D] and k, v [B, S, K, D] expected")
    B, S, H, D = q.shape
    K = k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_prefill: head_dim {D} not in {HEAD_DIMS}")
    if K == 0 or H % K:
        raise ValueError(f"flash_prefill: {H} query heads do not group over {K} kv heads")
    for name, t in (("k", k), ("v", v)):
        if tuple(t.shape) != (B, S, K, D) or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"flash_prefill: {name} is {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}, expected {(B, S, K, D)} {q.dtype} on {q.device}")
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
            B, S, H, K, D, int(window), float(cap), int(bool(causal)),
            build.DTYPE_CODES[q.dtype], build.stream_handle(q),
        ))
    return out
