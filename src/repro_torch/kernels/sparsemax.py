"""Launch wrapper for the hand-written SparseMax kernel (`csrc/sparsemax.cu`).

Port of `repro/kernels/sparsemax.py::sparsemax`: row-wise projection onto
the simplex along the last axis, one warp per row, the threshold found
exactly by shrinking the support from max(z) - 1 (no bisection). Callers go
through `repro_torch.kernels.ops.sparsemax`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

MAX_L = 1024   # a row lives in one warp's registers (32 lanes x 32 values)


def sparsemax_cuda(z: torch.Tensor) -> torch.Tensor:
    """z [..., L] fp32 on CUDA -> simplex projection along the last axis."""
    if z.device.type != "cuda":
        raise ValueError(f"sparsemax_cuda needs a CUDA tensor, got {z.device}")
    if z.dtype != torch.float32:
        raise ValueError(f"sparsemax: dtype {z.dtype} not supported (float32)")
    if not z.is_contiguous():
        raise ValueError("sparsemax: input must be contiguous")
    L = z.shape[-1]
    if not 1 <= L <= MAX_L:
        raise ValueError(f"sparsemax: row length {L} outside [1, {MAX_L}]")
    rows = z.numel() // L
    out = torch.empty_like(z)
    with torch.cuda.device(z.device):
        build.check("sparsemax", build.library().rt_sparsemax(
            z.data_ptr(), out.data_ptr(), rows, L, build.stream_handle(z),
        ))
    return out
