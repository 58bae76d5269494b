"""Launch wrapper for the hand-written SparseMax kernel (`csrc/sparsemax.cu`).

Port of `repro/kernels/sparsemax.py::sparsemax`: row-wise projection onto
the simplex along the last axis, the threshold found exactly by shrinking
the support from max(z) - 1 (no bisection). Rows of up to 1024 values take
one warp a row, longer ones one block a row; any row length and fp32, bf16
or fp16 input, read as fp32 and written in z's dtype, as the Pallas body.
Callers go through `repro_torch.kernels.ops.sparsemax`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

# dtype codes shared with csrc/sparsemax.cu
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def sparsemax_cuda(z: torch.Tensor) -> torch.Tensor:
    """z [..., L] fp32 / bf16 / fp16 on CUDA -> simplex projection along the
    last axis, in z's dtype."""
    if z.device.type != "cuda":
        raise ValueError(f"sparsemax_cuda needs a CUDA tensor, got {z.device}")
    if z.dtype not in DTYPES:
        raise ValueError(f"sparsemax: dtype {z.dtype} not supported (float32, bfloat16, float16)")
    if not z.is_contiguous():
        raise ValueError("sparsemax: input must be contiguous")
    L = z.shape[-1]
    if L < 1:
        raise ValueError(f"sparsemax: row length {L} must be at least 1")
    rows = z.numel() // L
    out = torch.empty_like(z)
    with torch.cuda.device(z.device):
        build.check("sparsemax", build.library().rt_sparsemax(
            z.data_ptr(), out.data_ptr(), rows, L, DTYPES[z.dtype], build.stream_handle(z),
        ))
    return out
