"""Launch wrapper for the hand-written expert FFN kernel (`csrc/expert_ffn.cu`).

Port of `repro/kernels/expert_gemm.py::expert_ffn`: xe [E, C, d] ->
act(xe @ w_in) @ w_out per slot (or act(xe @ w_gate) * (xe @ w_in) when
gated). Two launches of one GEMM kernel: the up-projection with the
activation fused writes h [E, C, F] once in the working dtype, then the
down-projection. Callers go through `repro_torch.kernels.ops.expert_ffn`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

ACT_CODES = {"silu": 0, "gelu": 1, "relu": 2}
_STORE, _ACT, _GLU = 0, 1, 2   # epilogue codes of rt_expert_gemm
TILE = 64                      # d and F must be multiples of the kernel's N/K tiles


def _check(name: str, t: torch.Tensor, shape, ref: torch.Tensor) -> None:
    if t.device != ref.device or t.dtype != ref.dtype:
        raise ValueError(f"expert_ffn: {name} is {t.dtype} on {t.device}, "
                         f"expected {ref.dtype} on {ref.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"expert_ffn: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"expert_ffn: {name} must be contiguous and 16-byte aligned")


def expert_ffn_cuda(
    xe: torch.Tensor,                 # [E, C, d]
    w_in: torch.Tensor,               # [E, d, F]
    w_gate: Optional[torch.Tensor],   # [E, d, F] or None (non-gated)
    w_out: torch.Tensor,              # [E, F, d]
    act: str = "silu",
) -> torch.Tensor:
    if xe.device.type != "cuda":
        raise ValueError(f"expert_ffn_cuda needs CUDA tensors, got {xe.device}")
    if xe.dtype not in build.DTYPE_CODES:
        raise ValueError(f"expert_ffn: dtype {xe.dtype} not supported (float32, bfloat16)")
    if act not in ACT_CODES:
        raise ValueError(f"expert_ffn: unknown activation {act!r}")
    if xe.dim() != 3 or w_in.dim() != 3:
        raise ValueError("expert_ffn: xe [E, C, d] and w_in [E, d, F] expected")
    E, C, d = xe.shape
    F = w_in.shape[-1]
    if d % TILE or F % TILE:
        raise ValueError(f"expert_ffn: d={d} and F={F} must be multiples of {TILE}")
    _check("xe", xe, (E, C, d), xe)
    _check("w_in", w_in, (E, d, F), xe)
    if w_gate is not None:
        _check("w_gate", w_gate, (E, d, F), xe)
    _check("w_out", w_out, (E, F, d), xe)

    lib = build.library()
    dt = build.DTYPE_CODES[xe.dtype]
    h = torch.empty((E, C, F), dtype=xe.dtype, device=xe.device)
    y = torch.empty((E, C, d), dtype=xe.dtype, device=xe.device)
    with torch.cuda.device(xe.device):
        stream = build.stream_handle(xe)
        up = _GLU if w_gate is not None else _ACT
        build.check("expert_ffn up", lib.rt_expert_gemm(
            xe.data_ptr(), w_in.data_ptr(),
            w_gate.data_ptr() if w_gate is not None else None, h.data_ptr(),
            E, C, F, d, dt, up, ACT_CODES[act], stream,
        ))
        build.check("expert_ffn down", lib.rt_expert_gemm(
            h.data_ptr(), w_out.data_ptr(), None, y.data_ptr(),
            E, C, d, F, dt, _STORE, ACT_CODES[act], stream,
        ))
    return y
