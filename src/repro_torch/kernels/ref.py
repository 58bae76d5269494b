"""Plain PyTorch versions of the kernels on the serving and decode paths.

Port of `repro/kernels/ref.py`: the oracles of `expert_ffn`, `sparsemax`,
`flash_prefill`, `flash_decode` and the int8 `expert_ffn_q` (the int4 and
paged oracles come with their slices, ROADMAP A11-int4 and A12).
`kernels.ops` runs these for CPU tensors, the tests hold them against the
JAX oracles, and `chip_smoke.py` holds each CUDA kernel against them on the
card.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.models.layers import act_fn


def expert_ffn_ref(
    xe: torch.Tensor,                 # [E, C, d]
    w_in: torch.Tensor,               # [E, d, F]
    w_gate: Optional[torch.Tensor],   # [E, d, F] or None
    w_out: torch.Tensor,              # [E, F, d]
    act: str = "silu",
) -> torch.Tensor:
    """Per-expert (G)LU FFN over the capacity buffer."""
    f = act_fn(act)
    h = torch.einsum("ecd,edf->ecf", xe, w_in)
    if w_gate is not None:
        h = f(torch.einsum("ecd,edf->ecf", xe, w_gate)) * h
    else:
        h = f(h)
    return torch.einsum("ecf,efd->ecd", h, w_out)


def dequantize_ref(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 tensor + per-output-channel scale plane -> f32 weights."""
    return q.float() * scale.float()


def expert_ffn_q_ref(
    xe: torch.Tensor,                       # [E, C, d]
    w_in_q: torch.Tensor,                   # [E, d, F] int8
    w_in_scale: torch.Tensor,               # [E, 1, F] (or [E, F])
    w_gate_q: Optional[torch.Tensor],       # [E, d, F] int8 or None
    w_gate_scale: Optional[torch.Tensor],   # [E, 1, F] or None
    w_out_q: torch.Tensor,                  # [E, F, d] int8
    w_out_scale: torch.Tensor,              # [E, 1, d] (or [E, d])
    act: str = "silu",
) -> torch.Tensor:
    """Dequantize-then-compute: the weights are rounded to xe's dtype after
    the dequant, then the plain FFN. Scales are per output channel, so
    x @ (q·s) == (x @ q)·s: the contract for the fused kernel."""
    E = xe.shape[0]
    wi = dequantize_ref(w_in_q, w_in_scale.reshape(E, 1, -1)).to(xe.dtype)
    wg = None
    if w_gate_q is not None:
        wg = dequantize_ref(w_gate_q, w_gate_scale.reshape(E, 1, -1)).to(xe.dtype)
    wo = dequantize_ref(w_out_q, w_out_scale.reshape(E, 1, -1)).to(xe.dtype)
    return expert_ffn_ref(xe, wi, wg, wo, act=act)


def sparsemax_ref(z: torch.Tensor) -> torch.Tensor:
    """Row-wise Euclidean projection onto the simplex (Martins & Astudillo)."""
    K = z.shape[-1]
    z_sorted = torch.sort(z, dim=-1, descending=True).values
    z_cum = z_sorted.cumsum(dim=-1)
    ks = torch.arange(1, K + 1, dtype=z.dtype, device=z.device)
    support = z_sorted * ks > (z_cum - 1.0)
    k_z = support.sum(dim=-1, keepdim=True)
    tau = (torch.gather(z_cum, -1, k_z - 1) - 1.0) / k_z.to(z.dtype)
    return torch.clamp(z - tau, min=0.0)


def flash_prefill_ref(
    q: torch.Tensor,   # [B, S, H, D]
    k: torch.Tensor,   # [B, S, K, D]
    v: torch.Tensor,   # [B, S, K, D]
    window: int = 0,
    cap: float = 0.0,
    causal: bool = True,
) -> torch.Tensor:
    """Full-sequence GQA attention with windows/softcaps (exact softmax, fp32)."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, D).float()
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(D)
    if cap:
        logits = cap * torch.tanh(logits / cap)
    pos = torch.arange(S, device=q.device)
    mask = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        mask &= pos[:, None] >= pos[None, :]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w, v.float())
    return out.reshape(B, S, H, D)


def flash_decode_ref(
    q: torch.Tensor,          # [B, H, D]
    k: torch.Tensor,          # [B, S, K, D]
    v: torch.Tensor,          # [B, S, K, D]
    slot_pos: torch.Tensor,   # [B, S] int32 (-1 = invalid)
    pos: torch.Tensor,        # [B] int32
    window: int = 0,
    cap: float = 0.0,
) -> torch.Tensor:
    """One-token attention over a (ring-buffer) KV cache with masking (fp32).
    Masked logits are -1e30, so a lane with no valid slot averages V."""
    B, H, D = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, D).float()
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) / math.sqrt(D)
    if cap:
        logits = cap * torch.tanh(logits / cap)
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    if window:
        valid &= slot_pos > (pos[:, None] - window)
    logits = torch.where(valid[:, None, None, :], logits, torch.full_like(logits, -1e30))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", w, v.float())
    return out.reshape(B, H, D)
