"""Plain PyTorch versions of the kernels on the serving and decode paths.

Port of `repro/kernels/ref.py`: the oracles of `expert_ffn`, `sparsemax`,
`flash_prefill`, `flash_decode`, the int8 `expert_ffn_q`, the int4
`expert_ffn_q4` and the paged `flash_decode_paged`. `kernels.ops` runs these
for CPU tensors, the tests hold them against the JAX oracles, and
`chip_smoke.py` holds each CUDA kernel against them on the card.
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


def unpack_int4_ref(packed: torch.Tensor, k: int) -> torch.Tensor:
    """Nibble-packed uint8 [..., ceil(k/2), n] -> int8 [..., k, n].

    Byte i holds contraction rows 2i (low nibble) and 2i+1 (high nibble),
    two's complement int4 in [-8, 7] (`core.offload.quantize_stack_int4`)."""
    lo = (packed & 0xF).to(torch.int8)
    hi = (packed >> 4).to(torch.int8)
    v = torch.stack([lo, hi], dim=-2)                      # [..., k/2, 2, n]
    v = v.reshape(*packed.shape[:-2], -1, packed.shape[-1])[..., :k, :]
    return torch.where(v >= 8, v - 16, v)


def dequantize_q4_ref(packed: torch.Tensor, scale: torch.Tensor, k: int) -> torch.Tensor:
    """int4-packed tensor + per-group per-output-channel scales -> f32.
    scale [..., n_groups, n] holds one f32 for each `k // n_groups`
    contraction rows, groups in order."""
    q = unpack_int4_ref(packed, k).float()
    gs = k // scale.shape[-2]
    return q * torch.repeat_interleave(scale.float(), gs, dim=-2)


def expert_ffn_q4_ref(
    xe: torch.Tensor,                       # [E, C, d]
    w_in_q4: torch.Tensor,                  # [E, d//2, F] uint8 (packed along d)
    w_in_scale: torch.Tensor,               # [E, d//g, F] f32
    w_gate_q4: Optional[torch.Tensor],      # [E, d//2, F] uint8 or None
    w_gate_scale: Optional[torch.Tensor],   # [E, d//g, F] or None
    w_out_q4: torch.Tensor,                 # [E, F//2, d] uint8 (packed along F)
    w_out_scale: torch.Tensor,              # [E, F//g, d] f32
    act: str = "silu",
) -> torch.Tensor:
    """Dequantize-then-compute: q·s is rounded to xe's dtype, then the
    plain FFN. Per-group scales do not commute with the whole contraction,
    so this materialised form is the contract the kernel is held to."""
    d = xe.shape[-1]
    F = w_out_q4.shape[-2] * 2
    wi = dequantize_q4_ref(w_in_q4, w_in_scale, d).to(xe.dtype)
    wg = None
    if w_gate_q4 is not None:
        wg = dequantize_q4_ref(w_gate_q4, w_gate_scale, d).to(xe.dtype)
    wo = dequantize_q4_ref(w_out_q4, w_out_scale, F).to(xe.dtype)
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


def prefill_mask(S: int, S_kv: int, window: int, causal: bool, device) -> torch.Tensor:
    """[S, S_kv] visibility of key j to query i: j <= i when causal, j > i -
    window with a window."""
    qp = torch.arange(S, device=device)[:, None]
    kp = torch.arange(S_kv, device=device)[None, :]
    mask = torch.ones((S, S_kv), dtype=torch.bool, device=device)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= kp > qp - window
    return mask


def flash_prefill_ref(
    q: torch.Tensor,   # [B, S, H, D]
    k: torch.Tensor,   # [B, S_kv, K, D]
    v: torch.Tensor,   # [B, S_kv, K, D]
    window: int = 0,
    cap: float = 0.0,
    causal: bool = True,
) -> torch.Tensor:
    """Full-sequence GQA attention with windows/softcaps (exact softmax,
    fp32); the keys may differ in number from the queries (cross-attention,
    unmasked)."""
    B, S, H, D = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, D).float()
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) / math.sqrt(D)
    if cap:
        logits = cap * torch.tanh(logits / cap)
    mask = prefill_mask(S, k.shape[1], window, causal, q.device)
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


def flash_decode_paged_ref(
    q: torch.Tensor,            # [B, H, D]
    kp: torch.Tensor,           # [P+1, page, K, D] shared page pool (trash page last)
    vp: torch.Tensor,           # [P+1, page, K, D]
    page_table: torch.Tensor,   # [B, Mp] int32 (-1 = unallocated / spilled)
    pos: torch.Tensor,          # [B] int32
    window: int = 0,
    cap: float = 0.0,
) -> torch.Tensor:
    """Paged decode oracle: gather K/V through the table (-1 reads the trash
    page), give slot j of entry p the position p·page + j (pages are
    allocated in position order), mask -1 entries, then `flash_decode_ref`.
    A lane with no valid key averages V over every gathered slot."""
    B = q.shape[0]
    P1, page, K, D = kp.shape
    Mp = page_table.shape[1]
    live = page_table >= 0
    pt = torch.where(live, page_table, torch.full_like(page_table, P1 - 1)).long()
    k = kp[pt].reshape(B, Mp * page, K, D)
    v = vp[pt].reshape(B, Mp * page, K, D)
    spos = torch.arange(Mp * page, dtype=torch.int32, device=q.device)[None, :]
    slot_pos = torch.where(live.repeat_interleave(page, dim=1), spos,
                           torch.full_like(spos, -1))
    return flash_decode_ref(q, k, v, slot_pos, pos, window=window, cap=cap)
