"""Gradients through the forward kernels that training runs: `expert_ffn`,
`flash_prefill` and `sparsemax`.

Each is a `torch.autograd.Function` whose forward is the caller's forward
(`kernels.ops`: the hand-written kernel for a CUDA tensor, the plain version
for a CPU tensor) and whose backward is explicit PyTorch (`bmm`, `einsum`
and elementwise ops), so the plain version stays off the card's path in
both directions. The JAX package has no backward kernel either: its
training differentiates plain `jnp`. `ops` routes a call here only when a
gradient is wanted; under `no_grad` / `inference_mode` the wrappers call
their forward directly, as before.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from repro_torch.kernels.ref import prefill_mask

GELU_C = math.sqrt(2.0 / math.pi)


def _act_and_grad(name: str, a: torch.Tensor):
    """(act(a), act'(a)) in fp32: tanh-approximate GELU (`jax.nn.gelu`'s
    default), SiLU, ReLU (derivative 0 at 0, as JAX's) and ReLU squared."""
    if name == "gelu":
        u = GELU_C * (a + 0.044715 * a ** 3)
        t = torch.tanh(u)
        da = 0.5 * (1 + t) + 0.5 * a * (1 - t * t) * GELU_C * (1 + 3 * 0.044715 * a * a)
        return 0.5 * a * (1 + t), da
    if name == "silu":
        s = torch.sigmoid(a)
        return a * s, s * (1 + a * (1 - s))
    if name == "relu":
        pos = (a > 0).to(a.dtype)
        return a * pos, pos
    if name == "relu2":
        r = torch.clamp(a, min=0)
        return r * r, 2 * r
    raise ValueError(f"expert_ffn: unknown activation {name!r}")


def _pre_activations(xe, w_in, w_gate: Optional[torch.Tensor]):
    """(x·W_in, x·W_gate or None) in fp32: the forward's products that the
    backward recomputes, since the forward keeps only its inputs."""
    a = torch.bmm(xe, w_in).float()                       # [E, C, F]
    return a, None if w_gate is None else torch.bmm(xe, w_gate).float()


def expert_ffn_backward(xe, w_in, w_gate: Optional[torch.Tensor], w_out, act: str, dy):
    """(dxe, dw_in, dw_gate or None, dw_out) of `expert_ffn`. The
    pre-activations are recomputed with `bmm` in the inputs' dtype; the
    activation and its derivative run in fp32."""
    dt = xe.dtype
    a, g = _pre_activations(xe, w_in, w_gate)
    dh = torch.bmm(dy.to(dt), w_out.transpose(1, 2)).float()
    if w_gate is None:
        h, dact = _act_and_grad(act, a)
        da, dg = (dh * dact).to(dt), None
    else:
        fg, dact = _act_and_grad(act, g)
        h = fg * a
        da, dg = (dh * fg).to(dt), (dh * a * dact).to(dt)
    xt = xe.transpose(1, 2)
    dw_out = torch.bmm(h.to(dt).transpose(1, 2), dy.to(dt))
    dw_in = torch.bmm(xt, da)
    dx = torch.bmm(da, w_in.transpose(1, 2))
    dw_gate = None
    if dg is not None:
        dw_gate = torch.bmm(xt, dg)
        dx = dx + torch.bmm(dg, w_gate.transpose(1, 2))
    return dx, dw_in, dw_gate, dw_out


class ExpertFFN(torch.autograd.Function):
    """xe [E, C, d] -> [E, C, d] through each slot's (G)LU FFN."""

    @staticmethod
    def forward(ctx, fwd: Callable, xe, w_in, w_gate, w_out, act: str):
        ctx.act = act
        ctx.save_for_backward(xe, w_in, w_gate, w_out)
        return fwd(xe, w_in, w_gate, w_out, act=act)

    @staticmethod
    def backward(ctx, dy):
        xe, w_in, w_gate, w_out = ctx.saved_tensors
        dx, dwi, dwg, dwo = expert_ffn_backward(xe, w_in, w_gate, w_out, ctx.act, dy)
        return None, dx, dwi, dwg, dwo, None


def flash_prefill_backward(q, k, v, window: int, cap: float, causal: bool, do):
    """(dq, dk, dv) of `flash_prefill`, in fp32 then cast to each input's
    dtype: S = Q Kᵀ·scale (softcapped: cap·tanh(S / cap)), masked, P =
    softmax(S), dV = Pᵀ dO, dS = P ⊙ (dO Vᵀ − rowsum(P ⊙ dO Vᵀ)), through the
    cap's 1 − (s / cap)², dQ = dS K·scale, dK = dSᵀ Q·scale; dK and dV sum
    over each GQA group. k / v may hold S_kv != S keys (cross-attention)."""
    B, S, H, D = q.shape
    K = k.shape[2]
    scale = 1.0 / math.sqrt(D)
    qg = q.reshape(B, S, K, H // K, D).float()
    kf, vf = k.float(), v.float()
    dog = do.reshape(B, S, K, H // K, D).float()
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, kf) * scale
    if cap:
        s = cap * torch.tanh(s / cap)
    mask = prefill_mask(S, k.shape[1], window, causal, q.device)
    p = torch.softmax(torch.where(mask, s, torch.full_like(s, -1e30)), dim=-1)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, vf)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    if cap:
        ds = ds * (1 - (s / cap) ** 2)
    dv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, qg) * scale
    return dq.reshape(B, S, H, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashPrefill(torch.autograd.Function):
    """q [B, S, H, D], k / v [B, S_kv, K, D] -> [B, S, H, D]."""

    @staticmethod
    def forward(ctx, fwd: Callable, q, k, v, window: int, cap: float, causal: bool):
        ctx.opts = (window, cap, causal)
        ctx.save_for_backward(q, k, v)
        return fwd(q, k, v, window=window, cap=cap, causal=causal)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_prefill_backward(q, k, v, *ctx.opts, do)
        return None, dq, dk, dv, None, None, None


def sparsemax_backward(out: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The simplex projection's exact VJP (Martins & Astudillo, Prop. 2), as
    the reference's `_sparsemax_bwd`: with s the support indicator,
    dz = (g − Σ(g·s) / max(Σs, 1))·s."""
    s = (out > 0).to(g.dtype)
    k = torch.clamp(s.sum(-1, keepdim=True), min=1.0)
    return (g - (g * s).sum(-1, keepdim=True) / k) * s


class Sparsemax(torch.autograd.Function):
    """z [..., L] -> simplex projection along the last axis."""

    @staticmethod
    def forward(ctx, fwd: Callable, z):
        out = fwd(z)
        ctx.save_for_backward(out)
        return out

    @staticmethod
    def backward(ctx, g):
        (out,) = ctx.saved_tensors
        return None, sparsemax_backward(out, g)
