"""Basic layers: norms, FFN, RoPE, softcap, initialisers.

Port of `repro/models/layers.py`. Params are nested dicts of tensors with
the JAX pytree's keys; every function is a plain function on tensors.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# init helpers (explicit torch.Generator; the numbers differ from jax.random)
# ---------------------------------------------------------------------------


def normal(gen: torch.Generator, shape, scale: float, dtype, device) -> torch.Tensor:
    """N(0, scale^2) drawn in fp32 on the generator's device, then cast and
    moved — so one seed gives the same weights whatever `device` is."""
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (x * scale).to(dtype=dtype, device=device)


def dense_init(gen, d_in: int, d_out: int, dtype, device, scale: Optional[float] = None):
    scale = scale if scale is not None else 1.0 / math.sqrt(d_in)
    return normal(gen, (d_in, d_out), scale, dtype, device)


def embed_init(gen, vocab: int, d: int, dtype, device):
    return normal(gen, (vocab, d), 0.02, dtype, device)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, dtype, device) -> dict:
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + params["scale"].float())).to(x.dtype)


# ---------------------------------------------------------------------------
# Activation / FFN
# ---------------------------------------------------------------------------


def relu2(x: torch.Tensor) -> torch.Tensor:
    """relu(x)², nemotron_h's expert activation (`mlp_hidden_act` "relu2")."""
    return F.relu(x).square()


# jax.nn.gelu defaults to the tanh approximation; torch's default is exact
_ACTS = {
    "silu": F.silu,
    "gelu": functools.partial(F.gelu, approximate="tanh"),
    "relu": F.relu,
    "relu2": relu2,
}


def act_fn(name: str):
    return _ACTS[name]


def init_ffn(gen, d: int, d_ff: int, glu: bool, dtype, device) -> dict:
    p = {
        "w_in": dense_init(gen, d, d_ff, dtype, device),
        "w_out": dense_init(gen, d_ff, d, dtype, device),
    }
    if glu:
        p["w_gate"] = dense_init(gen, d, d_ff, dtype, device)
    return p


def ffn(params: dict, x: torch.Tensor, act: str, glu: bool) -> torch.Tensor:
    h = x @ params["w_in"]
    if glu:
        h = act_fn(act)(x @ params["w_gate"]) * h
    else:
        h = act_fn(act)(h)
    return h @ params["w_out"]


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis, ties
    to the lower index as `jax.lax.top_k` breaks them (`torch.topk`
    promises no order among equal values)."""
    vals, ids = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


# ---------------------------------------------------------------------------
# RoPE (split halves, not interleaved)
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq]. theta 0 is no
    positional encoding (jamba's attention): x as it is."""
    if not theta:
        return x
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., :, None].float() * freqs            # [..., seq, hd/2]
    sin = torch.sin(angles)[..., :, None, :]
    cos = torch.cos(angles)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# softcap
# ---------------------------------------------------------------------------


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)
