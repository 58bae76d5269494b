"""Plain reference of the Jamba hybrid served through SiDA (AI21-Jamba2-Mini).

Written from the published description (the Jamba papers, arXiv:2403.19887
and arXiv:2408.12570, and the model's config.json): pre-norm blocks
`x += Mixer(RMSNorm(x))`, `x += FFN(RMSNorm(x))`, where sublayer s of a
period mixes with attention where `attn.layer_pattern[s]` is "global" and
with Mamba-1 where it is "mamba", and its FFN is the routed experts on every
`moe_every`-th sublayer and a dense SwiGLU elsewhere; a final RMSNorm and an
untied head. The attention is causal GQA with no positional encoding. The
Mamba is

    [u, z] = x W_in;  u = silu(causal depthwise conv(u) + b)
    [δ, B, C] = u W_x;  δ, B, C each through an RMSNorm
    Δ = softplus(δ W_dt + b_dt);  A = -exp(A_log)
    h_t = exp(Δ_t A) ⊙ h_{t-1} + (Δ_t ⊙ u_t) B_t;  y_t = h_t C_t + D ⊙ u_t
    out = (y ⊙ silu(z)) W_out

with the recurrence run one position at a time. The predictor, routing,
norms, FFNs, experts and the precision controls (`prec`: "tf32", "fp8") are
`moe_transformer`'s; everything is float32 with TF32 off. It imports
nothing of the program: the weights come from the benchmark's driver.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from perfbench.reference.moe_transformer import (  # noqa: F401  (the check's names)
    _act,
    _ffn,
    _moe,
    _rmsnorm,
    exact_fp32,
    is_moe,
    lower,
    mm,
    period,
    predictor_logits,
    top_k,
)


def _attention(p, h, m, prec):
    """Causal GQA over h [b, S, d], no positional encoding."""
    b, S, d = h.shape
    H, K = m["n_heads"], m["n_kv_heads"]
    D = m["head_dim"] or d // H
    q = mm(h, p["wq"].float(), prec).reshape(b, S, K, H // K, D)
    k = mm(h, p["wk"].float(), prec).reshape(b, S, K, D)
    v = mm(h, p["wv"].float(), prec).reshape(b, S, K, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", lower(q, prec), lower(k, prec)) / math.sqrt(D)
    causal = torch.ones((S, S), dtype=torch.bool, device=h.device).tril()
    w = torch.softmax(torch.where(causal, s, torch.full_like(s, -1e30)), dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", lower(w, prec), lower(v, prec)).reshape(b, S, H * D)
    return mm(o, p["wo"].float(), prec)


def _mamba(p, h, m, prec):
    """Mamba-1 with Jamba's Δ / B / C norms over h [b, S, d], its
    recurrence sequential over the positions."""
    b, S, _ = h.shape
    P = {k: (v if torch.is_tensor(v) else v["scale"]).float() for k, v in p.items()}
    di = P["in_proj"].shape[1] // 2
    R, N, K = P["dt_proj"].shape[0], P["A_log"].shape[1], P["conv_w"].shape[0]
    eps = m["norm_eps"]
    u, z = mm(h, P["in_proj"], prec).split(di, dim=-1)
    up = F.pad(u, (0, 0, K - 1, 0))
    u = F.silu(sum(up[:, k:k + S] * P["conv_w"][k] for k in range(K)) + P["conv_b"])
    delta, Bm, Cm = mm(u, P["x_db"], prec).split([R, N, N], dim=-1)
    delta = _rmsnorm(P["dt_norm"], delta, eps)
    Bm, Cm = _rmsnorm(P["b_norm"], Bm, eps), _rmsnorm(P["c_norm"], Cm, eps)
    dt = F.softplus(mm(delta, P["dt_proj"], prec) + P["dt_bias"])          # [b, S, di]
    A = -torch.exp(P["A_log"])                                             # [di, N]
    state = torch.zeros((b, di, N), dtype=torch.float32, device=h.device)
    ys = []
    for t in range(S):
        state = (torch.exp(dt[:, t, :, None] * A) * state
                 + (dt[:, t] * u[:, t])[:, :, None] * Bm[:, t, None, :])
        ys.append((state * Cm[:, t, None, :]).sum(-1))
    y = torch.stack(ys, dim=1) + P["D"] * u
    return mm(y * F.silu(z), P["out_proj"], prec)


def _group(tree: Dict, g: int) -> Dict:
    """Layer group g of a tree of stacked leaves."""
    return {k: v[g] if torch.is_tensor(v) else _group(v, g) for k, v in tree.items()}


def check_supported(m: Dict) -> None:
    """Refuse a configuration this reference does not implement."""
    a = m["attn"]
    unsupported = {
        "block_kind": m["block_kind"] != "jamba", "enc_dec": m["enc_dec"],
        "post_norm": m["post_norm"], "embed_scale": m["embed_scale"],
        "final_logit_softcap": m["final_logit_softcap"] != 0,
        "qkv_bias": a["qkv_bias"], "qk_norm": a["qk_norm"], "logit_softcap": a["logit_softcap"] != 0,
        "window": a["window"] != 0, "rope_theta": a["rope_theta"] != 0,
        "layer_pattern": not set(a["layer_pattern"]) <= {"global", "mamba"},
        "glu": not m["glu"],
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise ValueError(f"the plain Jamba reference does not implement {bad}")


@torch.no_grad()
def forward(W: Dict, m: Dict, tokens: torch.Tensor, experts: torch.Tensor,
            weights: torch.Tensor, prec: str = "fp32") -> torch.Tensor:
    """Logits [b, S, vocab] of the full causal forward over tokens [b, S],
    the MoE layers routed by experts / weights [n_moe, b, S, k] (expert ids
    and the effective weight of each; a weight of 0 drops the pair). `W` is
    the driver's weight tree, each block leaf stacked over the layer groups,
    read a layer at a time and widened to float32."""
    check_supported(m)
    b, S = tokens.shape
    per = period(m)
    pattern = m["attn"]["layer_pattern"]
    moe_subs = [s for s in range(per) if is_moe(m, s)]
    eps = m["norm_eps"]
    with exact_fp32():
        x = W["embed"][tokens.long()].float()
        for g in range(m["n_layers"] // per):
            for s in range(per):
                p = _group(W["blocks"][f"sub{s}"], g)
                h = _rmsnorm(p["ln1"]["scale"], x, eps)
                if pattern[s % len(pattern)] == "global":
                    x = x + _attention(p["attn"], h, m, prec)
                else:
                    x = x + _mamba(p["mamba"], h, m, prec)
                h = _rmsnorm(p["ln2"]["scale"], x, eps)
                if s in moe_subs:
                    li = g * len(moe_subs) + moe_subs.index(s)
                    y = _moe(p["moe"], h.reshape(b * S, -1), m, experts[li].reshape(b * S, -1),
                             weights[li].reshape(b * S, -1), prec).reshape(b, S, -1)
                else:
                    mlp = p["mlp"]
                    y = _ffn(mlp["w_in"].float(), mlp["w_gate"].float(), mlp["w_out"].float(), h,
                             _act(m["act"]), True, prec)
                x = x + y
        x = _rmsnorm(W["final_norm"]["scale"], x, eps)
        return mm(x, W["head"].float(), prec)[..., : m["vocab_size"]]
