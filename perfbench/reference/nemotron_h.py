"""Plain reference of the Nemotron-H hybrid served through SiDA
(NVIDIA-Nemotron-3-Nano-30B-A3B).

Written from the published description (the Nemotron-H paper,
arXiv:2504.03624, Mamba-2's, arXiv:2405.21060, and the model's config.json):
every block is `x += Mixer(RMSNorm(x))` with exactly one mixer, which block
s of a period takes from `attn.layer_pattern[s]`:

- "mamba2", Mamba-2 with H heads of P, B and C in G groups of N (H / G
  heads share a group), a causal depthwise conv of width K with bias:

      [z, xBC, dt] = x W_in;  xBC = silu(conv(xBC) + b);  [x, B, C] = xBC
      Δ = softplus(dt + dt_bias);  A = -exp(A_log)     (a scalar a head)
      h_t = exp(Δ_t A) h_{t-1} + Δ_t x_t ⊗ B_t;  y_t = h_t C_t + D x_t
      out = RMSNorm_grouped(y ⊙ silu(z)) W_out         (G groups of H·P / G)

  with the recurrence run one position at a time, no chunks;
- "moe", the routed experts `down(relu(up x)²)` weighted by the routing and
  times `routed_scaling_factor`, beside the shared expert of the same form
  (gated where the configuration's `glu` is). Routed by the served table, or where no
  routing is given by the model's own router: s = sigmoid(x W_r), the top k
  of s + the correction bias, weights s_i / Σ s over the k;
- "global", causal GQA with no positional encoding (`jamba._attention`).

A final RMSNorm and an untied head. Norms and the predictor are
`moe_transformer`'s, RMSNorm with its (1 + gain); everything is float32
with TF32 off, and `prec` ("tf32", "fp8") lowers every matrix product's
inputs as there. MoE layers are counted from the pattern. It imports
nothing of the program: the weights come from the benchmark's driver.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from perfbench.reference.jamba import _attention, _group
from perfbench.reference.moe_transformer import (  # noqa: F401  (the check's names)
    _rmsnorm,
    exact_fp32,
    lower,
    mm,
    predictor_logits,
    top_k,
)


def relu2(x: torch.Tensor) -> torch.Tensor:
    return F.relu(x).square()


def period(m: Dict) -> int:
    return len(m["attn"]["layer_pattern"])


def moe_blocks(m: Dict):
    """The blocks of the whole depth that are MoE, in order."""
    pattern = m["attn"]["layer_pattern"]
    return [layer for layer in range(m["n_layers"]) if pattern[layer % len(pattern)] == "moe"]


def ssd_sequential(x: torch.Tensor, delta: torch.Tensor, A: torch.Tensor, Bh: torch.Tensor,
                   Ch: torch.Tensor) -> torch.Tensor:
    """h_t = exp(Δ_t A) h_{t-1} + Δ_t x_t ⊗ B_t, y_t = h_t C_t from h_0 = 0,
    one position at a time: x [b, S, H, P], Δ [b, S, H], A [H], B / C
    [b, S, H, N] (a head's own) -> y [b, S, H, P]."""
    b, S, H, Pd = x.shape
    state = torch.zeros((b, H, Pd, Bh.shape[-1]), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        state = (torch.exp(delta[:, t] * A)[:, :, None, None] * state
                 + (delta[:, t, :, None] * x[:, t])[..., None] * Bh[:, t, :, None, :])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    return torch.stack(ys, dim=1)


def _mamba2(p, h, m, prec):
    """Mamba-2 over h [b, S, d], its recurrence sequential over the positions."""
    b, S, _ = h.shape
    s = m["ssm"]
    H, Pd, G, N = s["mamba2_heads"], s["mamba2_head_dim"], s["n_groups"], s["state_dim"]
    di, K = H * Pd, s["conv_dim"]
    P = {k: (v if torch.is_tensor(v) else v["scale"]).float() for k, v in p.items()}
    z, xbc, dt = mm(h, P["in_proj"], prec).split([di, di + 2 * G * N, H], dim=-1)
    xp = F.pad(xbc, (0, 0, K - 1, 0))
    xbc = F.silu(sum(xp[:, k:k + S] * P["conv_w"][k] for k in range(K)) + P["conv_b"])
    xs, Bm, Cm = xbc.split([di, G * N, G * N], dim=-1)
    delta = F.softplus(dt + P["dt_bias"])                                 # [b, S, H]
    A = -torch.exp(P["A_log"])                                            # [H]
    Bh = Bm.reshape(b, S, G, N).repeat_interleave(H // G, dim=2)          # [b, S, H, N]
    Ch = Cm.reshape(b, S, G, N).repeat_interleave(H // G, dim=2)
    x = xs.reshape(b, S, H, Pd)
    y = ssd_sequential(x, delta, A, Bh, Ch) + P["D"][:, None] * x
    y = y.reshape(b, S, di) * F.silu(z)
    g = y.reshape(b, S, G, di // G)
    g = (g * torch.rsqrt(g.square().mean(-1, keepdim=True) + m["norm_eps"])).reshape(b, S, di)
    return mm(g * (1.0 + P["norm"]), P["out_proj"], prec)


def route(p, h, m):
    """The model's own router over h [T, d]: (expert ids [T, k], weights
    [T, k]) before the routed scaling factor."""
    s = torch.sigmoid(h @ p["router"].float())
    bias = p["router_bias"].float() if "router_bias" in p else 0.0
    _, ids = top_k(s + bias, m["moe"]["top_k"])
    w = torch.gather(s, -1, ids)
    return ids, w / w.sum(-1, keepdim=True)


def _moe(p, h, m, experts: Optional[torch.Tensor], weights: Optional[torch.Tensor], prec):
    """h [T, d]; experts / weights [T, k] (expert ids and effective weights,
    0 drops a pair), or None for the model's own router."""
    moe = m["moe"]
    if experts is None:
        experts, weights = route(p, h, m)
    y = torch.zeros_like(h)
    for e in torch.unique(experts[weights != 0]).tolist():
        hit = (experts == e) & (weights != 0)
        rows = hit.any(-1).nonzero()[:, 0]
        w = (weights * hit).sum(-1)[rows]
        out = mm(relu2(mm(h[rows], p["w_in"][e].float(), prec)), p["w_out"][e].float(), prec)
        y.index_add_(0, rows, out * w[:, None])
    y = y * moe["routed_scaling_factor"]
    if moe["num_shared_experts"]:
        up = mm(h, p["shared_w_in"].float(), prec)
        if m["glu"]:
            up = relu2(mm(h, p["shared_w_gate"].float(), prec)) * up
        else:
            up = relu2(up)
        y = y + mm(up, p["shared_w_out"].float(), prec)
    return y


def check_supported(m: Dict) -> None:
    """Refuse a configuration this reference does not implement."""
    a = m["attn"]
    unsupported = {
        "block_kind": m["block_kind"] != "nemotron_h", "enc_dec": m["enc_dec"],
        "post_norm": m["post_norm"], "embed_scale": m["embed_scale"],
        "final_logit_softcap": m["final_logit_softcap"] != 0, "act": m["act"] != "relu2",
        "glu": m["glu"], "qkv_bias": a["qkv_bias"], "qk_norm": a["qk_norm"],
        "logit_softcap": a["logit_softcap"] != 0, "window": a["window"] != 0,
        "rope_theta": a["rope_theta"] != 0,
        "layer_pattern": not set(a["layer_pattern"]) <= {"mamba2", "moe", "global"},
        "score_func": m["moe"]["score_func"] != "sigmoid",
        "tie_embeddings": m["tie_embeddings"],
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise ValueError(f"the plain Nemotron-H reference does not implement {bad}")


@torch.no_grad()
def forward(W: Dict, m: Dict, tokens: torch.Tensor, experts: Optional[torch.Tensor],
            weights: Optional[torch.Tensor], prec: str = "fp32") -> torch.Tensor:
    """Logits [b, S, vocab] of the full causal forward over tokens [b, S],
    the MoE blocks routed by experts / weights [n_moe, b, S, k] (expert ids
    and the effective weight of each, before the routed scaling factor; a
    weight of 0 drops the pair), or by the model's own routers where
    `experts` is None. `W` is the weight tree, each block leaf stacked over
    the layer groups, read a block at a time and widened to float32."""
    check_supported(m)
    b, S = tokens.shape
    per = period(m)
    pattern = m["attn"]["layer_pattern"]
    eps = m["norm_eps"]
    li = 0
    with exact_fp32():
        x = W["embed"][tokens.long()].float()
        for g in range(m["n_layers"] // per):
            for s in range(per):
                p = _group(W["blocks"][f"sub{s}"], g)
                h = _rmsnorm(p["ln1"]["scale"], x, eps)
                kind = pattern[s]
                if kind == "mamba2":
                    x = x + _mamba2(p["mamba2"], h, m, prec)
                elif kind == "global":
                    x = x + _attention(p["attn"], h, m, prec)
                else:
                    e = w = None
                    if experts is not None:
                        e, w = experts[li].reshape(b * S, -1), weights[li].reshape(b * S, -1)
                    y = _moe(p["moe"], h.reshape(b * S, -1), m, e, w, prec)
                    x = x + y.reshape(b, S, -1)
                    li += 1
        x = _rmsnorm(W["final_norm"]["scale"], x, eps)
        return mm(x, W["head"].float(), prec)[..., : m["vocab_size"]]
