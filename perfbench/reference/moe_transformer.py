"""Plain reference of the served MoE transformer and of SiDA's hash predictor.

Written from the published description of the model (pre-norm decoder
blocks: RMSNorm with a (1 + scale) gain, rotary embeddings on split halves,
causal multi-head attention, a GELU or SwiGLU feed-forward, top-k routed
experts beside always-on shared experts, an untied or tied LM head) and of
SiDA's predictor (a compress layer, two LSTMs, SparseMax self-attention with
a residual, one linear head a MoE layer). It imports nothing of the program:
the weights come from `perfbench/weights.py`, the routing from
`reference/routing.py`.

Everything is computed in float32 with TF32 off. `prec` selects the
benchmark's controls, the same arithmetic one step lower: "tf32" rounds
every matrix product's inputs to TF32 (10 mantissa bits), "fp8" casts them
to float8 e4m3 with one scale a tensor. Products accumulate in float32
either way.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


@contextlib.contextmanager
def exact_fp32():
    """TF32 off for matrix products and convolutions, restored on exit."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32's 10 mantissa bits (nearest, ties away)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one scale for the tensor, back in float32."""
    scale = x.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def lower(x: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "fp32":
        return x
    if prec == "tf32":
        return _tf32(x)
    if prec == "fp8":
        return _fp8(x)
    raise ValueError(f"unknown precision {prec!r}")


def mm(a: torch.Tensor, b: torch.Tensor, prec: str = "fp32") -> torch.Tensor:
    return lower(a, prec) @ lower(b, prec)


# ---------------------------------------------------------------------------
# the hash predictor
# ---------------------------------------------------------------------------


def sparsemax(z: torch.Tensor) -> torch.Tensor:
    """Euclidean projection of each row (last axis) onto the simplex
    (Martins & Astudillo 2016), by sorting."""
    zs, _ = torch.sort(z, dim=-1, descending=True)
    k = torch.arange(1, z.shape[-1] + 1, device=z.device, dtype=z.dtype)
    cs = zs.cumsum(-1)
    support = (1 + k * zs) > cs
    n = support.sum(-1, keepdim=True)
    tau = (torch.gather(cs, -1, n - 1) - 1) / n.to(z.dtype)
    return torch.clamp(z - tau, min=0)


def _lstm_cell(p, xg, h, c, prec):
    g = xg + mm(h, p["wh"], prec)
    i, f, gg, o = g.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    return torch.sigmoid(o) * torch.tanh(c), c


def _lstm(p, x, prec):
    """x [b, S, d_in] -> outputs [b, S, d_h]; gates in i, f, g, o order."""
    b, S, _ = x.shape
    d_h = p["wh"].shape[0]
    xg = mm(x, p["wx"], prec) + p["b"]
    h = c = torch.zeros((b, d_h), dtype=torch.float32, device=x.device)
    hs = []
    for t in range(S):
        h, c = _lstm_cell(p, xg[:, t], h, c, prec)
        hs.append(h)
    return torch.stack(hs, dim=1)


def _states(hp, emb, prec):
    x = torch.tanh(mm(emb.float(), hp["compress"], prec))
    return _lstm(hp["lstm2"], _lstm(hp["lstm1"], x, prec), prec)


def predictor_logits(hp: Dict, emb: torch.Tensor, n_moe: int, experts: int,
                     prec: str = "fp32") -> torch.Tensor:
    """The batch predictor: emb [b, S, d_model] -> expert logits [b, S,
    n_moe, experts]. Each position attends to every position of its row
    (SiDA's look-ahead over the whole batch row)."""
    h = _states(hp, emb, prec)
    q = mm(h, hp["attn_q"], prec)
    scores = torch.einsum("bqd,bkd->bqk", lower(q, prec), lower(h, prec)) / math.sqrt(h.shape[-1])
    z = torch.einsum("bqk,bkd->bqd", sparsemax(scores), h) + h
    return mm(z, hp["heads"], prec).reshape(*emb.shape[:2], n_moe, experts)


def decode_predictor_logits(hp: Dict, emb: torch.Tensor, n_moe: int, experts: int,
                            history: int, prec: str = "fp32") -> torch.Tensor:
    """The one-token predictor over a row's inputs: emb [b, T, d_model] ->
    [b, T, n_moe, experts]. Position t attends to its own and the previous
    `history` - 1 LSTM outputs."""
    h = _states(hp, emb, prec)
    q = mm(h, hp["attn_q"], prec)
    T = h.shape[1]
    scores = torch.einsum("bqd,bkd->bqk", lower(q, prec), lower(h, prec)) / math.sqrt(h.shape[-1])
    t = torch.arange(T, device=h.device)
    seen = (t[None, :] <= t[:, None]) & (t[None, :] > t[:, None] - history)
    scores = torch.where(seen, scores, torch.full_like(scores, -1e30))
    z = torch.einsum("bqk,bkd->bqd", sparsemax(scores), h) + h
    return mm(z, hp["heads"], prec).reshape(*emb.shape[:2], n_moe, experts)


def top_k(logits: torch.Tensor, k: int):
    """(values, ids) of the k largest, ties to the lower index."""
    vals, ids = torch.sort(logits, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _rmsnorm(scale, x, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + scale.float())


def _act(name: str):
    return {"gelu": lambda x: F.gelu(x, approximate="tanh"), "silu": F.silu, "relu": F.relu}[name]


def _rope(x, theta):
    """x [b, S, heads, D]: rotary embedding over split halves."""
    D = x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D)
    ang = torch.arange(x.shape[1], dtype=torch.float32, device=x.device)[:, None] * freqs
    sin, cos = torch.sin(ang)[:, None, :], torch.cos(ang)[:, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(p, h, m, prec):
    b, S, d = h.shape
    H, K = m["n_heads"], m["n_kv_heads"]
    D = m["head_dim"] or d // H
    theta = m["attn"]["rope_theta"]
    q = _rope(mm(h, p["wq"].float(), prec).reshape(b, S, H, D), theta)
    k = _rope(mm(h, p["wk"].float(), prec).reshape(b, S, K, D), theta)
    v = mm(h, p["wv"].float(), prec).reshape(b, S, K, D)
    q = q.reshape(b, S, K, H // K, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", lower(q, prec), lower(k, prec)) / math.sqrt(D)
    causal = torch.ones((S, S), dtype=torch.bool, device=h.device).tril()
    w = torch.softmax(torch.where(causal, s, torch.full_like(s, -1e30)), dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", lower(w, prec), lower(v, prec)).reshape(b, S, H * D)
    return mm(o, p["wo"].float(), prec)


def _ffn(w_in, w_gate, w_out, x, act, glu, prec):
    h = mm(x, w_in, prec)
    h = act(mm(x, w_gate, prec)) * h if glu else act(h)
    return mm(h, w_out, prec)


def _moe(p, h, m, experts, weights, prec):
    """h [T, d]; experts / weights [T, k] (expert ids, effective weights)."""
    moe, act = m["moe"], _act(m["act"])
    y = torch.zeros_like(h)
    for e in torch.unique(experts[weights != 0]).tolist():
        hit = (experts == e) & (weights != 0)
        rows = hit.any(-1).nonzero()[:, 0]
        w = (weights * hit).sum(-1)[rows]
        out = _ffn(p["w_in"][e].float(), p["w_gate"][e].float(), p["w_out"][e].float(), h[rows],
                   act, m["glu"], prec)
        y.index_add_(0, rows, out * w[:, None])
    if moe["num_shared_experts"]:
        y = y + _ffn(p["shared_w_in"].float(), p["shared_w_gate"].float(),
                     p["shared_w_out"].float(), h, act, True, prec)
    return y


def period(m: Dict) -> int:
    per = len(m["attn"]["layer_pattern"])
    if m["moe"]["num_experts"]:
        per = per * m["moe"]["moe_every"] // math.gcd(per, m["moe"]["moe_every"])
    return per


def is_moe(m: Dict, sub: int) -> bool:
    every = m["moe"]["moe_every"]
    return bool(m["moe"]["num_experts"]) and sub % every == every - 1


def check_supported(m: Dict) -> None:
    """Refuse a configuration this reference does not implement."""
    a = m["attn"]
    unsupported = {
        "block_kind": m["block_kind"] != "attn", "enc_dec": m["enc_dec"],
        "post_norm": m["post_norm"], "embed_scale": m["embed_scale"],
        "final_logit_softcap": m["final_logit_softcap"] != 0,
        "qkv_bias": a["qkv_bias"], "qk_norm": a["qk_norm"], "logit_softcap": a["logit_softcap"] != 0,
        "window": a["window"] != 0, "layer_pattern": set(a["layer_pattern"]) != {"global"},
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise ValueError(f"the plain MoE reference does not implement {bad}")


@torch.no_grad()
def forward(W: Dict, m: Dict, tokens: torch.Tensor, experts: torch.Tensor,
            weights: torch.Tensor, prec: str = "fp32") -> torch.Tensor:
    """Logits [b, S, vocab] of the full causal forward over tokens [b, S],
    the MoE layers routed by experts / weights [n_moe, b, S, k] (expert ids
    and the effective weight of each; a weight of 0 drops the pair). `W` is
    the benchmark's weight tree (`weights.model_params`), read a layer at a
    time and widened to float32."""
    check_supported(m)
    b, S = tokens.shape
    per = period(m)
    moe_subs = [s for s in range(per) if is_moe(m, s)]
    eps = m["norm_eps"]
    x = W["embed"][tokens.long()].float()
    for g in range(m["n_layers"] // per):
        for s in range(per):
            p = {k: (v[g] if torch.is_tensor(v) else {n: t[g] for n, t in v.items()})
                 for k, v in W["blocks"][f"sub{s}"].items()}
            x = x + _attention(p["attn"], _rmsnorm(p["ln1"]["scale"], x, eps), m, prec)
            h = _rmsnorm(p["ln2"]["scale"], x, eps)
            if s in moe_subs:
                li = g * len(moe_subs) + moe_subs.index(s)
                y = _moe(p["moe"], h.reshape(b * S, -1), m, experts[li].reshape(b * S, -1),
                         weights[li].reshape(b * S, -1), prec).reshape(b, S, -1)
            elif "mlp" in p:
                mlp = p["mlp"]
                y = _ffn(mlp["w_in"].float(), mlp["w_gate"].float() if m["glu"] else None,
                         mlp["w_out"].float(), h, _act(m["act"]), m["glu"], prec)
            else:
                y = torch.zeros_like(h)
            x = x + y
    x = _rmsnorm(W["final_norm"]["scale"], x, eps)
    head = W["embed"].T if m["tie_embeddings"] else W["head"]
    return mm(x, head.float(), prec)[..., : m["vocab_size"]]

