"""The SiDA hash function: a 2-layer LSTM with SparseMax attention
(port of `repro/core/hash_fn.py`).

compress FC (d_model -> d_h), two LSTM layers, self-attention over the LSTM
outputs with SparseMax weights, a residual from the current token, then one
linear head per MoE layer -> expert logits [B, S, L_moe, E]. The SparseMax
goes through `kernels.ops.sparsemax`: the hand-written kernel for CUDA
tensors, the sort-based plain version for CPU tensors. An optional
tied-embedding draft head (`draft_proj`) reads next-token logits off the
same state for speculative decode.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, top_k
from repro_torch.tree import tree_leaves

Carry = Tuple[torch.Tensor, torch.Tensor]


def _init_lstm_layer(gen, d_in: int, d_h: int, device) -> dict:
    b = torch.zeros((4 * d_h,), dtype=torch.float32, device=device)
    b[d_h:2 * d_h] = 1.0   # forget-gate bias
    return {
        "wx": dense_init(gen, d_in, 4 * d_h, torch.float32, device),
        "wh": dense_init(gen, d_h, 4 * d_h, torch.float32, device),
        "b": b,
    }


def _lstm_layer(p: dict, x: torch.Tensor, carry: Optional[Carry] = None):
    """x: [B, S, d_in] -> ([B, S, d_h], final (h, c)); gates in i, f, g, o
    order. `carry` resumes from a previous call's final (h, c)."""
    B, S, _ = x.shape
    d_h = p["wh"].shape[0]
    xg = x @ p["wx"] + p["b"]
    if carry is None:
        h0 = torch.zeros((B, d_h), dtype=x.dtype, device=x.device)
        carry = (h0, h0)
    h, c = carry
    hs = []
    for t in range(S):
        g = torch.addmm(xg[:, t], h, p["wh"])
        i, f, gg, o = g.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
        h = torch.sigmoid(o) * torch.tanh(c)
        hs.append(h)
    return torch.stack(hs, dim=1), (h, c)


def init_hash_fn(
    gen: torch.Generator, d_model: int, n_moe_layers: int, num_experts: int,
    d_h: int = 256, device: DeviceLike = None, draft: bool = False,
) -> dict:
    """Random predictor weights from `gen`, on `device` (CUDA unless asked
    otherwise). `draft` adds the tied-embedding draft head, drawn last, so
    the other weights are those drawn without it."""
    device = resolve_device(device)
    p = {
        "compress": dense_init(gen, d_model, d_h, torch.float32, device),
        "lstm1": _init_lstm_layer(gen, d_h, d_h, device),
        "lstm2": _init_lstm_layer(gen, d_h, d_h, device),
        "attn_q": dense_init(gen, d_h, d_h, torch.float32, device),
        "heads": dense_init(gen, d_h, n_moe_layers * num_experts, torch.float32, device),
    }
    if draft:
        p["draft_proj"] = dense_init(gen, d_h, d_model, torch.float32, device)
    return p


def init_draft_head(gen: torch.Generator, params: dict, d_model: int) -> dict:
    """`params` with a random draft head from `gen` attached, on the
    params' device: the router heads stay as they are."""
    d_h = params["attn_q"].shape[0]
    dev = params["attn_q"].device
    return {**params, "draft_proj": dense_init(gen, d_h, d_model, torch.float32, dev)}


def draft_logits_from_state(params: dict, z: torch.Tensor, embed_table: torch.Tensor) -> torch.Tensor:
    """z [..., d_h] predictor state -> next-token logits [..., V] through the
    tied embedding: z @ draft_proj is a d_model query, the embedding table
    the output matrix. The product is fp32, as the reference's; a bf16 table
    is cast on each call (a [V, d] fp32 temporary) rather than kept as a
    second fp32 copy beside the model's."""
    q = z @ params["draft_proj"]                          # [..., d_model]
    return q @ embed_table.float().T


def _sparse_attention(params: dict, h: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """q = h @ attn_q, k = v = h; SparseMax weights; residual to h."""
    q = h @ params["attn_q"]
    scores = torch.einsum("bqd,bkd->bqk", q, h) / math.sqrt(h.shape[-1])
    if causal:
        S = scores.shape[-1]
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=h.device))
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    w = ops.sparsemax(scores.contiguous())
    return torch.einsum("bqk,bkd->bqd", w, h) + h


def hash_fn_apply(params: dict, emb: torch.Tensor, num_experts: int,
                  causal: bool = False, embed_table: Optional[torch.Tensor] = None):
    """emb: [B, S, d_model] token embeddings -> logits [B, S, L_moe, E].

    causal=True masks the SparseMax attention to the past (the decode-time
    predictor's training form); the default is the paper's full-batch
    look-ahead. With `embed_table` and a draft head in `params`, returns
    (logits, draft logits [B, S, V]): the full-sequence view of what the
    decode predictor drafts a token at a time."""
    L = params["heads"].shape[-1] // num_experts
    x = torch.tanh(emb.float() @ params["compress"])
    h, _ = _lstm_layer(params["lstm1"], x)
    h, _ = _lstm_layer(params["lstm2"], h)
    z = _sparse_attention(params, h, causal)
    logits = (z @ params["heads"]).reshape(*emb.shape[:2], L, num_experts)
    if embed_table is not None and "draft_proj" in params:
        return logits, draft_logits_from_state(params, z, embed_table)
    return logits


# Prompts at or below this length take the one-shot O(S^2) build.
HASH_SEG_LEN = 1024


def _hash_segment(params: dict, emb_seg: torch.Tensor, c1: Carry, c2: Carry):
    """One segment of the long-prompt predictor: LSTMs resume from the
    previous segment's carries, SparseMax sees this segment only."""
    x = torch.tanh(emb_seg.float() @ params["compress"])
    h, c1 = _lstm_layer(params["lstm1"], x, c1)
    h, c2 = _lstm_layer(params["lstm2"], h, c2)
    return _sparse_attention(params, h), c1, c2


def hash_fn_apply_segmented(
    params: dict, emb: torch.Tensor, num_experts: int, seg_len: int = HASH_SEG_LEN
) -> torch.Tensor:
    """Long-prompt variant of `hash_fn_apply`: the LSTM carries thread across
    segments (exact over the whole sequence) and the SparseMax attention is
    restricted to each `seg_len` segment. Identical to `hash_fn_apply` for
    S <= seg_len."""
    L = params["heads"].shape[-1] // num_experts
    B, S, _ = emb.shape
    d_h = params["attn_q"].shape[0]
    zeros = torch.zeros((B, d_h), dtype=torch.float32, device=emb.device)
    c1, c2 = (zeros, zeros), (zeros, zeros)
    outs = []
    for s0 in range(0, S, seg_len):
        z, c1, c2 = _hash_segment(params, emb[:, s0:s0 + seg_len], c1, c2)
        outs.append(z @ params["heads"])
    return torch.cat(outs, dim=1).reshape(B, S, L, num_experts)


def hash_fn_param_count(params: dict) -> int:
    return sum(t.numel() for t in tree_leaves(params))


def hash_hit_rate(pred_logits: torch.Tensor, teacher_ids: torch.Tensor, top: int = 3) -> torch.Tensor:
    """Top-`top` hit rate (the paper's Table 5): the share of (layer, token)
    whose teacher expert is among the predictor's top `top`, ties to the
    lower index. pred_logits [B, S, L, E]; teacher_ids [L, B, S]."""
    _, pred = top_k(pred_logits, top)
    hit = (pred.movedim(2, 0) == teacher_ids[..., None]).any(-1)
    return hit.float().mean()


def predict_topk(logits: torch.Tensor, k: int):
    """logits [B,S,L,E] -> (ids [L,B,S,k] int32, α [L,B,S,k] fp32); α is the
    softmax over the predicted top-k logits."""
    vals, ids = top_k(logits, k)
    alpha = torch.softmax(vals, dim=-1)
    return ids.movedim(2, 0).to(torch.int32), alpha.movedim(2, 0).float()
