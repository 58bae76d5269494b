"""Nominal model FLOPs, the numerator of MFU: what the published model does
for a token, whatever the program computes or pads. A matrix product of an
[n, a] by an [a, b] counts 2·n·a·b. A token counts the attention
projections, causal attention over the `keys` positions it sees, the
published top-k routed experts and the shared experts (or the dense
feed-forward) of each layer, and the LM head over the published vocabulary.
The predictor, the router and the norms are not counted."""
from __future__ import annotations

from typing import Dict

from perfbench.reference.moe_transformer import is_moe, period


def per_token(m: Dict, keys: float) -> float:
    d, H, K = m["d_model"], m["n_heads"], m["n_kv_heads"]
    D = m["head_dim"] or d // H
    moe = m["moe"]
    ffn_mats = 3 if m["glu"] else 2
    per = period(m)
    total = 0.0
    for layer in range(m["n_layers"]):
        total += 2 * d * (2 * H * D + 2 * K * D)          # q, o and k, v projections
        total += 4 * H * D * keys                         # q·k and p·v
        if is_moe(m, layer % per):
            total += moe["top_k"] * 2 * ffn_mats * d * moe["d_expert"]
            total += moe["num_shared_experts"] * 2 * 3 * d * moe["d_shared"]
        elif m["d_ff"]:
            total += 2 * ffn_mats * d * m["d_ff"]
    return total + 2 * d * m["vocab_size"]


def sequence(m: Dict, length: int) -> float:
    """A causal row of `length` tokens, position s seeing s + 1 keys."""
    return sum(per_token(m, s + 1) for s in range(length))
