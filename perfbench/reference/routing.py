"""SiDA's slot budget, translation and expert capacity, worked out again.

What the served forward does with a hash table, stated plainly (numpy on
the host):

- the experts a MoE layer must hold for a table: those the table routes a
  (token, k) pair to, cut to the `slots` with the most predicted α mass when
  there are more;
- the translation: a pair whose expert holds no slot keeps weight 0, and
  each token's surviving weights are scaled back to its predicted α mass;
- capacity: tokens go in blocks (the largest divisor of the token count up
  to 4096), and in each block a slot takes its first C pairs in token-major,
  k-minor order, C = max(8, min(block, int(capacity_factor · block · top_k /
  slots))). A pair whose expert holds no slot counts against slot 0, where
  the translation parks it. Pairs past C are dropped.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

BLOCK_TARGET = 4096


def needed_experts(ids: np.ndarray, alpha: np.ndarray, slots: int, experts: int) -> List[set]:
    """ids / alpha [n_moe, ...]: for each MoE layer, the set of experts the
    table must have resident under a budget of `slots`."""
    out = []
    for l in range(ids.shape[0]):
        active = np.unique(ids[l])
        if len(active) > slots:
            mass = np.zeros((experts,), np.float64)
            np.add.at(mass, ids[l].reshape(-1), alpha[l].reshape(-1).astype(np.float64))
            active = active[np.argsort(-mass[active], kind="stable")][:slots]
        out.append({int(e) for e in active})
    return out


def residency_faults(trans: np.ndarray, needed: List[set], slots: int) -> Tuple[int, int]:
    """(needed experts without a slot, invalid entries) of a translation
    table trans [n_moe, experts] (expert -> slot, -1 none). An entry is
    invalid where it names a slot outside [0, slots) or a slot that another
    expert of the layer also names."""
    missing = invalid = 0
    for l, need in enumerate(needed):
        row = trans[l]
        held = row[row >= 0]
        invalid += int((held >= slots).sum()) + (len(held) - len(np.unique(held)))
        missing += sum(1 for e in need if row[e] < 0)
    return missing, invalid


def block_size(tokens: int) -> int:
    if tokens <= BLOCK_TARGET:
        return tokens
    for blk in range(BLOCK_TARGET, 0, -1):
        if tokens % blk == 0:
            return blk
    return tokens


def capacity(block: int, top_k: int, slots: int, capacity_factor: float) -> int:
    return max(8, min(block, int(capacity_factor * block * top_k / slots)))


def effective_routing(ids: np.ndarray, alpha: np.ndarray, trans: np.ndarray, slots: int,
                      top_k: int, capacity_factor: float) -> np.ndarray:
    """The weight [n_moe, ..., k] each (token, k) pair of ids / alpha
    [n_moe, ..., k] carries into the forward: 0 where its expert holds no
    slot or where its slot is full, the α scaled back to the token's
    predicted mass elsewhere. Tokens are the flattened middle axes, in order
    (a batch's rows, or a decode step's lanes)."""
    n_moe, k = ids.shape[0], ids.shape[-1]
    lead = ids.shape[1:-1]
    ids2 = ids.reshape(n_moe, -1, k)[..., :top_k].astype(np.int64)
    a2 = alpha.reshape(n_moe, -1, k)[..., :top_k].astype(np.float64)
    T = ids2.shape[1]
    blk = block_size(T)
    C = capacity(blk, top_k, slots, capacity_factor)
    out = np.zeros_like(a2)
    for l in range(n_moe):
        slot = trans[l][ids2[l]]                                   # [T, k], -1 none
        w = a2[l] * (slot >= 0)
        orig, surv = a2[l].sum(-1, keepdims=True), w.sum(-1, keepdims=True)
        w = w * np.where(surv > 0, orig / np.maximum(surv, 1e-12), 1.0)
        parked = np.maximum(slot, 0).reshape(T // blk, blk * top_k)
        pos = np.empty_like(parked)
        for n in range(parked.shape[0]):
            order = np.argsort(parked[n], kind="stable")
            sorted_slots = parked[n][order]
            first = np.searchsorted(sorted_slots, sorted_slots, side="left")
            pos[n, order] = np.arange(len(order)) - first
        out[l] = w * (pos.reshape(T, top_k) < C)
    out = out.reshape(n_moe, *lead, top_k)
    if top_k < k:
        out = np.concatenate([out, np.zeros((*out.shape[:-1], k - top_k))], axis=-1)
    return out.astype(np.float32)


def useful_pairs(weights: np.ndarray, ids: np.ndarray) -> Dict[str, np.ndarray]:
    """Per MoE layer, the pairs that carry weight and the distinct experts
    they reach: what an expert FFN call of that layer needs to compute."""
    n_moe = weights.shape[0]
    w = weights.reshape(n_moe, -1)
    e = ids.reshape(n_moe, -1)
    pairs = (w != 0).sum(-1)
    experts = np.array([len(np.unique(e[l][w[l] != 0])) for l in range(n_moe)])
    return {"pairs": pairs, "experts": experts}
