"""Expert-activation sparsity and cross-embedding dependency analyses
(port of `repro/core/sparsity.py`), the paper's motivating measurements:
  Fig. 2  — effective device memory utilisation vs sentence length
  Fig. 4  — ratio of idle experts vs sentence length
  Fig. 6  — Eq. 2: E[p̂] as a function of (p, c, L)
  Fig. 7  — corruption study: probability a token's expert activation changes
            when a fraction p of other tokens/positions are corrupted
  ĉ       — the sparse cross-embedding dependency estimate (1–4 in the paper)
The model-facing functions run the port's `forward` on the params' device.
"""
from __future__ import annotations

from math import lgamma
from typing import Dict, List, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import forward


# ---------------------------------------------------------------------------
# Eq. 2 — probability the corrupted set hits >=1 critical token
# ---------------------------------------------------------------------------


def _log_comb(n: int, k: int) -> float:
    if k < 0 or k > n:
        return -np.inf
    return lgamma(n + 1) - lgamma(k + 1) - lgamma(n - k + 1)


def expected_phat(p: float, c: int, L: int) -> float:
    """E[p̂] = 1 - C(L-1-c, ⌊pL⌋) / C(L-1, ⌊pL⌋)   (paper Eq. 2)."""
    m = int(p * L)
    num = _log_comb(L - 1 - c, m)
    den = _log_comb(L - 1, m)
    if not np.isfinite(num):
        return 1.0
    return 1.0 - float(np.exp(num - den))


def estimate_c(
    ps: Sequence[float], phats: Sequence[float], L: int, c_max: int = 64
) -> int:
    """Least-squares inversion of Eq. 2 over a grid of c (paper: ĉ ∈ [1,4])."""
    best_c, best_err = 1, np.inf
    for c in range(1, c_max + 1):
        pred = np.array([expected_phat(p, c, L) for p in ps])
        err = float(np.mean((pred - np.asarray(phats)) ** 2))
        if err < best_err:
            best_c, best_err = c, err
    return best_c


# ---------------------------------------------------------------------------
# activation sparsity (Figs. 2 & 4)
# ---------------------------------------------------------------------------


@torch.no_grad()
def routing_ids(params: dict, cfg: ModelConfig, tokens: np.ndarray) -> np.ndarray:
    """Router argmax ids [L_moe, B, S] from a full forward on the params' device."""
    dev = params["embed"].device
    out = forward(params, cfg, torch.as_tensor(np.asarray(tokens), device=dev),
                  collect_router_logits=True)
    return torch.argmax(out["router_logits"], dim=-1).cpu().numpy()   # [L_moe, B, S]


def sentence_sparsity(ids: np.ndarray, num_experts: int) -> np.ndarray:
    """Per-sentence ratio of idle experts (Fig. 4). ids: [L, B, S] -> [B]."""
    L, B, S = ids.shape
    ratios = np.empty((B,), np.float64)
    for b in range(B):
        active = np.array([len(np.unique(ids[l, b])) for l in range(L)])
        ratios[b] = 1.0 - active.mean() / num_experts
    return ratios


def effective_memory_utilization(
    cfg: ModelConfig, idle_ratio: float
) -> Dict[str, float]:
    """Fig. 2: fraction of device memory doing useful work for this batch."""
    counts = cfg.param_counts()
    bpp = cfg.bytes_per_param()
    moe_b = counts["moe"] * bpp
    total_b = counts["total"] * bpp
    effective = total_b - moe_b * idle_ratio
    return {
        "total_gb": total_b / 1e9,
        "moe_gb": moe_b / 1e9,
        "moe_fraction": moe_b / total_b,
        "effective_utilization": effective / total_b,
        "ineffective_gb": moe_b * idle_ratio / 1e9,
    }


# ---------------------------------------------------------------------------
# corruption study (Fig. 7)
# ---------------------------------------------------------------------------


def corruption_study(
    params: dict,
    cfg: ModelConfig,
    tokens: np.ndarray,          # [B, L] token ids
    ps: Sequence[float],
    n_positions: int = 8,
    n_trials: int = 4,
    mode: str = "token",         # "token" | "position"
    seed: int = 0,
) -> Dict[float, float]:
    """Empirical P(expert activation of token i changes | corrupt fraction p).

    mode="token": replace a random fraction p of other tokens with random ids
    distinct from original and from token i (paper §3.4.1).
    mode="position": swap a random fraction p of other positions.
    """
    rng = np.random.default_rng(seed)
    B, L = tokens.shape
    base_ids = routing_ids(params, cfg, tokens)        # [Lm, B, S]
    results: Dict[float, List[float]] = {p: [] for p in ps}
    positions = rng.choice(L, size=min(n_positions, L), replace=False)

    for p in ps:
        m = max(1, int(p * L))
        for i in positions:
            for _ in range(n_trials):
                corrupt = tokens.copy()
                others = np.setdiff1d(np.arange(L), [i])
                sel = rng.choice(others, size=min(m, len(others)), replace=False)
                if mode == "token":
                    for b in range(B):
                        for j in sel:
                            orig = corrupt[b, j]
                            new = rng.integers(0, cfg.vocab_size)
                            while new == orig or new == tokens[b, i]:
                                new = rng.integers(0, cfg.vocab_size)
                            corrupt[b, j] = new
                else:
                    perm = rng.permutation(sel)
                    corrupt[:, sel] = corrupt[:, perm]
                new_ids = routing_ids(params, cfg, corrupt)
                changed = (new_ids[:, :, i] != base_ids[:, :, i]).mean()
                results[p].append(float(changed))
    return {p: float(np.mean(v)) for p, v in results.items()}
