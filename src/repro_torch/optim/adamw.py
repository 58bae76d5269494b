"""AdamW (Loshchilov & Hutter, 2019) over the port's dict trees (port of
`repro/optim/adamw.py`; not `torch.optim.AdamW`, whose clip and moment
dtypes differ). The update math runs in fp32 whatever the leaves' dtypes;
the moments are kept in `moment_dtype`; the global-norm clip scales every
gradient by min(1, clip / max(‖g‖, 1e-9)); each result is cast back to its
parameter's dtype."""
from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map


def adamw_init(params, moment_dtype=torch.float32) -> dict:
    """moment_dtype=torch.bfloat16 halves the optimizer's memory; the update
    math still runs in fp32."""
    zeros = lambda p: tree_map(lambda x: torch.zeros_like(x, dtype=moment_dtype), p)
    return {"m": zeros(params), "v": zeros(params), "t": 0}


def adamw_update(
    grads,
    params,
    state: dict,
    lr: float = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    grad_clip: float = 0.0,
) -> Tuple[Any, dict]:
    """One step: (new params, new state). Nothing is updated in place."""
    t = state["t"] + 1
    scale = None
    if grad_clip:
        gnorm = torch.sqrt(sum(g.float().square().sum() for g in tree_leaves(grads)))
        scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    # the bias corrections in fp32, as the reference computes them
    c1, c2 = (float(np.float32(1) - np.float32(b) ** np.float32(t)) for b in (b1, b2))

    def upd(g, p, m, v):
        g32 = g.float() if scale is None else g.float() * scale
        m32 = b1 * m.float() + (1 - b1) * g32
        v32 = b2 * v.float() + (1 - b2) * g32.square()
        step = (m32 / c1) / (torch.sqrt(v32 / c2) + eps) + weight_decay * p.float()
        return (p.float() - lr * step).to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)

    out = tree_map(upd, grads, params, state["m"], state["v"])
    return _pick(out, 0), {"m": _pick(out, 1), "v": _pick(out, 2), "t": t}


def _pick(tree, i: int):
    """Element i of each leaf's (param, m, v) result (param trees are dicts)."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
