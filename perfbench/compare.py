"""The numbers a check compares, each the widest gap over its sample."""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def routing_gap(ref_logits: torch.Tensor, ids: np.ndarray, alpha: np.ndarray
                ) -> Tuple[float, float]:
    """The predictor's choice against the reference's logits, both [n_moe,
    ..., *]: (the widest gap by which a chosen expert's reference logit lies
    below the reference's k-th best, the widest difference between a chosen
    α and the softmax of the reference's logits at the chosen experts)."""
    k = ids.shape[-1]
    ids_t = torch.as_tensor(ids, device=ref_logits.device).long()
    chosen = torch.gather(ref_logits, -1, ids_t)
    kth = torch.topk(ref_logits, k, dim=-1).values[..., -1:]
    gap = (kth - chosen).clamp(min=0).max()
    want = torch.softmax(chosen, dim=-1)
    err = (torch.as_tensor(alpha, device=want.device).float() - want).abs().max()
    return float(gap), float(err)


def logit_error(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest relative error of a position's logits: max over positions
    of ||got - ref|| / ||ref|| along the vocabulary (inf where got is not
    finite)."""
    got = got.float()
    if not torch.isfinite(got).all():
        return float("inf")
    return float(((got - ref).norm(dim=-1) / ref.norm(dim=-1).clamp(min=1e-30)).max())


def token_gap(ref_logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """The widest gap by which a served token's reference logit lies below
    the reference's best at its position: ref_logits [..., V], tokens [...]."""
    best = ref_logits.max(dim=-1).values
    served = torch.gather(ref_logits, -1, tokens.long()[..., None])[..., 0]
    return float((best - served).max())
