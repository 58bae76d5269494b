"""Truncated Knowledge Distillation (the paper's §3.5) and the hash
predictor's training (port of `repro/core/tkd.py`).

Objective: λ·L_CE + L_TKD(T). L_TKD matches the teacher router's softmax
over its top-T logits only (the LSTM student cannot model the full E-way
distribution); L_CE on the teacher's argmax drives the hash hit rate. The
SparseMax attention's gradient runs through `kernels.autograd.Sparsemax`
(the hand-written kernel forward on the card).
"""
from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch

from repro_torch.core.hash_fn import hash_fn_apply, hash_hit_rate
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.tree import leaf_grads, requiring_grad


def tkd_loss(
    student_logits: torch.Tensor,   # [B, S, L, E]
    teacher_logits: torch.Tensor,   # [L, B, S, E] (the MoE model's router logits)
    T: int = 30,
    lam: float = 0.005,
    tau: float = 1.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    t = teacher_logits.movedim(0, 2).float()
    s = student_logits.float()
    E = t.shape[-1]
    T = min(T, E)

    # truncated KD over the teacher's top-T: a softmax restricted to the
    # logits at or above the T-th (ties included), -1e30 elsewhere
    thresh = torch.topk(t, T, dim=-1).values[..., -1:]
    mask = t >= thresh
    neg = torch.full_like(t, -1e30)
    p = torch.softmax(torch.where(mask, t / tau, neg), dim=-1)
    logq = torch.log_softmax(torch.where(mask, s / tau, neg), dim=-1)
    kd = -(p * torch.where(mask, logq, torch.zeros_like(logq))).sum(-1).mean() * tau ** 2

    # CE on the teacher's argmax (the hash hit)
    labels = torch.argmax(t, dim=-1)
    ce = -torch.gather(torch.log_softmax(s, dim=-1), -1, labels[..., None]).mean()

    loss = lam * ce + kd
    acc = (torch.argmax(s, dim=-1) == labels).float().mean()
    return loss, {"kd": kd.detach(), "ce": ce.detach(), "acc": acc}


def train_hash_fn(
    params: dict,
    batches: Iterator[Tuple[torch.Tensor, torch.Tensor]],  # (embeddings, teacher router logits)
    steps: int,
    lr: float = 5e-5,
    T: int = 30,
    lam: float = 0.005,
    log_every: int = 50,
    verbose: bool = True,
):
    """Offline hash-function training (the paper: AdamW, lr 5e-5, λ 0.005,
    T 30). -> (params, history of float records at every `log_every`-th and
    the last step)."""
    opt_state = adamw_init(params)
    history = []
    for step in range(steps):
        emb, teacher = next(batches)
        p = requiring_grad(params)
        s = hash_fn_apply(p, emb, num_experts=teacher.shape[-1])
        loss, m = tkd_loss(s, teacher.detach(), T=T, lam=lam)
        params, opt_state = adamw_update(leaf_grads(loss, p), params, opt_state, lr=lr,
                                         weight_decay=0.01)
        if step % log_every == 0 or step == steps - 1:
            rec = {k: float(v) for k, v in m.items()}
            rec.update(loss=float(loss.detach()), step=step)
            history.append(rec)
            if verbose:
                print(f"  hash-fn step {step:4d}  loss={rec['loss']:.4f} "
                      f"kd={rec['kd']:.4f} ce={rec['ce']:.4f} acc={rec['acc']:.3f}")
    return params, history


def train_draft_head(
    params: dict,
    embed_table: torch.Tensor,
    batches: Iterator[Tuple[torch.Tensor, torch.Tensor]],  # (embeddings, teacher LM logits)
    steps: int,
    num_experts: int,
    lr: float = 3e-3,
    verbose: bool = False,
):
    """Distil the serving model's greedy next-token choice into the
    tied-embedding draft head (speculative decode). Only `draft_proj`
    trains: the router heads and the LSTMs are returned as the same tensors,
    so the predictor's expert hit rate stays bit for bit. Hard-label CE on
    the model's argmax: greedy acceptance only asks that the draft match it."""
    assert "draft_proj" in params, "attach a draft head first (init_draft_head)"
    draft_p = {"draft_proj": params["draft_proj"]}
    base = {k: v for k, v in params.items() if k != "draft_proj"}
    opt_state = adamw_init(draft_p)
    history = []
    for step in range(steps):
        emb, teacher_lm = next(batches)
        labels = torch.argmax(teacher_lm.detach().float(), dim=-1)
        dp = requiring_grad(draft_p)
        _, draft = hash_fn_apply({**base, **dp}, emb, num_experts=num_experts, causal=True,
                                 embed_table=embed_table)
        lp = torch.log_softmax(draft, dim=-1)
        loss = -torch.gather(lp, -1, labels[..., None]).mean()
        acc = (torch.argmax(draft, dim=-1) == labels).float().mean()
        draft_p, opt_state = adamw_update(leaf_grads(loss, dp), draft_p, opt_state, lr=lr,
                                          weight_decay=0.0)
        if step % 50 == 0 or step == steps - 1:
            history.append({"step": step, "loss": float(loss.detach()), "acc": float(acc)})
            if verbose:
                print(f"  draft step {step:4d}  ce={float(loss.detach()):.4f} "
                      f"argmax_match={float(acc):.3f}")
    return {**base, **draft_p}, history


@torch.no_grad()
def evaluate_hash_fn(params, emb, teacher_logits, top: int = 3) -> Dict[str, float]:
    s = hash_fn_apply(params, emb, num_experts=teacher_logits.shape[-1])
    labels = torch.argmax(teacher_logits.float(), dim=-1)     # [L, B, S]
    return {
        "top1_hit": float(hash_hit_rate(s, labels, top=1)),
        f"top{top}_hit": float(hash_hit_rate(s, labels, top=top)),
    }
