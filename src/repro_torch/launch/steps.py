"""Step functions: train_step / prefill_step / serve_step (port of
`repro/launch/steps.py`).

The reference jits these; here they are plain functions over the port's
dict trees. The train step differentiates the forward by autograd, which
reaches the kernels through `kernels.autograd`'s Functions on the card.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import decode_step, forward, lm_loss
from repro_torch.optim.adamw import adamw_update
from repro_torch.tree import leaf_grads, requiring_grad


def loss_and_grads(cfg: ModelConfig, params, tokens, labels, remat: bool = True, enc_input=None):
    """The train step's objective, lm_loss + router_aux_coef·aux_loss +
    router_z_coef·z_loss, and its gradient over every leaf of `params`; the
    forward runs the recurrences' "assoc" form, and an encoder-decoder
    config's encoder over `enc_input`. -> (total, metrics, grads)."""
    p = requiring_grad(params)
    out = forward(p, cfg, tokens, remat=remat, enc_input=enc_input, scan_mode="assoc")
    loss = lm_loss(out["logits"], labels)
    total = (loss + cfg.moe.router_aux_coef * out["aux_loss"]
             + cfg.moe.router_z_coef * out["z_loss"])
    grads = leaf_grads(total, p)
    metrics = {"lm_loss": loss.detach(), "aux_loss": out["aux_loss"].detach(),
               "z_loss": out["z_loss"].detach(), "total_loss": total.detach()}
    return total.detach(), metrics, grads


def make_train_step(cfg: ModelConfig, lr: float = 1e-4, grad_clip: float = 1.0):
    def train_step(params, opt_state, tokens, labels, enc_input=None, lr_runtime=None):
        """-> (params, opt_state, metrics). `lr_runtime` overrides the
        baked-in lr, so a schedule sets it each step; `enc_input` feeds an
        encoder-decoder config's encoder. The reference's
        sharding-constraint branch pins gradients to a mesh's parameter
        sharding; one device has no mesh, so it has no counterpart here."""
        _, metrics, grads = loss_and_grads(cfg, params, tokens, labels, enc_input=enc_input)
        params, opt_state = adamw_update(
            grads, params, opt_state, lr=lr if lr_runtime is None else lr_runtime,
            weight_decay=0.01, grad_clip=grad_clip,
        )
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, tokens, enc_input=None):
        with torch.no_grad():
            return forward(params, cfg, tokens, enc_input=enc_input,
                           scan_mode="assoc")["logits"][:, -1]

    return prefill_step


def make_serve_step(cfg: ModelConfig, ctx=None):
    """`ctx` as the reference's: a dry run's decode context splits the K/V
    cache's sequence over its `decode_seq_axis` (`attention.decode_attention`);
    the train and prefill steps' forward has nothing that reads a training
    mesh's roles on one device."""
    def serve_step(params, cache, tokens):
        with torch.no_grad():
            return decode_step(params, cache, tokens, cfg, ctx=ctx)

    return serve_step
