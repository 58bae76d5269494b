"""Mixture-of-Experts layer (port of `repro/models/moe.py`).

Top-k routing with per-block capacity, or SiDA's `routing_override` (ids and
weights from the hash table, translated to slot ids), and two dispatch
strategies with the reference's `auto` rule: "einsum" (one-hot dispatch /
combine products) and "gather" (index tables, scatter-add combine). The
per-block cumsum decides which assignments overflow capacity and drop, in
the reference's order, and overflowing assignments land in an explicit
overflow column / pad row that is sliced off (JAX drops them with
`mode="drop"`; torch would raise on an out-of-range index).

The expert compute always goes through `kernels.ops`: `expert_ffn` over fp
slot stacks, `expert_ffn_q` over int8-resident ones and `expert_ffn_q4` over
the warm tier's int4 slots (the hand-written kernels for CUDA tensors, the
plain versions for CPU tensors). `moe_decode` is the one-token-per-lane form
the decode step calls. Shared experts are added once, after the combine;
they are gated (GLU) where the configuration's `glu` is. The router is a
softmax top-k, or with `moe.score_func` "sigmoid" (nemotron_h) the top-k of
sigmoid scores plus a correction bias, renormalised over the chosen; a
`moe.routed_scaling_factor` other than 1 scales the routed weights, the
router's or the table's α alike.

Expert-parallel serving (`ctx` with an expert axis of M > 1 shards, and a
routing override, the reference's `served`): `_dispatch_combine_ep` runs
the reference's shard_map body once a shard in one process. Shard m masks
the global slot ids to its range (hot `[m·S8_loc, (m+1)·S8_loc)` and, when
tiered, warm `[S8 + m·S4_loc, ...)`), builds its capacity table at the
global C, runs one expert-FFN launch over its slice of the pool (a view,
no copy), and combines in the model dtype; the partials are summed in
shard order for the reference's psum. A token's contributions come from the
one shard that holds its slot, zeros elsewhere, so at top-1 the sum equals
the one-device combine.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.attention import ShardingCtx
from repro_torch.models.layers import act_fn, dense_init, normal, top_k


def init_moe(gen, cfg: ModelConfig, device) -> dict:
    m = cfg.moe
    d = cfg.d_model
    dtype = getattr(torch, cfg.dtype)
    p = {
        "router": dense_init(gen, d, m.num_experts, torch.float32, device, scale=0.02),
        "w_in": _stack_init(gen, m.num_experts, d, m.d_expert, dtype, device),
        # allocated for non-gated configs too, as the reference does
        "w_gate": _stack_init(gen, m.num_experts, d, m.d_expert, dtype, device),
        "w_out": _stack_init(gen, m.num_experts, m.d_expert, d, dtype, device),
    }
    if m.score_func == "sigmoid":
        # the sigmoid router's score-correction bias: it moves the choice only
        p["router_bias"] = normal(gen, (m.num_experts,), 0.01, torch.float32, device)
    if m.num_shared_experts:
        # the shared experts side by side: [d, n_shared * d_shared] and back
        ds = m.d_shared * m.num_shared_experts
        p["shared_w_in"] = dense_init(gen, d, ds, dtype, device)
        if cfg.glu:
            p["shared_w_gate"] = dense_init(gen, d, ds, dtype, device)
        p["shared_w_out"] = dense_init(gen, ds, d, dtype, device)
    return p


def _stack_init(gen, e, d_in, d_out, dtype, device):
    return normal(gen, (e, d_in, d_out), 1.0 / math.sqrt(d_in), dtype, device)


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def router_topk(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """[T, E] -> (ids [T, k], weights [T, k]); weights renormalised softmax."""
    gates = torch.softmax(logits.float(), dim=-1)
    w, ids = top_k(gates, k)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return ids, w


def router_sigmoid_topk(logits: torch.Tensor, bias: Optional[torch.Tensor], k: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[T, E] -> (ids [T, k], weights [T, k]): the k best sigmoid scores s
    after the correction bias is added to them (`bias` [E], the choice
    only), weighted s_i / Σ s over the k chosen. The routed scaling factor
    is `moe_layer`'s."""
    s = torch.sigmoid(logits.float())
    _, ids = top_k(s if bias is None else s + bias.float(), k)
    w = torch.gather(s, -1, ids)
    return ids, w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)


def load_balance_loss(logits: torch.Tensor, ids: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Switch-style aux loss: E * sum_e f_e * P_e."""
    gates = torch.softmax(logits.float(), dim=-1)
    me = gates.mean(dim=0)
    ce = F.one_hot(ids[..., 0], num_experts).float().mean(dim=0)
    return num_experts * (me * ce).sum()


def router_z_loss(logits: torch.Tensor) -> torch.Tensor:
    return torch.logsumexp(logits.float(), dim=-1).square().mean()


# ---------------------------------------------------------------------------
# capacity
# ---------------------------------------------------------------------------


def _capacity(cfg: ModelConfig, n_tokens: int, num_experts: int) -> int:
    m = cfg.moe
    c = int(m.capacity_factor * n_tokens * m.top_k / num_experts)
    return max(8, min(n_tokens, c))


def _block_tokens(T: int, target: int = 4096) -> int:
    """Largest divisor of T that is <= target (per-block capacity)."""
    if T <= target:
        return T
    for blk in range(target, 0, -1):
        if T % blk == 0:
            return blk
    return T


# ---------------------------------------------------------------------------
# MoE layer forward
# ---------------------------------------------------------------------------


def moe_layer(
    params: dict,
    x: torch.Tensor,                 # [B, S, d]
    cfg: ModelConfig,
    routing_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # ids/w [B,S,k]
    dispatch: str = "auto",
    ctx: Optional[ShardingCtx] = None,
):
    """Returns (y [B,S,d], aux) with aux = dict(router_logits, aux_loss, z_loss)."""
    m = cfg.moe
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    if routing_override is not None:
        ids, w = routing_override
        ids = ids.reshape(T, -1)[:, : m.top_k].long()
        w = w.reshape(T, -1)[:, : m.top_k].float()
        router_logits, aux_loss, z_loss = None, zero, zero
    else:
        router_logits = xt.float() @ params["router"]
        if m.score_func == "sigmoid":
            ids, w = router_sigmoid_topk(router_logits, params.get("router_bias"), m.top_k)
        else:
            ids, w = router_topk(router_logits, m.top_k)
        aux_loss = load_balance_loss(router_logits, ids, m.num_experts)
        z_loss = router_z_loss(router_logits)
    if m.routed_scaling_factor != 1.0:
        w = w * m.routed_scaling_factor

    y = _dispatch_combine(params, xt, ids, w, cfg, dispatch, ctx,
                          served=routing_override is not None)
    if m.num_shared_experts:
        # always active, whatever the routing; added to the fp32 combine
        y = y + shared_experts(params, xt, cfg)
    aux = {
        "router_logits": (
            router_logits.reshape(B, S, m.num_experts) if router_logits is not None else None
        ),
        "aux_loss": aux_loss,
        "z_loss": z_loss,
    }
    return y.reshape(B, S, d).to(x.dtype), aux


def shared_experts(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The shared experts side by side, act(x Wg) * (x Wi) Wo, in x's dtype
    (`src/repro/models/moe.py:164-167`); act(x Wi) Wo where they are not
    gated (a configuration whose `glu` is false)."""
    h = x @ params["shared_w_in"]
    if "shared_w_gate" in params:
        h = act_fn(cfg.act)(x @ params["shared_w_gate"]) * h
    else:
        h = act_fn(cfg.act)(h)
    return h @ params["shared_w_out"]


def _dispatch_combine(params, xt, ids, w, cfg, dispatch, ctx=None, served=False):
    """Token-blocked dispatch -> expert compute -> combine (see module doc).

    E is the slot count of the weight stack, not `num_experts`: SiDA serving
    passes slot pools with S_slots << num_experts and slot-translated ids.
    Under an expert-parallel `ctx` a served forward (or a gather dispatch)
    always takes `_dispatch_combine_ep`, the reference's condition."""
    T, d = xt.shape
    E, K = params["w_in"].shape[0], ids.shape[-1]
    if expert_params_tiered(params):
        # hot slots [0, S8) then warm slots [S8, S8 + S4): one slot space
        E += params["w_in_q4"].shape[0]
    blk = _block_tokens(T)
    n = T // blk
    C = _capacity(cfg, blk, E)
    if dispatch == "auto":
        dispatch = "einsum" if blk * E * C <= (1 << 24) else "gather"
    shards = ctx.ep_shards if ctx is not None else 1
    if shards > 1 and (dispatch == "gather" or served):
        if E % shards:
            # a sharded store's pools always divide; never fall back to one shard
            raise ValueError(f"{E} slots do not divide over {shards} expert-parallel shards")
        return _dispatch_combine_ep(params, xt, ids, w, cfg, blk, n, C, shards)

    ids_b = ids.reshape(n, blk, K)
    w_b = w.reshape(n, blk, K)
    x_b = xt.reshape(n, blk, d)

    # position of each (token, k) assignment in its expert's per-block
    # capacity buffer: cumsum over the block in token-major order
    flat_oh = F.one_hot(ids_b, E).reshape(n, blk * K, E)
    pos = (flat_oh.cumsum(dim=1) - 1).reshape(n, blk, K, E)
    pos = torch.gather(pos, -1, ids_b[..., None])[..., 0]           # [n,blk,K]
    keep = pos < C
    w_b = w_b * keep

    if dispatch == "gather":
        rows = torch.arange(n, device=xt.device)[:, None, None]
        tok_idx = torch.arange(blk, device=xt.device)[None, :, None].expand(n, blk, K)
        slot = torch.where(keep, ids_b * C + pos, torch.full_like(pos, E * C))
        # table[n, e, c] = which token sits in slot (e, c); column E*C takes
        # the overflow, empty slots point at the zero pad row `blk`
        table = torch.full((n, E * C + 1), blk, dtype=torch.long, device=xt.device)
        table.scatter_(1, slot.reshape(n, -1), tok_idx.reshape(n, -1))
        table = table[:, : E * C].reshape(n, E, C)
        x_pad = torch.cat([x_b, x_b.new_zeros((n, 1, d))], dim=1)
        xe = x_pad[rows, table]                                      # [n,E,C,d]
        ye = apply_expert_stack_blocked(params, xe, cfg)
        gate = torch.zeros((n, E * C + 1), dtype=torch.float32, device=xt.device)
        gate.scatter_add_(1, slot.reshape(n, -1), w_b.float().reshape(n, -1))
        gate = gate[:, : E * C].reshape(n, E, C)
        contrib = (ye.float() * gate[..., None]).reshape(n, E * C, d)
        y = torch.zeros((n, blk + 1, d), dtype=torch.float32, device=xt.device)
        y.scatter_add_(1, table.reshape(n, E * C, 1).expand(n, E * C, d), contrib)
        return y[:, :blk].reshape(T, d)

    # einsum dispatch (exact oracle; fine for small blk·E·C)
    oh = (
        F.one_hot(ids_b, E).to(xt.dtype)[..., None]
        * F.one_hot(torch.where(keep, pos, torch.full_like(pos, C)), C + 1).to(xt.dtype)[..., None, :C]
    )                                                                # [n,blk,K,E,C]
    xe = torch.einsum("nbd,nbec->necd", x_b, oh.sum(2))
    ye = apply_expert_stack_blocked(params, xe, cfg)
    comb = torch.einsum("nbkec,nbk->nbec", oh, w_b.to(xt.dtype))
    return _combine(ye, comb).reshape(T, d)


def _combine(ye: torch.Tensor, comb: torch.Tensor) -> torch.Tensor:
    """The einsum path's combine, ye [n, E, C, d] x comb [n, blk, E, C] ->
    [n, blk, d] in fp32: each token's weighted sum of its slots' outputs."""
    return torch.einsum("necd,nbec->nbd", ye, comb).float()


def _dispatch_combine_ep(params, xt, ids, w, cfg, blk, n, C, shards):
    """Expert-parallel dispatch / combine (the reference's shard_map body,
    once a shard; see the module doc). Returns y [T, d] in xt's dtype."""
    T, d = xt.shape
    K = ids.shape[-1]
    S8 = params["w_in"].shape[0]
    tiered = expert_params_tiered(params)
    S4 = params["w_in_q4"].shape[0] if tiered else 0
    S8_loc, S4_loc = S8 // shards, S4 // shards
    E_loc = S8_loc + S4_loc
    dev = xt.device
    ids_b, w_b = ids.reshape(n, blk, K), w.reshape(n, blk, K)
    x_pad = torch.cat([xt.reshape(n, blk, d), xt.new_zeros((n, 1, d))], dim=1)
    rows = torch.arange(n, device=dev)[:, None, None]
    tok = torch.arange(blk, device=dev)[None, :, None].expand(n, blk, K).reshape(n, -1)
    y = None
    for m in range(shards):
        if tiered:
            # two global ranges a shard, hot then warm, onto the local
            # stack [0, S8_loc) ++ [S8_loc, S8_loc + S4_loc)
            hot_l = ids_b - m * S8_loc
            is_hot = (ids_b < S8) & (hot_l >= 0) & (hot_l < S8_loc)
            warm_l = ids_b - S8 - m * S4_loc
            is_warm = (ids_b >= S8) & (warm_l >= 0) & (warm_l < S4_loc)
            local = is_hot | is_warm
            idsl = torch.where(is_warm, S8_loc + warm_l, hot_l)
        else:
            idsl = ids_b - m * E_loc
            local = (idsl >= 0) & (idsl < E_loc)
        idsl_c = idsl.clamp(0, E_loc - 1)
        oh = F.one_hot(torch.where(local, idsl_c, torch.full_like(idsl_c, E_loc)),
                       E_loc + 1)[..., :E_loc]                       # [n, blk, K, E_loc]
        pos = (oh.reshape(n, blk * K, E_loc).cumsum(dim=1) - 1).reshape(n, blk, K, E_loc)
        pos = torch.gather(pos, -1, idsl_c[..., None])[..., 0]
        keep = local & (pos < C)
        slot = torch.where(keep, idsl_c * C + pos, torch.full_like(pos, E_loc * C)).reshape(n, -1)
        # the local capacity table at the global C; column E_loc*C takes the
        # overflow, empty entries point at the zero pad row `blk`
        table = torch.full((n, E_loc * C + 1), blk, dtype=torch.long, device=dev)
        table.scatter_(1, slot, tok)
        table = table[:, : E_loc * C].reshape(n, E_loc, C)
        ye = apply_expert_stack_blocked(shard_slice(params, m, S8_loc, S4_loc),
                                        x_pad[rows, table], cfg)     # [n, E_loc, C, d]
        gate = torch.zeros((n, E_loc * C + 1), dtype=torch.float32, device=dev)
        gate.scatter_add_(1, slot, (w_b * keep).float().reshape(n, -1))
        gate = gate[:, : E_loc * C].reshape(n, E_loc, C)
        # combine in the model dtype, as the reference's shard does
        contrib = (ye.float() * gate[..., None]).to(xt.dtype).reshape(n, E_loc * C, d)
        y0 = torch.zeros((n, blk + 1, d), dtype=xt.dtype, device=dev)
        y0.scatter_add_(1, table.reshape(n, E_loc * C, 1).expand(n, E_loc * C, d), contrib)
        y = y0[:, :blk] if y is None else y + y0[:, :blk]          # the psum, in shard order
    return y.reshape(T, d)


def shard_slice(params: dict, m: int, S8_loc: int, S4_loc: int) -> dict:
    """Shard m's slice of a slot stack: the int8 / fp pools and their scale
    planes at [m·S8_loc, (m+1)·S8_loc), the warm int4 pools and planes at
    [m·S4_loc, (m+1)·S4_loc) of their own axis. Views of the pools (a slice
    of the leading axis of a contiguous tensor is contiguous), never
    copies."""
    out = {}
    for k, v in params.items():
        if not k.startswith("w_"):
            continue
        n = S4_loc if "_q4" in k else S8_loc
        out[k] = v[m * n:(m + 1) * n]
    return out


def expert_params_quantized(p: dict) -> bool:
    """True when the expert stack is int8-resident: the store publishes
    `w_*_scale` planes beside the int8 pools."""
    return "w_in_scale" in p


def expert_params_tiered(p: dict) -> bool:
    """True when the stack also carries the warm int4 tier: the tiered store
    publishes nibble-packed `w_*_q4` pools and `w_*_q4_scale` planes beside
    the int8 hot pools."""
    return "w_in_q4" in p


def apply_expert_stack(p: dict, xe: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """xe: [E, C, d] -> [E, C, d] through each expert's (G)LU FFN, unblocked:
    the reference's three einsums (`src/repro/models/moe.py:95-103`), which
    it computes outside any Pallas kernel, so plain PyTorch on every device.
    Nothing in either package calls it; the served and trained paths take
    `apply_expert_stack_blocked`, whose kernel (B1) computes the same FFN."""
    h = torch.einsum("ecd,edf->ecf", xe, p["w_in"])
    if cfg.glu:
        g = torch.einsum("ecd,edf->ecf", xe, p["w_gate"])
        h = act_fn(cfg.act)(g) * h
    else:
        h = act_fn(cfg.act)(h)
    return torch.einsum("ecf,efd->ecd", h, p["w_out"])


def apply_expert_stack_blocked(p: dict, xe: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """xe: [n, E, C, d] -> [n, E, C, d] through each slot's (G)LU FFN, as
    one [E, n·C, d] call of `ops.expert_ffn`, or of `ops.expert_ffn_q` when
    the slots are int8 (the reference's Pallas-path reshape). On the CPU the
    int8 call is the reference's jnp path: dequantise to x's dtype, then the
    plain FFN. A tiered stack splits the slot axis into the int8 hot block
    [0, S8) and the int4 warm block, each through its own kernel."""
    if expert_params_tiered(p):
        S8 = p["w_in"].shape[0]
        hot = {k: v for k, v in p.items() if "_q4" not in k}
        y8 = apply_expert_stack_blocked(hot, xe[:, :S8], cfg)
        y4 = _apply_expert_stack_q4(p, xe[:, S8:], cfg)
        return torch.cat([y8, y4], dim=1)
    n, E, C, d = xe.shape
    x2 = xe.transpose(0, 1).reshape(E, n * C, d).contiguous()
    if expert_params_quantized(p):
        out = ops.expert_ffn_q(
            x2, p["w_in"], p["w_in_scale"],
            p["w_gate"] if cfg.glu else None, p["w_gate_scale"] if cfg.glu else None,
            p["w_out"], p["w_out_scale"], act=cfg.act,
        )
    else:
        out = ops.expert_ffn(
            x2, p["w_in"], p["w_gate"] if cfg.glu else None, p["w_out"], act=cfg.act,
        )
    return out.reshape(E, n, C, d).transpose(0, 1)


def _apply_expert_stack_q4(p: dict, xe: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """xe: [n, S4, C, d] -> [n, S4, C, d] through the warm int4 slots, as one
    `ops.expert_ffn_q4` call. On the CPU that is the reference's jnp path:
    dequantise per group to x's dtype, then the plain FFN."""
    n, E, C, d = xe.shape
    x2 = xe.transpose(0, 1).reshape(E, n * C, d).contiguous()
    out = ops.expert_ffn_q4(
        x2, p["w_in_q4"], p["w_in_q4_scale"],
        p["w_gate_q4"] if cfg.glu else None, p["w_gate_q4_scale"] if cfg.glu else None,
        p["w_out_q4"], p["w_out_q4_scale"], act=cfg.act,
    )
    return out.reshape(E, n, C, d).transpose(0, 1)


# ---------------------------------------------------------------------------
# decode-path MoE (single token per sequence)
# ---------------------------------------------------------------------------


def moe_decode(
    params: dict,
    x: torch.Tensor,                 # [B, d]
    cfg: ModelConfig,
    routing_override: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # ids/w [B,k]
    ctx: Optional[ShardingCtx] = None,
) -> torch.Tensor:
    ro = None
    if routing_override is not None:
        ro = (routing_override[0][:, None], routing_override[1][:, None])
    y, _ = moe_layer(params, x[:, None, :], cfg, routing_override=ro, ctx=ctx)
    return y[:, 0]
