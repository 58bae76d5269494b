"""Config-driven transformer, attention + MoE block kinds (port of
`repro/models/transformer.py`: the full-sequence forward, the ring K/V
cache and the one-token `decode_step`).

Layers are grouped into repeating periods (Switch's dense/MoE pair) and each
sublayer's params are stacked over the groups, as in the reference; its
`lax.scan` over the stacked groups becomes a Python loop over the leading
group axis of the params and of the cache. `init_paged_cache` and the paged
branch of `decode_step` keep K/V in shared page pools read through a page
table (`core/residency.py`). `verify_step` runs a speculative draft block
and rolls the rejected positions back. `prefill_chunk_step` advances one
paged lane through a prompt chunk (the request server's chunked prefill).
Recurrent / hybrid blocks and encoder-decoder stacks are ported with the
other families (ROADMAP A15).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.attention import (
    attend_decode,
    attend_decode_paged,
    attend_full,
    attend_prefill_chunk,
    init_attention,
)
from repro_torch.models.layers import embed_init, ffn, init_ffn, init_rmsnorm, rmsnorm, softcap
from repro_torch.models.moe import init_moe, moe_decode, moe_layer
from repro_torch.tree import tree_map, tree_stack


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.block_kind != "attn":
        raise NotImplementedError(
            f"block_kind {cfg.block_kind!r} is ported with the other families (ROADMAP A15)"
        )
    if cfg.enc_dec:
        raise NotImplementedError("encoder-decoder stacks are ported with the other families (ROADMAP A15)")


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def period(cfg: ModelConfig) -> int:
    p = _lcm(1, len(cfg.attn.layer_pattern))
    if cfg.moe.enabled:
        p = _lcm(p, cfg.moe.moe_every)
    return p


def sub_kind(cfg: ModelConfig, sub: int) -> Dict[str, Any]:
    """Static description of sublayer `sub` within a period group."""
    is_moe = cfg.moe.enabled and (sub % cfg.moe.moe_every == cfg.moe.moe_every - 1)
    return {"kind": "attn", "moe": is_moe, "window": cfg.layer_window(sub)}


def n_moe_layers(cfg: ModelConfig) -> int:
    if not cfg.moe.enabled:
        return 0
    return cfg.n_layers // cfg.moe.moe_every


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_sublayer(gen, cfg: ModelConfig, sub: int, device) -> dict:
    dtype = getattr(torch, cfg.dtype)
    d = cfg.d_model
    p: dict = {"ln1": init_rmsnorm(d, dtype, device), "attn": init_attention(gen, cfg, device)}
    p["ln2"] = init_rmsnorm(d, dtype, device)
    if sub_kind(cfg, sub)["moe"]:
        p["moe"] = init_moe(gen, cfg, device)
    elif cfg.d_ff:
        p["mlp"] = init_ffn(gen, d, cfg.d_ff, cfg.glu, dtype, device)
    if cfg.post_norm:
        p["ln1_post"] = init_rmsnorm(d, dtype, device)
        p["ln2_post"] = init_rmsnorm(d, dtype, device)
    return p


def init_params(gen: torch.Generator, cfg: ModelConfig, device: DeviceLike = None) -> dict:
    """Random weights from `gen`, placed on `device` (CUDA unless asked
    otherwise). They are drawn on the generator's device, so a CPU generator
    gives the same weights for any target device."""
    _check_supported(cfg)
    device = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    per = period(cfg)
    assert cfg.n_layers % per == 0, (cfg.name, cfg.n_layers, per)
    groups = [
        {f"sub{s}": _init_sublayer(gen, cfg, s, device) for s in range(per)}
        for _ in range(cfg.n_layers // per)
    ]
    params = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype, device),
        "blocks": tree_stack(groups),
        "final_norm": init_rmsnorm(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype, device).T.contiguous()
    return params


# ---------------------------------------------------------------------------
# full-sequence forward
# ---------------------------------------------------------------------------


def attention_half(bp, x, cfg, sub, aux: Optional[dict] = None):
    """The attention half of a sublayer: attention, residual, then the
    pre-FFN norm. Returns (x, h) with h the FFN / MoE input; with an `aux`
    dict, the rope-applied K/V go into aux["kv"]. The layerwise baselines
    call it too, so their router input is the full forward's, bit for bit."""
    h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
    if aux is not None:
        # rope-applied K/V, what a decode cache holds at positions 0..S-1
        a, aux["kv"] = attend_full(bp["attn"], h, cfg, sub, return_kv=True)
    else:
        a = attend_full(bp["attn"], h, cfg, sub)
    if cfg.post_norm:
        a = rmsnorm(bp["ln1_post"], a, cfg.norm_eps)
    x = x + a
    return x, rmsnorm(bp["ln2"], x, cfg.norm_eps)


def _apply_sublayer_full(bp, x, cfg, sub, routing_override, collect_kv):
    aux: dict = {}
    x, h = attention_half(bp, x, cfg, sub, aux if collect_kv else None)
    if sub_kind(cfg, sub)["moe"]:
        y, moe_aux = moe_layer(bp["moe"], h, cfg, routing_override=routing_override)
        aux.update(moe_aux)
    elif "mlp" in bp:
        y = ffn(bp["mlp"], h, cfg.act, cfg.glu)
    else:
        y = torch.zeros_like(h)
    if cfg.post_norm:
        y = rmsnorm(bp["ln2_post"], y, cfg.norm_eps)
    return x + y, aux


def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    x = params["embed"][tokens.long()]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)
    return x


def unembed(params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    logits = x @ (params["embed"].T if cfg.tie_embeddings else params["head"])
    logits = softcap(logits, cfg.final_logit_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        # padded vocab columns are unreachable (see ModelConfig.padded_vocab)
        mask = torch.arange(cfg.padded_vocab, device=x.device) < cfg.vocab_size
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
    return logits


def forward(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,                 # [B, S] int
    routing_override=None,                # (ids [L_moe,B,S,k], w [L_moe,B,S,k]) or None
    collect_router_logits: bool = False,
    collect_kv: bool = False,
) -> Dict[str, Any]:
    """Full forward. Returns dict(logits, aux_loss, z_loss, router_logits?,
    kv?); kv is {sub: (k, v)} with each [G, B, S, K, D]."""
    _check_supported(cfg)
    per = period(cfg)
    moe_subs = [s for s in range(per) if sub_kind(cfg, s)["moe"]]
    x = embed_tokens(params, cfg, tokens)
    n_groups = cfg.n_layers // per
    aux_loss = z_loss = torch.zeros((), dtype=torch.float32, device=x.device)
    router_logits, kvs = [], []
    for g in range(n_groups):
        gp = tree_map(lambda t: t[g], params["blocks"])
        kv_g = {}
        for s in range(per):
            ro = None
            if routing_override is not None and s in moe_subs:
                li = g * len(moe_subs) + moe_subs.index(s)
                ro = (routing_override[0][li], routing_override[1][li])
            x, aux = _apply_sublayer_full(gp[f"sub{s}"], x, cfg, s, ro, collect_kv)
            if "kv" in aux:
                kv_g[f"sub{s}"] = aux.pop("kv")
            if s in moe_subs:
                aux_loss = aux_loss + aux["aux_loss"]
                z_loss = z_loss + aux["z_loss"]
                router_logits.append(aux["router_logits"])
        kvs.append(kv_g)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    out: Dict[str, Any] = {
        "logits": unembed(params, cfg, x), "aux_loss": aux_loss, "z_loss": z_loss,
    }
    if collect_router_logits:
        out["router_logits"] = torch.stack(router_logits)    # [L_moe, B, S, E]
    if collect_kv:
        out["kv"] = tree_stack(kvs)
    return out


# ---------------------------------------------------------------------------
# cache + decode
# ---------------------------------------------------------------------------


def cache_len(cfg: ModelConfig, sub: int, seq_budget: int) -> int:
    w = sub_kind(cfg, sub).get("window", 0)
    return min(seq_budget, w) if w else seq_budget


def init_cache(cfg: ModelConfig, batch: int, seq_budget: int, device: DeviceLike = None) -> dict:
    """Zeros ring cache on `device` (CUDA unless asked otherwise). Layout:
    {"pos": [B] int32, "sub{s}": {"k", "v": [G, B, Sc, K, D]}}."""
    _check_supported(cfg)
    device = resolve_device(device)
    per = period(cfg)
    n_groups = cfg.n_layers // per
    dtype = getattr(torch, cfg.dtype)
    K, D = cfg.n_kv_heads, cfg.hd
    cache: dict = {"pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    for s in range(per):
        Sc = cache_len(cfg, s, seq_budget)
        cache[f"sub{s}"] = {
            "k": torch.zeros((n_groups, batch, Sc, K, D), dtype=dtype, device=device),
            "v": torch.zeros((n_groups, batch, Sc, K, D), dtype=dtype, device=device),
        }
    return cache


def init_paged_cache(cfg: ModelConfig, batch: int, paged, device: DeviceLike = None) -> dict:
    """Zeros paged cache on `device` (CUDA unless asked otherwise). Layout:
    {"pos": [B] int32, "page_table": [B, Mp] int32 (-1 = unallocated),
    "sub{s}": {"kp", "vp": [G, P+1, page, K, D]}}: the pools are shared by
    all lanes and the last page is the trash page. One table serves every
    layer, since all layers cache the same positions. `paged` is a
    `residency.PagedKVConfig`; `KVPagePool` keeps the table."""
    _check_supported(cfg)
    device = resolve_device(device)
    per = period(cfg)
    n_groups = cfg.n_layers // per
    dtype = getattr(torch, cfg.dtype)
    K, D = cfg.n_kv_heads, cfg.hd
    cache: dict = {
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        "page_table": torch.full((batch, paged.pages_per_lane()), -1, dtype=torch.int32,
                                 device=device),
    }
    shape = (n_groups, paged.kv_pages + 1, paged.page_size, K, D)
    for s in range(per):
        cache[f"sub{s}"] = {
            "kp": torch.zeros(shape, dtype=dtype, device=device),
            "vp": torch.zeros(shape, dtype=dtype, device=device),
        }
    return cache


def _apply_sublayer_decode(bp, kv, x, pos, cfg, sub, routing_override,
                           page_table=None, active=None):
    """One sublayer for one token. `kv` is the group's (k, v) ring [B, Sc,
    K, D] or, with `page_table`, its (kp, vp) page pools; either is written
    in place."""
    h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
    if page_table is not None:
        a, _, _ = attend_decode_paged(bp["attn"], h, kv[0], kv[1], page_table, pos, cfg, sub,
                                      active=active)
    else:
        a, _, _ = attend_decode(bp["attn"], h, kv[0], kv[1], pos, cfg, sub)
    if cfg.post_norm:
        a = rmsnorm(bp["ln1_post"], a, cfg.norm_eps)
    x = x + a
    h = rmsnorm(bp["ln2"], x, cfg.norm_eps)
    if sub_kind(cfg, sub)["moe"]:
        y = moe_decode(bp["moe"], h, cfg, routing_override=routing_override)
    elif "mlp" in bp:
        y = ffn(bp["mlp"], h, cfg.act, cfg.glu)
    else:
        y = torch.zeros_like(h)
    if cfg.post_norm:
        y = rmsnorm(bp["ln2_post"], y, cfg.norm_eps)
    return x + y


def decode_step(
    params: dict,
    cache: dict,
    tokens: torch.Tensor,      # [B] int
    cfg: ModelConfig,
    routing_override=None,     # (ids [L_moe,B,k], w [L_moe,B,k]) or None
    active: Optional[torch.Tensor] = None,   # [B] bool; paged: inactive lanes write trash
):
    """One serve step: next-token logits [B, V] and the cache. The K/V
    tensors (ring or page pools) are updated in place (see
    `attention.attend_decode`); the returned dict holds them and the
    advanced `pos`."""
    _check_supported(cfg)
    per = period(cfg)
    moe_subs = [s for s in range(per) if sub_kind(cfg, s)["moe"]]
    pos = cache["pos"]
    page_table = cache.get("page_table")
    names = ("kp", "vp") if page_table is not None else ("k", "v")
    x = embed_tokens(params, cfg, tokens)
    for g in range(cfg.n_layers // per):
        gp = tree_map(lambda t: t[g], params["blocks"])
        for s in range(per):
            ro = None
            if routing_override is not None and s in moe_subs:
                li = g * len(moe_subs) + moe_subs.index(s)
                ro = (routing_override[0][li], routing_override[1][li])
            entry = cache[f"sub{s}"]
            kv = (entry[names[0]][g], entry[names[1]][g])
            x = _apply_sublayer_decode(gp[f"sub{s}"], kv, x, pos, cfg, s, ro,
                                       page_table=page_table, active=active)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed(params, cfg, x)
    new_cache = dict(cache)
    new_cache["pos"] = pos + 1
    return logits, new_cache


# ---------------------------------------------------------------------------
# speculative verify: kb-position decode with accept/reject rollback
# ---------------------------------------------------------------------------


def _block_index(cache: dict, skey: str, pos0: torch.Tensor, kb: int, active=None):
    """Where block position pos0 + i of each lane writes sublayer `skey`'s
    K/V, as a pair of [B, kb] indices into the tensor's dims 1 and 2: (lane,
    ring slot), or (page id, offset) through the installed table, with
    positions past the table, unallocated entries and inactive lanes on the
    trash page, as `attend_decode_paged` writes them."""
    p = pos0.long()[:, None] + torch.arange(kb, device=pos0.device)[None, :]
    pt = cache.get("page_table")
    if pt is None:
        lanes = torch.arange(p.shape[0], device=p.device)[:, None].expand_as(p)
        return lanes, p % cache[skey]["k"].shape[2]
    kp = cache[skey]["kp"]
    page, trash, Mp = kp.shape[2], kp.shape[1] - 1, pt.shape[1]
    pidx = p // page
    in_table = pidx < Mp
    pid = torch.gather(pt, 1, torch.where(in_table, pidx, 0)).long()
    ok = in_table & (pid >= 0)
    if active is not None:
        ok &= active[:, None]
    return torch.where(ok, pid, torch.full_like(pid, trash)), p % page


def verify_step(
    params: dict,
    cache: dict,
    tokens: torch.Tensor,      # [B, kb]: column 0 the last accepted token, then the drafts
    cfg: ModelConfig,
    routing_override=None,     # (ids [kb, L_moe, B, k], w [kb, L_moe, B, k]) or None
    active: Optional[torch.Tensor] = None,   # [B] bool; False => lane fully rolled back
):
    """Verify a speculative draft block: `kb` sequential `decode_step`s, so
    each position's math is the one-token step's and greedy outputs equal
    those of `kb` separate steps.

    Acceptance: position 0's input is the real last token, so its argmax is
    always emitted; position i > 0 consumed draft `tokens[:, i]`, so its
    output counts only while every earlier draft matched the model's
    argmax. n_acc is in [1, kb] a lane (0 for an inactive lane).

    Rollback leaves the cache as if only the accepted prefix had run. The
    reference restores rejected positions from the untouched pre-verify
    cache; here `decode_step` writes K/V in place, so before the block runs
    this snapshots only what the block will overwrite, the kb entries a
    lane of each K/V tensor (ring slots (pos0 + i) % Sc, or the (page,
    offset) the installed table gives, trash for positions past it), and
    writes the rejected ones back afterwards. `pos` advances by n_acc.

    Returns (out tokens [B, kb] int32, n_acc [B] int32, logits [kb, B, V],
    the cache); the cache's K/V tensors are the ones passed in, updated in
    place."""
    B, kb = tokens.shape
    subs = [k for k in cache if k.startswith("sub")]
    if any("state" in cache[k] for k in subs):
        raise NotImplementedError("recurrent-state rollback comes with ROADMAP A15")
    names = ("kp", "vp") if cache.get("page_table") is not None else ("k", "v")
    if names[0] == "k":
        for skey in subs:
            if cache[skey]["k"].shape[2] < kb:
                raise ValueError(f"draft window {kb} exceeds {skey}'s ring cache "
                                 f"({cache[skey]['k'].shape[2]} slots)")
    pos0 = cache["pos"]
    idx = {skey: _block_index(cache, skey, pos0, kb, active) for skey in subs}
    snap = {(skey, n): cache[skey][n][:, idx[skey][0], idx[skey][1]]    # [G, B, kb, K, D]
            for skey in subs for n in names}

    c, outs, logits = cache, [], []
    for i in range(kb):
        ro = None if routing_override is None else (routing_override[0][i],
                                                    routing_override[1][i])
        lg, c = decode_step(params, c, tokens[:, i], cfg, routing_override=ro, active=active)
        logits.append(lg)
        outs.append(torch.argmax(lg, dim=-1).to(torch.int32))
    out = torch.stack(outs, dim=1)                           # [B, kb]

    # longest accepted prefix: 1 (position 0 is real) + leading draft matches
    match = (out[:, :kb - 1] == tokens[:, 1:]).to(torch.int32)
    n_acc = (1 + torch.cumprod(match, dim=1).sum(dim=1)).to(torch.int32)
    if active is not None:
        n_acc = torch.where(active, n_acc, torch.zeros_like(n_acc))
    rejected = torch.arange(kb, device=tokens.device)[None, :] >= n_acc[:, None]
    for (skey, n), sn in snap.items():
        t, (i0, i1) = c[skey][n], idx[skey]
        t[:, i0, i1] = torch.where(rejected[None, :, :, None, None], sn, t[:, i0, i1])
    new_cache = dict(c)
    new_cache["pos"] = pos0 + n_acc
    return out, n_acc, torch.stack(logits), new_cache


# ---------------------------------------------------------------------------
# chunked prefill: advance one paged lane through a prompt chunk
# ---------------------------------------------------------------------------


def _apply_sublayer_chunk(bp, kv, x, pos0, page_table, cfg, sub, routing_override):
    """`_apply_sublayer_full` for a [1, T] chunk that continues at absolute
    position pos0 against the paged cache; `kv` is the group's (kp, vp)
    pools, written in place."""
    h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
    a, _, _ = attend_prefill_chunk(bp["attn"], h, kv[0], kv[1], page_table, pos0, cfg, sub)
    if cfg.post_norm:
        a = rmsnorm(bp["ln1_post"], a, cfg.norm_eps)
    x = x + a
    h = rmsnorm(bp["ln2"], x, cfg.norm_eps)
    if sub_kind(cfg, sub)["moe"]:
        y, _ = moe_layer(bp["moe"], h, cfg, routing_override=routing_override)
    elif "mlp" in bp:
        y = ffn(bp["mlp"], h, cfg.act, cfg.glu)
    else:
        y = torch.zeros_like(h)
    if cfg.post_norm:
        y = rmsnorm(bp["ln2_post"], y, cfg.norm_eps)
    return x + y


def prefill_chunk_step(
    params: dict,
    cache: dict,
    tokens: torch.Tensor,      # [1, T] one chunk of one lane's prompt
    cfg: ModelConfig,
    routing_override=None,     # (ids [L_moe, 1, T, k], w) as the full forward takes
):
    """Advance one paged lane through a prompt chunk: the full forward's
    math over [1, T] at absolute positions pos0 .. pos0 + T - 1, writing K/V
    through the page table in place as it goes. `cache` holds the lane's
    `pos` [1] and `page_table` [1, Mp] rows and the shared pools. Returns
    (logits [1, T, V], the cache with pos advanced by T). The caller
    interleaves these steps with decode ticks and makes the chunk's
    attention span resident first (`KVPagePool.ensure`)."""
    _check_supported(cfg)
    per = period(cfg)
    moe_subs = [s for s in range(per) if sub_kind(cfg, s)["moe"]]
    pos0 = cache["pos"]
    page_table = cache["page_table"]
    x = embed_tokens(params, cfg, tokens)
    for g in range(cfg.n_layers // per):
        gp = tree_map(lambda t: t[g], params["blocks"])
        for s in range(per):
            ro = None
            if routing_override is not None and s in moe_subs:
                li = g * len(moe_subs) + moe_subs.index(s)
                ro = (routing_override[0][li], routing_override[1][li])
            entry = cache[f"sub{s}"]
            x = _apply_sublayer_chunk(gp[f"sub{s}"], (entry["kp"][g], entry["vp"][g]), x, pos0,
                                      page_table, cfg, s, ro)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed(params, cfg, x)
    new_cache = dict(cache)
    new_cache["pos"] = pos0 + tokens.shape[1]
    return logits, new_cache
