"""Config-driven transformer for every block kind (port of
`repro/models/transformer.py`: the full-sequence forward, with activation
checkpointing for training (`remat`), `lm_loss`, the ring K/V cache with
recurrent states and cross-attention caches, and the one-token
`decode_step`). Block kinds: attention (+ MoE), hymba's parallel attention
and Mamba branches, xLSTM's mLSTM / sLSTM cells (`models/ssm.py`), jamba's
sublayers whose mixer is attention or Mamba by `attn.layer_pattern` (each
then a dense or MoE FFN; its cache a K/V ring on the attention sublayers
and a Mamba state on the others), nemotron_h's blocks of one mixer each
(Mamba-2, MoE or attention by `attn.layer_pattern`, `x += mixer(norm(x))`;
its cache a Mamba-2 state on the Mamba-2 blocks, a K/V ring on the
attention ones and nothing on the MoE ones), and the encoder-decoder stack
with cross-attention (seamless).

Layers are grouped into repeating periods (Switch's dense/MoE pair, xLSTM's
m/s pair) and each sublayer's params are stacked over the groups, as in the
reference; its `lax.scan` over the stacked groups becomes a Python loop
over the leading group axis of the params and of the cache. `init_paged_cache` and the paged
branch of `decode_step` keep K/V in shared page pools read through a page
table (`core/residency.py`). `verify_step` runs a speculative draft block
and rolls the rejected positions back. `prefill_chunk_step` advances one
paged lane through a prompt chunk (the request server's chunked prefill).
Each of the four takes the reference's `ctx` (`attention.ShardingCtx`) and
passes it to the MoE layers: under expert-parallel serving they dispatch a
shard at a time (`models/moe.py`). The decode attention reads it too: a dry
run's decode context splits the cache's sequence (`decode_seq_axis`). The paged cache and the chunked prefill
take attention-family decoder-only archs, as the reference's do. `forward`
takes a `Telemetry` (`telemetry=`): with spans on, each jamba Mamba mixer is
the span `model.mamba` and each nemotron_h Mamba-2 mixer `model.mamba2`,
timed on the device too (`ssm.device_span`).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.moe import init_moe, moe_decode, moe_layer
from repro_torch.tree import tree_leaves, tree_map, tree_stack, tree_unstack


def _check_unpaged(cfg: ModelConfig) -> None:
    """The paged cache and the chunked prefill hold attention K/V only."""
    if cfg.block_kind != "attn" or cfg.enc_dec:
        raise ValueError("paged K/V supports attention-family decoder-only archs, "
                         f"not {cfg.name} (block_kind {cfg.block_kind!r}, enc_dec {cfg.enc_dec})")


def _lcm(a: int, b: int) -> int:
    return a * b // math.gcd(a, b)


def period(cfg: ModelConfig) -> int:
    p = 1
    if cfg.block_kind in ("attn", "jamba"):
        p = _lcm(p, len(cfg.attn.layer_pattern))
        if cfg.moe.enabled:
            p = _lcm(p, cfg.moe.moe_every)
    elif cfg.block_kind == "xlstm":
        p = _lcm(p, max(1, len(cfg.ssm.xlstm_pattern)))
    elif cfg.block_kind == "nemotron_h":
        p = len(cfg.attn.layer_pattern)
    return p


def sub_kind(cfg: ModelConfig, sub: int) -> Dict[str, Any]:
    """Static description of sublayer `sub` within a period group."""
    if cfg.block_kind == "xlstm":
        pat = cfg.ssm.xlstm_pattern or ("m",)
        return {"kind": "xlstm", "cell": pat[sub % len(pat)]}
    if cfg.block_kind == "hymba":
        return {"kind": "hymba", "moe": False, "window": cfg.attn.window}
    if cfg.block_kind == "nemotron_h":
        mixer = cfg.pattern_at(sub)
        return {"kind": "nemotron_h", "mixer": mixer, "moe": mixer == "moe", "window": 0}
    is_moe = cfg.moe.enabled and (sub % cfg.moe.moe_every == cfg.moe.moe_every - 1)
    if cfg.block_kind == "jamba":
        return {"kind": "jamba", "mixer": cfg.pattern_at(sub), "moe": is_moe, "window": 0}
    return {"kind": "attn", "moe": is_moe, "window": cfg.layer_window(sub)}


def _moe_subs(cfg: ModelConfig):
    return [s for s in range(period(cfg)) if sub_kind(cfg, s).get("moe")]


def n_moe_layers(cfg: ModelConfig) -> int:
    """MoE layers over the whole depth: every `moe_every`-th, or in a
    nemotron_h stack the blocks the pattern names "moe"."""
    if not cfg.moe.enabled:
        return 0
    if cfg.block_kind == "nemotron_h":
        return sum(cfg.pattern_at(layer) == "moe" for layer in range(cfg.n_layers))
    return cfg.n_layers // cfg.moe.moe_every


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _init_sublayer(gen, cfg: ModelConfig, sub: int, device, cross: bool = False) -> dict:
    sk = sub_kind(cfg, sub)
    dtype = getattr(torch, cfg.dtype)
    d = cfg.d_model
    p: dict = {"ln1": init_rmsnorm(d, dtype, device)}
    if sk["kind"] == "xlstm":
        init = ssm_lib.init_mlstm if sk["cell"] == "m" else ssm_lib.init_slstm
        p["mixer"] = init(gen, cfg, device)
        return p
    if sk["kind"] == "nemotron_h":   # the one mixer, no second norm and no FFN
        if sk["mixer"] == "mamba2":
            p["mamba2"] = ssm_lib.init_mamba2(gen, cfg, device)
        elif sk["moe"]:
            p["moe"] = init_moe(gen, cfg, device)
        else:
            p["attn"] = init_attention(gen, cfg, device)
        return p
    if sk.get("mixer") == "mamba":
        p["mamba"] = ssm_lib.init_mamba(gen, cfg, device)
    else:
        p["attn"] = init_attention(gen, cfg, device)
    if sk["kind"] == "hymba":
        p["mamba"] = ssm_lib.init_mamba(gen, cfg, device)
        p["attn_norm"] = init_rmsnorm(d, dtype, device)
        p["mamba_norm"] = init_rmsnorm(d, dtype, device)
    if cross:
        p["lnx"] = init_rmsnorm(d, dtype, device)
        p["xattn"] = init_attention(gen, cfg, device)
    p["ln2"] = init_rmsnorm(d, dtype, device)
    if sk.get("moe"):
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
    gives the same weights for any target device. An encoder-decoder config
    adds the encoder's `enc_blocks` and `enc_norm`, and cross-attention
    (`lnx`, `xattn`) to each decoder sublayer."""
    device = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    per = period(cfg)
    assert cfg.n_layers % per == 0, (cfg.name, cfg.n_layers, per)

    def groups(n, cross):
        return tree_stack([
            {f"sub{s}": _init_sublayer(gen, cfg, s, device, cross) for s in range(per)}
            for _ in range(n // per)
        ])

    blocks = groups(cfg.n_layers, cfg.enc_dec)
    params = {
        "embed": embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype, device),
        "blocks": blocks,
        "final_norm": init_rmsnorm(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["head"] = embed_init(gen, cfg.padded_vocab, cfg.d_model, dtype, device).T.contiguous()
    if cfg.enc_dec:
        params["enc_blocks"] = groups(cfg.n_enc_layers, False)
        params["enc_norm"] = init_rmsnorm(cfg.d_model, dtype, device)
    return params


# ---------------------------------------------------------------------------
# full-sequence forward
# ---------------------------------------------------------------------------


def _hymba_fuse(bp, a, mmb, cfg):
    """hymba's mean of its two branches, each normalised."""
    return 0.5 * (rmsnorm(bp["attn_norm"], a, cfg.norm_eps)
                  + rmsnorm(bp["mamba_norm"], mmb, cfg.norm_eps))


def _mamba2_mixer(p, h, cfg, telemetry=None):
    """A nemotron_h Mamba-2 block's mixer: the span `model.mamba2`, its
    device seconds counter `mamba2_device_s`, its calls `mamba2_calls`."""
    with ssm_lib.device_span(telemetry, "model.mamba2", "mamba2_device_s", h,
                             calls="mamba2_calls"):
        return ssm_lib.mamba2_forward(p, h, cfg, telemetry)


def _nemotron_full(bp, x, cfg, sub, routing_override, collect_kv, ctx, telemetry):
    """A nemotron_h block over the sequence, x + mixer(RMSNorm(x)): (x, aux)
    with the MoE's router outputs, or an attention block's K/V under
    `collect_kv`."""
    aux: dict = {}
    h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
    if "mamba2" in bp:
        y = _mamba2_mixer(bp["mamba2"], h, cfg, telemetry)
    elif "moe" in bp:
        y, moe_aux = moe_layer(bp["moe"], h, cfg, routing_override=routing_override, ctx=ctx)
        aux.update(moe_aux)
    elif collect_kv:
        y, aux["kv"] = attend_full(bp["attn"], h, cfg, sub, return_kv=True)
    else:
        y = attend_full(bp["attn"], h, cfg, sub)
    return x + y, aux


def _mamba_mixer(p, h, cfg, scan_mode: str, telemetry=None):
    """A jamba Mamba sublayer's mixer: the span `model.mamba`, its device
    seconds counter `mamba_device_s`, its calls `mamba_calls`."""
    with ssm_lib.device_span(telemetry, "model.mamba", "mamba_device_s", h, calls="mamba_calls"):
        return ssm_lib.mamba_forward(p, h, cfg, scan_mode, telemetry)


def attention_half(bp, x, cfg, sub, aux: Optional[dict] = None, causal: bool = True,
                   enc_out: Optional[torch.Tensor] = None, scan_mode: str = "assoc",
                   telemetry=None):
    """The attention half of a sublayer: the mixer (attention, beside
    hymba's Mamba branch, or a jamba sublayer's Mamba alone), residual,
    cross-attention over `enc_out` where the sublayer has it, then the
    pre-FFN norm. Returns (x, h) with h the FFN / MoE input; with an `aux`
    dict, an attention sublayer's rope-applied K/V go into aux["kv"]. The
    layerwise baselines call it too, so their router input is the full
    forward's, bit for bit."""
    h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
    if "attn" not in bp:
        a = _mamba_mixer(bp["mamba"], h, cfg, scan_mode, telemetry)
    elif aux is not None:
        # rope-applied K/V, what a decode cache holds at positions 0..S-1
        a, aux["kv"] = attend_full(bp["attn"], h, cfg, sub, causal=causal, return_kv=True)
    else:
        a = attend_full(bp["attn"], h, cfg, sub, causal=causal)
    if "mamba" in bp and "attn" in bp:
        a = _hymba_fuse(bp, a, ssm_lib.mamba_forward(bp["mamba"], h, cfg, scan_mode), cfg)
    if cfg.post_norm:
        a = rmsnorm(bp["ln1_post"], a, cfg.norm_eps)
    x = x + a
    if enc_out is not None and "xattn" in bp:
        hx = rmsnorm(bp["lnx"], x, cfg.norm_eps)
        x = x + attend_full(bp["xattn"], hx, cfg, sub, causal=False, kv_from=enc_out)
    return x, rmsnorm(bp["ln2"], x, cfg.norm_eps)


def _apply_sublayer_full(bp, x, cfg, sub, routing_override, collect_kv, ctx=None,
                         causal: bool = True, enc_out=None, scan_mode: str = "assoc",
                         telemetry=None):
    aux: dict = {}
    sk = sub_kind(cfg, sub)
    if sk["kind"] == "xlstm":
        h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
        fwd = ssm_lib.mlstm_forward if sk["cell"] == "m" else ssm_lib.slstm_forward
        return x + fwd(bp["mixer"], h, cfg, scan_mode), aux
    if sk["kind"] == "nemotron_h":
        return _nemotron_full(bp, x, cfg, sub, routing_override, collect_kv, ctx, telemetry)
    x, h = attention_half(bp, x, cfg, sub, aux if collect_kv else None, causal, enc_out,
                          scan_mode, telemetry)
    if sk["moe"]:
        y, moe_aux = moe_layer(bp["moe"], h, cfg, routing_override=routing_override, ctx=ctx)
        aux.update(moe_aux)
    elif "mlp" in bp:
        y = ffn(bp["mlp"], h, cfg.act, cfg.glu)
    else:
        y = torch.zeros_like(h)
    if cfg.post_norm:
        y = rmsnorm(bp["ln2_post"], y, cfg.norm_eps)
    return x + y, aux


def embed_tokens(params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    # F.embedding, not indexing: its backward sums a repeated token's rows
    # in a fixed order (indexing's accumulating scatter does not on the CPU)
    x = F.embedding(tokens.long(), params["embed"])
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


def _group_full(gp, x, cfg: ModelConfig, ros, collect_kv: bool, ctx=None, causal: bool = True,
                enc_out=None, scan_mode: str = "assoc", telemetry=None):
    """One period group of sublayers: (x, aux_loss, z_loss, router logits
    of its MoE sublayers, {sub: (k, v)})."""
    aux_loss = z_loss = torch.zeros((), dtype=torch.float32, device=x.device)
    router_logits, kv_g = [], {}
    for s in range(period(cfg)):
        x, aux = _apply_sublayer_full(gp[f"sub{s}"], x, cfg, s, ros.get(s), collect_kv, ctx,
                                      causal, enc_out, scan_mode, telemetry)
        if "kv" in aux:
            kv_g[f"sub{s}"] = aux.pop("kv")
        if "aux_loss" in aux:
            aux_loss = aux_loss + aux["aux_loss"]
            z_loss = z_loss + aux["z_loss"]
            router_logits.append(aux["router_logits"])
    return x, aux_loss, z_loss, router_logits, kv_g


def _run_stack(blocks, x, cfg: ModelConfig, causal: bool, enc_out=None, routing_override=None,
               collect_kv: bool = False, remat: bool = False, ctx=None,
               scan_mode: str = "assoc", telemetry=None):
    """Every group of a stacked block tree over x: (x, aux_loss, z_loss,
    router logits [L_moe, ...] as a list, [{sub: (k, v)} a group]). With
    `remat`, each group runs under non-reentrant activation checkpointing
    and is recomputed in the backward (the reference's `jax.checkpoint` of
    its scan body)."""
    moe_subs = _moe_subs(cfg)
    aux_loss = z_loss = torch.zeros((), dtype=torch.float32, device=x.device)
    router_logits, kvs = [], []
    for g, gp in enumerate(tree_unstack(blocks)):
        ros = {}
        if routing_override is not None:
            for j, s in enumerate(moe_subs):
                li = g * len(moe_subs) + j
                ros[s] = (routing_override[0][li], routing_override[1][li])
        args = (gp, x, cfg, ros, collect_kv, ctx, causal, enc_out, scan_mode, telemetry)
        out = checkpoint(_group_full, *args, use_reentrant=False) if remat else _group_full(*args)
        x, al, zl, rl, kv_g = out
        aux_loss, z_loss = aux_loss + al, z_loss + zl
        router_logits += rl
        kvs.append(kv_g)
    return x, aux_loss, z_loss, router_logits, kvs


def _encode(params, cfg: ModelConfig, enc_input: torch.Tensor, scan_mode: str = "assoc",
            remat: bool = False) -> torch.Tensor:
    """The encoder of an encoder-decoder config: its groups over the stub
    frontend's frame embeddings [B, S_enc, d], unmasked, then `enc_norm`."""
    e = enc_input.to(getattr(torch, cfg.dtype))
    e = _run_stack(params["enc_blocks"], e, cfg, causal=False, remat=remat, scan_mode=scan_mode)[0]
    return rmsnorm(params["enc_norm"], e, cfg.norm_eps)


def forward(
    params: dict,
    cfg: ModelConfig,
    tokens: torch.Tensor,                 # [B, S] int (decoder tokens)
    routing_override=None,                # (ids [L_moe,B,S,k], w [L_moe,B,S,k]) or None
    collect_router_logits: bool = False,
    collect_kv: bool = False,
    remat: bool = False,
    ctx=None,                             # attention.ShardingCtx (expert-parallel serving)
    enc_input: Optional[torch.Tensor] = None,   # [B, S_enc, d] stub frontend embeddings
    scan_mode: str = "assoc",             # the recurrences' inner form ("assoc" | "scan")
    telemetry=None,                       # serving.telemetry.Telemetry: jamba's Mamba spans
) -> Dict[str, Any]:
    """Full forward. Returns dict(logits, aux_loss, z_loss, router_logits?,
    kv?); kv is {sub: (k, v)} with each [G, B, S, K, D]. An encoder-decoder
    config needs `enc_input`: the encoder runs first and the decoder's
    cross-attention reads its output. With `remat`, each layer group runs
    under non-reentrant activation checkpointing and is recomputed in the
    backward (the reference's `jax.checkpoint` of its scan body); the values
    and gradients are those without it."""
    enc_out = None
    if cfg.enc_dec:
        if enc_input is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder arch: forward needs enc_input")
        enc_out = _encode(params, cfg, enc_input, scan_mode, remat)
    x = embed_tokens(params, cfg, tokens)
    x, aux_loss, z_loss, router_logits, kvs = _run_stack(
        params["blocks"], x, cfg, causal=True, enc_out=enc_out,
        routing_override=routing_override, collect_kv=collect_kv, remat=remat, ctx=ctx,
        scan_mode=scan_mode, telemetry=telemetry)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    out: Dict[str, Any] = {
        "logits": unembed(params, cfg, x), "aux_loss": aux_loss, "z_loss": z_loss,
    }
    if collect_router_logits:
        out["router_logits"] = torch.stack(router_logits)    # [L_moe, B, S, E]
    if collect_kv:
        out["kv"] = tree_stack(kvs)
    return out


def lm_loss(logits: torch.Tensor, labels: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cross-entropy in fp32; labels [B, S] with -100 = ignore."""
    valid = labels >= 0 if mask is None else mask
    lp = torch.log_softmax(logits.float(), dim=-1)
    ll = torch.gather(lp, -1, labels.clamp(min=0).long()[..., None])[..., 0]
    return -(ll * valid).sum() / torch.clamp(valid.sum(), min=1)


def param_count(params) -> int:
    return sum(t.numel() for t in tree_leaves(params))


# ---------------------------------------------------------------------------
# cache + decode
# ---------------------------------------------------------------------------


def cache_len(cfg: ModelConfig, sub: int, seq_budget: int) -> int:
    w = sub_kind(cfg, sub).get("window", 0)
    return min(seq_budget, w) if w else seq_budget


def _stacked(tree: dict, n_groups: int) -> dict:
    return {k: t.expand(n_groups, *t.shape).clone() for k, t in tree.items()}


def init_cache(cfg: ModelConfig, batch: int, seq_budget: int, device: DeviceLike = None,
               enc_len: int = 0) -> dict:
    """Zeros cache on `device` (CUDA unless asked otherwise). Layout:
    {"pos": [B] int32, "sub{s}": entry}, where an attention sublayer's entry
    holds the ring {"k", "v": [G, B, Sc, K, D]}, a hymba sublayer's also its
    Mamba state {"state": {"h", "conv"}}, a jamba Mamba sublayer's only that
    state, a nemotron_h Mamba-2 block's only its state {"h", "conv"} and a
    nemotron_h MoE block's nothing ({}), an xLSTM cell's only its state
    ({"C", "n", "m"} or {"c", "n", "m"}), each state leaf stacked over the
    G groups; an encoder-decoder config adds {"cross_k", "cross_v": [G, B,
    enc_len, K, D]} to each decoder sublayer (the encoder's K/V, filled by
    the caller) and "cross_len": [B] int32 to the cache."""
    device = resolve_device(device)
    per = period(cfg)
    n_groups = cfg.n_layers // per
    dtype = getattr(torch, cfg.dtype)
    K, D = cfg.n_kv_heads, cfg.hd

    def zeros(S):
        return torch.zeros((n_groups, batch, S, K, D), dtype=dtype, device=device)

    cache: dict = {"pos": torch.zeros((batch,), dtype=torch.int32, device=device)}
    for s in range(per):
        sk = sub_kind(cfg, s)
        state = _init_state(cfg, s, batch, device)
        if sk["kind"] == "xlstm" or sk.get("mixer") in ("mamba", "mamba2"):   # no ring
            cache[f"sub{s}"] = {"state": _stacked(state, n_groups)}
            continue
        if sk["kind"] == "nemotron_h" and sk["moe"]:   # a MoE block caches nothing
            cache[f"sub{s}"] = {}
            continue
        Sc = cache_len(cfg, s, seq_budget)
        entry = {"k": zeros(Sc), "v": zeros(Sc)}
        if state is not None:   # hymba: its Mamba state beside the ring
            entry["state"] = _stacked(state, n_groups)
        if cfg.enc_dec:
            entry["cross_k"], entry["cross_v"] = zeros(enc_len), zeros(enc_len)
        cache[f"sub{s}"] = entry
    if cfg.enc_dec:
        cache["cross_len"] = torch.full((batch,), enc_len, dtype=torch.int32, device=device)
    return cache


def _init_state(cfg: ModelConfig, sub: int, batch: int, device) -> Optional[dict]:
    """Sublayer `sub`'s initial recurrent state for one group (an xLSTM
    cell's, the Mamba mixer's of jamba and hymba, or nemotron_h's Mamba-2
    mixer's), None without one."""
    sk = sub_kind(cfg, sub)
    if sk["kind"] == "xlstm":
        init = ssm_lib.mlstm_init_state if sk["cell"] == "m" else ssm_lib.slstm_init_state
        return init(cfg, batch, device)
    if sk.get("mixer") == "mamba" or sk["kind"] == "hymba":
        return ssm_lib.mamba_init_state(cfg, batch, getattr(torch, cfg.dtype), device)
    if sk.get("mixer") == "mamba2":
        return ssm_lib.mamba2_init_state(cfg, batch, getattr(torch, cfg.dtype), device)
    return None


def reset_cache(cfg: ModelConfig, cache: dict) -> dict:
    """Return a cache from `init_cache` to the values `init_cache` gave it,
    in place: K/V zero, each recurrent state at its initial value, `pos`
    0, `cross_len` the encoder's slots. The decode loop reuses one cache
    across calls this way, and its tensors keep their addresses."""
    pos = cache["pos"]
    pos.zero_()
    for s in range(period(cfg)):
        entry = cache[f"sub{s}"]
        for k, t in entry.items():
            if k != "state":
                t.zero_()
        if "state" in entry:
            init = _init_state(cfg, s, pos.shape[0], pos.device)
            for k, t in entry["state"].items():
                t.copy_(init[k])           # broadcast over the groups
    if "cross_len" in cache:
        cache["cross_len"].fill_(cache["sub0"]["cross_k"].shape[2])
    return cache


def init_paged_cache(cfg: ModelConfig, batch: int, paged, device: DeviceLike = None) -> dict:
    """Zeros paged cache on `device` (CUDA unless asked otherwise). Layout:
    {"pos": [B] int32, "page_table": [B, Mp] int32 (-1 = unallocated),
    "sub{s}": {"kp", "vp": [G, P+1, page, K, D]}}: the pools are shared by
    all lanes and the last page is the trash page. One table serves every
    layer, since all layers cache the same positions. `paged` is a
    `residency.PagedKVConfig`; `KVPagePool` keeps the table. Attention-family
    decoder-only archs only, as the reference's (a ValueError otherwise)."""
    _check_unpaged(cfg)
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


def _write_state(dst: dict, src: dict) -> None:
    for k, t in dst.items():
        t.copy_(src[k])


def _apply_sublayer_decode(bp, ent, x, pos, cfg, sub, routing_override, page_table=None,
                           active=None, ctx=None, cross_len=None):
    """One sublayer for one token. `ent` is the group's views of the
    sublayer's cache entry: its (k, v) ring [B, Sc, K, D] or, with
    `page_table`, its (kp, vp) page pools; its recurrent "state"; its
    cross-attention caches. The K/V and the state are written in place."""
    sk = sub_kind(cfg, sub)
    h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
    if sk["kind"] == "xlstm":
        dec = ssm_lib.mlstm_decode if sk["cell"] == "m" else ssm_lib.slstm_decode
        y, st = dec(bp["mixer"], h, ent["state"], cfg)
        _write_state(ent["state"], st)
        return x + y
    if sk["kind"] == "nemotron_h":
        if "mamba2" in bp:
            y, st = ssm_lib.mamba2_decode(bp["mamba2"], h, ent["state"], cfg)
            _write_state(ent["state"], st)
        elif "moe" in bp:
            y = moe_decode(bp["moe"], h, cfg, routing_override=routing_override, ctx=ctx)
        else:
            y, _, _ = attend_decode(bp["attn"], h, ent["k"], ent["v"], pos, cfg, sub, ctx=ctx)
        return x + y
    if "attn" not in bp:   # a jamba Mamba sublayer
        a, st = ssm_lib.mamba_decode(bp["mamba"], h, ent["state"], cfg)
        _write_state(ent["state"], st)
    elif page_table is not None:
        a, _, _ = attend_decode_paged(bp["attn"], h, ent["kp"], ent["vp"], page_table, pos, cfg,
                                      sub, active=active)
    else:
        a, _, _ = attend_decode(bp["attn"], h, ent["k"], ent["v"], pos, cfg, sub, ctx=ctx)
    if "mamba" in bp and "attn" in bp:
        mmb, st = ssm_lib.mamba_decode(bp["mamba"], h, ent["state"], cfg)
        _write_state(ent["state"], st)
        a = _hymba_fuse(bp, a, mmb, cfg)
    if cfg.post_norm:
        a = rmsnorm(bp["ln1_post"], a, cfg.norm_eps)
    x = x + a
    if "xattn" in bp and cross_len is not None:
        hx = rmsnorm(bp["lnx"], x, cfg.norm_eps)
        ya, _, _ = attend_decode(bp["xattn"], hx, ent["cross_k"], ent["cross_v"], pos, cfg, sub,
                                 cross=True, cross_len=cross_len, ctx=ctx)
        x = x + ya
    h = rmsnorm(bp["ln2"], x, cfg.norm_eps)
    if sk["moe"]:
        y = moe_decode(bp["moe"], h, cfg, routing_override=routing_override, ctx=ctx)
    elif "mlp" in bp:
        y = ffn(bp["mlp"], h, cfg.act, cfg.glu)
    else:
        y = torch.zeros_like(h)
    if cfg.post_norm:
        y = rmsnorm(bp["ln2_post"], y, cfg.norm_eps)
    return x + y


def _group_view(entry, g: int) -> dict:
    """Group g's views of a cache entry's tensors (the state leaves too)."""
    return {k: ({n: t[g] for n, t in v.items()} if isinstance(v, dict) else v[g])
            for k, v in entry.items()}


def decode_step(
    params: dict,
    cache: dict,
    tokens: torch.Tensor,      # [B] int
    cfg: ModelConfig,
    routing_override=None,     # (ids [L_moe,B,k], w [L_moe,B,k]) or None
    active: Optional[torch.Tensor] = None,   # [B] bool; paged: inactive lanes write trash
    ctx=None,
):
    """One serve step: next-token logits [B, V] and the cache. The K/V
    tensors (ring or page pools) and the recurrent states are updated in
    place (see `attention.attend_decode`); the returned dict holds them and
    the advanced `pos`. Cross-attention reads the cache's `cross_k` /
    `cross_v` over its first `cross_len` slots."""
    per = period(cfg)
    moe_subs = _moe_subs(cfg)
    pos = cache["pos"]
    page_table = cache.get("page_table")
    cross_len = cache.get("cross_len")
    x = embed_tokens(params, cfg, tokens)
    for g in range(cfg.n_layers // per):
        gp = tree_map(lambda t: t[g], params["blocks"])
        for s in range(per):
            ro = None
            if routing_override is not None and s in moe_subs:
                li = g * len(moe_subs) + moe_subs.index(s)
                ro = (routing_override[0][li], routing_override[1][li])
            x = _apply_sublayer_decode(gp[f"sub{s}"], _group_view(cache[f"sub{s}"], g), x, pos,
                                       cfg, s, ro, page_table=page_table, active=active, ctx=ctx,
                                       cross_len=cross_len)
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
    ctx=None,
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
    writes the rejected ones back afterwards. Recurrent states (hymba's
    Mamba, the xLSTM cells) keep a copy of every block position's
    post-update state; each lane takes position n_acc - 1's, and a lane
    with n_acc == 0 its pre-block state. `pos` advances by n_acc.

    Returns (out tokens [B, kb] int32, n_acc [B] int32, logits [kb, B, V],
    the cache); the cache's K/V tensors are the ones passed in, updated in
    place."""
    B, kb = tokens.shape
    names = ("kp", "vp") if cache.get("page_table") is not None else ("k", "v")
    subs = [k for k in cache if k.startswith("sub") and names[0] in cache[k]]
    state_subs = [k for k in cache if k.startswith("sub") and "state" in cache[k]]
    if names[0] == "k":
        for skey in subs:
            if cache[skey]["k"].shape[2] < kb:
                raise ValueError(f"draft window {kb} exceeds {skey}'s ring cache "
                                 f"({cache[skey]['k'].shape[2]} slots)")
    pos0 = cache["pos"]
    idx = {skey: _block_index(cache, skey, pos0, kb, active) for skey in subs}
    snap = {(skey, n): cache[skey][n][:, idx[skey][0], idx[skey][1]]    # [G, B, kb, K, D]
            for skey in subs for n in names}

    def states(c):
        return {skey: {n: t.clone() for n, t in c[skey]["state"].items()} for skey in state_subs}

    c, outs, logits, state_snaps = cache, [], [], [states(cache)]
    for i in range(kb):
        ro = None if routing_override is None else (routing_override[0][i],
                                                    routing_override[1][i])
        lg, c = decode_step(params, c, tokens[:, i], cfg, routing_override=ro, active=active,
                            ctx=ctx)
        logits.append(lg)
        outs.append(torch.argmax(lg, dim=-1).to(torch.int32))
        if state_subs:
            state_snaps.append(states(c))
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
    # each lane's state after its n_acc accepted positions (snapshot 0 is
    # the pre-block state, so n_acc == 0 keeps it)
    lanes = torch.arange(B, device=tokens.device)
    for skey in state_subs:
        for n, t in c[skey]["state"].items():
            stk = torch.stack([sn[skey][n] for sn in state_snaps])   # [kb + 1, G, B, ...]
            t.copy_(stk[n_acc.long(), :, lanes].movedim(0, 1))
    new_cache = dict(c)
    new_cache["pos"] = pos0 + n_acc
    return out, n_acc, torch.stack(logits), new_cache


# ---------------------------------------------------------------------------
# chunked prefill: advance one paged lane through a prompt chunk
# ---------------------------------------------------------------------------


def _apply_sublayer_chunk(bp, kv, x, pos0, page_table, cfg, sub, routing_override, ctx=None):
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
        y, _ = moe_layer(bp["moe"], h, cfg, routing_override=routing_override, ctx=ctx)
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
    ctx=None,
):
    """Advance one paged lane through a prompt chunk: the full forward's
    math over [1, T] at absolute positions pos0 .. pos0 + T - 1, writing K/V
    through the page table in place as it goes. `cache` holds the lane's
    `pos` [1] and `page_table` [1, Mp] rows and the shared pools. Returns
    (logits [1, T, V], the cache with pos advanced by T). The caller
    interleaves these steps with decode ticks and makes the chunk's
    attention span resident first (`KVPagePool.ensure`). Attention-family
    decoder-only archs only, as the reference's (a ValueError otherwise)."""
    _check_unpaged(cfg)
    per = period(cfg)
    moe_subs = _moe_subs(cfg)
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
                                      page_table, cfg, s, ro, ctx)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed(params, cfg, x)
    new_cache = dict(cache)
    new_cache["pos"] = pos0 + tokens.shape[1]
    return logits, new_cache
