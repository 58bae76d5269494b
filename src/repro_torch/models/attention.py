"""GQA attention, single device: the full-sequence (prefill) path and the
one-token decode path over a ring K/V cache.

Port of `repro/models/attention.py` without the mesh. On CUDA, `attend_full`
runs the whole sequence through the hand-written `flash_prefill` kernel and
`decode_attention` the token through `flash_decode`; on the CPU they keep the
reference's plain `_attend_chunk` (with `Q_CHUNK` query chunking and
sliding-window banding) and `decode_attention_local`. `attend_decode_paged`
is the same token over a shared page pool read through a page table
(`core/residency.py`): the `flash_decode_paged` kernel on CUDA, the
reference's gather and the plain path on the CPU. `attend_prefill_chunk`
advances one paged lane by a prompt chunk; the reference computes it in
plain `jnp` (no Pallas kernel), so on every device it is the plain
`_attend_chunk` over the gathered pages. The mesh-sharded paths come with
expert parallelism (ROADMAP A14), cross-attention with the encoder-decoder
families (A15).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import apply_rope, dense_init, init_rmsnorm, rmsnorm, softcap

NEG_INF = -1e30
Q_CHUNK = 1024  # query chunking for long prefill on the CPU path


def init_attention(gen, cfg: ModelConfig, device) -> dict:
    d, hd = cfg.d_model, cfg.hd
    nq, nkv = cfg.n_heads, cfg.n_kv_heads
    dtype = getattr(torch, cfg.dtype)
    p = {
        "wq": dense_init(gen, d, nq * hd, dtype, device),
        "wk": dense_init(gen, d, nkv * hd, dtype, device),
        "wv": dense_init(gen, d, nkv * hd, dtype, device),
        "wo": dense_init(gen, nq * hd, d, dtype, device),
    }
    if cfg.attn.qkv_bias:
        p["bq"] = torch.zeros((nq * hd,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((nkv * hd,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((nkv * hd,), dtype=dtype, device=device)
    if cfg.attn.qk_norm:
        p["q_norm"] = init_rmsnorm(hd, dtype, device)
        p["k_norm"] = init_rmsnorm(hd, dtype, device)
    return p


def _project_q(p: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    q = x @ p["wq"]
    if "bq" in p:
        q = q + p["bq"]
    q = q.reshape(*x.shape[:-1], cfg.n_heads, cfg.hd)
    if "q_norm" in p:
        q = rmsnorm(p["q_norm"], q, cfg.norm_eps)
    return q


def _project_kv(p: dict, x: torch.Tensor, cfg: ModelConfig):
    k = x @ p["wk"]
    v = x @ p["wv"]
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    k = k.reshape(*x.shape[:-1], cfg.n_kv_heads, cfg.hd)
    v = v.reshape(*x.shape[:-1], cfg.n_kv_heads, cfg.hd)
    if "k_norm" in p:
        k = rmsnorm(p["k_norm"], k, cfg.norm_eps)
    return k, v


def _attend_chunk(
    q: torch.Tensor,      # [B, Tq, H, D] (rope applied)
    k: torch.Tensor,      # [B, S, K, D]
    v: torch.Tensor,      # [B, S, K, D]
    q_pos: torch.Tensor,  # [Tq]
    k_pos: torch.Tensor,  # [S]
    window: int,
    cap: float,
    causal: bool,
    k_valid: Optional[torch.Tensor] = None,  # [S] extra key validity (paged gather)
) -> torch.Tensor:
    B, Tq, H, D = q.shape
    K = k.shape[2]
    qg = q.reshape(B, Tq, K, H // K, D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) / math.sqrt(D)
    if cap:
        logits = softcap(logits, cap)
    mask = torch.ones((Tq, k_pos.shape[0]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    if k_valid is not None:
        mask &= k_valid[None, :]
    logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w.to(v.dtype), v)   # bf16 rounding point
    return out.reshape(B, Tq, H, D)


def attend_full(
    params: dict,
    x: torch.Tensor,        # [B, S, d]
    cfg: ModelConfig,
    layer: int,
    causal: bool = True,
    return_kv: bool = False,
):
    B, S, _ = x.shape
    window = cfg.layer_window(layer) if causal else 0
    q = _project_q(params, x, cfg)
    k, v = _project_kv(params, x, cfg)
    positions = torch.arange(S, device=x.device)
    q = apply_rope(q, positions, cfg.attn.rope_theta)
    k = apply_rope(k, positions, cfg.attn.rope_theta)

    cap = cfg.attn.logit_softcap
    if x.device.type == "cuda":
        out = ops.flash_prefill(q, k, v, window=window, cap=cap, causal=causal)
    elif S <= Q_CHUNK:
        out = _attend_chunk(q, k, v, positions, positions, window, cap, causal)
    else:
        nchunk = math.ceil(S / Q_CHUNK)
        qp = F.pad(q, (0, 0, 0, 0, 0, nchunk * Q_CHUNK - S))
        # windowed layers slice K/V to the band a chunk can reach
        span = window + Q_CHUNK
        banded = bool(window) and causal and S > span
        outs = []
        for i in range(nchunk):
            qi = qp[:, i * Q_CHUNK:(i + 1) * Q_CHUNK]
            pi = i * Q_CHUNK + torch.arange(Q_CHUNK, device=x.device)
            if banded:
                start = min(max(i * Q_CHUNK + Q_CHUNK - span, 0), S - span)
                kp = start + torch.arange(span, device=x.device)
                outs.append(_attend_chunk(
                    qi, k[:, start:start + span], v[:, start:start + span],
                    pi, kp, window, cap, causal,
                ))
            else:
                outs.append(_attend_chunk(qi, k, v, pi, positions, window, cap, causal))
        out = torch.cat(outs, dim=1)[:, :S]
    y = out.reshape(B, S, cfg.n_heads * cfg.hd) @ params["wo"]
    if return_kv:
        return y, (k, v)
    return y


# ---------------------------------------------------------------------------
# decode attention — one token vs a ring K/V cache
# ---------------------------------------------------------------------------


def decode_attention_local(
    q: torch.Tensor,          # [B, H, D] (rope applied)
    k: torch.Tensor,          # [B, S, K, D]
    v: torch.Tensor,          # [B, S, K, D]
    slot_pos: torch.Tensor,   # [B, S] global position held by each slot (-1 invalid)
    pos: torch.Tensor,        # [B] current decode position
    window: int,
    cap: float,
):
    """Plain path: partial (out·l, l, m), the reference's safe-softmax form."""
    B, H, D = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, D)
    logits = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) / math.sqrt(D)
    if cap:
        logits = softcap(logits, cap)
    valid = (slot_pos >= 0) & (slot_pos <= pos[:, None])
    if window:
        valid &= slot_pos > (pos[:, None] - window)
    logits = torch.where(valid[:, None, None, :], logits, torch.full_like(logits, NEG_INF))
    m = logits.max(dim=-1).values                       # [B,K,G]
    e = torch.exp(logits - m[..., None])
    l = e.sum(dim=-1)                                   # [B,K,G]
    o = torch.einsum("bkgs,bskd->bkgd", e, v.float())
    return o.reshape(B, H, D), l.reshape(B, H), m.reshape(B, H)


def decode_attention(q, k, v, slot_pos, pos, window: int, cap: float) -> torch.Tensor:
    """[B, H, D] attention of one token over the cache, in q's dtype: the
    `flash_decode` kernel on CUDA, the plain path elsewhere."""
    if q.device.type == "cuda":
        return ops.flash_decode(q, k, v, slot_pos, pos, window=window, cap=cap)
    o, l, _ = decode_attention_local(q, k, v, slot_pos, pos, window, cap)
    return (o / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)


def attend_decode(
    params: dict,
    x_tok: torch.Tensor,      # [B, d] current-token activations
    cache_k: torch.Tensor,    # [B, Sc, K, D]
    cache_v: torch.Tensor,
    pos: torch.Tensor,        # [B] int32 decode position
    cfg: ModelConfig,
    layer: int,
):
    """One self-attention decode step. Returns (y [B, d], cache_k, cache_v).

    The new token's K/V go to ring slot `pos % Sc`. Unlike the reference,
    which returns updated copies, the port writes them into `cache_k` /
    `cache_v` in place (`index_put_`) and returns the same tensors: the
    decode loop owns its cache, and a copy of every layer's K/V per token
    would move the whole cache each step. `transformer.verify_step`, which
    needs the pre-block entries for its rollback, snapshots the few it
    overwrites."""
    B = x_tok.shape[0]
    Sc = cache_k.shape[1]
    window = cfg.layer_window(layer)
    q = _project_q(params, x_tok[:, None, :], cfg)                  # [B, 1, H, D]
    q = apply_rope(q, pos[:, None], cfg.attn.rope_theta)[:, 0]
    k_new, v_new = _project_kv(params, x_tok[:, None, :], cfg)
    k_new = apply_rope(k_new, pos[:, None], cfg.attn.rope_theta)
    slot = (pos % Sc).long()
    bidx = torch.arange(B, device=x_tok.device)
    cache_k.index_put_((bidx, slot), k_new[:, 0].to(cache_k.dtype))
    cache_v.index_put_((bidx, slot), v_new[:, 0].to(cache_v.dtype))
    # global position held by each slot s: largest p <= pos with p % Sc == s
    s_idx = torch.arange(Sc, dtype=pos.dtype, device=pos.device)[None, :]
    slot_pos = pos[:, None] - ((pos[:, None] - s_idx) % Sc)
    slot_pos = torch.where(slot_pos >= 0, slot_pos, torch.full_like(slot_pos, -1))
    o = decode_attention(q, cache_k, cache_v, slot_pos, pos, window, cfg.attn.logit_softcap)
    y = o.reshape(B, cfg.n_heads * cfg.hd).to(x_tok.dtype) @ params["wo"]
    return y, cache_k, cache_v


# ---------------------------------------------------------------------------
# paged K/V — decode through a page table
# ---------------------------------------------------------------------------
# The pool layout and its invariants live in core/residency.py: a shared
# [P+1, page, K, D] pool per sublayer (last page = trash), one [B, Mp] page
# table for all layers, pages allocated in position order so that slot j of
# entry i holds position i·page + j. Entry -1 (unallocated or spilled) is
# masked.


def _paged_gather(
    kp: torch.Tensor,          # [P+1, page, K, D] shared pool (trash page last)
    vp: torch.Tensor,
    page_table: torch.Tensor,  # [B, Mp] (-1 invalid)
    last_pos: torch.Tensor,    # [B] highest position a query can reach
    span: int,                 # 0 = every page; else positions reachable back
):
    """The reference's gather through the table -> (k [B, S, K, D], v,
    slot_pos [B, S]). Windowed layers gather only the pages the window can
    reach; full attention gathers the first min(Mp, P) entries (allocation
    is position-ordered and the working set fits the pool, so later entries
    are -1)."""
    B, Mp = page_table.shape
    page = kp.shape[1]
    trash = kp.shape[0] - 1
    dev = page_table.device
    if span:
        Wp = min(Mp, span // page + 2)
        base = torch.clamp(last_pos.long() // page - (Wp - 1), 0, Mp - Wp)
        idx = base[:, None] + torch.arange(Wp, device=dev)[None, :]       # [B, Wp]
        pt = torch.gather(page_table, 1, idx)
    else:
        Wp = min(Mp, trash)
        idx = torch.arange(Wp, device=dev)[None, :].expand(B, Wp)
        pt = page_table[:, :Wp]
    ptl = torch.where(pt >= 0, pt, torch.full_like(pt, trash)).long()
    kg, vg = kp[ptl], vp[ptl]                                            # [B, Wp, page, K, D]
    spos = idx[:, :, None] * page + torch.arange(page, device=dev)[None, None, :]
    slot_pos = torch.where((pt >= 0)[:, :, None], spos, torch.full_like(spos, -1))
    slot_pos = slot_pos.reshape(B, -1).to(torch.int32)
    S = slot_pos.shape[1]
    return (kg.reshape(B, S, kp.shape[2], kp.shape[3]),
            vg.reshape(B, S, vp.shape[2], vp.shape[3]), slot_pos)


def attend_decode_paged(
    params: dict,
    x_tok: torch.Tensor,        # [B, d] current-token activations
    kp: torch.Tensor,           # [P+1, page, K, D] shared page pool
    vp: torch.Tensor,
    page_table: torch.Tensor,   # [B, Mp] int32
    pos: torch.Tensor,          # [B] int32 decode position
    cfg: ModelConfig,
    layer: int,
    active: Optional[torch.Tensor] = None,  # [B] bool; inactive lanes write trash
):
    """One paged decode step. Returns (y [B, d], kp, vp), the pools written
    in place.

    The new token's K/V land at (page_table[b, pos // page], pos % page).
    A position past the table, an unallocated entry or an inactive lane is
    routed to the trash page explicitly; nothing relies on index clamping.
    On CUDA the read is `ops.flash_decode_paged` straight over the pool and
    the table; on the CPU it is the reference's gather, then the plain
    `decode_attention`. The two agree for every lane with a valid key."""
    B = x_tok.shape[0]
    page = kp.shape[1]
    trash = kp.shape[0] - 1
    Mp = page_table.shape[1]
    window = cfg.layer_window(layer)
    q = _project_q(params, x_tok[:, None, :], cfg)                  # [B, 1, H, D]
    q = apply_rope(q, pos[:, None], cfg.attn.rope_theta)[:, 0]
    k_new, v_new = _project_kv(params, x_tok[:, None, :], cfg)
    k_new = apply_rope(k_new, pos[:, None], cfg.attn.rope_theta)
    pidx = (pos // page).long()
    in_table = (pidx >= 0) & (pidx < Mp)
    pid = torch.gather(page_table, 1, torch.where(in_table, pidx, 0)[:, None])[:, 0].long()
    ok = in_table & (pid >= 0)
    if active is not None:
        ok &= active
    pid = torch.where(ok, pid, torch.full_like(pid, trash))
    off = (pos % page).long()
    kp.index_put_((pid, off), k_new[:, 0].to(kp.dtype))
    vp.index_put_((pid, off), v_new[:, 0].to(vp.dtype))
    cap = cfg.attn.logit_softcap
    if q.device.type == "cuda":
        o = ops.flash_decode_paged(q.contiguous(), kp, vp, page_table, pos, window=window, cap=cap)
    else:
        kg, vg, slot_pos = _paged_gather(kp, vp, page_table, pos, window)
        o = decode_attention(q, kg, vg, slot_pos, pos, window, cap)
    y = o.reshape(B, cfg.n_heads * cfg.hd).to(x_tok.dtype) @ params["wo"]
    return y, kp, vp


def attend_prefill_chunk(
    params: dict,
    x: torch.Tensor,            # [1, T, d] one lane's prompt chunk
    kp: torch.Tensor,           # [P+1, page, K, D] shared page pool
    vp: torch.Tensor,
    page_table: torch.Tensor,   # [1, Mp] the lane's table row
    pos0: torch.Tensor,         # [1] the chunk's first position
    cfg: ModelConfig,
    layer: int,
):
    """Chunked-prefill attention for one paged lane. Returns (y [1, T, d],
    kp, vp), the pools written in place.

    The chunk's K/V land at their absolute positions through the table
    (allocation is position-ordered, so no two positions share a (page,
    offset)); then its queries attend causally over the gathered pages.
    When `max_seq` is not a multiple of the chunk, the last chunk's pad
    tail reaches past the table: those positions, and unallocated entries,
    are routed to the trash page explicitly (an out-of-range index raises
    in torch where JAX clamps). Spilled out-of-window pages show up as -1
    entries and are masked through `k_valid`; windowed layers gather only
    the `window + T` positions the chunk can reach."""
    B, T, _ = x.shape
    page = kp.shape[1]
    trash = kp.shape[0] - 1
    Mp = page_table.shape[1]
    window = cfg.layer_window(layer)
    theta = cfg.attn.rope_theta
    q_pos = pos0.long()[:, None] + torch.arange(T, device=x.device)[None, :]   # [1, T]
    q = apply_rope(_project_q(params, x, cfg), q_pos, theta)
    k_new, v_new = _project_kv(params, x, cfg)
    k_new = apply_rope(k_new, q_pos, theta)
    p = q_pos[0]                                                             # [T]
    pidx = p // page
    in_table = pidx < Mp
    pid = page_table[0][torch.where(in_table, pidx, torch.zeros_like(pidx))].long()
    pid = torch.where(in_table & (pid >= 0), pid, torch.full_like(pid, trash))
    off = p % page
    kp.index_put_((pid, off), k_new[0].to(kp.dtype))
    vp.index_put_((pid, off), v_new[0].to(vp.dtype))
    span = window + T if window else 0
    kg, vg, slot_pos = _paged_gather(kp, vp, page_table, pos0 + T - 1, span)
    out = _attend_chunk(q, kg, vg, p, slot_pos[0], window, cfg.attn.logit_softcap,
                        causal=True, k_valid=slot_pos[0] >= 0)
    y = out.reshape(B, T, cfg.n_heads * cfg.hd).to(x.dtype) @ params["wo"]
    return y, kp, vp
