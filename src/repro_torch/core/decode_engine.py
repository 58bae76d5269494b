"""Autoregressive decode serving with incremental hash prediction (port of
the synchronous path of `repro/core/decode_engine.py`).

Per decode step:
  1. `hash_fn_step` advances the predictor's LSTM state on the previous
     token's embedding and emits expert ids + α for every MoE layer —
     before the model runs, keeping the look-ahead property;
  2. the ExpertStore loads any missing experts (consecutive tokens reuse
     experts heavily, so steady-state steps are mostly cache hits);
  3. `translate_device` turns the still-resident prediction into slot ids
     and renormalised weights on the device;
  4. `decode_step` runs with that routing override (routers offloaded) over
     the ring K/V cache, or with `generate(paged=...)` over a shared K/V
     page pool whose pages a `KVPagePool` allocates, spills and pages back
     in before each step.

With a prefetch pipeline (`prefetch_depth`) step 2 becomes a ticket: the
step's table is submitted to the transfer thread, its fences cleared (the
wait is `DecodeMetrics.stall_s`), and the ticket released once the step's
token is on the host; a paged pool's page-ins ride the same pipeline.

The store may split its slots into hot int8 and warm int4 tiers
(`tier=TierConfig(int4_slots=True)` with `quantized_slots=True`). The
SparseMax attention over LSTM outputs is kept exactly, over a ring of the
last `HISTORY` outputs; it goes through `kernels.ops.sparsemax`, the
hand-written kernel on the card.

Speculative decode (`spec_mode="draft"`, `spec_k=K > 1`): the predictor's
tied-embedding draft head proposes K - 1 tokens after the last accepted one
(`draft_unroll_fn`), the union of the K positions' predicted experts is
loaded as one ticket, `transformer.verify_step` runs the K positions and
rolls the rejected ones back, and each lane keeps its accepted prefix.
Expert-parallel shards (ROADMAP A14) are not ported yet and raise.
"""
from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hash_fn import draft_logits_from_state
from repro_torch.core.hash_table import HashTable
from repro_torch.core.offload import ExpertStore, PrefetchPipeline
from repro_torch.core.residency import KVPagePool
from repro_torch.device import DeviceLike
from repro_torch.kernels import ops
from repro_torch.models.layers import top_k
from repro_torch.models.transformer import decode_step, init_cache, n_moe_layers, verify_step
from repro_torch.tree import tree_map

HISTORY = 128  # SparseMax attention ring length


# ---------------------------------------------------------------------------
# incremental hash function
# ---------------------------------------------------------------------------


def hash_state_init(params: dict, batch: int) -> dict:
    """Zero predictor state on the params' device."""
    d_h = params["attn_q"].shape[0]
    dev = params["attn_q"].device
    z = lambda: torch.zeros((batch, d_h), dtype=torch.float32, device=dev)
    return {
        "h1": z(), "c1": z(), "h2": z(), "c2": z(),
        "ring": torch.zeros((batch, HISTORY, d_h), dtype=torch.float32, device=dev),
        # per-lane step counter, as the reference keeps it
        "t": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def _lstm_cell(p, x, h, c):
    g = x @ p["wx"] + h @ p["wh"] + p["b"]
    i, f, gg, o = g.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
    h = torch.sigmoid(o) * torch.tanh(c)
    return h, c


def hash_fn_step(params: dict, emb_tok: torch.Tensor, state: dict, num_experts: int,
                 embed_table: Optional[torch.Tensor] = None):
    """One-token advance. emb_tok: [B, d_model] -> (logits [B, L, E], new
    state). The state passed in is left as it was, so a caller may keep
    every state it was handed (the draft unroll stacks them).

    With `embed_table` and a draft head in `params`, returns (logits, draft
    logits [B, V], new state): the speculative loop reads both heads off
    one predictor pass."""
    E = num_experts
    L = params["heads"].shape[-1] // E
    x = torch.tanh(emb_tok.float() @ params["compress"])
    h1, c1 = _lstm_cell(params["lstm1"], x, state["h1"], state["c1"])
    h2, c2 = _lstm_cell(params["lstm2"], h1, state["h2"], state["c2"])
    t = state["t"]                                          # [B] per-lane step
    bidx = torch.arange(h2.shape[0], device=h2.device)
    ring = state["ring"].index_put((bidx, (t % HISTORY).long()), h2)
    # sparse attention of the current query over the ring (the full-sequence
    # predictor's math while t < HISTORY)
    q = h2 @ params["attn_q"]
    scores = torch.einsum("bd,bkd->bk", q, ring) / math.sqrt(h2.shape[-1])
    valid = torch.arange(HISTORY, device=h2.device)[None, :] <= t[:, None]
    scores = torch.where(valid, scores, torch.full_like(scores, -1e30))
    w = ops.sparsemax(scores.contiguous())
    a = torch.einsum("bk,bkd->bd", w, ring)
    z = a + h2
    logits = (z @ params["heads"]).reshape(-1, L, E)
    new_state = {"h1": h1, "c1": c1, "h2": h2, "c2": c2, "ring": ring, "t": t + 1}
    if embed_table is not None and "draft_proj" in params:
        return logits, draft_logits_from_state(params, z, embed_table), new_state
    return logits, new_state


# ---------------------------------------------------------------------------
# speculative draft unroll
# ---------------------------------------------------------------------------


def draft_unroll_fn(num_experts: int, top_k_: int, K: int) -> Callable:
    """The K-step draft unroll, as the reference builds it: from the last
    accepted token, advance the predictor K times, reading both heads off
    each state (the router heads for the position's expert ids and α, the
    draft head for the next, greedy, draft token), and stack the states the
    accept/reject bookkeeping rolls back to.

    The returned `unroll(hp, embed_table, tokens, hstate, active=None)`
    gives (inputs [B, K], ids [L, B, K, k] int32, α [L, B, K, k] fp32,
    states stacked [K, B, ...]); `active` [B] zeroes inactive lanes' α."""

    def unroll(hp, embed_table, tokens, hstate, active=None):
        toks, ids_l, alpha_l, states = [], [], [], []
        tok, st = tokens, hstate
        for _ in range(K):
            emb = embed_table[tok.long()]
            logits, dlog, st = hash_fn_step(hp, emb, st, num_experts, embed_table)
            vals, ids = top_k(logits, top_k_)                 # [B, L, k]
            alpha = torch.softmax(vals, dim=-1)
            if active is not None:
                alpha = alpha * active[:, None, None]
            toks.append(tok)
            ids_l.append(ids.movedim(1, 0).to(torch.int32))  # [L, B, k]
            alpha_l.append(alpha.movedim(1, 0).float())
            states.append(st)
            tok = torch.argmax(dlog, dim=-1).to(torch.int32)
        stacked = {name: torch.stack([s[name] for s in states]) for name in states[0]}
        return (torch.stack(toks, dim=1), torch.stack(ids_l, dim=2).contiguous(),
                torch.stack(alpha_l, dim=2).contiguous(), stacked)

    return unroll


def select_accepted_state(states: dict, n_acc: torch.Tensor, old: Optional[dict] = None) -> dict:
    """Per-lane predictor rollback: from the unroll's stacked states ([K, B,
    ...] leaves) each lane's state after its last accepted input (stack
    index n_acc - 1). With `old`, a lane that accepted nothing (n_acc == 0,
    an inactive lane) keeps its old state."""
    idx = torch.clamp(n_acc.long() - 1, min=0)
    bidx = torch.arange(n_acc.shape[0], device=n_acc.device)
    out = {}
    for name, stk in states.items():
        chosen = stk[idx, bidx]
        if old is not None:
            keep = (n_acc > 0).reshape(-1, *([1] * (chosen.dim() - 1)))
            chosen = torch.where(keep, chosen, old[name])
        out[name] = chosen
    return out


# ---------------------------------------------------------------------------
# decode engine
# ---------------------------------------------------------------------------


@dataclass
class DecodeMetrics:
    """Decode accounting, as the reference keeps it. `steps` counts verify
    blocks (one token a lane without speculation), `tokens` the tokens
    emitted, `proposed` the positions verified (B·K a speculative block), so
    `acceptance_rate` is 1.0 without speculation. `loads_per_step` has one
    entry a block (its superset ticket loads once), `accepted_per_step` the
    block's delivered tokens a lane, and `stall_s` is the time spent
    clearing prefetch tickets (0 on the synchronous path)."""

    steps: int = 0
    tokens: int = 0
    proposed: int = 0
    wall_s: float = 0.0
    stall_s: float = 0.0
    loads_per_step: List[int] = field(default_factory=list)
    accepted_per_step: List[float] = field(default_factory=list)

    @property
    def tok_s(self) -> float:
        return self.tokens / self.wall_s if self.wall_s else 0.0

    @property
    def acceptance_rate(self) -> float:
        return self.tokens / self.proposed if self.proposed else 0.0

    @property
    def mean_accepted(self) -> float:
        xs = self.accepted_per_step
        return float(np.mean(xs)) if xs else 0.0


def ids_alpha_to_host(ids: torch.Tensor, alpha: torch.Tensor):
    """int32 ids and fp32 α of one shape to numpy in one copy (α's bits ride
    as int32)."""
    both = torch.stack([ids, alpha.view(torch.int32)]).cpu().numpy()
    return both[0], both[1].view(np.float32)


class TableBuffer:
    """Reusable host backing store for the per-step decode HashTables: one
    persistent pair of [L, B, S, k] arrays that each step's prediction is
    copied into, so the only per-step host work is that copy."""

    def __init__(self, L: int, B: int, S: int, k: int):
        self.ids = np.zeros((L, B, S, k), np.int32)
        self.weights = np.zeros((L, B, S, k), np.float32)
        self.table = HashTable(0, self.ids, self.weights)

    def fill(self, batch_index: int, ids_dev: torch.Tensor, alpha_dev: torch.Tensor) -> HashTable:
        """ids int32 / alpha fp32 tensors, [L, B, k] (one position a lane)
        or [L, B, S, k] (a speculative block's S positions). Both come to
        the host in one copy: alpha's bits ride as int32."""
        self.table.batch_index = batch_index
        ids, alpha = ids_alpha_to_host(ids_dev, alpha_dev)
        if ids_dev.dim() == 3:
            ids, alpha = ids[:, :, None, :], alpha[:, :, None, :]
        np.copyto(self.ids, ids)
        np.copyto(self.weights, alpha)
        return self.table


class SiDADecodeEngine:
    """Token-by-token generation under an expert memory budget.

    Runs on CUDA unless `device` names another device; without a GPU the
    default raises instead of falling back to the CPU."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        hash_params: dict,
        slots_per_layer: int,
        serve_top_k: Optional[int] = None,
        host_quant: str = "none",
        eviction: str = "fifo",
        prefetch_depth: Optional[int] = None,
        staging_buffers: Optional[int] = None,
        prefetcher: Optional[PrefetchPipeline] = None,
        quantized_slots: Optional[bool] = None,
        scale_granularity: Optional[str] = None,
        tier=None,
        spec_mode: Optional[str] = None,   # "off" | "draft"; None => cfg.spec
        spec_k: Optional[int] = None,
        sharded=None,
        device: DeviceLike = None,
    ):
        mode = spec_mode if spec_mode is not None else cfg.spec.mode
        if mode not in ("off", "draft"):
            raise ValueError(f"unknown spec_mode {mode!r}")
        self.spec_k = spec_k if spec_k is not None else cfg.spec.k
        self.spec = mode == "draft" and self.spec_k > 1
        if self.spec and "draft_proj" not in hash_params:
            raise ValueError("spec_mode='draft' needs a hash function with a draft head "
                             "(init_hash_fn(draft=True) or init_draft_head)")
        if sharded is not None:
            raise NotImplementedError("expert-parallel shards are ported in ROADMAP A14")
        self.cfg = cfg
        self.k = serve_top_k or cfg.moe.top_k
        self.store = ExpertStore(
            cfg, params, slots_per_layer, eviction=eviction, device=device,
            host_quant=host_quant, quantized_slots=quantized_slots,
            scale_granularity=scale_granularity, tier=tier,
        )
        self.device = self.store.device
        # the reference's precedence: explicit depth > cfg.prefetch > off; a
        # caller's pipeline is shared as it is
        self._owns_prefetcher = False
        if prefetcher is not None:
            self.prefetcher: Optional[PrefetchPipeline] = prefetcher
        else:
            self.prefetcher = PrefetchPipeline.maybe_create(
                self.store, cfg, prefetch_depth, staging_buffers)
            self._owns_prefetcher = self.prefetcher is not None
        self.hash_params = tree_map(lambda x: x.to(self.device), hash_params)
        self.embed_table = self.store.serve_params["embed"]
        self.L = n_moe_layers(cfg)
        self.E = cfg.moe.num_experts
        self.kv_pool: Optional[KVPagePool] = None   # the last paged generate's pool
        self._draft_unroll = draft_unroll_fn(self.E, self.k, self.spec_k)

    # ------------------------------------------------------------------
    def _predict_step(self, tokens: torch.Tensor, hstate: dict):
        """(ids [L, B, k] int32, α [L, B, k] fp32, new state), on the device."""
        emb = self.embed_table[tokens.long()]
        logits, hstate = hash_fn_step(self.hash_params, emb, hstate, self.E)
        vals, ids = top_k(logits, self.k)                  # [B, L, k]
        alpha = torch.softmax(vals, dim=-1)
        return (ids.movedim(1, 0).to(torch.int32).contiguous(),
                alpha.movedim(1, 0).float().contiguous(), hstate)

    def _step(self, cache: dict, tokens: torch.Tensor, slot_ids, w):
        logits, cache = decode_step(
            self.store.serve_params, cache, tokens, self.cfg, routing_override=(slot_ids, w),
        )
        return torch.argmax(logits, dim=-1).to(torch.int32), cache

    def _verify(self, cache: dict, tokens_blk: torch.Tensor, slot_ids, w):
        """One speculative block through `verify_step`: (out [B, K], n_acc
        [B], the next block's first token [B], cache). The next block starts
        from each lane's last accepted model token."""
        out, n_acc, _, cache = verify_step(
            self.store.serve_params, cache, tokens_blk, self.cfg, routing_override=(slot_ids, w),
        )
        nxt = torch.gather(out, 1, (n_acc.long() - 1)[:, None])[:, 0]
        return out, n_acc, nxt, cache

    def _route_table(self, table: HashTable, m: DecodeMetrics):
        """Residency for one decode table: an async ticket (fences only) or a
        synchronous prepare. Returns (trans, ticket); the loads and the stall
        are attributed to the current step in `m`, and the caller releases
        a non-None ticket after the step."""
        loads_before = self.store.stats.loads
        if self.prefetcher is not None:
            stall0 = self.prefetcher.stats.stall_s
            ticket = self.prefetcher.submit(table)
            ticket.wait()
            m.stall_s += self.prefetcher.stats.stall_s - stall0
            trans = ticket.trans
        else:
            ticket = None
            trans = self.store.prepare(table)
        m.loads_per_step.append(self.store.stats.loads - loads_before)
        return trans, ticket

    def _make_cache(self, B: int, cache_len: int, paged):
        """A ring cache, or with a `residency.PagedKVConfig` a paged cache and
        the `KVPagePool` that keeps its table (α-mass page eviction). The
        pool shares the engine's prefetch pipeline, so page-ins ride the
        same transfer queue as expert uploads."""
        if paged is None:
            return init_cache(self.cfg, B, cache_len, device=self.device), None
        pool = KVPagePool(self.cfg, paged, B, eviction="alpha", pipeline=self.prefetcher,
                          device=self.device)
        return pool.init_cache(), pool

    @staticmethod
    def _page_tick(pool: KVPagePool, cache: dict, upto: np.ndarray, extra_span: int = 0) -> dict:
        """Before a step: make each lane's positions resident up to `upto[b]`
        (allocating, or paging spilled in-span pages back in), pinning them
        so one lane's allocation cannot evict a page another lane reads;
        clear the page-in fences; then install the table. The caller
        unpins after the step. `extra_span` widens the pinned span for a
        multi-position block (see `KVPagePool.ensure`)."""
        for b in range(upto.shape[0]):
            cache = pool.ensure(cache, b, int(upto[b]), pin=True, extra_span=extra_span)
        cache = pool.sync(cache)
        cache["page_table"] = pool.device_table()
        return cache

    @torch.inference_mode()
    def generate(
        self,
        prompt_last_tokens: np.ndarray,
        steps: int,
        cache_len: int = 256,
        paged=None,   # residency.PagedKVConfig => K/V in a shared page pool
    ) -> Tuple[np.ndarray, DecodeMetrics]:
        """Greedy-decode `steps` tokens for a batch, starting from the given
        current tokens with a fresh ring cache of `cache_len` slots, or a
        fresh paged cache. Each step: make the pages resident (paged),
        predict, copy ids/α to the host (the one D2H of the prediction),
        prepare the slots, translate on the device, run the step, copy the
        token to the host.

        With speculation (spec_mode="draft", spec_k > 1) each iteration
        verifies a K-token draft block instead (`_generate_spec`); while
        every predicted expert is resident its tokens are the ones this
        loop emits."""
        if self.spec:
            return self._generate_spec(prompt_last_tokens, steps, cache_len, paged)
        B = prompt_last_tokens.shape[0]
        cache, pool = self._make_cache(B, cache_len, paged)
        hstate = hash_state_init(self.hash_params, B)
        tokens = torch.as_tensor(np.asarray(prompt_last_tokens), dtype=torch.int32,
                                 device=self.device)
        out = np.zeros((B, steps), np.int32)
        m = DecodeMetrics()
        tbuf = TableBuffer(self.L, B, 1, self.k)
        t0 = time.perf_counter()
        for i in range(steps):
            if pool is not None:
                cache = self._page_tick(pool, cache, np.full((B,), i + 1, np.int64))
            ids, alpha, hstate = self._predict_step(tokens, hstate)
            table = tbuf.fill(i, ids, alpha)
            trans, ticket = self._route_table(table, m)
            # translation runs on the device straight off the still-resident
            # prediction (no per-step host slot gather or override upload)
            slot_ids, w = self.store.translate_device(ids[:, :, None, :], alpha[:, :, None, :],
                                                      trans)
            tokens, cache = self._step(cache, tokens, slot_ids[:, :, 0, :], w[:, :, 0, :])
            out[:, i] = tokens.cpu().numpy()   # forces the step; slots consumed
            if pool is not None:
                pool.unpin_all()               # pinned by _page_tick
            if ticket is not None:
                ticket.release()
            m.steps += 1
            m.tokens += B                      # every position emitted == accepted
            m.proposed += B
            m.accepted_per_step.append(1.0)
        m.wall_s = time.perf_counter() - t0
        self.kv_pool = pool
        return out, m

    @torch.inference_mode()
    def _generate_spec(self, prompt_last_tokens: np.ndarray, steps: int, cache_len: int,
                       paged=None) -> Tuple[np.ndarray, DecodeMetrics]:
        """Speculative decode, as the reference's: draft K tokens off the
        predictor's draft head, route the union of the K positions' predicted
        experts as one ticket (a superset of each position's), verify the
        block in one `verify_step`, and keep each lane's accepted prefix.
        Lanes advance at different rates; the loop ends when every lane has
        emitted `steps` tokens."""
        B = prompt_last_tokens.shape[0]
        K = self.spec_k
        cache, pool = self._make_cache(B, cache_len, paged)
        seq_len = pool.paged.seq_len if pool is not None else cache_len
        if K > seq_len:
            raise ValueError(f"spec_k {K} exceeds the cache's {seq_len} positions")
        hstate = hash_state_init(self.hash_params, B)
        tokens = torch.as_tensor(np.asarray(prompt_last_tokens), dtype=torch.int32,
                                 device=self.device)
        out = np.zeros((B, steps), np.int32)
        filled = np.zeros((B,), np.int64)
        pos_np = np.zeros((B,), np.int64)   # per-lane cache position (paged)
        m = DecodeMetrics()
        tbuf = TableBuffer(self.L, B, K, self.k)
        t0 = time.perf_counter()
        while filled.min() < steps:
            if pool is not None:
                # verify writes the whole block before acceptance is known,
                # and the pinned pages keep eviction off the rollback. A lane
                # near the edge drafts past the addressable range: its
                # overflow writes go to the trash page and the loop stops
                # before accepting them
                cache = self._page_tick(pool, cache, np.minimum(pos_np + K, seq_len),
                                        extra_span=K - 1)
            inputs, ids, alpha, states = self._draft_unroll(
                self.hash_params, self.embed_table, tokens, hstate)
            table = tbuf.fill(m.steps, ids, alpha)
            trans, ticket = self._route_table(table, m)
            slot_ids, w = self.store.translate_device(ids, alpha, trans)
            out_blk, n_acc, tokens, cache = self._verify(
                cache, inputs, slot_ids.movedim(2, 0), w.movedim(2, 0))
            hstate = select_accepted_state(states, n_acc)
            both = torch.cat([out_blk, n_acc[:, None]], dim=1).cpu().numpy()
            out_np, n_np = both[:, :K], both[:, K]   # forces the block; slots consumed
            if pool is not None:
                pool.unpin_all()
                pos_np += n_np
            if ticket is not None:
                ticket.release()
            delivered = 0
            for b in range(B):
                take = int(min(n_np[b], steps - filled[b]))
                out[b, filled[b]:filled[b] + take] = out_np[b, :take]
                filled[b] += take
                delivered += take
            m.tokens += delivered
            # delivered, not n_acc: a lane that reaches `steps` mid-block
            # drops the tail of its accepted prefix
            m.accepted_per_step.append(delivered / B)
            m.proposed += B * K
            m.steps += 1
        m.wall_s = time.perf_counter() - t0
        self.kv_pool = pool
        return out, m

    def close(self) -> None:
        """Join the prefetch transfer thread (nothing to do when synchronous,
        or when the pipeline belongs to the caller)."""
        if self.prefetcher is not None and self._owns_prefetcher:
            self.prefetcher.close()
