"""Request server: continuous batching over the SiDA hash-ahead pipeline
(port of `repro/serving/server.py`).

Wiring (one shared `ExpertStore` under everything):

    arrival stream ──> hash-ahead thread ──> admission queue (Scheduler)
                        (build_table per           │ EDF + cache-affinity
                         request, off the          ▼
                         critical path)      prefill batches (length-bucketed)
                                                   │ SiDAEngine.prefill
                                                   │ (logits + rope'd K/V)
                                                   ▼
                                             decode lanes (continuous batch)
                                                   │ per-step hash predict,
                                                   │ ExpertStore prepare,
                                                   ▼ masked decode_step
                                             token streams -> Request.emit

Requests join a decode lane the moment their prefill finishes (the prefill
forward's K/V seeds the lane's cache, no replay) and leave the moment they
finish. With `prefetch_depth > 0` the hash-ahead thread is also the
prefetch producer (a fire-and-forget warming submit per admitted request),
and prefill, decode ticks and chunks go through tickets. With
`spec_mode="draft"` a tick drafts `spec_k` tokens a lane off the
predictor's draft head, loads the union of the block's predicted experts as
one ticket, and verifies the block in one `verify_step`. A paged server
(`paged=PagedKVConfig(...)`) keeps K/V in a shared page pool and streams
prompts longer than the largest bucket through it in `prefill_chunk`-token
chunks between decode ticks.

With tenants (`ServingConfig.tenants`) the flat queue becomes weighted fair
queueing over per-tenant queues (`WFQScheduler`), the shed gate splits per
tenant (`TenantAdmission`), each tenant's pin quota is registered with the
store, and every request's metrics also land in its tenant's telemetry
partition (`tenant_summary`). Without tenants the server keeps the
single-tenant objects. A `FaultPlan` (`faults=`) injects failures into the
prefetch pipeline and the hash-ahead admission; the serve loop runs the
pipeline's `watchdog` every `watchdog_interval_s`.

Expert parallelism (`ServingConfig.parallel.sharded`, `ep_shards` > 1): the
one shared store's slot pools split into shards (with `replicate_hot`, hot
experts copied onto other shards), prefill, decode ticks, chunks and
verify blocks run the expert-parallel dispatch (`sharding/policy.py::store_ctx`,
or the `ctx` given), the prefetch pipeline fans tickets out to per-shard
transfer queues, and every `rebalance_interval` seconds the serve loop
re-homes experts from the α EMA (`ExpertStore.rebalance_homes`; the moves
ride the transfer queues). One process drives every shard, all on the
store's device.

The reference's `@jax.jit` closures are plain methods on tensors here:
`_hash_prefill`, `_predict_masked`, `_decode_masked`, `_seed_lanes`,
`_seed_lanes_paged`, `_chunk_step` and `_verify_masked`. What differs:

* **K/V written in place.** The port's decode writes each lane's new K/V
  into the cache in place. A ring lane that is masked out of a tick (a free
  lane) writes at its stale position instead of being merged back; no query
  reads that slot before it is rewritten, because a lane is only reused
  after `_seed_lanes` installs its new prompt and position, and a ring
  slot past a lane's position is invalid to its queries until that
  position's own decode writes it. Paged lanes that are masked out write
  to the trash page, as in the reference. A masked lane's `pos` and
  predictor state never move.
* **The predictor's prompt pass** is `hash_fn_prefill`, the LSTM state and
  ring alone; the reference's `lax.scan` of the full step leaves XLA to
  drop the attention and heads whose outputs nothing reads.
Runs on CUDA unless `device` names another device.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.decode_engine import (
    draft_unroll_fn,
    hash_fn_prefill,
    hash_fn_step,
    hash_state_init,
    ids_alpha_to_host,
    select_accepted_state,
)
from repro_torch.core.engine import SiDAEngine
from repro_torch.core.hash_table import HashTable
from repro_torch.core.offload import ExpertStore, PrefetchPipeline
from repro_torch.core.residency import KVPagePool, ResidencyManager
from repro_torch.models.layers import top_k
from repro_torch.sharding.policy import store_ctx
from repro_torch.models.transformer import (
    decode_step,
    init_cache,
    n_moe_layers,
    prefill_chunk_step,
    verify_step,
)
from repro_torch.serving.config import ServingConfig
from repro_torch.serving.request import Request, RequestState
from repro_torch.serving.scheduler import LaneTable, Scheduler, TenantAdmission, WFQScheduler
from repro_torch.serving.telemetry import Telemetry


def _mask_state(active: torch.Tensor, new: dict, old: dict) -> dict:
    """Per lane, `new` where `active` else `old`, over a predictor state
    whose leaves carry the lanes on axis 0."""
    out = {}
    for name, nw in new.items():
        keep = active.reshape(-1, *([1] * (nw.dim() - 1)))
        out[name] = torch.where(keep, nw, old[name])
    return out


class RequestServer:
    """Continuous-batching request server over the SiDA engines."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        hash_params: dict,
        config: Optional[ServingConfig] = None,
        **kwargs,
    ):
        """`config` is the consolidated `ServingConfig` (serving/config.py);
        the reference's flat keyword surface (`slots_per_layer=...,
        max_lanes=...`) is accepted through `ServingConfig.from_kwargs`, and
        an int in `config`'s place is `slots_per_layer`. `device`,
        `telemetry` and `ctx` (an `attention.ShardingCtx`; by default the
        store's own) are runtime keywords in both styles; mixing a
        ServingConfig with config keywords is a TypeError."""
        device = kwargs.pop("device", None)
        telemetry = kwargs.pop("telemetry", None)
        ctx = kwargs.pop("ctx", None)
        if isinstance(config, int):
            kwargs["slots_per_layer"] = config
            config = None
        if config is None:
            config = ServingConfig.from_kwargs(**kwargs)
        elif kwargs:
            raise TypeError(
                "RequestServer: pass either a ServingConfig or the legacy "
                f"flat kwargs, not both (got config= plus {sorted(kwargs)})"
            )
        if cfg.block_kind != "attn" or cfg.enc_dec or not cfg.moe.enabled:
            raise ValueError("the request server serves attention-family decoder-only MoE archs")
        self.config = config
        self.cfg = cfg
        mode = config.spec.mode if config.spec.mode is not None else cfg.spec.mode
        if mode not in ("off", "draft"):
            raise ValueError(f"unknown spec_mode {mode!r}")
        self.spec_k = config.spec.k if config.spec.k is not None else cfg.spec.k
        self.spec = mode == "draft" and self.spec_k > 1
        if self.spec and "draft_proj" not in hash_params:
            raise ValueError("spec_mode='draft' needs a hash function with a draft head "
                             "(init_hash_fn(draft=True) or init_draft_head)")
        q = config.quant
        # one registry for the server's metrics and its store's, pipeline's
        # and engine's spans (recorded while `telemetry.record_spans` is on)
        self.telemetry = telemetry or Telemetry()
        self.store = ExpertStore(
            cfg, params, config.slots_per_layer, eviction=config.eviction, device=device,
            host_quant=q.host_quant, quantized_slots=q.quantized_slots,
            scale_granularity=q.scale_granularity, tier=q.tier,
            sharded=config.parallel.sharded, mesh=ctx.mesh if ctx is not None else None,
            telemetry=self.telemetry,
        )
        self.ctx = store_ctx(self.store, ctx)
        self.device = self.store.device
        self.faults = config.faults.plan
        self.fence_timeout_s = config.prefetch.fence_timeout_s
        self.shed = config.faults.shed
        self.watchdog_interval_s = config.prefetch.watchdog_interval_s
        self.watchdog_max_job_age_s = config.prefetch.watchdog_max_job_age_s
        self._last_watchdog = 0.0
        self.prefetch: Optional[PrefetchPipeline] = PrefetchPipeline.maybe_create(
            self.store, cfg, config.prefetch.depth, config.prefetch.staging_buffers,
            faults=self.faults, telemetry=self.telemetry)
        # prefetch_depth=0: the engine must not build a second pipeline off
        # cfg.prefetch when the server decided to run synchronously
        self.engine = SiDAEngine(
            cfg, params, hash_params, config.slots_per_layer, serve_top_k=config.serve_top_k,
            store=self.store, prefetcher=self.prefetch, prefetch_depth=0, ctx=self.ctx,
            telemetry=self.telemetry,
        )
        self.hash_params = self.engine.hash_params
        self.embed_table = self.store.serve_params["embed"]
        self.L = n_moe_layers(cfg)
        self.E = cfg.moe.num_experts
        self.k = config.serve_top_k or cfg.moe.top_k

        b = config.batching
        self.buckets = tuple(sorted(b.buckets))
        paged = config.paged
        self.paged = paged if (paged is not None and paged.enabled) else None
        if self.paged is not None:
            # the addressable range (table width), not the resident budget:
            # spilled pages live on the host
            self.cache_len = self.paged.seq_len
            if self.buckets[-1] > self.cache_len:
                raise ValueError("page table must address a full prefill bucket")
            need = -(-self.buckets[-1] // self.paged.page_size)
            if self.paged.kv_pages < need:
                raise ValueError(f"kv_pages={self.paged.kv_pages} cannot hold one full "
                                 f"prefill bucket ({self.buckets[-1]} tokens = {need} pages)")
        else:
            self.cache_len = b.cache_len or 2 * self.buckets[-1]
            if self.buckets[-1] > self.cache_len:
                raise ValueError("cache must hold a full bucket")
            # a wrapped window would evict positions the prefill seed wrote
            windows = [w for s in range(cfg.n_layers) if (w := cfg.layer_window(s))]
            if windows and min(windows) < self.cache_len:
                raise ValueError("windowed layers need window >= cache_len for "
                                 "prefill-seeded lanes")

        # online re-homing every `rebalance_interval` seconds (sharded only)
        self.rebalance_interval = (
            config.parallel.rebalance_interval if self.store.shards > 1 else 0.0)
        self._last_rebalance = 0.0
        self.max_lanes = b.max_lanes
        self.max_prefill_batch = b.max_prefill_batch
        self.drop_expired = b.drop_expired
        self.keep_prefill_logits = config.keep_prefill_logits
        self.keep_decode_logits = config.keep_decode_logits
        # the multi-tenant front door: WFQ over per-tenant queues, the shed
        # gate split per tenant, each tenant's pin quota on the store; with
        # no tenants the single-tenant objects, unchanged
        self.tenants = config.tenants
        self.multitenant = config.multitenant
        self._shed_mt: Optional[TenantAdmission] = None
        if self.multitenant:
            self.scheduler: Scheduler = WFQScheduler(
                self.tenants, quantum=config.wfq_quantum, buckets=self.buckets)
            if self.shed is not None:
                self._shed_mt = TenantAdmission(self.shed, self.tenants)
            for t in self.tenants:
                if t.pin_quota < 1.0:
                    self.store.set_pin_quota(t.name, t.pin_quota)
        else:
            self.scheduler = Scheduler(buckets=self.buckets)
        self.lanes = LaneTable(self.max_lanes)
        self._lock = threading.Lock()

        # mutable decode-batch state (one lane = one batch row)
        with torch.no_grad():
            if self.paged is not None:
                # page-ins ride the prefetch pipeline's transfer queue when async
                self.kv_pool: Optional[KVPagePool] = KVPagePool(
                    cfg, self.paged, self.max_lanes, eviction="alpha", pipeline=self.prefetch,
                    device=self.device,
                )
                self.residency: Optional[ResidencyManager] = ResidencyManager(
                    self.store, self.kv_pool)
                self.cache = self.kv_pool.init_cache()
            else:
                self.kv_pool = None
                self.residency = None
                self.cache = init_cache(cfg, self.max_lanes, self.cache_len, device=self.device)
            self.hstate = hash_state_init(self.hash_params, self.max_lanes)
        self.lane_tokens = np.zeros((self.max_lanes,), np.int32)
        self._active = np.zeros((self.max_lanes,), bool)
        self._lane_pos = np.zeros((self.max_lanes,), np.int64)  # paged: write pos
        self._long_queue: List[Request] = []      # prompts beyond the buckets
        self._chunk_state: Optional[dict] = None  # in-flight chunked prefill
        self._pending_pred = None   # (ids, alpha, active, ticket) for the next tick
        self._pending_spec = None   # pre-unrolled draft block for the next spec tick
        self._step = 0
        self._t0 = time.perf_counter()   # rebased at run()
        self.completed: List[Request] = []
        self.rejected: List[Request] = []
        # one unroll definition with the decode engine; the lane mask is the
        # only difference
        self._spec_unroll_masked = draft_unroll_fn(self.E, self.k, self.spec_k)

    # ------------------------------------------------------------------
    # the reference's jitted closures, as methods on tensors
    # ------------------------------------------------------------------
    def _tensor(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _hash_prefill(self, tokens: np.ndarray, lengths: np.ndarray,
                      state0: Optional[dict] = None) -> dict:
        """Advance the predictor LSTM through each (padded) prompt, freezing
        every row at its true length: the state the incremental predictor
        would have reached (`hash_fn_prefill`: the LSTMs and the ring only).
        `state0` continues a prior call (chunked prefill threads it chunk to
        chunk)."""
        emb = self.embed_table[self._tensor(tokens).long()]            # [n, Sb, d]
        return hash_fn_prefill(self.hash_params, emb, lengths, state0)

    def _predict_masked(self, tokens: np.ndarray, hstate: dict, active: np.ndarray):
        """One predictor step for the `active` lanes: (ids [L, B, k] int32, α
        [L, B, k] fp32, zero on inactive lanes, on the device; the state with
        inactive lanes unchanged)."""
        act = self._tensor(active, torch.bool)
        emb = self.embed_table[self._tensor(tokens).long()]            # [B, d]
        logits, new = hash_fn_step(self.hash_params, emb, hstate, self.E)   # [B, L, E]
        merged = _mask_state(act, new, hstate)
        vals, ids = top_k(logits, self.k)                              # [B, L, k]
        alpha = torch.softmax(vals, dim=-1) * act[:, None, None]
        return (ids.movedim(1, 0).to(torch.int32).contiguous(),
                alpha.movedim(1, 0).float().contiguous(), merged)

    def _decode_masked(self, tokens: np.ndarray, slot_ids: torch.Tensor, w: torch.Tensor,
                       active: np.ndarray):
        """One decode step over every lane; a masked lane keeps its `pos`.
        Paged: its write goes to the trash page. Ring: it writes at its stale
        position (see the module docstring)."""
        act = self._tensor(active, torch.bool)
        pos = self.cache["pos"]
        logits, new_cache = decode_step(
            self.store.serve_params, self.cache, self._tensor(tokens), self.cfg,
            routing_override=(slot_ids, w),
            active=act if self.paged is not None else None, ctx=self.ctx,
        )
        new_cache["pos"] = torch.where(act, new_cache["pos"], pos)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits, new_cache

    def _seed_lanes(self, kv: dict, hjoin: dict, lanes: np.ndarray, pos: np.ndarray) -> None:
        """Ring lane join: each request's prefill K/V [G, n, Sb, K, D] into
        its lane's rows at [:Sb] (pad positions included), its position and
        its predictor state."""
        idx = self._tensor(lanes, torch.long)
        for skey, (kk, vv) in kv.items():
            Sb = kk.shape[2]
            entry = self.cache[skey]
            entry["k"][:, idx, :Sb] = kk.to(entry["k"].dtype)
            entry["v"][:, idx, :Sb] = vv.to(entry["v"].dtype)
        self._seed_lanes_paged(hjoin, lanes, pos)

    def _seed_lanes_paged(self, hjoin: dict, lanes: np.ndarray, pos: np.ndarray) -> None:
        """Lane join, position and predictor state (the paged join writes the
        K/V through `KVPagePool.seed` first)."""
        idx = self._tensor(lanes, torch.long)
        new_pos = self.cache["pos"].clone()
        new_pos[idx] = self._tensor(pos)
        self.cache["pos"] = new_pos
        self.hstate = {name: full.index_copy(0, idx, hjoin[name].to(full.dtype))
                       for name, full in self.hstate.items()}

    def _chunk_step(self, tokens: np.ndarray, lane: int, slot_ids: torch.Tensor,
                    w: torch.Tensor) -> torch.Tensor:
        """One [1, T] prefill chunk of lane `lane` against the shared paged
        cache: the lane's pos / table rows, the chunk forward (pools written
        in place), the advanced pos merged back. Returns logits [1, T, V]."""
        sub = dict(self.cache)
        sub["pos"] = self.cache["pos"][lane:lane + 1]
        sub["page_table"] = self.cache["page_table"][lane:lane + 1]
        logits, new_sub = prefill_chunk_step(
            self.store.serve_params, sub, self._tensor(tokens), self.cfg,
            routing_override=(slot_ids, w), ctx=self.ctx,
        )
        pos = self.cache["pos"].clone()
        pos[lane] = new_sub["pos"][0]
        self.cache["pos"] = pos
        return logits

    def _verify_masked(self, tokens_blk: torch.Tensor, slot_ids: torch.Tensor,
                       w: torch.Tensor, active: torch.Tensor, states: dict):
        """One speculative block: `verify_step` (a masked lane accepts
        nothing and is rolled back entirely), then each lane's predictor
        state after its last accepted input (a masked lane keeps its own)."""
        out, n_acc, logits, self.cache = verify_step(
            self.store.serve_params, self.cache, tokens_blk, self.cfg,
            routing_override=(slot_ids, w), active=active, ctx=self.ctx,
        )
        self.hstate = select_accepted_state(states, n_acc, self.hstate)
        return out, n_acc, logits

    # ------------------------------------------------------------------
    # hash-ahead admission
    # ------------------------------------------------------------------
    def build_request_table(self, req: Request) -> None:
        """Hash-ahead: predict the request's per-token expert activations
        before any model compute (runs on the hash thread). With the async
        pipeline the hash thread is also the prefetch producer: the
        predicted experts start uploading as a fire-and-forget warming
        prefetch (`protect=False`: a warmed expert may be evicted before the
        request is scheduled; later tickets fence on uploads in flight)."""
        if self.faults is not None:
            self.faults.inject("hash")
        req.table = self.engine.build_table(req.rid, req.prompt[None, :])
        if self.prefetch is not None:
            self.prefetch.submit(req.table, protect=False)
            self.telemetry.counter("prefetch_warm_submits").inc()

    def admit(self, req: Request, now: float) -> None:
        req.t_queued = now
        self.telemetry.counter("requests_arrived").inc()
        if self.multitenant:
            # the tenant's contract: a request without its own SLO takes the
            # tenant's default, which scheduling and shedding then read
            tcfg = self.config.tenant(req.tenant)
            if tcfg is not None and req.slo_s is None:
                req.slo_s = tcfg.default_slo_s
            self.telemetry.tenant(req.tenant).counter("requests_arrived").inc()
        P = req.prompt_len
        if self.paged is not None and P + req.max_new_tokens > self.cache_len:
            # the page table cannot address positions past cache_len, so the
            # request could not finish: refuse it up front
            return self._reject(req, now, "exceeds_addressable_range")
        if P > self.buckets[-1]:
            if self.paged is None or self.paged.prefill_chunk <= 0:
                # no chunked-prefill path: no bucket can hold this prompt
                return self._reject(req, now, "prompt_exceeds_max_bucket")
            self.telemetry.counter("requests_admitted_long").inc()
            with self._lock:
                self._long_queue.append(req)
            return
        if self._shed_mt is not None:
            # tenant-aware shedding: this tenant's queue depth and service
            # time alone, so one tenant's overload closes only its own gate
            with self._lock:
                depth = self.scheduler.pending_tenant(req.tenant) + sum(
                    1 for r in self._long_queue if r.tenant == req.tenant)
            degraded = self.prefetch.degraded_fraction() if self.prefetch is not None else 0.0
            slack = req.slack(now) if req.slo_s is not None else None
            if self._shed_mt.should_shed(req.tenant, depth, slack, degraded):
                self.telemetry.tenant(req.tenant).gauge("est_queue_wait_s").set(
                    self._shed_mt.controller(req.tenant).est_wait_s(depth))
                return self._reject(req, now, "overloaded")
        elif self.shed is not None:
            # overload shedding: estimated back-of-queue wait against this
            # request's remaining deadline slack; degraded transfer shards
            # shrink the threshold (synchronous uploads are about to slow
            # service down)
            with self._lock:
                depth = self.scheduler.pending() + len(self._long_queue)
            degraded = self.prefetch.degraded_fraction() if self.prefetch is not None else 0.0
            slack = req.slack(now) if req.slo_s is not None else None
            if self.shed.should_shed(depth, slack, degraded):
                self.telemetry.gauge("est_queue_wait_s").set(self.shed.est_wait_s(depth))
                return self._reject(req, now, "overloaded")
        with self._lock:
            self.scheduler.enqueue(req)

    def _reject(self, req: Request, now: float, reason: str) -> None:
        req.state = RequestState.REJECTED
        req.reject_reason = reason
        req.t_done = now
        self.rejected.append(req)
        self.telemetry.counter("requests_rejected").inc()
        self.telemetry.counter(f"requests_rejected_{reason}").inc()
        if self.multitenant:
            tt = self.telemetry.tenant(req.tenant)
            tt.counter("requests_rejected").inc()
            tt.counter(f"requests_rejected_{reason}").inc()

    # ------------------------------------------------------------------
    # prefill: length-bucketed batch -> lanes
    # ------------------------------------------------------------------
    def _combined_table(self, batch: List[Request], bucket: int) -> HashTable:
        """Concat per-request hash tables, edge-padding ids (no spurious
        expert loads) with zero α (pad tokens route nowhere)."""
        ids = np.zeros((self.L, len(batch), bucket, self.k), np.int32)
        w = np.zeros((self.L, len(batch), bucket, self.k), np.float32)
        for i, r in enumerate(batch):
            P = r.prompt_len
            ids[:, i, :P] = r.table.expert_ids[:, 0]
            ids[:, i, P:] = r.table.expert_ids[:, 0, P - 1:P]
            w[:, i, :P] = r.table.weights[:, 0]
        return HashTable(self._step, ids, w)

    def _prefill_and_join(self, batch: List[Request], bucket: int, now: float,
                          table: Optional[HashTable] = None, ticket=None) -> None:
        n = len(batch)
        tokens = np.zeros((n, bucket), np.int32)
        lengths = np.zeros((n,), np.int32)
        for i, r in enumerate(batch):
            tokens[i, :r.prompt_len] = r.prompt
            lengths[i] = r.prompt_len
            r.t_prefill = now
        if table is None:
            table = self._combined_table(batch, bucket)
        # the predictor's pass over the prompts is queued first: it does not
        # depend on the routing, so it runs while the prefill's fences clear
        hjoin = self._hash_prefill(tokens, lengths)
        logits, kv = self.engine.prefill(tokens, table, ticket=ticket)
        logits = logits.cpu()

        lanes = np.zeros((n,), np.int32)
        pos = np.zeros((n,), np.int32)
        t_first = time.perf_counter() - self._t0
        for i, r in enumerate(batch):
            first = int(torch.argmax(logits[i, r.prompt_len - 1]))
            if self.keep_prefill_logits:
                r.prefill_logits = logits[i, :r.prompt_len].float().numpy().copy()
            lanes[i] = self.lanes.assign(r)
            pos[i] = r.prompt_len
            r.state = RequestState.DECODE
            r.t_first_token = t_first
            r.emit(first)
            self.lane_tokens[lanes[i]] = first
            self.telemetry.histogram("ttft_s").observe(r.ttft_s)
            if self.multitenant:
                self.scheduler.debit(r.tenant, 1, now)
        if self.kv_pool is not None:
            # each request's rope'd K/V into its lane's pages (allocating or
            # spilling as needed), then pos and predictor state
            for i, r in enumerate(batch):
                self.cache = self.kv_pool.seed(
                    self.cache, int(lanes[i]),
                    {key: (kk[:, i], vv[:, i]) for key, (kk, vv) in kv.items()},
                    r.prompt_len,
                )
            self.cache["page_table"] = self.kv_pool.device_table()
            self._seed_lanes_paged(hjoin, lanes, pos)
        else:
            self._seed_lanes(kv, hjoin, lanes, pos)
        self._lane_pos[lanes] = pos
        self._active[lanes] = True
        self.telemetry.counter("prefill_batches").inc()
        self.telemetry.histogram("prefill_batch_size").observe(n)
        self.telemetry.counter("prefill_pad_tokens").inc(float(n * bucket - lengths.sum()))
        # a request whose whole budget was the first token finishes here
        for i, r in enumerate(batch):
            if r.finished():
                self._finish(int(lanes[i]))

    def _await_fences(self, ticket, prep: HashTable):
        """Bounded wait on a ticket's ready fences; returns the translation
        to decode with. On timeout the tick falls back to a synchronous
        `store.prepare` of the same prediction (the same residency, no
        overlap). `fence_timeout_s=None` waits until the fences clear."""
        with self.telemetry.timer("prefetch_fence_s"):
            ok = ticket.wait(self.fence_timeout_s)
        if ok:
            return ticket.trans
        self.telemetry.counter("prefetch_fence_timeouts").inc()
        return self.store.prepare(prep)

    # ------------------------------------------------------------------
    # decode: one continuous-batch step
    # ------------------------------------------------------------------
    def _page_tick(self, upto: np.ndarray, extra_span: int = 0) -> None:
        """Pre-tick paging: make each lane's positions resident up to
        `upto[lane]` (0 = skip the lane), pinned, clear page-in fences and
        install the table. The tick unpins after its step."""
        pool = self.kv_pool
        for lane in range(self.max_lanes):
            if upto[lane] > 0:
                self.cache = pool.ensure(self.cache, lane, int(upto[lane]), pin=True,
                                         extra_span=extra_span)
        self.cache = pool.sync(self.cache)
        self.cache["page_table"] = pool.device_table()

    def _predict_tick(self, mask: np.ndarray):
        """Advance the hash predictor for `mask` lanes; returns numpy."""
        ids, alpha, self.hstate = self._predict_masked(self.lane_tokens, self.hstate, mask)
        return ids_alpha_to_host(ids, alpha)

    def _spec_tick(self, now: float) -> None:
        """Speculative continuous-batch step: draft K tokens a lane, ship ONE
        superset ticket for the K positions' predicted experts, verify the
        block in one `verify_step`, and emit each lane's accepted prefix."""
        active = self._active.copy()
        if self.kv_pool is not None:
            # verify writes the whole block before acceptance is known; the
            # pinned pages keep eviction off the rollback. The target is
            # clamped to the addressable range (overdraft writes go to the
            # trash page and are never accepted); extra_span brings back the
            # window pages of the block's first query
            self._page_tick(
                np.where(active, np.minimum(self._lane_pos + self.spec_k, self.cache_len), 0),
                extra_span=self.spec_k - 1,
            )
        act_dev = self._tensor(active, torch.bool)
        unrolled = ticket = stale_ticket = None
        if self._pending_spec is not None:
            # pre-unrolled and pre-submitted at the end of the previous tick.
            # A lane that joined since invalidates it: redo it, but hold the
            # stale ticket until after the verify, so the new plan fences on
            # its in-flight uploads instead of issuing them again
            p_unrolled, pred_active, p_ticket = self._pending_spec
            self._pending_spec = None
            if (active & ~pred_active).any():
                stale_ticket = p_ticket
            else:
                unrolled, ticket = p_unrolled, p_ticket
        if unrolled is None:
            inputs, ids, alpha, states = self._spec_unroll_masked(
                self.hash_params, self.embed_table, self._tensor(self.lane_tokens),
                self.hstate, act_dev)
            ids_np, alpha_np = ids_alpha_to_host(ids, alpha)       # [L, B, K, k]
        else:
            inputs, ids, alpha, states, ids_np, alpha_np = unrolled
        spec_prep = HashTable(self._step, ids_np[:, active], alpha_np[:, active])
        if self.prefetch is not None:
            if ticket is None:
                # the union over all K draft positions of every active lane
                ticket = self.prefetch.submit(spec_prep)
            trans = self._await_fences(ticket, spec_prep)
        else:
            trans = self.store.prepare(spec_prep)
        slot_ids, w = self.store.translate_device(ids, alpha, trans)
        out_blk, n_acc, logits = self._verify_masked(
            inputs, slot_ids.movedim(2, 0), w.movedim(2, 0), act_dev, states)
        K = self.spec_k
        both = torch.cat([out_blk, n_acc[:, None]], dim=1).cpu().numpy()
        out_np, n_np = both[:, :K], both[:, K]     # forces the block; slots consumed
        if self.kv_pool is not None:
            self.kv_pool.unpin_all()
            self._lane_pos[active] += n_np[active]
        if ticket is not None:
            ticket.release()
        if stale_ticket is not None:
            stale_ticket.release()
        logits_np = logits.float().cpu().numpy() if self.keep_decode_logits else None  # [K, B, V]
        self._step += 1
        n_active = int(active.sum())
        self.telemetry.counter("decode_steps").inc()
        self.telemetry.counter("spec_verify_steps").inc()
        self.telemetry.counter("spec_proposed_tokens").inc(self.spec_k * n_active)

        emitted = 0
        for lane in self.lanes.active():
            if not active[lane]:
                continue  # joined after this tick's snapshot
            req = self.lanes.requests[lane]
            for i in range(int(n_np[lane])):
                req.emit(int(out_np[lane, i]))
                emitted += 1
                if logits_np is not None:
                    if req.decode_logits is None:
                        req.decode_logits = []
                    req.decode_logits.append(logits_np[i, lane].copy())
                self.lane_tokens[lane] = out_np[lane, i]
                self.telemetry.counter("tokens_generated").inc()
                if self.multitenant:
                    self.telemetry.tenant(req.tenant).counter("tokens_generated").inc()
                    self.scheduler.debit(req.tenant, 1, now)
                if req.finished():
                    self._finish(lane)
                    break
        # what was delivered: a lane that finished mid-block drops the rest
        # of its accepted prefix
        self.telemetry.counter("spec_accepted_tokens").inc(float(emitted))
        if n_active:
            self.telemetry.histogram("accepted_per_step").observe(emitted / n_active)

        # pipeline the next block: its draft unroll and superset ticket
        # overlap whatever runs between ticks
        if self.prefetch is not None and self._active.any():
            nxt = self._active.copy()
            n_inp, n_ids, n_alpha, n_states = self._spec_unroll_masked(
                self.hash_params, self.embed_table, self._tensor(self.lane_tokens),
                self.hstate, self._tensor(nxt, torch.bool))
            n_ids_np, n_alpha_np = ids_alpha_to_host(n_ids, n_alpha)
            tkt = self.prefetch.submit(HashTable(self._step, n_ids_np[:, nxt], n_alpha_np[:, nxt]))
            self._pending_spec = ((n_inp, n_ids, n_alpha, n_states, n_ids_np, n_alpha_np),
                                  nxt, tkt)

    def _decode_tick(self, now: float) -> None:
        if self.spec:
            return self._spec_tick(now)
        active = self._active.copy()
        if self.kv_pool is not None:
            self._page_tick(np.where(active, self._lane_pos + 1, 0))
        ticket = None
        if self._pending_pred is not None:
            # predicted and submitted at the end of the previous tick; lanes
            # that joined since are predicted now and folded in
            ids_np, alpha_np, pred_active, ticket = self._pending_pred
            self._pending_pred = None
            joined = active & ~pred_active
            if joined.any():
                ids2, alpha2 = self._predict_tick(joined)
                ids_np = np.where(joined[None, :, None], ids2, ids_np)
                alpha_np = np.where(joined[None, :, None], alpha2, alpha_np)
                ticket.release()
                ticket = self.prefetch.submit(HashTable(
                    self._step, ids_np[:, active, None, :], alpha_np[:, active, None, :]))
        else:
            ids_np, alpha_np = self._predict_tick(active)

        # prefetch only what active lanes predict; translate for all lanes
        prep = HashTable(self._step, ids_np[:, active, None, :], alpha_np[:, active, None, :])
        if self.prefetch is not None:
            if ticket is None:
                ticket = self.prefetch.submit(prep)
            trans = self._await_fences(ticket, prep)
        else:
            trans = self.store.prepare(prep)
        full = HashTable(self._step, ids_np[:, :, None, :], alpha_np[:, :, None, :])
        slot_ids, w = self.store.translate(full, trans)

        next_tok, logits, self.cache = self._decode_masked(
            self.lane_tokens, self._tensor(slot_ids[:, :, 0, :]),
            self._tensor(w[:, :, 0, :], torch.float32), active)
        next_tok = next_tok.cpu().numpy()    # forces the step; slots consumed
        if ticket is not None:
            ticket.release()
        if self.kv_pool is not None:
            self.kv_pool.unpin_all()         # pinned by _page_tick
            self._lane_pos[active] += 1
        logits_np = logits.float().cpu().numpy() if self.keep_decode_logits else None
        self._step += 1
        self.telemetry.counter("decode_steps").inc()

        for lane in self.lanes.active():
            if not active[lane]:
                continue  # joined after this tick's snapshot
            req = self.lanes.requests[lane]
            req.emit(int(next_tok[lane]))
            if logits_np is not None:
                if req.decode_logits is None:
                    req.decode_logits = []
                req.decode_logits.append(logits_np[lane].copy())
            self.lane_tokens[lane] = next_tok[lane]
            self.telemetry.counter("tokens_generated").inc()
            if self.multitenant:
                # the token marks the tenant's partition and debits its rate
                # budget (WFQ defers its next prefill once the bucket is dry)
                self.telemetry.tenant(req.tenant).counter("tokens_generated").inc()
                self.scheduler.debit(req.tenant, 1, now)
            if req.finished():
                self._finish(lane)

        # pipeline the next tick: predict it now (tokens are final) and
        # submit its uploads so they transfer while prefills and scheduling
        # run between ticks
        if self.prefetch is not None and self._active.any():
            nxt = self._active.copy()
            n_ids, n_alpha = self._predict_tick(nxt)
            tkt = self.prefetch.submit(HashTable(
                self._step, n_ids[:, nxt, None, :], n_alpha[:, nxt, None, :]))
            self._pending_pred = (n_ids, n_alpha, nxt, tkt)

    def _finish(self, lane: int) -> None:
        req = self.lanes.release(lane)
        self._active[lane] = False
        if self.kv_pool is not None:
            self.kv_pool.release_lane(lane)
            self._lane_pos[lane] = 0
        now = time.perf_counter() - self._t0
        req.state = RequestState.DONE
        req.t_done = now
        self.completed.append(req)
        self.telemetry.counter("requests_completed").inc()
        self.telemetry.histogram("latency_s").observe(req.latency_s)
        self.telemetry.histogram("decode_tokens").observe(len(req.generated))
        missed = req.slo_s is not None and req.latency_s > req.slo_s
        if missed:
            self.telemetry.counter("deadline_miss").inc()
        if self.multitenant:
            tt = self.telemetry.tenant(req.tenant)
            tt.counter("requests_completed").inc()
            tt.histogram("latency_s").observe(req.latency_s)
            tt.histogram("ttft_s").observe(req.ttft_s)
            tt.histogram("decode_tokens").observe(len(req.generated))
            if missed:
                tt.counter("deadline_miss").inc()
        if req.t_prefill >= 0:
            # prefill-to-done: the service time the queue-wait estimate
            # multiplies by (queueing delay is what it predicts)
            if self._shed_mt is not None:
                self._shed_mt.observe(req.tenant, now - req.t_prefill)
            elif self.shed is not None:
                self.shed.observe(now - req.t_prefill)

    # ------------------------------------------------------------------
    # chunked prefill: long prompts stream through the paged cache
    # ------------------------------------------------------------------
    def _start_long(self, req: Request, now: float) -> None:
        """Claim a lane for a long prompt; it joins the decode batch only
        after its last chunk (the lane stays masked out meanwhile). The
        lane's position is reset to 0: a lane released by an earlier
        request keeps that request's last position, and the first chunk
        would start there. (The reference does not reset it, so its long
        prompt on a reused lane is prefilled at the wrong positions; see
        ROADMAP §C.)"""
        lane = self.lanes.assign(req)
        req.state = RequestState.PREFILL
        req.t_prefill = now
        self._active[lane] = False
        pos = self.cache["pos"].clone()
        pos[lane] = 0
        self.cache["pos"] = pos
        self._chunk_state = {
            "req": req, "lane": lane, "done": 0,
            "hstate": None,   # predictor state threaded chunk to chunk
            "ema_s": 0.0,     # observed seconds a chunk (EMA), for chunk_urgent
            "logits": [] if self.keep_prefill_logits else None,
        }
        self.telemetry.counter("long_prefills_started").inc()

    def _chunk_tick(self, now: float) -> None:
        """Run ONE prefill chunk of the in-flight long request; decode ticks
        interleave between chunks, so a long prefill never stalls the
        continuous batch."""
        st = self._chunk_state
        req, lane, done = st["req"], st["lane"], st["done"]
        T = self.paged.prefill_chunk
        P = req.prompt_len
        n = min(T, P - done)
        t0 = time.perf_counter()
        tokens = np.zeros((1, T), np.int32)
        tokens[0, :n] = req.prompt[done:done + n]
        # per-chunk routing sliced from the admission-time table; edge-pad
        # ids (no spurious loads), zero-α pads route nowhere
        ids = np.zeros((self.L, 1, T, self.k), np.int32)
        w = np.zeros((self.L, 1, T, self.k), np.float32)
        ids[:, :, :n] = req.table.expert_ids[:, :, done:done + n]
        ids[:, :, n:] = ids[:, :, n - 1:n]
        w[:, :, :n] = req.table.weights[:, :, done:done + n]
        tbl = HashTable(self._step, ids, w)
        ticket = None
        if self.prefetch is not None:
            ticket = self.prefetch.submit(tbl)
            trans = self._await_fences(ticket, tbl)
        else:
            trans = self.store.prepare(tbl)
        slot_ids, w_t = self.store.translate(tbl, trans)
        # the chunk's writes and its attention span resident and pinned,
        # clamped to the addressable range (a pad tail past it goes to the
        # trash page inside the step); extra_span: the chunk's first query
        # is T - 1 positions before its last
        self.cache = self.kv_pool.ensure(self.cache, lane, min(done + T, self.cache_len),
                                         pin=True, extra_span=T - 1)
        self.cache = self.kv_pool.sync(self.cache)
        self.cache["page_table"] = self.kv_pool.device_table()
        logits = self._chunk_step(tokens, lane, self._tensor(slot_ids),
                                  self._tensor(w_t, torch.float32))
        self.kv_pool.unpin_lane(lane)
        st["hstate"] = self._hash_prefill(tokens, np.array([n], np.int32), st["hstate"])
        if st["logits"] is not None:
            st["logits"].append(logits[0, :n].float().cpu().numpy())
        if ticket is not None:
            ticket.release()
        st["done"] = done + n
        req.chunk_pos = st["done"]
        dt = time.perf_counter() - t0
        st["ema_s"] = dt if st["ema_s"] == 0.0 else 0.5 * st["ema_s"] + 0.5 * dt
        self._step += 1
        self.telemetry.counter("prefill_chunks").inc()
        self.telemetry.counter("prefill_pad_tokens").inc(float(T - n))
        if st["done"] < P:
            return
        # final chunk: the lane joins the decode batch
        first = int(torch.argmax(logits[0, n - 1]))
        if st["logits"] is not None:
            req.prefill_logits = np.concatenate(st["logits"], axis=0)
        # the pad tail advanced pos past the prompt; decode resumes at P
        # (each pad position is rewritten by decode before a query reads it)
        self._seed_lanes_paged(st["hstate"], np.array([lane]), np.array([P]))
        self._lane_pos[lane] = P
        self.lane_tokens[lane] = first
        self._active[lane] = True
        req.state = RequestState.DECODE
        req.t_first_token = time.perf_counter() - self._t0
        req.emit(first)
        self.telemetry.histogram("ttft_s").observe(req.ttft_s)
        if self.multitenant:
            self.scheduler.debit(req.tenant, 1, now)
        self.telemetry.counter("long_prefills_completed").inc()
        self._chunk_state = None
        if req.finished():
            self._finish(lane)

    # ------------------------------------------------------------------
    # serving loop
    # ------------------------------------------------------------------
    @torch.no_grad()
    def run(self, requests: List[Request], realtime: bool = True) -> Telemetry:
        """Serve an arrival stream to completion.

        realtime=True honours inter-arrival gaps with wall-clock waits (the
        open-loop Poisson benchmark); realtime=False releases requests in
        arrival order as fast as the hash thread can admit them (tests)."""
        self._t0 = time.perf_counter()
        stream = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        hash_done = threading.Event()
        hash_exc: List[BaseException] = []

        def hash_thread():
            # a per-request failure rejects that request and moves on; an
            # unexpected escape is re-raised on the caller's thread after the
            # join. Either way `hash_done` is set, or run() would spin forever
            try:
                with torch.no_grad():
                    for req in stream:
                        if realtime:
                            wait = req.arrival_s - (time.perf_counter() - self._t0)
                            if wait > 0:
                                time.sleep(wait)
                        try:
                            self.build_request_table(req)
                        except Exception:
                            self.telemetry.counter("hash_thread_errors").inc()
                            self._reject(req, time.perf_counter() - self._t0, "hash_error")
                            continue
                        self.admit(req, time.perf_counter() - self._t0)
            except BaseException as e:  # noqa: BLE001 (re-raised after the join)
                hash_exc.append(e)
            finally:
                hash_done.set()

        ht = threading.Thread(target=hash_thread, name="sida-hash-ahead")
        ht.start()
        try:
            while True:
                now = time.perf_counter() - self._t0
                long_req = None
                with self._lock:
                    if self.drop_expired:
                        for r in self.scheduler.pop_expired(now):
                            self._reject(r, now, "deadline_expired")
                    free = self.lanes.free_count()
                    batch, bucket = ([], 0)
                    if free:
                        # affinity: the pipeline (residency + uploads in
                        # flight) when async, the bare store when not
                        batch, bucket = self.scheduler.next_prefill_batch(
                            now, min(free, self.max_prefill_batch), self.prefetch or self.store)
                    # one chunked long prefill at a time, on a lane beyond
                    # what this round's bucket batch takes
                    if (self._chunk_state is None and self._long_queue
                            and self.lanes.free_count() > len(batch)):
                        long_req = self._long_queue.pop(0)
                    depth = self.scheduler.pending() + len(self._long_queue)
                self.telemetry.gauge("queue_depth").set(depth)
                self.telemetry.gauge("active_lanes").set(len(self.lanes.active()))

                if (self.prefetch is not None and self.watchdog_interval_s > 0
                        and now - self._last_watchdog >= self.watchdog_interval_s):
                    self._last_watchdog = now
                    revived, stalled = self.prefetch.watchdog(self.watchdog_max_job_age_s)
                    if revived:
                        self.telemetry.counter("watchdog_revives").inc(revived)
                    if stalled:
                        self.telemetry.counter("prefetch_stalled_jobs").inc(stalled)

                if (self.rebalance_interval > 0
                        and now - self._last_rebalance >= self.rebalance_interval):
                    self._last_rebalance = now
                    moved = self.store.rebalance_homes()
                    if moved:
                        self.telemetry.counter("rebalance_moves").inc(moved)
                        self.telemetry.counter("rebalance_rounds").inc()

                if long_req is not None:
                    self._start_long(long_req, now)

                progressed = False
                pf_table, pf_ticket = None, None
                if batch:
                    pf_table = self._combined_table(batch, bucket)
                    if self.prefetch is not None:
                        # prefill uploads go out before the decode tick, behind
                        # its own urgent ones, so the tick covers the transfer
                        pf_ticket = self.prefetch.submit(pf_table, priority=1)
                # a chunk runs before this round's decode tick only when the
                # long request's deadline demands it
                chunk_first = False
                if self._chunk_state is not None:
                    st = self._chunk_state
                    remaining = -(-(st["req"].prompt_len - st["done"]) // self.paged.prefill_chunk)
                    chunk_first = self.scheduler.chunk_urgent(st["req"], now, remaining,
                                                              st["ema_s"])
                    if chunk_first:
                        self._chunk_tick(now)
                        progressed = True
                if self._active.any():
                    # timed: decode tok/s counts only the ticks' time
                    with self.telemetry.timer("decode_tick_s"):
                        self._decode_tick(now)
                    progressed = True
                if batch:
                    self._prefill_and_join(batch, bucket, now, table=pf_table, ticket=pf_ticket)
                    progressed = True
                if self._chunk_state is not None and not chunk_first:
                    self._chunk_tick(now)
                    progressed = True
                if not progressed:
                    # hash_done is set only after the last admit, so a
                    # pending() re-read under the lock cannot miss a request
                    if hash_done.is_set():
                        with self._lock:
                            if (self.scheduler.pending() == 0 and not self._long_queue
                                    and self._chunk_state is None):
                                break
                    time.sleep(2e-4)
        finally:
            ht.join()
        if hash_exc:
            raise hash_exc[0]
        st = self.store.stats
        self.telemetry.counter("h2d_bytes").inc(st.bytes_h2d)
        self.telemetry.counter("expert_loads").inc(st.loads)
        self.telemetry.counter("expert_hits").inc(st.hits)
        self.telemetry.counter("expert_evictions").inc(st.evictions)
        self.telemetry.counter("expert_replica_loads").inc(st.replica_loads)
        for stats in ([self.prefetch.stats] if self.prefetch is not None else []) + (
                [self.kv_pool.stats] if self.kv_pool is not None else []) + (
                [self.faults] if self.faults is not None else []):
            for key, v in stats.summary().items():
                c = self.telemetry.counter(key)
                c.value = 0   # cumulative stats: snapshot, don't double-count
                c.inc(v)
        return self.telemetry

    def close(self) -> None:
        """Join the async prefetch transfer thread (no-op when sync)."""
        if self.prefetch is not None:
            self.prefetch.close()

    # ------------------------------------------------------------------
    def summary(self) -> Dict[str, float]:
        """Flat metric dict with the reference's keys."""
        t = self.telemetry
        lat, ttft = t.histogram("latency_s"), t.histogram("ttft_s")
        st = self.store.stats
        refs = st.hits + st.loads
        # first tokens are emitted at prefill
        toks = t.counter("tokens_generated").value + t.counter("requests_completed").value
        wall = t.wall_s()
        # upload stall: the sync path pays every upload inline; the async
        # one pays fences that had not landed plus residual sync prepares
        stall = st.prepare_time
        overlap = 0.0
        if self.prefetch is not None:
            stall += self.prefetch.stats.stall_s
            overlap = self.prefetch.stats.overlap_s
        acc_hist = t.histogram("accepted_per_step")
        tick_s = t.counter("decode_tick_s_total").value
        out = {
            "completed": t.counter("requests_completed").value,
            "rejected": t.counter("requests_rejected").value,
            "deadline_miss": t.counter("deadline_miss").value,
            "throughput_tok_s": toks / wall if wall else 0.0,
            # generated tokens per second of decode ticks
            "decode_tok_s": t.counter("tokens_generated").value / tick_s if tick_s else 0.0,
            "spec_k": float(self.spec_k if self.spec else 0),
            "spec_acceptance_rate": t.ratio("spec_accepted_tokens", "spec_proposed_tokens"),
            "spec_accepted_per_step": (
                sum(acc_hist.samples) / acc_hist.count if acc_hist.count else 0.0),
            "p50_latency_s": lat.percentile(50),
            "p95_latency_s": lat.percentile(95),
            "p99_latency_s": lat.percentile(99),
            "p50_ttft_s": ttft.percentile(50),
            "p95_ttft_s": ttft.percentile(95),
            "cache_hit_rate": st.hits / refs if refs else 0.0,
            "h2d_mb": st.bytes_h2d / 1e6,
            "max_queue_depth": t.gauge("queue_depth").max,
            "upload_stall_s": stall,
            "upload_overlap_s": overlap,
            "async_prefetch": 1.0 if self.prefetch is not None else 0.0,
            # the supervision counters (all 0 in a fault-free run)
            "rejected_overloaded": t.counter("requests_rejected_overloaded").value,
            "rejected_hash_error": t.counter("requests_rejected_hash_error").value,
            "upload_retries": t.counter("prefetch_upload_retries").value,
            "upload_failures": t.counter("prefetch_upload_failures").value,
            "poisoned_fences": t.counter("prefetch_poisoned_fences").value,
            "thread_crashes": t.counter("prefetch_thread_crashes").value,
            "thread_restarts": t.counter("prefetch_thread_restarts").value,
            "sync_fallbacks": t.counter("prefetch_sync_fallbacks").value,
            "fence_timeouts": t.counter("prefetch_fence_timeouts").value,
            "watchdog_revives": t.counter("watchdog_revives").value,
            "degraded_shards": t.counter("prefetch_degraded_shards").value,
        }
        if self.store.shards > 1:
            out["replicate_hot"] = float(self.store.sharded.replicate_hot)
            out["replica_loads"] = float(st.replica_loads)
            out["rebalance_moves"] = float(st.rebalance_moves)
            if self.prefetch is not None:
                # max / mean of the uploads a shard: 1.0 is an even fleet
                ups = [float(self.prefetch.stats.uploads_by_shard.get(m, 0))
                       for m in range(self.store.shards)]
                mean = sum(ups) / len(ups)
                out["shard_upload_max_over_mean"] = max(ups) / mean if mean > 0 else 1.0
        if self.residency is not None:
            out.update(self.residency.summary())
            out["paged_kv"] = 1.0
            out["long_prefills_completed"] = t.counter("long_prefills_completed").value
            out["prefill_chunks"] = t.counter("prefill_chunks").value
            out["requests_rejected_too_long"] = t.counter(
                "requests_rejected_prompt_exceeds_max_bucket").value
        else:
            out["paged_kv"] = 0.0
        return out

    def tenant_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-tenant summary block (`{}` without tenants): arrivals,
        completions, rejections, tokens, latency percentiles and SLO
        attainment, the share of the tenant's arrived requests that
        completed within their deadline (sheds and misses both count
        against it; without SLOs, completions alone)."""
        out: Dict[str, Dict[str, float]] = {}
        for name in self.telemetry.tenant_names():
            tt = self.telemetry.tenant(name)
            lat = tt.histogram("latency_s")
            arrived = tt.counter("requests_arrived").value
            completed = tt.counter("requests_completed").value
            missed = tt.counter("deadline_miss").value
            out[name] = {
                "arrived": arrived,
                "completed": completed,
                "rejected": tt.counter("requests_rejected").value,
                "rejected_overloaded": tt.counter("requests_rejected_overloaded").value,
                "deadline_miss": missed,
                "tokens_generated": tt.counter("tokens_generated").value,
                "p50_latency_s": lat.percentile(50),
                "p95_latency_s": lat.percentile(95),
                "slo_attainment": (completed - missed) / arrived if arrived else 0.0,
                "pinned_share": self.store.pinned_share(name),
            }
        return out
