"""Admission queue + continuous batcher (port of `repro/serving/scheduler.py`,
which is framework-free: `bucket_len`, `LaneTable`, `Scheduler`,
`AdmissionController` and the multi-tenant front door, `TenantState`,
`WFQScheduler` and `TenantAdmission`, are copied as they are).

Two scheduling decisions live here, both SLA-aware:

* **Prefill batch composition** — queued requests are grouped by length
  bucket (padding waste stays bounded by the bucket granularity) and
  ordered earliest-deadline-first; within the same urgency band, requests
  whose hash-ahead tables overlap the resident expert cache the most go
  first (the cache-affinity score generalized out of the batch engine's
  lookahead scheduling onto `ExpertStore.cache_affinity`; with the async
  pipeline the server passes the `PrefetchPipeline` instead, whose
  affinity also credits uploads still in flight — work the cache already
  paid for ranks as if it were resident).
* **Decode lane occupancy** — the `LaneTable` tracks which request holds
  which decode-batch row; requests join a free lane as soon as prefill
  completes and leave the moment they finish, so the running decode batch
  continuously re-fills instead of draining to the slowest member.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.offload import ExpertStore
from repro_torch.serving.config import TenantConfig
from repro_torch.serving.request import Request, RequestState

DEFAULT_BUCKETS = (8, 16, 32, 64, 128)

# requests within the same slack band are interchangeable deadline-wise;
# cache affinity orders inside a band
SLACK_BAND_S = 0.25


def bucket_len(length: int, buckets: Sequence[int] = DEFAULT_BUCKETS) -> int:
    """Smallest bucket that holds `length` (prompts are padded up to it)."""
    for b in buckets:
        if length <= b:
            return b
    raise ValueError(f"prompt length {length} exceeds largest bucket {buckets[-1]}")


class LaneTable:
    """Decode-batch lane bookkeeping: which request occupies which row."""

    def __init__(self, n_lanes: int):
        self.n_lanes = n_lanes
        self.requests: List[Optional[Request]] = [None] * n_lanes
        self._free: List[int] = list(range(n_lanes - 1, -1, -1))

    def free_count(self) -> int:
        return len(self._free)

    def active(self) -> List[int]:
        return [i for i, r in enumerate(self.requests) if r is not None]

    def assign(self, req: Request) -> int:
        lane = self._free.pop()
        self.requests[lane] = req
        req.lane = lane
        return lane

    def release(self, lane: int) -> Request:
        req = self.requests[lane]
        assert req is not None, f"lane {lane} is already free"
        self.requests[lane] = None
        self._free.append(lane)
        req.lane = -1
        return req


class Scheduler:
    """Admission queue feeding the continuous batcher."""

    def __init__(
        self,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        use_affinity: bool = True,
        slack_band_s: float = SLACK_BAND_S,
    ):
        self.buckets = tuple(sorted(buckets))
        self.use_affinity = use_affinity
        self.slack_band_s = slack_band_s
        self._queue: List[Request] = []
        # rid -> (affinity epoch, score): cache_affinity is an O(L·E) scan
        # under the store lock, so a deep queue re-scoring every request
        # every tick would serialize the serve loop against the prefetch
        # thread — scores are reused until the store's residency epoch
        # moves (see ExpertStore.affinity_epoch)
        self._aff_cache: Dict[int, Tuple[object, float]] = {}

    # ------------------------------------------------------------------
    def enqueue(self, req: Request) -> None:
        req.state = RequestState.QUEUED
        self._queue.append(req)

    def pending(self) -> int:
        return len(self._queue)

    def pop_expired(self, now: float) -> List[Request]:
        """Remove and return queued requests whose deadline already passed —
        admission control: serving them would burn capacity on guaranteed
        SLO misses."""
        expired = [r for r in self._queue if r.slack(now) < 0]
        for r in expired:
            self._queue.remove(r)
            r.state = RequestState.REJECTED
            self._aff_cache.pop(r.rid, None)
        return expired

    # ------------------------------------------------------------------
    def _order(self, reqs: List[Request], now: float, store):
        """EDF first; inside a slack band, highest cache affinity first.
        `store` is any affinity provider with `cache_affinity(table)` —
        an ExpertStore (residency only) or a PrefetchPipeline (residency
        plus in-flight uploads). Affinity is memoized per request against
        the provider's `affinity_epoch`: within one tick (and across ticks
        while residency is unchanged) each table is scanned at most once."""
        epoch = getattr(store, "affinity_epoch", None)

        def affinity(r: Request) -> float:
            hit = self._aff_cache.get(r.rid)
            if hit is not None and epoch is not None and hit[0] == epoch:
                return hit[1]
            aff = store.cache_affinity(r.table)
            self._aff_cache[r.rid] = (epoch, aff)
            return aff

        def key(r: Request):
            band = (
                r.slack(now) // self.slack_band_s
                if r.slo_s is not None
                else float("inf")
            )
            aff = 0.0
            if self.use_affinity and store is not None and r.table is not None:
                aff = affinity(r)
            return (band, -aff, r.arrival_s, r.rid)

        return sorted(reqs, key=key)

    def chunk_urgent(
        self, req: Request, now: float, remaining_chunks: int, chunk_s: float,
    ) -> bool:
        """Deadline accounting for chunked prefill: run the next chunk
        BEFORE this tick's decode when the request's remaining slack no
        longer covers the remaining chunks at the observed per-chunk rate
        (plus one slack band of margin). SLO-less requests are never
        urgent — their chunks always yield to decode progress."""
        if req.slo_s is None:
            return False
        need = remaining_chunks * max(chunk_s, 1e-4) + self.slack_band_s
        return req.slack(now) < need

    def next_prefill_batch(
        self,
        now: float,
        max_batch: int,
        store: Optional[ExpertStore] = None,  # or PrefetchPipeline (duck-typed)
    ) -> Tuple[List[Request], int]:
        """Compose the next prefill batch: the most urgent request anchors
        it, its length bucket fixes the padded shape, and remaining slots
        fill from the same bucket in deadline/affinity order. Returns
        (requests, bucket) — ([], 0) when nothing is ready."""
        ready = [r for r in self._queue if r.table is not None]
        if not ready or max_batch <= 0:
            return [], 0
        ordered = self._order(ready, now, store)
        anchor = ordered[0]
        bucket = bucket_len(anchor.prompt_len, self.buckets)
        batch = [
            r for r in ordered if bucket_len(r.prompt_len, self.buckets) == bucket
        ][:max_batch]
        for r in batch:
            self._queue.remove(r)
            r.state = RequestState.PREFILL
            self._aff_cache.pop(r.rid, None)
        return batch, bucket


class AdmissionController:
    """Overload shedding at the admission gate.

    The estimate is classic back-of-queue wait: `queue depth × EMA of
    observed per-request service time`. A request is shed (rejected with
    reason `overloaded`) when that estimate exceeds `margin` of its
    remaining slack — i.e. when, at the observed service rate, the request
    would already have missed its deadline before reaching a lane. Shedding
    at admission is the whole point: reject BEFORE burning prefill/decode
    capacity on a guaranteed SLO miss, not after (`pop_expired` is the
    too-late backstop).

    Hysteresis: crossing the threshold latches the gate; it stays latched
    until the estimate falls below `exit_frac` of a request's threshold, so
    the admit/shed decision cannot chatter around the boundary while the
    queue hovers at critical depth.

    Degraded transfer shards (the prefetch pipeline's sync-fallback mode —
    see core/offload.py) shrink the threshold by the degraded fraction:
    when uploads have lost their overlap, true service times are about to
    rise, so faults translate into earlier rejections instead of letting
    admitted requests pile into SLO collapse.

    Requests without an SLO fall back to `default_slo_s` slack; with
    neither, they are never shed (there is no deadline to protect)."""

    def __init__(
        self,
        margin: float = 0.8,          # shed when est. wait > margin × slack
        exit_frac: float = 0.6,       # un-latch below exit_frac × threshold
        ema_decay: float = 0.8,       # service-time EMA (new obs weight 1-d)
        init_service_s: float = 0.0,  # prior before the first completion
        default_slo_s: Optional[float] = None,
        degraded_shrink: float = 0.5, # threshold ×= (1 - shrink × degraded)
    ):
        self.margin = margin
        self.exit_frac = exit_frac
        self.ema_decay = ema_decay
        self.service_s = init_service_s
        self.default_slo_s = default_slo_s
        self.degraded_shrink = degraded_shrink
        self.shedding = False         # the hysteresis latch

    def observe(self, service_s: float) -> None:
        """Feed one completed request's service time (prefill -> done)."""
        if self.service_s <= 0.0:
            self.service_s = service_s
        else:
            self.service_s = (
                self.ema_decay * self.service_s
                + (1.0 - self.ema_decay) * service_s
            )

    def est_wait_s(self, depth: int) -> float:
        return depth * self.service_s

    def should_shed(
        self, depth: int, slack_s: Optional[float], degraded_frac: float = 0.0
    ) -> bool:
        """Decide one admission. `slack_s` is the request's remaining
        deadline slack (None = no SLO). Updates the hysteresis latch."""
        if slack_s is None:
            slack_s = self.default_slo_s
        if slack_s is None or self.service_s <= 0.0:
            return False
        thr = self.margin * max(slack_s, 0.0)
        thr *= max(0.0, 1.0 - self.degraded_shrink * degraded_frac)
        est = self.est_wait_s(depth)
        shed = est > (self.exit_frac * thr if self.shedding else thr)
        self.shedding = shed
        return shed

    def clone(self) -> "AdmissionController":
        """A fresh controller with the same policy hyperparameters but its
        own EMA state and hysteresis latch (the per-tenant split)."""
        return AdmissionController(
            margin=self.margin,
            exit_frac=self.exit_frac,
            ema_decay=self.ema_decay,
            init_service_s=0.0,
            default_slo_s=self.default_slo_s,
            degraded_shrink=self.degraded_shrink,
        )


# ----------------------------------------------------------------------
# multi-tenant front door: weighted fair queueing above EDF + affinity
# ----------------------------------------------------------------------
class TenantState:
    """Runtime scheduling state for one tenant: the DRR deficit counter and
    the generated-token rate bucket."""

    def __init__(self, cfg: TenantConfig):
        self.cfg = cfg
        self.deficit = 0.0
        # token bucket for the generated-token rate budget; starts full so
        # a tenant's first burst is not throttled by an empty ledger
        self.bucket_cap = cfg.burst if cfg.burst > 0 else cfg.token_rate
        self.tokens = self.bucket_cap
        self.last_refill: Optional[float] = None

    def refill(self, now: float) -> None:
        if self.cfg.token_rate <= 0:
            return
        if self.last_refill is None:
            self.last_refill = now
            return
        dt = max(0.0, now - self.last_refill)
        self.tokens = min(self.bucket_cap, self.tokens + dt * self.cfg.token_rate)
        self.last_refill = now

    def throttled(self, now: float) -> bool:
        """True when the tenant's generated-token budget is exhausted —
        its queued requests DEFER (never drop) until the bucket refills."""
        if self.cfg.token_rate <= 0:
            return False
        self.refill(now)
        return self.tokens <= 0.0

    def debit(self, n_tokens: int, now: float) -> None:
        """Charge generated tokens against the rate budget. The balance may
        go negative (a request in flight keeps decoding); the debt defers
        the tenant's NEXT prefill until refill pays it back."""
        if self.cfg.token_rate <= 0:
            return
        self.refill(now)
        self.tokens -= float(n_tokens)


class WFQScheduler(Scheduler):
    """Deficit-round-robin weighted fair queueing over per-tenant queues,
    sitting ABOVE the existing EDF + cache-affinity order.

    Two-level decision: DRR picks WHICH tenant the next prefill batch is
    drawn from (long-run service proportional to `TenantConfig.weight`,
    independent of offered load); within the chosen tenant the inherited
    `_order` ranks requests exactly as the single-tenant scheduler does
    (deadline bands, then cache affinity). A batch is therefore always
    single-tenant — bucket padding and attribution stay simple.

    Starvation-freedom: every scheduling round adds `quantum x weight` to
    each active tenant's deficit counter, so any head request's finite cost
    (padded prefill tokens + decode budget) is eventually covered no matter
    how much traffic heavier tenants offer; the round-robin pointer rotates
    so ties break fairly. A tenant's deficit resets when its queue drains
    (the DRR rule that prevents banking unused service into a future burst).

    Token-rate budgets: tenants whose generated-token bucket is empty are
    skipped (their requests defer, never drop) until `debit`-ed tokens are
    paid back by refill — the server debits per generated token."""

    def __init__(
        self,
        tenants: Sequence[TenantConfig],
        quantum: float = 64.0,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        use_affinity: bool = True,
        slack_band_s: float = SLACK_BAND_S,
    ):
        super().__init__(
            buckets=buckets, use_affinity=use_affinity, slack_band_s=slack_band_s
        )
        self.quantum = quantum
        self.tenants: Dict[str, TenantState] = {
            t.name: TenantState(t) for t in tenants
        }
        self._queues: Dict[str, List[Request]] = {
            t.name: [] for t in tenants
        }
        self._rr: List[str] = [t.name for t in tenants]
        self._rr_pos = 0

    # ------------------------------------------------------------------
    def _ensure(self, name: str) -> TenantState:
        st = self.tenants.get(name)
        if st is None:
            # unknown tenants get a default contract (weight 1, unlimited)
            # rather than a crash at admission; the registry is advisory
            st = TenantState(TenantConfig(name=name))
            self.tenants[name] = st
            self._queues[name] = []
            self._rr.append(name)
        return st

    def enqueue(self, req: Request) -> None:
        self._ensure(req.tenant)
        req.state = RequestState.QUEUED
        self._queues[req.tenant].append(req)

    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def pending_tenant(self, name: str) -> int:
        return len(self._queues.get(name, ()))

    def pop_expired(self, now: float) -> List[Request]:
        expired: List[Request] = []
        for q in self._queues.values():
            dead = [r for r in q if r.slack(now) < 0]
            for r in dead:
                q.remove(r)
                r.state = RequestState.REJECTED
                self._aff_cache.pop(r.rid, None)
            expired.extend(dead)
        return expired

    # ------------------------------------------------------------------
    @staticmethod
    def _cost(req: Request, bucket: int) -> float:
        """DRR service cost of one request: padded prefill tokens plus the
        decode budget it is entitled to generate."""
        return float(bucket + req.max_new_tokens)

    def debit(self, tenant: str, n_tokens: int, now: float) -> None:
        """Charge generated tokens to the tenant's rate bucket (the server
        calls this once per decode/verify tick with that tick's count)."""
        self._ensure(tenant).debit(n_tokens, now)

    def next_prefill_batch(
        self,
        now: float,
        max_batch: int,
        store: Optional[ExpertStore] = None,
    ) -> Tuple[List[Request], int]:
        if max_batch <= 0:
            return [], 0
        ready: Dict[str, List[Request]] = {}
        for name, q in self._queues.items():
            rs = [r for r in q if r.table is not None]
            if rs:
                ready[name] = rs
        if not ready:
            return [], 0
        # rate-throttled tenants defer; drop their deficit growth too so an
        # exhausted budget cannot bank priority for the moment it refills
        active = [
            n for n in self._rr
            if n in ready and not self.tenants[n].throttled(now)
        ]
        for name, st in self.tenants.items():
            if name not in ready:
                st.deficit = 0.0  # DRR: empty queue forfeits its deficit
        if not active:
            return [], 0
        # rotate so each call gives a different tenant first claim
        start = self._rr_pos % len(self._rr)
        order = [n for n in self._rr[start:] + self._rr[:start] if n in active]
        # per-tenant EDF+affinity heads, computed once
        heads: Dict[str, Tuple[List[Request], int, float]] = {}
        for name in order:
            ranked = self._order(ready[name], now, store)
            bucket = bucket_len(ranked[0].prompt_len, self.buckets)
            heads[name] = (ranked, bucket, self._cost(ranked[0], bucket))
        # each full round adds quantum x weight to every active tenant, so
        # the cheapest head is reachable within bounded rounds
        min_gain = min(
            self.quantum * self.tenants[n].cfg.weight for n in order
        )
        max_cost = max(h[2] for h in heads.values())
        for _ in range(int(max_cost / max(min_gain, 1e-9)) + 2):
            for name in order:
                st = self.tenants[name]
                st.deficit += self.quantum * st.cfg.weight
                ranked, bucket, cost = heads[name]
                if st.deficit < cost:
                    continue
                batch: List[Request] = []
                for r in ranked:
                    if len(batch) >= max_batch:
                        break
                    if bucket_len(r.prompt_len, self.buckets) != bucket:
                        continue
                    c = self._cost(r, bucket)
                    if batch and st.deficit < c:
                        break
                    st.deficit -= c
                    batch.append(r)
                q = self._queues[name]
                for r in batch:
                    q.remove(r)
                    r.state = RequestState.PREFILL
                    self._aff_cache.pop(r.rid, None)
                if not q:
                    st.deficit = 0.0
                self._rr_pos = (self._rr.index(name) + 1) % len(self._rr)
                return batch, bucket
        return [], 0  # unreachable: the round bound covers max_cost


class TenantAdmission:
    """The tenant-aware split of the overload-shedding gate: one
    `AdmissionController` clone per tenant, so queue-depth estimates and
    service-time EMAs are tracked per tenant and one tenant's overload
    sheds ONLY that tenant's requests. Tenants with a `default_slo_s` in
    their contract shed against that deadline even when individual
    requests carry none."""

    def __init__(
        self,
        template: AdmissionController,
        tenants: Sequence[TenantConfig] = (),
    ):
        self._template = template
        self._by_tenant: Dict[str, AdmissionController] = {}
        for t in tenants:
            ctl = template.clone()
            if t.default_slo_s is not None:
                ctl.default_slo_s = t.default_slo_s
            self._by_tenant[t.name] = ctl

    def controller(self, tenant: str) -> AdmissionController:
        ctl = self._by_tenant.get(tenant)
        if ctl is None:
            ctl = self._template.clone()
            self._by_tenant[tenant] = ctl
        return ctl

    def observe(self, tenant: str, service_s: float) -> None:
        self.controller(tenant).observe(service_s)

    def should_shed(
        self,
        tenant: str,
        depth: int,
        slack_s: Optional[float],
        degraded_frac: float = 0.0,
    ) -> bool:
        """One admission decision against the TENANT's own queue depth and
        service-time history."""
        return self.controller(tenant).should_shed(depth, slack_s, degraded_frac)

    @property
    def shedding(self) -> bool:
        return any(c.shedding for c in self._by_tenant.values())
