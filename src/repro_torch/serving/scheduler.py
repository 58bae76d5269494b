"""Admission queue + continuous batcher (port of `repro/serving/scheduler.py`,
which is framework-free: `bucket_len`, `LaneTable`, `Scheduler` and
`AdmissionController` are copied as they are; the multi-tenant front door,
`TenantState`, `WFQScheduler` and `TenantAdmission`, comes with ROADMAP
A13(b)).

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
