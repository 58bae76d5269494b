"""One device budget, two demand-paged clients: expert slots and K/V pages
(port of `repro/core/residency.py`).

The `ExpertStore` manages expert slot pools with host backing; this module
applies the same machinery to decode-time K/V state:

* **K/V pages** — per attention sublayer one shared pool `kp` / `vp` of
  shape [G, P+1, page, K, D] (`models.transformer.init_paged_cache`),
  addressed through per-lane page tables (`KVPagePool`). Page P is the
  **trash page**: the pool is shared across lanes, so a masked-out lane's
  write is routed there, and no table entry ever names it. One page table
  [lanes, Mp] serves every layer: all layers cache the same positions, so
  entry i of lane b names the device page holding positions
  [i·page, (i+1)·page) in every pool at once. Cold pages spill to host
  memory and page back in when a tick needs them.

Two invariants the decode step relies on:

* **position-ordered allocation** — a lane's pages are allocated in
  position order, so a slot's global position is a function of its table
  index (i·page + j), and validity is "entry >= 0 ∧ causal ∧ window" with
  no stored positions;
* **pinned while read** — `ensure(pin=True)` pins every in-span page it
  makes resident, so another lane's allocation in the same tick cannot
  evict it; the caller unpins after the step.

Pages are ranked for eviction by the same policies as expert slots (α mass
by default: the decayed attention mass of the owning lane), and
`ResidencyManager.split_budget` / `split_budget_tiered` turn one byte budget
into expert slots (hot and warm) and K/V pages.

The port writes pages into the pool in place (the reference returns updated
copies). A page-in runs inline, or with `pipeline=` (a `PrefetchPipeline`)
its H2D copy rides the transfer thread's queue and side stream and `sync`
writes the arrived pages on the caller's stream after their fences. A long
prompt streams into a lane's pages chunk by chunk
(`transformer.prefill_chunk_step`, driven by the request server), with
`prefill_chunk` tokens a chunk. Bookkeeping is numpy, as in the reference;
the device copy of the table is refreshed only after it changed.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.offload import EVICTION_POLICIES
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import init_paged_cache, period, sub_kind


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class PagedKVConfig:
    """Geometry of the paged K/V cache.

    `kv_pages` is the device budget (pages shared by all lanes, without the
    trash page); `max_seq` is the addressable sequence length (table width ×
    page size), which may exceed what is resident: spilled pages live on
    the host."""

    page_size: int = 16
    kv_pages: int = 64
    prefill_chunk: int = 0  # chunked prefill: tokens a chunk (0 = off)
    max_seq: int = 0        # 0 => kv_pages * page_size (everything resident)

    @property
    def enabled(self) -> bool:
        return self.kv_pages > 0

    @property
    def seq_len(self) -> int:
        return self.max_seq or self.kv_pages * self.page_size

    def pages_per_lane(self) -> int:
        return -(-self.seq_len // self.page_size)


@dataclass
class KVPoolStats:
    allocs: int = 0
    spills: int = 0
    page_ins: int = 0
    bytes_spilled: int = 0
    bytes_paged_in: int = 0
    fence_wait_s: float = 0.0   # `sync` time blocked on page-in fences

    def summary(self) -> Dict[str, float]:
        return {
            "kv_pages_allocated": self.allocs,
            "kv_page_spills": self.spills,
            "kv_page_ins": self.page_ins,
            "kv_bytes_spilled": self.bytes_spilled,
            "kv_bytes_paged_in": self.bytes_paged_in,
            "kv_fence_wait_s": self.fence_wait_s,
        }


def _page_write(pool: torch.Tensor, pid: int, data) -> None:
    """pool [G, P+1, page, K, D] <- data [G, page, K, D] at page `pid`, in
    place."""
    pool[:, pid] = torch.as_tensor(data).to(device=pool.device, dtype=pool.dtype)


# ---------------------------------------------------------------------------
# K/V page pool
# ---------------------------------------------------------------------------
class KVPagePool:
    """Host-side bookkeeping for the device K/V page pool.

    Methods take the cache dict and return it, as the reference's do; the
    pools inside are written in place. The page table lives here as numpy
    and is mirrored to a device tensor (`device_table`) that the caller
    installs as `cache["page_table"]` after any change."""

    def __init__(
        self,
        cfg: ModelConfig,
        paged: PagedKVConfig,
        n_lanes: int,
        eviction: str = "alpha",
        pipeline=None,
        device: DeviceLike = None,
    ):
        if cfg.block_kind != "attn" or cfg.enc_dec:
            raise ValueError("paged K/V supports attention-family decoder-only archs")
        if paged.kv_pages < 1 or paged.page_size < 1:
            raise ValueError(f"paged K/V needs at least one page of one slot: {paged}")
        self.cfg = cfg
        self.paged = paged
        self.device = resolve_device(device)
        self.page = paged.page_size
        self.n_pages = paged.kv_pages           # excludes the trash page
        self.trash = paged.kv_pages             # trash page id == pool index P
        self.n_lanes = n_lanes
        self.Mp = paged.pages_per_lane()
        per = period(cfg)
        self.kv_subs = [s for s in range(per) if sub_kind(cfg, s)["kind"] == "attn"]
        self.n_groups = cfg.n_layers // per
        windows = [cfg.layer_window(s) for s in range(cfg.n_layers)]
        # residency span: 0 = full attention (every allocated page must stay
        # resident); else only pages reaching back `span` positions are read
        self.span = 0 if any(w == 0 for w in windows) else max(windows)
        self.policy = EVICTION_POLICIES[eviction]()
        self.stats = KVPoolStats()
        self.table = np.full((n_lanes, self.Mp), -1, np.int32)
        self._free: List[int] = list(range(self.n_pages))
        self._owner: Dict[int, Tuple[int, int]] = {}
        self._spill: Dict[Tuple[int, int], Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = {}
        self._pinned: set = set()
        self._lock = threading.RLock()
        self._dev_table: Optional[torch.Tensor] = None
        self.pipeline = pipeline
        self._fences: List[threading.Event] = []
        # (lane, page_idx, pid) -> ({sub: (k, v) on the device}, CUDA event)
        self._arrived: Dict[Tuple[int, int, int], tuple] = {}

    # -- geometry / accounting -----------------------------------------
    def page_bytes(self) -> int:
        """Device bytes of one page across every layer pool (K and V)."""
        itm = torch.empty((), dtype=getattr(torch, self.cfg.dtype)).element_size()
        return (len(self.kv_subs) * self.n_groups
                * self.page * self.cfg.n_kv_heads * self.cfg.hd * itm * 2)

    def kv_pool_bytes(self) -> int:
        """Bytes held by currently resident pages (pages × page bytes)."""
        return (self.n_pages - len(self._free)) * self.page_bytes()

    def capacity_bytes(self) -> int:
        """Device footprint of the pools, trash page included."""
        return (self.n_pages + 1) * self.page_bytes()

    def resident_pages(self) -> int:
        return self.n_pages - len(self._free)

    # -- device mirrors -------------------------------------------------
    def device_table(self) -> torch.Tensor:
        """The table as an int32 tensor on the device, copied only after it
        changed."""
        if self._dev_table is None:
            self._dev_table = torch.from_numpy(self.table.copy()).to(self.device)
        return self._dev_table

    def _invalidate(self) -> None:
        self._dev_table = None

    def init_cache(self) -> dict:
        cache = init_paged_cache(self.cfg, self.n_lanes, self.paged, device=self.device)
        cache["page_table"] = self.device_table()
        return cache

    def touch_lane(self, lane: int, pos: int, weight: float = 1.0) -> None:
        """Credit α mass to the lane's in-window pages, so a decoding lane's
        working set ranks above stale pages."""
        with self._lock:
            npages = pos // self.page + 1
            lo = 0 if not self.span else max(0, pos - self.span) // self.page
            for i in range(lo, min(npages, self.Mp)):
                pid = int(self.table[lane, i])
                if pid >= 0:
                    self.policy.touch(pid, weight)

    # -- allocation / spill / page-in -----------------------------------
    def _victim(self) -> int:
        v = self.policy.pick_victim(set(self._pinned))
        if v is None:
            raise RuntimeError(
                "KV page pool exhausted: every resident page is pinned "
                f"({len(self._pinned)} pinned / {self.n_pages} pages)"
            )
        return v

    def alloc(self, cache: dict, lane: int, page_idx: int, weight: float = 1.0):
        """Allocate a device page for (lane, page_idx), spilling the coldest
        unpinned page when none is free. Returns (cache, page_id)."""
        with self._lock:
            if self.table[lane, page_idx] >= 0:
                raise ValueError(f"page ({lane}, {page_idx}) already allocated")
            if not self._free:
                victim = self._victim()
                cache = self.spill(cache, *self._owner[victim])
            pid = self._free.pop()
            self.table[lane, page_idx] = pid
            self._owner[pid] = (lane, page_idx)
            self.policy.admit(pid, weight)
            self.stats.allocs += 1
            self._invalidate()
        return cache, pid

    def spill(self, cache: dict, lane: int, page_idx: int) -> dict:
        """Evict (lane, page_idx) to host memory. The device page keeps its
        bytes until it is reused: no table entry names it any more, and the
        decode step's validity masking never reads it."""
        with self._lock:
            pid = int(self.table[lane, page_idx])
            if pid < 0:
                raise ValueError(f"page ({lane}, {page_idx}) is not resident")
            if pid in self._pinned:
                raise ValueError("cannot spill a pinned page")
            self._spill[(lane, page_idx)] = {
                f"sub{s}": (cache[f"sub{s}"]["kp"][:, pid].to("cpu", copy=True),
                            cache[f"sub{s}"]["vp"][:, pid].to("cpu", copy=True))
                for s in self.kv_subs
            }
            self.table[lane, page_idx] = -1
            del self._owner[pid]
            self.policy.forget(pid)
            self._free.append(pid)
            self.stats.spills += 1
            self.stats.bytes_spilled += self.page_bytes()
            self._invalidate()
        return cache

    def page_in(self, cache: dict, lane: int, page_idx: int) -> dict:
        """Bring a spilled page back. Without a pipeline the upload runs
        inline; with one, its H2D copy rides the transfer queue (the urgent
        class) and the caller must `sync` before the next step reads it."""
        cache, pid = self.alloc(cache, lane, page_idx)
        data = self._spill.pop((lane, page_idx))
        self.stats.page_ins += 1
        self.stats.bytes_paged_in += self.page_bytes()
        if self.pipeline is None:
            for skey, (k_host, v_host) in data.items():
                _page_write(cache[skey]["kp"], pid, k_host)
                _page_write(cache[skey]["vp"], pid, v_host)
            return cache
        pipe, dev = self.pipeline, self.device

        def stage(key=(lane, page_idx, pid), data=data):
            # on the transfer thread: the copies go on its side stream
            staged = {skey: (k.to(dev, non_blocking=True), v.to(dev, non_blocking=True))
                      for skey, (k, v) in data.items()}
            ev = pipe.record_event()
            with self._lock:
                self._arrived[key] = (staged, ev)

        self._fences.append(pipe.submit_job(stage, priority=0))
        return cache

    def sync(self, cache: dict) -> dict:
        """Wait the outstanding page-in fences, then write the arrived pages
        into the pools on the caller's stream, after the CUDA event of their
        copies: the paged analogue of a prefetch ticket's `wait`."""
        if self._fences:
            t0 = time.perf_counter()
            for ev in self._fences:
                ev.wait()
            self._fences = []
            self.stats.fence_wait_s += time.perf_counter() - t0
            self.pipeline._raise_if_failed()
        with self._lock:
            arrived, self._arrived = self._arrived, {}
        for (_, _, pid), (staged, ev) in arrived.items():
            if ev is not None:
                cur = torch.cuda.current_stream(self.device)
                cur.wait_event(ev)
            for skey, kv in staged.items():
                for name, t in zip(("kp", "vp"), kv):
                    if ev is not None:
                        t.record_stream(cur)   # made on the side stream, read on this one
                    _page_write(cache[skey][name], pid, t)
        return cache

    def ensure(
        self,
        cache: dict,
        lane: int,
        upto_pos: int,
        weight: float = 1.0,
        pin: bool = False,
        extra_span: int = 0,
    ) -> dict:
        """Make positions [0, upto_pos) of `lane` safe to read and write:
        allocate missing pages in position order and page spilled in-span
        pages back in; out-of-span spilled pages stay on the host.

        With `pin`, every in-span page is pinned as soon as it is resident,
        so a later allocation in the same tick cannot evict it; pressure
        beyond the pool then raises the pool-exhausted error instead of
        attending past a spilled page.

        `extra_span` widens the span for a multi-position step (a
        speculative verify block): the block's earliest query reads
        `window` back from the block's first position, `extra_span`
        positions before `upto_pos - 1`, so its in-window pages page back in
        and pin too. Full attention (span 0) keeps every page resident."""
        if upto_pos > self.Mp * self.page:
            raise ValueError(f"position {upto_pos} exceeds addressable range "
                             f"{self.Mp * self.page} (raise PagedKVConfig.max_seq)")
        npages = -(-upto_pos // self.page)
        if not self.span and npages > self.n_pages:
            # full attention reads every allocated position: refuse rather
            # than attend past spilled pages
            raise ValueError(
                f"full-attention working set ({npages} pages) exceeds the device pool "
                f"({self.n_pages} pages): raise kv_pages or use windowed attention layers"
            )
        lo = 0
        if self.span:
            lo = max(0, upto_pos - 1 - self.span - extra_span) // self.page
        with self._lock:
            if pin:
                # pin resident in-span pages before any alloc below could
                # evict one of them
                for i in range(lo, npages):
                    pid = int(self.table[lane, i])
                    if pid >= 0:
                        self._pinned.add(pid)
            for i in range(npages):
                if self.table[lane, i] < 0:
                    if (lane, i) in self._spill:
                        if i < lo:
                            continue  # out of span: stays on the host
                        cache = self.page_in(cache, lane, i)
                    else:
                        cache, _ = self.alloc(cache, lane, i, weight)
                if pin and i >= lo:
                    self._pinned.add(int(self.table[lane, i]))
        self.touch_lane(lane, upto_pos - 1, weight)
        return cache

    # -- lane lifecycle -------------------------------------------------
    def seed(self, cache: dict, lane: int, kv: Dict[str, tuple], length: int) -> dict:
        """Write a prefill's rope-applied K/V into the lane's pages. `kv`
        maps "sub{s}" -> (k, v) each [G, S, K, D] (numpy or tensors) with
        S >= length; the tail of the last page is zero-padded.

        The pages are pinned while they are allocated and written: an
        allocation under pressure could otherwise evict a page of this lane
        that holds nothing yet."""
        npages = -(-length // self.page)
        pinned_here: List[int] = []
        with self._lock:
            try:
                for i in range(npages):
                    if self.table[lane, i] < 0:
                        # a stale spill of this page is overwritten below
                        self._spill.pop((lane, i), None)
                        cache, _ = self.alloc(cache, lane, i)
                    pid = int(self.table[lane, i])
                    if pid not in self._pinned:
                        self._pinned.add(pid)
                        pinned_here.append(pid)
                for s in self.kv_subs:
                    skey = f"sub{s}"
                    for name, src in zip(("kp", "vp"), kv[skey]):
                        src = torch.as_tensor(src)
                        blk = src.new_zeros((src.shape[0], npages * self.page, *src.shape[2:]))
                        blk[:, :length] = src[:, :length]
                        for i in range(npages):
                            pid = int(self.table[lane, i])
                            _page_write(cache[skey][name], pid,
                                        blk[:, i * self.page:(i + 1) * self.page])
            finally:
                for pid in pinned_here:
                    self._pinned.discard(pid)
        return cache

    def release_lane(self, lane: int) -> None:
        """Free the lane's pages and drop its host spills (request done)."""
        with self._lock:
            for i in range(self.Mp):
                pid = int(self.table[lane, i])
                if pid >= 0:
                    self.table[lane, i] = -1
                    del self._owner[pid]
                    self.policy.forget(pid)
                    self._pinned.discard(pid)
                    self._free.append(pid)
            self._spill = {k: v for k, v in self._spill.items() if k[0] != lane}
            self._invalidate()

    def pin_lane(self, lane: int) -> None:
        """Pin the lane's resident pages."""
        with self._lock:
            self._pinned.update(int(p) for p in self.table[lane] if p >= 0)

    def unpin_lane(self, lane: int) -> None:
        with self._lock:
            for p in self.table[lane]:
                if p >= 0:
                    self._pinned.discard(int(p))

    def unpin_all(self) -> None:
        with self._lock:
            self._pinned.clear()


# ---------------------------------------------------------------------------
# one budget over both pools
# ---------------------------------------------------------------------------
class ResidencyManager:
    """One device budget over expert slots and K/V pages. The pools are
    statically shaped, so arbitration is a byte split at construction
    (`split_budget`, in proportion to the α mass each class is predicted to
    absorb) plus spill pressure at run time, where both pools rank victims
    by decayed α mass. The paged request server fronts its live store and
    pool with one instance and reports its `summary`."""

    def __init__(self, store, kv_pool: KVPagePool):
        self.store = store
        self.kv_pool = kv_pool

    def device_bytes(self) -> int:
        """Device bytes of both pools: expert slots, and K/V pages with the
        trash page."""
        return self.store.device_bytes() + self.kv_pool.capacity_bytes()

    def resident_bytes(self) -> int:
        """Bytes holding live data now: the expert slots and the resident
        K/V pages."""
        return self.store.device_bytes() + self.kv_pool.kv_pool_bytes()

    def summary(self) -> Dict[str, float]:
        out = dict(self.kv_pool.stats.summary())
        out["kv_pool_bytes"] = self.kv_pool.kv_pool_bytes()
        out["kv_capacity_bytes"] = self.kv_pool.capacity_bytes()
        out["expert_device_bytes"] = self.store.device_bytes()
        return out

    @staticmethod
    def split_budget(
        total_bytes: int,
        expert_slot_bytes: int,
        page_bytes: int,
        n_moe_layers: int,
        expert_mass: float = 1.0,
        kv_mass: float = 1.0,
        min_slots: int = 1,
        min_pages: int = 1,
    ) -> Tuple[int, int]:
        """Split one device budget into (slots_per_moe_layer, kv_pages) in
        proportion to the predicted α mass of each class (equal masses: a
        50/50 byte split). The floors keep both pools working."""
        if not (total_bytes > 0 and expert_slot_bytes > 0 and page_bytes > 0):
            raise ValueError("split_budget needs positive byte counts")
        layers = max(n_moe_layers, 1)
        floor = min_slots * expert_slot_bytes * layers + (min_pages + 1) * page_bytes
        if total_bytes < floor:
            raise ValueError(f"budget {total_bytes}B below the functional floor {floor}B")
        kv_share = kv_mass / max(expert_mass + kv_mass, 1e-9)
        kv_budget = int(total_bytes * kv_share)
        pages = max(min_pages, kv_budget // page_bytes - 1)  # -1: trash page
        while ((pages + 1) * page_bytes + min_slots * expert_slot_bytes * layers > total_bytes
               and pages > min_pages):
            pages -= 1
        left = total_bytes - (pages + 1) * page_bytes
        slots = max(min_slots, left // (expert_slot_bytes * layers))
        return int(slots), int(pages)

    @staticmethod
    def split_budget_tiered(
        total_bytes: int,
        hot_slot_bytes: int,
        warm_slot_bytes: int,
        page_bytes: int,
        n_moe_layers: int,
        tier_split: float = 0.5,
        expert_mass: float = 1.0,
        kv_mass: float = 1.0,
        min_slots: int = 1,
        min_pages: int = 1,
    ) -> Tuple[int, int, int]:
        """`split_budget` with the expert share split further: `tier_split`
        of it as int8 hot slots, the rest as int4 warm slots (bytes from
        `ExpertStore.tier_slot_bytes`). Returns (hot, warm, kv_pages)."""
        if not 0.0 < tier_split <= 1.0:
            raise ValueError(f"tier_split {tier_split} must be in (0, 1]")
        if warm_slot_bytes <= 0:
            raise ValueError("warm_slot_bytes must be positive")
        hot, pages = ResidencyManager.split_budget(
            total_bytes, hot_slot_bytes, page_bytes, n_moe_layers,
            expert_mass=expert_mass, kv_mass=kv_mass,
            min_slots=min_slots, min_pages=min_pages,
        )
        hot8 = max(min_slots, int(round(hot * tier_split)))
        warm4 = int((hot - hot8) * hot_slot_bytes // warm_slot_bytes)
        return int(hot8), int(warm4), int(pages)
