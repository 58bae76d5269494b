"""Expert offloading: host-resident expert store + device slot cache
(port of the plain case of `repro/core/offload.py`).

The full expert stacks live in host memory as CPU tensors. On the device
each MoE layer owns a fixed pool of `S` slots, `[G, S, ...]`. `prepare`
loads exactly the experts a hash table predicts, evicting under the slot
budget by the chosen policy, and returns the expert -> slot translation
table that the routing override addresses. Routers never reach the device.

The plain case only: fp slots, one shard, no tiers, no replicas and no
prefetcher. int8/int4 residency (ROADMAP A11), the async prefetch pipeline
(A9) and expert-parallel shards (A14) come in later slices. The slot
bookkeeping is the reference's, so the same table stream gives the same
resident sets, evictions, hits and translations.
"""
from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hash_table import HashTable
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import n_moe_layers, period, sub_kind
from repro_torch.tree import tree_map

EXPERT_TENSORS = ("w_in", "w_gate", "w_out")


class EvictionPolicy:
    """Replacement policy for one (group, sub) slot pool.

    The store calls `admit` when an expert is loaded, `touch` on every hit
    (with the α mass it carried), and `pick_victim` when a slot must be
    reclaimed, passing the experts that must survive (needed + pinned).
    `pick_victim` returns None when every resident is protected — the caller
    then drops the load instead of evicting."""

    name = "base"

    def admit(self, e: int, weight: float = 0.0) -> None:
        raise NotImplementedError

    def touch(self, e: int, weight: float = 0.0) -> None:
        pass

    def pick_victim(self, protected) -> Optional[int]:
        raise NotImplementedError


class FIFOPolicy(EvictionPolicy):
    """Evict in insertion order (the paper's serving loop assumption)."""

    name = "fifo"

    def __init__(self):
        self.order: collections.deque = collections.deque()

    def admit(self, e: int, weight: float = 0.0) -> None:
        self.order.append(e)

    def pick_victim(self, protected) -> Optional[int]:
        for _ in range(len(self.order)):
            victim = self.order.popleft()
            if victim in protected:
                self.order.append(victim)  # recycle, try next
                continue
            return victim
        return None


class LRUPolicy(EvictionPolicy):
    """Evict the least-recently referenced expert."""

    name = "lru"

    def __init__(self):
        self.order: "collections.OrderedDict[int, None]" = collections.OrderedDict()

    def admit(self, e: int, weight: float = 0.0) -> None:
        self.order[e] = None
        self.order.move_to_end(e)

    def touch(self, e: int, weight: float = 0.0) -> None:
        if e in self.order:
            self.order.move_to_end(e)

    def pick_victim(self, protected) -> Optional[int]:
        for victim in self.order:
            if victim not in protected:
                del self.order[victim]
                return victim
        return None


class AlphaMassPolicy(EvictionPolicy):
    """Evict the expert with the least decayed α mass (the routing weight
    the hash tables send it)."""

    name = "alpha"

    def __init__(self, decay: float = 0.9):
        self.decay = decay
        self.score: Dict[int, float] = {}

    def admit(self, e: int, weight: float = 0.0) -> None:
        self.score[e] = self.score.get(e, 0.0) + max(weight, 1e-6)

    def touch(self, e: int, weight: float = 0.0) -> None:
        if e in self.score:
            self.score[e] = self.decay * self.score[e] + weight

    def pick_victim(self, protected) -> Optional[int]:
        best, best_s = None, None
        for e, sc in self.score.items():
            if e in protected:
                continue
            if best_s is None or sc < best_s:
                best, best_s = e, sc
        if best is not None:
            del self.score[best]
        return best


EVICTION_POLICIES = {"fifo": FIFOPolicy, "lru": LRUPolicy, "alpha": AlphaMassPolicy}


@dataclass
class TransferStats:
    bytes_h2d: int = 0
    loads: int = 0
    evictions: int = 0
    hits: int = 0
    dropped: int = 0               # planned loads dropped (every victim protected)
    prepare_time: float = 0.0      # synchronous upload time inside the forward path

    def reset(self):
        self.bytes_h2d = self.loads = self.evictions = self.hits = self.dropped = 0
        self.prepare_time = 0.0


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class ExpertStore:
    """Host store + device slot cache for every MoE layer of a model.

    `params` may live on any device: the expert stacks are copied to host
    masters, every other leaf is moved to `device`, routers are dropped."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        slots_per_layer: int,
        eviction: str = "fifo",        # "fifo" | "lru" | "alpha"
        device: DeviceLike = None,
    ):
        if not cfg.moe.enabled:
            raise ValueError("ExpertStore requires an MoE config")
        if eviction not in EVICTION_POLICIES:
            raise ValueError(f"unknown eviction policy {eviction!r}")
        if cfg.quant.quantized_slots or cfg.quant.tier.enabled:
            raise NotImplementedError("int8/int4 resident slots are ported in ROADMAP A11")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.per = period(cfg)
        self.n_groups = cfg.n_layers // self.per
        self.moe_subs = [s for s in range(self.per) if sub_kind(cfg, s)["moe"]]
        self.L = n_moe_layers(cfg)
        self.E = cfg.moe.num_experts
        self.S = min(slots_per_layer, self.E)
        self.eviction = eviction
        self.stats = TransferStats()

        # split params: experts -> host masters, routers dropped, the rest
        # (and empty slot pools) on the device
        self.host: Dict[str, Dict[str, torch.Tensor]] = {}
        serve_params = tree_map(lambda x: x, params)   # fresh dicts, same leaves
        for s in self.moe_subs:
            moe_p = serve_params["blocks"][f"sub{s}"]["moe"]
            self.host[f"sub{s}"] = {}
            for t in EXPERT_TENSORS:
                full = moe_p[t]
                self.host[f"sub{s}"][t] = full.detach().to("cpu")
                moe_p[t] = torch.zeros(
                    (full.shape[0], self.S, *full.shape[2:]), dtype=full.dtype, device=self.device,
                )
            moe_p.pop("router", None)  # routers never participate in the forward
        self.serve_params = tree_map(lambda x: x.to(self.device), serve_params)

        self.resident: Dict[Tuple[int, int], Dict[int, int]] = {}
        self.policy: Dict[Tuple[int, int], EvictionPolicy] = {}
        self.free: Dict[Tuple[int, int], List[int]] = {}
        self.pinned: Dict[Tuple[int, int], Set[int]] = {}
        for g in range(self.n_groups):
            for s in self.moe_subs:
                self.resident[(g, s)] = {}
                self.policy[(g, s)] = EVICTION_POLICIES[eviction]()
                self.free[(g, s)] = list(range(self.S))
                self.pinned[(g, s)] = set()
        self._lock = threading.RLock()

    # -- layer indexing: moe layer l = g * len(moe_subs) + j ----------------
    def layer_to_gs(self, l: int) -> Tuple[int, int]:
        j = l % len(self.moe_subs)
        return l // len(self.moe_subs), self.moe_subs[j]

    # ------------------------------------------------------------------
    def device_bytes(self) -> int:
        """Bytes of expert slot pools resident on the device (the paper's metric)."""
        return sum(
            nbytes(self.serve_params["blocks"][f"sub{s}"]["moe"][t])
            for s in self.moe_subs for t in EXPERT_TENSORS
        )

    def expert_slot_bytes(self) -> int:
        """Device bytes one expert slot costs per MoE layer."""
        tot = 0
        for s in self.moe_subs:
            for t in EXPERT_TENSORS:
                arr = self.serve_params["blocks"][f"sub{s}"]["moe"][t]
                tot += nbytes(arr) // (arr.shape[0] * arr.shape[1])
        return tot // len(self.moe_subs)

    def full_expert_bytes(self) -> int:
        return sum(nbytes(a) for sub in self.host.values() for a in sub.values())

    # ------------------------------------------------------------------
    def pin_experts(self, l: int, experts) -> Set[int]:
        """Mark experts at MoE layer `l` as never-evictable. They still load
        through the normal prepare path; they just cannot be victims."""
        g, s = self.layer_to_gs(l)
        with self._lock:
            new = {int(e) for e in experts}
            self.pinned[(g, s)].update(new)
            return new

    def unpin_experts(self, l: int, experts) -> None:
        g, s = self.layer_to_gs(l)
        with self._lock:
            for e in experts:
                self.pinned[(g, s)].discard(int(e))

    def plan_layer(
        self, l: int, needed: np.ndarray, mass: Optional[np.ndarray] = None,
    ) -> List[Tuple[int, int, int]]:
        """Cache bookkeeping for one layer; returns pending (g, slot, e) loads.

        `mass` ([E], optional) is the α mass the table routes to each expert,
        fed to the eviction policy."""
        g, s = self.layer_to_gs(l)
        res = self.resident[(g, s)]
        policy = self.policy[(g, s)]
        free = self.free[(g, s)]
        protected = {int(e) for e in needed} | self.pinned[(g, s)]
        pending: List[Tuple[int, int, int]] = []
        for e in needed:
            e = int(e)
            w = float(mass[e]) if mass is not None else 0.0
            if e in res:
                self.stats.hits += 1
                policy.touch(e, w)
                continue
            if free:
                slot = free.pop()
            else:
                victim = policy.pick_victim(protected)
                if victim is None:
                    self.stats.dropped += 1  # everything resident is protected
                    continue
                slot = res.pop(victim)
                self.stats.evictions += 1
            res[e] = slot
            policy.admit(e, w)
            pending.append((g, slot, e))
            self.stats.loads += 1
        return pending

    def commit_loads(self, s: int, items: List[Tuple[int, int, int]]) -> None:
        """Batched host -> device writes for sub-slot `s` (one per tensor).

        The pools are written in place (`index_copy_`). That is safe here:
        prepare and the forward that reads the slots run on one thread and
        one stream, so the copy is ordered before every later read. An async
        prefetcher (ROADMAP A9) will need copy-on-write or events instead."""
        if not items:
            return
        gs = torch.tensor([i[0] for i in items], dtype=torch.long)
        sl = torch.tensor([i[1] for i in items], dtype=torch.long)
        es = torch.tensor([i[2] for i in items], dtype=torch.long)
        rows = (gs * self.S + sl).to(self.device)
        moe_p = self.serve_params["blocks"][f"sub{s}"]["moe"]
        for t in EXPERT_TENSORS:
            w_host = self.host[f"sub{s}"][t][gs, es]              # [n, d, f]
            self.stats.bytes_h2d += nbytes(w_host)
            pool = moe_p[t]
            pool.view(-1, *pool.shape[2:]).index_copy_(0, rows, w_host.to(self.device))

    def trans_row(self, l: int) -> np.ndarray:
        g, s = self.layer_to_gs(l)
        row = np.full((self.E,), -1, np.int32)
        for e, slot in self.resident[(g, s)].items():
            row[e] = slot
        return row

    def prepare_layer(self, l: int, needed: np.ndarray) -> np.ndarray:
        """Synchronously load `needed` experts for one layer (OnDemand path)."""
        t0 = time.perf_counter()
        if len(needed) > self.S:
            needed = needed[: self.S]
        _, s = self.layer_to_gs(l)
        with self._lock:
            self.commit_loads(s, self.plan_layer(l, np.asarray(needed)))
            row = self.trans_row(l)
        self.stats.prepare_time += time.perf_counter() - t0
        return row

    def plan(self, table: HashTable):
        """Slot bookkeeping for a whole table (no device traffic).

        Returns (trans [L, E], pending {sub: [(g, slot, e)]}, needed {l: ids}).
        Caller must hold `_lock`."""
        trans = np.full((self.L, self.E), -1, np.int32)
        pending: Dict[int, List[Tuple[int, int, int]]] = {s: [] for s in self.moe_subs}
        needed_by_layer: Dict[int, np.ndarray] = {}
        for l in range(self.L):
            needed = table.active_experts(l)
            mass = None
            if len(needed) > self.S or self.eviction == "alpha":
                mass = table.activation_mass(l, self.E)
            if len(needed) > self.S:
                # tighter budget than the active set: keep the highest-α-mass
                needed = needed[np.argsort(-mass[needed])][: self.S]
            _, s = self.layer_to_gs(l)
            pending[s].extend(self.plan_layer(l, needed, mass=mass))
            needed_by_layer[l] = needed
            trans[l] = self.trans_row(l)
        return trans, pending, needed_by_layer

    def prepare(self, table: HashTable) -> np.ndarray:
        """Load the predicted experts for a whole batch; returns the
        translation table [L, E] expert -> slot (-1 = not resident). Uploads
        run inline, so their time lands in `stats.prepare_time`."""
        t0 = time.perf_counter()
        with self._lock:
            trans, pending, _ = self.plan(table)
            for s, items in pending.items():
                self.commit_loads(s, items)
        self.stats.prepare_time += time.perf_counter() - t0
        return trans

    # ------------------------------------------------------------------
    def cache_affinity(self, table: HashTable) -> float:
        """Fraction of the table's active experts already resident — the
        score for cache-aware batch ordering."""
        hits = tot = 0
        with self._lock:
            for l in range(self.L):
                res = self.resident[self.layer_to_gs(l)]
                for e in table.active_experts(l):
                    tot += 1
                    hits += int(int(e) in res)
        return hits / max(tot, 1)

    def translate(self, table: HashTable, trans: np.ndarray):
        """(slot_ids [L,B,S,k] int32, weights [L,B,S,k] f32).

        Predicted experts that missed residency get slot 0 and weight 0, and
        each token's surviving weights are renormalised to the α mass the
        hash function predicted; a token whose every expert missed keeps
        weight 0."""
        L, B, S, k = table.expert_ids.shape
        flat = table.expert_ids.reshape(L, -1)
        slots = np.take_along_axis(trans, flat, axis=1).reshape(L, B, S, k)
        w = table.weights * (slots >= 0)
        orig = table.weights.sum(axis=-1, keepdims=True)
        surv = w.sum(axis=-1, keepdims=True)
        scale = np.where(surv > 0, orig / np.maximum(surv, 1e-12), 1.0)
        w = w * scale
        return np.maximum(slots, 0).astype(np.int32), w.astype(np.float32)
