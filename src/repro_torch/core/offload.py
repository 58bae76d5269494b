"""Expert offloading: host-resident expert store + device slot cache
(port of the synchronous, one-shard case of `repro/core/offload.py`).

The full expert stacks live in host memory as CPU tensors, in the model
dtype or, with `host_quant="int8"`, as symmetric int8 with fp32 scale planes
(`quantize_expert`, bit-identical to the reference's numpy). On the device
each MoE layer owns a fixed pool of `S` slots, `[G, S, ...]`: fp slots
(int8 host rows are dequantised on the device as they land), or with
`quantized_slots` int8 pools plus `w_*_scale` planes `[G, S, 1, d_out]`
that the int8 expert FFN reads as they are. `prepare` loads exactly the
experts a hash table predicts, evicting under the slot budget by the chosen
policy, and returns the expert -> slot translation table that the routing
override addresses; `translate` (host) and `translate_device` (decode) turn
it into slot ids and renormalised weights. Routers never reach the device.

One shard, no int4 tier, no replicas and no prefetcher: the int4 warm tier
(ROADMAP A11-int4), the async prefetch pipeline (A9) and expert-parallel
shards (A14) come in later slices. The slot bookkeeping is the reference's,
so the same table stream gives the same resident sets, evictions, hits,
translations and byte counts.
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


def quantize_expert(
    w: np.ndarray, granularity: str = "channel"
) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric int8 quantisation. w: [..., d_in, d_out].

    granularity="channel": one scale per output channel (absmax over d_in).
    granularity="tensor": one scale per expert tensor (absmax over both
    trailing axes). Either way the scale is returned as a [..., 1, d_out]
    per-channel plane. The reference's numpy, so the masters are
    bit-identical to its."""
    if granularity == "tensor":
        absmax = np.abs(w).max(axis=(-2, -1), keepdims=True).astype(np.float32)
        absmax = np.broadcast_to(
            absmax, w.shape[:-2] + (1, w.shape[-1])
        ).copy()
    else:
        if granularity != "channel":
            raise ValueError(f"unknown scale granularity {granularity!r}")
        absmax = np.abs(w).max(axis=-2, keepdims=True).astype(np.float32)
    scale = np.maximum(absmax, 1e-8) / 127.0
    q = np.clip(np.round(w.astype(np.float32) / scale), -127, 127).astype(np.int8)
    return q, scale


def expert_format_bytes(shapes: List[Tuple[int, int]], fmt: str, group: int = 64) -> int:
    """Per-expert device bytes per MoE layer for one residency format, scale
    planes included. `shapes` lists the (d_in, d_out) of each expert tensor
    (w_in, w_gate, w_out)."""
    tot = 0
    for k, n in shapes:
        if fmt == "int8":
            tot += k * n + 4 * n                    # int8 rows + [1, n] f32 scale
        elif fmt == "int4":
            g = min(group, k)
            g = g if k % g == 0 else k              # repro offload._group_of
            tot += ((k + 1) // 2) * n + 4 * (k // g) * n
        else:
            raise ValueError(f"unknown residency format {fmt!r}")
    return tot


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
        host_quant: str = "none",      # "none" | "int8" (host masters)
        quantized_slots: Optional[bool] = None,    # None => cfg.quant
        scale_granularity: Optional[str] = None,   # None => cfg.quant
    ):
        if not cfg.moe.enabled:
            raise ValueError("ExpertStore requires an MoE config")
        if eviction not in EVICTION_POLICIES:
            raise ValueError(f"unknown eviction policy {eviction!r}")
        if host_quant not in ("none", "int8"):
            raise ValueError(f"unknown host_quant {host_quant!r}")
        if cfg.quant.tier.enabled:
            raise NotImplementedError("the int4 warm tier is ported in ROADMAP A11-int4")
        self.quantized_slots = (
            cfg.quant.quantized_slots if quantized_slots is None else quantized_slots
        )
        self.scale_granularity = scale_granularity or cfg.quant.scale_granularity
        if self.quantized_slots:
            host_quant = "int8"  # int8 residency requires the int8 host tier
        self.quant = host_quant
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
        self.host_scale: Dict[str, Dict[str, torch.Tensor]] = {}
        serve_params = tree_map(lambda x: x, params)   # fresh dicts, same leaves
        for s in self.moe_subs:
            moe_p = serve_params["blocks"][f"sub{s}"]["moe"]
            self.host[f"sub{s}"] = {}
            self.host_scale[f"sub{s}"] = {}
            for t in EXPERT_TENSORS:
                full = moe_p[t]
                if self.quant == "int8":
                    # fp32 numpy of the master: abs-max and division give the
                    # reference's bits for fp32 and bf16 weights alike
                    q, scale = quantize_expert(
                        full.detach().to("cpu", torch.float32).numpy(), self.scale_granularity
                    )
                    self.host[f"sub{s}"][t] = torch.from_numpy(q)
                    self.host_scale[f"sub{s}"][t] = torch.from_numpy(scale)
                else:
                    self.host[f"sub{s}"][t] = full.detach().to("cpu")
                G = full.shape[0]
                if self.quantized_slots:
                    # the residency format is the transfer format: int8 rows
                    # and their scale plane land as they are
                    moe_p[t] = torch.zeros(
                        (G, self.S, *full.shape[2:]), dtype=torch.int8, device=self.device,
                    )
                    moe_p[t + "_scale"] = torch.zeros(
                        (G, self.S, 1, full.shape[-1]), dtype=torch.float32, device=self.device,
                    )
                else:
                    moe_p[t] = torch.zeros(
                        (G, self.S, *full.shape[2:]), dtype=full.dtype, device=self.device,
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
        """Bytes of expert slot pools resident on the device (the paper's
        metric), scale planes included when the slots are int8."""
        tot = 0
        for s in self.moe_subs:
            moe_p = self.serve_params["blocks"][f"sub{s}"]["moe"]
            for t in EXPERT_TENSORS:
                for key in (t, t + "_scale"):
                    if key in moe_p:
                        tot += nbytes(moe_p[key])
        return tot

    def expert_slot_bytes(self) -> int:
        """Device bytes one expert slot costs per MoE layer in the residency
        format (fp, or int8 + scale planes) — the denominator of the
        capacity-at-equal-bytes comparison."""
        tot = 0
        for s in self.moe_subs:
            moe_p = self.serve_params["blocks"][f"sub{s}"]["moe"]
            for t in EXPERT_TENSORS:
                for key in (t, t + "_scale"):
                    if key in moe_p:
                        arr = moe_p[key]
                        tot += nbytes(arr) // (arr.shape[0] * arr.shape[1])
        return tot // len(self.moe_subs)

    def full_expert_bytes(self) -> int:
        """Bytes of the host masters, as the reference counts them: int8
        masters without their scale planes."""
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

        Three formats, as the reference: int8 rows and scale planes landing
        as they are (quantized slots); int8 rows + scales uploaded and
        dequantised on the device into fp slots (`host_quant="int8"`, half
        the H2D bytes of bf16); fp rows.

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

        def write(key: str, vals: torch.Tensor) -> None:
            pool = moe_p[key]
            pool.view(-1, *pool.shape[2:]).index_copy_(0, rows, vals)

        for t in EXPERT_TENSORS:
            w_host = self.host[f"sub{s}"][t][gs, es]              # [n, d, f]
            if self.quant == "int8":
                scale = self.host_scale[f"sub{s}"][t][gs, es]     # [n, 1, f]
                self.stats.bytes_h2d += nbytes(w_host) + nbytes(scale)
                q, sc = w_host.to(self.device), scale.to(self.device)
                if self.quantized_slots:
                    write(t, q)
                    write(t + "_scale", sc)
                else:   # the reference's _pool_set_q: dequantise at slot write
                    write(t, (q.float() * sc).to(moe_p[t].dtype))
            else:
                self.stats.bytes_h2d += nbytes(w_host)
                write(t, w_host.to(self.device))

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

    def translate_device(self, ids: torch.Tensor, w: torch.Tensor, trans: np.ndarray):
        """`translate` on the device, for the decode loop: the predictor's
        still-resident ids / α [L, B, S, k] plus the host-planned table
        [L, E] -> (slot_ids int32, weights fp32) on ids' device, with the
        same miss zeroing and renormalisation. One shard, no replicas: each
        expert has one candidate slot (the reference's R = 1)."""
        L = ids.shape[0]
        cand = torch.from_numpy(trans).to(ids.device)
        slots = torch.gather(cand, 1, ids.reshape(L, -1).long()).reshape(ids.shape)
        wz = w.float()
        masked = wz * (slots >= 0)
        orig = wz.sum(dim=-1, keepdim=True)
        surv = masked.sum(dim=-1, keepdim=True)
        scale = torch.where(surv > 0, orig / torch.clamp(surv, min=1e-12), torch.ones_like(surv))
        return torch.clamp(slots, min=0).to(torch.int32), masked * scale
