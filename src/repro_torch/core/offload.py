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

With a `TierConfig` (`int4_slots`) and int8-resident slots the pool splits
into a hot tier of `S8` int8 slots and a warm tier of `S4` nibble-packed
int4 slots (`w_*_q4` pools plus per-group `w_*_q4_scale` planes), addressed
as one slot space `[0, S8 + S4)`, hot first. A decayed α-mass EMA ranks tier
moves: a hot-tier miss demotes its victim into a warm slot instead of
evicting it, a warm hit promotes into a free hot slot or swaps with the
coldest hot resident past `promote_margin`, and a hot tier whose residents
are all protected overflows into the warm tier. Every move re-uploads the
host master of the target format; nothing is transcoded on the device.

One shard, no replicas and no prefetcher: the async prefetch pipeline
(ROADMAP A9) and expert-parallel shards (A14) come in later slices. The
slot bookkeeping is the reference's, so the same table stream gives the same
resident sets, tier moves, evictions, hits, translations and byte counts.
"""
from __future__ import annotations

import collections
import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TierConfig
from repro_torch.core.hash_table import HashTable
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import n_moe_layers, period, sub_kind
from repro_torch.tree import tree_map

EXPERT_TENSORS = ("w_in", "w_gate", "w_out")
# per-table decay of the α-mass EMA that ranks tier moves (the reference's
# ShardedStoreConfig.alpha_decay default; the port has no EP config yet)
ALPHA_DECAY = 0.9


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

    def forget(self, e: int) -> None:
        """Drop `e` from the books without counting an eviction (a tier
        move, or a K/V page released)."""

    def pick_victim(self, protected) -> Optional[int]:
        raise NotImplementedError


class FIFOPolicy(EvictionPolicy):
    """Evict in insertion order (the paper's serving loop assumption)."""

    name = "fifo"

    def __init__(self):
        self.order: collections.deque = collections.deque()

    def admit(self, e: int, weight: float = 0.0) -> None:
        self.order.append(e)

    def forget(self, e: int) -> None:
        try:
            self.order.remove(e)
        except ValueError:
            pass

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

    def forget(self, e: int) -> None:
        self.order.pop(e, None)

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

    def forget(self, e: int) -> None:
        self.score.pop(e, None)

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
    promotions: int = 0            # warm (int4) -> hot (int8) tier moves
    demotions: int = 0             # hot (int8) -> warm (int4) tier moves

    def reset(self):
        self.bytes_h2d = self.loads = self.evictions = self.hits = self.dropped = 0
        self.prepare_time = 0.0
        self.promotions = self.demotions = 0


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


def pack_nibbles(q: np.ndarray) -> np.ndarray:
    """int4 values (int8 storage, [-8, 7]) [..., K, N] -> nibble-packed
    uint8 [..., ceil(K/2), N]. Byte i holds contraction rows 2i (low
    nibble) and 2i+1 (high nibble), two's complement; an odd K pads one
    zero row. The kernel and `kernels.ref.unpack_int4_ref` read this."""
    K = q.shape[-2]
    if K % 2:
        pad = [(0, 0)] * (q.ndim - 2) + [(0, 1), (0, 0)]
        q = np.pad(q, pad)
    u = (q.astype(np.int16) & 0xF).astype(np.uint8)
    return (u[..., 1::2, :] << 4) | u[..., 0::2, :]


def unpack_nibbles(p: np.ndarray, k: int) -> np.ndarray:
    """Inverse of `pack_nibbles`: uint8 [..., ceil(k/2), n] -> int8 [..., k, n]."""
    lo = (p & 0xF).astype(np.int8)
    hi = (p >> 4).astype(np.int8)
    v = np.stack([lo, hi], axis=-2)
    v = v.reshape(p.shape[:-2] + (-1, p.shape[-1]))[..., :k, :]
    return np.where(v >= 8, v - 16, v).astype(np.int8)


def _group_of(k: int, group: int) -> int:
    """Effective int4 scale group along a contraction axis of length `k`:
    `group` when it divides `k`, else the whole axis (one group)."""
    g = min(group, k)
    return g if k % g == 0 else k


def quantize_expert_q4(w: np.ndarray, group: int = 64) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric int4 quantisation with per-group scales. w: [..., d_in, d_out].

    Each (group of `group` contraction rows, output channel) pair gets one
    f32 scale = absmax / 7 and values round to [-7, 7]. Returns
    (packed [..., ceil(d_in/2), d_out] uint8, scale [..., d_in/group, d_out]
    f32). The reference's numpy, so the masters are bit-identical to its."""
    k = w.shape[-2]
    g = _group_of(k, group)
    ng = k // g
    wg = w.astype(np.float32).reshape(w.shape[:-2] + (ng, g, w.shape[-1]))
    absmax = np.abs(wg).max(axis=-2, keepdims=True)
    scale = np.maximum(absmax, 1e-8) / 7.0
    q = np.clip(np.round(wg / scale), -7, 7).astype(np.int8)
    q = q.reshape(w.shape)
    return pack_nibbles(q), scale[..., 0, :].reshape(
        w.shape[:-2] + (ng, w.shape[-1])
    ).astype(np.float32)


def expert_format_bytes(shapes: List[Tuple[int, int]], fmt: str, group: int = 64) -> int:
    """Per-expert device bytes per MoE layer for one residency format, scale
    planes included. `shapes` lists the (d_in, d_out) of each expert tensor
    (w_in, w_gate, w_out)."""
    tot = 0
    for k, n in shapes:
        if fmt == "int8":
            tot += k * n + 4 * n                    # int8 rows + [1, n] f32 scale
        elif fmt == "int4":
            g = _group_of(k, group)
            tot += ((k + 1) // 2) * n + 4 * (k // g) * n
        else:
            raise ValueError(f"unknown residency format {fmt!r}")
    return tot


def tier_geometry(tier, slots_per_layer: int, E: int,
                  shapes: List[Tuple[int, int]]) -> Tuple[int, int]:
    """(S8, S4): hot int8 and warm int4 slots per MoE layer for a budget of
    `slots_per_layer` int8 slots, the warm share bought at the per-tier bytes
    of `expert_format_bytes`. S8 + S4 caps at E: more slots than experts
    would shrink the per-slot dispatch capacity for no residency gain."""
    if tier.warm_slots is not None:
        S8 = min(max(slots_per_layer, 1), E)
        return int(S8), int(min(tier.warm_slots, E - S8))
    b8 = expert_format_bytes(shapes, "int8")
    b4 = expert_format_bytes(shapes, "int4", tier.group_size)
    S8 = min(max(1, int(round(slots_per_layer * tier.tier_split))), E)
    return int(S8), int(min(max(0, ((slots_per_layer - S8) * b8) // b4), E - S8))


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
        tier: Optional[TierConfig] = None,         # None => cfg.quant.tier
    ):
        if not cfg.moe.enabled:
            raise ValueError("ExpertStore requires an MoE config")
        if eviction not in EVICTION_POLICIES:
            raise ValueError(f"unknown eviction policy {eviction!r}")
        if host_quant not in ("none", "int8"):
            raise ValueError(f"unknown host_quant {host_quant!r}")
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

        # hot int8 / warm int4 tiers: `slots_per_layer` stays the budget in
        # int8-slot bytes (`tier_geometry`)
        self.tier = cfg.quant.tier if tier is None else tier
        self.tiered = bool(self.tier is not None and self.tier.enabled)
        moe_p0 = params["blocks"][f"sub{self.moe_subs[0]}"]["moe"]
        self._expert_shapes = [tuple(moe_p0[t].shape[2:]) for t in EXPERT_TENSORS]
        self.S8, self.S4 = self.S, 0
        if self.tiered:
            if not self.quantized_slots:
                raise ValueError("the int4 warm tier layers on int8-resident slots "
                                 "(--int4-slots requires --quantized-slots)")
            self.S8, self.S4 = tier_geometry(self.tier, slots_per_layer, self.E,
                                             self._expert_shapes)
            self.S = self.S8 + self.S4
            # no warm slots: behave exactly as the untiered quantized store
            self.tiered = self.S4 > 0

        # split params: experts -> host masters, routers dropped, the rest
        # (and empty slot pools) on the device
        self.host: Dict[str, Dict[str, torch.Tensor]] = {}
        self.host_scale: Dict[str, Dict[str, torch.Tensor]] = {}
        # int4 host masters (tiered stores): quantised from the same f32
        # originals as the int8 masters, so a tier move re-uploads a master
        # and never transcodes int8 <-> int4
        self.host4: Dict[str, Dict[str, torch.Tensor]] = {}
        self.host4_scale: Dict[str, Dict[str, torch.Tensor]] = {}
        serve_params = tree_map(lambda x: x, params)   # fresh dicts, same leaves
        for s in self.moe_subs:
            moe_p = serve_params["blocks"][f"sub{s}"]["moe"]
            for d in (self.host, self.host_scale, self.host4, self.host4_scale):
                d[f"sub{s}"] = {}
            for t in EXPERT_TENSORS:
                full = moe_p[t]
                # fp32 numpy of the master: abs-max and division give the
                # reference's bits for fp32 and bf16 weights alike
                w = full.detach().to("cpu", torch.float32).numpy() if (
                    self.quant == "int8" or self.tiered) else None
                if self.quant == "int8":
                    q, scale = quantize_expert(w, self.scale_granularity)
                    self.host[f"sub{s}"][t] = torch.from_numpy(q)
                    self.host_scale[f"sub{s}"][t] = torch.from_numpy(scale)
                else:
                    self.host[f"sub{s}"][t] = full.detach().to("cpu")
                G, k_in, n_out = full.shape[0], full.shape[2], full.shape[3]
                if self.quantized_slots:
                    # the residency format is the transfer format: int8 rows
                    # and their scale plane land as they are
                    moe_p[t] = torch.zeros(
                        (G, self.S8, k_in, n_out), dtype=torch.int8, device=self.device,
                    )
                    moe_p[t + "_scale"] = torch.zeros(
                        (G, self.S8, 1, n_out), dtype=torch.float32, device=self.device,
                    )
                else:
                    moe_p[t] = torch.zeros(
                        (G, self.S8, k_in, n_out), dtype=full.dtype, device=self.device,
                    )
                if self.tiered:
                    # warm pools, addressed by (global slot - S8)
                    q4, s4 = quantize_expert_q4(w, self.tier.group_size)
                    self.host4[f"sub{s}"][t] = torch.from_numpy(q4)
                    self.host4_scale[f"sub{s}"][t] = torch.from_numpy(s4)
                    moe_p[t + "_q4"] = torch.zeros(
                        (G, self.S4, (k_in + 1) // 2, n_out), dtype=torch.uint8, device=self.device,
                    )
                    moe_p[t + "_q4_scale"] = torch.zeros(
                        (G, self.S4, k_in // _group_of(k_in, self.tier.group_size), n_out),
                        dtype=torch.float32, device=self.device,
                    )
            moe_p.pop("router", None)  # routers never participate in the forward
        self.serve_params = tree_map(lambda x: x.to(self.device), serve_params)

        # per (group, sub): expert -> global slot, and each tier's policy and
        # free list (hot slots [0, S8), warm slots [S8, S8 + S4))
        self.resident: Dict[Tuple[int, int], Dict[int, int]] = {}
        self.policy: Dict[Tuple[int, int], EvictionPolicy] = {}
        self.free: Dict[Tuple[int, int], List[int]] = {}
        self.policy4: Dict[Tuple[int, int], EvictionPolicy] = {}
        self.free4: Dict[Tuple[int, int], List[int]] = {}
        self.pinned: Dict[Tuple[int, int], Set[int]] = {}
        self.alpha_ema: Dict[Tuple[int, int], np.ndarray] = {}   # decayed α mass per expert
        for g in range(self.n_groups):
            for s in self.moe_subs:
                self.resident[(g, s)] = {}
                self.policy[(g, s)] = EVICTION_POLICIES[eviction]()
                self.free[(g, s)] = list(range(self.S8))
                self.policy4[(g, s)] = EVICTION_POLICIES[eviction]()
                self.free4[(g, s)] = list(range(self.S8, self.S8 + self.S4))
                self.pinned[(g, s)] = set()
                self.alpha_ema[(g, s)] = np.zeros((self.E,), np.float64)
        self._lock = threading.RLock()

    # -- layer indexing: moe layer l = g * len(moe_subs) + j ----------------
    def layer_to_gs(self, l: int) -> Tuple[int, int]:
        j = l % len(self.moe_subs)
        return l // len(self.moe_subs), self.moe_subs[j]

    # ------------------------------------------------------------------
    def slot_tier(self, slot: int) -> str:
        """'hot' (int8 pool) or 'warm' (int4 pool) for a global slot id."""
        return "warm" if (self.S4 and slot >= self.S8) else "hot"

    def device_bytes(self) -> int:
        """Bytes of expert slot pools resident on the device (the paper's
        metric), scale planes included when the slots are int8, and the warm
        int4 pools with their group scale planes when tiered."""
        tot = 0
        for s in self.moe_subs:
            moe_p = self.serve_params["blocks"][f"sub{s}"]["moe"]
            for t in EXPERT_TENSORS:
                for key in (t, t + "_scale", t + "_q4", t + "_q4_scale"):
                    if key in moe_p:
                        tot += nbytes(moe_p[key])
        return tot

    def tier_slot_bytes(self) -> Dict[str, int]:
        """Device bytes one expert costs per MoE layer in each tier, scale
        planes included (`expert_format_bytes`)."""
        group = self.tier.group_size if self.tier is not None else 64
        return {
            "hot": expert_format_bytes(self._expert_shapes, "int8"),
            "warm": expert_format_bytes(self._expert_shapes, "int4", group),
        }

    def expert_slot_bytes(self) -> int:
        """Device bytes one hot expert slot costs per MoE layer in the
        residency format (fp, or int8 + scale planes) — the denominator of
        the capacity-at-equal-bytes comparison. A warm slot costs
        `tier_slot_bytes()["warm"]`."""
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
        extra_protected: Optional[Set[int]] = None,
    ) -> List[Tuple[int, int, int]]:
        """Cache bookkeeping for one layer; returns pending (g, slot, e) loads.

        `mass` ([E], optional) is the α mass the table routes to each expert,
        fed to the eviction policy and, when tiered, to the α EMA that ranks
        tier moves. `extra_protected` experts survive eviction and, like
        pinned ones, never move between tiers (a translation in flight may
        point at their slot)."""
        g, s = self.layer_to_gs(l)
        res = self.resident[(g, s)]
        policy = self.policy[(g, s)]
        free = self.free[(g, s)]
        protected = {int(e) for e in needed} | self.pinned[(g, s)]
        move_blocked = set(self.pinned[(g, s)])
        if extra_protected:
            protected |= extra_protected
            move_blocked |= extra_protected
        if mass is not None and self.tiered:
            # one full table pass decays the EMA by ALPHA_DECAY overall
            ema = self.alpha_ema[(g, s)]
            ema *= ALPHA_DECAY ** (1.0 / max(self.L, 1))
            ema += mass
        pending: List[Tuple[int, int, int]] = []
        for e in needed:
            e = int(e)
            w = float(mass[e]) if mass is not None else 0.0
            if e in res:
                self.stats.hits += 1
                if (self.tiered and res[e] >= self.S8 and e not in move_blocked
                        and self._promote(g, s, e, w, protected | move_blocked, pending)):
                    continue
                self._touch(g, s, e, res[e], w)
                continue
            if free:
                slot = free.pop()
            else:
                victim = policy.pick_victim(protected)
                if victim is None:
                    # hot tier full of protected residents: load into a warm
                    # slot instead of dropping (combined capacity S8 + S4)
                    wslot = self._take_warm_slot(g, s, protected) if self.tiered else None
                    if wslot is None:
                        self.stats.dropped += 1  # everything resident is protected
                        continue
                    res[e] = wslot
                    self.policy4[(g, s)].admit(e, w)
                    pending.append((g, wslot, e))
                    self.stats.loads += 1
                    continue
                slot = res.pop(victim)
                wslot = None
                if self.tiered and victim not in move_blocked:
                    # demote instead of evict: the victim stays resident in a
                    # warm slot, re-uploaded from its int4 host master
                    wslot = self._take_warm_slot(g, s, protected)
                if wslot is not None:
                    res[victim] = wslot
                    self.policy4[(g, s)].admit(victim, float(self.alpha_ema[(g, s)][victim]))
                    pending.append((g, wslot, victim))
                    self.stats.demotions += 1
                    self.stats.loads += 1
                else:
                    self.stats.evictions += 1
            res[e] = slot
            policy.admit(e, w)
            pending.append((g, slot, e))
            self.stats.loads += 1
        return pending

    def _touch(self, g: int, s: int, e: int, slot: int, w: float) -> None:
        """Route a reference to the policy of the tier holding `slot`."""
        (self.policy4 if self.slot_tier(slot) == "warm" else self.policy)[(g, s)].touch(e, w)

    def _take_warm_slot(self, g: int, s: int, protected: Set[int]) -> Optional[int]:
        """A warm slot: a free one, else the warm policy's victim evicted to
        the host. None when every warm resident is protected."""
        free4 = self.free4[(g, s)]
        if free4:
            return free4.pop()
        v4 = self.policy4[(g, s)].pick_victim(protected)
        if v4 is None:
            return None
        self.stats.evictions += 1
        return self.resident[(g, s)].pop(v4)

    def _peek_hot_victim(self, g: int, s: int, excluded: Set[int]) -> Optional[int]:
        """The hot resident with the least decayed α mass outside
        `excluded`, without touching the policy's books."""
        ema = self.alpha_ema[(g, s)]
        best = None
        for e2, slot in self.resident[(g, s)].items():
            if slot >= self.S8 or e2 in excluded:
                continue
            if best is None or ema[e2] < ema[best]:
                best = e2
        return best

    def _promote(self, g: int, s: int, e: int, w: float, excluded: Set[int],
                 pending: List[Tuple[int, int, int]]) -> bool:
        """Move warm-resident `e` into the hot tier: into a free hot slot,
        else by swapping with the coldest movable hot resident when e's
        decayed α mass beats it by `tier.promote_margin` (hysteresis). The
        moved experts are re-uploaded from their host masters. Returns True
        iff a move happened."""
        res = self.resident[(g, s)]
        ema = self.alpha_ema[(g, s)]
        wslot = res[e]
        free = self.free[(g, s)]
        if free:
            hot_slot = free.pop()
            self.free4[(g, s)].append(wslot)
            self.policy4[(g, s)].forget(e)
            res[e] = hot_slot
            self.policy[(g, s)].admit(e, w)
            pending.append((g, hot_slot, e))
            self.stats.promotions += 1
            self.stats.loads += 1
            return True
        v = self._peek_hot_victim(g, s, excluded)
        if v is None or float(ema[e]) <= 0.0:
            return False
        if float(ema[e]) < self.tier.promote_margin * float(ema[v]):
            return False
        hot_slot = res[v]
        res[e], res[v] = hot_slot, wslot
        self.policy[(g, s)].forget(v)
        self.policy4[(g, s)].forget(e)
        self.policy[(g, s)].admit(e, w)
        self.policy4[(g, s)].admit(v, float(ema[v]))
        pending.append((g, hot_slot, e))
        pending.append((g, wslot, v))
        self.stats.promotions += 1
        self.stats.demotions += 1
        self.stats.loads += 2
        return True

    def commit_loads(self, s: int, items: List[Tuple[int, int, int]]) -> None:
        """Batched host -> device writes for sub-slot `s` (one per tensor).

        Three formats, as the reference: int8 rows and scale planes landing
        as they are (quantized slots); int8 rows + scales uploaded and
        dequantised on the device into fp slots (`host_quant="int8"`, half
        the H2D bytes of bf16); fp rows. Loads into warm slots land the
        int4 masters (`_commit_warm`).

        The pools are written in place (`index_copy_`). That is safe here:
        prepare and the forward that reads the slots run on one thread and
        one stream, so the copy is ordered before every later read. An async
        prefetcher (ROADMAP A9) will need copy-on-write or events instead."""
        if self.S4:
            self._commit_warm(s, [i for i in items if i[1] >= self.S8])
            items = [i for i in items if i[1] < self.S8]
        if not items:
            return
        gs, sl, es = (torch.tensor(col, dtype=torch.long) for col in zip(*items))
        rows = (gs * self.S8 + sl).to(self.device)
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

    def _commit_warm(self, s: int, items: List[Tuple[int, int, int]]) -> None:
        """Writes into the warm pools: the nibble-packed int4 masters and
        their group scale planes land as they are. One plan can fill a warm
        slot twice (a demoted expert evicted again by a later demotion):
        every upload is counted, and the last one is what lands."""
        if not items:
            return
        moe_p = self.serve_params["blocks"][f"sub{s}"]["moe"]
        for t in EXPERT_TENSORS:
            for host in (self.host4, self.host4_scale):
                self.stats.bytes_h2d += len(items) * nbytes(host[f"sub{s}"][t][0, 0])
        last = list({(g, slot): (g, slot, e) for g, slot, e in items}.values())
        gs, sl, es = (torch.tensor(col, dtype=torch.long) for col in zip(*last))
        rows = (gs * self.S4 + sl - self.S8).to(self.device)
        for t in EXPERT_TENSORS:
            for key, host in ((t + "_q4", self.host4), (t + "_q4_scale", self.host4_scale)):
                vals = host[f"sub{s}"][t][gs, es]
                pool = moe_p[key]
                pool.view(-1, *pool.shape[2:]).index_copy_(0, rows, vals.to(self.device))

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
            # tiered stores take the mass too: the α EMA ranks tier moves
            if len(needed) > self.S or self.eviction == "alpha" or self.tiered:
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
