"""Expert offloading: host-resident expert store + device slot cache, and
the async prefetch pipeline (port of the one-shard case of
`repro/core/offload.py`).

The full expert stacks live in host memory as CPU tensors, in the model
dtype or, with `host_quant="int8"`, as symmetric int8 with fp32 scale planes
(`quantize_stack_int8`, bit-identical to the reference's numpy `quantize_expert`,
run on the store's device a layer at a time, so a model with gigabytes of
experts a layer quantises in seconds). On the device
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

`PrefetchPipeline` moves the uploads off the forward path: `submit` plans
the slots at once and a transfer thread gathers the rows into pinned
staging slabs and copies them on a side CUDA stream, behind per-expert
ready fences (see the class). The pools are written in place on either
stream, so every write waits on the CUDA event of the slot's previous
write, and every reader on the events of the slots it reads.

The pipeline is supervised as the reference's is: an upload batch that
fails is retried with bounded backoff, then abandoned (its slots rolled back
to the free lists and its fences poisoned, so waiters replan), repeated
abandonments degrade the shard to synchronous commits, a crashed transfer
thread restarts in place, and one that crashes too often is revived by the
`watchdog`. A `FaultPlan` (`faults=`) injects failures at the reference's
sites. A CUDA error is never retried: it is kept and re-raised to the
consumers.

One shard and no replicas: expert-parallel shards and their per-shard
queues are ROADMAP A14 (the supervision state is already kept a shard, as
lists of length one). The slot bookkeeping is the reference's, so the same
table stream gives the same resident sets, tier moves, evictions, hits,
translations and byte counts.
"""
from __future__ import annotations

import collections
import contextlib
import sys
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TierConfig
from repro_torch.core.hash_table import HashTable
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import n_moe_layers, period, sub_kind
from repro_torch.tree import tree_map

EXPERT_TENSORS = ("w_in", "w_gate", "w_out")
# per-table decay of the α-mass EMA that ranks tier moves (the reference's
# ShardedStoreConfig.alpha_decay default)
ALPHA_DECAY = 0.9


@dataclass(frozen=True)
class ShardedStoreConfig:
    """Expert-parallel partitioning of the serving slot pools, as the
    reference's `ShardedStoreConfig` spells it. Only the configuration is
    ported (the serving flag table builds it): the port's store has one
    shard, and a server asked for `ep_shards > 1` raises until the shard
    pools, replication and rebalancing are ported (ROADMAP A14)."""

    ep_shards: int = 1
    model_axis: str = "model"
    placement: str = "mod"            # "mod": e -> e % shards | "block": e -> e // (E/shards)
    replicate_hot: int = 0            # extra copies a hot expert may hold
    hot_alpha: Optional[float] = None  # hot threshold as a share of total α
    alpha_decay: float = ALPHA_DECAY  # per-table decay of the α-mass EMA

    @property
    def enabled(self) -> bool:
        return self.ep_shards > 1


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
    pin_quota_refusals: int = 0    # tenant pins refused at the quota cap

    def reset(self):
        self.bytes_h2d = self.loads = self.evictions = self.hits = self.dropped = 0
        self.prepare_time = 0.0
        self.promotions = self.demotions = 0
        self.pin_quota_refusals = 0


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_of(k: int, group: int) -> int:
    """Effective int4 scale group along a contraction axis of length `k`:
    `group` when it divides `k`, else the whole axis (one group)."""
    g = min(group, k)
    return g if k % g == 0 else k


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """x / d, correctly rounded on every device: PyTorch's CUDA division by
    a Python scalar multiplies by its reciprocal (an ulp off the numpy
    quotient for some x), division by a tensor does not."""
    return x / torch.full_like(x, d)


def _quantize_layers(full: torch.Tensor, device, quantize) -> Tuple[torch.Tensor, torch.Tensor]:
    """`quantize` (fp32 [..., d_in, d_out] -> (q, scale)) over an expert
    stack [L, ..., d_in, d_out] in torch on `device`, one leading index at a
    time, returned stacked as CPU tensors."""
    qs, ss = [], []
    for i in range(full.shape[0]):
        q, scale = quantize(full[i].to(device=device, dtype=torch.float32))
        qs.append(q.cpu())
        ss.append(scale.contiguous().cpu())
    return torch.stack(qs), torch.stack(ss)


def quantize_stack_int8(full: torch.Tensor, device,
                        granularity: str = "channel") -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantisation of an expert stack [L, ..., d_in, d_out]
    on `device` (values in [-127, 127]), bit-identical to the reference's
    numpy `quantize_expert` (the same fp32 abs-max, IEEE fp32 division and
    round-half-to-even), from fp32 or bf16 weights. `granularity`:
    "channel" (one scale per output channel, abs-max over d_in) or "tensor"
    (one per expert tensor); the scale is a [..., 1, d_out] plane."""
    if granularity not in ("channel", "tensor"):
        raise ValueError(f"unknown scale granularity {granularity!r}")
    dims = (-2, -1) if granularity == "tensor" else -2

    def one(w):
        absmax = w.abs().amax(dim=dims, keepdim=True).expand(*w.shape[:-2], 1, w.shape[-1])
        scale = _div(torch.clamp(absmax, min=1e-8), 127.0)
        return torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8), scale

    return _quantize_layers(full, device, one)


def quantize_stack_int4(full: torch.Tensor, device,
                        group: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int4 quantisation of an expert stack [L, ..., d_in, d_out]
    on `device`, bit-identical to the reference's numpy
    `quantize_expert_q4`: one fp32 scale = abs-max / 7 per `group`
    contraction rows (the whole axis when `group` does not divide it) and
    output channel, values in [-7, 7], nibble-packed into uint8
    [..., ceil(d_in / 2), d_out]: byte i holds rows 2i (low nibble) and
    2i + 1 (high), two's complement, an odd d_in padded with a zero row
    (`kernels.ref.unpack_int4_ref` reads it); scales [..., d_in / group,
    d_out]."""

    def one(w):
        k, n = w.shape[-2], w.shape[-1]
        g = _group_of(k, group)
        wg = w.reshape(*w.shape[:-2], k // g, g, n)
        scale = _div(torch.clamp(wg.abs().amax(dim=-2, keepdim=True), min=1e-8), 7.0)
        q = torch.clamp(torch.round(wg / scale), -7, 7).to(torch.int8).reshape(w.shape)
        if k % 2:
            q = torch.nn.functional.pad(q, (0, 0, 0, 1))
        u = (q.to(torch.int16) & 0xF).to(torch.uint8)
        return (u[..., 1::2, :] << 4) | u[..., 0::2, :], scale[..., 0, :]

    return _quantize_layers(full, device, one)


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
                full = moe_p[t].detach()
                # quantised from the fp32 master on the device: abs-max and
                # division give the reference's bits for fp32 and bf16 weights
                if self.quant == "int8":
                    q, scale = quantize_stack_int8(full, self.device, self.scale_granularity)
                    self.host[f"sub{s}"][t] = q
                    self.host_scale[f"sub{s}"][t] = scale
                else:
                    self.host[f"sub{s}"][t] = full.to("cpu")
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
                    q4, s4 = quantize_stack_int4(full, self.device, self.tier.group_size)
                    self.host4[f"sub{s}"][t] = q4
                    self.host4_scale[f"sub{s}"][t] = s4
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
        # tenant pins: (group, sub) -> expert -> owning tenant, and each
        # tenant's cap as a share of a layer's slots (`set_pin_quota`)
        self.pin_owner: Dict[Tuple[int, int], Dict[int, str]] = {
            gs: {} for gs in self.resident}
        self.pin_quota: Dict[str, float] = {}
        self._lock = threading.RLock()
        self._prefetcher: Optional["PrefetchPipeline"] = None
        self._epoch = 0   # residency version (`affinity_epoch`)

    @property
    def affinity_epoch(self) -> int:
        """Monotonic residency version: while it is unchanged every
        `cache_affinity` answer is too, so the request scheduler reuses a
        memoised score instead of rescanning L x E under the store lock."""
        return self._epoch

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
    def set_pin_quota(self, tenant: str, frac: float) -> None:
        """Cap `tenant`'s pinned share: at most `floor(frac x S)` of each
        layer's S slots may be pinned under its name (the request server
        registers `TenantConfig.pin_quota` here)."""
        if not (0.0 < frac <= 1.0):
            raise ValueError(f"pin quota for {tenant!r} must be in (0, 1]")
        self.pin_quota[tenant] = float(frac)

    def pin_cap(self, tenant: str) -> int:
        """Per-layer pinned-slot cap for `tenant` (S slots when no quota)."""
        return int(self.pin_quota.get(tenant, 1.0) * self.S)

    def pinned_count(self, l: int, tenant: str) -> int:
        return sum(1 for t in self.pin_owner[self.layer_to_gs(l)].values() if t == tenant)

    def pinned_share(self, tenant: str) -> float:
        """Largest fraction of any layer's slots pinned by `tenant`: the
        quantity the quota bounds."""
        if self.S <= 0:
            return 0.0
        worst = max((sum(1 for t in owners.values() if t == tenant)
                     for owners in self.pin_owner.values()), default=0)
        return worst / self.S

    def pin_experts(self, l: int, experts, tenant: Optional[str] = None) -> Set[int]:
        """Mark experts at MoE layer `l` as never-evictable. They still load
        through the normal prepare path; they just cannot be victims.

        With `tenant`, each pin is attributed to it and counted against its
        `set_pin_quota` cap: pins past `floor(quota x S)` a layer, and pins
        of an expert someone else pinned, are refused (skipped and counted
        in `stats.pin_quota_refusals`). Returns the experts pinned by this
        call; tenant-less pins are unattributed and uncapped."""
        g, s = self.layer_to_gs(l)
        with self._lock:
            pool = self.pinned[(g, s)]
            if tenant is None:
                new = {int(e) for e in experts}
                pool.update(new)
                return new
            owners = self.pin_owner[(g, s)]
            cap = self.pin_cap(tenant)
            held = sum(1 for t in owners.values() if t == tenant)
            granted: Set[int] = set()
            for e in sorted(int(x) for x in experts):
                if owners.get(e) == tenant:
                    granted.add(e)      # re-pinning one's own expert is free
                    continue
                if e in pool or held >= cap:
                    self.stats.pin_quota_refusals += 1
                    continue
                pool.add(e)
                owners[e] = tenant
                held += 1
                granted.add(e)
            return granted

    def unpin_experts(self, l: int, experts, tenant: Optional[str] = None) -> None:
        """Release pins; with `tenant`, only that tenant's own."""
        g, s = self.layer_to_gs(l)
        with self._lock:
            owners = self.pin_owner[(g, s)]
            for e in (int(x) for x in experts):
                if tenant is not None and owners.get(e) != tenant:
                    continue
                self.pinned[(g, s)].discard(e)
                owners.pop(e, None)

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
        if pending:
            # every residency change (load, eviction, tier move) plans an upload
            self._epoch += 1
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

        The pools are written in place (`index_copy_`) on the caller's
        stream, which is ordered before every later forward on it. With a
        prefetch pipeline attached, the writes also wait on the CUDA event of
        each slot's last write on the transfer stream, and record their own
        (`PrefetchPipeline._ordered_write`)."""
        pf = self._prefetcher
        with (pf._ordered_write(s, items) if pf is not None else contextlib.nullcontext()):
            self._commit_loads(s, items)

    def _commit_loads(self, s: int, items: List[Tuple[int, int, int]]) -> None:
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

    def rollback_upload(self, g: int, s: int, slot: int, e: int) -> bool:
        """Withdraw the residency published at plan time for one abandoned
        upload (caller holds the lock): the slot goes back to its tier's
        free list, so no translation built after this points at a slot
        whose bytes never landed. A mapping that moved on since (an evict
        and reload raced the failure) is left to its newer upload. One
        shard holds no replicas. Returns True iff a mapping was rolled
        back."""
        res = self.resident[(g, s)]
        if res.get(e) != slot:
            return False
        del res[e]
        warm = self.slot_tier(slot) == "warm"
        (self.policy4 if warm else self.policy)[(g, s)].forget(e)
        (self.free4 if warm else self.free)[(g, s)].append(slot)
        self._epoch += 1
        return True

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

    def plan(self, table: HashTable,
             protect_fn: Optional[Callable[[int, int], Set[int]]] = None):
        """Slot bookkeeping for a whole table (no device traffic).

        Returns (trans [L, E], pending {sub: [(g, slot, e)]}, needed {l: ids}).
        `protect_fn(g, s)` supplies extra never-evict experts (the prefetch
        pipeline protects experts of outstanding tickets and uploads in
        flight). Caller must hold `_lock`."""
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
            g, s = self.layer_to_gs(l)
            extra = protect_fn(g, s) if protect_fn is not None else None
            pending[s].extend(self.plan_layer(l, needed, mass=mass, extra_protected=extra))
            needed_by_layer[l] = needed
            trans[l] = self.trans_row(l)
        return trans, pending, needed_by_layer

    def prepare(self, table: HashTable) -> np.ndarray:
        """Load the predicted experts for a whole batch; returns the
        translation table [L, E] expert -> slot (-1 = not resident). Uploads
        run inline, so their time lands in `stats.prepare_time`. With a
        prefetch pipeline attached, experts it is uploading are fenced on
        instead of uploaded again."""
        t0 = time.perf_counter()
        pf = self._prefetcher
        # a poisoned fence (an abandoned upload, rolled back) means the
        # translation names a slot whose bytes never landed: plan again, and
        # the rolled-back expert loads here, inline
        for _ in range(64):
            with self._lock:
                trans, pending, needed = self.plan(
                    table, protect_fn=pf.protected_experts if pf is not None else None)
                for s, items in pending.items():
                    self.commit_loads(s, items)
                fences = pf.events_for(needed) if pf is not None else []
            poisoned = False
            for _, ev in fences:
                ev.wait()
                poisoned |= getattr(ev, "poisoned", False)
            if not poisoned:
                break
        if pf is not None:
            pf._raise_if_fatal()
            pf._device_wait(needed)
        self.stats.prepare_time += time.perf_counter() - t0
        return trans

    # ------------------------------------------------------------------
    def cache_affinity(self, table: HashTable,
                       inflight: Optional[Dict[Tuple[int, int], Set[int]]] = None) -> float:
        """Fraction of the table's active experts already resident — the
        score for cache-aware batch ordering. `inflight` extends residency
        with uploads in flight, so prefetches already paid for count."""
        hits = tot = 0
        with self._lock:
            for l in range(self.L):
                gs = self.layer_to_gs(l)
                res = self.resident[gs]
                fly = inflight.get(gs, ()) if inflight else ()
                for e in table.active_experts(l):
                    tot += 1
                    hits += int(int(e) in res or int(e) in fly)
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


# ---------------------------------------------------------------------------
# asynchronous prefetch pipeline
# ---------------------------------------------------------------------------


def _staged_put(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """H2D copy of one staged slab on the current stream (the transfer
    thread's side stream); a CPU device gets the slab itself. Module-level so
    tests can inject a slow link."""
    return x.to(device, non_blocking=True)


# a CUDA error is never retried, poisoned or degraded away: the transfer
# thread keeps it and every consumer re-raises it (`_raise_if_fatal`)
_CUDA_ERRORS = tuple(c for c in (getattr(torch, "AcceleratorError", None),
                                 torch.cuda.CudaError, torch.cuda.OutOfMemoryError)
                     if c is not None)


def _fatal(exc: BaseException) -> bool:
    return isinstance(exc, _CUDA_ERRORS) or "CUDA error" in str(exc)


@dataclass
class PrefetchStats:
    """Overlap and supervision accounting for the async pipeline.

    `stall_s` is the only time the forward path lost: consumer time spent
    clearing a ticket (stealing a queued job, re-planning, waiting on ready
    fences). `transfer_s` is the transfer thread's busy host time: gathers
    into the staging slabs, waits for a slab to drain, and enqueueing the
    copies and slot writes (on the card the copies themselves run on the
    side stream, after the thread moved on). Its part that is not stall is
    transfer hidden behind compute. A fault-free run counts no retries,
    failures, crashes, job errors or sync fallbacks."""

    submitted: int = 0          # tickets submitted
    uploads: int = 0            # experts uploaded by the transfer thread (or stolen)
    stall_s: float = 0.0        # consumer time blocked on ready fences
    transfer_s: float = 0.0     # background gather + upload busy time
    staging_waits: int = 0      # gathers that waited for a staging slab to drain
    warm_skipped: int = 0       # warming prefetches dropped (transfer backlog)
    stolen: int = 0             # jobs a fence found still queued and ran inline
    upload_retries: int = 0     # failed upload attempts that were retried
    upload_failures: int = 0    # upload batches abandoned (retries exhausted)
    poisoned_fences: int = 0    # per-expert fences poisoned by abandonment
    thread_crashes: int = 0     # transfer-loop exceptions outside a job guard
    thread_restarts: int = 0    # supervised restarts (in place or by the watchdog)
    sync_fallbacks: int = 0     # uploads committed through the synchronous path
    job_errors: int = 0         # callable-job (K/V page-in) exceptions caught
    degraded: int = 0           # shards now in degraded (synchronous) mode

    @property
    def overlap_s(self) -> float:
        return max(0.0, self.transfer_s - self.stall_s)

    def reset(self) -> None:
        self.submitted = self.uploads = self.staging_waits = 0
        self.warm_skipped = self.stolen = 0
        self.upload_retries = self.upload_failures = self.poisoned_fences = 0
        self.thread_crashes = self.thread_restarts = 0
        self.sync_fallbacks = self.job_errors = 0
        # `degraded` is a count of shards now, not of events: a reset keeps it
        self.stall_s = self.transfer_s = 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "prefetch_submitted": float(self.submitted),
            "prefetch_uploads": float(self.uploads),
            "prefetch_stall_s": self.stall_s,
            "prefetch_transfer_s": self.transfer_s,
            "prefetch_overlap_s": self.overlap_s,
            "prefetch_staging_waits": float(self.staging_waits),
            "prefetch_warm_skipped": float(self.warm_skipped),
            "prefetch_stolen": float(self.stolen),
            "prefetch_upload_retries": float(self.upload_retries),
            "prefetch_upload_failures": float(self.upload_failures),
            "prefetch_poisoned_fences": float(self.poisoned_fences),
            "prefetch_thread_crashes": float(self.thread_crashes),
            "prefetch_thread_restarts": float(self.thread_restarts),
            "prefetch_sync_fallbacks": float(self.sync_fallbacks),
            "prefetch_job_errors": float(self.job_errors),
            "prefetch_degraded_shards": float(self.degraded),
        }


class _CallableJob:
    """A non-expert transfer job (a K/V page-in, `core/residency.py`): `fn`
    runs on the transfer thread, then `done` is set. It rides the same
    three priority classes as expert uploads. A job that failed or was
    dropped still sets `done`; its waiter re-checks what `fn` was to do."""

    __slots__ = ("fn", "done")

    def __init__(self, fn: Callable[[], None]):
        self.fn = fn
        self.done = threading.Event()


class PrefetchTicket:
    """Handle for one submitted prediction: a translation-table snapshot plus
    the ready fences the consumer must clear before forwarding with it.

    Protocol: `submit` plans slots at once (so `trans` is final at
    submission) and the uploads land asynchronously; the consumer calls
    `wait()` (or `wait_experts` for a partial fence) before running the
    forward, and `release()` once the forward has finished on the device —
    until then every expert the ticket references is protected from
    eviction, so no slot it reads is overwritten in place."""

    def __init__(self, pipeline: "PrefetchPipeline", trans: np.ndarray,
                 needed: Dict[int, np.ndarray], fences, protect: bool):
        self._pipeline = pipeline
        self.trans = trans
        self.needed = needed                  # layer -> expert ids planned
        self._fences = fences                 # ((g, s, e), fence) to clear
        self._protect = protect
        self._job: Optional[Dict[int, List[tuple]]] = None   # queued upload job (stealable)
        self.released = False
        # set once a fence of this ticket was poisoned (its upload abandoned);
        # the replan in wait() has healed `trans` by then
        self.failed = False

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Make the ticket consumable: clear its ready fences, re-plan any
        needed expert whose prefetch was dropped (slot contention with other
        outstanding tickets), evicted since planning, or rolled back by an
        abandoned upload, refresh `trans` in place, and make the caller's
        stream wait on the writes of every slot the ticket reads. Returns
        False if `timeout` expired first; `trans` may then still name
        experts that are not resident, so the caller must wait again or
        fall back to `store.prepare` (never forward with a timed-out
        ticket)."""
        return self._pipeline._refresh(self, timeout)

    def wait_experts(self, l: int, experts) -> None:
        """Partial fence: block only on uploads of `experts` at MoE layer
        `l`; experts already resident (no upload pending) never block. A
        poisoned fence among them escalates to the full `wait()`: its slot
        was rolled back."""
        pf = self._pipeline
        g, s = pf.store.layer_to_gs(l)
        want = {int(e) for e in experts}
        t0 = time.perf_counter()
        poisoned = False
        for (fg, fs, fe), ev in self._fences:
            if (fg, fs) == (g, s) and fe in want:
                ev.wait()
                poisoned |= getattr(ev, "poisoned", False)
        pf.stats.stall_s += time.perf_counter() - t0
        if poisoned:
            pf._refresh(self)
            return
        pf._raise_if_fatal()
        t0 = time.perf_counter()
        pf._device_wait({l: np.fromiter(want, np.int64)})
        pf.stats.stall_s += time.perf_counter() - t0

    def release(self) -> None:
        """Drop eviction protection. Call after the forward that read this
        ticket's slots has finished on the device: the pools are written in
        place, so a slot released early could be overwritten under it."""
        if not self.released:
            self._pipeline._release(self)
            self.released = True


class PrefetchPipeline:
    """Async double-buffered expert prefetch over one ExpertStore.

    A background transfer thread takes planned load batches off a
    three-class priority queue (0 urgent consumer, 1 pre-submitted
    lookahead, 2 warming), gathers the host rows (int8 + scales under
    `host_quant="int8"`, the int4 masters for warm slots) into one of
    `staging_buffers` reusable host slabs, copies each slab to the device
    and writes the slot pools. Slot planning happens at `submit` under the
    store lock, so the ticket carries the final translation; only the bytes
    move later.

    On the card the slabs are pinned (`pin_memory=True`), grown on demand
    and reused round-robin; the thread owns one side `torch.cuda.Stream`
    and issues every copy (`non_blocking=True`) and every pool write (the
    int8 slots, the dequant-at-write of int8 host masters into fp slots,
    the warm int4 slots) on it, then records one CUDA event per upload
    batch. On the CPU there is no stream and no pinning: the copies are
    synchronous and the bookkeeping the same.

    Invariants:
      * an expert referenced by an unreleased ticket, or with an upload in
        flight, is never an eviction victim;
      * a ready fence is a pair: the host `threading.Event`, set only after
        every tensor (w_in, w_gate, w_out, scale planes) of its upload is
        written and the CUDA event after those writes is recorded, and that
        event, kept as the slot's last write in `_slot_event` (a host set
        alone orders nothing on the device). A fence set with `poisoned`
        says the bytes never landed: its waiter replans and never reads
        that slot's CUDA event as a ready mark;
      * each slot's last write (on either stream, failed attempts too)
        leaves its CUDA event in `_slot_event`: the next write to the slot
        waits on it (no two writes race), and a consumer's stream waits on
        the events of the slots it is about to read;
      * a staging slab is reused only after the CUDA event of the copies
        out of it, recorded on every exit from an upload attempt, has
        completed (the double-buffer fence, `staging_waits`).

    Supervision (the reference's): an upload batch is retried up to
    `max_retries` times with exponential backoff, then abandoned
    (`_fail_rows`: rolled back, fences poisoned); `degrade_after`
    consecutive abandonments switch the shard to synchronous commits
    (`_commit_sync`); a transfer-loop crash restarts the loop in place,
    and past `max_thread_restarts` the shard is dead (producers commit
    inline) until `watchdog` revives it. A CUDA error is none of these: it
    is kept and re-raised by every later submit, wait and fence."""

    # CPython's default switch interval (5 ms) starves the transfer thread's
    # short ops behind the serving loop's Python work; the interval is
    # process-global, so it is refcounted and restored at close().
    SWITCH_INTERVAL_S = 0.0005
    _switch_refs = 0
    _switch_saved: Optional[float] = None
    _switch_lock = threading.Lock()

    @classmethod
    def _acquire_switch_interval(cls) -> None:
        with cls._switch_lock:
            if cls._switch_refs == 0 and sys.getswitchinterval() > cls.SWITCH_INTERVAL_S:
                cls._switch_saved = sys.getswitchinterval()
                sys.setswitchinterval(cls.SWITCH_INTERVAL_S)
            cls._switch_refs += 1

    @classmethod
    def _release_switch_interval(cls) -> None:
        with cls._switch_lock:
            cls._switch_refs -= 1
            if cls._switch_refs == 0 and cls._switch_saved is not None:
                sys.setswitchinterval(cls._switch_saved)
                cls._switch_saved = None

    @classmethod
    def maybe_create(cls, store: ExpertStore, cfg, prefetch_depth: Optional[int] = None,
                     staging_buffers: Optional[int] = None,
                     faults=None) -> Optional["PrefetchPipeline"]:
        """Resolve the prefetch knobs (explicit args > cfg.prefetch > off) and
        build a pipeline, or return None for the synchronous path: the one
        precedence rule every engine shares. `faults` is a `FaultPlan`; the
        retry and degradation knobs ride `cfg.prefetch`."""
        depth = prefetch_depth if prefetch_depth is not None else (
            cfg.prefetch.depth if cfg.prefetch.enabled else 0)
        nbuf = staging_buffers if staging_buffers is not None else cfg.prefetch.staging_buffers
        if depth <= 0:
            return None
        pc = cfg.prefetch
        return cls(store, depth, nbuf, faults=faults, max_retries=pc.max_retries,
                   backoff_s=pc.backoff_s, degrade_after=pc.degrade_after)

    def __init__(self, store: ExpertStore, depth: int = 2, staging_buffers: int = 2,
                 faults=None, max_retries: int = 3, backoff_s: float = 0.002,
                 degrade_after: int = 3, max_thread_restarts: int = 3):
        if store._prefetcher is not None:
            raise ValueError("the store already has a prefetch pipeline")
        self.store = store
        self.shards = 1
        self.depth = max(1, depth)
        self.n_staging = max(1, staging_buffers)
        self.faults = faults                      # Optional[FaultPlan]
        self.max_retries = max(0, max_retries)    # upload attempts = 1 + max_retries
        self.backoff_s = backoff_s                # base of the exponential backoff
        self.degrade_after = max(1, degrade_after)
        self.max_thread_restarts = max(0, max_thread_restarts)
        self.stats = PrefetchStats()
        self._lock = store._lock
        self.device = store.device
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._jobs_cv = threading.Condition()
        self._jobs: List[collections.deque] = [collections.deque() for _ in range(3)]
        # (g, s) -> expert -> {dest slot: fence} for uploads still in flight
        self._pending: Dict[Tuple[int, int], Dict[int, Dict[int, threading.Event]]] = (
            collections.defaultdict(dict))
        # (g, s) -> expert -> refcount from unreleased tickets
        self._refs: Dict[Tuple[int, int], collections.Counter] = (
            collections.defaultdict(collections.Counter))
        # (g, s, global slot) -> CUDA event of the slot's last write
        self._slot_event: Dict[Tuple[int, int, int], torch.cuda.Event] = {}
        # per staging buffer: key -> host slab, and the event of the copies
        # out of it (the slab is reused once that event has completed)
        self._staging: List[Dict[tuple, torch.Tensor]] = [{} for _ in range(self.n_staging)]
        self._staging_event: List[Optional[torch.cuda.Event]] = [None] * self.n_staging
        self._buf_i = 0
        self._closed = False
        self._error: Optional[BaseException] = None   # a CUDA error, kept for consumers
        # supervision state, a list entry per shard (one shard), guarded by
        # _jobs_cv: degraded (uploads commit synchronously), dead (the thread
        # exhausted its restarts; producers commit inline), and the job each
        # thread holds and since when (crash poisoning, the watchdog)
        self._degraded = [False] * self.shards
        self._dead = [False] * self.shards
        self._fail_streak = [0] * self.shards
        self._crash_count = [0] * self.shards
        self._current_job: List[Optional[object]] = [None] * self.shards
        self._job_started = [0.0] * self.shards
        self._acquire_switch_interval()
        store._prefetcher = self
        self._threads = [self._new_thread(m) for m in range(self.shards)]
        for t in self._threads:
            t.start()

    def _new_thread(self, shard: int) -> threading.Thread:
        return threading.Thread(target=self._transfer_main, args=(shard,),
                                name=f"sida-prefetch-{shard}", daemon=True)

    @property
    def _thread(self) -> threading.Thread:
        """The (one) transfer thread."""
        return self._threads[0]

    # -- device ordering ------------------------------------------------
    def record_event(self) -> Optional[torch.cuda.Event]:
        """A CUDA event recorded on the calling thread's current stream (None
        on the CPU); a callable job records one after the work it enqueued."""
        if not self._cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    @contextlib.contextmanager
    def _ordered_write(self, s: int, items):
        """Around an in-place write of the slots of `items` [(g, slot, ...)]
        at sub `s` on the current stream: wait first on each slot's last
        write, then leave this write's event as theirs (for an upload, the
        device half of its ready fence, recorded before the host event is
        set), also when the write raised part-way. Caller holds the store
        lock, so the slots' writes enqueue in lock order."""
        if not self._cuda or not items:
            yield None
            return
        keys = {(it[0], s, it[1]) for it in items}
        cur = torch.cuda.current_stream(self.device)
        last = (self._slot_event.get(k) for k in keys)
        for ev in {id(e): e for e in last if e is not None}.values():
            cur.wait_event(ev)
        try:
            yield None
        finally:
            done = self.record_event()
            for k in keys:
                self._slot_event[k] = done

    def _device_wait(self, needed: Dict[int, np.ndarray]) -> None:
        """Make the current stream wait on the last write of every slot that
        holds an expert of `needed` (layer -> ids): the device half of each
        ready fence, and of uploads already retired whose copies may still
        be in flight on the side stream."""
        if not self._cuda:
            return
        evs = {}
        with self._lock:
            for l, ids in needed.items():
                g, s = self.store.layer_to_gs(l)
                res = self.store.resident[(g, s)]
                for e in ids:
                    slot = res.get(int(e))
                    ev = None if slot is None else self._slot_event.get((g, s, slot))
                    if ev is not None:
                        evs[id(ev)] = ev
        cur = torch.cuda.current_stream(self.device)
        for ev in evs.values():
            cur.wait_event(ev)

    def _raise_if_fatal(self) -> None:
        if self._error is not None:
            raise RuntimeError("the prefetch transfer thread hit a CUDA error") from self._error

    # -- planning side (consumer threads) -------------------------------
    def protected_experts(self, g: int, s: int) -> Set[int]:
        """Experts at (g, s) that must survive eviction: referenced by an
        unreleased ticket or mid-upload. Caller holds the store lock."""
        prot = set(self._refs[(g, s)].keys())
        prot.update(self._pending[(g, s)].keys())
        return prot

    def events_for(self, needed: Dict[int, np.ndarray]):
        """Ready fences covering `needed` (layer -> expert ids): one entry a
        needed expert with an upload in flight. Caller holds the lock."""
        fences = []
        for l, ids in needed.items():
            g, s = self.store.layer_to_gs(l)
            pend = self._pending[(g, s)]
            for e in ids:
                for ev in pend.get(int(e), {}).values():
                    fences.append(((g, s, int(e)), ev))
        return fences

    def inflight(self) -> Dict[Tuple[int, int], Set[int]]:
        """Snapshot of experts with uploads in flight (for cache affinity)."""
        with self._lock:
            return {k: set(v.keys()) for k, v in self._pending.items() if v}

    def cache_affinity(self, table: HashTable) -> float:
        """Affinity that credits in-flight prefetches, not only residency."""
        return self.store.cache_affinity(table, inflight=self.inflight())

    @property
    def affinity_epoch(self) -> Tuple[int, int]:
        """Version key for memoising `cache_affinity`: the store's residency
        epoch plus the upload counter (uploads retire the pending entries
        that the in-flight credit reads)."""
        return (self.store._epoch, self.stats.uploads)

    def degraded_fraction(self) -> float:
        """Share of transfer shards in degraded (synchronous) mode: the
        request server's shed gate shrinks its threshold by it."""
        return sum(self._degraded) / self.shards

    def submit(self, table: HashTable, protect: bool = True,
               priority: Optional[int] = None) -> Optional[PrefetchTicket]:
        """Plan slots for `table` now; enqueue its uploads for the transfer
        thread. `protect=False` submits a fire-and-forget warming prefetch:
        nothing is pinned, so a warmed expert may be evicted before use, and
        with the warming queue at `depth` it returns None without planning.
        `priority` (default 0 protected, 2 warming) picks the transfer class;
        a protected submit waits while its class holds `depth` jobs. A dead
        shard's uploads are committed here, inline."""
        if self._closed:
            raise RuntimeError("the prefetch pipeline is closed")
        self._raise_if_fatal()
        prio = priority if priority is not None else (0 if protect else 2)
        if not protect:
            with self._jobs_cv:
                if len(self._jobs[2]) >= self.depth:
                    self.stats.warm_skipped += 1
                    return None
        with self._lock:
            trans, pending, needed = self.store.plan(table, protect_fn=self.protected_experts)
            job: Dict[int, List[tuple]] = {}
            for s, items in pending.items():
                for g, slot, e in items:
                    ev = threading.Event()
                    self._pending[(g, s)].setdefault(e, {})[slot] = ev
                    job.setdefault(s, []).append((g, slot, e, ev))
            if protect:
                for l, ids in needed.items():
                    self._refs[self.store.layer_to_gs(l)].update(int(e) for e in ids)
            # the ticket fences on every needed expert still in flight,
            # whether this submit started the upload or an earlier one did
            fences = self.events_for(needed)
            self.stats.submitted += 1
        ticket = PrefetchTicket(self, trans, needed, fences, protect)
        if job:
            # outside the store lock: the put may wait at `depth`; a planned
            # job is never dropped, its slots are already assigned
            ticket._job = job
            with self._jobs_cv:
                # a dead shard's queue never drains: the wait breaks on it
                while (protect and len(self._jobs[prio]) >= self.depth and not self._dead[0]
                       and not self._closed and self._error is None):
                    self._jobs_cv.wait()
                self._raise_if_fatal()    # no thread would ever run the job
                inline = self._dead[0]
                if not inline:
                    self._jobs[prio].append(job)
                    self._jobs_cv.notify_all()
            if inline:
                ticket._job = None
                self._commit_sync(0, job)
        return ticket

    def submit_job(self, fn: Callable[[], None], priority: int = 1) -> threading.Event:
        """Enqueue a transfer callable at `priority` and return its done
        fence (the K/V page pool's page-ins ride the pipeline this way). On
        a dead shard it runs here, inline."""
        if self._closed:
            raise RuntimeError("the prefetch pipeline is closed")
        self._raise_if_fatal()
        job = _CallableJob(fn)
        with self._jobs_cv:
            self._raise_if_fatal()
            dead = self._dead[0]
            if not dead:
                self._jobs[priority].append(job)
                self._jobs_cv.notify_all()
        if dead:
            self._run_callable(job)
        return job.done

    def _upload_done(self, g: int, s: int, slot: int, e: int, ev: threading.Event) -> None:
        """Retire one written upload's pending entry (caller holds the lock;
        the identity check skips a newer upload of the same expert)."""
        pend = self._pending[(g, s)]
        slots_ev = pend.get(e)
        if slots_ev is not None and slots_ev.get(slot) is ev:
            del slots_ev[slot]
            if not slots_ev:
                del pend[e]

    def _steal(self, ticket: PrefetchTicket) -> None:
        """If the ticket's upload job is still queued when its fence is
        reached, take it off the queue and write it inline on the consumer's
        stream: the fence was about to pay for the whole transfer anyway, so
        a starved transfer thread never makes the async path slower than
        synchronous uploads."""
        job, ticket._job = ticket._job, None
        if job is None:
            return
        with self._jobs_cv:
            for q in self._jobs:
                if any(item is job for item in q):
                    q.remove(job)
                    self._jobs_cv.notify_all()   # a producer may wait for this queue slot
                    break
            else:
                return
        with self._lock:
            for s, rows in job.items():
                self.store.commit_loads(s, [(g, sl, e) for g, sl, e, _ in rows])
                for g, sl, e, ev in rows:
                    self._upload_done(g, s, sl, e, ev)
            self.stats.uploads += sum(len(r) for r in job.values())
            self.stats.stolen += 1
        for rows in job.values():
            for *_, ev in rows:
                ev.set()

    def _refresh(self, ticket: PrefetchTicket, timeout: Optional[float] = None) -> bool:
        """Consume-time reconciliation for one ticket (see `wait`): loop until
        every needed expert is resident (or unplannable, where the sync path
        drops too), re-planning missing experts ahead of later tickets'
        refs but never evicting one mid-upload; commit re-planned loads
        inline; clear the fences (a poisoned one, rolled back after the
        residency check, takes one more round); rebuild the translation
        from live residency. The elapsed time is the pipeline's stall."""
        store = self.store
        t0 = time.perf_counter()
        self._steal(ticket)

        def _left() -> Optional[float]:
            return None if timeout is None else max(0.0, timeout - (time.perf_counter() - t0))

        ok = True
        for _ in range(64):  # in-flight uploads strictly drain between rounds
            drain: List[threading.Event] = []
            with self._lock:
                progressed_all = True
                for l, ids in ticket.needed.items():
                    g, s = store.layer_to_gs(l)
                    res = store.resident[(g, s)]
                    missing = [int(e) for e in ids if int(e) not in res]
                    if not missing:
                        continue
                    pend = self._pending[(g, s)]
                    # protect own needed residents and mid-copy uploads; later
                    # tickets' prefetched experts are fair eviction game
                    extra = set(pend.keys()) | {int(e) for e in ids}
                    loads = store.plan_layer(l, np.asarray(missing, np.int64),
                                             extra_protected=extra)
                    if loads:
                        store.commit_loads(s, loads)
                    if any(e not in res for e in missing):
                        progressed_all = False
                        drain.extend(ev for d in pend.values() for ev in d.values())
                fences = self.events_for(ticket.needed)
            poisoned = False
            for _, ev in fences:
                if not ev.wait(_left()):
                    ok = False
                    break
                poisoned |= getattr(ev, "poisoned", False)
            if not ok or (progressed_all and not drain and not poisoned):
                break
            if not all(ev.wait(_left()) for ev in drain):
                ok = False
                break
            if not drain and not poisoned:
                break  # unplannable without pending uploads: sync drops too
        self._raise_if_fatal()
        with self._lock:
            for l in ticket.needed:
                ticket.trans[l] = store.trans_row(l)
        if not ticket.failed and any(getattr(ev, "poisoned", False) for _, ev in ticket._fences):
            ticket.failed = True
        if ok:
            self._device_wait(ticket.needed)
        self.stats.stall_s += time.perf_counter() - t0
        return ok

    def _release(self, ticket: PrefetchTicket) -> None:
        if not ticket._protect:
            return
        with self._lock:
            for l, ids in ticket.needed.items():
                refs = self._refs[self.store.layer_to_gs(l)]
                refs.subtract(int(e) for e in ids)
                for e in [e for e, c in refs.items() if c <= 0]:
                    del refs[e]

    # -- transfer side (the background thread) --------------------------
    def _next_job(self):
        with self._jobs_cv:
            while True:
                q = next((q for q in self._jobs if q), None)
                if q is not None:
                    job = q.popleft()
                    self._jobs_cv.notify_all()
                    return job
                if self._closed:
                    return None
                self._jobs_cv.wait()

    def _transfer_main(self, shard: int) -> None:
        """Thread body. On the card the thread sets its device and its side
        stream and takes `no_grad` (all three are per thread, so a revived
        thread sets them again), then runs the supervised loop: a crash
        (an exception outside the per-job guards, an injected `thread:crash`
        included) poisons the job the loop held and restarts the loop in
        place; past `max_thread_restarts` crashes the shard is dead, its
        queue drains synchronously and producers commit inline until
        `revive`. A CUDA error (or a failure to set the thread up) stops
        the thread and is kept for the consumers."""
        try:
            if self._cuda:
                torch.cuda.set_device(self._stream.device)
                ctx = torch.cuda.stream(self._stream)
            else:
                ctx = contextlib.nullcontext()
            with ctx, torch.no_grad():
                self._supervise(shard)
        except Exception as exc:
            job, self._current_job[shard] = self._current_job[shard], None
            self._fail_fatal(exc, job)

    def _supervise(self, shard: int) -> None:
        while True:
            try:
                self._transfer_loop(shard)
                return                      # closed
            except Exception as exc:
                if _fatal(exc):
                    raise
                job, self._current_job[shard] = self._current_job[shard], None
                with self._jobs_cv:
                    self.stats.thread_crashes += 1
                    self._crash_count[shard] += 1
                    crashes = self._crash_count[shard]
                    closed = self._closed
                if job is not None:
                    self._fail_job(shard, job)
                if closed:
                    return
                if crashes > self.max_thread_restarts:
                    with self._jobs_cv:
                        self._dead[shard] = True
                        self._set_degraded(shard, True)
                        # producers parked in submit() re-check _dead
                        self._jobs_cv.notify_all()
                    self._drain_sync(shard)
                    return
                with self._jobs_cv:
                    self.stats.thread_restarts += 1

    def _transfer_loop(self, shard: int) -> None:
        while True:
            job = self._next_job()
            if job is None:
                return
            self._job_started[shard] = time.perf_counter()
            self._current_job[shard] = job
            if self.faults is not None:
                self.faults.inject("thread")   # outside the per-job guards
            t0 = time.perf_counter()
            if isinstance(job, _CallableJob):
                self._run_callable(job)
            else:
                self._run_upload_job(shard, job)
            self._current_job[shard] = None
            with self._jobs_cv:
                self.stats.transfer_s += time.perf_counter() - t0

    def _run_callable(self, job: _CallableJob) -> None:
        """A callable job's failure is counted and does not kill the thread;
        its waiter finds `done` set and re-checks. A CUDA error propagates."""
        try:
            job.fn()
        except Exception as exc:
            if _fatal(exc):
                raise
            with self._jobs_cv:
                self.stats.job_errors += 1
        finally:
            job.done.set()

    def _run_upload_job(self, shard: int, job: Dict[int, List[tuple]]) -> None:
        """Upload one job sub by sub, retrying a failed attempt with bounded
        exponential backoff; exhausted retries abandon the batch
        (`_fail_rows`). A degraded shard commits synchronously."""
        if self._degraded[shard]:
            self._commit_sync(shard, job)
            return
        for s, rows in job.items():
            attempt = 0
            while True:
                try:
                    self._upload(s, rows)
                    with self._jobs_cv:
                        self._fail_streak[shard] = 0
                    break
                except Exception as exc:
                    if _fatal(exc):
                        raise
                    attempt += 1
                    if attempt > self.max_retries:
                        self._fail_rows(shard, s, rows)
                        break
                    with self._jobs_cv:
                        self.stats.upload_retries += 1
                    # a retry re-stages from the host masters
                    time.sleep(self.backoff_s * (2.0 ** (attempt - 1)))

    def _set_degraded(self, shard: int, value: bool) -> None:
        """Flip one shard's degraded flag, keeping the count exact. Caller
        holds `_jobs_cv`."""
        if self._degraded[shard] != value:
            self._degraded[shard] = value
            self.stats.degraded += 1 if value else -1

    def _fail_rows(self, shard: int, s: int, rows: List[tuple]) -> None:
        """Abandon one upload batch: roll every planned slot back to its free
        list, retire the pending entries, then poison the fences (`poisoned`
        is set before `set()`, so no waiter sees a fired, unpoisoned fence of
        an abandoned upload). `degrade_after` consecutive abandonments make
        the shard degraded."""
        with self._lock:
            for g, slot, e, ev in rows:
                self.store.rollback_upload(g, s, slot, e)
                self._upload_done(g, s, slot, e, ev)
            self.stats.upload_failures += 1
            self.stats.poisoned_fences += len(rows)
        with self._jobs_cv:
            self._fail_streak[shard] += 1
            if self._fail_streak[shard] >= self.degrade_after:
                self._set_degraded(shard, True)
        for *_, ev in rows:
            ev.poisoned = True
            ev.set()

    def _fail_job(self, shard: int, job) -> None:
        """Poison a whole crashed job (`_fail_rows` rolls back only mappings
        still pointing at the planned slot)."""
        if isinstance(job, _CallableJob):
            job.done.set()
            return
        for s, rows in job.items():
            self._fail_rows(shard, s, rows)

    def _fail_fatal(self, exc: BaseException, job) -> None:
        """A CUDA error on the transfer thread: keep it, drop the queues,
        fire every fence poisoned (and retire it) and wake every producer;
        each consumer re-raises it."""
        with self._jobs_cv:
            self._error = exc
            queued = [j for q in self._jobs for j in q]
            for q in self._jobs:
                q.clear()
            self._jobs_cv.notify_all()
        for j in queued + ([job] if job is not None else []):
            if isinstance(j, _CallableJob):
                j.done.set()
        with self._lock:
            for pend in self._pending.values():
                for slots_ev in pend.values():
                    for ev in slots_ev.values():
                        ev.poisoned = True
                        ev.set()
                pend.clear()

    def _commit_sync(self, shard: int, job: Dict[int, List[tuple]]) -> None:
        """The degraded path: commit one job through the store's synchronous
        `commit_loads` (host gather and device write inline on the calling
        thread's stream, ordered by `_ordered_write`; no staging ring, no
        injected upload faults): the bytes the async path would land."""
        evs: List[threading.Event] = []
        with self._lock:
            for s, rows in job.items():
                self.store.commit_loads(s, [(g, sl, e) for g, sl, e, _ in rows])
                for g, sl, e, ev in rows:
                    self._upload_done(g, s, sl, e, ev)
                    evs.append(ev)
            n = sum(len(r) for r in job.values())
            self.stats.uploads += n
            self.stats.sync_fallbacks += n
        for ev in evs:
            ev.set()

    def _drain_sync(self, shard: int) -> None:
        """Drain the queues on the calling thread through the synchronous
        path: the dead-thread and close-time fallback that keeps "a planned
        job is never dropped" without a transfer thread."""
        while True:
            with self._jobs_cv:
                q = next((q for q in self._jobs if q), None)
                if q is None:
                    return
                job = q.popleft()
                self._jobs_cv.notify_all()
            if isinstance(job, _CallableJob):
                self._run_callable(job)
            else:
                self._commit_sync(shard, job)

    # -- watchdog (the request server calls it on an interval) ----------
    def watchdog(self, max_job_age_s: Optional[float] = None) -> Tuple[int, int]:
        """Revive dead shard threads, and count jobs a live thread has held
        longer than `max_job_age_s` (a stalled link: Python cannot preempt
        the thread, but the count reaches telemetry). Returns (revived,
        stalled)."""
        revived = stalled = 0
        now = time.perf_counter()
        for m in range(self.shards):
            if self._dead[m] and not self._closed:
                revived += self.revive(m)
            elif (max_job_age_s is not None and self._current_job[m] is not None
                  and now - self._job_started[m] > max_job_age_s):
                stalled += 1
        return revived, stalled

    def revive(self, shard: int) -> int:
        """Start a fresh thread for a dead shard and lift degraded mode (on
        probation: a still-faulty link degrades again after `degrade_after`
        failures). Returns 1 iff a thread was started."""
        with self._jobs_cv:
            if self._closed or not self._dead[shard] or self._threads[shard].is_alive():
                return 0
            self._dead[shard] = False
            self._set_degraded(shard, False)
            self._fail_streak[shard] = 0
            self._crash_count[shard] = 0
            t = self._threads[shard] = self._new_thread(shard)
            self.stats.thread_restarts += 1
        t.start()
        return 1

    def _stage(self, buf: Dict[tuple, torch.Tensor], key: tuple, arr: torch.Tensor,
               idx: torch.Tensor) -> torch.Tensor:
        """Gather rows `idx` of a host tensor [G, E, ...] (flat g·E + e)
        straight into this buffer's slab (pinned on the card, grown on
        demand), so every copy reads a stable, reusable host region."""
        if self.faults is not None:
            self.faults.inject("host_read")   # a failed host-master read
        n, tail = len(idx), tuple(arr.shape[2:])
        slab = buf.get(key)
        if slab is None or slab.shape[0] < n or tuple(slab.shape[1:]) != tail \
                or slab.dtype != arr.dtype:
            slab = torch.empty((n,) + tail, dtype=arr.dtype, pin_memory=self._cuda)
            buf[key] = slab
        view = slab[:n]
        torch.index_select(arr.reshape((-1,) + tail), 0, idx, out=view)
        return view

    def _upload(self, s: int, rows: List[tuple]) -> None:
        """Stage, copy and write one sub's upload batch, then fire its
        fences. Hot rows land the int8 / fp masters, warm rows the int4
        masters; every copied byte is counted, and where one batch fills a
        warm slot twice the last upload is what lands. An attempt that
        raises leaves the slab's event recorded (its earlier keys' copies
        may be in flight) and, past the first write, the slots' events."""
        if self.faults is not None:
            self.faults.inject("upload")
        store = self.store
        i = self._buf_i
        self._buf_i = (i + 1) % self.n_staging
        ev = self._staging_event[i]
        if ev is not None:   # double-buffer fence: the copies out of slab i
            if not ev.query():
                with self._jobs_cv:
                    self.stats.staging_waits += 1
            ev.synchronize()
        staging = self._staging[i]
        hot = [r for r in rows if r[1] < store.S8]
        warm = [r for r in rows if r[1] >= store.S8]
        E, dev = store.E, self.device
        staged, nbytes_up = [], 0
        try:
            for part, tier in ((hot, "hot"), (warm, "warm")):
                if not part:
                    continue
                idx = torch.tensor([g * E + e for g, _, e, _ in part], dtype=torch.long)
                if tier == "hot":
                    srcs = [(t, store.host, "") for t in EXPERT_TENSORS]
                    if store.quant == "int8":
                        srcs += [(t, store.host_scale, "_scale") for t in EXPERT_TENSORS]
                else:
                    srcs = [(t, store.host4, "_q4") for t in EXPERT_TENSORS]
                    srcs += [(t, store.host4_scale, "_q4_scale") for t in EXPERT_TENSORS]
                put = {}
                for t, host, suffix in srcs:
                    view = self._stage(staging, (s, t, suffix), host[f"sub{s}"][t], idx)
                    put[(t, suffix)] = _staged_put(view, dev)
                    nbytes_up += nbytes(view)
                # the last upload into each (group, slot) lands
                last = list({r[:2]: k for k, r in enumerate(part)}.values())
                S_pool, base = (store.S8, 0) if tier == "hot" else (store.S4, store.S8)
                dst = torch.tensor([part[k][0] * S_pool + part[k][1] - base for k in last],
                                   dtype=torch.long).to(dev, non_blocking=True)
                keep = torch.tensor(last, dtype=torch.long).to(dev, non_blocking=True)
                staged.append((tier, put, dst, keep))
        finally:
            self._staging_event[i] = self.record_event()
        with self._lock:
            moe_p = store.serve_params["blocks"][f"sub{s}"]["moe"]

            def write(key: str, vals: torch.Tensor, dst, keep) -> None:
                pool = moe_p[key]
                pool.view(-1, *pool.shape[2:]).index_copy_(0, dst, vals.index_select(0, keep))

            with self._ordered_write(s, rows):
                for tier, put, dst, keep in staged:
                    for t in EXPERT_TENSORS:
                        if tier == "warm":
                            write(t + "_q4", put[(t, "_q4")], dst, keep)
                            write(t + "_q4_scale", put[(t, "_q4_scale")], dst, keep)
                        elif store.quantized_slots:
                            write(t, put[(t, "")], dst, keep)
                            write(t + "_scale", put[(t, "_scale")], dst, keep)
                        elif store.quant == "int8":   # dequantise at slot write
                            q, sc = put[(t, "")], put[(t, "_scale")]
                            write(t, (q.float() * sc).to(moe_p[t].dtype), dst, keep)
                        else:
                            write(t, put[(t, "")], dst, keep)
            store.stats.bytes_h2d += nbytes_up
            # every tensor of every expert in the batch is written and its
            # CUDA event recorded: the fences may fire (no half-written slot
            # is observable)
            for g, slot, e, fence in rows:
                self._upload_done(g, s, slot, e, fence)
            self.stats.uploads += len(rows)
        for *_, fence in rows:
            fence.set()

    # -- lifecycle ------------------------------------------------------
    def close(self) -> None:
        """Drain queued uploads, join the transfer thread and detach from the
        store. Idempotent, and safe after the thread died: a dead shard's
        leftover jobs are committed here, and any fence still pending (a
        job a thread died holding) fires poisoned, so every fence and done
        event handed out has fired when it returns."""
        if self._closed:
            return
        with self._jobs_cv:
            self._closed = True
            self._jobs_cv.notify_all()
        for t in self._threads:
            t.join()
        if self._error is None:
            for m in range(self.shards):
                self._drain_sync(m)
        with self._lock:
            for pend in self._pending.values():
                for slots_ev in pend.values():
                    for ev in slots_ev.values():
                        ev.poisoned = True
                        ev.set()
                pend.clear()
        if self._cuda:
            self._stream.synchronize()
        self._staging = []
        self._staging_event = []
        self.store._prefetcher = None
        self._release_switch_interval()

    def __enter__(self) -> "PrefetchPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
