"""Expert offloading: host-resident expert store + device slot cache, and
the async prefetch pipeline (port of `repro/core/offload.py`).

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

Expert parallelism (`ShardedStoreConfig`, `ep_shards` > 1): each pool is
cut into `ep_shards` contiguous slot ranges, one a shard (tiered: a hot
range `[m·S8_loc, (m+1)·S8_loc)` and a warm one `[S8 + m·S4_loc, ...)`).
An expert has a home shard and loads only into its range, with the shard's
own free list and eviction policy, so no eviction crosses a shard. Slot ids
stay global: the pools keep the reference's `[G, S, ...]` layout on the
store's device, and the expert-parallel dispatch (`models/moe.py`) runs one
expert-FFN launch a shard over the shard's slice of the pool. With
`replicate_hot` an α-hot expert also takes up to that many extra copies in
free slots of other shards (`replicas`), translation spreads its tokens
round-robin over the copies, and `rebalance_homes` re-homes experts by
greedy LPT over the α EMA, the old primary slot kept as a replica.

`PrefetchPipeline` moves the uploads off the forward path: `submit` plans
the slots at once and a transfer thread a shard gathers the rows into its
pinned staging slabs and copies them on its own side CUDA stream, behind
per-upload ready fences (see the class). The pools are written in place on
either stream, by the store's one slot writer (`ExpertStore.write_slots`),
so every write waits on the CUDA event of the slot's previous write, and
every reader on the events of the slots it reads.

The pipeline is supervised as the reference's is: an upload batch that
fails is retried with bounded backoff, then abandoned (its slots rolled back
to the free lists and its fences poisoned, so waiters replan), repeated
abandonments degrade the shard to synchronous commits, a crashed transfer
thread restarts in place, and one that crashes too often is revived by the
`watchdog`. A `FaultPlan` (`faults=`) injects failures at the reference's
sites. A CUDA error is never retried: it is kept and re-raised to the
consumers.

The slot bookkeeping is the reference's, so the same table stream gives the
same resident sets, replicas, homes, tier moves, evictions, hits,
translations and byte counts.

Given a `serving.telemetry.Telemetry` (`telemetry=`), the store records a
`store.upload` span around each inline commit and counts its bytes
(`upload_bytes_inline`); the pipeline a `transfer.job` span around each
job on a transfer thread (`upload_bytes_transfer`), `transfer.staging_wait`
around the double-buffer fence, and `prefetch.backpressure` around a
submit's wait for queue room. Without one they record nothing.
"""
from __future__ import annotations

import collections
import contextlib
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TierConfig
from repro_torch.core.hash_table import HashTable
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.transformer import n_moe_layers, period, sub_kind
from repro_torch.tree import tree_map

if TYPE_CHECKING:   # serving/ imports the engines: no import at run time
    from repro_torch.serving.telemetry import Telemetry

EXPERT_TENSORS = ("w_in", "w_gate", "w_out")


@dataclass(frozen=True)
class ShardedStoreConfig:
    """Expert-parallel partitioning of the serving slot pools.

    With `ep_shards` > 1 every (group, sub) slot pool splits into
    `ep_shards` contiguous partitions: each expert has a home shard
    (`placement`) and takes new slots only in that shard's range, under the
    shard's own eviction policy, free list and pin protection. Slot ids stay
    global (`shard * slots_per_shard + local`), so translation tables,
    tickets and routing overrides are unchanged; the expert-parallel dispatch
    derives each shard's local ids from the global id's range.

    `replicate_hot` > 0 lets α-hot experts hold up to that many extra copies
    on other shards, in free slots only (a replica never evicts a primary);
    translation spreads a replicated expert's tokens round-robin over its
    copies, least-loaded shard first. `hot_alpha` is the decayed-α share
    above which an expert is hot (default 2 / E); `alpha_decay` is the
    per-table decay of the α EMA that also drives
    `ExpertStore.rebalance_homes`."""

    ep_shards: int = 1
    model_axis: str = "model"
    placement: str = "mod"            # "mod": e -> e % shards | "block": e -> e // (E/shards)
    replicate_hot: int = 0            # extra copies a hot expert may hold
    hot_alpha: Optional[float] = None  # hot threshold as a share of total α
    alpha_decay: float = 0.9          # per-table decay of the α-mass EMA

    @property
    def enabled(self) -> bool:
        return self.ep_shards > 1

    def home_shards(self, num_experts: int) -> np.ndarray:
        """[E] expert -> home shard under the configured placement."""
        e = np.arange(num_experts)
        if self.placement == "block":
            blk = max(num_experts // self.ep_shards, 1)
            return np.minimum(e // blk, self.ep_shards - 1).astype(np.int32)
        if self.placement != "mod":
            raise ValueError(f"unknown placement {self.placement!r}")
        return (e % self.ep_shards).astype(np.int32)


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
    replica_loads: int = 0         # extra-copy uploads of hot experts (also in loads)
    rebalance_moves: int = 0       # primaries migrated by rebalance_homes
    promotions: int = 0            # warm (int4) -> hot (int8) tier moves
    demotions: int = 0             # hot (int8) -> warm (int4) tier moves
    pin_quota_refusals: int = 0    # tenant pins refused at the quota cap

    def reset(self):
        self.bytes_h2d = self.loads = self.evictions = self.hits = self.dropped = 0
        self.prepare_time = 0.0
        self.replica_loads = self.rebalance_moves = 0
        self.promotions = self.demotions = 0
        self.pin_quota_refusals = 0


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


_NO_SPAN = contextlib.nullcontext()


def span(telemetry: Optional["Telemetry"], name: str, ident: Optional[int] = None):
    """`telemetry.span(name, ident)`, or one shared no-op without a registry."""
    return _NO_SPAN if telemetry is None else telemetry.span(name, ident)


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


def sharded_tier_geometry(tier, slots_per_layer: int, E: int,
                          shapes: List[Tuple[int, int]], shards: int) -> Tuple[int, int]:
    """`tier_geometry` rounded to `shards` (the reference's rounding): each
    tier's count a whole number of slots a shard, the hot tier at least one
    a shard."""
    S8, S4 = tier_geometry(tier, slots_per_layer, E, shapes)
    if shards > 1:
        S8 = max((S8 // shards) * shards, shards)
        S4 = (S4 // shards) * shards
    return S8, S4


class ExpertStore:
    """Host store + device slot cache for every MoE layer of a model.

    `params` may live on any device: the expert stacks are copied to host
    masters, every other leaf is moved to `device`, routers are dropped.

    `sharded` partitions the pools expert-parallel (`ShardedStoreConfig`):
    `slots_per_layer` stays the total a layer, split evenly into per-shard
    partitions with their own eviction and pin bookkeeping. `mesh` (an
    `launch.mesh.EPMesh`, optional) names the shards' device; every shard's
    range lives in the one pool tensor on that device."""

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
        sharded: Optional[ShardedStoreConfig] = None,
        mesh=None,
        telemetry: Optional["Telemetry"] = None,
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
        if mesh is not None and device is None:
            device = mesh.device
        self.device = resolve_device(device)
        self.cfg = cfg
        self.per = period(cfg)
        self.n_groups = cfg.n_layers // self.per
        self.moe_subs = [s for s in range(self.per) if sub_kind(cfg, s)["moe"]]
        self.L = n_moe_layers(cfg)
        self.E = cfg.moe.num_experts
        self.sharded = sharded or ShardedStoreConfig()
        self.shards = self.sharded.ep_shards
        if self.shards < 1:
            raise ValueError(f"ep_shards must be >= 1, got {self.shards}")
        # one slot per expert copy at most: E without replication, E x the
        # copies a hot expert may hold with it (one a shard)
        copies = (min(self.shards, 1 + max(0, self.sharded.replicate_hot))
                  if self.shards > 1 else 1)
        self.S = min(slots_per_layer, self.E * copies)
        if self.shards > 1:
            if self.E % self.shards:
                raise ValueError(f"experts ({self.E}) must divide over ep_shards ({self.shards})")
            if self.S < self.shards:
                raise ValueError(f"need >= 1 slot per shard (slots={self.S}, "
                                 f"shards={self.shards})")
            self.S = (self.S // self.shards) * self.shards   # an even split
        self.S_loc = self.S // self.shards
        # expert -> home shard: where new primaries load (rebalance_homes
        # re-assigns it from the α EMA)
        self.home = self.sharded.home_shards(self.E)
        self.R = copies                 # copies a hot expert may hold
        self.mesh = mesh
        if mesh is not None:
            if mesh.shape.get(self.sharded.model_axis) != self.shards:
                raise ValueError(f"the mesh's {self.sharded.model_axis!r} axis "
                                 f"({mesh.shape}) must have ep_shards={self.shards} entries")
            if resolve_device(mesh.device) != self.device:
                raise ValueError(f"the mesh's device {mesh.device} is not the store's "
                                 f"{self.device}")
        self.eviction = eviction
        self.stats = TransferStats()
        self.telemetry = telemetry

        # hot int8 / warm int4 tiers: `slots_per_layer` stays the budget in
        # int8-slot bytes (`tier_geometry`)
        self.tier = cfg.quant.tier if tier is None else tier
        self.tiered = bool(self.tier is not None and self.tier.enabled)
        moe_p0 = params["blocks"][f"sub{self.moe_subs[0]}"]["moe"]
        self._expert_shapes = [tuple(moe_p0[t].shape[2:]) for t in EXPERT_TENSORS]
        self.S8, self.S4 = self.S, 0
        self.S8_loc, self.S4_loc = self.S_loc, 0
        if self.tiered:
            if not self.quantized_slots:
                raise ValueError("the int4 warm tier layers on int8-resident slots "
                                 "(--int4-slots requires --quantized-slots)")
            if self.sharded.replicate_hot:
                raise ValueError("hot-expert replication and residency tiering are mutually "
                                 "exclusive (a replica's tier would be ambiguous)")
            S8, S4 = sharded_tier_geometry(self.tier, slots_per_layer, self.E,
                                           self._expert_shapes, self.shards)
            self.S8, self.S4 = S8, S4
            self.S = S8 + S4
            self.S8_loc, self.S4_loc = S8 // self.shards, S4 // self.shards
            self.S_loc = self.S8_loc + self.S4_loc
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
            moe_p.pop("router_bias", None)
        self.serve_params = tree_map(lambda x: x.to(self.device), serve_params)

        # per (group, sub): expert -> global slot (`resident`, primaries),
        # and per shard each tier's policy and free list (hot slots
        # [m·S8_loc, (m+1)·S8_loc), warm [S8 + m·S4_loc, ...)): replacement
        # never crosses a shard
        self.resident: Dict[Tuple[int, int], Dict[int, int]] = {}
        self.policy: Dict[Tuple[int, int], List[EvictionPolicy]] = {}
        self.free: Dict[Tuple[int, int], List[List[int]]] = {}
        self.policy4: Dict[Tuple[int, int], List[EvictionPolicy]] = {}
        self.free4: Dict[Tuple[int, int], List[List[int]]] = {}
        self.pinned: Dict[Tuple[int, int], Set[int]] = {}
        # extra copies: expert -> {shard: global slot}; the primary stays in
        # `resident`, and each shard's policy tracks only the primaries it hosts
        self.replicas: Dict[Tuple[int, int], Dict[int, Dict[int, int]]] = {}
        self.alpha_ema: Dict[Tuple[int, int], np.ndarray] = {}   # decayed α mass per expert
        for g in range(self.n_groups):
            for s in self.moe_subs:
                self.resident[(g, s)] = {}
                self.policy[(g, s)] = [EVICTION_POLICIES[eviction]() for _ in range(self.shards)]
                self.free[(g, s)] = [list(range(m * self.S8_loc, (m + 1) * self.S8_loc))
                                     for m in range(self.shards)]
                self.policy4[(g, s)] = [EVICTION_POLICIES[eviction]() for _ in range(self.shards)]
                self.free4[(g, s)] = [list(range(self.S8 + m * self.S4_loc,
                                                 self.S8 + (m + 1) * self.S4_loc))
                                      for m in range(self.shards)]
                self.pinned[(g, s)] = set()
                self.replicas[(g, s)] = {}
                self.alpha_ema[(g, s)] = np.zeros((self.E,), np.float64)
        # tenant pins: (group, sub) -> expert -> owning tenant, and each
        # tenant's cap as a share of a layer's slots (`set_pin_quota`)
        self.pin_owner: Dict[Tuple[int, int], Dict[int, str]] = {
            gs: {} for gs in self.resident}
        self.pin_quota: Dict[str, float] = {}
        # decayed α mass dispatched a home shard (the load half of
        # `shard_load_score`; the other half is the uploads a shard made)
        self._shard_alpha = np.zeros((self.shards,), np.float64)
        self._lock = threading.RLock()
        self._prefetcher: Optional["PrefetchPipeline"] = None
        # (g, s, global slot) -> CUDA event of the slot's last write, kept
        # while a pipeline is attached (`write_slots`)
        self._slot_event: Dict[Tuple[int, int, int], torch.cuda.Event] = {}
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

    # -- expert-parallel shard geometry ----------------------------------
    def shard_of(self, e: int) -> int:
        """Current home shard of expert `e`, where new primary loads go; a
        replica or a promoted primary may sit on another shard."""
        return int(self.home[e])

    def shard_slots(self, shard: int) -> range:
        """Global hot slot ids of `shard` (a contiguous range); its warm
        slots are [S8 + shard·S4_loc, S8 + (shard + 1)·S4_loc)."""
        return range(shard * self.S8_loc, (shard + 1) * self.S8_loc)

    def slot_shard(self, slot: int) -> int:
        """The shard hosting a global slot id, hot or warm."""
        if self.S4 and slot >= self.S8:
            return (int(slot) - self.S8) // self.S4_loc
        return int(slot) // self.S8_loc

    def slot_tier(self, slot: int) -> str:
        """'hot' (int8 pool) or 'warm' (int4 pool) for a global slot id."""
        return "warm" if (self.S4 and slot >= self.S8) else "hot"

    def local_trans(self, trans: np.ndarray) -> np.ndarray:
        """Global translation table [L, E] -> each slot's id in its shard's
        local space (misses stay -1): hot slots [0, S8_loc), then warm slots
        [S8_loc, S8_loc + S4_loc). Derived from the slot, not the home: a
        primary may sit off its home shard. The dispatch derives the same
        on the device from the global ids."""
        if self.S4:
            warm = trans >= self.S8
            local = np.where(warm, self.S8_loc + (trans - self.S8) % self.S4_loc,
                             trans % self.S8_loc)
            return np.where(trans >= 0, local, -1).astype(np.int32)
        return np.where(trans >= 0, trans % self.S_loc, -1).astype(np.int32)

    # ------------------------------------------------------------------
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
        through the normal prepare path; they just cannot be victims, in
        whichever shard hosts them.

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
        fed to the eviction policy and, sharded or tiered, to the α EMA that
        ranks tier moves, picks hot experts to replicate and drives
        `rebalance_homes`. `extra_protected` experts survive eviction and,
        like pinned ones, never move between tiers (a translation in flight
        may point at their slot). A new expert loads on its home shard: a
        free slot, else a replica's slot reclaimed, else the shard policy's
        victim (a victim with a replica promotes it instead of leaving)."""
        g, s = self.layer_to_gs(l)
        res = self.resident[(g, s)]
        policies = self.policy[(g, s)]
        free = self.free[(g, s)]
        needed_set = {int(e) for e in needed}
        protected = needed_set | self.pinned[(g, s)]
        move_blocked = set(self.pinned[(g, s)])
        if extra_protected:
            protected |= extra_protected
            move_blocked |= extra_protected
        if mass is not None and (self.shards > 1 or self.tiered):
            # one full table pass decays the EMAs by alpha_decay overall
            d = self.sharded.alpha_decay ** (1.0 / max(self.L, 1))
            ema = self.alpha_ema[(g, s)]
            ema *= d
            ema += mass
            self._shard_alpha *= d
            self._shard_alpha += np.bincount(self.home, weights=mass, minlength=self.shards)
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
            sh = int(self.home[e])
            policy = policies[sh]
            if free[sh]:
                slot = free[sh].pop()
            else:
                # replicas are opportunistic: their slots go before a primary
                slot = self._reclaim_replica(g, s, sh, protected)
            if slot is None:
                victim = policy.pick_victim(protected)
                if victim is None:
                    # hot tier full of protected residents: load into a warm
                    # slot instead of dropping (combined capacity S8 + S4)
                    wslot = self._take_warm_slot(g, s, sh, protected) if self.tiered else None
                    if wslot is None:
                        self.stats.dropped += 1  # everything resident is protected
                        continue
                    res[e] = wslot
                    self.policy4[(g, s)][sh].admit(e, w)
                    pending.append((g, wslot, e))
                    self.stats.loads += 1
                    continue
                slot = res.pop(victim)
                v_reps = self.replicas[(g, s)].get(victim)
                wslot = None
                if v_reps:
                    # a live copy elsewhere: promote it to primary, only this
                    # shard's slot is reclaimed
                    m = min(v_reps)
                    res[victim] = v_reps.pop(m)
                    if not v_reps:
                        del self.replicas[(g, s)][victim]
                    policies[m].admit(victim, 0.0)
                elif self.tiered and victim not in move_blocked:
                    # demote instead of evict: the victim stays resident in a
                    # warm slot, re-uploaded from its int4 host master
                    wslot = self._take_warm_slot(g, s, sh, protected)
                    if wslot is not None:
                        res[victim] = wslot
                        self.policy4[(g, s)][sh].admit(
                            victim, float(self.alpha_ema[(g, s)][victim]))
                        pending.append((g, wslot, victim))
                        self.stats.demotions += 1
                        self.stats.loads += 1
                    else:
                        self.stats.evictions += 1
                else:
                    self.stats.evictions += 1
            res[e] = slot
            policy.admit(e, w)
            pending.append((g, slot, e))
            self.stats.loads += 1
        if self.R > 1 and mass is not None:
            pending.extend(self._plan_replicas(g, s, needed_set, protected))
        if pending:
            # every residency change (load, eviction, tier move) plans an upload
            self._epoch += 1
        return pending

    def _touch(self, g: int, s: int, e: int, slot: int, w: float) -> None:
        """Route a reference to the policy of the tier and shard holding
        `slot` (a promoted or re-homed primary may sit off its home)."""
        pols = self.policy4 if self.slot_tier(slot) == "warm" else self.policy
        pols[(g, s)][self.slot_shard(slot)].touch(e, w)

    def _take_warm_slot(self, g: int, s: int, sh: int, protected: Set[int]) -> Optional[int]:
        """A warm slot on shard `sh`: a free one, else the shard's warm
        policy victim evicted to the host. None when every warm resident
        there is protected."""
        free4 = self.free4[(g, s)][sh]
        if free4:
            return free4.pop()
        v4 = self.policy4[(g, s)][sh].pick_victim(protected)
        if v4 is None:
            return None
        self.stats.evictions += 1
        return self.resident[(g, s)].pop(v4)

    def _peek_hot_victim(self, g: int, s: int, sh: int, excluded: Set[int]) -> Optional[int]:
        """The hot resident of shard `sh` with the least decayed α mass
        outside `excluded`, without touching the policy's books."""
        ema = self.alpha_ema[(g, s)]
        best = None
        for e2, slot in self.resident[(g, s)].items():
            if slot >= self.S8 or self.slot_shard(slot) != sh or e2 in excluded:
                continue
            if best is None or ema[e2] < ema[best]:
                best = e2
        return best

    def _promote(self, g: int, s: int, e: int, w: float, excluded: Set[int],
                 pending: List[Tuple[int, int, int]]) -> bool:
        """Move warm-resident `e` into its shard's hot tier: into a free hot
        slot, else by swapping with the coldest movable hot resident when
        e's decayed α mass beats it by `tier.promote_margin` (hysteresis).
        The moved experts are re-uploaded from their host masters. Returns
        True iff a move happened."""
        res = self.resident[(g, s)]
        ema = self.alpha_ema[(g, s)]
        wslot = res[e]
        sh = self.slot_shard(wslot)
        free = self.free[(g, s)][sh]
        if free:
            hot_slot = free.pop()
            self.free4[(g, s)][sh].append(wslot)
            self.policy4[(g, s)][sh].forget(e)
            res[e] = hot_slot
            self.policy[(g, s)][sh].admit(e, w)
            pending.append((g, hot_slot, e))
            self.stats.promotions += 1
            self.stats.loads += 1
            return True
        v = self._peek_hot_victim(g, s, sh, excluded)
        if v is None or float(ema[e]) <= 0.0:
            return False
        if float(ema[e]) < self.tier.promote_margin * float(ema[v]):
            return False
        hot_slot = res[v]
        res[e], res[v] = hot_slot, wslot
        self.policy[(g, s)][sh].forget(v)
        self.policy4[(g, s)][sh].forget(e)
        self.policy[(g, s)][sh].admit(e, w)
        self.policy4[(g, s)][sh].admit(v, float(ema[v]))
        pending.append((g, hot_slot, e))
        pending.append((g, wslot, v))
        self.stats.promotions += 1
        self.stats.demotions += 1
        self.stats.loads += 2
        return True

    def _reclaim_replica(self, g: int, s: int, sh: int, protected: Set[int]) -> Optional[int]:
        """Free one replica slot on shard `sh`, the replica of least decayed
        α mass first, skipping protected experts' (a pending fence may
        target that slot). Returns the freed global slot, or None."""
        reps = self.replicas[(g, s)]
        ema = self.alpha_ema[(g, s)]
        best = None
        for e, by_shard in reps.items():
            if e in protected or sh not in by_shard:
                continue
            if best is None or ema[e] < ema[best]:
                best = e
        if best is None:
            return None
        slot = reps[best].pop(sh)
        if not reps[best]:
            del reps[best]
        self._epoch += 1
        return slot

    def _plan_replicas(self, g: int, s: int, needed: Set[int],
                       protected: Set[int]) -> List[Tuple[int, int, int]]:
        """Extra copies for the α-hot needed experts: up to `R` copies each,
        in free slots only (replication never evicts), least-loaded shards
        first. Caller holds the lock; returns the (g, slot, e) uploads."""
        res = self.resident[(g, s)]
        reps = self.replicas[(g, s)]
        free = self.free[(g, s)]
        ema = self.alpha_ema[(g, s)]
        tot = float(ema.sum())
        if tot <= 0.0:
            return []
        share = self.sharded.hot_alpha if self.sharded.hot_alpha is not None else 2.0 / self.E
        thr = share * tot
        score = self.shard_load_score()
        hot = sorted((e for e in needed if e in res and float(ema[e]) >= thr),
                     key=lambda e: -float(ema[e]))
        out: List[Tuple[int, int, int]] = []
        for e in hot:
            by_shard = reps.get(e)
            have = {res[e] // self.S_loc} | set(by_shard or ())
            for m in sorted(range(self.shards), key=lambda m: (score[m], m)):
                if len(have) >= self.R:
                    break
                if m in have or not free[m]:
                    continue
                slot = free[m].pop()
                if by_shard is None:
                    by_shard = reps.setdefault(e, {})
                by_shard[m] = slot
                have.add(m)
                out.append((g, slot, e))
                self.stats.loads += 1
                self.stats.replica_loads += 1
        return out

    def shard_load_score(self) -> np.ndarray:
        """[shards] relative load: the normalised decayed α mass a home
        shard dispatched, plus half the normalised uploads each shard's
        transfer queue made (`uploads_by_shard`, with a pipeline). Lower is
        less loaded; replica placement and the replica pick order by it."""
        load = self._shard_alpha.copy()
        tot = load.sum()
        load = load / tot if tot > 0 else np.zeros_like(load)
        pf = self._prefetcher
        if pf is not None:
            ups = np.array([float(pf.stats.uploads_by_shard.get(m, 0))
                            for m in range(self.shards)], np.float64)
            utot = ups.sum()
            if utot > 0:
                load = load + 0.5 * ups / utot
        return load

    # -- slot writes: every write into a slot pool goes through `write_slots`
    def slot_sources(self, s: int, warm: bool) -> List[Tuple[str, torch.Tensor]]:
        """The (key, host master [G, E, ...]) pairs that a write into the
        warm or the hot tier of sub `s` gathers. Warm slots take the
        nibble-packed int4 masters and their group scales (`w_*_q4`,
        `w_*_q4_scale`). Hot slots take the fp or int8 masters (`w_*`) and,
        for int8 ones, their scale planes (`w_*_scale`): int8 slots keep both
        as they are, fp slots (`host_quant="int8"`, half the H2D bytes of
        bf16) are written dequantised and have no scale pool."""
        sub = f"sub{s}"
        if warm:
            return [(t + sfx, host[sub][t]) for t in EXPERT_TENSORS
                    for sfx, host in (("_q4", self.host4), ("_q4_scale", self.host4_scale))]
        out = [(t, self.host[sub][t]) for t in EXPERT_TENSORS]
        if self.quant == "int8":
            out += [(t + "_scale", self.host_scale[sub][t]) for t in EXPERT_TENSORS]
        return out

    def slot_tiers(self, items: List[tuple]) -> List[Tuple[bool, List[tuple]]]:
        """`items` [(g, slot, e, ...)] split at S8 into [(warm, rows)], the
        hot rows first, an empty tier left out: the split that every gather
        and `write_slots` share."""
        if not self.S4:
            return [(False, items)] if items else []
        tiers = ((False, [r for r in items if r[1] < self.S8]),
                 (True, [r for r in items if r[1] >= self.S8]))
        return [(warm, rows) for warm, rows in tiers if rows]

    def write_slots(self, s: int,
                    parts: List[Tuple[bool, List[tuple], Dict[str, torch.Tensor]]]) -> None:
        """Write gathered expert rows into the slot pools of sub `s`, in
        place on the current stream: the one write path of every upload.
        `parts` is [(warm, rows, vals)] as `slot_tiers` split the rows, with
        `vals` holding each `slot_sources` key's rows already on the device,
        in row order. A source with a pool of its own lands as it is; int8
        rows into fp slots are dequantised with their scale planes (the
        reference's `_pool_set_q`). Slot ids are global, so a shard's range
        and a replica take the same write.

        The last upload into each (group, slot) is the one that lands; every
        row was gathered and counted. Only the warm tier can meet a slot
        twice in one write. A commit or an upload job carries one plan's rows
        of a (group, sub), and `plan_layer` fills a hot slot only for an
        expert it needs, or a replica of one, which stays protected from
        eviction for the rest of the plan (`rebalance_homes` moves each
        primary once), so no hot slot is refilled. A warm slot is, when a
        demotion evicts the expert an earlier demotion of the plan put there.

        Ordering, while a prefetch pipeline is attached (a transfer stream
        then writes slots too): each write first makes the current stream
        wait on the CUDA event of its slots' last writes (no two writes to a
        slot race), then leaves its own event as theirs in `_slot_event`, also
        when it raised part-way. For an upload that event is the device half
        of its ready fence: the pipeline sets the host fence only after this
        returns, so no half-written slot is observable, and a reader's
        stream waits on it (`wait_slots`). Callers hold the store lock, so
        the writes to a slot enqueue in lock order. Without a pipeline every
        write runs on the caller's stream, ahead of every later forward on
        it, and no event is recorded."""
        if not parts:
            return
        moe_p = self.serve_params["blocks"][f"sub{s}"]["moe"]
        dev = self.device
        ordered = self._prefetcher is not None and dev.type == "cuda"
        if ordered:
            keys = {(r[0], s, r[1]) for _, rows, _ in parts for r in rows}
            cur = torch.cuda.current_stream(dev)
            last = (self._slot_event.get(k) for k in keys)
            for ev in {id(e): e for e in last if e is not None}.values():
                cur.wait_event(ev)
        try:
            for warm, rows, vals in parts:
                S_pool, base = (self.S4, self.S8) if warm else (self.S8, 0)
                # (group, slot) -> its last row, in first-seen order
                last_of = {r[:2]: k for k, r in enumerate(rows)}
                dst = torch.tensor([g * S_pool + slot - base for g, slot in last_of],
                                   dtype=torch.long).to(dev, non_blocking=True)
                keep = None
                if len(last_of) < len(rows):
                    keep = torch.tensor(list(last_of.values()),
                                        dtype=torch.long).to(dev, non_blocking=True)
                for key, v in vals.items():
                    pool = moe_p.get(key)
                    if pool is None:
                        continue             # a scale plane, folded into its fp slot
                    if v.dtype != pool.dtype:    # int8 rows into fp slots
                        v = (v.float() * vals[key + "_scale"]).to(pool.dtype)
                    if keep is not None:
                        v = v.index_select(0, keep)
                    pool.view(-1, *pool.shape[2:]).index_copy_(0, dst, v)
        finally:
            if ordered:
                done = torch.cuda.Event()
                done.record(cur)
                for k in keys:
                    self._slot_event[k] = done

    def wait_slots(self, needed: Dict[int, np.ndarray]) -> None:
        """Make the current stream wait on the last write of every slot that
        holds an expert of `needed` (layer -> ids), its replicas included:
        the device half of each ready fence, and of uploads already retired
        whose copies may still be in flight on a side stream. Nothing to wait
        on without a pipeline (`write_slots`)."""
        if self._prefetcher is None or self.device.type != "cuda":
            return
        evs = {}
        with self._lock:
            for l, ids in needed.items():
                g, s = self.layer_to_gs(l)
                for e in ids:
                    for slot in self.copies_of(g, s, int(e)):
                        ev = self._slot_event.get((g, s, slot))
                        if ev is not None:
                            evs[id(ev)] = ev
        cur = torch.cuda.current_stream(self.device)
        for ev in evs.values():
            cur.wait_event(ev)

    def commit_loads(self, s: int, items: List[Tuple[int, int, int]]) -> None:
        """Inline host -> device writes of sub `s`'s planned loads: each
        tier's rows of every `slot_sources` master are gathered from the
        pageable host masters, copied to the device on the caller's stream
        and written by `write_slots`. Every write that is not a transfer
        thread's upload comes through here."""
        b0 = self.stats.bytes_h2d
        with span(self.telemetry, "store.upload"):
            parts = []
            for warm, rows in self.slot_tiers(items):
                gs, _, es = (torch.tensor(col, dtype=torch.long) for col in zip(*rows))
                vals = {}
                for key, host in self.slot_sources(s, warm):
                    v = host[gs, es]                         # [n, ...]
                    self.stats.bytes_h2d += nbytes(v)
                    vals[key] = v.to(self.device)
                parts.append((warm, rows, vals))
            self.write_slots(s, parts)
        if self.telemetry is not None:
            self.telemetry.counter("upload_bytes_inline").inc(self.stats.bytes_h2d - b0)

    def rollback_upload(self, g: int, s: int, slot: int, e: int) -> bool:
        """Withdraw the residency published at plan time for one abandoned
        upload (caller holds the lock): the slot goes back to its tier's
        and shard's free list, so no translation built after this points at
        a slot whose bytes never landed. A replica is dropped; a primary
        with a live replica promotes it. A mapping that moved on since (an
        evict and reload raced the failure) is left to its newer upload.
        Returns True iff a mapping was rolled back."""
        sh = self.slot_shard(slot)
        res = self.resident[(g, s)]
        reps = self.replicas[(g, s)].get(e)
        warm = self.slot_tier(slot) == "warm"
        if reps is not None and reps.get(sh) == slot:
            del reps[sh]
            if not reps:
                del self.replicas[(g, s)][e]
        elif res.get(e) == slot:
            del res[e]
            (self.policy4 if warm else self.policy)[(g, s)][sh].forget(e)
            if reps:
                m = min(reps)
                res[e] = reps.pop(m)
                if not reps:
                    del self.replicas[(g, s)][e]
                self.policy[(g, s)][m].admit(e, 0.0)
        else:
            return False
        (self.free4 if warm else self.free)[(g, s)][sh].append(slot)
        self._epoch += 1
        return True

    def trans_row(self, l: int) -> np.ndarray:
        g, s = self.layer_to_gs(l)
        row = np.full((self.E,), -1, np.int32)
        for e, slot in self.resident[(g, s)].items():
            row[e] = slot
        return row

    def copies_of(self, g: int, s: int, e: int) -> List[int]:
        """Every slot holding expert `e` at (g, s): its primary, then its
        replicas (empty when it is not resident)."""
        slot = self.resident[(g, s)].get(e)
        if slot is None:
            return []
        return [slot, *self.replicas[(g, s)].get(e, {}).values()]

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
            # sharded and tiered stores always take the mass: the α EMA
            # feeds replication, rebalancing and tier moves
            if (len(needed) > self.S or self.eviction == "alpha"
                    or self.shards > 1 or self.tiered):
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
        self.wait_slots(needed)
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

    def replica_cand(self, trans: np.ndarray) -> np.ndarray:
        """The translation table [L, E] as candidate slots [L, E, R]: each
        expert's live copies (primary and replicas), least-loaded hosting
        shard first, tiled cyclically to R, so the per-token round-robin
        pick spreads a replicated expert's tokens over its copies. Without
        replication (R = 1) it is the table itself."""
        if self.R <= 1:
            return trans.reshape(self.L, self.E, 1).astype(np.int32)
        cand = np.repeat(trans[:, :, None], self.R, axis=2).astype(np.int32)
        with self._lock:
            score = self.shard_load_score()
            for l in range(self.L):
                g, s = self.layer_to_gs(l)
                for e, by_shard in self.replicas[(g, s)].items():
                    if trans[l, e] < 0 or not by_shard:
                        continue
                    copies = [int(trans[l, e])] + [int(sl) for sl in by_shard.values()]
                    copies.sort(key=lambda sl: (score[self.slot_shard(sl)], sl))
                    for r in range(self.R):
                        cand[l, e, r] = copies[r % len(copies)]
        return cand

    def translate(self, table: HashTable, trans: np.ndarray):
        """(slot_ids [L,B,S,k] int32, weights [L,B,S,k] f32).

        Each routed (token, k) lane of flat index i picks copy i % R of its
        expert (`replica_cand`): every copy holds the same weights. Predicted
        experts that missed residency get slot 0 and weight 0, and each
        token's surviving weights are renormalised to the α mass the hash
        function predicted; a token whose every expert missed keeps weight 0."""
        L, B, S, k = table.expert_ids.shape
        cand = self.replica_cand(trans)                               # [L, E, R]
        flat = table.expert_ids.reshape(L, -1)
        s_all = np.take_along_axis(cand, flat[:, :, None], axis=1)    # [L, T, R]
        rr = (np.arange(flat.shape[1]) % cand.shape[2])[None, :, None]
        slots = np.take_along_axis(s_all, rr, axis=2)[..., 0].reshape(L, B, S, k)
        w = table.weights * (slots >= 0)
        orig = table.weights.sum(axis=-1, keepdims=True)
        surv = w.sum(axis=-1, keepdims=True)
        scale = np.where(surv > 0, orig / np.maximum(surv, 1e-12), 1.0)
        w = w * scale
        return np.maximum(slots, 0).astype(np.int32), w.astype(np.float32)

    def translate_device(self, ids: torch.Tensor, w: torch.Tensor, trans: np.ndarray,
                         step: Optional[int] = None):
        """`translate` on the device, for the decode loop: the predictor's
        still-resident ids / α [L, B, S, k] plus the host-planned table
        [L, E] -> (slot_ids int32, weights fp32) on ids' device, with the
        same replica pick, miss zeroing and renormalisation. `step` is the
        `decode.translate` span's ident."""
        with span(self.telemetry, "decode.translate", step):
            L = ids.shape[0]
            cand = torch.from_numpy(self.replica_cand(trans)).to(ids.device)   # [L, E, R]
            R = cand.shape[2]
            flat = ids.reshape(L, -1).long()
            s_all = torch.gather(cand, 1, flat[:, :, None].expand(-1, -1, R))  # [L, T, R]
            rr = (torch.arange(flat.shape[1], device=ids.device) % R)[None, :, None].expand(
                L, -1, 1)
            slots = torch.gather(s_all, 2, rr)[..., 0].reshape(ids.shape)
            wz = w.float()
            masked = wz * (slots >= 0)
            orig = wz.sum(dim=-1, keepdim=True)
            surv = masked.sum(dim=-1, keepdim=True)
            scale = torch.where(surv > 0, orig / torch.clamp(surv, min=1e-12),
                                torch.ones_like(surv))
            return torch.clamp(slots, min=0).to(torch.int32), masked * scale

    # ------------------------------------------------------------------
    def rebalance_homes(self) -> int:
        """Online load-aware placement: re-assign home shards by greedy LPT
        over the summed decayed α EMA (heaviest expert first onto the
        lightest shard, E / shards each), then move resident primaries to
        their new homes. A moved primary's old slot becomes a replica (still
        readable until a later plan reclaims it); the new copy takes over a
        replica already on the target shard, or uploads into a free or
        reclaimed slot through the pipeline's queues (`submit_loads`) or
        inline. Every translation taken before, during or after a move names
        slots that hold the expert. Returns the number of primaries moved."""
        if self.shards <= 1 or self.tiered:
            # a tiered store places by tier moves; a moved primary's tier
            # would have to be re-derived per shard
            return 0
        pf = self._prefetcher
        moved = 0
        with self._lock:
            ema = np.zeros((self.E,), np.float64)
            for arr in self.alpha_ema.values():
                ema += arr
            if ema.sum() <= 0.0:
                return 0
            cap = self.E // self.shards
            load = np.zeros((self.shards,), np.float64)
            count = np.zeros((self.shards,), np.int64)
            new_home = np.empty((self.E,), np.int32)
            for e in np.argsort(-ema, kind="stable"):
                m = min((m for m in range(self.shards) if count[m] < cap),
                        key=lambda m: (load[m], m))
                new_home[e] = m
                load[m] += ema[e]
                count[m] += 1
            if np.array_equal(new_home, self.home):
                return 0
            self.home = new_home
            pending: Dict[int, List[Tuple[int, int, int]]] = {s: [] for s in self.moe_subs}
            for (g, s), res in self.resident.items():
                reps = self.replicas[(g, s)]
                policies = self.policy[(g, s)]
                free = self.free[(g, s)]
                protected = set(self.pinned[(g, s)])
                if pf is not None:
                    protected |= pf.protected_experts(g, s)
                for e in list(res.keys()):
                    tgt = int(new_home[e])
                    cur = res[e] // self.S_loc
                    if cur == tgt:
                        continue
                    by_shard = reps.setdefault(e, {})
                    if tgt in by_shard:
                        new_slot = by_shard.pop(tgt)      # a copy is there: no bytes move
                    else:
                        new_slot = (free[tgt].pop() if free[tgt]
                                    else self._reclaim_replica(g, s, tgt, protected))
                        if new_slot is None:
                            # the target is full of primaries: a later pass may move it
                            if not by_shard:
                                del reps[e]
                            continue
                        pending[s].append((g, new_slot, e))
                        self.stats.loads += 1
                    by_shard[cur] = res[e]                # the old primary stays readable
                    res[e] = new_slot
                    policies[cur].forget(e)
                    policies[tgt].admit(e, float(ema[e]))
                    moved += 1
            if moved:
                self._epoch += 1
                self.stats.rebalance_moves += moved
            if pf is not None:
                pf.submit_loads(pending, priority=1)
            else:
                for s, items in pending.items():
                    self.commit_loads(s, items)
        return moved


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
    # uploads a transfer shard made (its queue, steals and sync commits of
    # its jobs); `shards` makes the summary list every shard, idle ones too
    shards: int = 1
    uploads_by_shard: Dict[int, int] = field(default_factory=dict)

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
        self.uploads_by_shard = {}

    def count_uploads(self, shard: int, n: int) -> None:
        self.uploads += n
        self.uploads_by_shard[shard] = self.uploads_by_shard.get(shard, 0) + n

    def summary(self) -> Dict[str, float]:
        out = {
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
        if self.shards > 1:
            for m in range(self.shards):
                out[f"prefetch_uploads_shard{m}"] = float(self.uploads_by_shard.get(m, 0))
        return out


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
        # queued upload jobs, [(shard, {sub: rows})] (stealable)
        self._job: Optional[List[Tuple[int, Dict[int, List[tuple]]]]] = None
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
        pf.store.wait_slots({l: np.fromiter(want, np.int64)})
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

    A background transfer thread a shard takes planned load batches off its
    shard's three-class priority queue (0 urgent consumer, 1 pre-submitted
    lookahead, 2 warming), gathers the host rows (int8 + scales under
    `host_quant="int8"`, the int4 masters for warm slots) into one of its
    `staging_buffers` reusable host slabs, copies each slab to the device
    and writes the slot pools. Slot planning happens at `submit` under the
    store lock, so the ticket carries the final translation; only the bytes
    move later.

    Over an expert-parallel store (`store.shards` > 1) each ticket fans out
    by destination slot (`store.slot_shard`): one job a shard, on that
    shard's queue, thread, staging ring and CUDA stream, so a backlogged
    shard never holds up another's uploads. Fences are per upload: a hot
    expert may have its primary and replicas in flight at once, each with
    its own fence, and a consumer waits for every copy. K/V page-ins ride
    shard 0's queue.

    On the card the slabs are pinned (`pin_memory=True`), grown on demand
    and reused round-robin; each thread owns one side `torch.cuda.Stream`
    and issues every copy (`non_blocking=True`) on it, and the store's
    slot writer (`ExpertStore.write_slots`, which holds the slot formats
    and the per-slot write order) writes the pools on it too. On the CPU
    there is no stream and no pinning: the copies are synchronous and the
    bookkeeping the same.

    Invariants:
      * an expert referenced by an unreleased ticket, or with an upload in
        flight, is never an eviction victim;
      * a ready fence is a pair: the host `threading.Event`, set only after
        every tensor (w_in, w_gate, w_out, scale planes) of its upload is
        written and the CUDA event after those writes is recorded, and that
        event, kept by the store as the slot's last write (a host set alone
        orders nothing on the device). A fence set with `poisoned` says the
        bytes never landed: its waiter replans and never reads that slot's
        CUDA event as a ready mark;
      * a staging slab is reused only after the CUDA event of the copies
        out of it, recorded on every exit from an upload attempt, has
        completed (the double-buffer fence, `staging_waits`).

    Supervision (the reference's), per shard: an upload batch is retried up
    to `max_retries` times with exponential backoff, then abandoned
    (`_fail_rows`: rolled back, fences poisoned); `degrade_after`
    consecutive abandonments switch the shard to synchronous commits
    (`_commit_sync`); a transfer-loop crash restarts the loop in place,
    and past `max_thread_restarts` the shard is dead (producers commit its
    jobs inline) until `watchdog` revives it. A CUDA error is none of these:
    it is kept and re-raised by every later submit, wait and fence."""

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
                     faults=None, telemetry: Optional["Telemetry"] = None
                     ) -> Optional["PrefetchPipeline"]:
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
                   backoff_s=pc.backoff_s, degrade_after=pc.degrade_after, telemetry=telemetry)

    def __init__(self, store: ExpertStore, depth: int = 2, staging_buffers: int = 2,
                 faults=None, max_retries: int = 3, backoff_s: float = 0.002,
                 degrade_after: int = 3, max_thread_restarts: int = 3,
                 telemetry: Optional["Telemetry"] = None):
        if store._prefetcher is not None:
            raise ValueError("the store already has a prefetch pipeline")
        self.store = store
        self.shards = store.shards
        self.depth = max(1, depth)
        self.n_staging = max(1, staging_buffers)
        self.faults = faults                      # Optional[FaultPlan]
        self.max_retries = max(0, max_retries)    # upload attempts = 1 + max_retries
        self.backoff_s = backoff_s                # base of the exponential backoff
        self.degrade_after = max(1, degrade_after)
        self.max_thread_restarts = max(0, max_thread_restarts)
        self.stats = PrefetchStats(shards=self.shards)
        self.telemetry = telemetry
        self._lock = store._lock
        self.device = store.device
        self._cuda = self.device.type == "cuda"
        shards = range(self.shards)
        self._streams = [torch.cuda.Stream(self.device) for _ in shards] if self._cuda else None
        # one condition guards every shard's three queues; each thread
        # drains only its own
        self._jobs_cv = threading.Condition()
        self._jobs: List[List[collections.deque]] = [
            [collections.deque() for _ in range(3)] for _ in shards]
        # (g, s) -> expert -> {dest slot: fence} for uploads still in flight
        self._pending: Dict[Tuple[int, int], Dict[int, Dict[int, threading.Event]]] = (
            collections.defaultdict(dict))
        # (g, s) -> expert -> refcount from unreleased tickets
        self._refs: Dict[Tuple[int, int], collections.Counter] = (
            collections.defaultdict(collections.Counter))
        # per shard and staging buffer: key -> host slab, and the event of
        # the copies out of it (the slab is reused once that event has
        # completed); each shard's thread owns its ring
        self._staging: List[List[Dict[tuple, torch.Tensor]]] = [
            [{} for _ in range(self.n_staging)] for _ in shards]
        self._staging_event: List[List[Optional[torch.cuda.Event]]] = [
            [None] * self.n_staging for _ in shards]
        self._buf_i = [0] * self.shards
        self._closed = False
        self._error: Optional[BaseException] = None   # a CUDA error, kept for consumers
        # supervision state a shard, guarded by _jobs_cv: degraded (uploads
        # commit synchronously), dead (the thread exhausted its restarts;
        # producers commit inline), and the job each thread holds and since
        # when (crash poisoning, the watchdog)
        self._degraded = [False] * self.shards
        self._dead = [False] * self.shards
        self._fail_streak = [0] * self.shards
        self._crash_count = [0] * self.shards
        self._current_job: List[Optional[object]] = [None] * self.shards
        self._job_started = [0.0] * self.shards
        self._acquire_switch_interval()
        store._prefetcher = self
        self._threads = [self._new_thread(m) for m in shards]
        for t in self._threads:
            t.start()

    def _new_thread(self, shard: int) -> threading.Thread:
        return threading.Thread(target=self._transfer_main, args=(shard,),
                                name=f"sida-prefetch-{shard}", daemon=True)

    @property
    def _thread(self) -> threading.Thread:
        """Shard 0's transfer thread."""
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
        """Ready fences covering `needed` (layer -> expert ids): one entry an
        upload in flight of a needed expert (a replicated expert gives every
        copy's). Caller holds the lock."""
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

    def _fan_out(self, pending: Dict[int, List[Tuple[int, int, int]]]):
        """Register a fence for each planned load and group the loads by
        destination shard: {shard: {sub: [(g, slot, e, fence)]}}. Caller
        holds the lock."""
        jobs: Dict[int, Dict[int, List[tuple]]] = {}
        for s, items in pending.items():
            for g, slot, e in items:
                ev = threading.Event()
                self._pending[(g, s)].setdefault(e, {})[slot] = ev
                sh = self.store.slot_shard(slot)
                jobs.setdefault(sh, {}).setdefault(s, []).append((g, slot, e, ev))
        return jobs

    def submit(self, table: HashTable, protect: bool = True,
               priority: Optional[int] = None) -> Optional[PrefetchTicket]:
        """Plan slots for `table` now; enqueue its uploads on their shards'
        transfer queues. `protect=False` submits a fire-and-forget warming
        prefetch: nothing is pinned, so a warmed expert may be evicted
        before use, and when the warming queue of a shard the table's
        experts call home holds `depth` jobs it returns None without
        planning. `priority` (default 0 protected, 2 warming) picks the
        transfer class; a protected submit waits while its class holds
        `depth` jobs on a shard it uploads to. A dead shard's uploads are
        committed here, inline."""
        if self._closed:
            raise RuntimeError("the prefetch pipeline is closed")
        self._raise_if_fatal()
        prio = priority if priority is not None else (0 if protect else 2)
        if not protect:
            # back-pressure only from the shards this table would upload to
            # (its experts' homes): a backlogged shard does not stop warming
            # for the idle ones
            if self.shards == 1:
                dests = {0}
            else:
                ids = np.unique(table.expert_ids)
                dests = ({int(m) for m in np.unique(self.store.home[ids])}
                         if ids.size else set(range(self.shards)))
            with self._jobs_cv:
                if any(len(self._jobs[m][2]) >= self.depth for m in dests):
                    self.stats.warm_skipped += 1
                    return None
        with self._lock:
            trans, pending, needed = self.store.plan(table, protect_fn=self.protected_experts)
            jobs = self._fan_out(pending)
            if protect:
                for l, ids in needed.items():
                    self._refs[self.store.layer_to_gs(l)].update(int(e) for e in ids)
            # the ticket fences on every needed expert still in flight,
            # whether this submit started the upload or an earlier one did
            fences = self.events_for(needed)
            self.stats.submitted += 1
        ticket = PrefetchTicket(self, trans, needed, fences, protect)
        if jobs:
            # outside the store lock: the put may wait at `depth`; a planned
            # job is never dropped, its slots are already assigned
            ticket._job = list(jobs.items())
            inline = []
            with self._jobs_cv:
                for sh, job in jobs.items():
                    # a dead shard's queue never drains: the wait breaks on it
                    with span(self.telemetry, "prefetch.backpressure"):
                        while (protect and len(self._jobs[sh][prio]) >= self.depth
                               and not self._dead[sh] and not self._closed
                               and self._error is None):
                            self._jobs_cv.wait()
                    self._raise_if_fatal()    # no thread would ever run the job
                    if self._dead[sh]:
                        inline.append((sh, job))
                    else:
                        self._jobs[sh][prio].append(job)
                self._jobs_cv.notify_all()
            if inline:
                self._commit_sync(inline)
        return ticket

    def submit_job(self, fn: Callable[[], None], shard: int = 0,
                   priority: int = 1) -> threading.Event:
        """Enqueue a transfer callable on `shard`'s queue at `priority` and
        return its done fence (the K/V page pool's page-ins ride shard 0
        this way). On a dead shard it runs here, inline."""
        if self._closed:
            raise RuntimeError("the prefetch pipeline is closed")
        self._raise_if_fatal()
        job = _CallableJob(fn)
        with self._jobs_cv:
            self._raise_if_fatal()
            dead = self._dead[shard]
            if not dead:
                self._jobs[shard][priority].append(job)
                self._jobs_cv.notify_all()
        if dead:
            self._run_callable(job)
        return job.done

    def submit_loads(self, pending: Dict[int, List[Tuple[int, int, int]]],
                     priority: int = 1) -> None:
        """Enqueue pre-planned {sub: [(g, slot, e)]} uploads (the store's
        `rebalance_homes` moves ride this): each gets a pending fence and
        lands on its destination slot's shard queue. No back-pressure: the
        caller holds the store lock, and a rebalance must never park the
        serve loop against its own transfer threads."""
        if self._closed:
            raise RuntimeError("the prefetch pipeline is closed")
        self._raise_if_fatal()
        jobs = self._fan_out(pending)
        inline = []
        with self._jobs_cv:
            for sh, job in jobs.items():
                if self._dead[sh]:
                    inline.append((sh, job))
                else:
                    self._jobs[sh][priority].append(job)
            self._jobs_cv.notify_all()
        if inline:
            self._commit_sync(inline)    # nests under the caller's (reentrant) lock

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
        """If any of the ticket's shard jobs is still queued when its fence
        is reached, take it off the queue and write it inline on the
        consumer's stream: the fence was about to pay for the whole transfer
        anyway, so a starved transfer thread never makes the async path
        slower than synchronous uploads. A job a thread already holds is
        left to its fence."""
        entries, ticket._job = ticket._job, None
        if entries is None:
            return
        stolen = []
        with self._jobs_cv:
            for sh, job in entries:
                for q in self._jobs[sh]:
                    if any(item is job for item in q):
                        q.remove(job)
                        stolen.append((sh, job))
                        break
            if stolen:
                self._jobs_cv.notify_all()   # a producer may wait for these queue slots
        if stolen:
            self._commit_sync(stolen, steal=True)

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
            store.wait_slots(ticket.needed)
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

    # -- transfer side (a background thread a shard) --------------------
    def _next_job(self, shard: int):
        with self._jobs_cv:
            while True:
                q = next((q for q in self._jobs[shard] if q), None)
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
                torch.cuda.set_device(self._streams[shard].device)   # an indexed device
                ctx = torch.cuda.stream(self._streams[shard])
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
            job = self._next_job(shard)
            if job is None:
                return
            self._job_started[shard] = time.perf_counter()
            self._current_job[shard] = job
            if self.faults is not None:
                self.faults.inject("thread")   # outside the per-job guards
            t0 = time.perf_counter()
            with span(self.telemetry, "transfer.job"):
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
            self._commit_sync([(shard, job)])
            return
        for s, rows in job.items():
            attempt = 0
            while True:
                try:
                    self._upload(shard, s, rows)
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
            queued = [j for qs in self._jobs for q in qs for j in q]
            for qs in self._jobs:
                for q in qs:
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

    def _commit_sync(self, jobs: List[Tuple[int, Dict[int, List[tuple]]]],
                     steal: bool = False) -> None:
        """Commit upload jobs [(shard, {sub: rows})] inline on the calling
        thread through the store's `commit_loads` (no staging ring, no
        injected upload faults): retire their pending entries and count
        their uploads under the lock, then set their fences. A steal counts
        once in `stolen`; a degraded or dead shard's commit, or a close-time
        drain, counts each upload in `sync_fallbacks`."""
        evs: List[threading.Event] = []
        with self._lock:
            for sh, job in jobs:
                for s, rows in job.items():
                    self.store.commit_loads(s, [(g, sl, e) for g, sl, e, _ in rows])
                    for g, sl, e, ev in rows:
                        self._upload_done(g, s, sl, e, ev)
                        evs.append(ev)
                self.stats.count_uploads(sh, sum(len(r) for r in job.values()))
            if steal:
                self.stats.stolen += 1
            else:
                self.stats.sync_fallbacks += len(evs)
        for ev in evs:
            ev.set()

    def _drain_sync(self, shard: int) -> None:
        """Drain `shard`'s queues on the calling thread through the
        synchronous path: the dead-thread and close-time fallback that keeps
        "a planned job is never dropped" without a transfer thread."""
        while True:
            with self._jobs_cv:
                q = next((q for q in self._jobs[shard] if q), None)
                if q is None:
                    return
                job = q.popleft()
                self._jobs_cv.notify_all()
            if isinstance(job, _CallableJob):
                self._run_callable(job)
            else:
                self._commit_sync([(shard, job)])

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

    def _upload(self, shard: int, s: int, rows: List[tuple]) -> None:
        """Stage and copy one sub's upload batch on `shard`'s ring and
        stream, have the store write it (`ExpertStore.write_slots`), then
        fire its fences. Every copied byte is counted. An attempt that
        raises leaves the slab's event recorded (its earlier keys' copies
        may be in flight) and, once the write began, the slots' events."""
        if self.faults is not None:
            self.faults.inject("upload")
        store = self.store
        i = self._buf_i[shard]
        self._buf_i[shard] = (i + 1) % self.n_staging
        ev = self._staging_event[shard][i]
        if ev is not None:   # double-buffer fence: the copies out of slab i
            if not ev.query():
                with self._jobs_cv:
                    self.stats.staging_waits += 1
            with span(self.telemetry, "transfer.staging_wait"):
                ev.synchronize()
        staging = self._staging[shard][i]
        parts, nbytes_up = [], 0
        try:
            for warm, part in store.slot_tiers(rows):
                idx = torch.tensor([g * store.E + e for g, _, e, _ in part], dtype=torch.long)
                vals = {}
                for key, host in store.slot_sources(s, warm):
                    view = self._stage(staging, (s, key), host, idx)
                    vals[key] = _staged_put(view, self.device)
                    nbytes_up += nbytes(view)
                parts.append((warm, part, vals))
        finally:
            self._staging_event[shard][i] = self.record_event()
        with self._lock:
            store.write_slots(s, parts)
            store.stats.bytes_h2d += nbytes_up
            if self.telemetry is not None:
                self.telemetry.counter("upload_bytes_transfer").inc(nbytes_up)
            # every tensor of every expert in the batch is written and its
            # CUDA event recorded: the fences may fire (no half-written slot
            # is observable)
            for g, slot, e, fence in rows:
                self._upload_done(g, s, slot, e, fence)
            self.stats.count_uploads(shard, len(rows))
        for *_, fence in rows:
            fence.set()

    # -- lifecycle ------------------------------------------------------
    def close(self) -> None:
        """Drain queued uploads, join the transfer threads and detach from the
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
            for stream in self._streams:
                stream.synchronize()
        self._staging = []
        self._staging_event = []
        with self._lock:
            self.store._slot_event.clear()
            self.store._prefetcher = None
        self._release_switch_interval()

    def __enter__(self) -> "PrefetchPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
