"""Consolidated serving configuration: one `ServingConfig` object for the
whole request-serving stack (port of `repro/serving/config.py`, which
imports no JAX: copied as it is, with the port's own `TierConfig`,
`FaultPlan`, `ShardedStoreConfig` and `PagedKVConfig`).

* `ServingConfig` groups every server knob into coherent sub-configs
  (batching, prefetch, quant/tier, speculation, expert parallelism, paged
  K/V, fault tolerance, tenants) with `validate()` carrying the cross-field
  rules.
* `SERVE_FLAGS` + `add_serving_args()` register the CLI surface from this
  module, and `ServingConfig.from_args()` builds the config back out of the
  parsed namespace, so flags and config read one table. The table equals
  the reference's flag for flag (names, dests, defaults, choices, help);
  `tests/test_torch_serving.py` holds the two against each other.
* `TenantConfig` is the multi-tenant front door's registry entry.

The config accepts everything the reference's does. The port's
`RequestServer` refuses what it does not serve yet, with
`NotImplementedError`: tenants and fault plans (ROADMAP A13(b)), expert-
parallel shards and rebalancing (A14).

`ServingConfig.from_kwargs` keeps the reference's flat keyword surface
(`RequestServer(cfg, params, hp, slots_per_layer=..., max_lanes=...)`).
"""
from __future__ import annotations

import argparse
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from repro_torch.configs.base import TierConfig
from repro_torch.core.faults import KNOWN_SITES, FaultPlan
from repro_torch.core.offload import ShardedStoreConfig
from repro_torch.core.residency import PagedKVConfig

DEFAULT_BUCKETS = (8, 16, 32, 64, 128)
DEFAULT_TENANT = "default"


class ServingConfigError(ValueError):
    """An incoherent serving configuration (the structured equivalent of
    `validate_serve_args`'s SystemExit — launchers catch and exit, tests
    assert on the message)."""


# ----------------------------------------------------------------------
# tenants
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class TenantConfig:
    """One tenant's service contract in the multi-tenant front door.

    `weight` is the WFQ share: the deficit-round-robin scheduler grants
    each tenant `weight x quantum` prefill tokens per round, so long-run
    service is proportional to weight regardless of offered load.
    `token_rate` is an absolute budget (generated tokens/second, token
    bucket with `burst` capacity; 0 = unlimited): tokens debit the bucket
    as they are generated and an empty bucket defers the tenant's queued
    requests (never drops them). `pin_quota` caps the share of each MoE
    layer's device slots this tenant may hold pinned
    (`ExpertStore.pin_experts` attribution) so one tenant's hot experts
    cannot monopolize the slot pools every tenant's hit rate depends on.
    `slo_class` labels telemetry; `default_slo_s` supplies a deadline for
    this tenant's requests that arrive without one (admission control and
    shedding key off deadlines)."""

    name: str
    weight: float = 1.0
    token_rate: float = 0.0     # generated tokens/sec budget; 0 = unlimited
    burst: float = 0.0          # token-bucket capacity; 0 => 1s at token_rate
    pin_quota: float = 1.0      # max fraction of per-layer slots pinned
    slo_class: str = "standard"
    default_slo_s: Optional[float] = None

    def validate(self) -> None:
        if not self.name:
            raise ServingConfigError("tenant name must be non-empty")
        if self.weight <= 0:
            raise ServingConfigError(
                f"tenant {self.name!r}: weight must be > 0 (got {self.weight})"
            )
        if self.token_rate < 0 or self.burst < 0:
            raise ServingConfigError(
                f"tenant {self.name!r}: token_rate/burst must be >= 0"
            )
        if not (0.0 < self.pin_quota <= 1.0):
            raise ServingConfigError(
                f"tenant {self.name!r}: pin_quota must be in (0, 1] "
                f"(fraction of per-layer slots; got {self.pin_quota})"
            )


def parse_tenants(spec: str) -> Tuple[TenantConfig, ...]:
    """Parse the `--tenants` grammar: comma-separated
    `name[:weight=W][:rate=R][:burst=B][:pin=F][:slo=S][:class=C]`,
    e.g. ``paid:weight=4:pin=0.5,free:weight=1:rate=200``."""
    out: List[TenantConfig] = []
    keys = {
        "weight": ("weight", float),
        "rate": ("token_rate", float),
        "burst": ("burst", float),
        "pin": ("pin_quota", float),
        "slo": ("default_slo_s", float),
        "class": ("slo_class", str),
    }
    for part in filter(None, (p.strip() for p in spec.split(","))):
        fields = part.split(":")
        kw: Dict[str, Any] = {"name": fields[0].strip()}
        for f in fields[1:]:
            if "=" not in f:
                raise ServingConfigError(
                    f"tenant spec {part!r}: expected key=value, got {f!r}"
                )
            k, v = f.split("=", 1)
            if k not in keys:
                raise ServingConfigError(
                    f"tenant spec {part!r}: unknown key {k!r} "
                    f"(known: {', '.join(keys)})"
                )
            attr, typ = keys[k]
            try:
                kw[attr] = typ(v)
            except ValueError:
                raise ServingConfigError(
                    f"tenant spec {part!r}: bad value {v!r} for {k}"
                ) from None
        t = TenantConfig(**kw)
        t.validate()
        out.append(t)
    names = [t.name for t in out]
    if len(set(names)) != len(names):
        raise ServingConfigError(f"duplicate tenant names in {spec!r}")
    return tuple(out)


# ----------------------------------------------------------------------
# grouped sub-configs
# ----------------------------------------------------------------------
@dataclass
class BatchingConfig:
    """Continuous-batching geometry: decode lanes, prefill batch size, the
    length-bucket ladder, the (ring) K/V length, and expired-request
    dropping."""

    max_lanes: int = 4
    max_prefill_batch: int = 4
    buckets: Tuple[int, ...] = DEFAULT_BUCKETS
    cache_len: int = 0          # 0 => 2 * buckets[-1] (ring path only)
    drop_expired: bool = False


@dataclass
class PrefetchServeConfig:
    """Async expert-prefetch pipeline + its supervision bounds. `depth`
    None defers to the model config's `cfg.prefetch`; 0 forces synchronous
    inline uploads."""

    depth: Optional[int] = None
    staging_buffers: Optional[int] = None
    fence_timeout_s: Optional[float] = None   # per-tick ticket.wait bound
    watchdog_interval_s: float = 0.25
    watchdog_max_job_age_s: Optional[float] = None


@dataclass
class QuantServeConfig:
    """Residency formats: host tier quantization, int8-native device slots,
    and the optional hot/warm (int8/int4) residency tiers."""

    host_quant: str = "none"                 # "none" | "int8"
    quantized_slots: Optional[bool] = None   # None => cfg.quant
    scale_granularity: Optional[str] = None  # "channel" | "tensor"
    tier: Optional[TierConfig] = None


@dataclass
class SpecServeConfig:
    """Speculative decode: draft mode + window. None defers to the model
    config's `cfg.spec`."""

    mode: Optional[str] = None   # "off" | "draft"
    k: Optional[int] = None


@dataclass
class ParallelServeConfig:
    """Expert parallelism: sharded slot pools (+ hot-expert replication via
    `sharded.replicate_hot`) and online home rebalancing."""

    sharded: Optional[ShardedStoreConfig] = None
    rebalance_interval: float = 0.0


@dataclass
class FaultToleranceConfig:
    """Seeded chaos plan + overload shedding. `shed` holds the admission
    controller template; with tenants configured the server splits it into
    per-tenant controllers (per-tenant depth/EMA) so one tenant's overload
    sheds only that tenant."""

    plan: Optional[FaultPlan] = None
    shed: Optional["AdmissionController"] = None  # noqa: F821 (scheduler)


@dataclass
class ServingConfig:
    """Every `RequestServer` knob, grouped. See module docstring."""

    slots_per_layer: int = 2
    serve_top_k: Optional[int] = None
    eviction: str = "lru"
    keep_prefill_logits: bool = False
    keep_decode_logits: bool = False
    batching: BatchingConfig = field(default_factory=BatchingConfig)
    prefetch: PrefetchServeConfig = field(default_factory=PrefetchServeConfig)
    quant: QuantServeConfig = field(default_factory=QuantServeConfig)
    spec: SpecServeConfig = field(default_factory=SpecServeConfig)
    parallel: ParallelServeConfig = field(default_factory=ParallelServeConfig)
    paged: Optional[PagedKVConfig] = None
    faults: FaultToleranceConfig = field(default_factory=FaultToleranceConfig)
    tenants: Tuple[TenantConfig, ...] = ()   # () = single-tenant (degenerate)
    wfq_quantum: float = 64.0   # DRR tokens granted per round per unit weight

    # ------------------------------------------------------------------
    @property
    def multitenant(self) -> bool:
        return len(self.tenants) > 0

    def tenant(self, name: str) -> Optional[TenantConfig]:
        for t in self.tenants:
            if t.name == name:
                return t
        return None

    # ------------------------------------------------------------------
    def validate(
        self,
        max_prompt_len: Optional[int] = None,
        max_new_tokens: Optional[int] = None,
        slo_s: Optional[float] = None,
    ) -> "ServingConfig":
        """Cross-field coherence rules (absorbed from the launcher's old
        `validate_serve_args`). The optional workload hints let launchers
        check the config against the stream they are about to serve; pure
        config rules run regardless. Raises `ServingConfigError`."""

        def die(msg: str) -> None:
            raise ServingConfigError(msg)

        if self.slots_per_layer < 1:
            die("slots_per_layer must be >= 1")
        b = self.batching
        if b.max_lanes < 1 or b.max_prefill_batch < 1:
            die("max_lanes and max_prefill_batch must be >= 1")
        if not b.buckets or list(b.buckets) != sorted(set(b.buckets)):
            die(f"buckets must be a strictly increasing ladder, got {b.buckets}")
        tier = self.quant.tier
        if tier is not None and tier.enabled:
            if not self.quant.quantized_slots:
                die("the int4 warm tier extends the quantized slot pool: "
                    "also set quantized_slots (hot tier stays int8)")
            sharded = self.parallel.sharded
            if sharded is not None and sharded.replicate_hot:
                die("int4 tiering and replicate_hot are mutually exclusive "
                    "(replicas assume a single uniform slot pool)")
            if not (0.0 < tier.tier_split <= 1.0):
                die(f"tier_split {tier.tier_split} must be in (0, 1]: the "
                    "fraction of the slot byte budget held as int8 hot slots")
            if tier.group_size <= 0:
                die("quant group_size must be >= 1 (int4 scale group size "
                    "along the contraction axis)")
        sh = self.parallel.sharded
        if sh is not None:
            if sh.ep_shards < 1 or sh.replicate_hot < 0:
                die("ep_shards must be >= 1 and replicate_hot >= 0")
            if sh.replicate_hot and sh.ep_shards <= 1:
                die("replicate_hot needs ep_shards > 1 (replication acts "
                    "across expert-parallel shards)")
        if self.parallel.rebalance_interval < 0:
            die("rebalance_interval must be >= 0")
        if (
            self.parallel.rebalance_interval
            and (sh is None or sh.ep_shards <= 1)
        ):
            die("rebalance_interval needs ep_shards > 1 (placement acts "
                "across expert-parallel shards)")
        p = self.paged
        if p is not None and p.enabled:
            if p.page_size <= 0 or p.kv_pages < 0 or p.prefill_chunk < 0:
                die("kv_pages/prefill_chunk must be >= 0 and page_size >= 1")
            resident = p.kv_pages * p.page_size
            if p.max_seq and p.max_seq < resident:
                die(f"max_seq {p.max_seq} is below the resident pool "
                    f"({p.kv_pages} x {p.page_size} = {resident}); drop "
                    "max_seq or shrink the pool")
            if b.buckets[-1] > p.seq_len:
                die(f"largest prefill bucket ({b.buckets[-1]}) exceeds the "
                    f"addressable range {p.seq_len}")
            need = -(-b.buckets[-1] // p.page_size)
            if p.kv_pages < need:
                die(f"kv_pages {p.kv_pages} cannot seed one full prefill "
                    f"bucket ({b.buckets[-1]} tokens = {need} pages of "
                    f"{p.page_size}); raise kv_pages to >= {need}")
            spec_k = self.spec.k
            if self.spec.mode == "draft" and spec_k and spec_k > resident:
                die(f"spec k {spec_k} exceeds the resident K/V pool "
                    f"({resident} positions); a verify block must fit in "
                    "device pages")
            if max_prompt_len is not None and max_new_tokens is not None:
                if max_prompt_len + max_new_tokens > p.seq_len:
                    die(f"prompt {max_prompt_len} + new tokens "
                        f"{max_new_tokens} exceeds the addressable range "
                        f"{p.seq_len}: such requests would be rejected at "
                        "admission — raise max_seq (spilled pages live on "
                        "host, so it may exceed the resident pool)")
        if max_prompt_len is not None and max_prompt_len > b.buckets[-1]:
            if p is None or not p.enabled or p.prefill_chunk <= 0:
                die(f"prompt length {max_prompt_len} exceeds the largest "
                    f"prefill bucket ({b.buckets[-1]}): such prompts would "
                    "be rejected at admission — enable chunked prefill "
                    "(paged K/V + prefill_chunk) or raise the buckets")
        pf = self.prefetch
        if pf.fence_timeout_s is not None and pf.fence_timeout_s < 0:
            die("fence_timeout_s must be >= 0")
        if self.faults.plan is not None:
            for spec in self.faults.plan.specs:
                if spec.site not in KNOWN_SITES:
                    die(f"fault plan: site {spec.site!r} is not instrumented "
                        f"(known sites: {', '.join(KNOWN_SITES)})")
        if self.faults.shed is not None and slo_s is None:
            # only checkable when the launcher tells us about the workload;
            # a shed gate with neither per-request SLOs nor a default would
            # never fire — that is a misconfiguration, not a feature
            if not any(t.default_slo_s is not None for t in self.tenants):
                die("overload shedding needs a deadline to protect: pass an "
                    "SLO (per request, per tenant default_slo_s, or the "
                    "launcher's --slo)")
        if self.wfq_quantum <= 0:
            die("wfq_quantum must be > 0")
        names = [t.name for t in self.tenants]
        if len(set(names)) != len(names):
            die(f"duplicate tenant names: {names}")
        for t in self.tenants:
            t.validate()
        return self

    # ------------------------------------------------------------------
    # legacy kwargs shim
    # ------------------------------------------------------------------
    @classmethod
    def from_kwargs(cls, **kwargs: Any) -> "ServingConfig":
        """Build a ServingConfig from `RequestServer`'s legacy flat kwargs.

        DEPRECATED surface: new call sites should construct a ServingConfig;
        the flat names are kept (via KWARG_PATHS) so nine PRs of tests and
        benchmarks keep working, and the equivalence differential
        (tests/test_serving_config.py) pins the two paths byte-identical.
        Unknown names raise TypeError exactly like the old signature did."""
        self = cls()
        for name, val in kwargs.items():
            path = KWARG_PATHS.get(name)
            if path is None:
                raise TypeError(
                    f"RequestServer got an unexpected keyword argument "
                    f"{name!r} (see ServingConfig for the config surface)"
                )
            obj: Any = self
            *parents, leaf = path.split(".")
            for p in parents:
                obj = getattr(obj, p)
            if name == "buckets":
                val = tuple(sorted(val))
            if name == "tenants":
                val = tuple(val)
            setattr(obj, leaf, val)
        return self

    # ------------------------------------------------------------------
    # flag surface
    # ------------------------------------------------------------------
    @staticmethod
    def add_args(parser: argparse.ArgumentParser) -> None:
        add_serving_args(parser)

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "ServingConfig":
        """The config from the parsed CLI namespace (`launch/serve.py`'s
        flags). Validates (with workload hints when the namespace carries
        them) and raises `ServingConfigError` on incoherent flag
        combinations."""
        tier = None
        if args.int4_slots:
            if not (0.0 < args.tier_split <= 1.0):
                raise ServingConfigError(
                    f"--tier-split {args.tier_split} must be in (0, 1]: the "
                    "fraction of the slot byte budget held as int8 hot slots"
                )
            if args.quant_group <= 0:
                raise ServingConfigError(
                    "--quant-group must be >= 1 (int4 scale group size "
                    "along the contraction axis)"
                )
            tier = TierConfig(
                int4_slots=True, tier_split=args.tier_split,
                group_size=args.quant_group,
            )
        sharded = None
        if args.ep_shards > 1 or args.replicate_hot:
            sharded = ShardedStoreConfig(
                ep_shards=args.ep_shards, replicate_hot=args.replicate_hot,
            )
        paged = None
        if args.kv_pages or args.max_seq or args.prefill_chunk:
            if args.kv_pages < 0 or args.page_size <= 0 or args.prefill_chunk < 0:
                raise ServingConfigError(
                    "--kv-pages/--prefill-chunk must be >= 0 and "
                    "--page-size >= 1"
                )
            if args.prefill_chunk and not args.kv_pages:
                raise ServingConfigError(
                    "--prefill-chunk needs the paged K/V cache: also pass "
                    "--kv-pages"
                )
            if args.max_seq and not args.kv_pages:
                raise ServingConfigError(
                    "--max-seq needs the paged K/V cache: also pass "
                    "--kv-pages"
                )
            paged = PagedKVConfig(
                page_size=args.page_size, kv_pages=args.kv_pages,
                prefill_chunk=args.prefill_chunk, max_seq=args.max_seq,
            )
        plan = None
        if args.fault_plan:
            try:
                plan = FaultPlan.parse(args.fault_plan, seed=args.fault_seed)
            except ValueError as e:
                raise ServingConfigError(f"--fault-plan: {e}") from None
        shed = None
        if args.shed_margin:
            if args.shed_margin < 0:
                raise ServingConfigError("--shed-margin must be >= 0")
            from repro_torch.serving.scheduler import AdmissionController

            shed = AdmissionController(margin=args.shed_margin)
        if args.fence_timeout < 0:
            raise ServingConfigError("--fence-timeout must be >= 0")
        tenants: Tuple[TenantConfig, ...] = ()
        if args.tenants:
            tenants = parse_tenants(args.tenants)
        seq = getattr(args, "seq", None)
        buckets = DEFAULT_BUCKETS
        if seq is not None:
            buckets = bucket_ladder(serve_bucket_limit(
                seq, args.kv_pages, args.page_size, args.prefill_chunk
            ))
        self = cls(
            slots_per_layer=args.slots,
            eviction=args.eviction,
            batching=BatchingConfig(
                max_lanes=args.lanes,
                max_prefill_batch=args.prefill_batch,
                buckets=buckets,
                drop_expired=args.drop_expired,
            ),
            prefetch=PrefetchServeConfig(
                depth=args.prefetch_depth,
                staging_buffers=args.staging_buffers,
                fence_timeout_s=args.fence_timeout or None,
            ),
            quant=QuantServeConfig(
                host_quant=args.host_quant,
                quantized_slots=args.quantized_slots,
                scale_granularity=args.scale_granularity,
                tier=tier,
            ),
            spec=SpecServeConfig(mode=args.spec_mode, k=args.spec_k),
            parallel=ParallelServeConfig(
                sharded=sharded,
                rebalance_interval=args.rebalance_interval,
            ),
            paged=paged,
            faults=FaultToleranceConfig(plan=plan, shed=shed),
            tenants=tenants,
            wfq_quantum=args.wfq_quantum,
        )
        return self.validate(
            max_prompt_len=seq,
            max_new_tokens=getattr(args, "new_tokens", None),
            slo_s=getattr(args, "slo", None),
        )


# RequestServer's historical flat keyword surface -> dotted config path
# (the back-compat shim's single lookup table; tests assert it covers the
# pre-redesign signature exactly).
KWARG_PATHS: Dict[str, str] = {
    "slots_per_layer": "slots_per_layer",
    "serve_top_k": "serve_top_k",
    "eviction": "eviction",
    "keep_prefill_logits": "keep_prefill_logits",
    "keep_decode_logits": "keep_decode_logits",
    "max_lanes": "batching.max_lanes",
    "max_prefill_batch": "batching.max_prefill_batch",
    "buckets": "batching.buckets",
    "cache_len": "batching.cache_len",
    "drop_expired": "batching.drop_expired",
    "prefetch_depth": "prefetch.depth",
    "staging_buffers": "prefetch.staging_buffers",
    "fence_timeout_s": "prefetch.fence_timeout_s",
    "watchdog_interval_s": "prefetch.watchdog_interval_s",
    "watchdog_max_job_age_s": "prefetch.watchdog_max_job_age_s",
    "host_quant": "quant.host_quant",
    "quantized_slots": "quant.quantized_slots",
    "scale_granularity": "quant.scale_granularity",
    "tier": "quant.tier",
    "spec_mode": "spec.mode",
    "spec_k": "spec.k",
    "sharded": "parallel.sharded",
    "rebalance_interval": "parallel.rebalance_interval",
    "paged": "paged",
    "faults": "faults.plan",
    "shed": "faults.shed",
    "tenants": "tenants",
    "wfq_quantum": "wfq_quantum",
}


# ----------------------------------------------------------------------
# bucket ladder (shared by from_args and the launcher's messages)
# ----------------------------------------------------------------------
def serve_bucket_limit(
    seq: int, kv_pages: int = 0, page_size: int = 16, prefill_chunk: int = 0,
) -> int:
    """Largest prefill bucket a launcher should build for prompts up to
    `seq`. Paged serving caps buckets at what the resident pool can seed in
    one shot (and, with chunked prefill on, at the default 128 — longer
    prompts stream chunk by chunk)."""
    limit = seq
    if kv_pages:
        limit = min(limit, kv_pages * page_size)
        if prefill_chunk:
            limit = min(limit, 128)
    bucket = 8
    while bucket < limit:
        bucket *= 2
    return bucket


def bucket_ladder(limit: int) -> Tuple[int, ...]:
    """The 8, 16, ... power-of-two ladder up to (and including) `limit`."""
    buckets = [8]
    while buckets[-1] < limit:
        buckets.append(2 * buckets[-1])
    return tuple(buckets)


# ----------------------------------------------------------------------
# CLI flag table — the argparse surface is REGISTERED from this table and
# READ BACK by from_args, so the flag set and the config cannot drift.
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class FlagSpec:
    flag: str                 # "--kv-pages"
    path: Optional[str]       # dotted ServingConfig path for 1:1 flags;
    #                           None = composite (consumed by from_args
    #                           into a sub-config object)
    kwargs: Dict[str, Any] = field(default_factory=dict)  # add_argument(**)

    @property
    def dest(self) -> str:
        return self.flag.lstrip("-").replace("-", "_")


SERVE_FLAGS: Tuple[FlagSpec, ...] = (
    FlagSpec("--slots", "slots_per_layer", dict(
        type=int, default=2,
        help="device expert slots per MoE layer (the memory budget)")),
    FlagSpec("--eviction", "eviction", dict(
        default="fifo", choices=["fifo", "lru", "alpha"],
        help="slot replacement: fifo | lru | alpha (α-mass)")),
    FlagSpec("--prefetch-depth", "prefetch.depth", dict(
        type=int, default=0,
        help="async prefetch lookahead (0 = synchronous uploads)")),
    FlagSpec("--staging-buffers", "prefetch.staging_buffers", dict(
        type=int, default=2,
        help="host staging slabs for the transfer thread")),
    FlagSpec("--host-quant", "quant.host_quant", dict(
        default="none", choices=["none", "int8"],
        help="host expert tier format (int8 halves H2D bytes; dequantised "
             "at slot write unless --quantized-slots)")),
    FlagSpec("--quantized-slots", "quant.quantized_slots", dict(
        action="store_true",
        help="int8 device-resident slots + fused-dequant expert FFN (2-4x "
             "resident experts per slot byte; implies --host-quant int8)")),
    FlagSpec("--scale-granularity", "quant.scale_granularity", dict(
        default="channel", choices=["channel", "tensor"],
        help="int8 scale granularity per expert tensor")),
    FlagSpec("--int4-slots", None, dict(
        action="store_true",
        help="hierarchical residency tiers: keep the hot tier int8 and add "
             "a warm tier of nibble-packed int4 slots with per-group scales "
             "(~2x experts per byte); requires --quantized-slots")),
    FlagSpec("--tier-split", None, dict(
        type=float, default=0.5,
        help="fraction of the slot byte budget held as int8 hot slots; the "
             "remainder becomes int4 warm slots (1.0 = all-hot, degenerate "
             "to --quantized-slots)")),
    FlagSpec("--quant-group", None, dict(
        type=int, default=64,
        help="int4 scale group size along the contraction axis (smaller = "
             "tighter error, more scale-plane bytes)")),
    FlagSpec("--spec-mode", "spec.mode", dict(
        default="off", choices=["off", "draft"],
        help="speculative decode: 'draft' unrolls the hash predictor's "
             "tied-embedding next-token head and verifies k tokens per "
             "step (request-server mode)")),
    FlagSpec("--spec-k", "spec.k", dict(
        type=int, default=4,
        help="draft tokens proposed per verify step; the union of all k "
             "positions' predicted experts ships as one superset prefetch "
             "ticket")),
    FlagSpec("--ep-shards", None, dict(
        type=int, default=1,
        help="expert-parallel serving shards: partition the slot pools "
             "(and prefetch transfer queues) over a 1-D 'model' mesh of "
             "this many devices; the expert FFN runs inside shard_map "
             "(fused dequant when --quantized-slots). 1 = single-device")),
    FlagSpec("--replicate-hot", None, dict(
        type=int, default=0,
        help="extra copies an α-mass-hot expert may hold on other shards "
             "(free slots only; translation round-robins tokens over the "
             "copies). Requires --ep-shards > 1; 0 = fixed placement")),
    FlagSpec("--rebalance-interval", "parallel.rebalance_interval", dict(
        type=float, default=0.0,
        help="seconds between online home-shard re-placements driven by "
             "the decayed α-mass EMA (request-server mode; requires "
             "--ep-shards > 1; 0 = off)")),
    FlagSpec("--kv-pages", None, dict(
        type=int, default=0,
        help="paged K/V cache: device page budget shared by all lanes "
             "(0 = ring cache). Spilled pages live on host and page back "
             "in over the prefetch queues")),
    FlagSpec("--page-size", None, dict(
        type=int, default=16,
        help="K/V page size in token positions")),
    FlagSpec("--prefill-chunk", None, dict(
        type=int, default=0,
        help="chunked prefill: stream prompts longer than the largest "
             "bucket through the paged cache in chunks of this many "
             "tokens, interleaved with decode ticks (0 = off; requires "
             "--kv-pages)")),
    FlagSpec("--max-seq", None, dict(
        type=int, default=0,
        help="addressable sequence length (page-table width); 0 = "
             "kv-pages * page-size (everything resident). May exceed the "
             "resident pool: the excess spills")),
    FlagSpec("--lanes", "batching.max_lanes", dict(
        type=int, default=4,
        help="(server) continuous-batching decode lanes")),
    FlagSpec("--prefill-batch", "batching.max_prefill_batch", dict(
        type=int, default=4,
        help="(server) max requests per bucketed prefill batch")),
    FlagSpec("--drop-expired", "batching.drop_expired", dict(
        action="store_true",
        help="(server) reject requests already past their SLO")),
    FlagSpec("--fault-plan", None, dict(
        default="",
        help="(server) seeded chaos schedule, e.g. "
             "'upload:fail,p=0.2;thread:crash@2' — grammar "
             "site:kind[=delay_s][@nth[xtimes]][,p=prob], ;-separated "
             "(see core/faults.py)")),
    FlagSpec("--fault-seed", None, dict(
        type=int, default=0,
        help="(server) RNG seed for probabilistic (p=) fault specs")),
    FlagSpec("--fence-timeout", None, dict(
        type=float, default=0.0,
        help="(server) bound (s) a serve tick waits on prefetch fences "
             "before falling back to a synchronous prepare (0 = wait "
             "indefinitely)")),
    FlagSpec("--shed-margin", None, dict(
        type=float, default=0.0,
        help="(server) overload shedding: reject at admission when "
             "estimated queue wait exceeds this fraction of a request's "
             "deadline slack (0 = no shedding; requires a deadline: --slo "
             "or a tenant default)")),
    FlagSpec("--tenants", None, dict(
        default="",
        help="(server) multi-tenant front door: comma-separated "
             "name[:weight=W][:rate=R][:pin=F][:slo=S][:class=C] specs, "
             "e.g. 'paid:weight=4:pin=0.5,free:rate=200'. Empty = "
             "single-tenant (byte-identical to the pre-tenant path)")),
    FlagSpec("--wfq-quantum", "wfq_quantum", dict(
        type=float, default=64.0,
        help="(server) deficit-round-robin quantum: prefill+decode tokens "
             "granted per scheduling round per unit tenant weight")),
)


def add_serving_args(parser: argparse.ArgumentParser) -> None:
    """Register every serving flag from SERVE_FLAGS (the launcher adds its
    workload/launcher-only flags — --arch, --engine, --requests, … —
    itself)."""
    for spec in SERVE_FLAGS:
        parser.add_argument(spec.flag, **spec.kwargs)


def resolve_path(cfg: ServingConfig, path: str) -> Any:
    """Read a dotted ServingConfig path ("batching.max_lanes")."""
    obj: Any = cfg
    for p in path.split("."):
        obj = getattr(obj, p)
    return obj
