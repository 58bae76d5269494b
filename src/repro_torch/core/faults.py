"""Deterministic, seeded fault injection for the serving stack (a copy of
`repro/core/faults.py`, which is framework-free; the port imports nothing
of `repro`). The port's prefetch pipeline and request server inject at the
reference's sites.

The async pipeline (hash-ahead prediction -> prefetch upload -> fenced
decode) has exactly four places a production deployment sees fail: the H2D
copy itself, the link stalling, the host master read, and the transfer
thread dying. A `FaultPlan` schedules any of those at precise points —
"the 3rd upload", "every upload with probability 0.2 under seed 7" — so a
test, the chaos CI step, and `bench_serving --fault-plan` all drive the
byte-identical scenario and the supervision machinery
(retry/backoff -> fence poisoning -> degraded sync fallback, see
core/offload.py) can be exercised deterministically.

Plan grammar (`;`-separated specs):

    site:kind[=delay_s][@nth[xtimes]][,p=prob]

    upload:fail@3          the 3rd upload batch raises InjectedFault once
    upload:fail@3x2        upload batches 3 and 4 raise
    upload:fail,p=0.2      each upload batch raises with probability 0.2
    upload:stall=0.05,p=.1 10% of upload batches sleep 50 ms first
    host_read:fail@1       the 1st host-master gather raises
    thread:crash@2         the 2nd transfer-loop iteration raises (kills
                           the shard thread; the supervisor restarts it)
    hash:fail@1            the 1st hash-ahead admission raises (the hash
                           thread rejects that request and continues)

Sites are just strings; the injection points name them (grep for
`inject(`). Counters are per-site and the probabilistic draw uses one RNG
per site seeded from (seed, site), so adding a spec for one site never
perturbs another site's schedule. With a single transfer thread per shard
the per-site operation order — and therefore an `@nth` schedule — is fully
deterministic; under multiple shards the @nth match lands on whichever
shard reaches the counter first (use `p=` for multi-shard plans).
"""
from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

__all__ = ["FaultSpec", "FaultPlan", "InjectedFault"]

# the sites the serving stack currently instruments (a plan may name others;
# they simply never match — this list is for the launcher's validation)
KNOWN_SITES = ("upload", "host_read", "thread", "hash")
KNOWN_KINDS = ("fail", "stall", "crash")


class InjectedFault(RuntimeError):
    """Raised at an injection point. Deliberately a plain RuntimeError
    subclass: the supervision code must treat it exactly like a real
    transfer/read error (no special-casing), or the chaos suite would be
    testing a path production errors never take."""

    def __init__(self, site: str, n: int):
        super().__init__(f"injected fault at {site} (operation #{n})")
        self.site = site
        self.n = n


@dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault: fire `kind` at `site` on operations
    [nth, nth+times) and/or with probability `p` on every operation."""

    site: str
    kind: str = "fail"            # "fail" | "stall" | "crash"
    delay_s: float = 0.0          # stall duration (kind == "stall")
    nth: int = 0                  # 1-based op index; 0 = probabilistic only
    times: int = 1                # consecutive ops faulted from nth
    p: float = 0.0                # per-op probability (seeded RNG)

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        text = text.strip()
        head, *mods = text.split(",")
        if ":" not in head:
            raise ValueError(f"fault spec {text!r}: expected site:kind")
        site, kind = head.split(":", 1)
        nth, times = 0, 1
        if "@" in kind:
            kind, sched = kind.split("@", 1)
            if "x" in sched:
                n_s, t_s = sched.split("x", 1)
                nth, times = int(n_s), int(t_s)
            else:
                nth = int(sched)
            if nth < 1 or times < 1:
                raise ValueError(f"fault spec {text!r}: @nth/xtimes must be >= 1")
        delay = 0.0
        if "=" in kind:
            kind, d_s = kind.split("=", 1)
            delay = float(d_s)
        p = 0.0
        for m in mods:
            k, _, v = m.strip().partition("=")
            if k != "p" or not v:
                raise ValueError(f"fault spec {text!r}: unknown modifier {m!r}")
            p = float(v)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"fault spec {text!r}: p must be in [0, 1]")
        if kind not in KNOWN_KINDS:
            raise ValueError(
                f"fault spec {text!r}: kind {kind!r} not in {KNOWN_KINDS}"
            )
        if kind == "stall" and delay <= 0.0:
            raise ValueError(f"fault spec {text!r}: stall needs =delay_s > 0")
        if nth == 0 and p == 0.0:
            raise ValueError(
                f"fault spec {text!r}: needs @nth scheduling and/or p=prob"
            )
        return cls(site=site.strip(), kind=kind, delay_s=delay,
                   nth=nth, times=times, p=p)


@dataclass
class FaultPlan:
    """Thread-safe registry of scheduled faults, keyed by site.

    `inject(site)` counts one operation at `site`, then fires the first
    matching spec: a stall sleeps `delay_s` and returns; fail/crash raise
    `InjectedFault`. Everything is deterministic under a fixed seed and
    per-site operation order."""

    specs: List[FaultSpec] = field(default_factory=list)
    seed: int = 0

    def __post_init__(self) -> None:
        self._lock = threading.Lock()
        self._ops: Dict[str, int] = {}
        self._fired: Dict[str, int] = {}
        self._rng: Dict[str, random.Random] = {}

    @classmethod
    def parse(cls, text: str, seed: int = 0) -> "FaultPlan":
        specs = [FaultSpec.parse(s) for s in text.split(";") if s.strip()]
        return cls(specs=specs, seed=seed)

    def _site_rng(self, site: str) -> random.Random:
        rng = self._rng.get(site)
        if rng is None:
            # a str seed hashes via sha512 (deterministic regardless of
            # PYTHONHASHSEED); a tuple would go through hash() and vary
            rng = self._rng[site] = random.Random(f"{self.seed}:{site}")
        return rng

    def fire(self, site: str) -> Optional[FaultSpec]:
        """Count one operation at `site`; return the spec that fires on it
        (first match wins), or None. Pure scheduling — no sleep, no raise."""
        with self._lock:
            n = self._ops[site] = self._ops.get(site, 0) + 1
            for spec in self.specs:
                if spec.site != site:
                    continue
                hit = spec.nth > 0 and spec.nth <= n < spec.nth + spec.times
                if not hit and spec.p > 0.0:
                    hit = self._site_rng(site).random() < spec.p
                if hit:
                    self._fired[site] = self._fired.get(site, 0) + 1
                    return spec
        return None

    def inject(self, site: str) -> None:
        """The injection-point call: fire the schedule for one operation at
        `site`, sleeping for stalls and raising `InjectedFault` for
        fail/crash. A site with no matching spec costs one dict lookup."""
        spec = self.fire(site)
        if spec is None:
            return
        if spec.kind == "stall":
            time.sleep(spec.delay_s)
            return
        raise InjectedFault(site, self._ops[site])

    # -- introspection (tests and the chaos bench read these) -----------
    def ops(self, site: str) -> int:
        """Operations counted at `site` so far."""
        return self._ops.get(site, 0)

    def fired(self, site: str) -> int:
        """Faults fired at `site` so far (stalls included)."""
        return self._fired.get(site, 0)

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for site in sorted(set(self._ops) | set(self._fired)):
            out[f"fault_ops_{site}"] = float(self._ops.get(site, 0))
            out[f"fault_fired_{site}"] = float(self._fired.get(site, 0))
        return out
