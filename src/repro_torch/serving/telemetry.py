"""Serving telemetry: counters, gauges, histograms with JSON export (a copy
of `repro/serving/telemetry.py`, which is framework-free).

Replaces the ad-hoc print-a-few-floats reporting of the batch engines with
a structured registry the server, the launcher, and the benchmarks all
share: `Telemetry.snapshot()` is a plain dict (JSON-serializable) carrying
p50/p95/p99 latency, TTFT, queue depth, H2D bytes, cache hit rate, …
"""
from __future__ import annotations

import contextlib
import json
import math
import threading
import time
from typing import Dict, List, Optional

# metrics are written from several threads at once (the hash-ahead thread
# rejects/admits while the serve loop ticks and the transfer threads flush
# stats); a float `+=` is read-modify-write, so unguarded concurrent incs
# can drop counts. One shared lock is plenty — these are not hot-loop ops.
_metrics_lock = threading.Lock()


class Counter:
    """Monotonic event count (requests completed, tokens generated, …).
    Thread-safe: admission runs on the hash thread, ticks on the main one."""

    def __init__(self) -> None:
        self.value: float = 0

    def inc(self, v: float = 1) -> None:
        with _metrics_lock:
            self.value += v


class Gauge:
    """Point-in-time value (queue depth, active lanes, …). Keeps the max
    ever seen so a snapshot exposes peak pressure, not just the final state."""

    def __init__(self) -> None:
        self.value: float = 0
        self.max: float = 0

    def set(self, v: float) -> None:
        with _metrics_lock:
            self.value = v
            self.max = max(self.max, v)


class Histogram:
    """Exact-sample histogram (serving runs are bounded, so no sketching):
    percentiles are computed from the raw observations at snapshot time."""

    def __init__(self) -> None:
        self.samples: List[float] = []

    def observe(self, v: float) -> None:
        with _metrics_lock:
            self.samples.append(float(v))

    @property
    def count(self) -> int:
        return len(self.samples)

    def percentile(self, q: float) -> float:
        """Ceil-based nearest rank: at least a q-fraction of the samples
        lie at or below the returned value. (Banker's rounding would pick
        the LOWER of two samples for p50 and understate small-count tail
        percentiles — an SLO report must err high, not low.)"""
        if not self.samples:
            return 0.0
        xs = sorted(self.samples)
        idx = min(len(xs) - 1, max(0, math.ceil(q / 100.0 * (len(xs) - 1))))
        return xs[idx]

    def summary(self) -> Dict[str, float]:
        if not self.samples:
            return {"count": 0}
        return {
            "count": self.count,
            "mean": sum(self.samples) / self.count,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
            "max": max(self.samples),
        }


class Telemetry:
    """Named-metric registry with get-or-create accessors and JSON export."""

    def __init__(self) -> None:
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        # per-tenant partitions (multi-tenant serving): child registries
        # keyed by tenant name, surfaced as a "tenants" block in snapshots.
        # Created lazily so single-tenant snapshots stay byte-identical to
        # the pre-tenant schema (no empty "tenants" key).
        self._tenants: Dict[str, "Telemetry"] = {}
        self._t0 = time.perf_counter()

    def counter(self, name: str) -> Counter:
        return self._counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        return self._gauges.setdefault(name, Gauge())

    def histogram(self, name: str) -> Histogram:
        return self._histograms.setdefault(name, Histogram())

    def tenant(self, name: str) -> "Telemetry":
        """Get-or-create the per-tenant child registry. The server writes
        each request's metrics to the global registry AND to its tenant's
        partition, so per-tenant SLO attainment / throughput / shed counts
        are first-class in every snapshot."""
        return self._tenants.setdefault(name, Telemetry())

    def tenant_names(self) -> List[str]:
        return sorted(self._tenants)

    def wall_s(self) -> float:
        return time.perf_counter() - self._t0

    def ratio(self, num: str, den: str) -> float:
        """Counter ratio with a zero-denominator guard — acceptance rate
        (spec_accepted_tokens / spec_proposed_tokens), hit rates, and any
        other derived fraction the summaries report."""
        d = self.counter(den).value
        return self.counter(num).value / d if d else 0.0

    @contextlib.contextmanager
    def timer(self, name: str):
        """Time a block into histogram `name` and accumulate the total into
        counter `name + "_total"` — the serving loop wraps prefetch-fence
        waits with this so stall time shows up in every snapshot."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.histogram(name).observe(dt)
            self.counter(name + "_total").inc(dt)

    def snapshot(self) -> dict:
        snap = {
            "wall_s": self.wall_s(),
            "counters": {k: c.value for k, c in self._counters.items()},
            "gauges": {
                k: {"last": g.value, "max": g.max} for k, g in self._gauges.items()
            },
            "histograms": {k: h.summary() for k, h in self._histograms.items()},
        }
        if self._tenants:
            snap["tenants"] = {
                name: t.snapshot() for name, t in sorted(self._tenants.items())
            }
        return snap

    def to_json(self, indent: Optional[int] = 2) -> str:
        return json.dumps(self.snapshot(), indent=indent)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())
