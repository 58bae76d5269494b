"""The device trace of a `--trace 1` run: `torch.profiler` with device
activity only (CUPTI; host operations are not recorded, so the traced
window keeps the host's pace), reduced to the seconds some operation ran on
the device, each kernel's count and seconds, and the idle gaps named by the
harness's spans."""
from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

TOP = 10


class DeviceTrace:
    """On a CPU device (the tests) the host's operations stand in for the
    device's."""

    def __init__(self, device: str):
        self.cuda = device.startswith("cuda")
        self.prof = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA if self.cuda
                                        else ProfilerActivity.CPU])
        self.prof.__enter__()

    def stop(self) -> None:
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def events(self) -> Tuple[List[str], np.ndarray, np.ndarray]:
        """(names, start ns, end ns) of every device operation (kernels,
        copies, fills: the events the trace places on the device)."""
        kind = "CUDA" if self.cuda else "CPU"
        names, starts, ends = [], [], []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type().name == kind:
                t = e.start_ns()
                names.append(e.name())
                starts.append(t)
                ends.append(t + e.duration_ns())
        return names, np.asarray(starts, np.int64), np.asarray(ends, np.int64)


def collect(tracer: DeviceTrace, t0: int, t1: int, spans) -> Optional[Dict]:
    """Stop the trace and reduce it over the window [t0, t1]; the cost of
    each step goes to standard error."""
    c0 = time.perf_counter()
    tracer.stop()
    c1 = time.perf_counter()
    names, start, end = tracer.events()
    c2 = time.perf_counter()
    out = reduce(names, start, end, t0, t1, spans)
    print(f"perfbench: trace stop {c1 - c0:.1f} s, {len(names)} device operations read in "
          f"{c2 - c1:.1f} s, reduced in {time.perf_counter() - c2:.1f} s", file=sys.stderr)
    return out


def short_name(name: str) -> str:
    """A kernel's name without its trailing argument list, at most 120
    characters ("void (anonymous namespace)::k<64>(int, float)" ->
    "void (anonymous namespace)::k<64>")."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return name[:120]


def _idle_before(ga: np.ndarray, gb: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Idle ns in [window start, t) for sorted, disjoint gaps [ga, gb)."""
    cum = np.concatenate([[0], np.cumsum(gb - ga)])
    i = np.searchsorted(gb, t, side="right")            # gaps ended by t
    partial = np.where(i < len(ga), np.clip(t - ga[np.minimum(i, len(ga) - 1)], 0, None), 0)
    return cum[i] + partial


def reduce(names: List[str], start: np.ndarray, end: np.ndarray, t0: int, t1: int,
           spans) -> Optional[Dict]:
    """busy_s (the union of device operations within [t0, t1]), window_s,
    {short name: [count, seconds]}, and the breakdown: the operations that
    took most time, and the idle time by what the host was doing (the
    innermost span of each thread, constant between span boundaries)."""
    keep = (end > t0) & (start < t1)
    if not keep.any():
        return None
    a = np.clip(start[keep], t0, t1)
    b = np.clip(end[keep], t0, t1)
    order = np.argsort(a, kind="stable")
    a, b = a[order], np.maximum.accumulate(b[order])
    # a new busy run starts where an operation starts after all before it ended
    new = np.concatenate([[True], a[1:] > b[:-1]])
    run_a, run_b = a[new], np.concatenate([b[:-1][new[1:]], [b[-1]]])
    busy = int((run_b - run_a).sum())
    ga = np.concatenate([[t0], run_b])
    gb = np.concatenate([run_a, [t1]])
    ga, gb = ga[gb > ga], gb[gb > ga]
    raw: Dict[str, List[float]] = {}
    for n, d in zip(names, (end - start).tolist()):
        k = raw.setdefault(n, [0, 0])
        k[0] += 1
        k[1] += d
    kernels: Dict[str, List[float]] = {}
    for n, (c, d) in raw.items():
        k = kernels.setdefault(short_name(n), [0, 0.0])
        k[0] += c
        k[1] += d / 1e9
    bounds = sorted({t for _, _, x, y in spans.items for t in (x, y) if t0 < t < t1})
    edges = np.asarray([t0, *bounds, t1], np.int64)
    idle_in = np.diff(_idle_before(ga, gb, edges))
    idle: Dict[str, float] = {}
    for label, ns in zip(spans.labels(edges[:-1].tolist()), idle_in.tolist()):
        if ns > 0:
            idle[label] = idle.get(label, 0.0) + ns / 1e9
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:TOP]
    return {
        "busy_s": busy / 1e9,
        "window_s": (t1 - t0) / 1e9,
        "kernels": kernels,
        "breakdown": {
            "device_ops": [[n, s] for n, (_, s) in top_ops],
            "idle_gaps": [[n, s] for n, s in sorted(idle.items(), key=lambda kv: -kv[1])[:TOP]],
        },
    }
