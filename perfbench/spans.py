"""Spans the benchmark records around the program's layer boundaries.

The program has no spans of its own yet, so the harness wraps the engine's
bound methods on the instance it drives (`wrap`): each call records its name,
thread and wall-clock interval, the clock the profiler's device events carry,
so an idle gap on the device can be named by what the host was doing."""
from __future__ import annotations

import functools
import threading
import time
from typing import Callable, List, Optional, Tuple

Span = Tuple[str, int, int, int]   # name, thread id, start ns, end ns (time.time_ns)


class Spans:
    def __init__(self):
        self.items: List[Span] = []

    def wrap(self, obj, attr: str, name: str, after: Optional[Callable] = None) -> None:
        """Replace `obj.attr` by a wrapper that records a span around each
        call and then calls `after(result, *args)` where given."""
        inner = getattr(obj, attr)

        @functools.wraps(inner)
        def wrapper(*args, **kwargs):
            t0 = time.time_ns()
            try:
                out = inner(*args, **kwargs)
            finally:
                self.items.append((name, threading.get_ident(), t0, time.time_ns()))
            if after is not None:
                after(out, *args)
            return out

        setattr(obj, attr, wrapper)

    def labels(self, times_ns: List[int]) -> List[str]:
        """For each of the ascending `times_ns`, the innermost span of each
        thread open then, joined by '+' ("no span" where none is): one sweep
        over the spans in order of their start."""
        order = sorted(self.items, key=lambda s: s[2])
        out, active, i = [], [], 0
        for t in times_ns:
            while i < len(order) and order[i][2] <= t:
                active.append(order[i])
                i += 1
            active = [s for s in active if s[3] > t]
            inner = {}
            for name, tid, t0, _ in active:
                if tid not in inner or t0 >= inner[tid][0]:
                    inner[tid] = (t0, name)
            out.append("+".join(sorted({n for _, n in inner.values()})) or "no span")
        return out
