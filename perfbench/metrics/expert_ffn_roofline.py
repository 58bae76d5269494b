"""The expert FFN kernel's share of its roofline: the least time the
window's calls need (each call's useful (token, expert) pairs and the
experts they reach, `kernels/expert_ffn.py`, bound by bytes at 3.35 TB/s or
operations at 989 TFLOP/s, whichever is longer) over the device time of the
kernel's operations in the trace."""
from pathlib import Path

from perfbench import peaks
from perfbench.harness import load_module


def read(rec):
    tr, calls = rec.get("trace"), rec.get("expert_ffn")
    if not tr or not calls or not calls["calls"]:
        return None
    k = load_module(Path(__file__).resolve().parents[2], "kernels", "expert_ffn")
    busy = sum(s for name, (_, s) in tr["kernels"].items() if k.matches(name))
    if busy <= 0:
        return None
    d, F, glu = calls["d"], calls["F"], calls["glu"]
    least = sum(peaks.least_seconds(k.flops(p, d, F, glu), k.nbytes(p, e, d, F, glu))
                for p, e in calls["calls"])
    return 100.0 * least / busy
