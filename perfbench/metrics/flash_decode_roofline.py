"""The decode attention kernel's share of its roofline: the least time the
window's calls need (each step's keys, `kernels/flash_decode.py`, bound by
bytes at 3.35 TB/s or operations at 989 TFLOP/s) over the device time of
the kernel's operations in the trace."""
from pathlib import Path

from perfbench import peaks
from perfbench.harness import load_module


def read(rec):
    tr, fd = rec.get("trace"), rec.get("flash_decode")
    if not tr or not fd:
        return None
    k = load_module(Path(__file__).resolve().parents[2], "kernels", "flash_decode")
    busy = sum(s for name, (_, s) in tr["kernels"].items() if k.matches(name))
    if busy <= 0:
        return None
    least = sum(n * peaks.least_seconds(
        k.flops(fd["lanes"], fd["heads"], fd["head_dim"], keys),
        k.nbytes(fd["lanes"], fd["heads"], fd["kv_heads"], fd["head_dim"], keys, fd["elem_bytes"]))
        for keys, n in fd["calls"])
    return 100.0 * least / busy
