"""The Mamba scan's share of its roofline: the least time the window's scan
calls need (`kernels/mamba_scan.py`, each call over a batch's tokens) over
the device time the program's CUDA events measure around them
(`model.mamba_scan`, counter `mamba_scan_device_s`). Nothing where the
program records no such span."""
from pathlib import Path

from perfbench.harness import load_module


def read(rec):
    mb = rec.get("mamba")
    if not mb or not mb["calls"] or mb["scan_device_s"] <= 0:
        return None
    k = load_module(Path(__file__).resolve().parents[2], "kernels", "mamba_scan")
    least = mb["calls"] * k.least_seconds(mb["tokens_per_call"], mb["d_inner"], mb["dt_rank"],
                                          mb["state"])
    return 100.0 * least / mb["scan_device_s"]
