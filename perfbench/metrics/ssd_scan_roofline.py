"""Mamba-2's SSD's share of its roofline: the least time the window's SSD
calls need (`kernels/ssd_scan.py`, each call over a batch's tokens at the
published chunk) over the device time the program's CUDA events measure
around them (`model.ssd`, counter `ssd_device_s`). Nothing where the
program records no such span."""
from pathlib import Path

from perfbench.harness import load_module


def read(rec):
    mb = rec.get("mamba2")
    if not mb or not mb["calls"] or mb["ssd_device_s"] <= 0:
        return None
    k = load_module(Path(__file__).resolve().parents[2], "kernels", "ssd_scan")
    least = mb["calls"] * k.least_seconds(mb["tokens_per_call"], mb["heads"], mb["head_dim"],
                                          mb["groups"], mb["state"], mb["chunk"])
    return 100.0 * least / mb["ssd_device_s"]
