"""The share of the traced window in which no operation ran on the device
(`torch.profiler`, device activity only; the union over streams)."""


def read(rec):
    tr = rec.get("trace")
    if not tr:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
