"""Every token of every batch `SiDAEngine.serve` finished in the window,
over the window's seconds (host clock; the window ends when the last call
has returned, its logits on the host)."""


def read(rec):
    if "batch_latency_s" not in rec:
        return None
    return rec["tokens"] / rec["window_s"]
