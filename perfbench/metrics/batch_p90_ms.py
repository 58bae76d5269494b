"""The 90th percentile, over all batches of the window, of each batch's
`ServeMetrics.latency_s`: from the inference thread taking the batch to its
logits on the device, synchronised (host clock)."""
import numpy as np


def read(rec):
    lat = rec.get("batch_latency_s")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat), 90)) * 1e3
