"""Time the inference thread spent a batch on expert uploads: the store's
synchronous prepare (`ExpertStore.stats.prepare_time`) plus the prefetch
pipeline's consumer stall (`PrefetchPipeline.stats.stall_s`)."""


def read(rec):
    if not rec.get("batches"):
        return None
    st = rec["store"]
    return (st["prepare_time_s"] + rec["prefetch_stall_s"]) / rec["batches"] * 1e3
