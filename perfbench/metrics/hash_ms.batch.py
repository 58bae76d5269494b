"""The predictor's time a batch on the hash-ahead thread
(`ServeMetrics.hash_time_s` over the window's batches): building the hash
table, its copy to the host and, with a prefetch pipeline, the submit."""


def read(rec):
    if not rec.get("batches"):
        return None
    return rec["hash_time_s"] / rec["batches"] * 1e3
