"""`peak_device_gib` where experts are uploaded while batches run: the peak
then depends on how the pipeline's uploads and staging overlap each
forward, which the threads' timing moves from run to run, so it carries a
wider bound of its own."""


def read(rec):
    return rec["memory_peak_bytes"] / 2 ** 30
