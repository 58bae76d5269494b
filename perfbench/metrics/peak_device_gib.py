"""`torch.cuda.max_memory_allocated()` over the window, after
`reset_peak_memory_stats()` as it opens: the device memory the served
path held at its peak, in GiB. Read by the benchmark from the device's
allocator, not from the program."""


def read(rec):
    return rec["memory_peak_bytes"] / 2 ** 30
