"""Device milliseconds a batch in the Mamba-2 mixers: the CUDA events the
program records around each Mamba-2 mixer call (`model.mamba2`, counter
`mamba2_device_s`) while the window is traced, over the window's batches.
Nothing where the program records no such span."""


def read(rec):
    mb = rec.get("mamba2")
    if not mb or not mb["calls"] or not rec.get("batches") or mb["device_s"] <= 0:
        return None
    return mb["device_s"] / rec["batches"] * 1e3
