"""The window's nominal model FLOPs (`perfbench/flops.py`: what the published
model does for the tokens completed) over the window's seconds, as a share
of the card's published bf16 peak (989 TFLOP/s dense)."""
from perfbench import peaks


def read(rec):
    if not rec.get("model_flops") or not rec.get("trace"):
        return None
    return 100.0 * rec["model_flops"] / rec["window_s"] / peaks.BF16_FLOPS
