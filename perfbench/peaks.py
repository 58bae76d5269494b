"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet: dense rates,
no sparsity, at the full 700 W power limit). Rooflines and MFU are stated
against them, with the card's power limit beside each run."""
BF16_FLOPS = 989e12
BYTES_S = 3.35e12


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time a call of `flops` operations over `nbytes` bytes can
    take on the card: the larger of its compute and its memory bound."""
    return max(flops / BF16_FLOPS, nbytes / BYTES_S)
