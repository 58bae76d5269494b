"""Decode attention over a ring cache (`kernels/ops.py::flash_decode` ->
`csrc/flash_decode.cu`): its device operation's name and the least work a
call needs: each lane's valid keys and values read once with their slot
positions, its query read and output written once."""
NAMES = ("flash_decode_kernel",)


def matches(name: str) -> bool:
    return any(n in name for n in NAMES)


def flops(lanes: int, heads: int, head_dim: int, keys: int) -> float:
    return 4.0 * lanes * heads * head_dim * keys


def nbytes(lanes: int, heads: int, kv_heads: int, head_dim: int, keys: int, elem: int) -> float:
    return lanes * (2.0 * keys * kv_heads * head_dim * elem + 2.0 * heads * head_dim * elem
                    + 4.0 * keys + 4.0)
