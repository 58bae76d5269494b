"""The expert FFN (`kernels/ops.py::expert_ffn` -> `csrc/expert_ffn_sm90.cu`):
the names of its device operations (the up- and down-projection GEMMs,
the small-batch tile and the split-K reduction) and the least work a call
needs: each (token, expert) pair that carries weight through its expert's
two or three matrices, each reached expert's weights read once, each
pair's input read and output written once, in bf16."""
NAMES = ("sm90_gemm_kernel", "sm90_swap_kernel", "splitk_reduce_kernel")
ELEM = 2


def matches(name: str) -> bool:
    return any(n in name for n in NAMES)


def flops(pairs: int, d: int, F: int, glu: bool) -> float:
    return 2.0 * pairs * d * F * (3 if glu else 2)


def nbytes(pairs: int, experts: int, d: int, F: int, glu: bool) -> float:
    return ELEM * (2.0 * pairs * d + experts * d * F * (3 if glu else 2))
