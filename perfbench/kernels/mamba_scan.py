"""The Mamba scan (`models/ssm.py::mamba_forward`, the span
`model.mamba_scan`): from the conv's output u and the gate z to the gated y,
through Δ / B / C, the recurrence, the read-out and D. The least work a
call needs, whatever computes it:

- operations: the x and dt projections (2 · di · (R + 2N) + 2 · R · di a
  token) at the bf16 peak, and the recurrence's discretise, update and
  read-out (6 · di · N a token) in float32 at 67 TFLOP/s (the H100 SXM's
  published float32 rate outside the tensor cores);
- bytes: u, z and y once each (bf16, di a token), and W_x, W_dt, b_dt, the
  three norms' gains (bf16), A_log and D (float32) once.

Its least time is the larger of the operations' time (the two kinds added)
and the bytes' time at 3.35 TB/s."""
from perfbench import peaks

FP32_FLOPS = 67e12
ELEM = 2


def flops_bf16(tokens: int, di: int, R: int, N: int) -> float:
    return 2.0 * tokens * (di * (R + 2 * N) + R * di)


def flops_fp32(tokens: int, di: int, N: int) -> float:
    return 6.0 * tokens * di * N


def nbytes(tokens: int, di: int, R: int, N: int) -> float:
    weights = ELEM * (di * (R + 2 * N) + R * di + di + R + 2 * N) + 4 * (di * N + di)
    return ELEM * 3.0 * tokens * di + weights


def least_seconds(tokens: int, di: int, R: int, N: int) -> float:
    compute = flops_bf16(tokens, di, R, N) / peaks.BF16_FLOPS + flops_fp32(tokens, di, N) / FP32_FLOPS
    return max(compute, nbytes(tokens, di, R, N) / peaks.BYTES_S)
