"""Mamba-2's SSD (`models/ssm.py::_ssd`, the span `model.ssd`): from the
conv's output (x, B, C) and dt to y before the gated norm, through Δ, the
chunked recurrence and the skip D x. The least work one call over a
batch's tokens needs, whatever computes it, counted at the published chunk
L of 128:

- operations: C·Bᵀ inside a chunk, a token against the positions it sees
  there ((L + 1) / 2 of them on average over a whole chunk: G·N·2 each), the
  masked product of those scores with Δ x (H·P·2 each), the chunk's state
  and its read-out (2·H·P·N each a token), on the tensor cores at the bf16
  peak; the decays exp(A_l - A_s), one a seen position a head, and the
  discretisation and skip (3·H·P a token), in float32 at 67 TFLOP/s (the
  H100 SXM's published float32 rate outside the tensor cores);
- bytes: x, B, C, dt and y once each (bf16: H·P, G·N, G·N, H and H·P a
  token), and A_log, D and dt_bias (float32, H each) once.

Its least time is the larger of the operations' time (the two kinds added)
and the bytes' time at 3.35 TB/s. The state passed between chunks is not
counted: a chunk's G·N·H·P numbers, which a fused kernel keeps on chip."""
from perfbench import peaks

FP32_FLOPS = 67e12
ELEM = 2


def flops_mm(tokens: int, H: int, P: int, G: int, N: int, L: int) -> float:
    return tokens * ((G * N + H * P) * (L + 1.0) + 4.0 * H * P * N)


def flops_fp32(tokens: int, H: int, P: int, L: int) -> float:
    return tokens * (H * (L + 1.0) / 2.0 + 3.0 * H * P)


def nbytes(tokens: int, H: int, P: int, G: int, N: int) -> float:
    return ELEM * tokens * (2.0 * H * P + 2.0 * G * N + H) + 4.0 * 3 * H


def least_seconds(tokens: int, H: int, P: int, G: int, N: int, L: int) -> float:
    compute = (flops_mm(tokens, H, P, G, N, L) / peaks.BF16_FLOPS
               + flops_fp32(tokens, H, P, L) / FP32_FLOPS)
    return max(compute, nbytes(tokens, H, P, G, N) / peaks.BYTES_S)
