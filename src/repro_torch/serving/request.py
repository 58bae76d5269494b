"""Request lifecycle for the serving subsystem (a numpy-only copy of
`repro/serving/request.py`).

A `Request` carries one user prompt through

    QUEUED -> PREFILL -> DECODE -> DONE   (or REJECTED)

with per-request timestamps at every transition, an optional latency SLO
(deadline = arrival + slo), the hash-ahead table built at admission, and
the generated-token stream. The batch engines operate on anonymous token
matrices; everything SLA-aware in the scheduler hangs off this object.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from repro_torch.core.hash_table import HashTable


class RequestState(enum.Enum):
    QUEUED = "queued"      # arrived, waiting for a prefill batch
    PREFILL = "prefill"    # in a running prefill forward
    DECODE = "decode"      # occupying a decode lane
    DONE = "done"          # finished (max_new_tokens generated)
    REJECTED = "rejected"  # dropped (deadline already blown before prefill)


@dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # [P] int32 token ids
    max_new_tokens: int
    arrival_s: float = 0.0             # offset from stream start
    slo_s: Optional[float] = None      # latency SLO; deadline = arrival + slo
    tenant: str = "default"            # multi-tenant front door: owner id,
    #                                    stamped at admission (WFQ queue,
    #                                    token budget, telemetry partition)

    state: RequestState = RequestState.QUEUED
    generated: List[int] = field(default_factory=list)
    on_token: Optional[Callable[[int], None]] = None  # token-stream callback

    # hash-ahead output, built at admission (before any model compute)
    table: Optional[HashTable] = None

    lane: int = -1                     # decode lane while state == DECODE
    prefill_logits: Optional[np.ndarray] = None  # kept only when asked
    decode_logits: Optional[List[np.ndarray]] = None  # per-step, when asked

    # why admission refused this request (state == REJECTED)
    reject_reason: Optional[str] = None
    # chunked-prefill progress: prompt tokens consumed so far (long prompts
    # served through the paged K/V path advance this chunk by chunk)
    chunk_pos: int = 0

    # lifecycle timestamps (server-clock seconds; -1 = not reached)
    t_queued: float = -1.0
    t_prefill: float = -1.0
    t_first_token: float = -1.0
    t_done: float = -1.0

    @property
    def prompt_len(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def deadline_s(self) -> float:
        return self.arrival_s + self.slo_s if self.slo_s is not None else float("inf")

    def slack(self, now: float) -> float:
        return self.deadline_s - now

    @property
    def ttft_s(self) -> float:
        """Time to first token (arrival -> first generated token)."""
        return self.t_first_token - self.arrival_s if self.t_first_token >= 0 else -1.0

    @property
    def latency_s(self) -> float:
        """End-to-end latency (arrival -> last token)."""
        return self.t_done - self.arrival_s if self.t_done >= 0 else -1.0

    def emit(self, token: int) -> None:
        self.generated.append(int(token))
        if self.on_token is not None:
            self.on_token(int(token))

    def finished(self) -> bool:
        return len(self.generated) >= self.max_new_tokens


def poisson_requests(
    rng: np.random.Generator,
    n: int,
    rate_rps: float,
    vocab_size: int,
    prompt_len_range=(8, 32),
    max_new_range=(4, 16),
    slo_s: Optional[float] = None,
    tenant: str = "default",
    rid_base: int = 0,
) -> List[Request]:
    """Synthetic open-loop arrival stream: exponential inter-arrival gaps
    (Poisson process at `rate_rps`), uniform prompt lengths and decode
    budgets: the arrival stream `RequestServer.run` serves in the launcher,
    the serving benchmark and `chip_smoke.py`."""
    reqs: List[Request] = []
    t = 0.0
    for i in range(n):
        t += float(rng.exponential(1.0 / rate_rps))
        p = int(rng.integers(prompt_len_range[0], prompt_len_range[1] + 1))
        m = int(rng.integers(max_new_range[0], max_new_range[1] + 1))
        prompt = rng.integers(0, vocab_size, (p,)).astype(np.int32)
        reqs.append(
            Request(
                rid=rid_base + i, prompt=prompt, max_new_tokens=m,
                arrival_s=t, slo_s=slo_s, tenant=tenant,
            )
        )
    return reqs
