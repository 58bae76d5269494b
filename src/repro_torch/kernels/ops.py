"""Dispatch layer over the port's kernels (port of `repro/kernels/ops.py`).

A CPU tensor goes to the plain version in `kernels.ref`; a CUDA tensor goes
to the hand-written kernel, which launches or raises — nothing falls back
from the card to a library call or to the plain version. Each wrapper counts
its kernel launches (`launches()`, `reset_launches()`), so a run can show
that its path went through the kernels; the attention wrappers also count
them by head shape, window and softcap (`launches_by_shape()`), so a model
whose layers differ (a local and a global layer) shows each form's. A CUDA
graph captures the wrappers' launches once and replays them without
passing through the wrappers: its capture runs under `held_launches()`,
which keeps the capturing thread's counts out of the totals, and each replay
adds them back with `add_launches`.

Under grad mode, with an input that requires grad, `expert_ffn`,
`flash_prefill` and `sparsemax` go through their `kernels.autograd`
Functions (the same forward, an explicit PyTorch backward) on both devices;
the other four wrappers have no backward, since the reference never trains
through them, and raise a ValueError there rather than return a result cut
off from the graph.
"""
from __future__ import annotations

import contextlib
import functools
import threading
from typing import Dict, Iterator, Optional, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.autograd import ExpertFFN, FlashPrefill, Sparsemax
from repro_torch.kernels.expert_gemm import expert_ffn_cuda, expert_ffn_q4_cuda, expert_ffn_q_cuda
from repro_torch.kernels.flash_decode import flash_decode_cuda, flash_decode_paged_cuda
from repro_torch.kernels.flash_prefill import check_key_length, flash_prefill_cuda
from repro_torch.kernels.sparsemax import sparsemax_cuda

KERNELS = ("expert_ffn", "sparsemax", "flash_prefill", "flash_decode", "expert_ffn_q",
           "expert_ffn_q4", "flash_decode_paged")
_LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}
# (kernel, query heads, kv heads, head_dim, window, softcap) -> launches
_BY_SHAPE: Dict[tuple, int] = {}
_count_lock = threading.Lock()   # the hash and inference threads both launch
# a thread's (by kernel, by shape) counts while it holds them (`held_launches`)
_held = threading.local()


def reset_launches() -> None:
    with _count_lock:
        for name in KERNELS:
            _LAUNCHES[name] = 0
        _BY_SHAPE.clear()


def launches() -> Dict[str, int]:
    with _count_lock:
        return dict(_LAUNCHES)


def launches_by_shape() -> Dict[tuple, int]:
    """The attention kernels' launches since the last reset, by (kernel,
    query heads, kv heads, head_dim, window, softcap); a launch in another
    form than causal self-attention adds it as a seventh entry: "noncausal"
    (flash_prefill over an encoder) or "cross" (cross-attention, either
    kernel; the caller names it)."""
    with _count_lock:
        return dict(_BY_SHAPE)


def add_launches(counts: Dict[str, int], by_shape: Dict[tuple, int]) -> None:
    """Add launches made without the wrappers (a CUDA graph's replay): by
    kernel, and by the shape keys of `launches_by_shape()`."""
    with _count_lock:
        for name, n in counts.items():
            _LAUNCHES[name] += n
        for key, n in by_shape.items():
            _BY_SHAPE[key] = _BY_SHAPE.get(key, 0) + n


@contextlib.contextmanager
def held_launches() -> Iterator[Tuple[Dict[str, int], Dict[tuple, int]]]:
    """Count this thread's wrapper calls inside the block apart, for a CUDA
    graph's capture, which launches nothing: the totals are left as they
    were, and the block's counts fill the yielded (by kernel, by shape)
    pair, nonzero entries only. Other threads' calls meanwhile count in the
    totals as ever, so a capture on the hash thread leaves the inference
    thread's forwards counted once."""
    held: Tuple[Dict[str, int], Dict[tuple, int]] = ({}, {})
    outer = getattr(_held, "counts", None)
    _held.counts = held
    try:
        yield held
    finally:
        _held.counts = outer


def _count(name: str, q=None, k=None, window: int = 0, cap: float = 0.0,
           form: Optional[str] = None) -> None:
    counts, by_shape = getattr(_held, "counts", None) or (_LAUNCHES, _BY_SHAPE)
    with _count_lock:
        counts[name] = counts.get(name, 0) + 1
        if q is not None:
            key = (name, q.shape[-2], k.shape[-2], q.shape[-1], int(window), float(cap))
            if form is not None:
                key += (form,)
            by_shape[key] = by_shape.get(key, 0) + 1


def _on_card(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for device {t.device}")


def _wants_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


def _no_backward(name: str, *ts) -> None:
    if _wants_grad(*ts):
        raise ValueError(f"{name}: the kernel has no backward; call it under torch.no_grad()")


def expert_ffn(xe, w_in, w_gate: Optional[torch.Tensor], w_out, act: str = "silu"):
    """xe [E, C, d] -> [E, C, d] through each slot's (G)LU FFN."""
    if _wants_grad(xe, w_in, w_gate, w_out):
        return ExpertFFN.apply(_expert_ffn, xe, w_in, w_gate, w_out, act)
    return _expert_ffn(xe, w_in, w_gate, w_out, act=act)


def _expert_ffn(xe, w_in, w_gate, w_out, act):
    if _on_card(xe, "expert_ffn"):
        out = expert_ffn_cuda(xe, w_in, w_gate, w_out, act=act)
        _count("expert_ffn")
        return out
    return ref.expert_ffn_ref(xe, w_in, w_gate, w_out, act=act)


def expert_ffn_q(xe, w_in_q, w_in_scale, w_gate_q: Optional[torch.Tensor],
                 w_gate_scale: Optional[torch.Tensor], w_out_q, w_out_scale,
                 act: str = "silu"):
    """xe [E, C, d] -> [E, C, d] through each slot's FFN over int8 weights
    with per-output-channel fp32 scales."""
    _no_backward("expert_ffn_q", xe, w_in_scale, w_gate_scale, w_out_scale)
    if _on_card(xe, "expert_ffn_q"):
        out = expert_ffn_q_cuda(xe, w_in_q, w_in_scale, w_gate_q, w_gate_scale,
                                w_out_q, w_out_scale, act=act)
        _count("expert_ffn_q")
        return out
    return ref.expert_ffn_q_ref(xe, w_in_q, w_in_scale, w_gate_q, w_gate_scale,
                                w_out_q, w_out_scale, act=act)


def expert_ffn_q4(xe, w_in_q4, w_in_scale, w_gate_q4: Optional[torch.Tensor],
                  w_gate_scale: Optional[torch.Tensor], w_out_q4, w_out_scale,
                  act: str = "silu"):
    """xe [E, C, d] -> [E, C, d] through each slot's FFN over nibble-packed
    int4 weights with per-group fp32 scales (the warm tier)."""
    _no_backward("expert_ffn_q4", xe, w_in_scale, w_gate_scale, w_out_scale)
    if _on_card(xe, "expert_ffn_q4"):
        out = expert_ffn_q4_cuda(xe, w_in_q4, w_in_scale, w_gate_q4, w_gate_scale,
                                 w_out_q4, w_out_scale, act=act)
        _count("expert_ffn_q4")
        return out
    return ref.expert_ffn_q4_ref(xe, w_in_q4, w_in_scale, w_gate_q4, w_gate_scale,
                                 w_out_q4, w_out_scale, act=act)


def sparsemax(z: torch.Tensor) -> torch.Tensor:
    """z [..., L] -> simplex projection along the last axis."""
    if _wants_grad(z):
        return Sparsemax.apply(_sparsemax, z)
    return _sparsemax(z)


def _sparsemax(z):
    if _on_card(z, "sparsemax"):
        out = sparsemax_cuda(z)
        _count("sparsemax")
        return out
    return ref.sparsemax_ref(z)


def flash_prefill(q, k, v, window: int = 0, cap: float = 0.0, causal: bool = True,
                  cross: bool = False):
    """q [B, S, H, D], k/v [B, S_kv, K, D] -> [B, S, H, D] in q's dtype;
    S_kv != S only unmasked (causal=False, window=0: cross-attention, which
    the caller names by `cross` for the launch count)."""
    check_key_length(q.shape[1], k.shape[1], window, causal)
    form = "cross" if cross else None if causal else "noncausal"
    fwd = functools.partial(_flash_prefill, form=form)
    if _wants_grad(q, k, v):
        return FlashPrefill.apply(fwd, q, k, v, window, cap, causal)
    return fwd(q, k, v, window=window, cap=cap, causal=causal)


def _flash_prefill(q, k, v, window, cap, causal, form=None):
    if _on_card(q, "flash_prefill"):
        out = flash_prefill_cuda(q, k, v, window=window, cap=cap, causal=causal)
        _count("flash_prefill", q, k, window, cap, form)
        return out
    return ref.flash_prefill_ref(q, k, v, window=window, cap=cap, causal=causal).to(q.dtype)


def flash_decode(q, k, v, slot_pos, pos, window: int = 0, cap: float = 0.0,
                 cross: bool = False):
    """q [B, H, D] over a ring cache k/v [B, S, K, D] whose slots hold the
    global positions `slot_pos` [B, S] (-1 invalid) -> [B, H, D] in q's dtype.
    `cross` names cross-attention's read of an encoder cache for the launch
    count."""
    _no_backward("flash_decode", q, k, v)
    if _on_card(q, "flash_decode"):
        out = flash_decode_cuda(q, k, v, slot_pos, pos, window=window, cap=cap)
        _count("flash_decode", q, k, window, cap, "cross" if cross else None)
        return out
    return ref.flash_decode_ref(q, k, v, slot_pos, pos, window=window, cap=cap).to(q.dtype)


def flash_decode_paged(q, kp, vp, page_table, pos, window: int = 0, cap: float = 0.0):
    """q [B, H, D] over a shared page pool kp/vp [P+1, page, K, D] read
    through page_table [B, Mp] (-1 = not resident) -> [B, H, D] in q's dtype."""
    _no_backward("flash_decode_paged", q, kp, vp)
    if _on_card(q, "flash_decode_paged"):
        out = flash_decode_paged_cuda(q, kp, vp, page_table, pos, window=window, cap=cap)
        _count("flash_decode_paged", q, kp, window, cap)
        return out
    return ref.flash_decode_paged_ref(q, kp, vp, page_table, pos, window=window,
                                      cap=cap).to(q.dtype)
