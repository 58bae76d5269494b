"""State-space / recurrent mixers: Mamba (hymba's parallel branch), the
xLSTM blocks (port of `repro/models/ssm.py`) and Mamba-2, which the JAX
package does not have (a nemotron_h block's mixer, `mamba2_forward`).

Every recurrence is first-order linear (h_t = a_t ⊙ h_{t-1} + b_t), or its
max-plus form for the exponential gates' stabiliser. The full-sequence
paths are chunked, as the reference's: a loop carries the state across
chunks while the inner chunk runs either

  * mode="assoc": a log-depth scan within the chunk. `lax.associative_scan`
    has no PyTorch counterpart, so the combine runs as a Hillis–Steele
    doubling over the chunk axis, log2(ck) shifted combines (the reference
    combines in another tree, so the two round differently in the last
    bits), or
  * mode="scan": the sequential oracle, gates computed a step at a time.

Mamba-2's full-sequence path is the SSD's chunked form on batched matrix
products (`ssd_chunked`), not a scan. Decode paths are one O(1)-state
update. No Pallas kernel lies on this
path: the JAX package runs it in plain `jnp`, and the port in plain
PyTorch on every device. Jamba's Mamba (`block_kind` "jamba") adds RMSNorms
on Δ, B and C (leaves `dt_norm`, `b_norm`, `c_norm`) after the x projection;
hymba's has none and is computed as before. Given a `Telemetry` that
records spans, `mamba_forward` times its scan (`device_span`). Casts sit
where the reference's do: gates, states and the stabiliser `m` in fp32, the
Mamba conv state in the model dtype.
`F.softplus` is the identity above 20 where `jax.nn.softplus` is not; the
two differ there by less than fp32 resolves.
"""
from __future__ import annotations

import contextlib
import math
import time
from typing import TYPE_CHECKING, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, init_rmsnorm, rmsnorm

if TYPE_CHECKING:   # serving/ imports the engines, which import this module
    from repro_torch.serving.telemetry import Telemetry

CHUNK = 256  # inner-chunk length of the associative path

_OFF = contextlib.nullcontext()


def device_span(tel: Optional["Telemetry"], name: str, counter: str, x: torch.Tensor,
                calls: Optional[str] = None):
    """Around a block of device work on `x`'s device: the host span `name`
    of `tel`, and the block's device seconds added to counter `counter`. On
    CUDA they are a pair of events on the current stream, read when
    `tel.run_deferred()` runs after the stream has drained; on the CPU,
    whose operations have finished when they return, the host clock.
    Counter `calls`, where given, counts the blocks. One shared no-op unless
    `tel` records spans."""
    if tel is None or not tel.record_spans:
        return _OFF
    return _device_span(tel, name, counter, x.is_cuda, calls)


@contextlib.contextmanager
def _device_span(tel: "Telemetry", name: str, counter: str, cuda: bool, calls: Optional[str]):
    if calls is not None:
        tel.counter(calls).inc()
    with tel.span(name):
        if cuda:
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            yield
            t1.record()
            tel.defer(lambda: tel.counter(counter).inc(t0.elapsed_time(t1) / 1e3))
        else:
            c0 = time.perf_counter()
            yield
            tel.counter(counter).inc(time.perf_counter() - c0)


def _doubling(a: torch.Tensor, b: torch.Tensor, combine):
    """Inclusive scan of (a, b) pairs over axis 1 by Hillis–Steele doubling:
    at offset d every position t >= d takes combine(pair[t - d], pair[t])."""
    n, d = a.shape[1], 1
    while d < n:
        na, nb = combine(a[:, :-d], b[:, :-d], a[:, d:], b[:, d:])
        a = torch.cat([a[:, :d], na], dim=1)
        b = torch.cat([b[:, :d], nb], dim=1)
        d *= 2
    return a, b


def _linear_recurrence_chunk(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """h_t = a_t * h_{t-1} + b_t over axis 1 within one chunk (assoc)."""
    b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    _, hs = _doubling(a, b, lambda a1, b1, a2, b2: (a1 * a2, a2 * b1 + b2))
    return hs


def _maxplus_chunk(logf: torch.Tensor, logi: torch.Tensor, m0: torch.Tensor) -> torch.Tensor:
    """m_t = max(logf_t + m_{t-1}, logi_t) within one chunk (assoc)."""
    acum = torch.cumsum(logf, dim=1)
    _, b = _doubling(logf, logi,
                     lambda a1, b1, a2, b2: (a1 + a2, torch.maximum(b1 + a2, b2)))
    return torch.maximum(acum + m0[:, None], b)


def _chunked(x_seq: torch.Tensor, carry0, chunk_fn, step_fn, mode: str, ck: int = CHUNK):
    """Run a recurrence over [B, S, ...] sequences.

    chunk_fn(carry, xs_chunk) -> (carry, ys_chunk)   (assoc inner)
    step_fn(carry, xs_t) -> (carry, ys_t)            (sequential inner)
    """
    S = x_seq.shape[1]
    c, ys = carry0, []
    if mode == "scan":
        for t in range(S):
            c, y = step_fn(c, x_seq[:, t])
            ys.append(y)
        return torch.stack(ys, dim=1)
    ck = min(ck, S)
    if S % ck:
        # fall back to a divisor (S is a power-of-2-ish in all our shapes)
        for cand in range(min(ck, S), 0, -1):
            if S % cand == 0:
                ck = cand
                break
    for i in range(S // ck):
        c, y = chunk_fn(c, x_seq[:, i * ck:(i + 1) * ck])
        ys.append(y)
    return torch.cat(ys, dim=1)


# ===========================================================================
# Mamba (selective SSM): hymba's parallel branch, a jamba sublayer's mixer
# ===========================================================================


def init_mamba(gen, cfg: ModelConfig, device) -> dict:
    d = cfg.d_model
    s = cfg.ssm
    di = s.expand * d
    N = s.state_dim
    dt_rank = max(1, math.ceil(d / 16))
    dtype = getattr(torch, cfg.dtype)
    conv = torch.randn((s.conv_dim, di), generator=gen, dtype=torch.float32, device=gen.device)
    p = {
        "in_proj": dense_init(gen, d, 2 * di, dtype, device),
        "conv_w": (conv * 0.1).to(dtype=dtype, device=device),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_db": dense_init(gen, di, dt_rank + 2 * N, dtype, device),
        "dt_proj": dense_init(gen, dt_rank, di, dtype, device),
        "dt_bias": torch.full((di,), -2.0, dtype=dtype, device=device),  # small initial dt
        "A_log": torch.log(torch.arange(1, N + 1, dtype=torch.float32, device=device)
                           ).expand(di, N).contiguous(),
        "D": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": dense_init(gen, di, d, dtype, device),
    }
    if cfg.block_kind == "jamba":
        p.update(dt_norm=init_rmsnorm(dt_rank, dtype, device),
                 b_norm=init_rmsnorm(N, dtype, device), c_norm=init_rmsnorm(N, dtype, device))
    return p


def _mamba_gates(p: dict, xz: torch.Tensor, cfg: ModelConfig):
    """xz: [..., di] conv-ed activations -> (a, b, C) for the recurrence."""
    N = cfg.ssm.state_dim
    dt_rank = p["dt_proj"].shape[0]
    dbc = xz @ p["x_db"]
    dt, Bm, Cm = torch.split(dbc, [dt_rank, N, N], dim=-1)
    if "dt_norm" in p:   # jamba
        dt = rmsnorm(p["dt_norm"], dt, cfg.norm_eps)
        Bm = rmsnorm(p["b_norm"], Bm, cfg.norm_eps)
        Cm = rmsnorm(p["c_norm"], Cm, cfg.norm_eps)
    dt = F.softplus(dt @ p["dt_proj"] + p["dt_bias"]).float()
    A = -torch.exp(p["A_log"])                                 # [di, N]
    a = torch.exp(dt[..., None] * A)                           # [..., di, N]
    b = (dt[..., None] * Bm[..., None, :].float()) * xz[..., None].float()
    return a, b, Cm.float()


def _mamba_conv_full(p: dict, xs: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over [B, S, di]."""
    K = p["conv_w"].shape[0]
    S = xs.shape[1]
    xp = F.pad(xs, (0, 0, K - 1, 0))
    out = sum(xp[:, i:i + S] * p["conv_w"][i] for i in range(K))
    return F.silu(out + p["conv_b"])


def mamba_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, mode: str = "assoc",
                  tel: Optional["Telemetry"] = None) -> torch.Tensor:
    """Full-sequence Mamba mixer. x: [B, S, d] -> [B, S, d]. With a `tel`
    that records spans, the scan (from the conv's output and z to the gated
    y: Δ / B / C, the recurrence, the read-out, D and silu(z)) is the span
    `model.mamba_scan`, its device seconds counter `mamba_scan_device_s`."""
    xs, z = (x @ p["in_proj"]).chunk(2, dim=-1)                # [B, S, di] each
    xs = _mamba_conv_full(p, xs)
    with device_span(tel, "model.mamba_scan", "mamba_scan_device_s", x):
        y = _mamba_scan(p, xs, z, cfg, mode)
    return y @ p["out_proj"]


def _mamba_scan(p: dict, xs: torch.Tensor, z: torch.Tensor, cfg: ModelConfig,
                mode: str) -> torch.Tensor:
    """The selective scan over the conv'd xs [B, S, di], gated by z."""
    B = xs.shape[0]
    di = cfg.ssm.expand * cfg.d_model
    h0 = torch.zeros((B, di, cfg.ssm.state_dim), dtype=torch.float32, device=xs.device)

    def chunk_fn(h, xs_c):                                     # xs_c [B, ck, di]
        a, b, Cm = _mamba_gates(p, xs_c, cfg)                  # [B, ck, di, N]
        hs = _linear_recurrence_chunk(a, b, h)
        return hs[:, -1], torch.einsum("bsdn,bsn->bsd", hs, Cm)

    def step_fn(h, xs_t):                                      # xs_t [B, di]
        a, b, Cm = _mamba_gates(p, xs_t, cfg)                  # [B, di, N]
        h = a * h + b
        return h, torch.einsum("bdn,bn->bd", h, Cm)

    # chunk 64: the [B, ck, di, N] fp32 gate tensors are the live working set
    y = _chunked(xs, h0, chunk_fn, step_fn, mode, ck=64)
    y = y + p["D"] * xs.float()
    return y.to(z.dtype) * F.silu(z)


def mamba_init_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    di = cfg.ssm.expand * cfg.d_model
    return {
        "h": torch.zeros((batch, di, cfg.ssm.state_dim), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm.conv_dim - 1, di), dtype=dtype, device=device),
    }


def mamba_decode(p: dict, x: torch.Tensor, state: dict, cfg: ModelConfig):
    """One-token Mamba step. x: [B, d] -> (y [B, d], state)."""
    xs, z = (x @ p["in_proj"]).chunk(2, dim=-1)               # [B, di]
    conv = torch.cat([state["conv"], xs[:, None]], dim=1)      # [B, K, di]
    xs = F.silu(torch.einsum("bkd,kd->bd", conv, p["conv_w"]) + p["conv_b"])
    a, b, Cm = _mamba_gates(p, xs, cfg)                        # [B, di, N]
    h = a * state["h"] + b
    y = torch.einsum("bdn,bn->bd", h, Cm) + p["D"] * xs.float()
    y = y.to(x.dtype) * F.silu(z)
    return y @ p["out_proj"], {"h": h, "conv": conv[:, 1:]}


# ===========================================================================
# Mamba-2 (the SSD, arXiv:2405.21060): a nemotron_h block's mixer
# ===========================================================================


def _mamba2_sizes(cfg: ModelConfig):
    """(heads H, head dim P, groups G, state N, d_inner H·P, conv channels
    H·P + 2·G·N)."""
    s = cfg.ssm
    H, P, G, N = s.mamba2_heads, s.mamba2_head_dim, s.n_groups, s.state_dim
    return H, P, G, N, H * P, H * P + 2 * G * N


def init_mamba2(gen, cfg: ModelConfig, device) -> dict:
    """Mamba-2's leaves: `in_proj` d -> [z (di), xBC (di + 2·G·N), dt (H)],
    the depthwise conv over xBC (`conv_w` [K, channels], `conv_b`), a head's
    `dt_bias`, `A_log` and `D` (float32), the grouped norm's gain `norm` and
    `out_proj` di -> d. Δ's initial value is log-uniform in [1e-3, 0.1],
    floored at 1e-4, and `dt_bias` its softplus inverse; A = -U[1, 16]."""
    H, _, G, N, di, ch = _mamba2_sizes(cfg)
    d, K = cfg.d_model, cfg.ssm.conv_dim
    dtype = getattr(torch, cfg.dtype)
    f32 = dict(dtype=torch.float32, device=gen.device)
    conv = torch.randn((K, ch), generator=gen, **f32) * K ** -0.5
    u = torch.rand((H,), generator=gen, **f32)
    dt = torch.exp(math.log(1e-3) + u * (math.log(0.1) - math.log(1e-3))).clamp(min=1e-4)
    A = 1.0 + 15.0 * torch.rand((H,), generator=gen, **f32)
    return {
        "in_proj": dense_init(gen, d, di + ch + H, dtype, device),
        "conv_w": conv.to(dtype=dtype, device=device),
        "conv_b": torch.zeros((ch,), dtype=dtype, device=device),
        "dt_bias": (dt + torch.log(-torch.expm1(-dt))).to(device),
        "A_log": torch.log(A).to(device),
        "D": torch.ones((H,), dtype=torch.float32, device=device),
        "norm": init_rmsnorm(di, dtype, device),
        "out_proj": dense_init(gen, di, d, dtype, device),
    }


def _gated_norm(p: dict, y: torch.Tensor, z: torch.Tensor, groups: int, eps: float,
                dtype) -> torch.Tensor:
    """RMSNorm over each of the `groups` groups of y ⊙ silu(z) [..., di], in
    float32, then the (1 + gain) of the port's norms; returned in `dtype`."""
    g = (y.float() * F.silu(z.float())).unflatten(-1, (groups, -1))
    g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + eps)
    return (g.flatten(-2) * (1.0 + p["scale"].float())).to(dtype)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                Cm: torch.Tensor, chunk: int) -> torch.Tensor:
    """The SSD's chunked form of h_t = exp(Δ_t A) h_{t-1} + Δ_t x_t ⊗ B_t,
    y_t = h_t C_t, from h_0 = 0, on batched matrix products in float32.
    x [b, S, H, P], dt (Δ) [b, S, H], A [H], Bm / Cm [b, S, G, N] with head
    h in group h // (H / G) -> y [b, S, H, P]. A sequence that is not a
    whole number of chunks is padded with Δ = 0 (no decay, no input) at its
    end. With a_t = Δ_t A and its running sum A_t inside a chunk:

    1. inside a chunk, y_l = Σ_{s<=l} (C_l · B_s) exp(A_l - A_s) Δ_s x_s;
    2. a chunk's own state, Σ_s exp(A_end - A_s) B_s ⊗ Δ_s x_s;
    3. the state passed into chunk z, Σ_{c<z} exp(A over chunks c+1 .. z-1)
       times chunk c's own state;
    4. its read-out, y_l += exp(A_l) C_l · (the state passed in)."""
    b, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    R = H // G
    pad = -S % chunk
    if pad:
        x, dt, Bm, Cm = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, dt, Bm, Cm))
    c, L = (S + pad) // chunk, chunk
    xd = (x * dt[..., None]).view(b, c, L, G, R, P)                  # Δ x
    acum = (dt * A).view(b, c, L, H).cumsum(2)                       # A_l inside a chunk
    Bc, Cc = Bm.view(b, c, L, G, N), Cm.view(b, c, L, G, N)
    # 1. [b, c, H, l, s]: exp(A_l - A_s) on and below the diagonal, 0 above
    seg = acum.transpose(2, 3)[..., :, None] - acum.transpose(2, 3)[..., None, :]
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()
    decay = torch.exp(torch.where(causal, seg, torch.full_like(seg, -math.inf)))
    cb = torch.einsum("bclgn,bcsgn->bcgls", Cc, Bc)                   # shared by a group's heads
    m = cb[:, :, :, None] * decay.view(b, c, G, R, L, L)
    y = m @ xd.permute(0, 1, 3, 4, 2, 5)                              # [b, c, G, R, l, P]
    # 2. each chunk's own state [b, c, G, N, R, P]
    w = torch.exp(acum[:, :, -1:] - acum).view(b, c, L, G, R, 1)
    own = torch.einsum("bcsgn,bcsgrp->bcgnrp", Bc, xd * w)
    # 3. the state passed into each chunk: [b, z, c, H] over c < z
    tot = acum[:, :, -1].cumsum(1)                                   # through chunk c
    gap = (tot - acum[:, :, -1])[:, :, None] - tot[:, None]          # over c+1 .. z-1
    before = torch.ones((c, c), dtype=torch.bool, device=x.device).tril(-1)[..., None]
    carry = torch.exp(torch.where(before, gap, torch.full_like(gap, -math.inf)))
    h_in = torch.einsum("bzcgr,bcgnrp->bzgnrp", carry.view(b, c, c, G, R), own)
    # 4. its read-out
    y_off = torch.einsum("bclgn,bcgnrp->bclgrp", Cc, h_in)
    y = y.permute(0, 1, 4, 2, 3, 5) + y_off * torch.exp(acum).view(b, c, L, G, R, 1)
    return y.reshape(b, c * L, H, P)[:, :S]


def _ssd(p: dict, xbc: torch.Tensor, dt: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """From the conv's output xBC [b, S, ch] and dt [b, S, H] to y [b, S,
    di] before the gated norm: Δ = softplus(dt + dt_bias), the chunked SSD
    over x with the group's B and C, and the skip D x, in float32."""
    H, P, G, N, di, _ = _mamba2_sizes(cfg)
    b, S, _ = xbc.shape
    xs, Bm, Cm = xbc.float().split([di, G * N, G * N], dim=-1)
    delta = F.softplus(dt.float() + p["dt_bias"])
    x = xs.view(b, S, H, P)
    y = ssd_chunked(x, delta, -torch.exp(p["A_log"]), Bm.view(b, S, G, N), Cm.view(b, S, G, N),
                    cfg.ssm.chunk_size)
    return (y + p["D"][:, None] * x).reshape(b, S, di)


def mamba2_forward(p: dict, x: torch.Tensor, cfg: ModelConfig,
                   tel: Optional["Telemetry"] = None) -> torch.Tensor:
    """Full-sequence Mamba-2 mixer, x [B, S, d] -> [B, S, d]:

        [z, xBC, dt] = x W_in;  xBC = silu(causal depthwise conv(xBC) + b)
        [x, B, C] = xBC  (x in H heads of P, B and C in G groups of N;
                          H / G heads share a group)
        Δ = softplus(dt + dt_bias);  A = -exp(A_log)  (one scalar a head)
        h_t = exp(Δ_t A) h_{t-1} + Δ_t x_t ⊗ B_t;  y_t = h_t C_t + D x_t
        out = RMSNorm_grouped(y ⊙ silu(z)) W_out  (G groups of di / G)

    the recurrence in `ssd_chunked`'s form at the configuration's chunk.
    With a `tel` that records spans, the span `model.ssd` (its device
    seconds counter `ssd_device_s`) runs from the conv's output and dt to y
    before the gated norm."""
    H, _, G, _, di, ch = _mamba2_sizes(cfg)
    z, xbc, dt = (x @ p["in_proj"]).split([di, ch, H], dim=-1)
    xbc = _mamba_conv_full(p, xbc)
    with device_span(tel, "model.ssd", "ssd_device_s", x):
        y = _ssd(p, xbc, dt, cfg)
    return _gated_norm(p["norm"], y, z, G, cfg.norm_eps, x.dtype) @ p["out_proj"]


def mamba2_init_state(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    """The SSM state h [B, H, P, N] in float32 and the conv's window of the
    last K - 1 xBC inputs [B, K - 1, ch] in the model dtype."""
    H, P, _, N, _, ch = _mamba2_sizes(cfg)
    return {
        "h": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.ssm.conv_dim - 1, ch), dtype=dtype, device=device),
    }


def mamba2_decode(p: dict, x: torch.Tensor, state: dict, cfg: ModelConfig):
    """One-token Mamba-2 step, the recurrence at one position. x: [B, d] ->
    (y [B, d], state)."""
    H, P, G, N, di, ch = _mamba2_sizes(cfg)
    B = x.shape[0]
    z, xbc, dt = (x @ p["in_proj"]).split([di, ch, H], dim=-1)
    conv = torch.cat([state["conv"], xbc[:, None]], dim=1)            # [B, K, ch]
    xbc = F.silu(torch.einsum("bkc,kc->bc", conv, p["conv_w"]) + p["conv_b"])
    xs, Bm, Cm = xbc.float().split([di, G * N, G * N], dim=-1)
    delta = F.softplus(dt.float() + p["dt_bias"])                     # [B, H]
    xh = xs.view(B, H, P)
    Bh = Bm.view(B, G, 1, N).expand(B, G, H // G, N).reshape(B, H, N)
    Ch = Cm.view(B, G, 1, N).expand(B, G, H // G, N).reshape(B, H, N)
    a = torch.exp(delta * -torch.exp(p["A_log"]))
    h = a[..., None, None] * state["h"] + (delta[..., None] * xh)[..., None] * Bh[:, :, None]
    y = torch.einsum("bhpn,bhn->bhp", h, Ch) + p["D"][:, None] * xh
    y = _gated_norm(p["norm"], y.reshape(B, di), z, G, cfg.norm_eps, x.dtype)
    return y @ p["out_proj"], {"h": h, "conv": conv[:, 1:]}


# ===========================================================================
# xLSTM: mLSTM (matrix memory) and sLSTM (scalar memory) blocks
# ===========================================================================


def init_mlstm(gen, cfg: ModelConfig, device) -> dict:
    d = cfg.d_model
    H = cfg.ssm.xlstm_heads
    di = 2 * d                                                 # proj factor 2
    dtype = getattr(torch, cfg.dtype)
    return {
        "up": dense_init(gen, d, 2 * di, dtype, device),       # [x | gate]
        "wq": dense_init(gen, di, di, dtype, device),
        "wk": dense_init(gen, di, di, dtype, device),
        "wv": dense_init(gen, di, di, dtype, device),
        "w_if": dense_init(gen, di, 2 * H, dtype, device, scale=0.02),
        "b_i": torch.zeros((H,), dtype=torch.float32, device=device),
        "b_f": torch.full((H,), 3.0, dtype=torch.float32, device=device),  # forget-open init
        "out_norm": init_rmsnorm(di, dtype, device),
        "down": dense_init(gen, di, d, dtype, device),
    }


def _mlstm_qkv(p, xi, H):
    q, k, v = xi @ p["wq"], xi @ p["wk"], xi @ p["wv"]
    hd = q.shape[-1] // H
    sh = (*q.shape[:-1], H, hd)
    return q.reshape(sh).float() / math.sqrt(hd), k.reshape(sh).float(), v.reshape(sh).float()


def _mlstm_gates(p, xi, H):
    gates = (xi @ p["w_if"]).float()
    logi = gates[..., :H] + p["b_i"]
    logf = F.logsigmoid(gates[..., H:] + p["b_f"])
    return logi, logf


def _mlstm_out(C, n, m, q, p, zg, cfg):
    num = torch.einsum("...hkv,...hk->...hv", C, q)
    den = torch.clamp(torch.abs(torch.einsum("...hk,...hk->...h", n, q)), min=1.0)
    y = (num / den[..., None]).reshape(*q.shape[:-2], -1).to(zg.dtype)
    y = rmsnorm(p["out_norm"], y, cfg.norm_eps) * F.silu(zg)
    return y @ p["down"]


def _mlstm_step(carry, q, k, v, logi, logf):
    """One stabilised mLSTM update -> ((C, n, m), the normalised readout)."""
    C0, n0, m0 = carry
    m = torch.maximum(logf + m0, logi)
    i_st = torch.exp(logi - m)
    f_st = torch.exp(logf + m0 - m)
    C = f_st[..., None, None] * C0 + i_st[..., None, None] * torch.einsum("bhk,bhv->bhkv", k, v)
    n = f_st[..., None] * n0 + i_st[..., None] * k
    return C, n, m


def _mlstm_carry(C0, n0, a_end, bW, k, v):
    """The mLSTM state (C, n) at a chunk's end: the start state decayed by
    a_end [B, H] plus the chunk's keys and values weighted by
    bW [B, ck, H] (b_W[s] = D[W-1, s])."""
    C1 = a_end[..., None, None] * C0 + torch.einsum("bsh,bshk,bshv->bhkv", bW, k, v)
    n1 = a_end[..., None] * n0 + torch.einsum("bsh,bshk->bhk", bW, k)
    return C1, n1


def mlstm_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, mode: str = "assoc") -> torch.Tensor:
    """Full-sequence mLSTM. x: [B, S, d]."""
    B, S, _ = x.shape
    H = cfg.ssm.xlstm_heads
    xi, zg = (x @ p["up"]).chunk(2, dim=-1)
    hd = xi.shape[-1] // H
    f32 = dict(dtype=torch.float32, device=x.device)
    carry0 = (
        torch.zeros((B, H, hd, hd), **f32),                    # C (stabilised)
        torch.zeros((B, H, hd), **f32),                        # n
        torch.full((B, H), -math.inf, **f32),                  # m
    )

    def chunk_fn(carry, xi_c):                                 # xi_c [B, ck, di]
        """The chunkwise-parallel form: within the chunk an attention-like
        [ck, ck] product over decay-weighted q·k scores, across chunks only
        the O(hd²) state; the matrix memory is never stacked over time."""
        C0, n0, m0 = carry
        q, k, v = _mlstm_qkv(p, xi_c, H)                       # [B, ck, H, hd]
        logi, logf = _mlstm_gates(p, xi_c, H)                  # [B, ck, H]
        m = _maxplus_chunk(logf, logi, m0)                     # running stabiliser
        Fc = torch.cumsum(logf, dim=1)                         # [B, ck, H]
        # inter-chunk contribution scale: a_t = exp(F_t + m0 - m_t)
        a = torch.exp(Fc + m0[:, None] - m)
        # intra-chunk decay D[t, s] = exp(F_t - F_s + logi_s - m_t), s <= t
        expo = Fc[:, :, None] - Fc[:, None, :] + logi[:, None, :] - m[:, :, None]
        ck = xi_c.shape[1]
        tri = torch.tril(torch.ones((ck, ck), dtype=torch.bool, device=x.device))
        # mask BEFORE exp: s > t entries have positive exponents (F decreasing)
        D = torch.exp(torch.where(tri[None, :, :, None], expo, torch.full_like(expo, -math.inf)))
        w = D * torch.einsum("bthd,bshd->btsh", q, k)          # [B, ck, ck, H]
        num = (a[..., None] * torch.einsum("bthk,bhkv->bthv", q, C0)
               + torch.einsum("btsh,bshv->bthv", w, v))
        den = a * torch.einsum("bthk,bhk->bth", q, n0) + w.sum(dim=2)
        y = num / torch.clamp(torch.abs(den), min=1.0)[..., None]
        C1, n1 = _mlstm_carry(C0, n0, a[:, -1], D[:, -1], k, v)
        return (C1, n1, m[:, -1]), y

    def step_fn(carry, xi_t):                                  # xi_t [B, di]
        q, k, v = _mlstm_qkv(p, xi_t, H)                       # [B, H, hd]
        logi, logf = _mlstm_gates(p, xi_t, H)                  # [B, H]
        C, n, m = _mlstm_step(carry, q, k, v, logi, logf)
        num = torch.einsum("bhkv,bhk->bhv", C, q)
        den = torch.clamp(torch.abs(torch.einsum("bhk,bhk->bh", n, q)), min=1.0)
        return (C, n, m), num / den[..., None]

    y = _chunked(xi, carry0, chunk_fn, step_fn, mode, ck=64)
    y = y.reshape(B, S, -1).to(x.dtype)
    y = rmsnorm(p["out_norm"], y, cfg.norm_eps) * F.silu(zg)
    return y @ p["down"]


def mlstm_init_state(cfg: ModelConfig, batch: int, device) -> dict:
    H = cfg.ssm.xlstm_heads
    hd = 2 * cfg.d_model // H
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "C": torch.zeros((batch, H, hd, hd), **f32),
        "n": torch.zeros((batch, H, hd), **f32),
        "m": torch.full((batch, H), -math.inf, **f32),
    }


def mlstm_decode(p: dict, x: torch.Tensor, state: dict, cfg: ModelConfig):
    H = cfg.ssm.xlstm_heads
    xi, zg = (x @ p["up"]).chunk(2, dim=-1)
    q, k, v = _mlstm_qkv(p, xi, H)                             # [B, H, hd]
    logi, logf = _mlstm_gates(p, xi, H)
    C, n, m = _mlstm_step((state["C"], state["n"], state["m"]), q, k, v, logi, logf)
    return _mlstm_out(C, n, m, q, p, zg, cfg), {"C": C, "n": n, "m": m}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def init_slstm(gen, cfg: ModelConfig, device) -> dict:
    d = cfg.d_model
    dtype = getattr(torch, cfg.dtype)
    dff = max(1, int(4 * d // 3))
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "w_z": dense_init(gen, d, d, dtype, device),
        "w_gates": dense_init(gen, d, 3 * d, dtype, device, scale=0.02),  # i, f, o
        "b_i": torch.zeros((d,), **f32),
        "b_f": torch.full((d,), 3.0, **f32),
        "b_o": torch.zeros((d,), **f32),
        "ffn_in": dense_init(gen, d, dff, dtype, device),
        "ffn_gate": dense_init(gen, d, dff, dtype, device),
        "ffn_out": dense_init(gen, dff, d, dtype, device),
    }


def _slstm_gates(p, x):
    z = torch.tanh((x @ p["w_z"]).float())
    g = (x @ p["w_gates"]).float()
    d = z.shape[-1]
    logi = g[..., :d] + p["b_i"]
    logf = F.logsigmoid(g[..., d:2 * d] + p["b_f"])
    o = torch.sigmoid(g[..., 2 * d:] + p["b_o"])
    return z, logi, logf, o


def _slstm_step(carry, z, logi, logf):
    c0, n0, m0 = carry
    m = torch.maximum(logf + m0, logi)
    i_st = torch.exp(logi - m)
    f_st = torch.exp(logf + m0 - m)
    return f_st * c0 + i_st * z, f_st * n0 + i_st, m


def _slstm_ffn(p, h):
    """The post-FFN (pf = 4/3 GLU) of the xLSTM sLSTM block."""
    return (F.silu(h @ p["ffn_gate"]) * (h @ p["ffn_in"])) @ p["ffn_out"]


def slstm_forward(p: dict, x: torch.Tensor, cfg: ModelConfig, mode: str = "assoc") -> torch.Tensor:
    B, _, d = x.shape
    f32 = dict(dtype=torch.float32, device=x.device)
    carry0 = (torch.zeros((B, d), **f32), torch.zeros((B, d), **f32),
              torch.full((B, d), -math.inf, **f32))            # c, n, m

    def chunk_fn(carry, x_c):
        c0, n0, m0 = carry
        z, logi, logf, o = _slstm_gates(p, x_c)                # [B, ck, d]
        m = _maxplus_chunk(logf, logi, m0)
        m_prev = torch.cat([m0[:, None], m[:, :-1]], dim=1)
        i_st = torch.exp(logi - m)
        f_st = torch.exp(logf + m_prev - m)
        cs = _linear_recurrence_chunk(f_st, i_st * z, c0)
        ns = _linear_recurrence_chunk(f_st, i_st, n0)
        h = o * cs / torch.clamp(ns, min=1e-6)
        return (cs[:, -1], ns[:, -1], m[:, -1]), h

    def step_fn(carry, x_t):
        z, logi, logf, o = _slstm_gates(p, x_t)                # [B, d]
        c, n, m = _slstm_step(carry, z, logi, logf)
        return (c, n, m), o * c / torch.clamp(n, min=1e-6)

    h = _chunked(x, carry0, chunk_fn, step_fn, mode).to(x.dtype)
    return _slstm_ffn(p, h)


def slstm_init_state(cfg: ModelConfig, batch: int, device) -> dict:
    d = cfg.d_model
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "c": torch.zeros((batch, d), **f32),
        "n": torch.zeros((batch, d), **f32),
        "m": torch.full((batch, d), -math.inf, **f32),
    }


def slstm_decode(p: dict, x: torch.Tensor, state: dict, cfg: ModelConfig):
    z, logi, logf, o = _slstm_gates(p, x)                      # [B, d]
    c, n, m = _slstm_step((state["c"], state["n"], state["m"]), z, logi, logf)
    h = (o * c / torch.clamp(n, min=1e-6)).to(x.dtype)
    return _slstm_ffn(p, h), {"c": c, "n": n, "m": m}
