"""Batch serving of the Jamba hybrid: `batch_serve`'s driver (the same
closed loop of `SiDAEngine.serve` calls, the same sample, record and check,
read from the same traffic file keys) with three things of its own:

- the weights: the leaves of a model whose sublayer s mixes with attention
  where `attn.layer_pattern[s]` is "global" and with Mamba where it is
  "mamba", each followed by the MoE FFN on every `moe_every`-th sublayer and
  a dense SwiGLU elsewhere, drawn through `weights._tree` as `weights.py`
  draws every leaf. The Mamba sizes are `SSMConfig`'s defaults, which
  `modelcfg.build` leaves in place (state 16, conv 4, expand 2; dt rank
  ceil(d / 16)). Three leaves take a fixed offset after the draw, as
  Mamba's own initialisation centres them: A_log log(1..N) per state, dt_bias
  -4 (Δ = softplus near 0.02), D 1; A_log and D are then float32, as the
  program keeps them;
- the nominal FLOPs (`sequence`): `flops.py`'s count with each sublayer's
  mixer as the pattern says, a Mamba counting its four projections;
- the Mamba counters: the engine records its spans into a `Telemetry` while
  the window is traced, and the record's "mamba" holds the window's Mamba
  mixer calls, their device seconds (`model.mamba`) and their scans'
  (`model.mamba_scan`), with the sizes `kernels/mamba_scan.py` needs. A
  program without these spans leaves the counters at 0, and the metrics
  that read them report nothing.

`batch_serve` is loaded again as a module of this driver's own, with this
file's weights and FLOPs in place of its attention-only ones, so the cells
that run `batch_serve` itself are untouched.
"""
from __future__ import annotations

import importlib.util
import math
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List

import torch

from perfbench import flops, weights
from perfbench.reference.moe_transformer import is_moe, period
from perfbench.weights import EMBED_STD, NORM_STD, Leaf, padded_vocab

STATE, CONV, EXPAND = 16, 4, 2      # SSMConfig's defaults: the program's Mamba sizes
DT_BIAS, D_SKIP = -4.0, 1.0
COUNTERS = {"calls": "mamba_calls", "device_s": "mamba_device_s",
            "scan_device_s": "mamba_scan_device_s"}


def _mamba_leaves(b, d: int) -> List[Leaf]:
    di, R, N = EXPAND * d, math.ceil(d / 16), STATE
    m = b + ("mamba",)
    return [(m + ("in_proj",), (d, 2 * di), d ** -0.5, True),
            (m + ("conv_w",), (CONV, di), CONV ** -0.5, True),
            (m + ("conv_b",), (di,), NORM_STD, True),
            (m + ("x_db",), (di, R + 2 * N), di ** -0.5, True),
            (m + ("dt_norm", "scale"), (R,), NORM_STD, True),
            (m + ("b_norm", "scale"), (N,), NORM_STD, True),
            (m + ("c_norm", "scale"), (N,), NORM_STD, True),
            (m + ("dt_proj",), (R, di), R ** -0.5, True),
            (m + ("dt_bias",), (di,), 0.5, True),
            (m + ("A_log",), (di, N), 0.5, True),
            (m + ("D",), (di,), NORM_STD, True),
            (m + ("out_proj",), (di, d), di ** -0.5, True)]


def model_leaves(m: Dict) -> List[Leaf]:
    """(path, shape without the group axis, std, stacked over groups)."""
    d, H, K = m["d_model"], m["n_heads"], m["n_kv_heads"]
    D = m["head_dim"] or d // H
    F, E, pattern = m["d_ff"], m["moe"]["num_experts"], m["attn"]["layer_pattern"]
    out: List[Leaf] = [(("embed",), (padded_vocab(m["vocab_size"]), d), EMBED_STD, False)]
    for s in range(period(m)):
        b = ("blocks", f"sub{s}")
        out.append((b + ("ln1", "scale"), (d,), NORM_STD, True))
        if pattern[s % len(pattern)] == "global":
            out += [(b + ("attn", "wq"), (d, H * D), d ** -0.5, True),
                    (b + ("attn", "wk"), (d, K * D), d ** -0.5, True),
                    (b + ("attn", "wv"), (d, K * D), d ** -0.5, True),
                    (b + ("attn", "wo"), (H * D, d), (H * D) ** -0.5, True)]
        else:
            out += _mamba_leaves(b, d)
        out.append((b + ("ln2", "scale"), (d,), NORM_STD, True))
        if is_moe(m, s):
            Fe = m["moe"]["d_expert"]
            out += [(b + ("moe", "w_in"), (E, d, Fe), d ** -0.5, True),
                    (b + ("moe", "w_gate"), (E, d, Fe), d ** -0.5, True),
                    (b + ("moe", "w_out"), (E, Fe, d), Fe ** -0.5, True)]
        else:
            out += [(b + ("mlp", "w_in"), (d, F), d ** -0.5, True),
                    (b + ("mlp", "w_out"), (F, d), F ** -0.5, True),
                    (b + ("mlp", "w_gate"), (d, F), d ** -0.5, True)]
    out.append((("final_norm", "scale"), (d,), NORM_STD, False))
    out.append((("head",), (d, padded_vocab(m["vocab_size"])), EMBED_STD, False))
    return out


def model_params(spec: Dict, device) -> Dict:
    m = spec["model"]
    tree = weights._tree(model_leaves(m), spec["weights"]["model_seed"],
                         m["n_layers"] // period(m), getattr(torch, m["dtype"]), device)
    for sub in tree["blocks"].values():
        if "mamba" in sub:
            p = sub["mamba"]
            n = torch.arange(1, STATE + 1, dtype=torch.float32, device=device)
            p["A_log"] = p["A_log"].float() + torch.log(n)
            p["dt_bias"] = (p["dt_bias"].float() + DT_BIAS).to(p["dt_bias"].dtype)
            p["D"] = p["D"].float() + D_SKIP
    return tree


def per_token(m: Dict, keys: float) -> float:
    """`flops.per_token` with each sublayer's mixer as the pattern says: a
    Mamba counts its in, x, dt and out projections."""
    d, H, K = m["d_model"], m["n_heads"], m["n_kv_heads"]
    D = m["head_dim"] or d // H
    di, R, N = EXPAND * d, math.ceil(d / 16), STATE
    moe, pattern, per = m["moe"], m["attn"]["layer_pattern"], period(m)
    total = 0.0
    for layer in range(m["n_layers"]):
        s = layer % per
        if pattern[s % len(pattern)] == "global":
            total += 2 * d * (2 * H * D + 2 * K * D) + 4 * H * D * keys
        else:
            total += 2 * (d * 2 * di + di * (R + 2 * N) + R * di + di * d)
        if is_moe(m, s):
            total += moe["top_k"] * 2 * 3 * d * moe["d_expert"]
        else:
            total += 2 * 3 * d * m["d_ff"]
    return total + 2 * d * m["vocab_size"]


def sequence(m: Dict, length: int) -> float:
    """A causal row of `length` tokens, position s seeing s + 1 keys."""
    return sum(per_token(m, s + 1) for s in range(length))


def _base():
    """`batch_serve`, loaded as a module of this driver's own whose
    `weights` and `flops` are this file's."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_drivers_hybrid_batch_serve_base", Path(__file__).with_name("batch_serve.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.weights = SimpleNamespace(**{**vars(weights), "model_params": model_params})
    mod.flops = SimpleNamespace(**{**vars(flops), "sequence": sequence})
    return mod


class Driver(_base().Driver):
    def setup(self) -> None:
        from repro_torch.serving.telemetry import Telemetry

        super().setup()
        self.tel = Telemetry()
        self.eng.telemetry = self.tel

    def _counters(self) -> Dict[str, float]:
        return {k: self.tel.counter(c).value for k, c in COUNTERS.items()}

    def window(self, seconds: float, trace: bool) -> Dict:
        """`batch_serve`'s window, the engine's spans on while traced; the
        record gains the window's Mamba counters."""
        self.tel.record_spans = trace
        before = self._counters()
        rec = super().window(seconds, trace)
        m = self.m
        rec["mamba"] = {k: v - before[k] for k, v in self._counters().items()}
        rec["mamba"].update(tokens_per_call=self.tr["batch"] * self.tr["seq"],
                            d_inner=EXPAND * m["d_model"], dt_rank=math.ceil(m["d_model"] / 16),
                            state=STATE)
        return rec
