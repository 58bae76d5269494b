"""Batch serving of the Nemotron-H hybrid: `batch_serve`'s driver (the same
closed loop of `SiDAEngine.serve` calls, the same sample and record, read
from the same traffic file keys) with what a model of one mixer a block
needs of its own:

- the weights: the leaves of a model whose block s holds a norm and the one
  mixer `attn.layer_pattern[s]` names, Mamba-2 ("mamba2"), the MoE ("moe":
  its router and correction bias, the routed experts' stacks and the
  non-gated shared expert) or attention ("global"), drawn through
  `weights._tree` as `weights.py` draws every leaf. The Mamba-2 sizes are
  the configuration's `ssm` group. Three leaves of a Mamba-2 mixer are made
  from their draw as Mamba-2 initialises them, in float32 as the program
  keeps them: with u = Φ(the standard normal draw), uniform in (0, 1),
  dt_bias is the softplus inverse of Δ = exp(log 1e-3 + u · log 100),
  floored at 1e-4; A_log is log(1 + 15 u); D is 1. The router's bias is
  drawn N(0, 0.01). The predictor has one head a MoE block of the pattern;
- the configuration (`build`): `modelcfg.build` with the `ssm` group passed
  too, refusing a program whose configuration or blocks lack nemotron_h
  before any weight is drawn;
- the nominal FLOPs (`sequence`): a Mamba-2 block counts its in and out
  projections and the SSD at its chunk (C·Bᵀ and the masked product with
  x over the positions a token sees in its chunk, the chunk's state and
  its read-out), a MoE block its top-k relu² experts (two matrices each)
  and its shared expert, an attention block as `flops.py` counts one, and
  the head;
- the check: `batch_serve`'s, with the MoE blocks counted from the pattern,
  on a sample kept as a reservoir: `batch_serve` keeps every call's sample
  (here 4 rows of [1024, 131072] bf16 logits, 1 GB a call, ~40 calls a
  window) and draws `check.calls` of them after the window; this driver
  keeps a uniform random `check.calls` of the window's calls as it goes
  (reservoir sampling, drawn from the seed), which bounds the host memory
  a window holds;
- the Mamba-2 counters: the engine records its spans into a `Telemetry`
  while the window is traced, and the record's "mamba2" holds the window's
  Mamba-2 mixer calls, their device seconds (`model.mamba2`) and their
  SSDs' (`model.ssd`), with the sizes `kernels/ssd_scan.py` needs. A
  program without these spans leaves the counters at 0, and the metrics
  that read them report nothing.

`batch_serve` is loaded again as a module of this driver's own, with this
file's weights, FLOPs and configuration in place of its attention-only
ones, so the cells that run `batch_serve` itself are untouched.
"""
from __future__ import annotations

import importlib.util
import math
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from perfbench import compare, flops, weights
from perfbench.reference import routing
from perfbench.weights import EMBED_STD, NORM_STD, Leaf, padded_vocab

COUNTERS = {"calls": "mamba2_calls", "device_s": "mamba2_device_s",
            "ssd_device_s": "ssd_device_s"}
BLOCK_KIND = "nemotron_h"


def pattern(m: Dict) -> List[str]:
    """The mixer of every block of the model's depth."""
    p = m["attn"]["layer_pattern"]
    return [p[layer % len(p)] for layer in range(m["n_layers"])]


def n_moe(m: Dict) -> int:
    return pattern(m).count("moe")


def mamba2_sizes(m: Dict):
    """(heads H, head dim P, groups G, state N, d_inner, conv channels)."""
    s = m["ssm"]
    H, P, G, N = s["mamba2_heads"], s["mamba2_head_dim"], s["n_groups"], s["state_dim"]
    return H, P, G, N, H * P, H * P + 2 * G * N


def _mamba2_leaves(b, m: Dict) -> List[Leaf]:
    d, K = m["d_model"], m["ssm"]["conv_dim"]
    H, _, _, _, di, ch = mamba2_sizes(m)
    x = b + ("mamba2",)
    return [(x + ("in_proj",), (d, di + ch + H), d ** -0.5, True),
            (x + ("conv_w",), (K, ch), K ** -0.5, True),
            (x + ("conv_b",), (ch,), NORM_STD, True),
            (x + ("dt_bias",), (H,), 1.0, True),
            (x + ("A_log",), (H,), 1.0, True),
            (x + ("D",), (H,), 1.0, True),
            (x + ("norm", "scale"), (di,), NORM_STD, True),
            (x + ("out_proj",), (di, d), di ** -0.5, True)]


def _moe_leaves(b, m: Dict) -> List[Leaf]:
    d, moe = m["d_model"], m["moe"]
    E, F = moe["num_experts"], moe["d_expert"]
    ds = moe["num_shared_experts"] * moe["d_shared"]
    x = b + ("moe",)
    # w_gate is drawn for the non-gated experts too: the program's store
    # keeps and uploads all three stacks
    out = [(x + ("router",), (d, E), d ** -0.5, True),
           (x + ("router_bias",), (E,), 0.01, True),
           (x + ("w_in",), (E, d, F), d ** -0.5, True),
           (x + ("w_gate",), (E, d, F), d ** -0.5, True),
           (x + ("w_out",), (E, F, d), F ** -0.5, True)]
    if ds:
        out += [(x + ("shared_w_in",), (d, ds), d ** -0.5, True),
                (x + ("shared_w_out",), (ds, d), ds ** -0.5, True)]
    return out


def model_leaves(m: Dict) -> List[Leaf]:
    """(path, shape without the group axis, std, stacked over groups)."""
    d, H, K = m["d_model"], m["n_heads"], m["n_kv_heads"]
    D = m["head_dim"] or d // H
    p = m["attn"]["layer_pattern"]
    out: List[Leaf] = [(("embed",), (padded_vocab(m["vocab_size"]), d), EMBED_STD, False)]
    for s, kind in enumerate(p):
        b = ("blocks", f"sub{s}")
        out.append((b + ("ln1", "scale"), (d,), NORM_STD, True))
        if kind == "mamba2":
            out += _mamba2_leaves(b, m)
        elif kind == "moe":
            out += _moe_leaves(b, m)
        else:
            out += [(b + ("attn", "wq"), (d, H * D), d ** -0.5, True),
                    (b + ("attn", "wk"), (d, K * D), d ** -0.5, True),
                    (b + ("attn", "wv"), (d, K * D), d ** -0.5, True),
                    (b + ("attn", "wo"), (H * D, d), (H * D) ** -0.5, True)]
    out.append((("final_norm", "scale"), (d,), NORM_STD, False))
    out.append((("head",), (d, padded_vocab(m["vocab_size"])), EMBED_STD, False))
    return out


def model_params(spec: Dict, device) -> Dict:
    m = spec["model"]
    tree = weights._tree(model_leaves(m), spec["weights"]["model_seed"],
                         m["n_layers"] // len(m["attn"]["layer_pattern"]),
                         getattr(torch, m["dtype"]), device)
    for sub in tree["blocks"].values():
        if "mamba2" in sub:
            p = sub["mamba2"]
            u = 0.5 * (1.0 + torch.erf(p["dt_bias"].float() / math.sqrt(2.0)))
            dt = torch.exp(math.log(1e-3) + u * math.log(100.0)).clamp(min=1e-4)
            p["dt_bias"] = dt + torch.log(-torch.expm1(-dt))
            u = 0.5 * (1.0 + torch.erf(p["A_log"].float() / math.sqrt(2.0)))
            p["A_log"] = torch.log(1.0 + 15.0 * u)
            p["D"] = torch.ones_like(p["D"], dtype=torch.float32)
    return tree


def predictor_leaves(m: Dict, d_h: int) -> List[Leaf]:
    """`weights.predictor_leaves` with one head a MoE block of the pattern."""
    d = m["d_model"]
    out: List[Leaf] = [(("compress",), (d, d_h), d ** -0.5, False)]
    for name in ("lstm1", "lstm2"):
        out += [((name, "wx"), (d_h, 4 * d_h), d_h ** -0.5, False),
                ((name, "wh"), (d_h, 4 * d_h), d_h ** -0.5, False),
                ((name, "b"), (4 * d_h,), 0.0, False)]
    out += [(("attn_q",), (d_h, d_h), d_h ** -0.5, False),
            (("heads",), (d_h, n_moe(m) * m["moe"]["num_experts"]), d_h ** -0.5, False)]
    return out


def predictor_params(spec: Dict, device) -> Dict:
    w = spec["weights"]
    return weights._tree(predictor_leaves(spec["model"], w["predictor_d_h"]),
                         w["predictor_seed"], 1, torch.float32, device)


def build(spec: Dict):
    """The program's `ModelConfig` from the file's `model` group, its `ssm`
    group included. A program without the nemotron_h block kind (or its
    configuration's fields: the Mamba-2 sizes, the sigmoid router, relu²)
    is refused here, before any weight is drawn."""
    from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig, SSMConfig
    from repro_torch.models.transformer import sub_kind

    m = dict(spec["model"])
    attn, moe, ssm = dict(m.pop("attn")), m.pop("moe"), m.pop("ssm")
    attn["layer_pattern"] = tuple(attn["layer_pattern"])
    try:
        cfg = ModelConfig(**m, attn=AttnConfig(**attn), moe=MoEConfig(**moe), ssm=SSMConfig(**ssm))
    except TypeError as e:
        raise ValueError(f"this program has no block kind {BLOCK_KIND!r} (act "
                         f"{m['act']!r}): its configuration refuses {e}") from None
    if sub_kind(cfg, 0).get("kind") != BLOCK_KIND:
        raise ValueError(f"this program has no block kind {BLOCK_KIND!r}")
    return cfg


def per_token(m: Dict, keys: float) -> float:
    """A token at position keys - 1 of its row: Mamba-2 blocks count their
    projections and the SSD at the configuration's chunk (the token sees
    ((keys - 1) mod chunk) + 1 positions of its chunk), MoE blocks their
    top-k relu² experts and the shared expert, attention blocks their
    projections and keys, and the head."""
    d, H, K = m["d_model"], m["n_heads"], m["n_kv_heads"]
    D = m["head_dim"] or d // H
    moe = m["moe"]
    Hm, P, G, N, di, ch = mamba2_sizes(m)
    seen = (keys - 1) % m["ssm"]["chunk_size"] + 1
    mamba2 = 2 * d * (di + ch + Hm) + 2 * di * d + 2 * (G * N + di) * seen + 4 * di * N
    moe_f = (moe["top_k"] * 2 * 2 * d * moe["d_expert"]
             + moe["num_shared_experts"] * 2 * 2 * d * moe["d_shared"])
    attn = 2 * d * (2 * H * D + 2 * K * D) + 4 * H * D * keys
    blocks = {"mamba2": mamba2, "moe": moe_f, "global": attn}
    return sum(blocks[kind] for kind in pattern(m)) + 2 * d * m["vocab_size"]


def sequence(m: Dict, length: int) -> float:
    """A causal row of `length` tokens, position s seeing s + 1 keys."""
    return sum(per_token(m, s + 1) for s in range(length))


def _base():
    """`batch_serve`, loaded as a module of this driver's own whose
    `weights`, `flops` and `build` are this file's."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_drivers_nemotron_batch_serve_base", Path(__file__).with_name("batch_serve.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.weights = SimpleNamespace(**{**vars(weights), "model_params": model_params,
                                     "predictor_params": predictor_params})
    mod.flops = SimpleNamespace(**{**vars(flops), "sequence": sequence})
    mod.build = build
    return mod


class Driver(_base().Driver):
    def reseed(self, seed: int) -> None:
        super().reseed(seed)
        self.rng_keep = np.random.default_rng(self.rng_check.integers(1 << 62))
        self.seen, self.unsettled = 0, False

    def _settle(self) -> None:
        """Put the newest call's finished sample into the reservoir of
        `check.calls` samples: kept while there is room, else in place of a
        uniformly drawn one with probability calls / (calls seen)."""
        if not self.unsettled:
            return
        self.unsettled = False
        k = self.ctx.cell.workload["check"]["calls"]
        new = self.samples.pop()
        j = self.rng_keep.integers(self.seen + 1)
        self.seen += 1
        if len(self.samples) < k:
            self.samples.append(new)
        elif j < k:
            self.samples[j] = new

    def _on_translate(self, out, table, trans) -> None:
        """`batch_serve`'s, the previous call's sample settled first: the
        window's loop completes the newest sample, the list's last."""
        if self.call >= 0 and table.batch_index == self.pick:
            self._settle()
            self.unsettled = True
        super()._on_translate(out, table, trans)

    def setup(self) -> None:
        from repro_torch.serving.telemetry import Telemetry

        build(self.spec)
        super().setup()
        self.tel = Telemetry()
        self.eng.telemetry = self.tel

    def _counters(self) -> Dict[str, float]:
        return {k: self.tel.counter(c).value for k, c in COUNTERS.items()}

    def window(self, seconds: float, trace: bool) -> Dict:
        """`batch_serve`'s window, the engine's spans on while traced; the
        record gains the window's Mamba-2 counters."""
        self.tel.record_spans = trace
        before = self._counters()
        rec = super().window(seconds, trace)
        H, P, G, N, _, _ = mamba2_sizes(self.m)
        rec["mamba2"] = {k: v - before[k] for k, v in self._counters().items()}
        rec["mamba2"].update(tokens_per_call=self.tr["batch"] * self.tr["seq"], heads=H,
                             head_dim=P, groups=G, state=N, chunk=self.m["ssm"]["chunk_size"])
        return rec

    @torch.no_grad()
    def check(self, ref, control: bool) -> Dict[str, float]:
        """`batch_serve`'s check, the MoE blocks counted from the pattern."""
        self._settle()
        dev, m = self.ctx.device, self.m
        moe = m["moe"]
        W = model_params(self.spec, dev)
        hp = predictor_params(self.spec, dev)
        n = min(self.ctx.cell.workload["check"]["calls"], len(self.samples))
        picked = sorted(np.random.default_rng(self.rng_check.integers(1 << 62)).choice(
            len(self.samples), n, replace=False))
        out = {"slots_missing": 0.0, "slots_invalid": 0.0, "hash_gap": 0.0, "alpha_err": 0.0,
               "logit_err": 0.0}
        with ref.exact_fp32():
            for i in picked:
                s = self.samples[i]
                need = routing.needed_experts(s["ids"], s["alpha"], self.slots, self.E)
                miss, bad = routing.residency_faults(s["trans"], need, self.slots)
                out["slots_missing"] += miss
                out["slots_invalid"] += bad
                rows = s["rows"]
                toks = torch.as_tensor(s["tokens"][rows], device=dev)
                emb = W["embed"][toks.long()].float()
                want = ref.predictor_logits(hp, emb, n_moe(m), self.E).movedim(2, 0)
                ids, alpha = s["ids"][:, rows], s["alpha"][:, rows]
                if control:
                    low = ref.predictor_logits(hp, emb, n_moe(m), self.E, prec="tf32").movedim(2, 0)
                    vals, top = ref.top_k(low, ids.shape[-1])
                    ids, alpha = top.cpu().numpy(), torch.softmax(vals, -1).cpu().numpy()
                gap, err = compare.routing_gap(want, ids, alpha)
                out["hash_gap"] = max(out["hash_gap"], gap)
                out["alpha_err"] = max(out["alpha_err"], err)
                eff = routing.effective_routing(s["ids"], s["alpha"], s["trans"], self.slots,
                                                moe["top_k"], moe["capacity_factor"])
                experts = torch.as_tensor(s["ids"][:, rows][..., : eff.shape[-1]], device=dev)
                w = torch.as_tensor(eff[:, rows], device=dev)
                want = ref.forward(W, m, toks, experts, w)
                got = (ref.forward(W, m, toks, experts, w, prec="fp8") if control
                       else s["logits"][..., : m["vocab_size"]].to(dev))
                out["logit_err"] = max(out["logit_err"], compare.logit_error(got, want))
        return out
