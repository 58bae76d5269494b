"""Decode: `SiDADecodeEngine.generate`, greedy, many lanes at once, in a
closed loop of calls back to back, each from start tokens drawn from the
seed over a fresh ring cache.

Traffic file keys: `lanes`, `steps` (tokens a lane a call), `cache_len`
(ring slots), `history` (the predictor's attention ring, as the program
keeps it), `warmup_steps`, `tokens` (the start tokens' distribution), and
the deployment's `slots` a MoE layer, `eviction`, `prefetch_depth`.

The check, on calls and lanes drawn from the seed:
- `slots_missing`, `slots_invalid`: each step's needed experts hold a slot
  in the translation its step used, no slot named twice;
- `hash_gap`, `alpha_err`: each step's predicted experts and α against the
  reference's one-token predictor run over the lane's inputs;
- `token_gap`: each served token against the reference's full causal
  forward over the lane's inputs, routed by the program's predictions
  through the reference's own translation and capacity drops (capacity
  counts every lane of a step): the widest gap by which a served token's
  logit lies below the reference's best.
"""
from __future__ import annotations

import sys
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import compare, device, flops, generate, weights
from perfbench.modelcfg import build
from perfbench.reference import routing
from perfbench.trace import DeviceTrace, collect


class Driver:
    def __init__(self, ctx):
        self.ctx = ctx
        self.spec = ctx.cell.config
        self.m = self.spec["model"]
        self.tr = ctx.cell.traffic
        self.E = self.m["moe"]["num_experts"]
        self.slots = min(self.tr["slots"], self.E)
        self.steps: List[tuple] = []      # (ids, alpha, trans) of each step of the current call
        self.record = False
        self.reseed(ctx.seed)

    def reseed(self, seed: int) -> None:
        """Draw the next window's inputs and sample from `seed`."""
        self.rng_warm, self.rng_tokens, self.rng_check = generate.streams(seed, 3)
        self.calls: List[Dict] = []

    def _on_route(self, out, table, _metrics) -> None:
        if self.record:
            self.steps.append((table.expert_ids[:, :, 0].copy(), table.weights[:, :, 0].copy(),
                               np.array(out[0])))

    def _start(self, rng) -> np.ndarray:
        return generate.token_ids(rng, (self.tr["lanes"],), self.m["vocab_size"], self.tr["tokens"])

    def setup(self) -> None:
        """Weights drawn on the device, the engine built from them, spans
        wrapped around the step's stages, and one short generate at the
        cell's lanes and ring."""
        from repro_torch.core.decode_engine import SiDADecodeEngine

        dev, tr = self.ctx.device, self.tr
        params = weights.model_params(self.spec, dev)
        hp = weights.predictor_params(self.spec, dev)
        self.eng = SiDADecodeEngine(build(self.spec), params, hp, slots_per_layer=tr["slots"],
                                    eviction=tr["eviction"], prefetch_depth=tr["prefetch_depth"],
                                    device=dev)
        del params, hp
        spans = self.ctx.spans
        spans.wrap(self.eng, "_predict_step", "predict")
        spans.wrap(self.eng, "_route_table", "route", after=self._on_route)
        spans.wrap(self.eng.store, "translate_device", "translate")
        spans.wrap(self.eng, "_step", "step")
        self.eng.generate(self._start(self.rng_warm), steps=tr["warmup_steps"],
                          cache_len=tr["cache_len"])

    def window(self, seconds: float, trace: bool) -> Dict:
        eng, tr, dev = self.eng, self.tr, self.ctx.device
        device.reset_peak(dev)
        eng.store.stats.reset()
        tracer = DeviceTrace(dev) if trace else None
        tokens = steps = 0
        need = self.ctx.cell.workload["check"]["calls"]
        self.record = True
        if tracer is not None:
            tracer.start()
        w0, t0 = time.time_ns(), time.perf_counter()
        while True:
            c0 = time.perf_counter()
            start = self._start(self.rng_tokens)
            self.steps = []
            out, dm = eng.generate(start, steps=tr["steps"], cache_len=tr["cache_len"])
            tokens += dm.tokens
            steps += dm.steps
            self.calls.append({"start": start, "out": out, "route": self.steps})
            print(f"perfbench: call {len(self.calls)}: {dm.steps} steps in "
                  f"{time.perf_counter() - c0:.3f} s", file=sys.stderr)
            if time.perf_counter() - t0 >= seconds and len(self.calls) >= need:
                break
        window_s = time.perf_counter() - t0
        w1 = time.time_ns()
        self.record = False
        peak = device.peak_bytes(dev)
        n = len(self.calls)
        m = self.m
        rec = {
            "attempted": n * tr["lanes"], "failed": 0, "window_s": window_s, "tokens": tokens,
            "steps": steps, "calls": n,
            "model_flops": n * tr["lanes"] * sum(flops.per_token(m, t + 1)
                                                 for t in range(tr["steps"])),
            "memory_peak_bytes": peak, "device": device.info(dev, peak),
        }
        if tracer is not None:
            rec["trace"] = collect(tracer, w0, w1, self.ctx.spans)
            rec["flash_decode"] = {
                "lanes": tr["lanes"], "heads": m["n_heads"], "kv_heads": m["n_kv_heads"],
                "head_dim": m["head_dim"] or m["d_model"] // m["n_heads"],
                "elem_bytes": 2 if m["dtype"] in ("bfloat16", "float16") else 4,
                "calls": [(t + 1, m["n_layers"] * n) for t in range(tr["steps"])],
            }
        return rec

    def release(self) -> None:
        self.eng.close()
        del self.eng

    @torch.no_grad()
    def check(self, ref, control: bool) -> Dict[str, float]:
        dev, m, tr = self.ctx.device, self.m, self.tr
        moe = m["moe"]
        n_moe = m["n_layers"] // moe["moe_every"]
        chk = self.ctx.cell.workload["check"]
        W = weights.model_params(self.spec, dev)
        hp = weights.predictor_params(self.spec, dev)
        rng = np.random.default_rng(self.rng_check.integers(1 << 62))
        picked = sorted(rng.choice(len(self.calls), min(chk["calls"], len(self.calls)),
                                   replace=False))
        out = {"slots_missing": 0.0, "slots_invalid": 0.0, "hash_gap": 0.0, "alpha_err": 0.0,
               "token_gap": 0.0}
        with ref.exact_fp32():
            for i in picked:
                c = self.calls[i]
                lanes = np.sort(rng.choice(tr["lanes"], chk["lanes"], replace=False))
                eff = []
                for ids, alpha, trans in c["route"]:
                    need = routing.needed_experts(ids, alpha, self.slots, self.E)
                    miss, bad = routing.residency_faults(trans, need, self.slots)
                    out["slots_missing"] += miss
                    out["slots_invalid"] += bad
                    eff.append(routing.effective_routing(ids, alpha, trans, self.slots,
                                                         moe["top_k"], moe["capacity_factor"]))
                # [steps, n_moe, lanes, k] -> the picked lanes' [n_moe, b, steps, k]
                ids = np.stack([r[0] for r in c["route"]])[:, :, lanes].transpose(1, 2, 0, 3)
                alpha = np.stack([r[1] for r in c["route"]])[:, :, lanes].transpose(1, 2, 0, 3)
                w = np.stack(eff)[:, :, lanes].transpose(1, 2, 0, 3)
                served = torch.as_tensor(c["out"][lanes], device=dev)
                inputs = torch.cat([torch.as_tensor(c["start"][lanes], device=dev)[:, None],
                                    served[:, :-1]], dim=1)
                emb = W["embed"][inputs.long()].float()
                want = ref.decode_predictor_logits(hp, emb, n_moe, self.E,
                                                   tr["history"]).movedim(2, 0)
                if control:
                    low = ref.decode_predictor_logits(hp, emb, n_moe, self.E, tr["history"],
                                                      prec="tf32").movedim(2, 0)
                    vals, top = ref.top_k(low, ids.shape[-1])
                    ids, alpha = top.cpu().numpy(), torch.softmax(vals, -1).cpu().numpy()
                gap, err = compare.routing_gap(want, ids, alpha)
                out["hash_gap"] = max(out["hash_gap"], gap)
                out["alpha_err"] = max(out["alpha_err"], err)
                experts = torch.as_tensor(np.stack([r[0] for r in c["route"]])[:, :, lanes]
                                          .transpose(1, 2, 0, 3)[..., : w.shape[-1]], device=dev)
                w = torch.as_tensor(w, device=dev)
                logits = ref.forward(W, m, inputs, experts, w)
                if control:
                    served = ref.forward(W, m, inputs, experts, w, prec="fp8").argmax(-1)
                out["token_gap"] = max(out["token_gap"], compare.token_gap(logits, served))
        return out
