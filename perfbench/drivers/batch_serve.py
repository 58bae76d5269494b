"""Batch serving: `SiDAEngine.serve`, SiDA's Algorithm 1 (a hash-ahead thread
beside the inference thread), in a closed loop of calls of a fixed number of
token batches, back to back.

Traffic file keys: `batch`, `seq`, `tokens` (a `generate.token_ids`
distribution), `batches_per_call`, `warmup_batches`, and the deployment's
`slots` a MoE layer, `eviction`, `prefetch_depth`, `staging_buffers`,
`lookahead`. Each call draws its batches from the seed; the inference
thread keeps every batch's logits on the host, so the driver keeps a sample
of each call's and drops the rest before the next call. The drain at the
end of each call is inside the window, as a user's job of that size pays
it.

The check, on a sample of the window's calls drawn from the seed (a batch a
call, `rows` sequences of it), stage by stage:
- `slots_missing`, `slots_invalid`: the experts the table needs under the
  slot budget (worked out again from the program's table) all hold a slot
  in the translation the forward used, and no slot is named twice;
- `hash_gap`, `alpha_err`: the program's predicted experts and α against
  the reference predictor's logits on the same tokens;
- `logit_err`: the served logits against the reference forward, routed by
  the program's table through the reference's own translation and capacity
  drops (so a predictor's near-tie does not move the forward's check).
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
        self.call, self.pick, self.keep_all = -1, -1, False
        self.reseed(ctx.seed)

    def reseed(self, seed: int) -> None:
        """Draw the next window's inputs and sample from `seed`."""
        self.rng_warm, self.rng_tokens, self.rng_pick, self.rng_check = generate.streams(seed, 4)
        self.samples: List[Dict] = []
        self.routes: List[tuple] = []

    def _batches(self, rng, n: int) -> List[np.ndarray]:
        shape = (self.tr["batch"], self.tr["seq"])
        return [generate.token_ids(rng, shape, self.m["vocab_size"], self.tr["tokens"])
                for _ in range(n)]

    def _on_translate(self, _out, table, trans) -> None:
        if self.call < 0:
            return
        if self.keep_all:
            self.routes.append((table.expert_ids, table.weights, np.array(trans)))
        if table.batch_index == self.pick:
            self.samples.append({"ids": table.expert_ids, "alpha": table.weights,
                                 "trans": np.array(trans)})

    def setup(self) -> None:
        """Weights drawn on the device, the engine built from them (its expert
        stacks go to host memory), spans wrapped around its layer calls, and
        one call of `warmup_batches` batches at the cell's shapes."""
        from repro_torch.core.engine import SiDAEngine

        dev, tr = self.ctx.device, self.tr
        params = weights.model_params(self.spec, dev)
        hp = weights.predictor_params(self.spec, dev)
        self.eng = SiDAEngine(build(self.spec), params, hp, slots_per_layer=tr["slots"],
                              eviction=tr["eviction"], device=dev,
                              prefetch_depth=tr["prefetch_depth"],
                              staging_buffers=tr["staging_buffers"])
        del params, hp
        spans = self.ctx.spans
        spans.wrap(self.eng, "build_table", "hash")
        spans.wrap(self.eng, "infer", "infer")
        spans.wrap(self.eng, "_route", "route")
        spans.wrap(self.eng.store, "translate", "translate", after=self._on_translate)
        if self.eng.prefetcher is not None:
            spans.wrap(self.eng.prefetcher, "submit", "submit")
        self.eng.serve(self._batches(self.rng_warm, tr["warmup_batches"]), threaded=True,
                       lookahead=tr["lookahead"])
        self.eng.results = []

    def window(self, seconds: float, trace: bool) -> Dict:
        eng, tr, dev = self.eng, self.tr, self.ctx.device
        check = self.ctx.cell.workload["check"]
        device.reset_peak(dev)
        eng.store.stats.reset()
        if eng.prefetcher is not None:
            eng.prefetcher.stats.reset()
        tracer = DeviceTrace(dev) if trace else None
        self.keep_all = trace
        latency: List[float] = []
        hash_s, tokens, calls = 0.0, 0, 0
        if tracer is not None:
            tracer.start()
        w0, t0 = time.time_ns(), time.perf_counter()
        while True:
            c0 = time.perf_counter()
            batches = self._batches(self.rng_tokens, tr["batches_per_call"])
            self.call, self.pick = calls, int(self.rng_pick.integers(len(batches)))
            picked_rows = np.sort(self.rng_pick.choice(tr["batch"], check["rows"], replace=False))
            m = eng.serve(batches, threaded=True, lookahead=tr["lookahead"])
            latency += m.latency_s
            hash_s += m.hash_time_s
            tokens += m.tokens
            s = self.samples[-1]
            s.update(tokens=batches[self.pick], rows=picked_rows,
                     logits=eng.results[self.pick][torch.as_tensor(picked_rows)])
            eng.results = []
            calls += 1
            print(f"perfbench: call {calls}: {len(batches)} batches in "
                  f"{time.perf_counter() - c0:.3f} s, batch latency median "
                  f"{1e3 * float(np.median(m.latency_s)):.1f} ms", file=sys.stderr)
            if time.perf_counter() - t0 >= seconds and calls >= check["calls"]:
                break
        window_s = time.perf_counter() - t0
        w1 = time.time_ns()
        peak = device.peak_bytes(dev)
        st, pf = eng.store.stats, eng.prefetcher
        n = len(latency)
        rec = {
            "attempted": n, "failed": 0, "window_s": window_s, "tokens": tokens, "batches": n,
            "calls": calls, "batch_latency_s": latency, "hash_time_s": hash_s,
            "store": {"hits": st.hits, "loads": st.loads, "bytes_h2d": st.bytes_h2d,
                      "prepare_time_s": st.prepare_time},
            "prefetch_stall_s": pf.stats.stall_s if pf is not None else 0.0,
            "model_flops": n * tr["batch"] * flops.sequence(self.m, tr["seq"]),
            "memory_peak_bytes": peak, "device": device.info(dev, peak),
        }
        if tracer is not None:
            rec["trace"] = collect(tracer, w0, w1, self.ctx.spans)
            rec["expert_ffn"] = self._expert_ffn_calls()
        return rec

    def _expert_ffn_calls(self) -> Dict:
        """Every expert FFN call of the window (a MoE layer of a batch): the
        (token, expert) pairs that carry weight and the experts they reach."""
        moe = self.m["moe"]
        calls = []
        for ids, alpha, trans in self.routes:
            w = routing.effective_routing(ids, alpha, trans, self.slots, moe["top_k"],
                                          moe["capacity_factor"])
            u = routing.useful_pairs(w, ids[..., : w.shape[-1]])
            calls += list(zip(u["pairs"].tolist(), u["experts"].tolist()))
        return {"d": self.m["d_model"], "F": moe["d_expert"], "glu": self.m["glu"],
                "calls": calls}

    def release(self) -> None:
        self.eng.close()
        del self.eng
        self.routes = []

    @torch.no_grad()
    def check(self, ref, control: bool) -> Dict[str, float]:
        dev, m = self.ctx.device, self.m
        moe = m["moe"]
        n_moe = m["n_layers"] // moe["moe_every"]
        W = weights.model_params(self.spec, dev)
        hp = weights.predictor_params(self.spec, dev)
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
                want = ref.predictor_logits(hp, emb, n_moe, self.E).movedim(2, 0)
                ids, alpha = s["ids"][:, rows], s["alpha"][:, rows]
                if control:
                    low = ref.predictor_logits(hp, emb, n_moe, self.E, prec="tf32").movedim(2, 0)
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
