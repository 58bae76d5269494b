"""Serving baselines (paper §4 Setup): Standard, OnDemand, PrefetchAll
(port of `repro/core/baselines.py`).

* Standard      — the stock implementation: every expert resident on the
                  device, routers run inline, dense dispatch over all E experts.
* OnDemand      — naive offloading (the paper's Challenge-1 strawman): experts
                  live on the host; routing is only known after each router
                  runs, so every MoE layer synchronously loads its activated
                  experts, stalling the forward.
* PrefetchAll   — data-unaware streaming under a memory budget (a proxy for
                  DeepSpeed / Tutel-style serving): each MoE layer loads all
                  its experts through the slot pool in ⌈E/S⌉ waves, computing
                  each wave's tokens after its load.

OnDemand and PrefetchAll share the port's `ExpertStore`, so their memory
budgets compare with SiDA's. The store writes its slot pools in place, so
the layer loop reads the slots through views and never re-fetches them (the
reference's `_fresh_moe_params`). Every entry point runs on CUDA unless
`device` names another device.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import ServeMetrics
from repro_torch.core.offload import ExpertStore, nbytes
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import rmsnorm
from repro_torch.models.moe import moe_layer, router_topk, shared_experts
from repro_torch.models.transformer import (
    _apply_sublayer_full,
    attention_half,
    embed_tokens,
    forward,
    period,
    sub_kind,
)
from repro_torch.tree import tree_leaves, tree_map


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class StandardServer:
    """Everything resident; router inline; all-expert dense dispatch."""

    def __init__(self, cfg: ModelConfig, params: dict, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = tree_map(lambda x: x.to(self.device), params)

    @torch.inference_mode()
    def _fwd(self, tokens: np.ndarray) -> torch.Tensor:
        return forward(self.params, self.cfg, torch.as_tensor(tokens, device=self.device))["logits"]

    def serve(self, batches: Sequence[np.ndarray]) -> ServeMetrics:
        m = ServeMetrics()
        t_start = time.perf_counter()
        for toks in batches:
            t0 = time.perf_counter()
            self._fwd(toks)
            _sync(self.device)
            m.latency_s.append(time.perf_counter() - t0)
            m.tokens += int(np.prod(toks.shape))
        m.wall_s = time.perf_counter() - t_start
        return m

    def device_memory_bytes(self) -> int:
        return sum(nbytes(x) for x in tree_leaves(self.params))


class _LayerwiseServer:
    """Shared Python layer loop of the offloading baselines.

    The loop runs in Python so the host sync between a router's output and
    its layer's expert loads is serialised, exactly like the naive
    implementation the paper describes."""

    def __init__(self, cfg: ModelConfig, params: dict, slots_per_layer: int,
                 device: DeviceLike = None):
        if not cfg.moe.enabled:
            raise ValueError("the offloading baselines serve MoE configs")
        self.cfg = cfg
        self.per = period(cfg)
        self.n_groups = cfg.n_layers // self.per
        self.store = ExpertStore(cfg, params, slots_per_layer, device=device)
        self.device = self.store.device
        # routers stay on the device for these baselines (they run inline)
        self.routers = {
            f"sub{s}": params["blocks"][f"sub{s}"]["moe"]["router"].to(self.device)
            for s in range(self.per) if sub_kind(cfg, s)["moe"]
        }
        sp = self.store.serve_params
        self.embed, self.final_norm, self.head = sp["embed"], sp["final_norm"], sp.get("head")

    def _group_params(self, g: int) -> dict:
        return tree_map(lambda x: x[g], self.store.serve_params["blocks"])

    def _moe_part(self, moe_p, x, h2, slot_ids, w, cfg=None):
        y, _ = moe_layer(moe_p, h2, cfg or self.cfg, routing_override=(slot_ids, w))
        # the reference's quirk, kept: post_norm is not applied here (only the
        # dense sublayers take it; Switch has none)
        return x + y

    def _final(self, x):
        # the reference's `_final`, kept as it is: no final softcap and no
        # masking of the padded vocab columns (`transformer.unembed` has both)
        x = rmsnorm(self.final_norm, x, self.cfg.norm_eps)
        return x @ (self.embed.T if self.cfg.tie_embeddings else self.head)

    @torch.inference_mode()
    def _forward_batch(self, tokens: np.ndarray) -> torch.Tensor:
        cfg = self.cfg
        x = embed_tokens({"embed": self.embed}, cfg, torch.as_tensor(tokens, device=self.device))
        l = 0
        for g in range(self.n_groups):
            gp = self._group_params(g)
            for s in range(self.per):
                sp = gp[f"sub{s}"]
                if not sub_kind(cfg, s)["moe"]:
                    x, _ = _apply_sublayer_full(sp, x, cfg, s, None, False)
                    continue
                x, h2 = attention_half(sp, x, cfg, s)
                # routers are stacked over groups: this group's router, in
                # fp32 over [T, d] as `moe_layer` computes its logits
                logits = h2.reshape(-1, cfg.d_model).float() @ self.routers[f"sub{s}"][g]
                ids, w = router_topk(logits, cfg.moe.top_k)
                ids_np = ids.cpu().numpy()   # HOST SYNC: the pipeline stall
                x = self._moe_with_loads(l, sp["moe"], x, h2, ids_np, ids, w)
                l += 1
        return self._final(x)

    def _moe_with_loads(self, l, moe_p, x, h2, ids_np, ids, w):
        raise NotImplementedError

    def serve(self, batches: Sequence[np.ndarray]) -> ServeMetrics:
        m = ServeMetrics()
        t_start = time.perf_counter()
        for toks in batches:
            t0 = time.perf_counter()
            self._forward_batch(toks)
            _sync(self.device)
            m.latency_s.append(time.perf_counter() - t0)
            m.tokens += int(np.prod(toks.shape))
        m.wall_s = time.perf_counter() - t_start
        return m

    def device_memory_bytes(self) -> int:
        # the reference's count, kept: the store's device params whole (slot
        # pools included), not the routers this loop also keeps on the device
        return sum(nbytes(x) for x in tree_leaves(self.store.serve_params))


class OnDemandServer(_LayerwiseServer):
    """Load experts only after the router reveals them (synchronous stall)."""

    def _moe_with_loads(self, l, moe_p, x, h2, ids_np, ids, w):
        uniq, counts = np.unique(ids_np, return_counts=True)
        needed = uniq[np.argsort(-counts)]
        trans_row = self.store.prepare_layer(l, needed)     # synchronous H2D
        B, S, _ = h2.shape
        slot_flat = torch.from_numpy(trans_row).to(self.device)[ids]   # [T, k]
        w = w * (slot_flat >= 0)
        slot_ids = torch.clamp(slot_flat, min=0).reshape(B, S, -1)
        return self._moe_part(moe_p, x, h2, slot_ids, w.reshape(B, S, -1))


class PrefetchAllServer(_LayerwiseServer):
    """Data-unaware: stream every expert of every layer through the slots."""

    def _moe_with_loads(self, l, moe_p, x, h2, ids_np, ids, w):
        E, n_slots = self.store.E, self.store.S
        B, S, _ = h2.shape
        # the shared experts once, after the waves: the reference runs the
        # whole `moe_layer` each wave, so it adds them E / slots times
        # (ROADMAP C14)
        routed = dataclasses.replace(self.cfg, moe=dataclasses.replace(
            self.cfg.moe, num_shared_experts=0))
        y_parts = None
        for wave_start in range(0, E, n_slots):
            wave = np.arange(wave_start, min(E, wave_start + n_slots))
            trans_row = self.store.prepare_layer(l, wave)
            slot_flat = torch.from_numpy(trans_row).to(self.device)[ids]
            in_wave = (ids >= wave_start) & (ids < wave_start + n_slots)
            w_wave = w * in_wave * (slot_flat >= 0)
            slot_ids = torch.clamp(slot_flat, min=0).reshape(B, S, -1)
            part = self._moe_part(moe_p, torch.zeros_like(x), h2, slot_ids,
                                  w_wave.reshape(B, S, -1), cfg=routed)
            y_parts = part if y_parts is None else y_parts + part
        if self.cfg.moe.num_shared_experts:
            y_parts = y_parts + shared_experts(moe_p, h2, self.cfg)
        return x + y_parts
