"""SiDA serving engine: hash-building thread ∥ inference thread (paper Fig. 5).

Port of `repro/core/engine.py` (Algorithm 1):

  Hash-building thread: for each incoming batch X_j, run the hash function,
  build hash table H_j (expert ids + α per token per MoE layer), enqueue.
  Inference thread: pop H_i, load the predicted experts into the device
  slots (evicting under the slot budget), forward X_i with the hash table as
  the routing override — routers never run.

Both threads launch on PyTorch's default stream, so the device runs their
work in enqueue order; the hash thread's copy of the table to the host waits
for what is queued before it. Tables hold numpy, as in the reference.

With an async prefetch pipeline (`prefetch_depth`, `core/offload.py`) the
hash thread also submits each table's uploads as it builds it, so batch
j+1's copies run on the transfer stream while batch j's forward runs, and
the inference thread only clears ready fences. A ticket is released once
its forward has finished on the device, since the slots are written in
place.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TierConfig
from repro_torch.core.hash_fn import (
    HASH_SEG_LEN,
    hash_fn_apply,
    hash_fn_apply_segmented,
    predict_topk,
)
from repro_torch.core.hash_table import HashTable, HashTableQueue
from repro_torch.core.offload import ExpertStore, PrefetchPipeline, PrefetchTicket, nbytes
from repro_torch.device import DeviceLike
from repro_torch.models.transformer import forward
from repro_torch.tree import tree_leaves, tree_map


@dataclass
class ServeMetrics:
    latency_s: List[float] = field(default_factory=list)
    hash_time_s: float = 0.0
    tokens: int = 0
    wall_s: float = 0.0

    @property
    def throughput(self) -> float:
        return self.tokens / self.wall_s if self.wall_s else 0.0

    @property
    def mean_latency(self) -> float:
        return float(np.mean(self.latency_s)) if self.latency_s else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "throughput_tok_s": self.throughput,
            "mean_latency_s": self.mean_latency,
            "hash_time_s": self.hash_time_s,
            "wall_s": self.wall_s,
        }


class SiDAEngine:
    """Serve full-sequence batches with data-aware expert offloading.

    Runs on CUDA unless `device` names another device; without a GPU the
    default raises instead of falling back to the CPU."""

    def __init__(
        self,
        cfg: ModelConfig,
        params: dict,
        hash_params: dict,
        slots_per_layer: int,
        serve_top_k: Optional[int] = None,
        eviction: str = "fifo",
        device: DeviceLike = None,
        host_quant: str = "none",                   # "none" | "int8" host masters
        quantized_slots: Optional[bool] = None,     # int8-resident slots
        scale_granularity: Optional[str] = None,    # "channel" | "tensor"
        tier: Optional[TierConfig] = None,          # hot int8 / warm int4 slots
        prefetch_depth: Optional[int] = None,       # async prefetch lookahead (0 = sync)
        staging_buffers: Optional[int] = None,      # host staging slabs of the pipeline
        prefetcher: Optional[PrefetchPipeline] = None,
        store: Optional[ExpertStore] = None,        # share a caller's store as it is
    ):
        self.cfg = cfg
        self.k = serve_top_k or cfg.moe.top_k
        # the request server shares one store between this engine's prefill
        # and its own decode ticks
        self.store = store if store is not None else ExpertStore(
            cfg, params, slots_per_layer, eviction=eviction, device=device,
            host_quant=host_quant, quantized_slots=quantized_slots,
            scale_granularity=scale_granularity, tier=tier,
        )
        self.device = self.store.device
        # async prefetch: explicit args > cfg.prefetch > off; a caller's
        # pipeline is shared as it is
        self._owns_prefetcher = False
        if prefetcher is not None:
            self.prefetcher: Optional[PrefetchPipeline] = prefetcher
        else:
            self.prefetcher = PrefetchPipeline.maybe_create(
                self.store, cfg, prefetch_depth, staging_buffers)
            self._owns_prefetcher = self.prefetcher is not None
        self.hash_params = tree_map(lambda x: x.to(self.device), hash_params)
        self.embed_table = self.store.serve_params["embed"]
        self.E = cfg.moe.num_experts
        # each served batch's logits on the host, in the model dtype (the
        # reference keeps numpy arrays; numpy has no bf16)
        self.results: List[Optional[torch.Tensor]] = []

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def build_table(self, batch_index: int, tokens: np.ndarray) -> HashTable:
        emb = self.embed_table[torch.as_tensor(tokens, device=self.device).long()]
        if tokens.shape[1] > HASH_SEG_LEN:
            # long prompts: exact LSTM threading, per-segment SparseMax
            logits = hash_fn_apply_segmented(self.hash_params, emb, self.E)
        else:
            logits = hash_fn_apply(self.hash_params, emb, num_experts=self.E)
        ids, w = predict_topk(logits, self.k)
        return HashTable(batch_index, ids.cpu().numpy(), w.cpu().numpy())

    def _route(self, table: HashTable, ticket: Optional[PrefetchTicket] = None):
        """(slot_ids, weights, ticket) for `table`, the first two on the
        device: through the pipeline (clear the ticket's fences, never
        upload inline) when one is attached, else a synchronous prepare.
        The caller releases a non-None ticket once the forward is done."""
        if ticket is None and self.prefetcher is not None:
            ticket = self.prefetcher.submit(table)
        if ticket is not None:
            ticket.wait()
            trans = ticket.trans
        else:
            trans = self.store.prepare(table)
        slot_ids, w = self.store.translate(table, trans)
        return (torch.from_numpy(slot_ids).to(self.device),
                torch.from_numpy(w).to(self.device), ticket)

    @torch.inference_mode()
    def _forward(self, tokens: np.ndarray, table: HashTable, collect_kv: bool,
                 ticket: Optional[PrefetchTicket] = None):
        slot_ids, w, ticket = self._route(table, ticket)
        out = forward(
            self.store.serve_params, self.cfg,
            torch.as_tensor(tokens, device=self.device),
            routing_override=(slot_ids, w), collect_kv=collect_kv,
        )
        if ticket is not None:
            # the slots stay eviction-protected until the forward has read them
            self._sync()
            ticket.release()
        return out

    def infer(self, tokens: np.ndarray, table: HashTable,
              ticket: Optional[PrefetchTicket] = None) -> torch.Tensor:
        """Logits [B, S, V] on the device."""
        return self._forward(tokens, table, collect_kv=False, ticket=ticket)["logits"]

    def prefill(self, tokens: np.ndarray, table: HashTable,
                ticket: Optional[PrefetchTicket] = None):
        """Like `infer`, but also returns every layer's rope-applied K/V
        ({sub: (k, v)} each [G, B, S, K, D]) to seed decode caches."""
        out = self._forward(tokens, table, collect_kv=True, ticket=ticket)
        return out["logits"], out["kv"]

    # ------------------------------------------------------------------
    def _cache_affinity(self, table: HashTable) -> float:
        """Fraction of the table's active experts already resident or with
        an upload in flight."""
        if self.prefetcher is not None:
            return self.prefetcher.cache_affinity(table)
        return self.store.cache_affinity(table)

    def _sync(self) -> None:
        """Wait for the work queued on this thread's stream, not the
        transfer stream's copies of later batches."""
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def serve(
        self, batches: Sequence[np.ndarray], threaded: bool = True,
        lookahead: int = 1,
    ) -> ServeMetrics:
        """Run the two-thread pipeline over `batches` of token ids [B, S].

        lookahead > 1 enables cache-aware scheduling: the inference thread
        buffers up to `lookahead` hash tables and serves the one whose
        predicted expert set overlaps the resident cache the most.

        With a prefetch pipeline the hash thread is also its producer: it
        submits each table's uploads the moment the table is built."""
        metrics = ServeMetrics()
        q = HashTableQueue(maxsize=max(4, lookahead))
        results: List[Optional[torch.Tensor]] = [None] * len(batches)
        errors: List[Exception] = []
        # ticket handoff hash -> inference thread; the queue's put / get pair
        # orders the dict write before the read
        tickets: Dict[int, PrefetchTicket] = {}

        def hash_thread():
            try:
                for j, toks in enumerate(batches):
                    t0 = time.perf_counter()
                    table = self.build_table(j, toks)
                    if self.prefetcher is not None:
                        tickets[j] = self.prefetcher.submit(table)
                    q.put(table)
                    metrics.hash_time_s += time.perf_counter() - t0
            except Exception as e:    # re-raised by serve() after the join
                errors.append(e)
            finally:
                q.close()

        def _run_one(table: HashTable):
            i = table.batch_index
            t0 = time.perf_counter()
            logits = self.infer(batches[i], table, ticket=tickets.pop(i, None))
            self._sync()
            metrics.latency_s.append(time.perf_counter() - t0)
            results[i] = logits.cpu()
            metrics.tokens += int(np.prod(batches[i].shape))

        def inference_thread():
            try:
                pool: List[HashTable] = []
                closed = False
                while True:
                    while not closed and len(pool) < lookahead:
                        table = q.get()
                        if table is None:
                            closed = True
                            break
                        pool.append(table)
                        if lookahead == 1:
                            break
                    if not pool:
                        if closed:
                            break
                        continue
                    best = max(pool, key=self._cache_affinity) if len(pool) > 1 else pool[0]
                    pool.remove(best)
                    _run_one(best)
            except Exception as e:
                errors.append(e)
                while not closed and q.get() is not None:   # unblock the producer
                    pass

        t_start = time.perf_counter()
        if threaded:
            ht = threading.Thread(target=hash_thread)
            it = threading.Thread(target=inference_thread)
            ht.start(); it.start()
            ht.join(); it.join()
            if errors:
                raise errors[0]
        else:  # sequential ablation: hash + prepare + forward serialised
            for j, toks in enumerate(batches):
                t0 = time.perf_counter()
                table = self.build_table(j, toks)
                logits = self.infer(toks, table)
                self._sync()
                metrics.latency_s.append(time.perf_counter() - t0)
                results[j] = logits.cpu()
                metrics.tokens += int(np.prod(toks.shape))
        metrics.wall_s = time.perf_counter() - t_start
        self.results = results
        return metrics

    # ------------------------------------------------------------------
    def close(self) -> None:
        """Join the prefetch transfer thread (nothing to do when synchronous,
        or when the pipeline belongs to the caller)."""
        if self.prefetcher is not None and self._owns_prefetcher:
            self.prefetcher.close()

    def device_memory_bytes(self) -> int:
        """Device-resident bytes: non-expert params + slot buffers."""
        return sum(nbytes(x) for x in tree_leaves(self.store.serve_params))

    def memory_saving(self) -> Dict[str, float]:
        """The paper's Fig. 8 metric: expert bytes saved vs full residency."""
        full = self.store.full_expert_bytes()
        resident = self.store.device_bytes()
        return {
            "full_expert_gb": full / 1e9,
            "resident_expert_gb": resident / 1e9,
            "reduction": 1.0 - resident / full if full else 0.0,
        }
