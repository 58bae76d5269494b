"""SiDA serving engine: hash-building thread ∥ inference thread (paper Fig. 5).

Port of `repro/core/engine.py` (Algorithm 1):

  Hash-building thread: for each incoming batch X_j, run the hash function,
  build hash table H_j (expert ids + α per token per MoE layer), enqueue.
  Inference thread: pop H_i, load the predicted experts into the device
  slots (evicting under the slot budget), forward X_i with the hash table as
  the routing override — routers never run.

Tables hold numpy, as in the reference. On CUDA the predictor runs on a
stream of the engine's own (`build_table`): the token ids' copy in, the
build, and the table's copy to the host, which so waits for the predictor
alone and not for the forwards the inference thread queues on its stream.
A build of S <= `HASH_SEG_LEN` positions is captured as one CUDA graph
after `GRAPH_WARM_STEPS` eager builds in a row at one (B, S) and replayed
from then on (`HashGraph`), keyed on (B, S) and the addresses of the
predictor's weights and the embedding table: a build at another key runs
eagerly and drops the kept graph. The replay launches the kernels the eager
build does, in its order, so the tables are the eager ones bit for bit.
Longer prompts' segmented builds, and everything on the CPU, run eagerly
(`hash_graph_engages`). A batch's logits reach the host on a copy stream of
the engine's own too, by DMA into page-locked host memory that PyTorch's
caching host allocator hands back for reuse (`_results_copy`).

With an async prefetch pipeline (`prefetch_depth`, `core/offload.py`) the
hash thread also submits each table's uploads as it builds it, so batch
j+1's copies run on the transfer stream while batch j's forward runs, and
the inference thread only clears ready fences. A ticket is released once
its forward has finished on the device, since the slots are written in
place.

With `sharded` (a `ShardedStoreConfig` with `ep_shards` > 1) the store's
slot pools are expert-parallel and every forward runs under the store's
expert-parallel context (`sharding/policy.py::store_ctx`): one expert-FFN
launch a shard a MoE layer.

Given a `serving.telemetry.Telemetry` (`telemetry=`, passed on to the
store and pipeline the engine builds), `serve` records spans of each
thread's host work, each with its batch as `ident`: on the hash thread
`hash.batch` (`ServeMetrics.hash_time_s`'s interval) holding
`hash.launch` (the predictor's launches, or the token ids' copy and the
graph's replay), `hash.d2h` (the table's copy to the host), `hash.submit`
and `hash.queue_put`, and counts `hash_graph_captures`,
`hash_graph_replays` and `hash_graph_eager_builds`; on the inference thread
`infer.queue_get`, `infer.route`, `infer.translate`, `infer.forward`
(launches), `infer.drain` (waits for the device) and `infer.results_copy`
(the copy with the wait on its event; counters `results_copy_bytes` and, on
CUDA, `results_pinned_new` / `results_pinned_reused`: copies into a host
block the engine had not written before, and the rest). No span adds a
synchronize. The forward gets the telemetry too: a jamba model's Mamba
mixers record `model.mamba` / `model.mamba_scan` and queue the reads of
their CUDA events, which `_sync` runs after its drain (counters
`mamba_device_s`, `mamba_scan_device_s`, `mamba_calls`).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, TierConfig
from repro_torch.core.decode_engine import GRAPH_WARM_STEPS
from repro_torch.core.hash_fn import (
    HASH_SEG_LEN,
    hash_fn_apply,
    hash_fn_apply_segmented,
    predict_topk,
)
from repro_torch.core.hash_table import HashTable, HashTableQueue
from repro_torch.core.offload import (
    ExpertStore,
    PrefetchPipeline,
    PrefetchTicket,
    ShardedStoreConfig,
    nbytes,
    span,
)
from repro_torch.device import DeviceLike
from repro_torch.kernels import ops
from repro_torch.models.attention import ShardingCtx
from repro_torch.models.transformer import forward
from repro_torch.sharding.policy import store_ctx
from repro_torch.tree import tree_leaves, tree_map

if TYPE_CHECKING:   # serving/ imports this module: no import at run time
    from repro_torch.serving.telemetry import Telemetry


@dataclass
class ServeMetrics:
    latency_s: List[float] = field(default_factory=list)
    # the hash thread's time a batch, summed: building the table (the
    # predictor's launches or its graph's replay, and the table's copy to
    # the host, which waits for the predictor's stream alone), the prefetch
    # submit with its wait for queue room, and the wait for room in the
    # table queue: a hash thread held back by the inference thread reads
    # here like a slow predictor (the `hash.*` spans split it)
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


def hash_graph_engages(device: torch.device, seq_len: int) -> bool:
    """Whether a table build of `seq_len` positions may replay a captured
    CUDA graph: on a CUDA device, at the one-shot build's lengths. The
    segmented long-prompt build, and everything on the CPU, runs eagerly."""
    return torch.device(device).type == "cuda" and seq_len <= HASH_SEG_LEN


class HashGraph:
    """A table build captured as one CUDA graph for one key ((B, S) and the
    addresses of the weights it reads): the static token ids [B, S] each
    replay copies into, the ids / α [L, B, S, k] it writes, and the kernel
    launches one replay makes (`ops.held_launches` of the capture, added
    back each replay)."""

    def __init__(self, graph, key: tuple, tokens: torch.Tensor, ids: torch.Tensor,
                 alpha: torch.Tensor, launches: Tuple[dict, dict]):
        self.graph, self.key = graph, key
        self.tokens, self.ids, self.alpha = tokens, ids, alpha
        self.launches = launches

    def replay(self, tokens: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        self.tokens.copy_(torch.as_tensor(tokens))
        self.graph.replay()
        ops.add_launches(*self.launches)
        return self.ids, self.alpha


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
        sharded: Optional[ShardedStoreConfig] = None,   # expert-parallel slot pools
        ctx: Optional[ShardingCtx] = None,          # None: the store's own (`store_ctx`)
        telemetry: Optional["Telemetry"] = None,    # spans and counters; None: none
    ):
        self.cfg = cfg
        self.telemetry = telemetry
        self.k = serve_top_k or cfg.moe.top_k
        # the request server shares one store between this engine's prefill
        # and its own decode ticks
        self.store = store if store is not None else ExpertStore(
            cfg, params, slots_per_layer, eviction=eviction, device=device,
            host_quant=host_quant, quantized_slots=quantized_slots,
            scale_granularity=scale_granularity, tier=tier, sharded=sharded,
            mesh=ctx.mesh if ctx is not None else None, telemetry=telemetry,
        )
        self.ctx = store_ctx(self.store, ctx)
        self.device = self.store.device
        # async prefetch: explicit args > cfg.prefetch > off; a caller's
        # pipeline is shared as it is
        self._owns_prefetcher = False
        if prefetcher is not None:
            self.prefetcher: Optional[PrefetchPipeline] = prefetcher
        else:
            self.prefetcher = PrefetchPipeline.maybe_create(
                self.store, cfg, prefetch_depth, staging_buffers, telemetry=telemetry)
            self._owns_prefetcher = self.prefetcher is not None
        self.hash_params = tree_map(lambda x: x.to(self.device), hash_params)
        self.embed_table = self.store.serve_params["embed"]
        self.E = cfg.moe.num_experts
        # each served batch's logits on the host, in the model dtype (the
        # reference keeps numpy arrays; numpy has no bf16)
        self.results: List[Optional[torch.Tensor]] = []
        # the results copy's stream (None off CUDA) and the pinned host
        # blocks it has written, by address
        self._copy_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._pinned_seen: set = set()
        # the predictor's stream (None off CUDA), the kept graph, and the key
        # and count of the last eager builds in a row; one build at a time
        self._hash_stream = (torch.cuda.Stream(self.device)
                             if self.device.type == "cuda" else None)
        self._hash_graph: Optional[HashGraph] = None
        self._hash_run: Tuple[Optional[tuple], int] = (None, 0)
        self._hash_lock = threading.Lock()

    # ------------------------------------------------------------------
    @torch.inference_mode()
    def build_table(self, batch_index: int, tokens: np.ndarray) -> HashTable:
        """The hash table of `tokens` [B, S]: expert ids and α per MoE layer,
        token and choice, on the host.

        On CUDA every step runs on the engine's predictor stream: an eager
        build first waits for the work queued on the caller's stream (where
        the weights were written), a replay waits for nothing, and the
        table's copy to the host waits for the predictor alone. A build
        replays the kept graph while its key holds; otherwise it runs
        eagerly (counter `hash_graph_eager_builds`), and the build after
        `GRAPH_WARM_STEPS` eager ones in a row at one key captures the
        graph (`hash_graph_captures`) and replays it (`hash_graph_replays`),
        where `hash_graph_engages`. A build at another key drops the kept
        graph. Builds of one engine run one at a time."""
        tel, stream = self.telemetry, self._hash_stream
        caller = torch.cuda.current_stream(self.device) if stream is not None else None
        with self._hash_lock, torch.cuda.stream(stream):   # None: no stream to enter
            with span(tel, "hash.launch", batch_index):
                ids, w = self._predict(tokens, caller)
            with span(tel, "hash.d2h", batch_index):
                ids, w = ids.cpu().numpy(), w.cpu().numpy()
        return HashTable(batch_index, ids, w)

    def _predict(self, tokens: np.ndarray, caller) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ids, α) of `tokens` on the device, replayed or built eagerly."""
        tel = self.telemetry
        key = None
        if hash_graph_engages(self.device, tokens.shape[1]):
            key = (tuple(tokens.shape), self.embed_table.data_ptr(),
                   *(t.data_ptr() for t in tree_leaves(self.hash_params)))
        graph = self._hash_graph
        if graph is not None and graph.key != key:
            self._hash_graph = graph = None
        run_key, run = self._hash_run
        if graph is None and key is not None and run_key == key and run >= GRAPH_WARM_STEPS:
            graph = self._hash_graph = self._capture_build(key, tokens)
            if tel is not None:
                tel.counter("hash_graph_captures").inc()
        if graph is not None:
            if tel is not None:
                tel.counter("hash_graph_replays").inc()
            return graph.replay(tokens)
        self._hash_run = (key, run + 1 if run_key == key else 1)
        if tel is not None:
            tel.counter("hash_graph_eager_builds").inc()
        if caller is not None:
            self._hash_stream.wait_stream(caller)
        return self._predict_body(torch.as_tensor(tokens, device=self.device))

    def _predict_body(self, tokens: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The build over token ids on the device, eager or under capture."""
        emb = self.embed_table[tokens.long()]
        if tokens.shape[1] > HASH_SEG_LEN:
            # long prompts: exact LSTM threading, per-segment SparseMax
            logits = hash_fn_apply_segmented(self.hash_params, emb, self.E)
        else:
            logits = hash_fn_apply(self.hash_params, emb, num_experts=self.E)
        return predict_topk(logits, self.k)

    def _capture_build(self, key: tuple, tokens: np.ndarray) -> HashGraph:
        """Capture the build at `tokens`' shape on the predictor stream,
        whose cuBLAS workspace the eager builds before it opened, while the
        other threads go on launching on theirs; the capture runs nothing,
        and its launches count once a replay runs them."""
        static = torch.as_tensor(tokens, device=self.device)
        graph = torch.cuda.CUDAGraph()
        with ops.held_launches() as launches, torch.cuda.graph(
                graph, stream=self._hash_stream, capture_error_mode="thread_local"):
            ids, alpha = self._predict_body(static)
        return HashGraph(graph, key, static, ids, alpha, launches)

    def _route(self, table: HashTable, ticket: Optional[PrefetchTicket] = None):
        """(slot_ids, weights, ticket) for `table`, the first two on the
        device: through the pipeline (clear the ticket's fences, never
        upload inline) when one is attached, else a synchronous prepare.
        The caller releases a non-None ticket once the forward is done."""
        tel = self.telemetry
        with span(tel, "infer.route", table.batch_index):
            if ticket is None and self.prefetcher is not None:
                ticket = self.prefetcher.submit(table)
            if ticket is not None:
                ticket.wait()
                trans = ticket.trans
            else:
                trans = self.store.prepare(table)
        with span(tel, "infer.translate", table.batch_index):
            slot_ids, w = self.store.translate(table, trans)
            slot_ids, w = (torch.from_numpy(slot_ids).to(self.device),
                           torch.from_numpy(w).to(self.device))
        return slot_ids, w, ticket

    @torch.inference_mode()
    def _forward(self, tokens: np.ndarray, table: HashTable, collect_kv: bool,
                 ticket: Optional[PrefetchTicket] = None):
        slot_ids, w, ticket = self._route(table, ticket)
        with span(self.telemetry, "infer.forward", table.batch_index):
            out = forward(
                self.store.serve_params, self.cfg,
                torch.as_tensor(tokens, device=self.device),
                routing_override=(slot_ids, w), collect_kv=collect_kv, ctx=self.ctx,
                telemetry=self.telemetry,
            )
        if ticket is not None:
            # the slots stay eviction-protected until the forward has read them
            self._sync(table.batch_index)
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

    def _sync(self, batch_index: Optional[int] = None) -> None:
        """Wait for the work queued on this thread's stream, not the
        transfer stream's copies of later batches; then read what the
        forward's device spans queued."""
        tel = self.telemetry
        with span(tel, "infer.drain", batch_index):
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
        if tel is not None:
            tel.run_deferred()

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

        tel = self.telemetry

        def hash_thread():
            try:
                for j, toks in enumerate(batches):
                    with span(tel, "hash.batch", j):
                        t0 = time.perf_counter()
                        table = self.build_table(j, toks)
                        if self.prefetcher is not None:
                            with span(tel, "hash.submit"):
                                tickets[j] = self.prefetcher.submit(table)
                        with span(tel, "hash.queue_put"):
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
            self._sync(i)
            metrics.latency_s.append(time.perf_counter() - t0)
            results[i] = self._results_copy(logits, i)
            metrics.tokens += int(np.prod(batches[i].shape))

        def inference_thread():
            try:
                pool: List[HashTable] = []
                closed = False
                while True:
                    while not closed and len(pool) < lookahead:
                        with span(tel, "infer.queue_get"):
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
                self._sync(j)
                metrics.latency_s.append(time.perf_counter() - t0)
                results[j] = self._results_copy(logits, j)
                metrics.tokens += int(np.prod(toks.shape))
        metrics.wall_s = time.perf_counter() - t_start
        self.results = results
        return metrics

    def _results_copy(self, logits: torch.Tensor, batch_index: int) -> torch.Tensor:
        """A batch's logits on the host, in the model dtype.

        On CUDA: a DMA on the engine's copy stream, after the work queued
        so far on this thread's stream, into page-locked memory of PyTorch's
        caching host allocator, which hands a block back only once every
        tensor on it is gone, so a result the caller keeps is never
        overwritten. The thread then waits on this copy's event alone. The
        caller drops `logits` on return, before the next forward, so no
        second batch's logits is alive on the device while a copy runs."""
        tel, stream = self.telemetry, self._copy_stream
        with span(tel, "infer.results_copy", batch_index):
            if stream is None:
                out = logits.cpu()
            else:
                out = torch.empty(logits.shape, dtype=logits.dtype, pin_memory=True)
                stream.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(stream):
                    out.copy_(logits, non_blocking=True)
                logits.record_stream(stream)
                stream.record_event().synchronize()
        if tel is not None:
            tel.counter("results_copy_bytes").inc(nbytes(out))
        if stream is not None:
            ptr = out.data_ptr()
            if tel is not None:
                seen = ptr in self._pinned_seen
                tel.counter("results_pinned_reused" if seen else "results_pinned_new").inc()
            self._pinned_seen.add(ptr)
        return out

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
