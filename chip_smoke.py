#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py          # needs one CUDA GPU; exits non-zero on any failure

1. Device: the card's name and power limit, then the build of every kernel
   in `src/repro_torch/csrc` (nvcc, one process per source) and its time.
2. Kernels vs plain: each hand-written kernel at the shapes the served
   switch-base-8 batch and decode runs give it (expert_ffn_q at the decode
   steps of 5a-5c and at the int8 batch serve's [4, 640], expert_ffn_q4 at
   5c's warm block and [4, 640]), in bf16 and fp32, against
   its plain PyTorch version — max abs error and tolerance, kernel / plain /
   library ms (CUDA events around 20 back-to-back calls, warm L2: host launch
   work included), the least time the H100 could take (989 TFLOP/s bf16 or
   67 TFLOP/s fp32, 3.35 TB/s), the rate reached and its share of that
   bound; then the kernel's and the library's device time alone (the same
   20 calls captured in one CUDA graph and replayed), with its rate and share.
   The decode attention kernels also print their split plan (decode_plan),
   run the split's edge cases (keys not a whole number of tiles a rank,
   valid keys only in the last rank, fewer live pages than ranks), check
   that a rerun is bit-identical, and flash_decode_paged is set beside SDPA
   and flash_decode on the same keys gathered into a ring (gather untimed).
   sparsemax runs at both shapes it serves (the batch predictor's
   [8, 256, 256], also with slowly converging rows, and the decode ring's
   [8, 128] with masked entries), each rerun bit-identical. Phase 7's shapes
   too: expert_ffn at Standard's [8, 320] and the tiered batch serve's hot
   (expert_ffn_q) and warm (expert_ffn_q4) blocks. Phase 10's shapes too:
   the GLU (SwiGLU) expert FFN at deepseek-moe-16b's [16, ., 2048 -> 1408]
   and qwen3-moe's [32, ., 4096 -> 1536] batch and decode blocks and their
   tiered decode's int8 hot and int4 warm blocks; flash_prefill,
   flash_decode and flash_decode_paged at every form phase 10 launches them
   in: qwen3's GQA group 16 and deepseek's 16 / 16 heads at D 128 ([8, 256],
   8 lanes over 512 keys), chameleon-34b, qwen2-1.5b, smollm-135m and
   stablelm-12b (head_dim 160) at [2, 512] and a 528-slot ring, gemma2-9b's
   local (window 4096) and global layers at [1, 5120] (head_dim 256,
   softcap 50); the library SDPA with enable_gqa, or for a softcapped row a
   compiled flex_attention (tanh score_mod, block mask), its own error
   against the plain version printed; a group above 16 and a head_dim
   outside the set refused. The training shapes too (phase 11's fp32
   forward over [8, 128] tokens): expert_ffn at [8, 160, 768 -> 3072] and
   flash_prefill at 12 / 12 heads of 64 (fp32 1e-4), sparsemax at TKD's
   [8, 128, 128]; each Function's backward (`kernels/autograd.py`) against
   autograd over the plain version on the same inputs (fp32 within 1e-4 *
   max(1, max|g|), expert_ffn also in bf16 within 5e-2 * max(1, max|g|)),
   timed beside autograd over the plain version and over the library call
   (bmm+gelu+bmm, SDPA), with its bound. sparsemax past 1024 rows (the
   block-a-row kernel) at 11b's long step's [4, 1280, 1280], at TKD's
   [8, 2048, 2048] and at [1, 2048, 8192] (fp32, 1e-5), and in bf16 at [8, 2048, 2048] (bit-equal to the fp32 kernel cast
   to bf16, within one bf16 ulp of the plain version over z.float()), each
   with its bound (a read and a write of z). The expert-parallel shapes too
   (phase 12's per-shard launches): expert_ffn, expert_ffn_q and
   expert_ffn_q4 over the last shard's slice of a slot pool (a view at an
   offset into the pool and its scale planes, never a copy), bit-identical
   to the kernel over a copy of the slice: [2, 8], [2, 640], [1, 8] (B1,
   12a EP-2 / EP-4 over 4 slots), [2, 8] (B5, 12a EP-4 over 8 int8 slots),
   [1, 8] hot and warm (B5 / B6, 12a's EP-2 tiers), [4, 8], [2, 8], [3, 8]
   (12d's switch-base-64 at EP-4). Phase 13's forms too: flash_prefill at
   hymba-1.5b's GQA group 5 (25 / 5 heads of 64) with its 2048 window over
   [2, 4096], over seamless-m4t-medium's encoder ([2, 512], not causal)
   and in its cross-attention (64 queries over 512 encoder keys, a key
   length of its own, with that form's backward), flash_decode at hymba's
   group 5 over its 2048-slot ring and in seamless's cross form (512
   encoder slots at position 0); SDPA with enable_gqa the library. Phase
   10e's shapes too: nemotron-3-nano's relu² experts (not gated, d 2688 ->
   F 1856) at the [8, 1024] batch's 480 rows a slot, on 128 bf16 and 128
   int8 slots and on the tiered run's 64 hot int8 and 64 warm int4 slots,
   in bf16 (5e-2 * max(1, |y|) an element: relu²'s outputs pass 8, where a
   bf16 ulp is 6.25e-2) and fp32 (1e-4) against the plain version, the
   library bmm, relu², bmm.
3. Batch path: `SiDAEngine` on switch-base-8 at full width and depth (bf16,
   seeded random weights), 4 expert slots per MoE layer, 8 batches of
   8 x 256 tokens through the threaded serve; throughput, latency, memory,
   store traffic, and the launch count of each kernel of that path (0 fails).
4. Card vs CPU: full width, 2 layers, fp32, one batch through the port on
   the card and on the CPU with the same weights: hash ids agree (>= 0.999),
   and the same table gives logits within tolerance.
5. Decode path: `SiDADecodeEngine.generate` on the same model, 8 lanes,
   64 steps over a 512-slot ring cache, (a) on 4 bf16 slots and (b) on 8
   int8-resident slots per MoE layer (about the same device bytes), and
   (c) on hot int8 / warm int4 slots (a 4-slot int8 budget split 0.5: 2 hot,
   3 warm) over a paged K/V pool (page 16, 256 pages, 512 addressable
   positions), and (d) 5a again through the async prefetch pipeline
   (prefetch_depth 2); tok/s, ms/step, loads, tier moves, bytes, pages, the
   prefetch stall, each kernel's launches in the run (0 fails for the
   kernels of that path), the step time's p50 and p99, the profiled device idle
   share and the profile's largest rows (and the decode attention kernel's
   and the host-to-device copies' rows).
5e. Speculative decode: `SiDADecodeEngine(spec_mode="draft", spec_k=4)` on
   the same model with a seeded (untrained) draft head, 8 lanes, 64 tokens a
   lane: (i) all 8 experts on bf16 slots, its tokens gated identical to a
   vanilla run on the same slots; (ii) 5c's tiers over 5c's paged pool;
   (iii) (i) through the async pipeline, gated identical to (i); tok/s, ms a
   block and an emitted token, acceptance, loads a block, stall, bytes and
   launches each (0 fails). Then a directed rollback on (i)'s engine, on
   the ring and on pages: a block of the model's own greedy tokens with one
   wrong draft on half the lanes, whose accept counts, outputs, K/V and
   positions must equal running only each lane's accepted prefix, bit for
   bit.
6. Decode card vs CPU: full width, 2 layers, 40 steps over a 32-slot ring
   (it wraps), fp and int8 slots, in fp32 and in bf16, then (c) tiered
   slots over a paged pool (page 8, 48 pages, fp32): in fp32 the greedy
   tokens identical (and for (c) the same loads and tier moves); one fixed
   table's decode_step logits within tolerance (bf16: 5e-2 * max(1,
   max|logit|), the tokens' agreement printed, not gated). (d) speculative
   decode, fp32, 2 layers: a ring synchronous and through the pipeline, and
   tiered slots over pages; the greedy tokens, the accepted tokens and loads
   of every block and the store's counters identical.
7. SiDA against the paper's baselines (run after phase 3, on its batches):
   StandardServer (all 8 experts resident), OnDemandServer and
   PrefetchAllServer at 4 slots, SiDAEngine synchronous, through the async
   prefetch pipeline, on int8 slots and on hot int8 / warm int4 tiers;
   throughput, latency, device bytes, memory saving, store traffic, prefetch
   overlap and launches each, then SiDA's ratios beside the paper's 3.93x,
   72 % and 80 % (reported, not gated). Gates: async logits within 5e-2 *
   max(1, max|logit|) of sync, every resident slot equal to its host master
   after the async serve, OnDemand at 8 slots within that bound of Standard.
8. Card vs CPU, fp32, 2 layers: the async batch engine (hash ids, logits),
   OnDemand and PrefetchAll (logits, loads), the async decode engine (greedy
   tokens and per-step loads identical).
9. The request server (`RequestServer.run`, run after 5e on the same model):
   24 Poisson requests at 8 req/s in real time (prompts 16-256 tokens, 8-64
   new tokens, `poisson_requests(np.random.default_rng(0), ...)`), 8 lanes,
   prefill batches of up to 8 in buckets (64, 128, 256): (a) a 512-slot
   ring over 4 bf16 slots, (b) (a) through the async prefetch pipeline,
   (c) 5c's hot int8 / warm int4 slots over a paged pool (page 16, 512
   pages, 2048 addressable positions) with one more, 1536-token prompt that
   streams in in six 256-token chunks between decode ticks, (d) speculative
   decode (K = 4, 5e's seeded draft head) over all 8 experts on bf16 slots;
   each run's `summary()`, its wall split (decode ticks, prefill batches,
   chunks, the rest), ms a decode tick beside 5a's ms/step, store traffic,
   9c's `ResidencyManager.summary()`, and each kernel's launches. Gates:
   every request completes with its whole budget of in-vocab tokens and
   none is rejected, 9c's long prompt takes 6 chunks and completes, each
   run's kernels launch, all seven kernels over 9a-9d, and no run counts a
   retry, failure, crash, job error or sync fallback. (e) card vs CPU, fp32,
   2 layers at full width, capacity_factor 100, pre-admitted: 9a's, 9c's
   (a 768-token prompt in 3 chunks) and 9d's setups give every request the
   same tokens and the store the same counters on the card and the CPU;
   9b's async server under a seeded upload:fail,p=0.2 plan gives the tokens
   of its fault-free run on the card and on the CPU; 9a's server with two
   tenants under WFQ gives the same tokens and completed counts per tenant.
9f. The server under faults (after 9d, full width and depth, bf16): 9b,
   9c through the pipeline, and 9b under thread crashes, each serving
   phase 9's 24 requests pre-admitted and closed loop (prefill batches in
   arrival order), fault-free and then under a seeded plan; gates: every
   request completes, the fault-free run counts no supervision event, the
   planned counters are non-zero, the bf16 runs' tokens equal the
   fault-free run's, resident slots hold their masters, the kernels launch.
9g. Two tenants under WFQ on 9a's server (light: 16 Poisson requests at 4
   req/s, SLO 20 s; heavy: 48 at t = 0 with a 0.25 pin quota): light alone,
   beside heavy under WFQ, and with no tenants; gates: every light request
   completes, heavy's pinned share is 0.25, one pin refusal a MoE layer;
   the light tenant's SLO attainment is printed.
10. The MoE attention-family configs at full width, bf16, weights drawn on
   the card from seeds and kept on the host: (a) deepseek-moe-16b at 4 of
   28 layers (64 experts top-6, 2 shared experts resident), (b)
   qwen3-moe-235b-a22b at 2 of 94 (128 experts top-8, GQA 64 / 4), each:
   the routed experts' host bytes beside MemTotal (too little memory
   fails), 4 batches of [8, 256] through SiDAEngine at 16 / 32 slots a
   layer (synchronous, then threaded) against Standard with every expert
   resident (device bytes, memory_saving exactly 1 - slots / E), then
   decode, 8 lanes x 32 steps, over a 512-slot ring on bf16 slots and on
   hot int8 / warm int4 tiers over a paged pool; tok/s, latency, ms a
   step, loads, launches. (c) each at 1 layer, fp32, 4 lanes x 16 steps,
   card against CPU: hash ids, slot traces, tokens and loads identical,
   logits within 1e-3 * max(1, max|logit|). (d) chameleon-34b, gemma2-9b
   (one local and one global layer, a 5120-token prompt), qwen2-1.5b,
   smollm-135m and stablelm-12b at 2 layers, bf16: forward over [2, 512]
   (gemma2 [1, 5120]), 16 greedy decode steps from its K/V over a ring and
   over pages that a KVPagePool seeds; the card against the CPU path
   (fp32, the same weights) within 5e-2 * max(1, max|logit|). (e)
   nemotron-3-nano (unregistered, `configs/nemotron3_nano.py`) at full
   width, its first 6 blocks MEMEM* (Mamba-2, relu² MoE of 128 experts
   top-6, attention), bf16: 2 batches of [8, 1024] through SiDAEngine,
   threaded after a warm-up batch, at 128 slots a MoE block on bf16 slots,
   on int8 slots and on hot int8 / warm int4 tiers (64 / 64); throughput,
   launches; gates: finite logits, the tiers phase 2 held, each run's
   kernels launched.
11. The offline phase on switch-base-8 at full width and depth, fp32,
   seeded weights, SyntheticLM [8, 128] batches: (a) 30 steps of
   `repro_torch.launch.train.train` (lr 3e-4, warmup-cosine, remat):
   param count, peak memory, ms a step (steps 5-30), tok/s, the first and
   last losses, launches, and the three backwards' share of a step
   (torch.profiler over 2 more steps; also from phase 2's backward times);
   gates: finite losses whose last-5 mean is below the first-5 mean, both
   forward kernels launched. (b) TKD of the predictor (d_h 64, seed 1) from
   (a)'s frozen model, 150 steps at lr 3e-3, T 8, λ 0.005, then the draft
   head for 100 steps; ms a step, sparsemax launches, first / last loss,
   kd, ce, acc, held-out top-1 / top-3 hit rates of the trained and the
   untrained predictor; gates: the TKD loss falls, the trained top-1 beats
   chance and the untrained one, the router heads and LSTMs bit-identical
   through the draft training, a checkpoint round trip bit for bit. (d)
   (a)'s model in bf16 through SiDAEngine at 4 slots with each predictor,
   beside Standard: hit rate against the router, the share of tokens whose
   argmax equals Standard's, throughput, loads, bytes, memory saving (every
   batch kernel launches). (e) idle experts a sentence and the effective
   memory utilisation at lengths 16 / 64 / 256 (Figs. 4, 2), ĉ from a
   token-corruption study (Eq. 2). (c) full width cut to 2 layers, card
   against CPU: the first batch's gradients of the LM objective and of the
   TKD loss, each leaf within 1e-3 * max|g_cpu| (zeros where the CPU's are
   not fail), and 2 train and 2 TKD steps, each loss within 1e-4 *
   max(1, |loss|).
12. Expert parallelism on one card (every shard on it, one process driving
   them: one expert-FFN launch a shard a MoE layer, the partials summed in
   shard order). (a) Phase 9's 24 Poisson requests in real time through
   `RequestServer` at full width and depth, bf16, async (depth 2),
   re-homing every 0.5 s: 4 bf16 slots at EP-2 and EP-4 with one replica a
   hot expert, 8 int8 slots at EP-4 with replicas, 5c's tiers at EP-2;
   `summary()` with the shard fields, `uploads_by_shard`, ms a decode tick
   beside 9a's, launches; gates: every request completes, every shard's
   queue uploads, re-homing runs (and moves a primary), each expert-FFN
   kernel launches exactly shards x dispatches, no one-device dispatch,
   slots and replicas hold their masters. (b) Every expert resident (8
   slots), fp32: EP-2 and EP-4 server and decode tokens identical to one
   device's; bf16: a fixed table's logits within 5e-2 * max(1, max|logit|),
   tokens printed. (c) Card vs CPU, fp32, 2 layers, EP-2, a replica a hot
   expert, 6 slots: the server re-homing every iteration (tokens, loads,
   replica loads, moves, residency identical) and the decode engine through
   the per-shard queues with a re-homing between two generates (plus
   `uploads_by_shard`). (d) switch-base-64 at full width, 4 layers, EP-4
   (16 homes a shard) over 16 slots, decode on bf16 slots and on tiers
   through the queues: tok/s, loads a step, per-shard uploads, device bytes
   against Standard's.
13. The hybrid, recurrent and encoder-decoder families (seeded weights drawn
   on the card; their recurrences are plain PyTorch, no kernel of their
   own). (a) hymba-1.5b at full width and depth, bf16: `forward` over
   [2, 4096] (twice its window), 2 lanes x 128 greedy `decode_step`s from
   an empty 2048-slot ring whose last logits match a forward over the same
   tokens (5e-2 * max(1, max|logit|)), `verify_step` (kb 4) whose K/V and
   Mamba state equal the accepted prefix stepped alone, bit for bit; ms a
   prefill and a step, tok/s, peak memory, the device idle share of a
   step and the Mamba updates' share. (b) xlstm-125m, full, fp32: forward
   over [4, 1024] in "assoc" and "scan" mode (1e-4 relative), 4 x 128
   decode steps against forward (5e-3 relative), no kernel launched. (c)
   seamless-m4t-medium, full, bf16: the encoder over [2, 512] stub frames
   and the decoder over [2, 64] tokens (flash_prefill causal, non-causal
   and cross), cross caches from `_encode`, 2 x 64 greedy steps (flash_decode
   over the ring and the 512 encoder slots) against forward (5e-2). (d)
   card vs CPU, full width, 2 layers, fp32: forward logits within 1e-3 *
   max(1, max|logit|), 16 greedy steps' tokens identical, hymba again with
   its window cut to 64 over 96 steps (its ring wraps), hymba's verify
   block (n_acc, tokens), seamless through its cross caches. (e) each
   family's LM-loss gradients at 2 layers, card against CPU (each leaf
   within 1e-3 * max|g_cpu|, floored at 1e-3 of the largest leaf's), then
   `launch.train.train` 10 steps at full width on [4, 256], 4 layers
   (seamless 4 + 4), fp32: losses finite and falling, flash_prefill
   launched in hymba's and seamless's training (its cross form too).
   Phase 11b also runs one TKD step at S = 1280 ([4, 1280] tokens through
   11a's model; sparsemax rows of 1280) on the card and on the CPU: each
   gradient leaf within 1e-3 * max|g_cpu|, the step's loss within 1e-4 *
   max(1, |loss|).
14. (a) `models/moe.py::apply_expert_stack` (the reference's unblocked
   einsum FFN, plain PyTorch) at switch-base-8's [4, 640] bf16 against B1
   within 5e-2 * max(1, max|y|). (b) C2 on the trained miniature: the
   committed sys_E8 (experiments/cache/sys_E8) in bf16 with its trained
   predictor, `SiDADecodeEngine` 8 lanes x 64 greedy steps, no fixed table,
   at 8 and 3 slots: tokens and per-step loads identical on card and CPU.
   (c) the port's dry run (`launch/dryrun.py`: fake tensors on the host
   under FlopCounterMode, no JAX) of switch-base-8 x {train_4k, decode_32k}
   on the (16, 16) pod mesh: FLOPs and GB a device; a failed trace fails.

The second-to-last lines are the kernels' JSON record (the seven kernels,
expert_ffn at the decode shape, at 5e's all-resident verify step
[8, 8, d] and at Standard's, expert_ffn_q and
expert_ffn_q4 at the batch serves' shapes, and sparsemax at the ring's;
`device_ms` and
`library_device_ms` are the graph-replayed times; `spec_launches` a decode
kernel's launches on 5e's speculative runs, null for the batch rows;
`server_launches` a kernel's launches on each of 9a-9d (null for the shape
rows); the training rows (`expert_ffn/train`, `flash_prefill/train`,
`sparsemax/tkd`) count 11a's / 11b's launches (`sparsemax/tkd-1280` 11b's
S = 1280 step's, at its [4, 1280, 1280] scores; `/tkd-2048`, `/tkd-8192`
and `/bf16` are shape rows that no path launches, 0) and carry their backward's
`backward_*` times, bound and error over its tolerance; the phase-10 rows (`expert_ffn/deepseek-batch`,
`flash_decode/qwen3-G16`, ...) count their own phase-10 run's launches,
each attention row its own form's (`ops.launches_by_shape()`; 0 fails),
`library_max_abs_err` is the library call's own distance from the plain
version, the phase-13 rows (`flash_prefill/hymba-G5`, `/seamless-enc`,
`/seamless-cross`, `flash_decode/hymba-G5`, `/seamless-cross`) count their
own form's launches in their phase-13 run, the nemotron rows
(`expert_ffn/nemotron-batch`, `expert_ffn_q/nemotron-batch`,
`expert_ffn_q/nemotron-tiered-hot`, `expert_ffn_q4/nemotron-tiered-warm`)
count their own phase-10e run's launches of their kernel, the expert-parallel rows (`expert_ffn/ep2-decode`, ...) count their
phase-12 run's launches of their kernel, and `sdpa_nocap_*` time SDPA without the softcap the kernel applies;
flash_decode_paged's
`gathered_*` times are its comparators on the keys gathered into a ring) and
the nvidia-smi line; the last line is {"ok": true, "device": {...}}. Imports
nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
H100_BF16_FLOPS = 989e12
H100_F32_FLOPS = 67e12
H100_BYTES_S = 3.35e12


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 20) -> float:
    """Time of one call of `fn`: CUDA events around `reps` back-to-back calls
    (warm L2), as every slice has timed it. The kernels line's `ms`,
    `plain_ms` and `library_ms`. Below ~0.06 ms it is the host's launch work
    (the Python wrappers) that paces it, not the device."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20):
    """Device time of one call of `fn`: `reps` calls captured in one CUDA
    graph, replayed between two events (warm L2), so no host launch work is
    in it. The kernels line's `device_ms` and `library_device_ms`; None, and
    said so, where the call cannot be captured."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    try:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
    except RuntimeError as exc:   # an op the graph cannot capture
        print(f"    (not capturable, device_ms is null: {str(exc)[:120]})")
        return None
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    """(least ms, what bounds it, bytes, operations) of a call on the H100."""
    t_bytes, t_ops = nbytes / H100_BYTES_S, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"),
            nbytes, flops)


def nb(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def report(failed, name, dtype, shape, got, want, tol, k_ms, p_ms, lib_ms, bnd, lib_label="",
           graph=None):
    """Print one kernel-vs-plain case; append it to `failed` if it disagrees.
    `tol` bounds max_abs_err, or is a tensor of `want`'s shape that bounds
    each element's error (the worst error / bound is printed). `graph` is (kernel call, library call or None), timed again on the device
    alone by `graph_ms`. Beside each kernel time: its rate in the unit of what
    bounds it (TFLOP/s or GB/s) and the share of the bound it reaches.
    Returns the case's record for the kernels' JSON line."""
    import torch

    diff = (got.float() - want.float()).abs()
    err = diff.max().item()
    over = (diff / tol).max().item() if torch.is_tensor(tol) else err / tol
    ok = bool(over <= 1) and bool(torch.isfinite(got.float()).all())
    tol_txt = (f"tol=elementwise (worst error / bound {over:.4f})" if torch.is_tensor(tol)
               else f"tol={tol:g}")
    k_dev = l_dev = None
    if graph is not None:
        k_dev = graph_ms(graph[0])
        l_dev = None if graph[1] is None else graph_ms(graph[1])

    def rate(ms):
        if ms is None:
            return "null"
        r = (f"{bnd[3] / ms / 1e9:.1f} TFLOP/s" if bnd[1] == "operations"
             else f"{bnd[2] / ms / 1e6:.1f} GB/s")
        return f"{ms:.4f} ({r}, share_of_bound={bnd[0] / ms:.3f})"

    lib = "null" if lib_ms is None else f"{lib_ms:.4f}{lib_label}"
    dev = ("" if graph is None else
           f" device_ms={rate(k_dev)} library_device_ms="
           f"{'null' if l_dev is None else f'{l_dev:.4f}'}")
    print(f"  {name:20s} {str(dtype).replace('torch.', ''):8s} {shape} max_abs_err={err:.3e} "
          f"{tol_txt} {'ok' if ok else 'FAIL'} kernel_ms={rate(k_ms)} plain_ms={p_ms:.4f} "
          f"library_ms={lib} bound_ms={bnd[0]:.4f} ({bnd[1]}){dev}", flush=True)
    if not ok:
        failed.append(f"{name} {dtype} {shape}")
    return dict(max_abs_err=err, err_over_tol=over, ms=k_ms, plain_ms=p_ms, bound_ms=bnd[0], bound_by=bnd[1],
                library_ms=lib_ms, device_ms=k_dev, library_device_ms=l_dev)


def batch_capacity(cfg, batch: int, seq: int, slots: int) -> int:
    """Rows of each slot's capacity buffer in a batch of batch x seq tokens."""
    from repro_torch.models.moe import _block_tokens, _capacity

    T = batch * seq
    return (T // _block_tokens(T)) * _capacity(cfg, _block_tokens(T), slots)


def check_kernels(cfg, batch: int, seq: int, slots: int):
    """Phase 2: every kernel vs its plain version at the main path's shapes,
    and expert_ffn at Standard's all-expert dispatch [E, C, d] (bf16).
    Returns {kernel: record of the bf16 / main-path case}."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.expert_gemm import expert_ffn_cuda
    from repro_torch.kernels.flash_prefill import flash_prefill_cuda

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(123)

    def rnd(shape, scale, dtype):
        return (torch.randn(shape, generator=gen) * scale).to(dtype=dtype, device=dev)

    records, failed = {}, []

    # --- expert_ffn: [E=slots, C, d] through the slot stack (non-gated GELU)
    d, Fh = cfg.d_model, cfg.moe.d_expert
    C = batch_capacity(cfg, batch, seq, slots)
    for dtype, tol in ((torch.bfloat16, 5e-2), (torch.float32, 1e-4)):
        xe = rnd((slots, C, d), 1.0, dtype)
        wi = rnd((slots, d, Fh), d ** -0.5, dtype)
        wo = rnd((slots, Fh, d), Fh ** -0.5, dtype)
        got = expert_ffn_cuda(xe, wi, None, wo, act=cfg.act)
        torch.cuda.synchronize()
        want = ref.expert_ffn_ref(xe, wi, None, wo, act=cfg.act)

        def lib():
            h = F.gelu(torch.bmm(xe, wi), approximate="tanh")
            return torch.bmm(h, wo)

        peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
        bnd = bound_ms(nb(xe, wi, wo, got), 2 * 2 * slots * C * d * Fh, peak)
        kern = lambda: expert_ffn_cuda(xe, wi, None, wo, act=cfg.act)
        k_ms = time_ms(kern)
        p_ms = time_ms(lambda: ref.expert_ffn_ref(xe, wi, None, wo, act=cfg.act))
        l_ms = time_ms(lib)
        rec = report(failed, "expert_ffn", dtype, (slots, C, d, Fh), got, want, tol, k_ms, p_ms,
                     l_ms, bnd, " (bmm+gelu+bmm)", graph=(kern, lib))
        if dtype == torch.bfloat16:
            records["expert_ffn"] = rec

    # --- expert_ffn at StandardServer's dense dispatch over all E experts
    E = cfg.moe.num_experts
    C_std = batch_capacity(cfg, batch, seq, E)
    xe = rnd((E, C_std, d), 1.0, torch.bfloat16)
    wi = rnd((E, d, Fh), d ** -0.5, torch.bfloat16)
    wo = rnd((E, Fh, d), Fh ** -0.5, torch.bfloat16)
    got = expert_ffn_cuda(xe, wi, None, wo, act=cfg.act)
    torch.cuda.synchronize()
    want = ref.expert_ffn_ref(xe, wi, None, wo, act=cfg.act)

    def lib_std():
        return torch.bmm(F.gelu(torch.bmm(xe, wi), approximate="tanh"), wo)

    kern = lambda: expert_ffn_cuda(xe, wi, None, wo, act=cfg.act)
    records["expert_ffn/standard"] = report(
        failed, "expert_ffn/standard", torch.bfloat16, (E, C_std, d, Fh), got, want, 5e-2,
        time_ms(kern), time_ms(lambda: ref.expert_ffn_ref(xe, wi, None, wo, act=cfg.act)),
        time_ms(lib_std), bound_ms(nb(xe, wi, wo, got), 2 * 2 * E * C_std * d * Fh,
                                   H100_BF16_FLOPS),
        " (bmm+gelu+bmm)", graph=(kern, lib_std))

    # --- sparsemax: the predictor's scores [B, S, S] (fp32 only on the path)
    z = rnd((batch, seq, seq), 3.0, torch.float32)
    records["sparsemax"] = check_sparsemax(failed, "sparsemax", z)

    # --- flash_prefill: [B, S, H, D] causal (the path), plus window + softcap
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        for window, cap in ((0, 0.0), (64, 50.0)):
            q = rnd((batch, seq, H, D), 1.0, dtype)
            k = rnd((batch, seq, K, D), 1.0, dtype)
            v = rnd((batch, seq, K, D), 1.0, dtype)
            got = flash_prefill_cuda(q, k, v, window=window, cap=cap, causal=True)
            torch.cuda.synchronize()
            want = ref.flash_prefill_ref(q, k, v, window=window, cap=cap, causal=True)
            i = torch.arange(seq)
            vis = (i[:, None] >= i[None, :])
            if window:
                vis &= i[None, :] > i[:, None] - window
            pairs = int(vis.sum())
            peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
            bnd = bound_ms(nb(q, k, v, got), 4 * batch * H * D * pairs, peak)
            l_ms = lib = None
            if not window and not cap:
                qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
                lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
                l_ms = time_ms(lib)
            kern = lambda: flash_prefill_cuda(q, k, v, window=window, cap=cap)
            k_ms = time_ms(kern)
            p_ms = time_ms(lambda: ref.flash_prefill_ref(q, k, v, window, cap, True))
            rec = report(failed,
                         f"flash_prefill{'/w' + str(window) + 'c' + str(int(cap)) if window else ''}",
                         dtype, tuple(q.shape), got, want, tol, k_ms, p_ms, l_ms, bnd,
                         " (SDPA)" if l_ms is not None else "", graph=(kern, lib))
            if dtype == torch.bfloat16 and not window:
                records["flash_prefill"] = rec

    # --- sparsemax on slowly converging rows (scale 0.05: many values near
    # the max, so the most support-shrinking passes of a served shape)
    check_sparsemax(failed, "sparsemax/slow", rnd((batch, seq, seq), 0.05, torch.float32))
    if failed:
        raise SystemExit(f"chip_smoke: kernels disagree with their plain versions: {failed}")
    return records


def check_sparsemax(failed, name, z):
    """Phase 2, sparsemax (fp32 only on the path) on scores z: held to its
    plain version at 1e-5, a rerun bit-identical, timed with `device_ms`.
    Returns the record."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.sparsemax import sparsemax_cuda

    z = z.contiguous()
    got = sparsemax_cuda(z)
    again = sparsemax_cuda(z)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        failed.append(f"{name}: a rerun differs")
    want = ref.sparsemax_ref(z)
    bnd = bound_ms(nb(z, got), 4 * z.numel(), H100_F32_FLOPS)
    kern = lambda: sparsemax_cuda(z)
    return report(failed, name, torch.float32, tuple(z.shape), got, want, 1e-5, time_ms(kern),
                  time_ms(lambda: ref.sparsemax_ref(z)), None, bnd, graph=(kern, None))


def seeded_model(cfg):
    """The served weights: model from seed 0, hash predictor (d_h 64) from
    seed 1, both made on the host, as `repro_torch.launch.serve` makes them."""
    import torch

    from repro_torch.core.hash_fn import init_hash_fn
    from repro_torch.models.transformer import init_params, n_moe_layers

    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    hp = init_hash_fn(torch.Generator().manual_seed(1), cfg.d_model, n_moe_layers(cfg),
                      cfg.moe.num_experts, d_h=64, device="cpu")
    return params, hp


BATCH_KERNELS = ("expert_ffn", "sparsemax", "flash_prefill")


def main_path(cfg, params, hp, batches, slots: int):
    """Phase 3: the threaded SiDA serve at full width; returns launch counts."""
    import numpy as np
    import torch

    from repro_torch.core.engine import SiDAEngine
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    eng = SiDAEngine(cfg, params, hp, slots_per_layer=slots, device="cuda")
    print(f"  setup_s={time.perf_counter() - t0:.2f} (engine build: host masters, device params)")
    eng.serve(batches[:1], threaded=False)        # warm-up: cuBLAS handles, first uploads
    eng.store.stats.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launches()
    m = eng.serve(batches, threaded=True)
    counts = ops.launches()

    V, Vp = cfg.vocab_size, cfg.padded_vocab
    for i, r in enumerate(eng.results):
        if r is None or tuple(r.shape) != (*batches[i].shape, Vp):
            raise SystemExit(f"chip_smoke: batch {i} logits shape {None if r is None else r.shape}")
        if not torch.isfinite(r[..., :V]).all() or not (r[..., V:] <= -1e29).all():
            raise SystemExit(f"chip_smoke: batch {i} logits not finite / padded vocab not masked")
    st = eng.store.stats
    ms = eng.memory_saving()
    n_tok = sum(int(np.prod(b.shape)) for b in batches)
    print(f"  batches={len(batches)} x {batches[0].shape} tokens={n_tok} slots={slots}")
    print(f"  throughput_tok_s={m.throughput:.1f} mean_latency_s={m.mean_latency:.5f} "
          f"hash_time_s={m.hash_time_s:.4f} wall_s={m.wall_s:.4f}")
    print(f"  device_memory_bytes={eng.device_memory_bytes()} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()}")
    print(f"  memory_saving full_expert_gb={ms['full_expert_gb']:.4f} "
          f"resident_expert_gb={ms['resident_expert_gb']:.4f} reduction={ms['reduction']:.4f}")
    print(f"  store loads={st.loads} hits={st.hits} evictions={st.evictions} "
          f"dropped={st.dropped} bytes_h2d={st.bytes_h2d} sync_upload_s={st.prepare_time:.4f}")
    print(f"  launches {json.dumps(counts)}")
    idle = [k for k in BATCH_KERNELS if counts[k] == 0]
    if idle:
        raise SystemExit(f"chip_smoke: kernels never launched on the batch path: {idle}")
    seq = eng.serve(batches, threaded=False)
    print(f"  sequential ablation (hash, prepare, forward in turn): "
          f"throughput_tok_s={seq.throughput:.1f} mean_latency_s={seq.mean_latency:.5f} "
          f"wall_s={seq.wall_s:.4f}")
    breakdown(eng, batches)
    eng.close()
    return counts


def breakdown(eng, batches):
    """Phase 3b: where a batch's time goes. Each stage alone, host clock
    around work that ends in a synchronize; then the device's busy share
    over one more threaded serve of the same batches (torch.profiler)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models.transformer import forward

    stages = {"hash": [], "prepare": [], "forward": [], "logits_d2h": []}
    for j, toks in enumerate(batches):
        t0 = time.perf_counter()
        table = eng.build_table(j, toks)              # ends in the ids' copy to host
        t1 = time.perf_counter()
        trans = eng.store.prepare(table)
        slot_ids, w = eng.store.translate(table, trans)
        ro = (torch.from_numpy(slot_ids).to(eng.device), torch.from_numpy(w).to(eng.device))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with torch.inference_mode():
            logits = forward(eng.store.serve_params, eng.cfg,
                             torch.as_tensor(toks, device=eng.device), routing_override=ro)["logits"]
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        logits.cpu()
        t4 = time.perf_counter()
        for k, v in zip(stages, (t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
            stages[k].append(v)
    print("  per-batch stage means (sequential): " + " ".join(
        f"{k}_ms={1e3 * float(np.mean(v)):.3f}" for k, v in stages.items()))

    # device activity only: with host ops recorded too, each op's row carries
    # the device time of its kernels and the kernels have rows of their own,
    # so the sum would count device time twice
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.serve(batches, threaded=True)
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, e.key, e.count))
    busy_s = sum(r[0] for r in rows) / 1e6
    if busy_s <= 0:
        print("  device busy share: not measured (the profiler recorded no device time)")
        return
    print(f"  profiled threaded serve: wall_s={wall:.4f} device_busy_s={busy_s:.4f} "
          f"device_idle_share={max(0.0, 1 - busy_s / wall):.3f}")
    for dev_us, key, count in sorted(rows, reverse=True)[:8]:
        print(f"    {dev_us / 1e3:9.3f} ms  {count:6d}x  {key[:90]}")


BASELINE_KERNELS = {"standard": ("expert_ffn", "flash_prefill"),
                    "ondemand": ("expert_ffn", "flash_prefill"),
                    "prefetchall": ("expert_ffn", "flash_prefill"),
                    "sida-sync": ("expert_ffn", "sparsemax", "flash_prefill"),
                    "sida-async": ("expert_ffn", "sparsemax", "flash_prefill"),
                    "sida-int8": ("expert_ffn_q", "sparsemax", "flash_prefill"),
                    "sida-tiered": ("expert_ffn_q", "expert_ffn_q4", "sparsemax", "flash_prefill")}
PAPER = {"throughput_x": 3.93, "latency_reduction": 0.72, "memory_saving": 0.80}


def baseline_runs(cfg, slots: int, tier_slots: int):
    """Phase 7's runs: (name, engine factory(params, hp)). Standard holds all
    E experts; every other run holds `slots` a MoE layer (the tiered one a
    budget of `tier_slots` int8 slots, split as in phase 5c)."""
    from repro_torch.configs.base import TierConfig
    from repro_torch.core.baselines import OnDemandServer, PrefetchAllServer, StandardServer
    from repro_torch.core.engine import SiDAEngine

    tier = TierConfig(int4_slots=True, tier_split=0.5, group_size=64)

    def sida(**kw):
        return lambda p, hp: SiDAEngine(cfg, p, hp, device="cuda", **kw)

    return (("standard", lambda p, hp: StandardServer(cfg, p, device="cuda")),
            ("ondemand", lambda p, hp: OnDemandServer(cfg, p, slots, device="cuda")),
            ("prefetchall", lambda p, hp: PrefetchAllServer(cfg, p, slots, device="cuda")),
            ("sida-sync", sida(slots_per_layer=slots)),
            ("sida-async", sida(slots_per_layer=slots, prefetch_depth=2, staging_buffers=2)),
            ("sida-int8", sida(slots_per_layer=slots, quantized_slots=True)),
            ("sida-tiered", sida(slots_per_layer=tier_slots, quantized_slots=True, tier=tier)))


def resident_equals_host(store) -> int:
    """Every resident slot of `store` (primaries and replicas) against its
    host master, byte for byte (the fp / int8 rows and scale planes, the warm
    tier's int4 rows and group scales). Returns the number of slots checked;
    raises on a mismatch."""
    import torch

    from repro_torch.core.offload import EXPERT_TENSORS

    n = 0
    for l in range(store.L):
        g, s = store.layer_to_gs(l)
        moe_p = store.serve_params["blocks"][f"sub{s}"]["moe"]
        copies = [(e, slot) for e, slot in store.resident[(g, s)].items()]
        copies += [(e, slot) for e, by in store.replicas[(g, s)].items() for slot in by.values()]
        for e, slot in copies:
            for t in EXPERT_TENSORS:
                if slot >= store.S8:
                    pairs = ((moe_p[t + "_q4"][g, slot - store.S8], store.host4[f"sub{s}"][t]),
                             (moe_p[t + "_q4_scale"][g, slot - store.S8],
                              store.host4_scale[f"sub{s}"][t]))
                elif store.quantized_slots:
                    pairs = ((moe_p[t][g, slot], store.host[f"sub{s}"][t]),
                             (moe_p[t + "_scale"][g, slot], store.host_scale[f"sub{s}"][t]))
                else:
                    pairs = ((moe_p[t][g, slot], store.host[f"sub{s}"][t]),)
                for dev, host in pairs:
                    if not torch.equal(dev.cpu(), host[g, e]):
                        raise SystemExit(f"chip_smoke: slot {slot} of MoE layer {l} does not hold "
                                         f"expert {e}'s master ({t})")
            n += 1
    return n


def baselines_path(cfg, params, hp, batches, slots: int, tier_slots: int, tiers):
    """Phase 7: SiDA against the paper's baselines, full width and depth, bf16,
    on phase 3's batches. Each run: build, one warm-up batch, counters reset,
    then the 8 batches (SiDA threaded, as phase 3), with each kernel's
    launches. Gates: the async SiDA logits within the bf16 bound of the
    synchronous ones, every resident slot equal to its host master after the
    async serve, OnDemand at E slots within the bf16 bound of Standard on
    batch 0. The SiDA-vs-baseline ratios are printed beside the paper's, not
    gated. Returns {run: launch counts}."""
    import numpy as np
    import torch

    from repro_torch.core.baselines import OnDemandServer
    from repro_torch.core.engine import SiDAEngine
    from repro_torch.kernels import ops

    V, E = cfg.vocab_size, cfg.moe.num_experts
    out, summary, logits = {}, {}, {}
    std = None
    for name, make in baseline_runs(cfg, slots, tier_slots):
        t0 = time.perf_counter()
        eng = make(params, hp)
        setup = time.perf_counter() - t0
        sida = isinstance(eng, SiDAEngine)
        if sida:
            eng.serve(batches[:1], threaded=False)      # warm-up, as phase 3
            eng.store.stats.reset()
            if eng.prefetcher is not None:
                eng.prefetcher.stats.reset()
        else:
            eng.serve(batches[:1])
            if hasattr(eng, "store"):
                eng.store.stats.reset()
        torch.cuda.synchronize()
        ops.reset_launches()
        m = eng.serve(batches, threaded=True) if sida else eng.serve(batches)
        counts = ops.launches()
        summary[name] = (m.throughput, m.mean_latency, eng.device_memory_bytes())
        print(f"  ({name}) setup_s={setup:.2f} throughput_tok_s={m.throughput:.1f} "
              f"mean_latency_s={m.mean_latency:.5f} wall_s={m.wall_s:.4f} "
              f"device_memory_bytes={eng.device_memory_bytes()}")
        if hasattr(eng, "store"):
            st = eng.store.stats
            saving = (f" memory_saving={eng.memory_saving()['reduction']:.4f}" if sida else "")
            print(f"    store S8={eng.store.S8} S4={eng.store.S4} loads={st.loads} "
                  f"evictions={st.evictions} promotions={st.promotions} "
                  f"demotions={st.demotions} bytes_h2d={st.bytes_h2d} "
                  f"sync_upload_s={st.prepare_time:.4f}{saving}")
        if sida and eng.prefetcher is not None:
            ps = eng.prefetcher.stats
            print(f"    prefetch stall_s={ps.stall_s:.4f} transfer_s={ps.transfer_s:.4f} "
                  f"overlap_s={ps.overlap_s:.4f} uploads={ps.uploads} stolen={ps.stolen} "
                  f"staging_waits={ps.staging_waits} submitted={ps.submitted}")
        print(f"    launches {json.dumps(counts)}")
        idle = [k for k in BASELINE_KERNELS[name] if counts[k] == 0]
        if idle:
            raise SystemExit(f"chip_smoke: kernels never launched on the {name} run: {idle}")
        if name == "sida-tiered" and (eng.store.S8, eng.store.S4) != tiers:
            raise SystemExit(f"chip_smoke: the tiered batch store has (S8, S4) = "
                             f"{(eng.store.S8, eng.store.S4)}, phase 2 checked {tiers}")
        if name in ("sida-sync", "sida-async"):
            logits[name] = eng.results
        if name == "sida-async":
            n = resident_equals_host(eng.store)
            print(f"    after the async serve: {n} resident slots equal their host masters")
        if name == "standard":
            std = eng
        elif sida:
            eng.close()
        out[name] = counts
        del eng

    # gate: async against sync SiDA on the same batches
    worst = 0.0
    for a, b in zip(logits["sida-async"], logits["sida-sync"]):
        a, b = a[..., :V].float(), b[..., :V].float()
        err = (a - b).abs().max().item()
        tol = 5e-2 * max(1.0, b.abs().max().item())
        worst = max(worst, err / tol)
        if not err <= tol or not torch.isfinite(a).all():
            raise SystemExit(f"chip_smoke: async SiDA logits differ from sync: {err:.3e} > {tol:.3e}")
    print(f"  gate: async vs sync SiDA logits, worst error / bound = {worst:.4f} (need <= 1)")
    # gate: OnDemand at E slots against Standard on batch 0 (the same
    # per-expert capacity, so the same dropped tokens)
    od = OnDemandServer(cfg, params, E, device="cuda")
    lo = od._forward_batch(batches[0])[..., :V].float()
    ls = std._fwd(batches[0])[..., :V].float()
    err = (lo - ls).abs().max().item()
    tol = 5e-2 * max(1.0, ls.abs().max().item())
    print(f"  gate: OnDemand at {E} slots vs Standard, batch 0: max_abs_err={err:.3e} tol={tol:.3e}")
    if not err <= tol or not torch.isfinite(lo).all():
        raise SystemExit("chip_smoke: OnDemand at E slots disagrees with Standard")
    del od, std

    # the paper's comparison, reported, not gated
    for sida in ("sida-sync", "sida-async", "sida-int8", "sida-tiered"):
        tput, lat, mem = summary[sida]
        parts = []
        for base in ("standard", "ondemand", "prefetchall"):
            bt, bl, _ = summary[base]
            parts.append(f"vs {base}: throughput x{tput / bt:.3f} latency reduction "
                         f"{1 - lat / bl:.4f}")
        print(f"  {sida}: " + "; ".join(parts) + f"; device memory saving vs standard "
              f"{1 - mem / summary['standard'][2]:.4f}")
    print(f"  (paper: up to x{PAPER['throughput_x']} throughput, "
          f"{PAPER['latency_reduction']:.0%} latency reduction, "
          f"{PAPER['memory_saving']:.0%} memory saving)")
    return out


def async_card_vs_cpu(cfg, batches, slots: int, lanes: int):
    """Phase 8: fp32, 2 layers, on the card and on the CPU with the same
    weights: the async batch engine (the same hash ids, >= 0.999; logits of
    a threaded serve on the CPU's tables within 1e-3 * max(1, max|logit|)),
    OnDemand and PrefetchAll (logits within that bound, the same loads and
    evictions), the async decode engine (greedy tokens and per-step loads
    identical)."""
    import numpy as np
    import torch

    from repro_torch.core.baselines import OnDemandServer, PrefetchAllServer
    from repro_torch.core.decode_engine import SiDADecodeEngine
    from repro_torch.core.engine import SiDAEngine

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params, hp = seeded_model(cfg2)
    V = cfg2.vocab_size
    where = {"card": "cuda", "cpu": "cpu"}

    def close(a, b):
        err = float(np.abs(a[..., :V] - b[..., :V]).max())
        tol = 1e-3 * max(1.0, float(np.abs(b[..., :V]).max()))
        return err, tol, err <= tol and np.isfinite(a).all()

    # the async batch engine: the CPU's tables on both, threaded serve
    eng = {k: SiDAEngine(cfg2, params, hp, slots_per_layer=slots, device=d, prefetch_depth=2)
           for k, d in where.items()}
    tabs = {k: [e.build_table(j, b) for j, b in enumerate(batches)] for k, e in eng.items()}
    agree = float(np.mean([(a.expert_ids == b.expert_ids).mean()
                           for a, b in zip(tabs["card"], tabs["cpu"])]))
    for e in eng.values():
        e.build_table = lambda j, toks: tabs["cpu"][j]
        e.serve(batches, threaded=True)
        e.close()
    errs = [close(a.float().numpy(), b.float().numpy())
            for a, b in zip(eng["card"].results, eng["cpu"].results)]
    ps = eng["card"].prefetcher.stats
    print(f"  (sida-async) fp32 n_layers=2 batches={len(batches)}x{batches[0].shape}: hash id "
          f"agreement={agree:.6f} (need >= 0.999); logits max_abs_err="
          f"{max(e[0] for e in errs):.3e} tol={min(e[1] for e in errs):.3e}; card uploads="
          f"{ps.uploads} stolen={ps.stolen}")
    if agree < 0.999 or not all(e[2] for e in errs):
        raise SystemExit("chip_smoke: card and CPU disagree on the async batch path")
    del eng

    for name, cls in (("ondemand", OnDemandServer), ("prefetchall", PrefetchAllServer)):
        srv = {k: cls(cfg2, params, slots, device=d) for k, d in where.items()}
        lg = {k: [s._forward_batch(b).float().cpu().numpy() for b in batches]
              for k, s in srv.items()}
        errs = [close(a, b) for a, b in zip(lg["card"], lg["cpu"])]
        stats = {k: (s.store.stats.loads, s.store.stats.evictions, s.store.stats.bytes_h2d)
                 for k, s in srv.items()}
        print(f"  ({name}) fp32 n_layers=2: logits max_abs_err={max(e[0] for e in errs):.3e} "
              f"tol={min(e[1] for e in errs):.3e}; loads, evictions, bytes_h2d card "
              f"{stats['card']} cpu {stats['cpu']}")
        if not all(e[2] for e in errs) or stats["card"] != stats["cpu"]:
            raise SystemExit(f"chip_smoke: card and CPU disagree on {name}")

    start = np.random.default_rng(0).integers(0, V, (lanes,)).astype(np.int32)
    dec = {k: SiDADecodeEngine(cfg2, params, hp, slots_per_layer=slots, device=d,
                               prefetch_depth=2) for k, d in where.items()}
    res = {k: e.generate(start, steps=40, cache_len=32) for k, e in dec.items()}
    for e in dec.values():
        e.close()
    same = float((res["card"][0] == res["cpu"][0]).mean())
    loads_same = res["card"][1].loads_per_step == res["cpu"][1].loads_per_step
    print(f"  (decode-async) fp32 n_layers=2 lanes={lanes} steps=40 cache_len=32: greedy tokens "
          f"identical={same:.6f} (need 1.0); per-step loads identical={loads_same}; card "
          f"stall_s={res['card'][1].stall_s:.4f}")
    if same < 1.0 or not loads_same:
        raise SystemExit("chip_smoke: card and CPU disagree on the async decode path")


def card_vs_cpu(cfg, tokens, slots: int):
    """Phase 4: the whole path on the card and on the CPU, same weights."""
    import numpy as np
    import torch

    from repro_torch.core.engine import SiDAEngine
    from repro_torch.core.hash_fn import init_hash_fn
    from repro_torch.models.transformer import init_params, n_moe_layers

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params = init_params(torch.Generator().manual_seed(0), cfg2, device="cpu")
    hp = init_hash_fn(torch.Generator().manual_seed(1), cfg2.d_model, n_moe_layers(cfg2),
                      cfg2.moe.num_experts, d_h=64, device="cpu")
    gpu = SiDAEngine(cfg2, params, hp, slots_per_layer=slots, device="cuda")
    cpu = SiDAEngine(cfg2, params, hp, slots_per_layer=slots, device="cpu")
    tab_g, tab_c = gpu.build_table(0, tokens), cpu.build_table(0, tokens)
    agree = float((tab_g.expert_ids == tab_c.expert_ids).mean())
    w_err = float(np.abs(tab_g.weights - tab_c.weights).max())
    lg = gpu.infer(tokens, tab_c).float().cpu().numpy()
    lc = cpu.infer(tokens, tab_c).float().numpy()
    V = cfg2.vocab_size
    err = float(np.abs(lg[..., :V] - lc[..., :V]).max())
    scale = float(np.abs(lc[..., :V]).max())
    tol = 1e-3 * max(1.0, scale)
    print(f"  fp32 n_layers=2 batch={tokens.shape}: hash id agreement={agree:.6f} (need >= 0.999) "
          f"alpha max_abs_err={w_err:.3e}")
    print(f"  logits (same table) max_abs_err={err:.3e} tol={tol:.3e} max|logit|={scale:.3f}")
    if agree < 0.999 or not err <= tol or not np.isfinite(lg).all():
        raise SystemExit("chip_smoke: card and CPU disagree on the whole path")


def check_decode_kernels(cfg, lanes: int, cache_len: int, slots: int, int8_slots: int,
                         hot: int, c_hot: int, c_batch: int, hot_b: int, c_tb: int,
                         spec_slots: int):
    """Phase 2, decode shapes: flash_decode over the ring cache, expert_ffn_q
    and expert_ffn on the decode step's [slots, 8, d] capacity buffer,
    expert_ffn_q also on 5b's [int8_slots, 8, d], on 5c's hot block
    [hot, c_hot, d], on the int8 batch serve's [slots, c_batch, d] and on the
    tiered batch serve's hot block [hot_b, c_tb, d], expert_ffn also on 5e's
    all-resident verify step [spec_slots, 8, d], sparsemax on the
    predictor's [lanes, 128] ring scores with masked entries. Returns
    {kernel: record of the path's bf16 case}."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.decode_engine import HISTORY
    from repro_torch.kernels import ref
    from repro_torch.kernels.expert_gemm import expert_ffn_cuda, expert_ffn_q_cuda
    from repro_torch.kernels.flash_decode import decode_plan, flash_decode_cuda
    from repro_torch.models.moe import _capacity

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(321)

    def rnd(shape, scale, dtype):
        return (torch.randn(shape, generator=gen) * scale).to(dtype=dtype, device=dev)

    records, failed = {}, []

    # --- flash_decode: one token per lane over the ring cache
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd

    def ring(pos, S):
        p = torch.tensor(pos, dtype=torch.int32)
        s_idx = torch.arange(S, dtype=torch.int32)[None, :]
        sp = p[:, None] - ((p[:, None] - s_idx) % S)
        sp = torch.where(sp >= 0, sp, torch.full_like(sp, -1))
        return sp.to(dev).contiguous(), p.to(dev)

    wrapped = [cache_len + 89 * i for i in range(lanes)]      # every lane past the wrap
    cases = [  # name, dtype, H, K, S, positions, window, cap, tol
        ("flash_decode", torch.bfloat16, H, K, cache_len, wrapped, 0, 0.0, 2e-2),
        ("flash_decode", torch.float32, H, K, cache_len, wrapped, 0, 0.0, 1e-4),
        ("flash_decode/early", torch.bfloat16, H, K, cache_len, list(range(0, 8 * lanes, 8)),
         0, 0.0, 2e-2),
        ("flash_decode/w128c50", torch.bfloat16, H, K, cache_len, wrapped, 128, 50.0, 2e-2),
        ("flash_decode/G4", torch.bfloat16, H, H // 4, cache_len, wrapped, 0, 0.0, 2e-2),
        ("flash_decode/invalid", torch.float32, H, K, 300, [-1] + wrapped[1:], 0, 0.0, 1e-4),
        # the split's edges: 300 keys are not a whole number of tiles a rank,
        # and a window of 5 at the end leaves the valid keys in the last rank
        ("flash_decode/S300", torch.bfloat16, H, K, 300, wrapped, 0, 0.0, 2e-2),
        ("flash_decode/last-rank", torch.bfloat16, H, K, cache_len, [cache_len - 1] * lanes, 5,
         0.0, 2e-2),
    ]
    for name, dtype, h, kh, S, pos, window, cap, tol in cases:
        q = rnd((lanes, h, D), 1.0, dtype)
        k = rnd((lanes, S, kh, D), 1.0, dtype)
        v = rnd((lanes, S, kh, D), 1.0, dtype)
        sp, p = ring(pos, S)
        got = flash_decode_cuda(q, k, v, sp, p, window=window, cap=cap)
        again = flash_decode_cuda(q, k, v, sp, p, window=window, cap=cap)
        torch.cuda.synchronize()
        print(f"    {name} plan (splits) = {decode_plan(lanes, kh, S, h // kh, D, dtype)}, "
              f"rerun bit-identical: {torch.equal(got, again)}")
        if not torch.equal(got, again):
            failed.append(f"{name} {dtype}: a rerun differs")
        want = ref.flash_decode_ref(q, k, v, sp, p, window=window, cap=cap)
        peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
        bnd = bound_ms(nb(q, k, v, sp, p, got), 4 * lanes * h * S * D, peak)
        kern = lambda: flash_decode_cuda(q, k, v, sp, p, window=window, cap=cap)
        k_ms = time_ms(kern)
        p_ms = time_ms(lambda: ref.flash_decode_ref(q, k, v, sp, p, window=window, cap=cap))
        l_ms = lib = None
        if name == "flash_decode" and kh == h:
            qt = q[:, :, None, :]
            kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
            valid = ((sp >= 0) & (sp <= p[:, None]))[:, None, None, :]
            lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=valid)
            l_ms = time_ms(lib)
        rec = report(failed, name, dtype, (lanes, h, D, S, kh), got, want, tol, k_ms, p_ms, l_ms, bnd,
                     " (SDPA, boolean mask)" if l_ms is not None else "", graph=(kern, lib))
        if name == "flash_decode" and dtype == torch.bfloat16:
            records["flash_decode"] = rec

    # --- expert_ffn_q / expert_ffn: the decode step's capacity buffer
    d, Fh = cfg.d_model, cfg.moe.d_expert

    def quantize(w):   # per-output-channel symmetric int8, as ExpertStore makes it
        s = torch.clamp(w.float().abs().amax(dim=-2, keepdim=True), min=1e-8) / 127.0
        return torch.clamp(torch.round(w.float() / s), -127, 127).to(torch.int8), s

    # (slots, capacity, {weight format checked: the record its bf16 case
    # gives, or None}): "q" is expert_ffn_q over int8 weights, "bf16" expert_ffn
    ffn_cases = [(slots, _capacity(cfg, lanes, slots),
                  {"q": None, "bf16": "expert_ffn/decode"}),          # 5a's step
                 (int8_slots, _capacity(cfg, lanes, int8_slots), {"q": "expert_ffn_q"}),  # 5b
                 (hot, c_hot, {"q": None}),                           # 5c's hot int8 block
                 (slots, c_batch, {"q": "expert_ffn_q/batch"}),       # the int8 batch serve
                 (hot_b, c_tb, {"q": "expert_ffn_q/tiered-batch"}),   # the tiered batch's hot
                 # 5e's verify step over all E bf16 slots
                 (spec_slots, _capacity(cfg, lanes, spec_slots), {"bf16": "expert_ffn/spec"})]
    for E, C, recs in ffn_cases:
        for dtype, tol in ((torch.bfloat16, 5e-2), (torch.float32, 1e-4)):
            xe = rnd((E, C, d), 1.0, dtype)
            wi_q, wi_s = quantize(rnd((E, d, Fh), d ** -0.5, torch.float32))
            wo_q, wo_s = quantize(rnd((E, Fh, d), Fh ** -0.5, torch.float32))
            args = (xe, wi_q, wi_s, None, None, wo_q, wo_s)
            wi_f = ref.dequantize_ref(wi_q, wi_s).to(dtype)      # dequantised ahead of time
            wo_f = ref.dequantize_ref(wo_q, wo_s).to(dtype)

            def lib():
                return torch.bmm(F.gelu(torch.bmm(xe, wi_f), approximate="tanh"), wo_f)

            peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
            if "q" in recs:
                got = expert_ffn_q_cuda(*args, act=cfg.act)
                torch.cuda.synchronize()
                want = ref.expert_ffn_q_ref(*args, act=cfg.act)
                bnd = bound_ms(nb(xe, wi_q, wi_s, wo_q, wo_s, got), 2 * 2 * E * C * d * Fh, peak)
                kern = lambda: expert_ffn_q_cuda(*args, act=cfg.act)
                k_ms = time_ms(kern)
                p_ms = time_ms(lambda: ref.expert_ffn_q_ref(*args, act=cfg.act))
                rec = report(failed, "expert_ffn_q", dtype, (E, C, d, Fh), got, want, tol, k_ms,
                             p_ms, time_ms(lib), bnd, " (bmm+gelu+bmm, pre-dequantised)",
                             graph=(kern, lib))
                if dtype == torch.bfloat16 and recs["q"]:
                    records[recs["q"]] = rec
            if dtype == torch.bfloat16 and "bf16" in recs:
                wi, wo = wi_f, wo_f      # the same weights in bf16: expert_ffn at decode
                got = expert_ffn_cuda(xe, wi, None, wo, act=cfg.act)
                torch.cuda.synchronize()
                want = ref.expert_ffn_ref(xe, wi, None, wo, act=cfg.act)
                bnd = bound_ms(nb(xe, wi, wo, got), 2 * 2 * E * C * d * Fh, peak)
                kern = lambda: expert_ffn_cuda(xe, wi, None, wo, act=cfg.act)
                records[recs["bf16"]] = report(
                    failed, recs["bf16"], dtype, (E, C, d, Fh), got, want, tol,
                    time_ms(kern),
                    time_ms(lambda: ref.expert_ffn_ref(xe, wi, None, wo, act=cfg.act)),
                    time_ms(lib), bnd, " (bmm+gelu+bmm)", graph=(kern, lib))

    # --- sparsemax: the predictor's ring scores, invalid slots at -1e30
    z = rnd((lanes, HISTORY), 3.0, torch.float32)
    filled = torch.tensor([1, 2, 5, 17, 64, 100, 127, 128][:lanes], device=dev)
    z = torch.where(torch.arange(HISTORY, device=dev)[None, :] < filled[:, None], z,
                    torch.full_like(z, -1e30))
    records["sparsemax/ring"] = check_sparsemax(failed, "sparsemax/ring", z)
    if failed:
        raise SystemExit(f"chip_smoke: kernels disagree with their plain versions: {failed}")
    return records


def check_tier_paged_kernels(cfg, lanes: int, cache_len: int, page: int, warm: int, c_warm: int,
                             warm_b: int, c_tb: int):
    """Phase 2, tiered and paged decode shapes: expert_ffn_q4 on phase 5c's
    warm block [warm, c_warm, d], on [4, 640, d] and on the tiered batch
    serve's warm block [warm_b, c_tb, d], and flash_decode_paged
    over a full table that holds the keys of flash_decode's ring case, plus
    spilled entries with window, softcap and a lane with no valid key.
    Returns {kernel: record of the path's bf16 case}."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core.offload import quantize_stack_int4
    from repro_torch.kernels import ref
    from repro_torch.kernels.expert_gemm import expert_ffn_q4_cuda
    from repro_torch.kernels.flash_decode import (decode_plan, flash_decode_cuda,
                                                  flash_decode_paged_cuda)

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(432)

    def rnd(shape, scale, dtype):
        return (torch.randn(shape, generator=gen) * scale).to(dtype=dtype, device=dev)

    records, failed = {}, []

    # --- expert_ffn_q4: int4 weights, group 64, as the tiered store makes them
    d, Fh = cfg.d_model, cfg.moe.d_expert

    def quantize4(w):
        q, sc = quantize_stack_int4(w, "cpu", 64)
        return q.to(dev), sc.to(dev)

    for E, C in ((warm, c_warm), (4, 640), (warm_b, c_tb)):
        wi_q, wi_s = quantize4(torch.randn((E, d, Fh), generator=gen) * d ** -0.5)
        wo_q, wo_s = quantize4(torch.randn((E, Fh, d), generator=gen) * Fh ** -0.5)
        for dtype, tol in ((torch.bfloat16, 5e-2), (torch.float32, 1e-4)):
            xe = rnd((E, C, d), 1.0, dtype)
            args = (xe, wi_q, wi_s, None, None, wo_q, wo_s)
            got = expert_ffn_q4_cuda(*args, act=cfg.act)
            torch.cuda.synchronize()
            want = ref.expert_ffn_q4_ref(*args, act=cfg.act)
            wi_f = ref.dequantize_q4_ref(wi_q, wi_s, d).to(dtype)     # dequantised ahead of time
            wo_f = ref.dequantize_q4_ref(wo_q, wo_s, Fh).to(dtype)
            peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
            bnd = bound_ms(nb(xe, wi_q, wi_s, wo_q, wo_s, got), 2 * 2 * E * C * d * Fh, peak)
            kern = lambda: expert_ffn_q4_cuda(*args, act=cfg.act)

            def lib():
                return torch.bmm(F.gelu(torch.bmm(xe, wi_f), approximate="tanh"), wo_f)

            rec = report(failed, "expert_ffn_q4", dtype, (E, C, d, Fh), got, want, tol,
                         time_ms(kern),
                         time_ms(lambda: ref.expert_ffn_q4_ref(*args, act=cfg.act)),
                         time_ms(lib), bnd, " (bmm+gelu+bmm, pre-dequantised)",
                         graph=(kern, lib))
            if dtype == torch.bfloat16 and (E, C) == (warm, c_warm):
                records["expert_ffn_q4"] = rec
            if dtype == torch.bfloat16 and (E, C) == (warm_b, c_tb):
                records["expert_ffn_q4/tiered-batch"] = rec

    # --- flash_decode_paged: lane b's entry i is pool page b·Mp + i, so the
    # pool holds the [lanes, cache_len] ring case's keys, all valid at the
    # last position
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    Mp = cache_len // page
    for name, dtype, window, cap, tol in (
        ("flash_decode_paged", torch.bfloat16, 0, 0.0, 2e-2),
        ("flash_decode_paged", torch.float32, 0, 0.0, 1e-4),
        ("flash_decode_paged/spilled-w128c50", torch.bfloat16, 128, 50.0, 2e-2),
        ("flash_decode_paged/spilled-w128c50", torch.float32, 128, 50.0, 1e-4),
        # the split divides each lane's live keys: fewer live pages than
        # ranks, a lane whose only page is its last entry
        ("flash_decode_paged/split-edges", torch.bfloat16, 0, 0.0, 2e-2),
    ):
        q = rnd((lanes, H, D), 1.0, dtype)
        k = rnd((lanes, cache_len, K, D), 1.0, dtype)
        v = rnd((lanes, cache_len, K, D), 1.0, dtype)
        kp = torch.cat([k.reshape(lanes * Mp, page, K, D),
                        rnd((1, page, K, D), 1.0, dtype)]).contiguous()   # + the trash page
        vp = torch.cat([v.reshape(lanes * Mp, page, K, D),
                        rnd((1, page, K, D), 1.0, dtype)]).contiguous()
        table = np.arange(lanes * Mp, dtype=np.int32).reshape(lanes, Mp)
        pos = np.full((lanes,), cache_len - 1, np.int32)
        if window:
            table[1, ::3] = -1                           # spilled entries
            table[2, Mp // 2:] = -1                      # unallocated tail
            pos[2] = cache_len // 2 + 5                  # past its allocated pages
            table[3, :] = -1                             # no valid key at all
        if name.endswith("split-edges"):
            table[1, 1:] = -1                            # one live page
            pos[1] = page // 2
            table[2, :-1] = -1                           # its only page the last entry
            table[3, 2:] = -1                            # two live pages
        pt = torch.from_numpy(table).to(dev)
        p = torch.from_numpy(pos).to(dev)
        got = flash_decode_paged_cuda(q, kp, vp, pt, p, window=window, cap=cap)
        again = flash_decode_paged_cuda(q, kp, vp, pt, p, window=window, cap=cap)
        torch.cuda.synchronize()
        print(f"    {name} plan (splits) = "
              f"{decode_plan(lanes, K, Mp * page, H // K, D, dtype)}, "
              f"rerun bit-identical: {torch.equal(got, again)}")
        if not torch.equal(got, again):
            failed.append(f"{name} {dtype}: a rerun differs")
        want = ref.flash_decode_paged_ref(q, kp, vp, pt, p, window=window, cap=cap)
        # bytes: the K/V rows of every live page, plus the trash page once if
        # a lane has none; operations: a lane with none averages V over all
        # Mp entries, each naming the trash page
        lo = np.where(window > 0, pos - window + 1, 0)
        first = np.arange(Mp)[None, :] * page
        live = (table >= 0) & (first <= pos[:, None]) & (first + page - 1 >= lo[:, None])
        empty = int((live.sum(1) == 0).sum())
        kv_bytes = 2 * (int(live.sum()) + min(empty, 1)) * page * K * D * kp.element_size()
        op_keys = (int(live.sum()) + Mp * empty) * page
        peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
        bnd = bound_ms(kv_bytes + nb(q, pt, p, got), 4 * H * D * op_keys, peak)
        kern = lambda: flash_decode_paged_cuda(q, kp, vp, pt, p, window=window, cap=cap)
        k_ms = time_ms(kern)
        p_ms = time_ms(lambda: ref.flash_decode_paged_ref(q, kp, vp, pt, p, window=window,
                                                           cap=cap))
        rec = report(failed, name, dtype, (lanes, H, D, Mp, page), got, want, tol, k_ms, p_ms,
                     None, bnd, graph=(kern, None))
        if name == "flash_decode_paged":
            # no PyTorch call reads through a page table, so library_ms is
            # null; beside it, the same keys gathered into a ring (untimed):
            # SDPA on them, and the port's own flash_decode
            sp = torch.arange(cache_len, dtype=torch.int32, device=dev).expand(lanes, -1)
            sp = sp.contiguous()
            ring = flash_decode_cuda(q, k, v, sp, p)
            err = (ring.float() - got.float()).abs().max().item()
            qt = q[:, :, None, :]
            kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
            valid = ((sp >= 0) & (sp <= p[:, None]))[:, None, None, :]
            sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=valid)
            fd = lambda: flash_decode_cuda(q, k, v, sp, p)
            rec.update(gathered_sdpa_ms=time_ms(sdpa), gathered_sdpa_device_ms=graph_ms(sdpa),
                       gathered_flash_decode_ms=time_ms(fd),
                       gathered_flash_decode_device_ms=graph_ms(fd))
            ratio = (rec["device_ms"] / rec["gathered_flash_decode_device_ms"]
                     if rec["device_ms"] and rec["gathered_flash_decode_device_ms"] else None)
            print(f"    (the same keys gathered into a ring: SDPA {rec['gathered_sdpa_ms']:.4f} ms, "
                  f"device {rec['gathered_sdpa_device_ms']}; the port's flash_decode "
                  f"{rec['gathered_flash_decode_ms']:.4f} ms, device "
                  f"{rec['gathered_flash_decode_device_ms']}; paged / ring device "
                  f"{'null' if ratio is None else f'{ratio:.3f}'}; max_abs_diff to paged "
                  f"{err:.3e})")
            if err > tol:
                failed.append(f"{name} {dtype}: paged and ring kernels disagree")
            if dtype == torch.bfloat16:
                records["flash_decode_paged"] = rec
    if failed:
        raise SystemExit(f"chip_smoke: kernels disagree with their plain versions: {failed}")
    return records


DECODE_KERNELS = {"bf16": ("flash_decode", "expert_ffn", "sparsemax"),
                  "bf16-async": ("flash_decode", "expert_ffn", "sparsemax"),
                  "int8": ("flash_decode", "expert_ffn_q", "sparsemax"),
                  "tiered-paged": ("flash_decode_paged", "expert_ffn_q", "expert_ffn_q4",
                                   "sparsemax")}


def decode_runs(cfg, slots: int, int8_slots: int, tier_slots: int, cache_len: int):
    """Phase 5's four runs: (name, engine kwargs, generate kwargs); the last
    is 5a again through the async prefetch pipeline."""
    from repro_torch.configs.base import TierConfig
    from repro_torch.core.residency import PagedKVConfig

    tier = TierConfig(int4_slots=True, tier_split=0.5, group_size=64)
    paged = PagedKVConfig(page_size=16, kv_pages=256, max_seq=cache_len)
    return (("bf16", dict(slots_per_layer=slots), {}),
            ("int8", dict(slots_per_layer=int8_slots, quantized_slots=True), {}),
            ("tiered-paged", dict(slots_per_layer=tier_slots, quantized_slots=True, tier=tier),
             dict(paged=paged)),
            ("bf16-async", dict(slots_per_layer=slots, prefetch_depth=2, staging_buffers=2), {}))


def decode_path(cfg, params, hp, lanes: int, steps: int, cache_len: int, runs, tiers):
    """Phase 5: SiDADecodeEngine.generate at full width on each run of
    `decode_runs`; returns ({run name: launch counts}, {run name: ms/step}). `tiers` is the (S8, S4)
    phase 2 timed the tiered kernels at, which the tiered store must have."""
    import numpy as np
    import torch

    from repro_torch.core.decode_engine import SiDADecodeEngine
    from repro_torch.core.offload import nbytes
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_leaves

    start = np.random.default_rng(0).integers(0, cfg.vocab_size, (lanes,)).astype(np.int32)
    out_counts, ms_per_step = {}, {}
    for name, kw, gen_kw in runs:
        t0 = time.perf_counter()
        eng = SiDADecodeEngine(cfg, params, hp, device="cuda", **kw)
        setup = time.perf_counter() - t0
        torch.cuda.synchronize()
        ops.reset_launches()
        toks, m = eng.generate(start, steps=steps, cache_len=cache_len, **gen_kw)
        counts = ops.launches()
        st = eng.store.stats
        dev_bytes = sum(nbytes(x) for x in tree_leaves(eng.store.serve_params))
        print(f"  ({name}) slots={kw['slots_per_layer']} (S8={eng.store.S8} S4={eng.store.S4}) "
              f"lanes={lanes} steps={steps} cache_len={cache_len} setup_s={setup:.2f}")
        step_ms = 1e3 * np.asarray(m.step_s)
        print(f"    tok_s={m.tok_s:.1f} ms_per_step={1e3 * m.wall_s / m.steps:.3f} "
              f"step_ms_p50={np.percentile(step_ms, 50):.3f} "
              f"step_ms_p99={np.percentile(step_ms, 99):.3f} "
              f"wall_s={m.wall_s:.4f} tokens={m.tokens} stall_s={m.stall_s:.4f} "
              f"graph_steps={m.graph_steps}")
        if eng.prefetcher is not None:
            ps = eng.prefetcher.stats
            print(f"    prefetch uploads={ps.uploads} stolen={ps.stolen} stall_s={ps.stall_s:.4f} "
                  f"transfer_s={ps.transfer_s:.4f} overlap_s={ps.overlap_s:.4f} "
                  f"staging_waits={ps.staging_waits}")
        print(f"    loads first_step={m.loads_per_step[0]} last_step={m.loads_per_step[-1]} "
              f"total={st.loads} hits={st.hits} evictions={st.evictions} "
              f"promotions={st.promotions} demotions={st.demotions} bytes_h2d={st.bytes_h2d}")
        print(f"    device_memory_bytes={dev_bytes} expert_device_bytes={eng.store.device_bytes()} "
              f"expert_slot_bytes={eng.store.expert_slot_bytes()}")
        if eng.kv_pool is not None:
            pool = eng.kv_pool
            print(f"    kv pages allocated={pool.stats.allocs} resident={pool.resident_pages()} "
                  f"spills={pool.stats.spills} page_ins={pool.stats.page_ins} "
                  f"kv_pool_bytes={pool.kv_pool_bytes()} kv_capacity_bytes={pool.capacity_bytes()}")
        print(f"    launches {json.dumps(counts)}")
        if "tier" in kw and (eng.store.S8, eng.store.S4) != tiers:
            raise SystemExit(f"chip_smoke: the tiered store has (S8, S4) = "
                             f"{(eng.store.S8, eng.store.S4)}, phase 2 checked {tiers}")
        if toks.shape != (lanes, steps) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise SystemExit(f"chip_smoke: decode ({name}) emitted out-of-vocab tokens")
        idle = [k for k in DECODE_KERNELS[name] if counts[k] == 0]
        if idle:
            raise SystemExit(f"chip_smoke: kernels never launched on the {name} decode path: {idle}")
        t1 = time.perf_counter()
        decode_profile(eng, start, 16, cache_len, gen_kw)
        print(f"    (profile {time.perf_counter() - t1:.1f} s)")
        out_counts[name] = counts
        ms_per_step[name] = 1e3 * m.wall_s / m.steps
        eng.close()
        del eng
    return out_counts, ms_per_step


def decode_profile(eng, start, steps: int, cache_len: int, gen_kw):
    """Phase 5, device busy share over one generate (torch.profiler, device
    activity only, as phase 3b)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.generate(start, steps=steps, cache_len=cache_len, **gen_kw)
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us, e.key, e.count))
    busy_s = sum(r[0] for r in rows) / 1e6
    if busy_s <= 0:
        print("    device busy share: not measured (the profiler recorded no device time)")
        return
    print(f"    profiled generate ({steps} steps): wall_s={wall:.4f} device_busy_s={busy_s:.4f} "
          f"device_idle_share={max(0.0, 1 - busy_s / wall):.3f}")
    top = sorted(rows, reverse=True)
    for dev_us, key, count in top[:6]:
        print(f"      {dev_us / 1e3:9.3f} ms  {count:6d}x  {key[:90]}")
    for dev_us, key, count in top[6:]:   # decode attention and copies, wherever they rank
        if "flash_decode" in key or "Memcpy HtoD" in key:
            print(f"      {dev_us / 1e3:9.3f} ms  {count:6d}x  {key[:90]}")


def decode_card_vs_cpu(cfg, lanes: int, slots: int, int8_slots: int, dtype: str):
    """Phase 6: greedy decode on the card and on the CPU, same weights, in
    `dtype`. fp32: the greedy tokens identical and the logits within
    1e-3 * max(1, max|logit|). bf16: each bf16 kernel is held to its plain
    version at 5e-2 (phase 2), so the fixed table's logits are gated at
    5e-2 * max(1, max|logit|); the greedy tokens' agreement is printed and
    not gated, because a bf16 near-tie can flip an argmax and every later
    token with it."""
    import numpy as np
    import torch

    from repro_torch.core.decode_engine import SiDADecodeEngine
    from repro_torch.core.hash_table import HashTable
    from repro_torch.models.transformer import decode_step, init_cache, n_moe_layers

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype=dtype)
    params, hp = seeded_model(cfg2)
    start = np.random.default_rng(0).integers(0, cfg2.vocab_size, (lanes,)).astype(np.int32)
    L, steps, cache_len = n_moe_layers(cfg2), 40, 32
    exact = dtype == "float32"
    for name, n_slots, kw in (("fp", slots, {}), ("int8", int8_slots, {"quantized_slots": True})):
        eng = {dev: SiDADecodeEngine(cfg2, params, hp, slots_per_layer=n_slots, device=dev, **kw)
               for dev in ("cuda", "cpu")}
        # one fixed table of experts that fit the budget, prepared in both
        # stores before any generate (a bf16 generate may emit other tokens on
        # each device, and then its slots hold other experts): decode_step
        # logits from a fresh cache
        rng = np.random.default_rng(7)
        ids = rng.integers(0, n_slots, (L, lanes, 1, 1)).astype(np.int32)
        w = np.ones((L, lanes, 1, 1), np.float32)
        logits = {}
        with torch.inference_mode():
            for dev, e in eng.items():
                trans = e.store.prepare(HashTable(0, ids, w))
                slot_ids, sw = e.store.translate_device(torch.as_tensor(ids, device=dev),
                                                        torch.as_tensor(w, device=dev), trans)
                cache = init_cache(cfg2, lanes, cache_len, device=dev)
                lg, _ = decode_step(e.store.serve_params, cache, torch.as_tensor(start, device=dev),
                                    cfg2, routing_override=(slot_ids[:, :, 0], sw[:, :, 0]))
                logits[dev] = lg.float().cpu().numpy()[:, :cfg2.vocab_size]
        out = {dev: e.generate(start, steps=steps, cache_len=cache_len)[0] for dev, e in eng.items()}
        same = float((out["cuda"] == out["cpu"]).mean())
        err = float(np.abs(logits["cuda"] - logits["cpu"]).max())
        scale = float(np.abs(logits["cpu"]).max())
        tol = (1e-3 if exact else 5e-2) * max(1.0, scale)
        need = "need 1.0" if exact else "not gated: bf16 near-ties can flip an argmax"
        print(f"  ({name} slots={n_slots}) {dtype} n_layers=2 lanes={lanes} steps={steps} "
              f"cache_len={cache_len}: greedy tokens identical={same:.6f} ({need}); "
              f"decode_step logits max_abs_err={err:.3e} tol={tol:.3e} max|logit|={scale:.3f}")
        if ((exact and same < 1.0) or not err <= tol or not np.isfinite(logits["cuda"]).all()):
            raise SystemExit(f"chip_smoke: card and CPU disagree on the {name} {dtype} decode path")


def tiered_paged_card_vs_cpu(cfg, lanes: int, tier_slots: int):
    """Phase 6c: greedy decode on tiered slots over a paged pool, on the card
    and on the CPU, same weights."""
    import numpy as np
    import torch

    from repro_torch.configs.base import TierConfig
    from repro_torch.core.decode_engine import SiDADecodeEngine
    from repro_torch.core.residency import KVPagePool, PagedKVConfig
    from repro_torch.models.transformer import decode_step, n_moe_layers

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params, hp = seeded_model(cfg2)
    start = np.random.default_rng(0).integers(0, cfg2.vocab_size, (lanes,)).astype(np.int32)
    L, steps = n_moe_layers(cfg2), 40
    tier = TierConfig(int4_slots=True, tier_split=0.5, group_size=64)
    paged = PagedKVConfig(page_size=8, kv_pages=48)
    where = {"card": "cuda", "cpu": "cpu"}
    eng = {k: SiDADecodeEngine(cfg2, params, hp, slots_per_layer=tier_slots, device=dev,
                               quantized_slots=True, tier=tier) for k, dev in where.items()}
    out, loads = {}, {}
    for k, e in eng.items():
        out[k], m = e.generate(start, steps=steps, paged=paged)
        st = e.store.stats
        loads[k] = (m.loads_per_step, st.loads, st.promotions, st.demotions, st.evictions)
    same = float((out["card"] == out["cpu"]).mean())
    st = eng["card"].store
    # one fixed table over both tiers' slots: paged decode_step logits from a fresh pool
    rng = np.random.default_rng(7)
    ids = rng.integers(0, st.S8 + st.S4, (L, lanes, 1)).astype(np.int32)
    w = np.ones((L, lanes, 1), np.float32)
    logits = {}
    with torch.inference_mode():
        for k, e in eng.items():
            dev = where[k]
            pool = KVPagePool(cfg2, paged, lanes, device=dev)
            cache = pool.init_cache()
            for b in range(lanes):
                cache = pool.ensure(cache, b, 1)
            cache["page_table"] = pool.device_table()
            lg, _ = decode_step(e.store.serve_params, cache, torch.as_tensor(start, device=dev),
                                cfg2, routing_override=(torch.as_tensor(ids, device=dev),
                                                        torch.as_tensor(w, device=dev)))
            logits[k] = lg.float().cpu().numpy()[:, :cfg2.vocab_size]
    err = float(np.abs(logits["card"] - logits["cpu"]).max())
    scale = float(np.abs(logits["cpu"]).max())
    tol = 1e-3 * max(1.0, scale)
    c = loads["card"]
    print(f"  (tiered-paged slots={tier_slots}: S8={st.S8} S4={st.S4}) fp32 n_layers=2 "
          f"lanes={lanes} steps={steps} page=8 kv_pages=48: greedy tokens identical={same:.6f} "
          f"(need 1.0); loads={c[1]} promotions={c[2]} demotions={c[3]} evictions={c[4]} "
          f"identical on card and CPU={loads['card'] == loads['cpu']}; decode_step logits "
          f"max_abs_err={err:.3e} tol={tol:.3e} max|logit|={scale:.3f}")
    if (same < 1.0 or loads["card"] != loads["cpu"] or not err <= tol
            or not np.isfinite(logits["card"]).all()):
        raise SystemExit("chip_smoke: card and CPU disagree on the tiered paged decode path")


SPEC_KERNELS = {"spec-bf16": ("flash_decode", "expert_ffn", "sparsemax"),
                "spec-tiered-paged": ("flash_decode_paged", "expert_ffn_q", "expert_ffn_q4",
                                      "sparsemax"),
                "spec-async": ("flash_decode", "expert_ffn", "sparsemax")}


def spec_runs(cfg, tier_slots: int, cache_len: int):
    """Phase 5e's three runs: (name, engine kwargs, generate kwargs). (i) all
    E experts on bf16 slots, (ii) 5c's tiers over 5c's paged pool, (iii)
    (i) through the async prefetch pipeline."""
    from repro_torch.configs.base import TierConfig
    from repro_torch.core.residency import PagedKVConfig

    E = cfg.moe.num_experts
    tier = TierConfig(int4_slots=True, tier_split=0.5, group_size=64)
    paged = PagedKVConfig(page_size=16, kv_pages=256, max_seq=cache_len)
    return (("spec-bf16", dict(slots_per_layer=E), {}),
            ("spec-tiered-paged", dict(slots_per_layer=tier_slots, quantized_slots=True,
                                       tier=tier), dict(paged=paged)),
            ("spec-async", dict(slots_per_layer=E, prefetch_depth=2, staging_buffers=2), {}))


def with_draft_head(cfg, hp):
    """The served predictor with a draft head from seed 7 (random, untrained)."""
    import torch

    from repro_torch.core.hash_fn import init_draft_head

    return init_draft_head(torch.Generator().manual_seed(7), hp, cfg.d_model)


def spec_path(cfg, params, hp, lanes: int, steps: int, cache_len: int, K: int, runs, tiers):
    """Phase 5e: speculative decode at full width, `SiDADecodeEngine(spec_mode=
    "draft", spec_k=K).generate` on each run of `spec_runs`, beside a vanilla
    run on all E bf16 slots from the same start tokens. Gates: the all-
    resident spec tokens equal the vanilla ones, the async run's equal the
    sync run's, every kernel of a run launched; then the directed rollback
    on the spec-bf16 engine. Returns {run name: launch counts}."""
    import numpy as np
    import torch

    from repro_torch.core.decode_engine import SiDADecodeEngine
    from repro_torch.core.offload import nbytes
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_leaves

    E = cfg.moe.num_experts
    start = np.random.default_rng(0).integers(0, cfg.vocab_size, (lanes,)).astype(np.int32)
    van = SiDADecodeEngine(cfg, params, hp, slots_per_layer=E, device="cuda")
    van_toks, vm = van.generate(start, steps=steps, cache_len=cache_len)
    van.close()
    print(f"  (vanilla) slots={E} lanes={lanes} steps={steps} tok_s={vm.tok_s:.1f} "
          f"ms_per_step={1e3 * vm.wall_s / vm.steps:.3f} loads first_step={vm.loads_per_step[0]} "
          f"last_step={vm.loads_per_step[-1]}")
    out_counts, toks_of = {}, {}
    for name, kw, gen_kw in runs:
        t0 = time.perf_counter()
        eng = SiDADecodeEngine(cfg, params, hp, device="cuda", spec_mode="draft", spec_k=K, **kw)
        setup = time.perf_counter() - t0
        torch.cuda.synchronize()
        ops.reset_launches()
        toks, m = eng.generate(start, steps=steps, cache_len=cache_len, **gen_kw)
        counts = ops.launches()
        toks_of[name] = toks
        st = eng.store.stats
        dev_bytes = sum(nbytes(x) for x in tree_leaves(eng.store.serve_params))
        print(f"  ({name}) spec_k={K} slots={kw['slots_per_layer']} (S8={eng.store.S8} "
              f"S4={eng.store.S4}) lanes={lanes} tokens_a_lane={steps} cache_len={cache_len} "
              f"setup_s={setup:.2f}")
        print(f"    tok_s={m.tok_s:.1f} ms_per_block={1e3 * m.wall_s / m.steps:.3f} "
              f"ms_per_emitted_token={1e3 * m.wall_s * lanes / m.tokens:.3f} blocks={m.steps} "
              f"tokens={m.tokens} proposed={m.proposed} acceptance_rate={m.acceptance_rate:.4f} "
              f"mean_accepted={m.mean_accepted:.4f} wall_s={m.wall_s:.4f} stall_s={m.stall_s:.4f}")
        if eng.prefetcher is not None:
            ps = eng.prefetcher.stats
            print(f"    prefetch uploads={ps.uploads} stolen={ps.stolen} stall_s={ps.stall_s:.4f} "
                  f"transfer_s={ps.transfer_s:.4f} overlap_s={ps.overlap_s:.4f}")
        print(f"    loads first_block={m.loads_per_step[0]} last_block={m.loads_per_step[-1]} "
              f"total={st.loads} hits={st.hits} evictions={st.evictions} "
              f"promotions={st.promotions} demotions={st.demotions} bytes_h2d={st.bytes_h2d}")
        # the draft head's fp32 product casts the bf16 table on each call:
        # no second copy of the embedding is kept on the device
        print(f"    device_memory_bytes={dev_bytes} expert_device_bytes={eng.store.device_bytes()} "
              f"draft_head_bytes={nbytes(eng.hash_params['draft_proj'])} "
              f"fp32_embed_copy_bytes=0 (cast a call: {4 * eng.embed_table.numel()} bytes "
              f"temporary)")
        if eng.kv_pool is not None:
            pool = eng.kv_pool
            print(f"    kv pages allocated={pool.stats.allocs} resident={pool.resident_pages()} "
                  f"spills={pool.stats.spills} page_ins={pool.stats.page_ins} "
                  f"kv_pool_bytes={pool.kv_pool_bytes()}")
        print(f"    launches {json.dumps(counts)}")
        if "tier" in kw and (eng.store.S8, eng.store.S4) != tiers:
            raise SystemExit(f"chip_smoke: the tiered store has (S8, S4) = "
                             f"{(eng.store.S8, eng.store.S4)}, phase 2 checked {tiers}")
        if toks.shape != (lanes, steps) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise SystemExit(f"chip_smoke: spec decode ({name}) emitted out-of-vocab tokens")
        if m.tokens != lanes * steps or m.proposed != lanes * K * m.steps:
            raise SystemExit(f"chip_smoke: spec decode ({name}) miscounted its tokens")
        idle = [k for k in SPEC_KERNELS[name] if counts[k] == 0]
        if idle:
            raise SystemExit(f"chip_smoke: kernels never launched on the {name} path: {idle}")
        same = {"spec-bf16": ("vanilla", van_toks), "spec-async": ("spec-bf16",
                                                                   toks_of.get("spec-bf16"))}
        if name in same:
            other, want = same[name]
            ok = bool((toks == want).all())
            print(f"    tokens identical to {other}: {ok} (need True; "
                  f"{float((toks == want).mean()):.6f} of {toks.size})")
            if not ok:
                raise SystemExit(f"chip_smoke: {name} tokens differ from {other}'s")
        if name == "spec-bf16":
            for paged in (None, runs[1][2]["paged"]):
                directed_rollback(eng, cfg, lanes, K, cache_len, paged)
        out_counts[name] = counts
        eng.close()
        del eng
    return out_counts


def directed_rollback(eng, cfg, lanes: int, K: int, cache_len: int, paged, j: int = 2,
                      prefix: int = 14):
    """Phase 5e, directed rollback: from a cache `prefix` positions deep (a
    paged block then crosses a page boundary), a block whose drafts are the
    model's own greedy tokens, with the draft at column j + 1 wrong on the
    odd lanes. Gates: n_acc = j + 1 there and K elsewhere, the outputs the
    greedy tokens, and every layer's K/V and `pos` bit-equal to running only
    each lane's accepted prefix (j + 1 or K plain decode_steps)."""
    import numpy as np
    import torch

    from repro_torch.core.decode_engine import hash_state_init
    from repro_torch.core.hash_table import HashTable
    from repro_torch.models.transformer import decode_step, verify_step

    params = eng.store.serve_params

    def route(tokens, hstate):
        """One position's routing from the predictor, as the vanilla loop
        makes it: (slot ids, weights, new predictor state)."""
        ids, alpha, hstate = eng._predict_step(tokens, hstate)
        ids, alpha = ids[:, :, None, :], alpha[:, :, None, :]
        trans = eng.store.prepare(HashTable(0, ids.cpu().numpy(), alpha.cpu().numpy()))
        slot_ids, w = eng.store.translate_device(ids, alpha, trans)
        return slot_ids[:, :, 0], w[:, :, 0], hstate

    def kv(cache):
        return {(s, n): t.clone() for s in cache if s.startswith("sub")
                for n, t in cache[s].items()}

    def step(cache, tokens, ro, pool):
        if pool is not None:
            cache = eng._page_tick(pool, cache, cache["pos"].cpu().numpy().astype(np.int64) + 1)
        lg, cache = decode_step(params, cache, tokens, cfg, routing_override=ro)
        if pool is not None:
            pool.unpin_all()
        return torch.argmax(lg, dim=-1).to(torch.int32), cache

    with torch.inference_mode():
        cache, pool = eng._make_cache(lanes, cache_len, paged)
        hstate = hash_state_init(eng.hash_params, lanes)
        tok = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab_size, (lanes,)),
                              dtype=torch.int32, device=eng.device)
        for _ in range(prefix):
            sid, w, hstate = route(tok, hstate)
            tok, cache = step(cache, tok, (sid, w), pool)
        if pool is not None:   # the block's pages, allocated and installed up front
            cache = eng._page_tick(pool, cache, np.full((lanes,), prefix + K, np.int64),
                                   extra_span=K - 1)
        pos0 = cache["pos"].clone()
        start_kv = kv(cache)
        # the plain run: K steps, K/V kept after j + 1 of them
        blk, ros = [tok], []
        for i in range(K):
            sid, w, hstate = route(blk[-1], hstate)
            ros.append((sid, w))
            nxt, cache = step(cache, blk[-1], ros[-1], None)
            blk.append(nxt)
            if i == j:
                after_j = kv(cache)
        plain_kv, plain_pos = kv(cache), cache["pos"].clone()
        # back to the block's start, then the block with wrong drafts
        for (s, n), t in start_kv.items():
            cache[s][n].copy_(t)
        cache["pos"] = pos0
        wrong = torch.arange(lanes, device=eng.device) % 2 == 1
        tokens = torch.stack(blk[:K], dim=1)
        tokens[:, j + 1] = torch.where(wrong, (tokens[:, j + 1] + 1) % cfg.vocab_size,
                                       tokens[:, j + 1])
        out, n_acc, _, cache = verify_step(
            params, cache, tokens, cfg,
            routing_override=(torch.stack([r[0] for r in ros]), torch.stack([r[1] for r in ros])))
        torch.cuda.synchronize()
        if pool is not None:
            pool.unpin_all()
        want_n = torch.where(wrong, j + 1, K).to(torch.int32)
        greedy = torch.stack(blk[1:], dim=1)
        out_ok = all(bool((out[b, :int(n_acc[b])] == greedy[b, :int(n_acc[b])]).all())
                     for b in range(lanes))
        want_pos = torch.where(wrong, pos0 + j + 1, plain_pos)
        kv_ok = True
        for (s, n), t in kv(cache).items():
            want = plain_kv[(s, n)].clone()
            if pool is None:
                want[:, wrong] = after_j[(s, n)][:, wrong]
            else:
                for b in torch.nonzero(wrong).flatten().tolist():
                    pages = torch.as_tensor(pool.table[b][pool.table[b] >= 0], device=t.device)
                    want[:, pages.long()] = after_j[(s, n)][:, pages.long()]
            kv_ok &= torch.equal(t, want)
        ok = (torch.equal(n_acc, want_n) and torch.equal(cache["pos"], want_pos) and kv_ok
              and out_ok)
        print(f"  (directed rollback, {'paged' if pool else 'ring'}) K={K} wrong draft at "
              f"column {j + 1} on lanes {torch.nonzero(wrong).flatten().tolist()}, block at "
              f"positions {int(pos0[0])}..{int(pos0[0]) + K - 1}: n_acc={n_acc.tolist()} "
              f"(need {want_n.tolist()}), outputs the greedy tokens={out_ok}, K/V and pos "
              f"bit-equal to the accepted prefix alone={kv_ok and torch.equal(cache['pos'], want_pos)}")
        if not ok:
            raise SystemExit(f"chip_smoke: directed rollback failed "
                             f"({'paged' if pool else 'ring'})")


def spec_card_vs_cpu(cfg, lanes: int, slots: int, tier_slots: int, K: int):
    """Phase 6d: speculative decode on the card and on the CPU, fp32, 2
    layers, same weights (with the seeded draft head): a ring (sync and
    through the async pipeline) and tiered slots over a paged pool. Gate:
    the greedy tokens, the per-block acceptance and loads, and the store's
    counters identical."""
    import numpy as np

    from repro_torch.configs.base import TierConfig
    from repro_torch.core.decode_engine import SiDADecodeEngine
    from repro_torch.core.residency import PagedKVConfig

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32")
    params, hp = seeded_model(cfg2)
    hp = with_draft_head(cfg2, hp)
    start = np.random.default_rng(0).integers(0, cfg2.vocab_size, (lanes,)).astype(np.int32)
    steps, cache_len = 16, 16     # the ring wraps within the run
    tier = TierConfig(int4_slots=True, tier_split=0.5, group_size=64)
    runs = (("ring", dict(slots_per_layer=slots), {}),
            ("ring-async", dict(slots_per_layer=slots, prefetch_depth=2, staging_buffers=2), {}),
            ("tiered-paged", dict(slots_per_layer=tier_slots, quantized_slots=True, tier=tier),
             dict(paged=PagedKVConfig(page_size=8, kv_pages=4 * lanes, max_seq=32))))
    for name, kw, gen_kw in runs:
        got = {}
        for dev in ("cuda", "cpu"):
            eng = SiDADecodeEngine(cfg2, params, hp, device=dev, spec_mode="draft", spec_k=K, **kw)
            toks, m = eng.generate(start, steps=steps, cache_len=cache_len, **gen_kw)
            st = eng.store.stats
            got[dev] = (toks, m.accepted_per_step, m.loads_per_step, m.steps,
                        (st.loads, st.hits, st.evictions, st.promotions, st.demotions,
                         st.bytes_h2d))
            eng.close()
        c, h = got["cuda"], got["cpu"]
        same = [bool((c[0] == h[0]).all()), c[1] == h[1], c[2] == h[2], c[3:] == h[3:]]
        print(f"  ({name}) fp32 n_layers=2 lanes={lanes} spec_k={K} tokens_a_lane={steps} "
              f"blocks={c[3]} mean_accepted={float(np.mean(c[1])):.4f}: greedy tokens, "
              f"accepted per block, loads per block, store counters identical on card and "
              f"CPU = {same} (need all True); loads={c[4][0]} evictions={c[4][2]} "
              f"promotions={c[4][3]}")
        if not all(same):
            raise SystemExit(f"chip_smoke: card and CPU disagree on the {name} spec decode path")


# ---------------------------------------------------------------------------
# phase 9: the request server
# ---------------------------------------------------------------------------

SERVER_KERNELS = {"9a": ("expert_ffn", "sparsemax", "flash_prefill", "flash_decode"),
                  "9b": ("expert_ffn", "sparsemax", "flash_prefill", "flash_decode"),
                  "9c": ("expert_ffn_q", "expert_ffn_q4", "sparsemax", "flash_prefill",
                         "flash_decode_paged"),
                  "9d": ("expert_ffn", "sparsemax", "flash_prefill", "flash_decode")}
SERVER_BUCKETS = (64, 128, 256)


def server_runs(cfg, slots: int, tier_slots: int, K: int, cache_len: int):
    """Phase 9's runs: (name, RequestServer kwargs, long prompt length or 0).
    9a a ring over bf16 slots, 9b 9a through the async pipeline, 9c hot int8
    / warm int4 slots (5c's split) over a paged pool with chunked prefill,
    9d speculative decode over every expert on bf16 slots."""
    from repro_torch.configs.base import TierConfig
    from repro_torch.core.residency import PagedKVConfig

    tier = TierConfig(int4_slots=True, tier_split=0.5, group_size=64)
    base = dict(max_lanes=8, max_prefill_batch=8, buckets=SERVER_BUCKETS)
    ring = dict(base, cache_len=cache_len)
    paged = PagedKVConfig(page_size=16, kv_pages=512, max_seq=2048, prefill_chunk=256)
    return (("9a", dict(ring, slots_per_layer=slots), 0),
            ("9b", dict(ring, slots_per_layer=slots, prefetch_depth=2, staging_buffers=2), 0),
            ("9c", dict(base, slots_per_layer=tier_slots, quantized_slots=True, tier=tier,
                        paged=paged), 6 * paged.prefill_chunk),
            ("9d", dict(ring, slots_per_layer=cfg.moe.num_experts, spec_mode="draft",
                        spec_k=K), 0))


def server_requests(cfg, n: int, rate: float, prompts, new, long_len: int = 0, seed: int = 0):
    """`poisson_requests(np.random.default_rng(seed), ...)`, plus one prompt
    of `long_len` tokens (seed + 1) that arrives with the third request."""
    import numpy as np

    from repro_torch.serving import Request, poisson_requests

    reqs = poisson_requests(np.random.default_rng(seed), n, rate_rps=rate,
                            vocab_size=cfg.vocab_size, prompt_len_range=prompts,
                            max_new_range=new)
    if long_len:
        prompt = np.random.default_rng(seed + 1).integers(0, cfg.vocab_size, (long_len,))
        reqs.append(Request(rid=n, prompt=prompt.astype(np.int32), max_new_tokens=new[0],
                            arrival_s=reqs[min(2, n - 1)].arrival_s))
    return reqs


def check_served(srv, reqs, cfg, name: str) -> None:
    """Every request completed with its whole budget of in-vocab tokens, none
    rejected."""
    done = {r.rid: r for r in srv.completed}
    bad = [r.rid for r in reqs if r.rid not in done or len(done[r.rid].generated)
           != r.max_new_tokens or min(done[r.rid].generated) < 0
           or max(done[r.rid].generated) >= cfg.vocab_size]
    if srv.rejected or bad:
        raise SystemExit(f"chip_smoke: server {name}: rejected "
                         f"{[(r.rid, r.reject_reason) for r in srv.rejected]}, incomplete or "
                         f"out-of-vocab {bad}")


def server_path(cfg, params, hp, runs, ms_5a: float):
    """Phase 9: `RequestServer.run` at full width on each run of
    `server_runs`, 24 Poisson requests at 8 req/s in real time (prompts
    16-256 tokens, 8-64 new tokens); 9c adds one 1536-token prompt that
    streams through the pages in six 256-token chunks. Prints each run's
    `summary()`, ms a decode tick beside phase 5a's ms/step, and each
    kernel's launches; gates completion, 9c's chunks and every kernel of a
    run's path launched. Returns ({run name: launch counts}, {run name: ms
    a decode tick})."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving import RequestServer

    keys = ("completed", "rejected", "throughput_tok_s", "decode_tok_s", "p50_latency_s",
            "p95_latency_s", "p50_ttft_s", "p95_ttft_s", "cache_hit_rate", "h2d_mb",
            "upload_stall_s", "upload_overlap_s", "max_queue_depth", "spec_acceptance_rate",
            "spec_accepted_per_step")
    out_counts, tick_ms_of = {}, {}
    for name, kw, long_len in runs:
        reqs = server_requests(cfg, 24, 8.0, (16, 256), (8, 64), long_len)
        hp_run = with_draft_head(cfg, hp) if kw.get("spec_mode") == "draft" else hp
        t0 = time.perf_counter()
        srv = RequestServer(cfg, params, hp_run, device="cuda", **kw)
        setup = time.perf_counter() - t0
        # the loop's wall split: prefill batches and chunks timed to the end
        # of their device work (host clock), decode ticks by the server's
        # own timer
        spans = {"prefill": 0.0, "chunks": 0.0, "hash_prefill": 0.0}

        def timed(fn, key):
            def call(*a, **k):
                t1 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    torch.cuda.synchronize()
                    spans[key] += time.perf_counter() - t1
            return call

        srv._prefill_and_join = timed(srv._prefill_and_join, "prefill")
        srv._chunk_tick = timed(srv._chunk_tick, "chunks")
        srv._hash_prefill = timed(srv._hash_prefill, "hash_prefill")   # inside both
        torch.cuda.synchronize()
        ops.reset_launches()
        try:
            srv.run(reqs, realtime=True)
        finally:
            srv.close()
        counts = ops.launches()
        s = srv.summary()
        t = srv.telemetry
        steps = t.counter("decode_steps").value
        tick_ms = 1e3 * t.counter("decode_tick_s_total").value / max(steps, 1)
        print(f"  ({name}) {', '.join(f'{k}={v}' for k, v in kw.items() if k != 'buckets')} "
              f"requests={len(reqs)} setup_s={setup:.2f} wall_s={t.wall_s():.3f}")
        print("    " + " ".join(f"{k}={s[k]:.4f}" for k in keys))
        ticks_s = t.counter("decode_tick_s_total").value
        print(f"    wall split: decode_ticks_s={ticks_s:.3f} prefill_s={spans['prefill']:.3f} "
              f"chunks_s={spans['chunks']:.3f} rest_s="
              f"{t.wall_s() - ticks_s - spans['prefill'] - spans['chunks']:.3f} (arrival waits, "
              f"scheduling, the loop's idle polls); the predictor's prompt pass "
              f"hash_prefill_s={spans['hash_prefill']:.3f} of prefill_s and chunks_s")
        print(f"    decode_steps={int(steps)} ms_per_decode_tick={tick_ms:.3f} "
              f"(phase 5a ms_per_step={ms_5a:.3f}) prefill_batches="
              f"{int(t.counter('prefill_batches').value)} prefill_chunks="
              f"{int(t.counter('prefill_chunks').value)} tokens_generated="
              f"{int(t.counter('tokens_generated').value)}")
        st = srv.store.stats
        print(f"    store loads={st.loads} hits={st.hits} evictions={st.evictions} "
              f"promotions={st.promotions} demotions={st.demotions} bytes_h2d={st.bytes_h2d}")
        if srv.residency is not None:
            print(f"    residency {json.dumps(srv.residency.summary())}")
            print(f"    long_prefills_completed={s['long_prefills_completed']:.0f} "
                  f"prefill_chunks={s['prefill_chunks']:.0f} device_bytes="
                  f"{srv.residency.device_bytes()} resident_bytes={srv.residency.resident_bytes()}")
        print(f"    launches {json.dumps(counts)}")
        check_served(srv, reqs, cfg, name)
        check_fault_free(srv, name)
        need = -(-reqs[-1].prompt_len // kw["paged"].prefill_chunk) if long_len else 0
        if long_len and (s["prefill_chunks"] != need or s["long_prefills_completed"] != 1):
            raise SystemExit(f"chip_smoke: server {name}: the long prompt took "
                             f"{s['prefill_chunks']} chunks, {s['long_prefills_completed']} "
                             f"completed (need {need} and 1)")
        idle = [k for k in SERVER_KERNELS[name] if counts[k] == 0]
        if idle:
            raise SystemExit(f"chip_smoke: kernels never launched on the server {name} path: "
                             f"{idle}")
        out_counts[name] = counts
        tick_ms_of[name] = tick_ms
        del srv
    unused = [k for k in out_counts["9a"] if not any(c[k] for c in out_counts.values())]
    if unused:
        raise SystemExit(f"chip_smoke: kernels never launched on the server paths: {unused}")
    return out_counts, tick_ms_of


def server_card_vs_cpu(cfg, slots: int, tier_slots: int, K: int, cache_len: int):
    """Phase 9e: the request server on the card and on the CPU, fp32, 2
    layers at full width, capacity_factor 100, the same weights, for the
    setups of 9a, 9c (a 768-token prompt in three chunks, tiered slots) and
    9d. The requests are pre-admitted (`build_request_table` + `admit`, then
    `run([])`), so both run one schedule. Gate: every request's tokens and
    the store's counters identical."""
    import numpy as np

    from repro_torch.serving import RequestServer

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32",
                               moe=dataclasses.replace(cfg.moe, capacity_factor=100.0))
    params, hp = seeded_model(cfg2)
    hp_d = with_draft_head(cfg2, hp)
    for name, kw, long_len in server_runs(cfg2, slots, tier_slots, K, cache_len):
        if name == "9b":
            continue
        long_len //= 2
        got = {}
        for dev in ("cuda", "cpu"):
            reqs = server_requests(cfg2, 8, 1e6, (16, 200), (4, 16), long_len, seed=1)
            srv = RequestServer(cfg2, params, hp_d if name == "9d" else hp, device=dev, **kw)
            try:
                for r in reqs:
                    srv.build_request_table(r)
                    srv.admit(r, 0.0)
                srv.run([], realtime=False)
            finally:
                srv.close()
            check_served(srv, reqs, cfg2, f"{name} on {dev}")
            st = srv.store.stats
            got[dev] = ({r.rid: r.generated for r in srv.completed},
                        (st.loads, st.hits, st.evictions, st.promotions, st.demotions,
                         st.bytes_h2d), srv.summary())
        (tc, sc, mc), (th, sh, mh) = got["cuda"], got["cpu"]
        same = [tc == th, sc == sh]
        print(f"  ({name}) fp32 n_layers=2 requests={len(tc)} tokens={sum(map(len, tc.values()))} "
              f"prefill_chunks={mc.get('prefill_chunks', 0):.0f} spec_acceptance_rate="
              f"{mc['spec_acceptance_rate']:.4f}: tokens of every request, store counters "
              f"identical on card and CPU = {same} (need all True); loads={sc[0]} "
              f"evictions={sc[2]} promotions={sc[3]}")
        if not all(same):
            raise SystemExit(f"chip_smoke: card and CPU disagree on the server {name} path")


# ---------------------------------------------------------------------------
# phases 9f and 9g: the server under faults, and two tenants under WFQ
# ---------------------------------------------------------------------------

SUPERVISION = ("upload_retries", "upload_failures", "thread_crashes", "sync_fallbacks")
# the fault plans' seed: its upload schedule fails the 2nd and 3rd operations
# (with one retry, the second upload batch is abandoned) and 7 of the first
# 20, so a run that uploads little still meets the faults it gates on
FAULT_SEED = 9


def check_fault_free(srv, name: str) -> None:
    """A fault-free run leaves retries, abandoned batches, thread crashes,
    synchronous fallbacks and callable-job errors at 0 (retry and degrade
    would otherwise absorb a bug in the transfer path)."""
    s = srv.summary()
    counts = {k: s[k] for k in SUPERVISION}
    counts["job_errors"] = srv.telemetry.counter("prefetch_job_errors").value
    bad = {k: v for k, v in counts.items() if v}
    if bad:
        raise SystemExit(f"chip_smoke: the fault-free server {name} counted {bad}")


def serve_pre_admitted(srv, reqs) -> None:
    """Admit every request before the loop starts (tables built on this
    thread, no warming submits) and order prefill batches by arrival alone,
    not by cache affinity: one schedule, whatever the transfer thread's
    timing or a fault does to residency, so two runs hold token for token."""
    srv.scheduler.use_affinity = False
    try:
        for r in reqs:
            r.table = srv.engine.build_table(r.rid, r.prompt[None, :])
            srv.admit(r, 0.0)
        srv.run([], realtime=False)
    finally:
        srv.close()


def fault_runs(cfg, slots: int, tier_slots: int, K: int, cache_len: int):
    """Phase 9f's setups: (name, RequestServer kwargs, fault plan, long
    prompt length, kernels of the path, whether the faulted run's tokens
    must equal the fault-free run's). (i) 9b, (ii) 9c through the async
    pipeline, (iii) 9b under thread crashes past `max_thread_restarts` (3).
    (ii) spills no K/V page: at its peak every resident page is pinned by a
    tick, so a pool small enough to spill is exhausted instead. Its tokens
    are held only up to the first forward whose tier placement differs: an
    abandoned batch is rolled back and its experts replanned when a tick
    consumes them, under that tick's protections, so one can land in the
    other tier (int8 where the fault-free run had int4, or the reverse),
    and the tokens that follow may differ (ROADMAP §C, C13)."""
    runs = {name: (kw, long_len) for name, kw, long_len in
            server_runs(cfg, slots, tier_slots, K, cache_len)}
    kw_c, long_len = runs["9c"]
    kw_c = dict(kw_c, prefetch_depth=2, staging_buffers=2)
    return (("i", runs["9b"][0], "upload:fail,p=0.2", 0, SERVER_KERNELS["9b"], True),
            ("ii", kw_c, "upload:fail,p=0.2;host_read:fail,p=0.1", long_len,
             SERVER_KERNELS["9c"], False),
            ("iii", runs["9b"][0], "thread:crash@1x4", 0, SERVER_KERNELS["9b"], True))


def server_faults_path(cfg, params, hp, runs):
    """Phase 9f: each setup of `fault_runs` serves phase 9's 24 requests
    (seed 0, prompts 16-256, 8-64 new tokens) pre-admitted and closed loop,
    fault-free and then under its seeded plan (`FAULT_SEED`), with one retry an
    upload batch (`cfg.prefetch.max_retries=1`) so that abandoned batches
    happen, and capacity_factor 100, as the reference's chaos test sets it:
    a token routed to an expert that missed residency takes a capacity row
    of slot 0 at weight 0, so where capacity binds, the expert a replan
    puts in slot 0 decides whose tokens overflow. Gates: every request
    completes, none rejected; on the bf16 slots of (i) and (iii) the
    faulted run's tokens equal the fault-free run's, request by request;
    on (ii)'s tiers every forward's predicted experts equal the fault-free
    run's until the first forward whose tier placement differs; the
    fault-free run counts no retry, failure, crash, job error or sync
    fallback; the planned counters are non-zero (retries and poisoned
    fences in (i) and (ii); crashes, a degraded shard and a watchdog revive
    in (iii)); the resident slots hold their masters; every kernel of the
    path launches in the faulted run."""
    import numpy as np

    from repro_torch.core.faults import FaultPlan
    from repro_torch.kernels import ops
    from repro_torch.serving import RequestServer

    cfg_f = dataclasses.replace(cfg, prefetch=dataclasses.replace(cfg.prefetch, max_retries=1),
                                moe=dataclasses.replace(cfg.moe, capacity_factor=100.0))
    keys = ("completed", "throughput_tok_s", "decode_tok_s", "upload_retries",
            "upload_failures", "poisoned_fences", "thread_crashes", "thread_restarts",
            "sync_fallbacks", "degraded_shards", "watchdog_revives", "fence_timeouts")
    for name, kw, plan_text, long_len, kernels, held in runs:
        out = {}
        for plan in (None, FaultPlan.parse(plan_text, seed=FAULT_SEED)):
            reqs = server_requests(cfg, 24, 8.0, (16, 256), (8, 64), long_len)
            srv = RequestServer(cfg_f, params, hp, device="cuda", faults=plan, **kw)
            seen = {"degraded": 0}
            watchdog = srv.prefetch.watchdog

            def watch(*a, srv=srv, seen=seen, watchdog=watchdog):
                seen["degraded"] = max(seen["degraded"], srv.prefetch.stats.degraded)
                return watchdog(*a)

            srv.prefetch.watchdog = watch
            # each forward's predicted experts and the tier (8 hot, 4 warm, 0
            # unrouted) each of them is served from
            forwards = []
            translate = srv.store.translate

            def spy(table, trans, srv=srv, forwards=forwards, translate=translate):
                slot_ids, w = translate(table, trans)
                tiers = np.where(slot_ids >= srv.store.S8, 4, 8) * (w > 0)
                forwards.append((table.expert_ids.copy(), tiers))
                return slot_ids, w

            srv.store.translate = spy
            ops.reset_launches()
            t0 = time.perf_counter()
            serve_pre_admitted(srv, reqs)
            counts = ops.launches()
            check_served(srv, reqs, cfg, f"9f({name})")
            n_slots = resident_equals_host(srv.store)
            s = srv.summary()
            tag = "faulted" if plan is not None else "fault-free"
            print(f"  (9f {name}) {tag} plan={plan_text if plan else None} "
                  f"wall_s={time.perf_counter() - t0:.3f} " + " ".join(
                      f"{k}={s[k]:.4f}" for k in keys)
                  + f" degraded_seen={seen['degraded']} job_errors="
                  f"{srv.telemetry.counter('prefetch_job_errors').value:.0f} "
                  f"resident_slots_checked={n_slots}")
            if plan is not None:
                print(f"    faults {json.dumps(plan.summary())} store loads={srv.store.stats.loads} "
                      f"bytes_h2d={srv.store.stats.bytes_h2d}")
                if srv.residency is not None:
                    print(f"    residency {json.dumps(srv.residency.summary())}")
                print(f"    launches {json.dumps(counts)}")
                idle = [k for k in kernels if counts[k] == 0]
                if idle:
                    raise SystemExit(f"chip_smoke: kernels never launched on the faulted server "
                                     f"9f({name}): {idle}")
            else:
                check_fault_free(srv, f"9f({name})")
            out[tag] = ({r.rid: list(r.generated) for r in srv.completed}, s, seen["degraded"],
                        forwards)
            del srv
        (clean, s0, _, fw0), (toks, s1, degraded, fw1) = out["fault-free"], out["faulted"]
        same = sum(clean[rid] == toks.get(rid) for rid in clean)
        ratio = s1["throughput_tok_s"] / max(s0["throughput_tok_s"], 1e-9)
        first = lambda differ: next((i for i, (a, b) in enumerate(zip(fw0, fw1)) if differ(a, b)),
                                    None)
        ids_at = first(lambda a, b: a[0].shape != b[0].shape or (a[0] != b[0]).any())
        tier_at = first(lambda a, b: a[1].shape != b[1].shape or (a[1] != b[1]).any())
        print(f"    9f({name}): requests with the fault-free tokens {same} of {len(clean)} "
              f"({'need all' if held else 'held up to the first change of tier placement'}); "
              f"forwards {len(fw0)} / {len(fw1)}, first with other predicted experts {ids_at}, "
              f"first with other tier placement {tier_at}; chaos_throughput_ratio={ratio:.4f}")
        if held and toks != clean:
            raise SystemExit(f"chip_smoke: 9f({name}): faults changed the tokens of "
                             f"{len(clean) - same} requests")
        if len(fw0) != len(fw1) or (ids_at is not None and (tier_at is None or tier_at >= ids_at)):
            raise SystemExit(f"chip_smoke: 9f({name}): the faulted run's forwards left the "
                             f"fault-free run's before any change of tier placement")
        if name == "iii":
            need = {"thread_crashes": s1["thread_crashes"] >= 4, "degraded_seen": degraded > 0,
                    "watchdog_revives": s1["watchdog_revives"] >= 1}
        else:
            need = {"upload_retries": s1["upload_retries"] > 0,
                    "poisoned_fences": s1["poisoned_fences"] > 0}
        if not all(need.values()):
            raise SystemExit(f"chip_smoke: 9f({name}): planned counters not reached {need}")


def tenant_requests(cfg):
    """Phase 9g's traffic, shaped like the reference's multitenant probe: a
    light tenant's 16 Poisson requests at 4 req/s and a heavy tenant's 48
    that all arrive at t = 0; prompts 16-128, 8-32 new tokens, SLO 20 s."""
    import numpy as np

    from repro_torch.serving import poisson_requests

    light = poisson_requests(np.random.default_rng(0), 16, rate_rps=4.0,
                             vocab_size=cfg.vocab_size, prompt_len_range=(16, 128),
                             max_new_range=(8, 32), slo_s=20.0, tenant="light")
    heavy = poisson_requests(np.random.default_rng(1), 48, rate_rps=1e6,
                             vocab_size=cfg.vocab_size, prompt_len_range=(16, 128),
                             max_new_range=(8, 32), slo_s=20.0, tenant="heavy", rid_base=1000)
    for r in heavy:
        r.arrival_s = 0.0
    return light, heavy


def tenants_path(cfg, params, hp, slots: int, cache_len: int):
    """Phase 9g: 9a's server (4 bf16 slots, a ring) serves the light tenant
    alone, light + heavy under WFQ (weight 1 each, heavy's pin quota 0.25,
    two experts a MoE layer pinned under heavy's name first), and light +
    heavy with no tenants, in real time. Gates: every light request
    completes in each run; heavy's pinned share is 0.25 (1 of 4 slots);
    the quota refuses one pin a MoE layer; the fault-free counters stay 0;
    the path's kernels launch. Prints the light tenant's SLO attainment in
    each run and WFQ's over solo's (not gated)."""
    from repro_torch.kernels import ops
    from repro_torch.serving import RequestServer, TenantConfig

    light_cfg = TenantConfig("light", weight=1.0)
    heavy_cfg = TenantConfig("heavy", weight=1.0, pin_quota=0.25)
    att = {}
    for run, tenants in (("solo", (light_cfg,)), ("wfq", (light_cfg, heavy_cfg)), ("flat", ())):
        light, heavy = tenant_requests(cfg)
        reqs = light if run == "solo" else light + heavy
        srv = RequestServer(cfg, params, hp, device="cuda", slots_per_layer=slots, max_lanes=8,
                            max_prefill_batch=8, buckets=SERVER_BUCKETS, cache_len=cache_len,
                            tenants=tenants)
        pins = None
        if run == "wfq":
            pins = [srv.store.pin_experts(l, [0, 1], tenant="heavy") for l in range(srv.L)]
        ops.reset_launches()
        try:
            srv.run(reqs, realtime=True)
        finally:
            srv.close()
        counts = ops.launches()
        check_fault_free(srv, f"9g({run})")
        done = {r.rid: r for r in srv.completed}
        lost = [r.rid for r in light if r.rid not in done]
        ok = sum(1 for r in light if r.rid in done and done[r.rid].latency_s <= r.slo_s)
        att[run] = ok / len(light)
        s = srv.summary()
        print(f"  (9g {run}) requests={len(reqs)} completed={s['completed']:.0f} "
              f"rejected={s['rejected']:.0f} wall_s={srv.telemetry.wall_s():.3f} "
              f"throughput_tok_s={s['throughput_tok_s']:.4f} light_slo_attainment={att[run]:.4f} "
              f"light_max_latency_s={max((done[r.rid].latency_s for r in light if r.rid in done), default=0.0):.3f}")
        for tname, blk in srv.tenant_summary().items():
            print(f"    tenant {tname} " + " ".join(f"{k}={v:.4f}" for k, v in blk.items()))
        print(f"    launches {json.dumps(counts)}")
        if lost or srv.rejected:
            raise SystemExit(f"chip_smoke: 9g({run}): light requests not completed {lost}, "
                             f"rejected {[r.rid for r in srv.rejected]}")
        idle = [k for k in SERVER_KERNELS["9a"] if counts[k] == 0]
        if idle:
            raise SystemExit(f"chip_smoke: kernels never launched on 9g({run}): {idle}")
        if run == "wfq":
            share = srv.store.pinned_share("heavy")
            refusals = srv.store.stats.pin_quota_refusals
            print(f"    heavy pinned_share={share:.4f} (need 0.25) pin_quota_refusals={refusals} "
                  f"(need {srv.L}, one a MoE layer) granted={[sorted(p) for p in pins]}")
            if share != 0.25 or refusals != srv.L:
                raise SystemExit("chip_smoke: 9g: heavy's pin quota did not hold")
    print(f"    light SLO attainment solo={att['solo']:.4f} wfq={att['wfq']:.4f} "
          f"unprotected={att['flat']:.4f} attainment_ratio={att['wfq'] / max(att['solo'], 1e-9):.4f} "
          f"(the reference's bar 0.9 was set on the CPU; not gated)")


def server_faults_card_vs_cpu(cfg, slots: int, cache_len: int):
    """Phase 9e, continued (fp32, 2 layers at full width, capacity_factor
    100, pre-admitted): 9b's async server under a seeded upload:fail,p=0.2
    plan on the card and the CPU, and fault-free on the card, gives every
    request the same tokens; 9a's server with two tenants under WFQ gives
    every request the same tokens and each tenant the same completed count
    on the card and the CPU. Store counters under a fault plan depend on
    the thread's timing: printed, not gated."""
    import numpy as np

    from repro_torch.core.faults import FaultPlan
    from repro_torch.serving import RequestServer, TenantConfig, poisson_requests

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32",
                               moe=dataclasses.replace(cfg.moe, capacity_factor=100.0))
    params, hp = seeded_model(cfg2)
    ring = dict(max_lanes=8, max_prefill_batch=8, buckets=SERVER_BUCKETS, cache_len=cache_len,
                slots_per_layer=slots)
    got = {}
    for dev, plan in (("cuda", None), ("cuda", "upload:fail,p=0.2"), ("cpu", "upload:fail,p=0.2")):
        reqs = server_requests(cfg2, 8, 1e6, (16, 200), (4, 16), seed=1)
        faults = FaultPlan.parse(plan, seed=FAULT_SEED) if plan else None
        srv = RequestServer(cfg2, params, hp, device=dev, prefetch_depth=2, staging_buffers=2,
                            faults=faults, **ring)
        serve_pre_admitted(srv, reqs)
        check_served(srv, reqs, cfg2, f"9e async on {dev}")
        s, st = srv.summary(), srv.store.stats
        got[(dev, plan)] = {r.rid: r.generated for r in srv.completed}
        print(f"  (9e async {dev} plan={plan}) fp32 n_layers=2 requests={len(reqs)} "
              f"retries={s['upload_retries']:.0f} failures={s['upload_failures']:.0f} "
              f"poisoned={s['poisoned_fences']:.0f} sync_fallbacks={s['sync_fallbacks']:.0f} "
              f"loads={st.loads} evictions={st.evictions} bytes_h2d={st.bytes_h2d}")
    clean = got[("cuda", None)]
    same = [got[("cuda", "upload:fail,p=0.2")] == clean, got[("cpu", "upload:fail,p=0.2")] == clean]
    print(f"    tokens of every request: faulted card = fault-free card, faulted CPU = "
          f"fault-free card: {same} (need all True)")
    if not all(same):
        raise SystemExit("chip_smoke: 9e: the async server under faults disagrees")
    tenants = (TenantConfig("a", weight=2.0, pin_quota=0.5), TenantConfig("b", weight=1.0))
    got = {}
    for dev in ("cuda", "cpu"):
        reqs = []
        for i, name in enumerate(("a", "b")):
            reqs += poisson_requests(np.random.default_rng(i + 1), 6, rate_rps=1e6,
                                     vocab_size=cfg2.vocab_size, prompt_len_range=(16, 200),
                                     max_new_range=(4, 16), tenant=name, rid_base=100 * i)
        srv = RequestServer(cfg2, params, hp, device=dev, tenants=tenants, **ring)
        try:
            for r in reqs:
                srv.build_request_table(r)
                srv.admit(r, 0.0)
            srv.run([], realtime=False)
        finally:
            srv.close()
        check_served(srv, reqs, cfg2, f"9e tenants on {dev}")
        got[dev] = ({r.rid: r.generated for r in srv.completed},
                    {n: b["completed"] for n, b in srv.tenant_summary().items()})
    same = [got["cuda"][0] == got["cpu"][0], got["cuda"][1] == got["cpu"][1]]
    print(f"  (9e tenants) fp32 n_layers=2 requests={len(got['cuda'][0])} completed per tenant "
          f"{got['cuda'][1]}: tokens of every request, completed per tenant identical on card "
          f"and CPU = {same} (need all True)")
    if not all(same):
        raise SystemExit("chip_smoke: 9e: the two-tenant server disagrees between card and CPU")


# ---------------------------------------------------------------------------
# phase 2, the expert-parallel shapes; phase 12, expert parallelism on one card
# ---------------------------------------------------------------------------

EP_REBALANCE_S = 0.5      # 12a's re-homing interval: several rounds a run
E64_SHARDS, E64_SLOTS, E64_DEPTH = 4, 16, 4   # 12d: 16 homes a shard over 4 slots a shard


def ep_server_runs(cfg, slots: int, int8_slots: int, tier_slots: int, cache_len: int):
    """Phase 12a's runs: (name, RequestServer kwargs, expert-FFN kernels of
    the path, shards). 9a's ring and slot budget through the async pipeline
    (depth 2) with re-homing every `EP_REBALANCE_S`: bf16 slots at EP-2 and
    EP-4 with one replica a hot expert may hold, 5b's 8 int8 slots at EP-4
    with replicas, and 5c's tiers (hot int8 / warm int4, split 0.5) at EP-2,
    where both tiers' counts divide over the shards (no replicas: tiers and
    replicas exclude each other)."""
    from repro_torch.configs.base import TierConfig
    from repro_torch.core.offload import ShardedStoreConfig

    ring = dict(max_lanes=8, max_prefill_batch=8, buckets=SERVER_BUCKETS, cache_len=cache_len,
                prefetch_depth=2, staging_buffers=2, rebalance_interval=EP_REBALANCE_S)
    tier = TierConfig(int4_slots=True, tier_split=0.5, group_size=64)
    sharded = lambda m, r: ShardedStoreConfig(ep_shards=m, replicate_hot=r)   # noqa: E731
    return (("12a-ep2", dict(ring, slots_per_layer=slots, sharded=sharded(2, 1)),
             ("expert_ffn",), 2),
            ("12a-ep4", dict(ring, slots_per_layer=slots, sharded=sharded(4, 1)),
             ("expert_ffn",), 4),
            ("12a-int8-ep4", dict(ring, slots_per_layer=int8_slots, quantized_slots=True,
                                  sharded=sharded(4, 1)), ("expert_ffn_q",), 4),
            ("12a-tiered-ep2", dict(ring, slots_per_layer=tier_slots, quantized_slots=True,
                                    tier=tier, sharded=sharded(2, 0)),
             ("expert_ffn_q", "expert_ffn_q4"), 2))


def ep_kernel_cases(cfg, lanes: int, slots: int, int8_slots: int, tiers, e64_tiers, c_prefill):
    """Phase 2's expert-parallel rows: (row, format, pool slots S, shards,
    capacity C) for each per-shard shape phase 12 launches; the row's
    kernel runs over the last shard's slice of an [S, ...] pool, a view at
    a non-zero offset. The capacity is the global one (the EP dispatch
    builds each shard's table at the one-device C)."""
    from repro_torch.models.moe import _capacity

    hot, warm = tiers
    hot64, warm64 = e64_tiers
    dec = lambda S: _capacity(cfg, lanes, S)   # noqa: E731  one token a lane
    return (("expert_ffn/ep2-decode", "fp", slots, 2, dec(slots)),
            ("expert_ffn/ep2-prefill", "fp", slots, 2, c_prefill),
            ("expert_ffn/ep4-decode", "fp", slots, 4, dec(slots)),
            ("expert_ffn_q/ep4-decode", "int8", int8_slots, 4, dec(int8_slots)),
            ("expert_ffn_q/ep2-tiered-hot", "int8", hot, 2, dec(hot + warm)),
            ("expert_ffn_q4/ep2-tiered-warm", "int4", warm, 2, dec(hot + warm)),
            ("expert_ffn/e64-ep4-decode", "fp", E64_SLOTS, E64_SHARDS, dec(E64_SLOTS)),
            ("expert_ffn_q/e64-ep4-hot", "int8", hot64, E64_SHARDS, dec(hot64 + warm64)),
            ("expert_ffn_q4/e64-ep4-warm", "int4", warm64, E64_SHARDS, dec(hot64 + warm64)))


def check_ep_kernels(cfg, cases):
    """Phase 2, the expert-parallel shapes: B1 / B5 / B6 over the last
    shard's slice of a slot pool (weights, int8 scale planes, int4 packed
    and group-scale planes: views at an offset of (shards - 1) x S_loc slots,
    no copy), at bf16 5e-2 and fp32 1e-4 against the plain version on the
    same slice, and bit-identical to the kernel over a contiguous copy of
    the slice (its address changes nothing). Timed beside the plain version
    and bmm+gelu+bmm over the slice's weights dequantised ahead of time.
    Returns {row: record of the bf16 case}."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.offload import quantize_stack_int4, quantize_stack_int8
    from repro_torch.kernels import ref
    from repro_torch.kernels.expert_gemm import (
        expert_ffn_cuda,
        expert_ffn_q4_cuda,
        expert_ffn_q_cuda,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(4321)
    d, Fh = cfg.d_model, cfg.moe.d_expert
    records, failed = {}, []
    kern_of = {"fp": expert_ffn_cuda, "int8": expert_ffn_q_cuda, "int4": expert_ffn_q4_cuda}
    plain_of = {"fp": ref.expert_ffn_ref, "int8": ref.expert_ffn_q_ref,
                "int4": ref.expert_ffn_q4_ref}
    for row, fmt, S, shards, C in cases:
        n, m = S // shards, shards - 1
        w_in = torch.randn((1, S, d, Fh), generator=gen) * d ** -0.5
        w_out = torch.randn((1, S, Fh, d), generator=gen) * Fh ** -0.5
        for dtype, tol in ((torch.bfloat16, 5e-2), (torch.float32, 1e-4)):
            if fmt == "fp":
                pools = [w_in[0].to(dev, dtype), None, w_out[0].to(dev, dtype)]
            else:
                quant = ((lambda w: quantize_stack_int8(w, dev)) if fmt == "int8"
                         else (lambda w: quantize_stack_int4(w, dev, 64)))
                (qi, si), (qo, so) = quant(w_in), quant(w_out)
                pools = [qi[0].to(dev), si[0].to(dev), None, None, qo[0].to(dev), so[0].to(dev)]
            view = [None if p is None else p[m * n:(m + 1) * n] for p in pools]
            offset_ok = all(v.untyped_storage().data_ptr() == p.untyped_storage().data_ptr()
                            and v.data_ptr() == p.data_ptr()
                            + m * n * p.stride(0) * p.element_size()
                            for p, v in zip(pools, view) if p is not None)
            xe = (torch.randn((n, C, d), generator=gen)).to(dev, dtype)
            kern = lambda: kern_of[fmt](xe, *view, act=cfg.act)   # noqa: E731
            got = kern()
            copied = kern_of[fmt](xe, *[None if v is None else v.clone() for v in view],
                                  act=cfg.act)
            torch.cuda.synchronize()
            if not offset_ok or not torch.equal(got, copied):
                failed.append(f"{row} {dtype}: offset view ok={offset_ok}, equal to the kernel "
                              f"over a copy={torch.equal(got, copied)}")
            want = plain_of[fmt](xe, *view, act=cfg.act)
            wi_f = (view[0] if fmt == "fp" else
                    ref.dequantize_ref(view[0], view[1]) if fmt == "int8" else
                    ref.dequantize_q4_ref(view[0], view[1], d)).to(dtype)
            wo_f = (view[2] if fmt == "fp" else
                    ref.dequantize_ref(view[4], view[5]) if fmt == "int8" else
                    ref.dequantize_q4_ref(view[4], view[5], Fh)).to(dtype)

            def lib():
                return torch.bmm(F.gelu(torch.bmm(xe, wi_f), approximate="tanh"), wo_f)

            peak = H100_BF16_FLOPS if dtype == torch.bfloat16 else H100_F32_FLOPS
            bnd = bound_ms(nb(xe, got, *[v for v in view if v is not None]),
                           2 * 2 * n * C * d * Fh, peak)
            rec = report(failed, row, dtype, (n, C, d, Fh), got, want, tol, time_ms(kern),
                         time_ms(lambda: plain_of[fmt](xe, *view, act=cfg.act)), time_ms(lib),
                         bnd, " (bmm+gelu+bmm" + (", pre-dequantised)" if fmt != "fp" else ")"),
                         graph=(kern, lib))
            if dtype == torch.bfloat16:
                records[row] = dict(rec, pool_slots=S, shards=shards, shard=m)
        print(f"    {row}: shard {m} of {shards}, slots [{m * n}, {(m + 1) * n}) of {S}, "
              f"views at their offset (no copy) = {offset_ok}")
    if failed:
        raise SystemExit(f"chip_smoke: expert-parallel kernel rows disagree: {failed}")
    return records


class DispatchCounter:
    """Counts `models.moe`'s dispatches while installed: `ep` the
    expert-parallel ones (one a MoE layer a forward), `all` every one. A
    decode step captured as a CUDA graph dispatches at each replay and not
    at its capture, so the capture's dispatches count once a replay."""

    def __init__(self):
        from repro_torch.core.decode_engine import RingStep, SiDADecodeEngine
        from repro_torch.models import moe

        self.moe, self.ep, self.all = moe, 0, 0
        self._ep, self._all = moe._dispatch_combine_ep, moe._dispatch_combine
        self._engine, self._ring = SiDADecodeEngine, RingStep
        self._capture, self._replay = SiDADecodeEngine._capture, RingStep.replay
        self._a_replay = {}   # id(ring) -> (ep, all) dispatches of its graph

    def __enter__(self):
        def ep(*a, **k):
            self.ep += 1
            return self._ep(*a, **k)

        def every(*a, **k):
            self.all += 1
            return self._all(*a, **k)

        def capture(eng, ring, *a):
            before = self.ep, self.all
            self._capture(eng, ring, *a)
            self._a_replay[id(ring)] = (self.ep - before[0], self.all - before[1])
            self.ep, self.all = before

        def replay(ring, *a):
            n_ep, n_all = self._a_replay.get(id(ring), (0, 0))
            self.ep, self.all = self.ep + n_ep, self.all + n_all
            return self._replay(ring, *a)

        self.moe._dispatch_combine_ep, self.moe._dispatch_combine = ep, every
        self._engine._capture, self._ring.replay = capture, replay
        return self

    def __exit__(self, *exc):
        self.moe._dispatch_combine_ep, self.moe._dispatch_combine = self._ep, self._all
        self._engine._capture, self._ring.replay = self._capture, self._replay


def check_per_shard_launches(name: str, counts, disp, kernels, shards: int) -> None:
    """Gate: every dispatch went expert-parallel, and each expert-FFN kernel
    of the path launched once a shard a dispatch (shards x the one-device
    count)."""
    want = shards * disp.ep
    got = {k: counts[k] for k in kernels}
    print(f"    dispatches: expert-parallel {disp.ep} of {disp.all}; launches {got}, "
          f"need {want} each (shards {shards} x dispatches)")
    if disp.ep == 0 or disp.ep != disp.all or any(v != want for v in got.values()):
        raise SystemExit(f"chip_smoke: {name}: not one expert-FFN launch a shard a dispatch "
                         f"(expert-parallel dispatches {disp.ep} of {disp.all}, launches {got}, "
                         f"need {want})")


def ep_server_path(cfg, params, hp, runs, ms_9a: float):
    """Phase 12a: `RequestServer.run` at full width and depth, bf16, phase
    9's 24 Poisson requests at 8 req/s in real time, on each run of
    `ep_server_runs` (every shard on the one card). Prints each run's
    `summary()` with its shard fields, the store's replica and rebalance
    counters, `uploads_by_shard`, ms a decode tick beside 9a's, and each
    kernel's launches. Gates: every request completes, none rejected, no
    supervision event; every shard's queue uploaded; the server re-homed at
    least once a run (`rebalance_homes` called) and, over the runs without
    tiers, moved a primary; each expert-FFN kernel of the path launched
    once a shard a dispatch; the resident slots and replicas hold their
    masters. Returns ({run: launch counts}, {run: the store's (S8, S4)})."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving import RequestServer

    keys = ("completed", "throughput_tok_s", "decode_tok_s", "p50_latency_s", "p95_latency_s",
            "p50_ttft_s", "cache_hit_rate", "h2d_mb", "upload_stall_s", "replicate_hot",
            "replica_loads", "rebalance_moves", "shard_upload_max_over_mean")
    out_counts, geometry, moves = {}, {}, 0
    for name, kw, kernels, shards in runs:
        reqs = server_requests(cfg, 24, 8.0, (16, 256), (8, 64))
        t0 = time.perf_counter()
        srv = RequestServer(cfg, params, hp, device="cuda", **kw)
        setup = time.perf_counter() - t0
        calls = {"n": 0}
        rebalance = srv.store.rebalance_homes

        def counted(rebalance=rebalance, calls=calls):
            calls["n"] += 1
            return rebalance()

        srv.store.rebalance_homes = counted
        torch.cuda.synchronize()
        ops.reset_launches()
        with DispatchCounter() as disp:
            try:
                srv.run(reqs, realtime=True)
            finally:
                srv.close()
        counts = ops.launches()
        s, t, st = srv.summary(), srv.telemetry, srv.store.stats
        steps = t.counter("decode_steps").value
        tick_ms = 1e3 * t.counter("decode_tick_s_total").value / max(steps, 1)
        ups = dict(sorted(srv.prefetch.stats.uploads_by_shard.items()))
        print(f"  ({name}) ep_shards={shards} slots={kw['slots_per_layer']} (S8={srv.store.S8} "
              f"S4={srv.store.S4}, S_loc={srv.store.S_loc}) replicate_hot="
              f"{kw['sharded'].replicate_hot} rebalance_interval={kw['rebalance_interval']} "
              f"requests={len(reqs)} setup_s={setup:.2f} wall_s={t.wall_s():.3f}")
        print("    " + " ".join(f"{k}={s[k]:.4f}" for k in keys))
        print(f"    decode_steps={int(steps)} ms_per_decode_tick={tick_ms:.3f} (phase 9a "
              f"ms_per_decode_tick={ms_9a:.3f}) prefill_batches="
              f"{int(t.counter('prefill_batches').value)} rebalance_calls={calls['n']} "
              f"rebalance_rounds={int(t.counter('rebalance_rounds').value)}")
        print(f"    store loads={st.loads} hits={st.hits} evictions={st.evictions} "
              f"replica_loads={st.replica_loads} rebalance_moves={st.rebalance_moves} "
              f"promotions={st.promotions} demotions={st.demotions} bytes_h2d={st.bytes_h2d} "
              f"uploads_by_shard={json.dumps(ups)} homes={srv.store.home.tolist()}")
        print(f"    launches {json.dumps(counts)}")
        check_served(srv, reqs, cfg, name)
        check_fault_free(srv, name)
        check_per_shard_launches(name, counts, disp, kernels, shards)
        n_slots = resident_equals_host(srv.store)
        print(f"    resident slots and replicas checked against their masters: {n_slots}")
        if sorted(k for k, v in ups.items() if v) != list(range(shards)):
            raise SystemExit(f"chip_smoke: {name}: not every shard's queue uploaded {ups}")
        if calls["n"] < 1:
            raise SystemExit(f"chip_smoke: {name}: no rebalance round ran")
        moves += st.rebalance_moves if "tier" not in kw else 0
        out_counts[name] = counts
        geometry[name] = (srv.store.S8, srv.store.S4)
        del srv
    if moves == 0:
        raise SystemExit("chip_smoke: 12a: no rebalance round moved a primary")
    return out_counts, geometry


def ep_all_resident(cfg, params, hp, lanes: int, cache_len: int):
    """Phase 12b: every expert resident (slots = E = 8), full width and depth,
    fp32 (phase 9's bf16 weights widened), capacity factor 100, 8 requests
    pre-admitted (one schedule): the EP-2 and EP-4 servers' tokens equal the
    one-device server's, request by request, and the EP-2 / EP-4 decode
    engines' tokens the one-device engine's (the reference's invariant: each
    token's expert FFN runs on the shard that holds its slot, the partials
    add exact zeros). Then bf16, the weights as served: one fixed table's
    prefill logits through EP-2 and EP-4 within 5e-2 * max(1, max|logit|)
    of the one-device forward, and the bf16 decode tokens' agreement
    printed (not gated: the decode tile's split may differ with the slot
    count)."""
    import numpy as np
    import torch

    from repro_torch.core.decode_engine import SiDADecodeEngine
    from repro_torch.core.hash_table import HashTable
    from repro_torch.core.offload import ShardedStoreConfig
    from repro_torch.models.transformer import forward, n_moe_layers
    from repro_torch.serving import RequestServer
    from repro_torch.tree import tree_map

    E = cfg.moe.num_experts
    cfg32 = dataclasses.replace(cfg, dtype="float32",
                                moe=dataclasses.replace(cfg.moe, capacity_factor=100.0))
    p32 = tree_map(lambda t: t.float(), params)
    start = np.random.default_rng(3).integers(0, cfg.vocab_size, (lanes,)).astype(np.int32)
    sharded = lambda m: ShardedStoreConfig(ep_shards=m) if m > 1 else None   # noqa: E731
    srv_tokens, dec_tokens = {}, {}
    for m in (1, 2, 4):
        reqs = server_requests(cfg, 8, 1e6, (16, 96), (8, 16), seed=5)
        srv = RequestServer(cfg32, p32, hp, device="cuda", slots_per_layer=E, max_lanes=lanes,
                            max_prefill_batch=lanes, buckets=(128,), cache_len=cache_len,
                            sharded=sharded(m))
        serve_pre_admitted(srv, reqs)
        check_served(srv, reqs, cfg, f"12b ep{m}")
        srv_tokens[m] = {r.rid: list(r.generated) for r in srv.completed}
        del srv
        eng = SiDADecodeEngine(cfg32, p32, hp, slots_per_layer=E, device="cuda",
                               sharded=sharded(m))
        dec_tokens[m] = eng.generate(start, 16, cache_len=cache_len)[0]
        eng.close()
        del eng
    same_srv = {m: srv_tokens[m] == srv_tokens[1] for m in (2, 4)}
    same_dec = {m: bool(np.array_equal(dec_tokens[m], dec_tokens[1])) for m in (2, 4)}
    print(f"  (12b fp32, every expert resident) server tokens equal the one-device server's: "
          f"EP-2 {same_srv[2]}, EP-4 {same_srv[4]} ({sum(map(len, srv_tokens[1].values()))} "
          f"tokens); decode engine tokens equal: EP-2 {same_dec[2]}, EP-4 {same_dec[4]} "
          f"({dec_tokens[1].size} tokens)")
    if not all(same_srv.values()) or not all(same_dec.values()):
        raise SystemExit("chip_smoke: 12b: expert-parallel tokens differ from the one-device "
                         "path with every expert resident")
    del p32

    # bf16, as served: one fixed table's logits, and the decode tokens printed
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (2, 128)).astype(np.int32)
    L = n_moe_layers(cfg)
    ids = rng.integers(0, E, (L, 2, 128, 1)).astype(np.int32)
    w = rng.random((L, 2, 128, 1)).astype(np.float32)
    logits, toks = {}, {}
    for m in (1, 2, 4):
        eng = SiDADecodeEngine(cfg, params, hp, slots_per_layer=E, device="cuda",
                               sharded=sharded(m))
        table = HashTable(0, ids, w)
        slot_ids, ww = eng.store.translate(table, eng.store.prepare(table))
        with torch.inference_mode():
            logits[m] = forward(eng.store.serve_params, cfg, torch.as_tensor(tokens, device="cuda"),
                                routing_override=(torch.as_tensor(slot_ids, device="cuda"),
                                                  torch.as_tensor(ww, device="cuda")),
                                ctx=eng.ctx)["logits"][..., :cfg.vocab_size].float().cpu()
        toks[m] = eng.generate(start, 16, cache_len=cache_len)[0]
        eng.close()
        del eng
    for m in (2, 4):
        err = (logits[m] - logits[1]).abs().max().item()
        tol = 5e-2 * max(1.0, logits[1].abs().max().item())
        agree = float((toks[m] == toks[1]).mean())
        print(f"  (12b bf16 EP-{m}) fixed table's logits max_abs_err={err:.4e} tol={tol:.4e} "
              f"{'ok' if err <= tol else 'FAIL'}; decode tokens agreeing with one device "
              f"{agree:.4f} (printed, not gated)")
        if not err <= tol:
            raise SystemExit(f"chip_smoke: 12b: bf16 EP-{m} logits off by {err}")


def ep_card_vs_cpu(cfg, lanes: int = 2):
    """Phase 12c: card against CPU, fp32, full width cut to 2 layers, EP-2
    with one replica a hot expert may hold, 6 slots of 8, 2 lanes (a tick's
    few experts leave other shards free slots for replicas, and replicas a
    target for moves; at 8 lanes the 6 slots stay full of primaries and
    neither happens). (i) The server,
    synchronous, re-homing on every loop iteration (rebalance_interval
    1e-6), 8 requests pre-admitted: every request's tokens, the store's
    loads, replica loads, re-homing moves, residency, replicas and homes
    identical. (ii) The decode engine through the per-shard queues: 12
    steps, `rebalance_homes` (its moves ride the queues; drained), 12 more:
    tokens, loads a step, replica loads, moves and `uploads_by_shard`
    identical. Each run must place a replica and move a primary."""
    import numpy as np

    from repro_torch.core.decode_engine import SiDADecodeEngine
    from repro_torch.core.offload import ShardedStoreConfig
    from repro_torch.serving import RequestServer

    cfg2 = dataclasses.replace(cfg, n_layers=2, dtype="float32",
                               moe=dataclasses.replace(cfg.moe, capacity_factor=100.0))
    params, hp = seeded_model(cfg2)
    sharded = ShardedStoreConfig(ep_shards=2, replicate_hot=1)
    start = np.random.default_rng(6).integers(0, cfg.vocab_size, (lanes,)).astype(np.int32)
    got = {}
    for dev in ("cuda", "cpu"):
        reqs = server_requests(cfg2, 8, 1e6, (16, 96), (4, 12), seed=2)
        srv = RequestServer(cfg2, params, hp, device=dev, slots_per_layer=6, max_lanes=lanes,
                            max_prefill_batch=lanes, buckets=(128,), cache_len=256,
                            sharded=sharded, rebalance_interval=1e-6)
        serve_pre_admitted(srv, reqs)
        check_served(srv, reqs, cfg2, f"12c on {dev}")
        st = srv.store
        server = ({r.rid: list(r.generated) for r in srv.completed},
                  (st.stats.loads, st.stats.hits, st.stats.evictions, st.stats.replica_loads,
                   st.stats.rebalance_moves, st.stats.bytes_h2d),
                  (st.resident, st.replicas, st.home.tolist()))
        eng = SiDADecodeEngine(cfg2, params, hp, slots_per_layer=6, device=dev,
                               sharded=sharded, prefetch_depth=2)
        t1, m1 = eng.generate(start, 12, cache_len=64)
        moved = eng.store.rebalance_homes()
        pf = eng.prefetcher
        with eng.store._lock:         # the moves' fences, on their shards' queues
            fences = [ev for pend in pf._pending.values() for by in pend.values()
                      for ev in by.values()]
        if not all(ev.wait(60) for ev in fences):
            raise SystemExit(f"chip_smoke: 12c on {dev}: the moves' uploads never landed")
        t2, m2 = eng.generate(start, 12, cache_len=64)
        es = eng.store.stats
        decode = (np.concatenate([t1, t2], axis=1).tolist(), m1.loads_per_step + m2.loads_per_step,
                  (es.loads, es.replica_loads, es.rebalance_moves, moved),
                  dict(sorted(pf.stats.uploads_by_shard.items())),
                  eng.store.resident, eng.store.replicas, eng.store.home.tolist())
        resident_equals_host(eng.store)
        eng.close()
        got[dev] = (server, decode)
        del srv, eng
    (sc, dc), (sh, dh) = got["cuda"], got["cpu"]
    same = {"server tokens": sc[0] == sh[0], "server counters": sc[1] == sh[1],
            "server residency": sc[2] == sh[2], "decode tokens": dc[0] == dh[0],
            "decode loads a step": dc[1] == dh[1], "decode counters": dc[2] == dh[2],
            "uploads_by_shard": dc[3] == dh[3], "decode residency": dc[4:] == dh[4:]}
    print(f"  (12c fp32 EP-2, 2 layers, {lanes} lanes, replicate_hot 1, 6 slots) server: loads, hits, "
          f"evictions, replica_loads, rebalance_moves, bytes = {sc[1]}; decode: loads, "
          f"replica_loads, rebalance_moves, moved = {dc[2]}, uploads_by_shard = "
          f"{json.dumps(dc[3])}; identical on card and CPU: {same} (need all True)")
    if not all(same.values()) or min(sc[1][3], sc[1][4], dc[2][1], dc[2][2]) == 0:
        raise SystemExit(f"chip_smoke: 12c: card and CPU disagree, or no replica / move: {same}")


def ep_e64_path(lanes: int, cache_len: int, steps: int = 32):
    """Phase 12d: switch-base-64 at full width, `E64_DEPTH` layers (2 MoE
    layers), bf16, weights drawn on the card and kept on the host, served
    through `SiDADecodeEngine` at EP-4 (16 homes a shard) over 16 slots (4 a
    shard: the partition binds), through the per-shard queues: on bf16 slots
    and on hot int8 / warm int4 tiers (split 0.5). Prints tok/s, ms a step,
    loads a step, `uploads_by_shard`, the device bytes beside Standard's
    (every expert resident); gates: in-vocab tokens, every shard uploaded,
    one launch a shard a dispatch, the slots hold their masters. Returns
    ({run: launch counts}, the tiered store's (S8, S4))."""
    import numpy as np
    import torch

    from repro_torch.configs.base import TierConfig, get_config
    from repro_torch.core.decode_engine import SiDADecodeEngine
    from repro_torch.core.offload import ShardedStoreConfig, nbytes
    from repro_torch.kernels import ops
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(get_config("switch-base-64"), n_layers=E64_DEPTH)
    t0 = time.perf_counter()
    params, hp = card_seeded_model(cfg)
    standard = sum(nbytes(x) for x in tree_leaves(params))   # StandardServer holds all of it
    print(f"  switch-base-64: {cfg.n_layers} layers, d_model {cfg.d_model}, d_expert "
          f"{cfg.moe.d_expert}, {cfg.moe.num_experts} experts; seeded init (drawn on the card, "
          f"kept on the host) {time.perf_counter() - t0:.2f} s")
    start = np.random.default_rng(0).integers(0, cfg.vocab_size, (lanes,)).astype(np.int32)
    tier = TierConfig(int4_slots=True, tier_split=0.5, group_size=64)
    runs = (("e64-ep4-bf16", dict(slots_per_layer=E64_SLOTS), ("expert_ffn",)),
            ("e64-ep4-tiered", dict(slots_per_layer=E64_SLOTS, quantized_slots=True, tier=tier),
             ("expert_ffn_q", "expert_ffn_q4")))
    out_counts, tiers = {}, None
    for name, kw, kernels in runs:
        eng = SiDADecodeEngine(cfg, params, hp, device="cuda", prefetch_depth=2,
                               sharded=ShardedStoreConfig(ep_shards=E64_SHARDS), **kw)
        torch.cuda.synchronize()
        ops.reset_launches()
        with DispatchCounter() as disp:
            toks, m = eng.generate(start, steps=steps, cache_len=cache_len)
        counts = ops.launches()
        st, ps = eng.store, eng.prefetcher.stats
        ups = dict(sorted(ps.uploads_by_shard.items()))
        dev_bytes = sum(nbytes(x) for x in tree_leaves(st.serve_params))
        print(f"  ({name}) ep_shards={E64_SHARDS} slots={kw['slots_per_layer']} (S8={st.S8} "
              f"S4={st.S4}, {st.S_loc} a shard) homes a shard={cfg.moe.num_experts // E64_SHARDS} "
              f"lanes={lanes} steps={steps}")
        print(f"    tok_s={m.tok_s:.1f} ms_per_step={1e3 * m.wall_s / m.steps:.3f} "
              f"stall_s={m.stall_s:.4f} loads_per_step_mean={np.mean(m.loads_per_step):.3f} "
              f"(first {m.loads_per_step[0]}, last {m.loads_per_step[-1]}) loads={st.stats.loads} "
              f"evictions={st.stats.evictions} promotions={st.stats.promotions} demotions="
              f"{st.stats.demotions} uploads_by_shard={json.dumps(ups)}")
        print(f"    device_memory_bytes={dev_bytes} expert_device_bytes={st.device_bytes()} "
              f"against Standard's {standard} (every expert resident): "
              f"{dev_bytes / standard:.4f} of it")
        print(f"    launches {json.dumps(counts)}")
        if toks.shape != (lanes, steps) or toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise SystemExit(f"chip_smoke: 12d ({name}) emitted out-of-vocab tokens")
        check_per_shard_launches(name, counts, disp, kernels, E64_SHARDS)
        if sorted(k for k, v in ups.items() if v) != list(range(E64_SHARDS)):
            raise SystemExit(f"chip_smoke: 12d ({name}): not every shard uploaded {ups}")
        resident_equals_host(st)
        if "tier" in kw:
            tiers = (st.S8, st.S4)
        out_counts[name] = counts
        eng.close()
        del eng
    return out_counts, tiers


# ---------------------------------------------------------------------------
# phase 2, the attention-family shapes; phase 10, the attention-family configs
# ---------------------------------------------------------------------------

# the MoE configs served at full width: (name, depth served, slots a MoE
# layer). Depth is cut so that the host's init and the call's time stay
# bounded (the published depths are 28 and 94: 454 GB of qwen3 experts);
# the width never is.
MOE_FAMILY = (("deepseek-moe-16b", 4, 16), ("qwen3-moe-235b-a22b", 2, 32))
# the dense configs, 2 layers each (gemma2: one local and one global layer),
# and the prompt each forward runs (gemma2's is past its 4096 window)
DENSE_FAMILY = (("chameleon-34b", (2, 512)), ("gemma2-9b", (1, 5120)), ("qwen2-1.5b", (2, 512)),
                ("smollm-135m", (2, 512)), ("stablelm-12b", (2, 512)))
FAMILY_TIER = dict(tier_split=0.5, group_size=64)   # 10a/b's tiered decode
FAMILY_BATCH = (8, 256)                            # 10a/b's batches, [batch, seq]
DENSE_STEPS = 16                                   # 10d's decode steps after each prompt


def family_config(name: str, depth: int = 0, dtype: str = "bfloat16", **attn):
    """A published config at `dtype`, its depth cut to `depth` where given
    (an encoder-decoder keeps as many encoder layers), attention fields
    replaced where asked."""
    from repro_torch.configs.base import get_config

    cfg = dataclasses.replace(get_config(name), dtype=dtype)
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth,
                                  n_enc_layers=depth if cfg.enc_dec else cfg.n_enc_layers)
    if attn:
        cfg = dataclasses.replace(cfg, attn=dataclasses.replace(cfg.attn, **attn))
    return cfg


def family_tiers(cfg, slots: int):
    """(S8, S4) of 10a/b's tiered store: `slots` int8-slot units split 0.5."""
    from repro_torch.configs.base import TierConfig
    from repro_torch.core.offload import tier_geometry

    d, Fh = cfg.d_model, cfg.moe.d_expert
    return tier_geometry(TierConfig(int4_slots=True, **FAMILY_TIER), slots, cfg.moe.num_experts,
                         [(d, Fh), (d, Fh), (Fh, d)])


def attention_family_cases(lanes: int, cache_len: int):
    """Every form in which phase 10 launches the attention kernels, each a
    row of phase 2: (row suffix, config, prefill [B, S], decode lanes, ring
    slots, paged positions, window, softcap, where its launches come from).
    10a/b decode `lanes` over a `cache_len` ring and a `cache_len`-position
    table and serve FAMILY_BATCH; 10d runs each DENSE_FAMILY prompt and
    DENSE_STEPS steps after it (gemma2: its local layer's ring is its window,
    its global layer's the whole run)."""
    cases = [(f"{name.split('-')[0]}-{tag}", name, FAMILY_BATCH, lanes, cache_len, cache_len, 0,
              0.0, "moe") for name, tag in (("qwen3-moe-235b-a22b", "G16"),
                                           ("deepseek-moe-16b", "H16"))]
    tags = {"chameleon-34b": ["G8"], "qwen2-1.5b": ["G6"], "smollm-135m": ["D64"],
            "stablelm-12b": ["D160"], "gemma2-9b": ["D256", "D256-global"]}
    for name, (B, S) in DENSE_FAMILY:
        cfg = family_config(name, 2)
        n = S + DENSE_STEPS
        for tag in tags[name]:
            window = 0 if tag.endswith("global") else cfg.attn.window
            cases.append((f"{name.split('-')[0]}-{tag}", name, (B, S), B,
                          min(window, n) if window else n, n, window, cfg.attn.logit_softcap,
                          "dense"))
    return cases


def flex_library(q, k, v, mask_mod, cap: float, B, Lq: int, Lk: int):
    """The library call of a softcapped attention row: one compiled
    `flex_attention` over q [B, H, Lq, D], k/v [B, K, Lk, D], with score_mod
    cap·tanh(s / cap), the row's mask as a block mask built here (outside
    the timed call) and GQA through enable_gqa. Eager, and said so, if the
    compile fails. Returns (call, label)."""
    import torch
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    cfg = torch._dynamo.config
    setattr(cfg, "recompile_limit" if hasattr(cfg, "recompile_limit") else "cache_size_limit", 64)
    block = create_block_mask(mask_mod, B, None, Lq, Lk, device=q.device)

    def softcap(s, b, h, qi, ki):
        return cap * torch.tanh(s / cap)

    flex = torch.compile(flex_attention, dynamic=False)
    call = lambda: flex(q, k, v, score_mod=softcap, block_mask=block, enable_gqa=True)
    try:
        call()
        return call, " (flex_attention compiled: tanh score_mod, block mask, enable_gqa)"
    except Exception as exc:   # the library's compiler, not the port: time it eager
        print(f"    (flex_attention did not compile, timed eager: {str(exc)[:160]})")
        call = lambda: flex_attention(q, k, v, score_mod=softcap, block_mask=block,
                                      enable_gqa=True)
        return call, " (flex_attention eager: tanh score_mod, block mask, enable_gqa)"


def library_check(rec, out, want) -> None:
    """The library call's own distance from the plain version, printed and
    kept beside the row (`library_max_abs_err`): it computes the same
    function, so this is its rounding."""
    err = (out().float() - want.float()).abs().max().item()
    rec["library_max_abs_err"] = err
    print(f"    (the library call against the plain version: max_abs_err={err:.3e})")


def check_family_kernels(lanes: int, cache_len: int):
    """Phase 2, the attention-family shapes. The GLU (SwiGLU) expert FFN at
    deepseek-moe-16b's and qwen3-moe's batch-serve and decode blocks (bf16
    slots, against bmm·silu·bmm) and at their tiered decode's hot int8 and
    warm int4 blocks; flash_decode, flash_decode_paged and flash_prefill at
    every form phase 10 launches them in (`attention_family_cases`: GQA
    group 16 and deepseek's 16 / 16 heads at 10a/b's shapes, the dense
    configs at 10d's, gemma2's local and global layers with softcap 50).
    Each in bf16 (5e-2) and fp32 (1e-4) against its plain version on the
    same inputs. The library is SDPA with enable_gqa on the same keys, or
    for a softcapped row a compiled flex_attention (`flex_library`), SDPA
    without the softcap beside it (`sdpa_nocap_ms`); the library's own
    distance from the plain version is kept (`library_max_abs_err`).
    Returns {row: bf16 record}."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from repro_torch.core.offload import quantize_stack_int4, quantize_stack_int8
    from repro_torch.kernels import ref
    from repro_torch.kernels.expert_gemm import (expert_ffn_cuda, expert_ffn_q4_cuda,
                                                 expert_ffn_q_cuda)
    from repro_torch.kernels.flash_decode import (decode_plan, flash_decode_cuda,
                                                  flash_decode_paged_cuda)
    from repro_torch.kernels.flash_prefill import flash_prefill_cuda
    from repro_torch.models.moe import _capacity

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(654)   # gigabytes of weights: drawn on the card

    def rnd(shape, scale, dtype):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    records, failed = {}, []
    peak = {torch.bfloat16: H100_BF16_FLOPS, torch.float32: H100_F32_FLOPS}
    tols = ((torch.bfloat16, 5e-2), (torch.float32, 1e-4))

    def nocap(rec, sdpa):
        """SDPA has no softcap: its time without one, beside a capped row."""
        rec.update(sdpa_nocap_ms=time_ms(sdpa), sdpa_nocap_device_ms=graph_ms(sdpa))
        print(f"    (SDPA on the same inputs without the softcap: {rec['sdpa_nocap_ms']:.4f} ms, "
              f"device {rec['sdpa_nocap_device_ms']})")

    # --- the GLU expert FFN: [E, C, d] -> F -> d, silu(x Wg) * (x Wi) Wo
    for name, depth, slots in MOE_FAMILY:
        cfg = family_config(name, depth)
        d, Fh = cfg.d_model, cfg.moe.d_expert
        hot, warm = family_tiers(cfg, slots)
        c_dec = _capacity(cfg, lanes, slots)
        short = name.split("-")[0]
        cases = ((f"expert_ffn/{short}-batch", "bf16", slots,
                  batch_capacity(cfg, *FAMILY_BATCH, slots)),
                 (f"expert_ffn/{short}-decode", "bf16", slots, c_dec),
                 (f"expert_ffn_q/{short}-decode-hot", "int8", hot, _capacity(cfg, lanes, hot + warm)),
                 (f"expert_ffn_q4/{short}-decode-warm", "int4", warm,
                  _capacity(cfg, lanes, hot + warm)))
        for row, fmt, E, C in cases:
            ws = [rnd(s, s[1] ** -0.5, torch.float32)
                  for s in ((E, d, Fh), (E, d, Fh), (E, Fh, d))]      # w_in, w_gate, w_out
            if fmt == "int8":
                qs = [quantize_stack_int8(w[None], dev, "channel") for w in ws]
                wq = [(q[0].to(dev), s[0].to(dev)) for q, s in qs]
                deq = [ref.dequantize_ref(q, s) for q, s in wq]
            elif fmt == "int4":
                qs = [quantize_stack_int4(w[None], dev, 64) for w in ws]
                wq = [(q[0].to(dev), s[0].to(dev)) for q, s in qs]
                deq = [ref.dequantize_q4_ref(q, s, k) for (q, s), k in zip(wq, (d, d, Fh))]
            for dtype, tol in tols:
                xe = rnd((E, C, d), 1.0, dtype)
                if fmt == "bf16":
                    wi, wg, wo = (w.to(dtype) for w in ws)
                    args, fn, plain = (xe, wi, wg, wo), expert_ffn_cuda, ref.expert_ffn_ref
                    wbytes = nb(wi, wg, wo)
                    wi_f, wg_f, wo_f = wi, wg, wo
                else:
                    (wi_q, wi_s), (wg_q, wg_s), (wo_q, wo_s) = wq
                    args = (xe, wi_q, wi_s, wg_q, wg_s, wo_q, wo_s)
                    fn, plain = ((expert_ffn_q_cuda, ref.expert_ffn_q_ref) if fmt == "int8"
                                 else (expert_ffn_q4_cuda, ref.expert_ffn_q4_ref))
                    wbytes = nb(wi_q, wi_s, wg_q, wg_s, wo_q, wo_s)
                    wi_f, wg_f, wo_f = (w.to(dtype) for w in deq)       # pre-dequantised
                got = fn(*args, act="silu")
                torch.cuda.synchronize()
                want = plain(*args, act="silu")

                def lib(xe=xe, wi_f=wi_f, wg_f=wg_f, wo_f=wo_f):
                    return torch.bmm(F.silu(torch.bmm(xe, wg_f)) * torch.bmm(xe, wi_f), wo_f)

                kern = lambda fn=fn, args=args: fn(*args, act="silu")
                bnd = bound_ms(nb(xe, got) + wbytes, 3 * 2 * E * C * d * Fh, peak[dtype])
                rec = report(failed, row, dtype, (E, C, d, Fh), got, want, tol, time_ms(kern),
                             time_ms(lambda plain=plain, args=args: plain(*args, act="silu")),
                             time_ms(lib), bnd,
                             " (bmm+silu*bmm+bmm" + (", pre-dequantised)" if fmt != "bf16" else ")"),
                             graph=(kern, lib))
                if dtype == torch.bfloat16:
                    records[row] = rec

    # --- attention at every form phase 10 launches: ring decode, paged
    # decode and prefill; every ring lane past its wrap
    page = 16
    for suffix, name, (Bp, Sp), B, S, Spg, window, cap, _ in attention_family_cases(lanes,
                                                                                   cache_len):
        cfg = family_config(name, 2)
        H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        for dtype, tol in tols:
            q = rnd((B, H, D), 1.0, dtype)
            k = rnd((B, S, K, D), 1.0, dtype)
            v = rnd((B, S, K, D), 1.0, dtype)
            p = torch.tensor([S + 1000 + 37 * i for i in range(B)], dtype=torch.int32)
            s_idx = torch.arange(S, dtype=torch.int32)[None, :]
            sp = (p[:, None] - ((p[:, None] - s_idx) % S)).to(dev).contiguous()
            p = p.to(dev)
            got = flash_decode_cuda(q, k, v, sp, p, window=window, cap=cap)
            again = flash_decode_cuda(q, k, v, sp, p, window=window, cap=cap)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                failed.append(f"flash_decode/{suffix} {dtype}: a rerun differs")
            want = ref.flash_decode_ref(q, k, v, sp, p, window=window, cap=cap)
            n_keys = min(S, window) if window else S
            bnd = bound_ms(nb(q, k, v, sp, p, got), 4 * B * H * n_keys * D, peak[dtype])
            kern = lambda q=q, k=k, v=v, sp=sp, p=p: flash_decode_cuda(q, k, v, sp, p,
                                                                       window=window, cap=cap)
            qt = q[:, :, None, :]
            kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
            valid = (sp <= p[:, None]) & (sp >= 0)
            if window:
                valid &= sp > p[:, None] - window
            sdpa = lambda qt=qt, kt=kt, vt=vt, valid=valid[:, None, None, :]: (
                F.scaled_dot_product_attention(qt, kt, vt, attn_mask=valid, enable_gqa=True))
            if cap:
                def ring_mask(b, h, qi, ki, sp=sp, p=p):
                    pos = sp[b, ki]
                    ok = (pos >= 0) & (pos <= p[b])
                    return (ok & (pos > p[b] - window)) if window else ok
                lib, label = flex_library(qt, kt, vt, ring_mask, cap, B, 1, S)
                lib_out = lambda lib=lib: lib()[:, :, 0]
            else:
                lib, label, lib_out = sdpa, " (SDPA, enable_gqa)", lambda: sdpa()[:, :, 0]
            print(f"    flash_decode/{suffix} plan (splits) = "
                  f"{decode_plan(B, K, S, H // K, D, dtype)}")
            rec = report(failed, f"flash_decode/{suffix}", dtype, (B, H, D, S, K), got, want, tol,
                         time_ms(kern), time_ms(lambda: ref.flash_decode_ref(
                             q, k, v, sp, p, window=window, cap=cap)),
                         time_ms(lib), bnd, label, graph=(kern, lib))
            library_check(rec, lib_out, want)
            if cap:
                nocap(rec, sdpa)
            if dtype == torch.bfloat16:
                records[f"flash_decode/{suffix}"] = rec
            del k, v, kt, vt

            # the paged run's table: Spg positions over Mp pages, lane b's
            # entry i is pool page b·Mp + i, all valid at the last position
            Mp = -(-Spg // page)
            kpad, vpad = (torch.cat([rnd((B, Spg, K, D), 1.0, dtype),
                                     torch.zeros((B, Mp * page - Spg, K, D), dtype=dtype,
                                                 device=dev)], dim=1) for _ in range(2))
            kp = torch.cat([kpad.reshape(B * Mp, page, K, D),
                            rnd((1, page, K, D), 1.0, dtype)]).contiguous()
            vp = torch.cat([vpad.reshape(B * Mp, page, K, D),
                            rnd((1, page, K, D), 1.0, dtype)]).contiguous()
            pt = torch.arange(B * Mp, dtype=torch.int32, device=dev).reshape(B, Mp).contiguous()
            pl = torch.full((B,), Spg - 1, dtype=torch.int32, device=dev)
            gotp = flash_decode_paged_cuda(q, kp, vp, pt, pl, window=window, cap=cap)
            torch.cuda.synchronize()
            wantp = ref.flash_decode_paged_ref(q, kp, vp, pt, pl, window=window, cap=cap)
            n_keys = min(Spg, window) if window else Spg
            bnd = bound_ms(2 * B * -(-n_keys // page) * page * K * D * kp.element_size()
                           + nb(q, pt, pl, gotp), 4 * B * H * n_keys * D, peak[dtype])
            kern = lambda q=q, kp=kp, vp=vp, pt=pt, pl=pl: flash_decode_paged_cuda(
                q, kp, vp, pt, pl, window=window, cap=cap)
            rec = report(failed, f"flash_decode_paged/{suffix}", dtype, (B, H, D, Mp, page), gotp,
                         wantp, tol, time_ms(kern), time_ms(lambda: ref.flash_decode_paged_ref(
                             q, kp, vp, pt, pl, window=window, cap=cap)), None, bnd,
                         graph=(kern, None))
            # no PyTorch call reads through a page table: SDPA on the same
            # keys as a ring beside it (untimed gather), where it computes
            # the same function
            if not cap:
                spl = torch.arange(Mp * page, dtype=torch.int32, device=dev)[None, :]
                valid = (spl <= pl[:, None]) & ((spl > pl[:, None] - window) if window else True)
                ktp, vtp = (t.transpose(1, 2).contiguous() for t in (kpad, vpad))
                gsdpa = lambda qt=qt, ktp=ktp, vtp=vtp, valid=valid[:, None, None, :]: (
                    F.scaled_dot_product_attention(qt, ktp, vtp, attn_mask=valid,
                                                   enable_gqa=True))
                rec.update(gathered_sdpa_ms=time_ms(gsdpa), gathered_sdpa_device_ms=graph_ms(gsdpa))
                del ktp, vtp
            if dtype == torch.bfloat16:
                records[f"flash_decode_paged/{suffix}"] = rec
            del kpad, vpad, kp, vp

            # prefill over [Bp, Sp]
            row = f"flash_prefill/{suffix}"
            q, k, v = (rnd((Bp, Sp, n, D), 1.0, dtype) for n in (H, K, K))
            got = flash_prefill_cuda(q, k, v, window=window, cap=cap)
            torch.cuda.synchronize()
            want = ref.flash_prefill_ref(q, k, v, window=window, cap=cap)
            i = np.arange(Sp)
            band = (i[:, None] >= i[None, :]) & ((i[None, :] > i[:, None] - window) if window
                                                 else True)
            bnd = bound_ms(nb(q, k, v, got), 4 * Bp * H * D * int(band.sum()), peak[dtype])
            kern = lambda q=q, k=k, v=v: flash_prefill_cuda(q, k, v, window=window, cap=cap)
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            if window:
                band = torch.from_numpy(band).to(dev)
                sdpa = lambda qt=qt, kt=kt, vt=vt, band=band: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=band, enable_gqa=True)
            else:
                sdpa = lambda qt=qt, kt=kt, vt=vt: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
            if cap:
                def band_mask(b, h, qi, ki):
                    ok = qi >= ki
                    return (ok & (ki > qi - window)) if window else ok
                lib, label = flex_library(qt, kt, vt, band_mask, cap, None, Sp, Sp)
            else:
                lib, label = sdpa, " (SDPA, enable_gqa)"
            rec = report(failed, row, dtype, tuple(q.shape), got, want, tol, time_ms(kern),
                         time_ms(lambda: ref.flash_prefill_ref(q, k, v, window, cap, True)),
                         time_ms(lib), bnd, label, graph=(kern, lib))
            library_check(rec, lambda lib=lib: lib().transpose(1, 2), want)
            if cap:
                nocap(rec, sdpa)
            if dtype == torch.bfloat16:
                records[row] = rec
            del q, k, v, qt, kt, vt, got, want

    # outside the accepted set, the wrappers refuse on the card
    for fn, shape in ((lambda q: flash_decode_cuda(q, q.new_zeros((1, 8, 2, 128)),
                                                   q.new_zeros((1, 8, 2, 128)),
                                                   torch.zeros((1, 8), dtype=torch.int32,
                                                               device=dev),
                                                   torch.zeros((1,), dtype=torch.int32,
                                                               device=dev)), (1, 34, 128)),
                      (lambda q: flash_prefill_cuda(q, q, q), (1, 8, 2, 96))):
        try:
            fn(torch.zeros(shape, dtype=torch.bfloat16, device=dev))
            failed.append(f"a shape outside the accepted set was not refused: {shape}")
        except ValueError as exc:
            print(f"    refused on the card, as it must be: {exc}")
    if failed:
        raise SystemExit(f"chip_smoke: kernels disagree with their plain versions: {failed}")
    return records


# nemotron-3-nano (NVIDIA-Nemotron-3-Nano-30B-A3B, block kind nemotron_h) at
# full width: its pattern's first NEMOTRON_DEPTH blocks (MEMEM*: 3 Mamba-2,
# 2 MoE, 1 attention; the published depth is 52), every MoE block's 128
# relu² experts on 128 slots, as the benchmark's nemotron3nano.batch holds
# them, batches of NEMOTRON_BATCH; the tiered run splits the same 128-slot
# budget into 64 hot int8 and 64 warm int4 slots (FAMILY_TIER), whose
# capacity is the same
NEMOTRON_DEPTH, NEMOTRON_SLOTS, NEMOTRON_BATCH = 6, 128, (8, 1024)
NEMOTRON_KERNELS = {"sida-bf16": ("expert_ffn", "sparsemax", "flash_prefill"),
                    "sida-int8": ("expert_ffn_q", "sparsemax", "flash_prefill"),
                    "sida-tiered": ("expert_ffn_q", "expert_ffn_q4", "sparsemax",
                                    "flash_prefill")}


def nemotron_config(depth: int = 0, dtype: str = "bfloat16"):
    """The published nemotron-3-nano (`configs/nemotron3_nano.py`, not in the
    registry) at `dtype`, cut to its pattern's first `depth` blocks."""
    from repro_torch.configs.nemotron3_nano import CONFIG

    cfg = dataclasses.replace(CONFIG, dtype=dtype)
    if depth:
        cfg = dataclasses.replace(cfg, n_layers=depth, attn=dataclasses.replace(
            cfg.attn, layer_pattern=cfg.attn.layer_pattern[:depth]))
    return cfg


def nemotron_cases():
    """Phase 2's nemotron rows: (row, format, slots, rows a slot) at the
    batch capacity of NEMOTRON_BATCH over NEMOTRON_SLOTS slots, the launch
    shapes of phase 10e's runs: bf16 and int8 slots over all 128, the
    tiered run's hot int8 and warm int4 blocks of 64 each."""
    cfg = nemotron_config()
    C = batch_capacity(cfg, *NEMOTRON_BATCH, NEMOTRON_SLOTS)
    hot, warm = family_tiers(cfg, NEMOTRON_SLOTS)
    return (("expert_ffn/nemotron-batch", "bf16", NEMOTRON_SLOTS, C),
            ("expert_ffn_q/nemotron-batch", "int8", NEMOTRON_SLOTS, C),
            ("expert_ffn_q/nemotron-tiered-hot", "int8", hot, C),
            ("expert_ffn_q4/nemotron-tiered-warm", "int4", warm, C))


def check_nemotron_kernels():
    """Phase 2, nemotron's relu² experts (d 2688 -> F 1856, not gated: the
    epilogue's relu(h)² in place of GELU or the GLU product) at
    `nemotron_cases`' shapes, bf16 slots and the int8 / int4 slot formats,
    each in fp32 within 1e-4 and in bf16 within 5e-2 * max(1, |y|) of each
    element of its plain version on the same inputs; the library is bmm,
    relu², bmm (over weights dequantised ahead of time for int8 / int4).
    The bf16 bound is phase 2's 5e-2 where |y| <= 1, scaled where relu²
    gives larger outputs: over [128, 480] rows y reaches 8 and more, where
    one bf16 ulp is 6.25e-2 and the kernel and the plain version, each
    rounding y to bf16 after summing in another order, differ by one.
    Returns {row: bf16 record}."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core.offload import quantize_stack_int4, quantize_stack_int8
    from repro_torch.kernels import ref
    from repro_torch.kernels.expert_gemm import (expert_ffn_cuda, expert_ffn_q4_cuda,
                                                 expert_ffn_q_cuda)

    cfg = nemotron_config()
    d, Fh, act = cfg.d_model, cfg.moe.d_expert, cfg.act
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(655)

    def rnd(shape, scale, dtype):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    records, failed = {}, []
    peak = {torch.bfloat16: H100_BF16_FLOPS, torch.float32: H100_F32_FLOPS}
    for row, fmt, E, C in nemotron_cases():
        ws = [rnd(sh, sh[1] ** -0.5, torch.float32) for sh in ((E, d, Fh), (E, Fh, d))]
        if fmt == "int8":
            wq = [(q[0].to(dev), sc[0].to(dev))
                  for q, sc in (quantize_stack_int8(w[None], dev, "channel") for w in ws)]
            deq = [ref.dequantize_ref(q, sc) for q, sc in wq]
        elif fmt == "int4":
            wq = [(q[0].to(dev), sc[0].to(dev))
                  for q, sc in (quantize_stack_int4(w[None], dev, 64) for w in ws)]
            deq = [ref.dequantize_q4_ref(q, sc, k) for (q, sc), k in zip(wq, (d, Fh))]
        for dtype in (torch.bfloat16, torch.float32):
            xe = rnd((E, C, d), 1.0, dtype)
            if fmt == "bf16":
                wi, wo = (w.to(dtype) for w in ws)
                args, fn, plain = (xe, wi, None, wo), expert_ffn_cuda, ref.expert_ffn_ref
                wbytes, wi_f, wo_f = nb(wi, wo), wi, wo
            else:
                (wi_q, wi_s), (wo_q, wo_s) = wq
                args = (xe, wi_q, wi_s, None, None, wo_q, wo_s)
                fn, plain = ((expert_ffn_q_cuda, ref.expert_ffn_q_ref) if fmt == "int8"
                             else (expert_ffn_q4_cuda, ref.expert_ffn_q4_ref))
                wbytes = nb(wi_q, wi_s, wo_q, wo_s)
                wi_f, wo_f = (w.to(dtype) for w in deq)
            got = fn(*args, act=act)
            torch.cuda.synchronize()
            want = plain(*args, act=act)
            tol = 5e-2 * want.float().abs().clamp(min=1.0) if dtype == torch.bfloat16 else 1e-4

            def lib(xe=xe, wi_f=wi_f, wo_f=wo_f):
                return torch.bmm(F.relu(torch.bmm(xe, wi_f)).square(), wo_f)

            kern = lambda fn=fn, args=args: fn(*args, act=act)
            bnd = bound_ms(nb(xe, got) + wbytes, 2 * 2 * E * C * d * Fh, peak[dtype])
            rec = report(failed, row, dtype, (E, C, d, Fh), got, want, tol, time_ms(kern),
                         time_ms(lambda plain=plain, args=args: plain(*args, act=act)),
                         time_ms(lib), bnd,
                         " (bmm+relu²+bmm" + (", pre-dequantised)" if fmt != "bf16" else ")"),
                         graph=(kern, lib))
            if dtype == torch.bfloat16:
                records[row] = rec
            del xe, got, want
        torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"chip_smoke: kernels disagree with their plain versions: {failed}")
    return records


def nemotron_path(n_batches: int = 2):
    """Phase 10e: nemotron-3-nano at full width, its first NEMOTRON_DEPTH
    blocks, bf16, seeded weights drawn on the card and kept on the host;
    `n_batches` of NEMOTRON_BATCH through `SiDAEngine` (threaded, after one
    warm-up batch) at NEMOTRON_SLOTS slots a MoE block on bf16 slots, on
    int8 slots and on hot int8 / warm int4 tiers. Gates: finite logits of
    the right shape, the tiered store's (S8, S4) those phase 2 held, each
    run's kernels launched. Returns {run: launch counts}."""
    import numpy as np
    import torch

    from repro_torch.configs.base import TierConfig
    from repro_torch.core.engine import SiDAEngine
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import n_moe_layers

    cfg = nemotron_config(NEMOTRON_DEPTH)
    m, slots = cfg.moe, NEMOTRON_SLOTS
    routed = n_moe_layers(cfg) * m.num_experts * 3 * cfg.d_model * m.d_expert * 2
    print(f"  blocks {''.join({'mamba2': 'M', 'moe': 'E', 'global': '*'}[k] for k in cfg.attn.layer_pattern)} "
          f"of 52, width as published: d_model {cfg.d_model}, Mamba-2 {cfg.ssm.mamba2_heads} heads "
          f"of {cfg.ssm.mamba2_head_dim} (state {cfg.ssm.state_dim}, {cfg.ssm.n_groups} groups), "
          f"{m.num_experts} experts top-{m.top_k} of d_expert {m.d_expert} ({cfg.act}, "
          f"GLU={cfg.glu}), vocab {cfg.vocab_size}; {slots} slots a MoE block; the store's "
          f"routed stacks on the host {routed} bytes beside MemTotal {host_mem_total()} bytes")
    t0 = time.perf_counter()
    params, hp = card_seeded_model(cfg)
    print(f"    seeded init (drawn on the card, kept on the host): {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(14)
    batch, seq = NEMOTRON_BATCH
    batches = [rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
               for _ in range(n_batches + 1)]
    V, Vp = cfg.vocab_size, cfg.padded_vocab
    tier = TierConfig(int4_slots=True, **FAMILY_TIER)
    counts = {}
    for run, kw in (("sida-bf16", {}), ("sida-int8", dict(quantized_slots=True)),
                    ("sida-tiered", dict(quantized_slots=True, tier=tier))):
        t0 = time.perf_counter()
        eng = SiDAEngine(cfg, params, hp, slots_per_layer=slots, device="cuda", **kw)
        setup = time.perf_counter() - t0
        eng.serve(batches[:1], threaded=False)        # warm-up
        torch.cuda.synchronize()
        ops.reset_launches()
        met = eng.serve(batches[1:], threaded=True)
        got = ops.launches()
        for i, r in enumerate(eng.results):
            if r is None or tuple(r.shape) != (batch, seq, Vp) or not torch.isfinite(
                    r[..., :V]).all():
                raise SystemExit(f"chip_smoke: nemotron {run} batch {i}: logits "
                                 f"{None if r is None else tuple(r.shape)} not finite / shape")
        geom = (eng.store.S8, eng.store.S4)
        print(f"    ({run}) slots={slots} (S8={geom[0]} S4={geom[1]}) setup_s={setup:.2f} "
              f"{n_batches} x [{batch}, {seq}] throughput_tok_s={met.throughput:.1f} "
              f"mean_latency_s={met.mean_latency:.5f} wall_s={met.wall_s:.4f}")
        print(f"      launches {json.dumps(got)}")
        if "tier" in kw and geom != family_tiers(cfg, slots):
            raise SystemExit(f"chip_smoke: nemotron's tiered store has (S8, S4) = {geom}, "
                             f"phase 2 checked {family_tiers(cfg, slots)}")
        idle = [k for k in NEMOTRON_KERNELS[run] if got[k] == 0]
        if idle:
            raise SystemExit(f"chip_smoke: kernels never launched on nemotron's {run} run: {idle}")
        counts[run] = got
        eng.close()
        del eng
        torch.cuda.empty_cache()
    del params
    return counts


def host_mem_total() -> int:
    """MemTotal of /proc/meminfo, in bytes."""
    with open("/proc/meminfo") as fh:
        for line in fh:
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) * 1024
    raise SystemExit("chip_smoke: /proc/meminfo has no MemTotal")


def card_seeded_model(cfg):
    """A phase-10 model's weights: drawn on the card from seeded CUDA
    generators (model seed 0, predictor d_h 64 seed 1) and kept on the host,
    as `repro_torch.launch.serve` keeps them (the host's generator would
    take a minute for qwen3's 9.7 GB of experts)."""
    import torch

    from repro_torch.core.hash_fn import init_hash_fn
    from repro_torch.models.transformer import init_params, n_moe_layers

    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cpu")
    hp = None
    if cfg.moe.enabled:
        hp = init_hash_fn(torch.Generator(device="cuda").manual_seed(1), cfg.d_model,
                          n_moe_layers(cfg), cfg.moe.num_experts, d_h=64, device="cpu")
    return params, hp


FAMILY_KERNELS = {"sida-sync": ("expert_ffn", "sparsemax", "flash_prefill"),
                  "sida-threaded": ("expert_ffn", "sparsemax", "flash_prefill"),
                  "standard": ("expert_ffn", "flash_prefill"),
                  "decode-bf16": ("flash_decode", "expert_ffn", "sparsemax"),
                  "decode-tiered-paged": ("flash_decode_paged", "expert_ffn_q", "expert_ffn_q4",
                                          "sparsemax")}


def moe_family_path(name: str, depth: int, slots: int, lanes: int, cache_len: int,
                    n_batches: int = 4, steps: int = 32):
    """Phase 10a / 10b: one MoE attention-family config at full width, cut to
    `depth` layers, bf16, seeded weights. A batch serve of `n_batches` of
    [batch, seq] through `SiDAEngine` at `slots` a MoE layer (synchronous,
    then threaded) against `Standard` with every expert resident; then
    decode, `lanes` x `steps`, over a `cache_len`-slot ring on bf16 slots,
    then on hot int8 / warm int4 tiers (the same int8-slot budget split 0.5)
    over a paged pool. Gates: finite logits of the right shape, tokens in
    the vocab, the SiDA saving exactly 1 - slots / E, each run's kernels
    launched. Returns ({run: launch counts, "by_shape": {run:
    `ops.launches_by_shape()`}}, {run: summary numbers})."""
    import numpy as np
    import torch

    from repro_torch.configs.base import TierConfig, get_config
    from repro_torch.core.baselines import StandardServer
    from repro_torch.core.decode_engine import SiDADecodeEngine
    from repro_torch.core.engine import SiDAEngine
    from repro_torch.core.offload import nbytes
    from repro_torch.core.residency import PagedKVConfig
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import n_moe_layers
    from repro_torch.tree import tree_leaves

    published = get_config(name)
    cfg = family_config(name, depth)
    m = cfg.moe
    L, E = n_moe_layers(cfg), m.num_experts
    routed = L * E * 3 * cfg.d_model * m.d_expert * 2
    mem = host_mem_total()
    print(f"  ({name}) depth {depth} of {published.n_layers} (cut for the host's init and the "
          f"call's time), width as published: d_model {cfg.d_model}, {cfg.n_heads} query / "
          f"{cfg.n_kv_heads} kv heads of {cfg.hd} (group {cfg.n_heads // cfg.n_kv_heads}), "
          f"{E} experts top-{m.top_k} of d_expert {m.d_expert} ({m.num_shared_experts} shared of "
          f"{m.d_shared}), {cfg.act} GLU={cfg.glu}, vocab {cfg.vocab_size}; {slots} slots a MoE "
          f"layer")
    print(f"    routed experts on the host: {routed} bytes ({routed / 1e9:.2f} GB) beside "
          f"MemTotal {mem} bytes ({mem / 1e9:.1f} GB)")
    if mem < 3 * routed:
        raise SystemExit(f"chip_smoke: phase 10 serves {name} at depth {depth} with "
                         f"{routed / 1e9:.2f} GB of routed experts and needs about "
                         f"{3 * routed / 1e9:.1f} GB of host memory; this host has "
                         f"{mem / 1e9:.1f} GB")
    t0 = time.perf_counter()
    params, hp = card_seeded_model(cfg)
    print(f"    seeded init (drawn on the card, kept on the host): {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(10)
    batch, seq = FAMILY_BATCH
    batches = [rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
               for _ in range(n_batches)]
    n_tok = n_batches * batch * seq
    V, Vp = cfg.vocab_size, cfg.padded_vocab
    counts, summary = {"by_shape": {}}, {}

    def gate(run, got, shapes):
        counts[run] = got
        counts["by_shape"][run] = shapes
        print(f"    launches {json.dumps(got)}")
        idle = [k for k in FAMILY_KERNELS[run] if got[k] == 0]
        if idle:
            raise SystemExit(f"chip_smoke: kernels never launched on {name}'s {run} run: {idle}")

    t0 = time.perf_counter()
    eng = SiDAEngine(cfg, params, hp, slots_per_layer=slots, device="cuda")
    print(f"    (sida) setup_s={time.perf_counter() - t0:.2f}")
    eng.serve(batches[:1], threaded=False)        # warm-up
    eng.store.stats.reset()
    for run, threaded in (("sida-sync", False), ("sida-threaded", True)):
        torch.cuda.synchronize()
        ops.reset_launches()
        met = eng.serve(batches, threaded=threaded)
        got, shapes = ops.launches(), ops.launches_by_shape()
        for i, r in enumerate(eng.results):
            if r is None or tuple(r.shape) != (batch, seq, Vp) or not torch.isfinite(
                    r[..., :V]).all():
                raise SystemExit(f"chip_smoke: {name} {run} batch {i}: logits "
                                 f"{None if r is None else tuple(r.shape)} not finite / shape")
        print(f"    ({run}) {n_batches} x [{batch}, {seq}] tokens={n_tok} "
              f"throughput_tok_s={met.throughput:.1f} mean_latency_s={met.mean_latency:.5f} "
              f"hash_time_s={met.hash_time_s:.4f} wall_s={met.wall_s:.4f}")
        summary[run] = met.throughput
        gate(run, got, shapes)
    st = eng.store.stats
    saving = eng.memory_saving()
    sida_dev = eng.device_memory_bytes()
    print(f"    store loads={st.loads} hits={st.hits} evictions={st.evictions} dropped={st.dropped} "
          f"bytes_h2d={st.bytes_h2d} sync_upload_s={st.prepare_time:.4f}")
    print(f"    device_memory_bytes={sida_dev} expert_device_bytes={eng.store.device_bytes()} "
          f"memory_saving full_expert_gb={saving['full_expert_gb']:.4f} "
          f"resident_expert_gb={saving['resident_expert_gb']:.4f} "
          f"reduction={saving['reduction']:.4f} (1 - {slots}/{E} = {1 - slots / E:.4f})")
    if abs(saving["reduction"] - (1 - slots / E)) > 1e-9:
        raise SystemExit(f"chip_smoke: {name}'s SiDA expert saving {saving['reduction']} is not "
                         f"1 - slots / E")
    eng.close()
    del eng
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    std = StandardServer(cfg, params, device="cuda")
    setup = time.perf_counter() - t0
    std.serve(batches[:1])
    torch.cuda.synchronize()
    ops.reset_launches()
    met = std.serve(batches)
    got, shapes = ops.launches(), ops.launches_by_shape()
    std_dev = std.device_memory_bytes()
    print(f"    (standard, all {E} experts resident) setup_s={setup:.2f} "
          f"throughput_tok_s={met.throughput:.1f} mean_latency_s={met.mean_latency:.5f} "
          f"wall_s={met.wall_s:.4f} device_memory_bytes={std_dev}")
    gate("standard", got, shapes)
    summary["standard"] = met.throughput
    summary["device_saving"] = 1 - sida_dev / std_dev
    print(f"    SiDA against Standard: device memory saving {summary['device_saving']:.4f} "
          f"({sida_dev} of {std_dev} bytes), throughput x{summary['sida-threaded'] / met.throughput:.4f}"
          f" (threaded), expert saving {saving['reduction']:.4f}")
    del std
    torch.cuda.empty_cache()

    start = np.random.default_rng(11).integers(0, V, (lanes,)).astype(np.int32)
    tier = TierConfig(int4_slots=True, **FAMILY_TIER)
    paged = PagedKVConfig(page_size=16, kv_pages=256, max_seq=cache_len)
    for run, kw, gen_kw in (
            ("decode-bf16", {}, {}),
            ("decode-tiered-paged", dict(quantized_slots=True, tier=tier), dict(paged=paged))):
        t0 = time.perf_counter()
        deng = SiDADecodeEngine(cfg, params, hp, slots_per_layer=slots, device="cuda", **kw)
        setup = time.perf_counter() - t0
        torch.cuda.synchronize()
        ops.reset_launches()
        toks, dm = deng.generate(start, steps=steps, cache_len=cache_len, **gen_kw)
        got, shapes = ops.launches(), ops.launches_by_shape()
        st = deng.store.stats
        dev_bytes = sum(nbytes(x) for x in tree_leaves(deng.store.serve_params))
        print(f"    ({run}) slots={slots} (S8={deng.store.S8} S4={deng.store.S4}) lanes={lanes} "
              f"steps={steps} cache_len={cache_len} setup_s={setup:.2f}")
        print(f"      tok_s={dm.tok_s:.1f} ms_per_step={1e3 * dm.wall_s / dm.steps:.3f} "
              f"wall_s={dm.wall_s:.4f} loads first_step={dm.loads_per_step[0]} "
              f"last_step={dm.loads_per_step[-1]} total={st.loads} evictions={st.evictions} "
              f"promotions={st.promotions} demotions={st.demotions} bytes_h2d={st.bytes_h2d}")
        print(f"      device_memory_bytes={dev_bytes} expert_device_bytes={deng.store.device_bytes()}"
              + (f" kv_pool_bytes={deng.kv_pool.kv_pool_bytes()}" if deng.kv_pool is not None
                 else ""))
        if toks.shape != (lanes, steps) or toks.min() < 0 or toks.max() >= V:
            raise SystemExit(f"chip_smoke: {name} {run} emitted out-of-vocab tokens")
        if "tier" in kw and (deng.store.S8, deng.store.S4) != family_tiers(cfg, slots):
            raise SystemExit(f"chip_smoke: {name}'s tiered store has (S8, S4) = "
                             f"{(deng.store.S8, deng.store.S4)}, phase 2 checked "
                             f"{family_tiers(cfg, slots)}")
        gate(run, got, shapes)
        summary[run] = (dm.tok_s, 1e3 * dm.wall_s / dm.steps)
        deng.close()
        del deng
        torch.cuda.empty_cache()
    del params
    return counts, summary


def moe_family_card_vs_cpu(name: str, slots: int, lanes: int = 4, steps: int = 16):
    """Phase 10c: `name` at full width, 1 layer, fp32, `lanes` x `steps` of
    decode on the card and on the CPU with the same weights: the hash ids
    and slot trace of every step, the greedy tokens and the per-step loads
    identical; one fixed table's decode_step logits within
    1e-3 * max(1, max|logit|)."""
    import numpy as np
    import torch

    from repro_torch.core.decode_engine import SiDADecodeEngine
    from repro_torch.core.hash_table import HashTable
    from repro_torch.models.transformer import decode_step, init_cache, n_moe_layers

    cfg = family_config(name, 1, "float32")
    params, hp = card_seeded_model(cfg)
    L, k = n_moe_layers(cfg), cfg.moe.top_k
    start = np.random.default_rng(12).integers(0, cfg.vocab_size, (lanes,)).astype(np.int32)
    eng = {dev: SiDADecodeEngine(cfg, params, hp, slots_per_layer=slots, device=dev)
           for dev in ("cuda", "cpu")}
    # a fixed table of k distinct experts a lane, all within the budget
    rng = np.random.default_rng(13)
    ids = np.stack([rng.permutation(slots)[:k] for _ in range(L * lanes)])
    ids = ids.reshape(L, lanes, 1, k).astype(np.int32)
    w = np.full((L, lanes, 1, k), 1.0 / k, np.float32)
    logits = {}
    with torch.inference_mode():
        for dev, e in eng.items():
            trans = e.store.prepare(HashTable(0, ids, w))
            slot_ids, sw = e.store.translate_device(torch.as_tensor(ids, device=dev),
                                                    torch.as_tensor(w, device=dev), trans)
            cache = init_cache(cfg, lanes, 32, device=dev)
            lg, _ = decode_step(e.store.serve_params, cache, torch.as_tensor(start, device=dev),
                                cfg, routing_override=(slot_ids[:, :, 0], sw[:, :, 0]))
            logits[dev] = lg.float().cpu().numpy()[:, :cfg.vocab_size]
    record = {}
    for dev, e in eng.items():
        trace, prepare = [], e.store.prepare

        def rec(table, prepare=prepare, trace=trace):
            trans = prepare(table)
            trace.append((np.array(table.expert_ids, copy=True), np.array(trans, copy=True)))
            return trans

        e.store.prepare = rec
        record[dev] = trace
    out = {dev: e.generate(start, steps=steps, cache_len=64) for dev, e in eng.items()}
    same_tok = bool(np.array_equal(out["cuda"][0], out["cpu"][0]))
    same_loads = out["cuda"][1].loads_per_step == out["cpu"][1].loads_per_step
    same_ids = all(np.array_equal(a[0], b[0]) for a, b in zip(record["cuda"], record["cpu"]))
    same_trace = all(np.array_equal(a[1], b[1]) for a, b in zip(record["cuda"], record["cpu"]))
    err = float(np.abs(logits["cuda"] - logits["cpu"]).max())
    scale = float(np.abs(logits["cpu"]).max())
    tol = 1e-3 * max(1.0, scale)
    print(f"  ({name}) fp32 n_layers=1 lanes={lanes} steps={steps}: tokens identical={same_tok} "
          f"loads identical={same_loads} ({sum(out['cpu'][1].loads_per_step)} loads) hash ids "
          f"identical={same_ids} slot traces identical={same_trace} ({len(record['cpu'])} steps); "
          f"decode_step logits max_abs_err={err:.3e} tol={tol:.3e} max|logit|={scale:.3f}")
    if not (same_tok and same_loads and same_ids and same_trace and len(record["cpu"]) == steps
            and err <= tol and np.isfinite(logits["cuda"]).all()):
        raise SystemExit(f"chip_smoke: card and CPU disagree on {name}'s decode path")
    for e in eng.values():
        e.close()


def seed_ring(cache: dict, kv: dict, S: int) -> None:
    """A prompt's K/V [G, B, S, K, D] into a ring cache, in place: position
    p at slot p % Sc, the last Sc positions kept (a windowed layer's ring
    holds its window; the server's `_seed_lanes` writes a prompt that fits
    its ring); the lanes continue at position S."""
    import torch

    for skey, (k, v) in kv.items():
        entry = cache[skey]
        Sc = entry["k"].shape[2]
        keep = torch.arange(max(0, S - Sc), S, device=k.device)
        entry["k"][:, :, keep % Sc] = k[:, :, keep].to(entry["k"].dtype)
        entry["v"][:, :, keep % Sc] = v[:, :, keep].to(entry["v"].dtype)
    cache["pos"] = torch.full_like(cache["pos"], S)


def dense_family_path(name: str, shape, steps: int = DENSE_STEPS):
    """Phase 10d: `name` at full width, 2 layers, bf16, seeded weights:
    `forward` over `shape` [B, S] with the prompt's K/V, then `steps` greedy
    `decode_step`s from it over a ring cache and again over a paged cache
    that a `KVPagePool` seeds (`seed`) and extends (`ensure`) per lane.
    On the CPU, in fp32 from the same (bf16) weights: the forward and the
    ring steps (fed the card's tokens). Gates: the card's logits within
    5e-2 * max(1, max|logit|) of the CPU's (forward and every step), the
    paged steps within that bound of the ring's, the kernels launched.
    Returns {"ring": launch counts of forward + ring steps, "paged": of the
    paged steps, "by_shape": {"ring" / "paged": `ops.launches_by_shape()`}}."""
    import numpy as np
    import torch

    from repro_torch.configs.base import get_config
    from repro_torch.core.residency import KVPagePool, PagedKVConfig
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import decode_step, forward, init_cache
    from repro_torch.tree import tree_map

    cfg = family_config(name, 2)
    B, S = shape
    t0 = time.perf_counter()
    host, _ = card_seeded_model(cfg)
    params = tree_map(lambda t: t.to("cuda"), host)
    toks = np.random.default_rng(14).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    V = cfg.vocab_size
    windows = sorted({cfg.layer_window(i) for i in range(cfg.n_layers)})
    print(f"  ({name}) 2 of {get_config(name).n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.hd}, "
          f"windows {windows}, softcap {cfg.attn.logit_softcap}, vocab {V}; forward over "
          f"[{B}, {S}], then {steps} decode steps (init {time.perf_counter() - t0:.2f} s)")
    counts = {"by_shape": {}}
    with torch.inference_mode():
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = forward(params, cfg, torch.as_tensor(toks, device="cuda"), collect_kv=True)
        torch.cuda.synchronize()
        t_fwd = time.perf_counter() - t0
        lg_fwd = out["logits"]
        cache = init_cache(cfg, B, S + steps, device="cuda")
        seed_ring(cache, out["kv"], S)
        Mp = -(-(S + steps) // 16)
        pool = KVPagePool(cfg, PagedKVConfig(page_size=16, kv_pages=B * Mp, max_seq=Mp * 16), B,
                          device="cuda")
        paged = pool.init_cache()
        for b in range(B):
            paged = pool.seed(paged, b, {skey: (k[:, b], v[:, b])
                                         for skey, (k, v) in out["kv"].items()}, S)
            paged = pool.ensure(paged, b, S + steps)
        paged["page_table"] = pool.device_table()
        paged["pos"] = torch.full((B,), S, dtype=torch.int32, device="cuda")
        del out
        tok = torch.argmax(lg_fwd[:, -1, :V], dim=-1).to(torch.int32)
        fed, ring_lg = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fed.append(tok)
            lg, cache = decode_step(params, cache, tok, cfg)
            ring_lg.append(lg[:, :V].float().cpu())
            tok = torch.argmax(lg[:, :V], dim=-1).to(torch.int32)
        t_dec = (time.perf_counter() - t0) / steps
        counts["ring"] = ops.launches()
        counts["by_shape"]["ring"] = ops.launches_by_shape()
        ops.reset_launches()
        paged_err = 0.0
        for i in range(steps):
            lg, paged = decode_step(params, paged, fed[i], cfg)
            paged_err = max(paged_err, (lg[:, :V].float().cpu() - ring_lg[i]).abs().max().item())
        counts["paged"] = ops.launches()
        counts["by_shape"]["paged"] = ops.launches_by_shape()
        lg_fwd = lg_fwd[..., :V].float().cpu()
    del params, cache, paged
    torch.cuda.empty_cache()
    print(f"    card: forward {1e3 * t_fwd:.1f} ms, decode {1e3 * t_dec:.3f} ms a step; launches "
          f"ring {json.dumps(counts['ring'])} paged {json.dumps(counts['paged'])}")
    for run, need in (("ring", ("flash_prefill", "flash_decode")),
                      ("paged", ("flash_decode_paged",))):
        idle = [k for k in need if counts[run][k] == 0]
        if idle:
            raise SystemExit(f"chip_smoke: kernels never launched on {name}'s {run} run: {idle}")

    # the CPU path, fp32, from the same bf16 weights; fed the card's tokens
    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params = tree_map(lambda t: t.float(), host)
    del host
    with torch.inference_mode():
        out = forward(params, cfg32, torch.as_tensor(toks), collect_kv=True)
        err_f = (lg_fwd - out["logits"][..., :V]).abs().max().item()
        tol_f = 5e-2 * max(1.0, out["logits"][..., :V].abs().max().item())
        cache = init_cache(cfg32, B, S + steps, device="cpu")
        seed_ring(cache, out["kv"], S)
        del out
        err_d = tol_d = 0.0
        for i in range(steps):
            lg, cache = decode_step(params, cache, fed[i].cpu(), cfg32)
            err_d = max(err_d, (ring_lg[i] - lg[:, :V]).abs().max().item())
            tol_d = max(tol_d, 5e-2 * max(1.0, lg[:, :V].abs().max().item()))
    print(f"    card vs CPU (fp32, {time.perf_counter() - t0:.1f} s): forward max_abs_err="
          f"{err_f:.3e} tol={tol_f:.3e}; decode steps max_abs_err={err_d:.3e} tol={tol_d:.3e}; "
          f"paged vs ring steps on the card max_abs_err={paged_err:.3e}")
    if not (err_f <= tol_f and err_d <= tol_d and paged_err <= tol_d
            and torch.isfinite(lg_fwd).all()):
        raise SystemExit(f"chip_smoke: {name}: the card disagrees with the CPU path")
    return counts


# ---------------------------------------------------------------------------
# phase 2, the training shapes; phase 11, the offline phase
# ---------------------------------------------------------------------------

TRAIN_BATCH = (8, 128)                     # phase 11's SyntheticLM batches, [batch, seq]
TRAIN_KERNELS = ("expert_ffn", "flash_prefill")
TKD_STEPS, DRAFT_STEPS = 150, 100          # the get_system recipe's TKD steps; 11b's draft steps
# each Function's node in the autograd graph (torch.profiler's row names)
BACKWARDS = {"expert_ffn": "ExpertFFNBackward", "flash_prefill": "FlashPrefillBackward",
             "sparsemax": "SparsemaxBackward"}


def train_config(cfg, depth: int = 0):
    """switch-base-8 as phase 11 trains it: fp32 (the reference's bench_cfg
    recipe trains in fp32), full width, depth cut only where asked (11c)."""
    return dataclasses.replace(cfg, dtype="float32", n_layers=depth or cfg.n_layers)


def check_backward(failed, rec, name, fn, plain, inputs, bwd, tol, bnd, library=None, tag=""):
    """One Function's backward on the card, added to the phase-2 row `rec`:
    the gradient of <fn(inputs), ct> through the wrapper (the kernel's
    Function) against autograd over `plain` on the same inputs, each leaf
    within tol * max(1, max|g|); then the backward alone timed: `bwd(ct)`
    (the Function's explicit backward), autograd over the plain version and
    over `library` (graph built once, retained)."""
    import torch

    a = [None if t is None else t.detach().clone().requires_grad_(True) for t in inputs]
    b = [None if t is None else t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*a)
    gen = torch.Generator(device="cpu").manual_seed(7)
    ct = torch.randn(tuple(out.shape), generator=gen).to(out.device, out.dtype)
    got = torch.autograd.grad(out, [t for t in a if t is not None], ct)
    want_out = plain(*b)
    live_b = [t for t in b if t is not None]
    want = torch.autograd.grad(want_out, live_b, ct, retain_graph=True)
    torch.cuda.synchronize()
    err, ok = 0.0, True
    for g, w in zip(got, want):
        e = (g.float() - w.float()).abs().max().item()
        bound = tol * max(1.0, w.float().abs().max().item())
        ok &= bool(e <= bound) and bool(torch.isfinite(g.float()).all())
        err = max(err, e / bound)
    k_ms = time_ms(lambda: bwd(ct))
    p_ms = time_ms(lambda: torch.autograd.grad(want_out, live_b, ct, retain_graph=True))
    l_ms = None
    if library is not None:
        c = [None if t is None else t.detach().clone().requires_grad_(True) for t in inputs]
        lib_out = library(*c)
        live_c = [t for t in c if t is not None]
        l_ms = time_ms(lambda: torch.autograd.grad(lib_out, live_c, ct, retain_graph=True))
    print(f"  {name + ' backward' + tag:28s} worst error / bound = {err:.4f} "
          f"(tol {tol:g} * max(1, max|g|)) {'ok' if ok else 'FAIL'} backward_ms={k_ms:.4f} "
          f"(share_of_bound={bnd[0] / k_ms:.3f}) plain_backward_ms={p_ms:.4f} "
          f"library_backward_ms={'null' if l_ms is None else f'{l_ms:.4f}'} "
          f"backward_bound_ms={bnd[0]:.4f} ({bnd[1]})", flush=True)
    if not ok:
        failed.append(f"{name} backward{tag}")
    key = "backward" + tag.replace(" ", "_")
    rec.update({f"{key}_err_over_tol": err, f"{key}_ms": k_ms, f"{key}_plain_ms": p_ms,
                f"{key}_library_ms": l_ms, f"{key}_bound_ms": bnd[0], f"{key}_bound_by": bnd[1]})


def check_training_kernels(cfg):
    """Phase 2, the training forward's shapes (switch-base-8 fp32, [8, 128]
    tokens): expert_ffn at [8, 160, 768 -> 3072] (capacity 1.25 x 1024 / 8),
    flash_prefill at 12 / 12 heads of 64, sparsemax at the TKD forward's
    [8, 128, 128]; each forward against its plain version (fp32 1e-4,
    sparsemax 1e-5), then its Function's backward against autograd over the
    plain version (fp32 1e-4, and expert_ffn's in bf16 at 5e-2), each timed
    with its bound. Returns {row: record}."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import autograd, ops, ref
    from repro_torch.kernels.expert_gemm import expert_ffn_cuda
    from repro_torch.kernels.flash_prefill import flash_prefill_cuda
    from repro_torch.kernels.sparsemax import sparsemax_cuda

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(321)

    def rnd(shape, scale, dtype):
        return (torch.randn(shape, generator=gen) * scale).to(dtype=dtype, device=dev)

    records, failed = {}, []
    B, S = TRAIN_BATCH
    E, d, Fh = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_expert
    C = batch_capacity(train_config(cfg), B, S, E)
    f32 = torch.float32

    # --- expert_ffn: the training forward's capacity buffer, fp32 (and bf16 backward)
    for dtype, tol, peak in ((f32, 1e-4, H100_F32_FLOPS), (torch.bfloat16, 5e-2, H100_BF16_FLOPS)):
        xe = rnd((E, C, d), 1.0, dtype)
        wi = rnd((E, d, Fh), d ** -0.5, dtype)
        wo = rnd((E, Fh, d), Fh ** -0.5, dtype)
        gemm = 2 * E * C * d * Fh

        def lib(x, i, o):
            return torch.bmm(F.gelu(torch.bmm(x, i), approximate="tanh"), o)

        if dtype == f32:
            got = expert_ffn_cuda(xe, wi, None, wo, act=cfg.act)
            torch.cuda.synchronize()
            want = ref.expert_ffn_ref(xe, wi, None, wo, act=cfg.act)
            kern = lambda: expert_ffn_cuda(xe, wi, None, wo, act=cfg.act)
            rec = report(failed, "expert_ffn/train", dtype, (E, C, d, Fh), got, want, tol,
                         time_ms(kern), time_ms(lambda: ref.expert_ffn_ref(xe, wi, None, wo, cfg.act)),
                         time_ms(lambda: lib(xe, wi, wo)),
                         bound_ms(nb(xe, wi, wo, got), 2 * gemm, peak), " (bmm+gelu+bmm)",
                         graph=(kern, lambda: lib(xe, wi, wo)))
        # the backward recomputes the pre-activation: five GEMMs; it reads
        # x, the weights and dy, and writes dx and the weight gradients
        check_backward(failed, rec, "expert_ffn/train",
                       lambda x, i, o: ops.expert_ffn(x, i, None, o, act=cfg.act),
                       lambda x, i, o: ref.expert_ffn_ref(x, i, None, o, act=cfg.act),
                       [xe, wi, wo],
                       lambda dy: autograd.expert_ffn_backward(xe, wi, None, wo, cfg.act, dy),
                       tol, bound_ms(2 * nb(xe, wi, wo) + nb(xe), 5 * gemm, peak), library=lib,
                       tag="" if dtype == f32 else " bf16")
    records["expert_ffn/train"] = rec

    # --- flash_prefill: 12 / 12 heads of 64 over [8, 128], causal, fp32
    H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = (rnd((B, S, n, D), 1.0, f32) for n in (H, K, K))
    got = flash_prefill_cuda(q, k, v)
    torch.cuda.synchronize()
    want = ref.flash_prefill_ref(q, k, v)
    pairs = S * (S + 1) // 2
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    kern = lambda: flash_prefill_cuda(q, k, v)
    rec = report(failed, "flash_prefill/train", f32, tuple(q.shape), got, want, 1e-4,
                 time_ms(kern), time_ms(lambda: ref.flash_prefill_ref(q, k, v)), time_ms(sdpa),
                 bound_ms(nb(q, k, v, got), 4 * B * H * D * pairs, H100_F32_FLOPS), " (SDPA)",
                 graph=(kern, sdpa))
    # the backward: S again, dP, dV, dQ, dK (five products over the visible pairs)
    check_backward(failed, rec, "flash_prefill/train", ops.flash_prefill,
                   lambda q, k, v: ref.flash_prefill_ref(q, k, v), [q, k, v],
                   lambda do: autograd.flash_prefill_backward(q, k, v, 0, 0.0, True, do), 1e-4,
                   bound_ms(2 * nb(q, k, v) + nb(q), 10 * B * H * D * pairs, H100_F32_FLOPS),
                   library=lambda q, k, v: F.scaled_dot_product_attention(
                       q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                       is_causal=True).transpose(1, 2))
    records["flash_prefill/train"] = rec

    # --- sparsemax: the TKD forward's scores [8, 128, 128]
    z = rnd((B, S, S), 3.0, f32)
    rec = check_sparsemax(failed, "sparsemax/tkd", z)
    out = sparsemax_cuda(z)
    check_backward(failed, rec, "sparsemax/tkd", ops.sparsemax, ref.sparsemax_ref, [z],
                   lambda g: autograd.sparsemax_backward(out, g), 1e-4,
                   bound_ms(nb(z, z, z), 4 * z.numel(), H100_F32_FLOPS))
    records["sparsemax/tkd"] = rec
    if failed:
        raise SystemExit(f"chip_smoke: training kernels disagree with their plain versions: {failed}")
    return records


def falls(losses) -> bool:
    """Phase 11's loss gate: every loss finite, and the mean of the last 5
    below the mean of the first 5."""
    import numpy as np

    return bool(np.isfinite(losses).all()) and float(np.mean(losses[-5:])) < float(np.mean(losses[:5]))


def backward_profile(cfg_t, params, batches):
    """Phase 11a's split: two more train steps from the trained weights under
    torch.profiler (host and device activity). The device time inside each
    Function's backward node (inclusive), the device's busy time and the
    wall. Returns {kernel: device ms a step} or None where the profiler
    recorded no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim.adamw import adamw_init

    step = make_train_step(cfg_t, lr=3e-4)
    opt = adamw_init(params)
    batches = [tuple(torch.from_numpy(a).to(params["embed"].device) for a in b) for b in batches]
    float(step(params, opt, *batches[0])[2]["lm_loss"])          # warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for tk, lb in batches:
            float(step(params, opt, tk, lb)[2]["lm_loss"])
        wall = time.perf_counter() - t0
    rows = prof.key_averages()

    def dev_us(e, attr):
        return getattr(e, f"{attr}device_time_total", None) or getattr(e, f"{attr}cuda_time_total", 0)

    busy = sum(dev_us(e, "self_") for e in rows if str(e.device_type).endswith("CUDA"))
    if busy <= 0:
        print("  backward share from the profiler: not measured (no device time recorded)")
        return None
    n = len(batches)
    per_step = {k: max([dev_us(e, "") for e in rows if node in e.key] or [0]) / 1e3 / n
                for k, node in BACKWARDS.items()}
    bwd = sum(per_step.values())
    step_ms = wall * 1e3 / n
    print(f"  profiled 2 steps: wall ms a step={step_ms:.3f} device busy ms a step="
          f"{busy / 1e3 / n:.3f} device_idle_share={max(0.0, 1 - busy / 1e6 / wall):.3f}")
    print(f"  the backwards' device ms a step: " + " ".join(
        f"{k}={v:.3f}" for k, v in per_step.items()) + f"; share of the step's wall "
          f"{bwd / step_ms:.4f}, of its device busy time {bwd / (busy / 1e3 / n):.4f}")
    for e in sorted(rows, key=lambda e: -dev_us(e, "self_"))[:6]:
        print(f"    {dev_us(e, 'self_') / 1e3 / n:9.3f} ms a step  {e.key[:90]}")
    return per_step


def train_path(cfg, records):
    """Phase 11a: `repro_torch.launch.train.train` at full width and depth,
    fp32, 30 steps of SyntheticLM [8, 128] at lr 3e-4 (warmup-cosine).
    Gates: finite losses, the last 5 steps' mean below the first 5's, both
    forward kernels launched. Returns (trained params, launch counts)."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    from repro_torch.models.transformer import param_count

    B, S = TRAIN_BATCH
    steps = 30
    # earlier phases' engines can sit in reference cycles with device
    # tensors: collect them, so the peak below is training's own
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()           # what earlier phases still hold
    ops.reset_launches()
    params, hist = train(cfg.name, steps=steps, batch=B, seq=S, lr=3e-4, reduced=False,
                         log_every=1, seed=0, device="cuda", dtype="float32")
    counts = ops.launches()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    el = [h["elapsed_s"] for h in hist]
    ms = (el[-1] - el[4]) / (steps - 5) * 1e3          # steps 5..29, each ended by its loss read
    print(f"  param_count={param_count(params)} peak max_memory_allocated={peak} "
          f"(held before training {held}) "
          f"ms_a_step={ms:.3f} (mean of steps 5-30) tokens_s={B * S / ms * 1e3:.1f} "
          f"first_step_s={el[0]:.3f}")
    print(f"  loss first={losses[0]:.4f} last={losses[-1]:.4f} mean first 5={np.mean(losses[:5]):.4f} "
          f"last 5={np.mean(losses[-5:]):.4f}")
    print(f"  launches {json.dumps(counts)}")
    if not falls(losses):
        raise SystemExit(f"chip_smoke: 11a's loss did not fall: {losses}")
    idle = [k for k in TRAIN_KERNELS if counts[k] == 0]
    if idle:
        raise SystemExit(f"chip_smoke: forward kernels never launched in training: {idle}")
    cfg_t = train_config(cfg)
    data = SyntheticLM(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=S, n_domains=8), seed=9)
    backward_profile(cfg_t, params, list(data.batches(B, 2)))
    # the same split from phase 2's backward times: launches a step (one a
    # MoE layer, one a layer) times each backward's time at this shape
    est = {"expert_ffn": cfg.n_layers // 2 * records["expert_ffn/train"]["backward_ms"],
           "flash_prefill": cfg.n_layers * records["flash_prefill/train"]["backward_ms"]}
    print(f"  the backwards from phase 2's times: " + " ".join(f"{k}={v:.3f} ms" for k, v in est.items())
          + f"; share of a {ms:.3f} ms step {sum(est.values()) / ms:.4f}")
    return params, counts


def tkd_batches(cfg_t, params, seed: int, lm: bool = False):
    """Fresh SyntheticLM [8, 128] batches from the frozen model on the card:
    (token embeddings, router logits [L, B, S, E]) or, with `lm`, (token
    embeddings, LM logits)."""
    import torch

    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
    from repro_torch.models.transformer import forward

    B, S = TRAIN_BATCH
    data = SyntheticLM(SyntheticConfig(vocab_size=cfg_t.vocab_size, seq_len=S, n_domains=8),
                       seed=seed)
    dev = params["embed"].device
    while True:
        toks = torch.from_numpy(data.sample(B)[0]).long().to(dev)
        with torch.no_grad():
            out = forward(params, cfg_t, toks, collect_router_logits=not lm)
        yield params["embed"][toks], out["logits" if lm else "router_logits"]


def tkd_path(cfg, params):
    """Phase 11b: TKD of the predictor (d_h 64, seed 1, as `seeded_model`
    makes it) from 11a's frozen model, 150 steps at lr 3e-3, T 8, λ 0.005,
    fresh batches each step; then the draft head, 100 steps at lr 3e-3.
    Gates: the TKD loss falls; the trained predictor's held-out top-1 hit
    rate above chance and above the untrained one's on the same 4 batches;
    the router heads and LSTMs bit-identical through the draft training;
    a save / load round trip bit for bit. Returns (trained, untrained
    predictor, sparsemax launches)."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.core.hash_fn import hash_fn_param_count, init_draft_head, init_hash_fn
    from repro_torch.core.tkd import evaluate_hash_fn, train_draft_head, train_hash_fn
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import n_moe_layers
    from repro_torch.tree import flatten, tree_leaves, tree_map

    cfg_t = train_config(cfg)
    E = cfg.moe.num_experts
    hp0 = init_hash_fn(torch.Generator().manual_seed(1), cfg.d_model, n_moe_layers(cfg), E,
                       d_h=64, device="cuda")
    held = tkd_batches(cfg_t, params, seed=2)
    held = [next(held) for _ in range(4)]

    def hits(hp):
        ms = [evaluate_hash_fn(hp, e, rl, top=3) for e, rl in held]
        return {k: float(np.mean([m[k] for m in ms])) for k in ms[0]}

    ops.reset_launches()
    t0 = time.perf_counter()
    hp, hist = train_hash_fn(hp0, tkd_batches(cfg_t, params, seed=1), steps=TKD_STEPS, lr=3e-3,
                             T=min(30, E), lam=0.005, log_every=1, verbose=False)
    wall = time.perf_counter() - t0
    counts = ops.launches()
    losses = [h["loss"] for h in hist]
    first, last = hist[0], hist[-1]
    print(f"  predictor params={hash_fn_param_count(hp)} ms_a_step={wall / TKD_STEPS * 1e3:.3f} "
          f"(the teacher's forward included) sparsemax launches={counts['sparsemax']}")
    for tag, h in (("first", first), ("last", last)):
        print(f"  {tag} step: loss={h['loss']:.4f} kd={h['kd']:.4f} ce={h['ce']:.4f} acc={h['acc']:.4f}")
    trained, untrained = hits(hp), hits(hp0)
    print(f"  held-out hit rates (4 x {TRAIN_BATCH}): trained {json.dumps(trained)} "
          f"untrained seed-1 {json.dumps(untrained)} chance top1={1 / E:.4f}")
    if not falls(losses):
        raise SystemExit(f"chip_smoke: 11b's TKD loss did not fall: {losses}")
    if counts["sparsemax"] == 0:
        raise SystemExit("chip_smoke: sparsemax never launched in TKD")
    if not (trained["top1_hit"] > 1 / E and trained["top1_hit"] > untrained["top1_hit"]):
        raise SystemExit("chip_smoke: the trained predictor does not beat chance and the untrained one")

    hd = init_draft_head(torch.Generator().manual_seed(7), hp, cfg.d_model)
    t0 = time.perf_counter()
    out, dh = train_draft_head(hd, params["embed"], tkd_batches(cfg_t, params, seed=3, lm=True),
                               steps=DRAFT_STEPS, num_experts=E, lr=3e-3)
    print(f"  draft head: {DRAFT_STEPS} steps, ms_a_step={(time.perf_counter() - t0) / DRAFT_STEPS * 1e3:.3f} "
          f"ce first={dh[0]['loss']:.4f} last={dh[-1]['loss']:.4f} "
          f"argmax_match first={dh[0]['acc']:.4f} last={dh[-1]['acc']:.4f}")
    before, after = flatten(hd), flatten(out)
    moved = [k for k in before if k != "draft_proj" and not torch.equal(before[k], after[k])]
    if moved:
        raise SystemExit(f"chip_smoke: the draft training moved the predictor's {moved}")
    ck = os.path.join(ROOT, "build", "chip_smoke_predictor")
    save_checkpoint(ck, out, step=TKD_STEPS, extra={"arch": cfg.name})
    back, _ = load_checkpoint(ck, device="cuda")
    same = all(torch.equal(a, b) for a, b in zip(tree_leaves(out), tree_leaves(back)))
    if not same or sorted(flatten(back)) != sorted(after):
        raise SystemExit("chip_smoke: the predictor's checkpoint round trip is not bit for bit")
    print(f"  router heads and LSTMs bit-identical through the draft training; checkpoint "
          f"round trip bit for bit ({ck})")
    return out, tree_map(lambda t: t.cpu(), hp0), counts


def grads_close(card: dict, cpu: dict, roundoff: float = 0.0):
    """The card-vs-CPU gradient gate of 11c and 13e, leaf by leaf: within
    1e-3 * max|g_cpu| of the leaf, and a card leaf of zeros where the CPU's
    is not fails; a CPU leaf of zeros needs zeros on the card. With
    `roundoff`, a CPU leaf no larger than roundoff * the largest leaf's is
    zero to rounding and must be so on the card too (13e: the xLSTM cells'
    input-gate biases b_i, whose gradient is zero in exact arithmetic: the
    stabiliser m follows b_i's shift, so the gates i', f' and the states C,
    n and h are unchanged). Returns (worst error / bound over the other
    leaves, failures, the leaves held as roundoff)."""
    top = max(g.abs().max().item() for g in cpu.values())
    worst, bad, tiny = 0.0, [], []
    for key, gc in cpu.items():
        gg = card[key].cpu()
        scale, err = gc.abs().max().item(), (gg - gc).abs().max().item()
        if scale == 0:
            ok = err == 0
        elif scale <= roundoff * top:
            ok = gg.abs().max().item() <= roundoff * top
            tiny.append(f"{key} (max|g_cpu| {scale:.3e}, max|g_card| {gg.abs().max().item():.3e})")
        else:
            ok = err <= 1e-3 * scale and bool(gg.any())
            worst = max(worst, err / (1e-3 * scale))
        if not ok:
            bad.append(f"{key} err={err:.3e} max|g_cpu|={scale:.3e}")
    return worst, bad, tiny


def offline_card_vs_cpu(cfg):
    """Phase 11c, the gradient gate: switch-base-8 at full width cut to 2
    layers (one dense, one MoE), fp32, seeded weights and 2 SyntheticLM
    [8, 128] batches on both devices. The first batch's gradients of the LM
    objective and of the TKD loss, every leaf within 1e-3 * max|g_cpu| (a
    card gradient of zeros where the CPU's is not fails); then 2 train steps
    and 2 TKD steps, each step's loss within 1e-4 * max(1, |loss|)."""
    import torch

    from repro_torch.core.hash_fn import hash_fn_apply, init_hash_fn
    from repro_torch.core.tkd import tkd_loss, train_hash_fn
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
    from repro_torch.launch.steps import loss_and_grads, make_train_step
    from repro_torch.models.transformer import forward, init_params
    from repro_torch.optim.adamw import adamw_init
    from repro_torch.tree import flatten, leaf_grads, requiring_grad, tree_map

    cfg2 = train_config(cfg, depth=2)
    E = cfg.moe.num_experts
    host = init_params(torch.Generator().manual_seed(0), cfg2, device="cpu")
    hp_host = init_hash_fn(torch.Generator().manual_seed(1), cfg.d_model, 1, E, d_h=64,
                           device="cpu")
    B, S = TRAIN_BATCH
    data = SyntheticLM(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=S, n_domains=8), seed=5)
    batches = [tuple(torch.from_numpy(a).long() for a in b) for b in data.batches(B, 2)]
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        params = tree_map(lambda t: t.to(dev), host)
        bt = [(t.to(dev), l.to(dev)) for t, l in batches]
        _, _, g_lm = loss_and_grads(cfg2, params, *bt[0])
        with torch.no_grad():
            tk = [(params["embed"][t], forward(params, cfg2, t, collect_router_logits=True)
                   ["router_logits"]) for t, _ in bt]
        hp = tree_map(lambda t: t.to(dev), hp_host)
        p = requiring_grad(hp)
        loss, _ = tkd_loss(hash_fn_apply(p, tk[0][0], E), tk[0][1], T=min(30, E), lam=0.005)
        g_tkd = leaf_grads(loss, p)
        step, opt, lm_losses = make_train_step(cfg2, lr=3e-4), adamw_init(params), []
        for t, l in bt:
            params, opt, m = step(params, opt, t, l)
            lm_losses.append(float(m["total_loss"]))
        _, hist = train_hash_fn(hp, iter(tk), steps=2, lr=3e-3, T=min(30, E), lam=0.005,
                                log_every=1, verbose=False)
        runs[dev] = (flatten(g_lm), flatten(g_tkd), lm_losses, [h["loss"] for h in hist])
        print(f"  ({dev}) {time.perf_counter() - t0:.1f} s: train losses {lm_losses}, "
              f"TKD losses {runs[dev][3]}")
    card, cpu = runs["cuda"], runs["cpu"]
    bad = []
    for which, i in (("train", 0), ("tkd", 1)):
        worst, failed, _ = grads_close(card[i], cpu[i])
        bad += [f"{which}:{f}" for f in failed]
        print(f"  {which} gradients, {len(cpu[i])} leaves: worst error / bound = {worst:.4f} (need <= 1)")
    for which, i in (("train", 2), ("tkd", 3)):
        for j, (a, b) in enumerate(zip(card[i], cpu[i])):
            if not abs(a - b) <= 1e-4 * max(1.0, abs(b)):
                bad.append(f"{which} step {j} loss {a} vs {b}")
    if bad:
        raise SystemExit(f"chip_smoke: 11c, the card's training disagrees with the CPU's: {bad}")
    print("  gate: the card's gradients and losses equal the CPU's within tolerance")


def serve_trained_path(cfg, params, hp_trained, hp_untrained, slots: int):
    """Phase 11d: 11a's model in bf16 served through SiDAEngine at phase 3's
    slot budget on 4 held-out [8, 128] batches, with 11b's predictor and
    with the untrained seed-1 one, each beside Standard (every expert
    resident): the hash hit rate against the model's router, the share of
    tokens whose argmax equals Standard's (the paper's fidelity), throughput,
    loads, bytes and memory saving. Gate: every batch kernel launches."""
    import numpy as np
    import torch

    from repro_torch.core.baselines import StandardServer
    from repro_torch.core.engine import SiDAEngine
    from repro_torch.core.tkd import evaluate_hash_fn
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import forward
    from repro_torch.tree import flatten, unflatten

    B, S = TRAIN_BATCH
    V = cfg.vocab_size
    # the serving dtypes: bf16, the router fp32 (as `init_moe` makes it)
    host = unflatten({k: t.detach().cpu() if k.endswith("/router") else
                      t.detach().to(torch.bfloat16).cpu() for k, t in flatten(params).items()})
    data = SyntheticLM(SyntheticConfig(vocab_size=V, seq_len=S, n_domains=8), seed=6)
    batches = [data.sample(B)[0] for _ in range(5)]            # a warm-up batch, then 4
    std = StandardServer(cfg, host, device="cuda")
    std.serve(batches[:1])
    m_std = std.serve(batches[1:])
    ref_tok, teacher = [], []
    with torch.inference_mode():
        for toks in batches[1:]:
            t = torch.as_tensor(toks, device="cuda").long()
            out = forward(std.params, cfg, t, collect_router_logits=True)
            ref_tok.append(out["logits"][..., :V].argmax(-1).cpu())
            teacher.append((std.params["embed"][t], out["router_logits"]))
    print(f"  (standard) throughput_tok_s={m_std.throughput:.1f} mean_latency_s={m_std.mean_latency:.5f} "
          f"device_memory_bytes={std.device_memory_bytes()}")
    del std
    for name, hp in (("trained", hp_trained), ("untrained", hp_untrained)):
        eng = SiDAEngine(cfg, host, hp, slots_per_layer=slots, device="cuda")
        eng.serve(batches[:1], threaded=False)
        eng.store.stats.reset()
        torch.cuda.synchronize()
        ops.reset_launches()
        m = eng.serve(batches[1:], threaded=True)
        counts = ops.launches()
        hits = [evaluate_hash_fn(eng.hash_params, e, rl, top=3) for e, rl in teacher]
        hit = {k: float(np.mean([h[k] for h in hits])) for k in hits[0]}
        fid = float(np.mean([(r[..., :V].float().argmax(-1) == t).float().mean().item()
                             for r, t in zip(eng.results, ref_tok)]))
        st = eng.store.stats
        print(f"  ({name} predictor) hit rate vs the router {json.dumps(hit)} "
              f"argmax_equal_to_standard={fid:.4f}")
        print(f"    throughput_tok_s={m.throughput:.1f} mean_latency_s={m.mean_latency:.5f} "
              f"loads={st.loads} bytes_h2d={st.bytes_h2d} "
              f"memory_saving={eng.memory_saving()['reduction']:.4f} launches {json.dumps(counts)}")
        idle = [k for k in BATCH_KERNELS if counts[k] == 0]
        if idle:
            raise SystemExit(f"chip_smoke: kernels never launched serving the {name} predictor: {idle}")
        eng.close()
        del eng


def sparsity_path(cfg, params):
    """Phase 11e: the paper's motivating measurements on 11a's model: the
    idle-expert ratio a sentence (Fig. 4) and the effective memory
    utilisation it gives (Fig. 2) at sentence lengths 16, 64 and 256, and ĉ
    (Eq. 2 inverted over a token-corruption study, Fig. 7)."""
    from repro_torch.core.sparsity import (corruption_study, effective_memory_utilization,
                                           estimate_c, routing_ids, sentence_sparsity)
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM

    cfg_t = train_config(cfg)
    E = cfg.moe.num_experts
    for L in (16, 64, 256):
        data = SyntheticLM(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=L, n_domains=8), seed=4)
        idle = float(sentence_sparsity(routing_ids(params, cfg_t, data.sample(8)[0]), E).mean())
        mem = effective_memory_utilization(cfg, idle)
        print(f"  sentence length {L:3d}: idle expert ratio={idle:.4f} (Fig. 4) "
              f"effective_utilization={mem['effective_utilization']:.4f} "
              f"ineffective_gb={mem['ineffective_gb']:.4f} of total_gb={mem['total_gb']:.4f} "
              f"(Fig. 2, bf16)")
    L, ps = 64, [0.05, 0.1, 0.2, 0.4]
    toks = SyntheticLM(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=L, n_domains=8),
                       seed=5).sample(4)[0]
    phat = corruption_study(params, cfg_t, toks, ps, n_positions=4, n_trials=2, mode="token")
    c = estimate_c(ps, [phat[p] for p in ps], L)
    print(f"  corruption study (L {L}, token mode): p_hat {json.dumps(phat)} -> c_hat={c} "
          f"(the paper: 1 to 4)")


# ---------------------------------------------------------------------------
# phase 2, the hybrid, recurrent and encoder-decoder forms; phase 13
# ---------------------------------------------------------------------------

HYMBA_PROMPT, HYMBA_STEPS = (2, 4096), 128      # 13a: a prompt twice the 2048 window; greedy steps
XLSTM_PROMPT, XLSTM_STEPS = (4, 1024), 128      # 13b
SEAMLESS_ENC, SEAMLESS_DEC = (2, 512), (2, 64)  # 13c: encoder frames, decoder tokens
SEAMLESS_STEPS = 64
VERIFY_KB = 4                                   # 13a / 13d's speculative block
CPU_STEPS = 16                                  # 13d's greedy steps, card against CPU
WRAP_WINDOW, WRAP_STEPS = 64, 96                # 13d: hymba's window cut so that its ring wraps
TRAIN_FAMILY_BATCH, TRAIN_FAMILY_DEPTH, TRAIN_FAMILY_STEPS = (4, 256), 4, 10   # 13e's train()
GRAD_BATCH = (2, 64)                            # 13e's card-vs-CPU gradient batch
RECURRENT_FAMILY = ("hymba-1.5b", "xlstm-125m", "seamless-m4t-medium")


def recurrent_rows():
    """Phase 2's rows at phase 13's new attention forms: (row, config,
    kernel, B, S, S_kv or ring slots, window, causal, launch-key form, the
    phase-13 run that launches it)."""
    hy, sm = family_config("hymba-1.5b"), family_config("seamless-m4t-medium")
    W = hy.attn.window
    return (("flash_prefill/hymba-G5", hy, "flash_prefill", *HYMBA_PROMPT, HYMBA_PROMPT[1], W,
             True, None, "13a-prefill"),
            ("flash_prefill/seamless-enc", sm, "flash_prefill", *SEAMLESS_ENC, SEAMLESS_ENC[1], 0,
             False, "noncausal", "13c-prefill"),
            ("flash_prefill/seamless-cross", sm, "flash_prefill", *SEAMLESS_DEC, SEAMLESS_ENC[1],
             0, False, "cross", "13c-prefill"),
            ("flash_decode/hymba-G5", hy, "flash_decode", HYMBA_PROMPT[0], 1, W, W, True, None,
             "13a-decode"),
            ("flash_decode/seamless-cross", sm, "flash_decode", SEAMLESS_DEC[0], 1,
             SEAMLESS_ENC[1], 0, False, "cross", "13c-decode"))


def bf16_attention_bound(want, mag):
    """Each element's bound for bf16 attention against its fp32 plain
    version: 2^-7 * (P|V| + |want|), twice the rounding of P and of the
    output to bf16 (unit roundoff 2^-8), and never above the absolute 5e-2
    of the other bf16 rows; `mag` is the plain version over |v|. It scales
    with what is compared: where a softmax spreads over hundreds of keys it
    is ~6e-3, where 5e-2 alone is as large as a typical output."""
    return (2.0 ** -7 * (mag.float() + want.float().abs())).clamp(max=5e-2)


def check_recurrent_family_kernels():
    """Phase 2, phase 13's new attention forms, each against its plain
    version on the same inputs, bf16 within `bf16_attention_bound` of each
    element and fp32 within 1e-4: flash_prefill at
    hymba's group of 5 (25 / 5 heads of 64) with its 2048 window over a
    4096-token prompt, over seamless's encoder (16 / 16 heads, not causal)
    and in seamless's cross-attention (64 queries over 512 encoder keys, a
    key length of its own), with that form's backward against autograd over
    the plain version; flash_decode at hymba's group of 5 over its
    2048-slot ring and in seamless's cross form (512 encoder slots at
    position 0). The library is SDPA with enable_gqa (a boolean mask for the
    window, none where nothing is masked). Returns {row: bf16 record}."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import autograd, ops, ref
    from repro_torch.kernels.flash_decode import decode_plan, flash_decode_cuda
    from repro_torch.kernels.flash_prefill import flash_prefill_cuda

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(765)

    def rnd(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    records, failed = {}, []
    peak = {torch.bfloat16: H100_BF16_FLOPS, torch.float32: H100_F32_FLOPS}
    for row, cfg, kernel, B, S, Skv, window, causal, _, _ in recurrent_rows():
        H, K, D = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        for dtype in (torch.bfloat16, torch.float32):
            if kernel == "flash_prefill":
                q, k, v = rnd((B, S, H, D), dtype), rnd((B, Skv, K, D), dtype), rnd((B, Skv, K, D), dtype)
                got = flash_prefill_cuda(q, k, v, window=window, causal=causal)
                torch.cuda.synchronize()
                want = ref.flash_prefill_ref(q, k, v, window, 0.0, causal)
                mag = ref.flash_prefill_ref(q, k, v.abs(), window, 0.0, causal)
                mask = ref.prefill_mask(S, Skv, window, causal, dev)
                pairs = int(mask.sum())
                bnd = bound_ms(nb(q, k, v, got), 4 * B * H * D * pairs, peak[dtype])
                kern = lambda q=q, k=k, v=v: flash_prefill_cuda(q, k, v, window=window,
                                                                causal=causal)
                plain = lambda q=q, k=k, v=v: ref.flash_prefill_ref(q, k, v, window, 0.0, causal)
                qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
                kw = ({"attn_mask": mask} if window else {"is_causal": True} if causal else {})
                lib = lambda qt=qt, kt=kt, vt=vt, kw=kw: F.scaled_dot_product_attention(
                    qt, kt, vt, enable_gqa=True, **kw)
                label = " (SDPA, enable_gqa" + (", boolean band mask)" if window else
                                                ", is_causal)" if causal else ", unmasked)")
                lib_out = lambda lib=lib: lib().transpose(1, 2)
                shape = (B, S, Skv, H, K, D)
            else:
                q, k, v = rnd((B, H, D), dtype), rnd((B, Skv, K, D), dtype), rnd((B, Skv, K, D), dtype)
                if causal:      # hymba's ring, every lane past its wrap
                    p = torch.tensor([Skv + 1000 + 37 * i for i in range(B)], dtype=torch.int32)
                    s_idx = torch.arange(Skv, dtype=torch.int32)[None, :]
                    sp = (p[:, None] - ((p[:, None] - s_idx) % Skv)).to(dev).contiguous()
                    p = p.to(dev)
                else:           # the cross form: every encoder slot at position 0
                    p = torch.zeros(B, dtype=torch.int32, device=dev)
                    sp = torch.zeros((B, Skv), dtype=torch.int32, device=dev)
                got = flash_decode_cuda(q, k, v, sp, p, window=window)
                torch.cuda.synchronize()
                want = ref.flash_decode_ref(q, k, v, sp, p, window=window)
                mag = ref.flash_decode_ref(q, k, v.abs(), sp, p, window=window)
                bnd = bound_ms(nb(q, k, v, sp, p, got), 4 * B * H * Skv * D, peak[dtype])
                kern = lambda q=q, k=k, v=v, sp=sp, p=p: flash_decode_cuda(q, k, v, sp, p,
                                                                           window=window)
                plain = lambda q=q, k=k, v=v, sp=sp, p=p: ref.flash_decode_ref(q, k, v, sp, p,
                                                                               window=window)
                qt = q[:, :, None, :]
                kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
                valid = ((sp >= 0) & (sp <= p[:, None]) & (sp > p[:, None] - window))[:, None, None]
                kw = {"attn_mask": valid} if window else {}
                lib = lambda qt=qt, kt=kt, vt=vt, kw=kw: F.scaled_dot_product_attention(
                    qt, kt, vt, enable_gqa=True, **kw)
                label = " (SDPA, enable_gqa" + (", boolean mask)" if window else ", unmasked)")
                lib_out = lambda lib=lib: lib()[:, :, 0]
                shape = (B, H, D, Skv, K)
                print(f"    {row} plan (splits) = {decode_plan(B, K, Skv, H // K, D, dtype)}")
            bf16 = dtype == torch.bfloat16
            tol = bf16_attention_bound(want, mag) if bf16 else 1e-4
            rec = report(failed, row, dtype, shape, got, want, tol, time_ms(kern), time_ms(plain),
                         time_ms(lib), bnd, label, graph=(kern, lib))
            library_check(rec, lib_out, want)
            if bf16:
                records[row] = rec
            if row == "flash_prefill/seamless-cross":
                # the form's backward: S again, dP, dV, dQ, dK over every pair
                check_backward(
                    failed, records[row], row,
                    lambda q, k, v: ops.flash_prefill(q, k, v, causal=False, cross=True),
                    lambda q, k, v: ref.flash_prefill_ref(q, k, v, causal=False).to(q.dtype),
                    [q, k, v],
                    lambda do, q=q, k=k, v=v: autograd.flash_prefill_backward(
                        q, k, v, 0, 0.0, False, do),
                    5e-2 if bf16 else 1e-4,
                    bound_ms(2 * nb(q, k, v) + nb(q), 10 * B * H * D * pairs, peak[dtype]),
                    library=lambda q, k, v: F.scaled_dot_product_attention(
                        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        enable_gqa=True).transpose(1, 2),
                    tag=" bf16" if bf16 else "")
            del q, k, v, got, want, mag, tol
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"chip_smoke: the phase-13 forms disagree with their plain versions: "
                         f"{failed}")
    return records


def seed_cross(params, cfg, cache, enc):
    """An encoder-decoder cache's cross-attention K/V, in place: each decoder
    group's `xattn` projection of `_encode`'s output over `enc`, as the
    reference's tests/test_decode_consistency.py seeds them."""
    from repro_torch.models.attention import _project_kv
    from repro_torch.models.transformer import _encode
    from repro_torch.tree import tree_map

    enc_out = _encode(params, cfg, enc)
    for g in range(cfg.n_layers):
        k, v = _project_kv(tree_map(lambda t: t[g], params["blocks"])["sub0"]["xattn"], enc_out,
                           cfg)
        cache["sub0"]["cross_k"][g], cache["sub0"]["cross_v"][g] = k, v


def greedy(params, cfg, cache, tok, steps: int, keep_logits: bool = False):
    """`steps` greedy decode_steps from `tok` [B]: (tokens fed [B, steps],
    the last step's logits, every step's logits on the host if asked, the
    cache). The tokens stay on the device: nothing waits for the card."""
    import torch

    from repro_torch.models.transformer import decode_step

    V = cfg.vocab_size
    fed, kept = [], []
    for _ in range(steps):
        fed.append(tok)
        lg, cache = decode_step(params, cache, tok, cfg)
        if keep_logits:
            kept.append(lg[:, :V].float().cpu())
        tok = torch.argmax(lg[:, :V], dim=-1).to(torch.int32)
    return torch.stack(fed, dim=1), lg, kept, cache


def rel_err(got, want) -> float:
    """max|got - want| over max(1, max|want|), in fp32 on the host."""
    got, want = got.float().cpu(), want.float().cpu()
    return (got - want).abs().max().item() / max(1.0, want.abs().max().item())


def verify_block(params, cfg, cache, last, kb: int, seed: int):
    """A speculative block after `last` [B]: lane 0's first two drafts are
    the model's greedy tokens (stepped on a clone of `cache`), the rest
    random. Returns [B, kb] int32."""
    import numpy as np
    import torch

    from repro_torch.tree import tree_map

    probe = tree_map(lambda t: t.clone(), cache)
    own, _, _, _ = greedy(params, cfg, probe, last, kb - 1)
    del probe
    B = last.shape[0]
    rnd = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, kb - 1)).astype(np.int32)
    drafts = torch.as_tensor(rnd, device=last.device)
    drafts[0, :2] = own[0, 1:3]
    return torch.cat([last[:, None], drafts], dim=1)


def check_rollback(params, cfg, cache, block, name: str):
    """verify_step over `block` from `cache`, then each lane's accepted
    prefix stepped alone from a clone of the same cache: every K/V and
    state leaf of the lane bit-equal. Returns (n_acc, out tokens)."""
    import torch

    from repro_torch.models.transformer import decode_step, verify_step
    from repro_torch.tree import flatten, tree_map

    before = tree_map(lambda t: t.clone(), cache)
    out, n_acc, _, vc = verify_step(params, cache, block, cfg)
    vflat = {k: flatten(vc[k]) for k in vc if k.startswith("sub")}
    bad = []
    for lane in range(block.shape[0]):
        ref = tree_map(lambda t: t.clone(), before)
        for i in range(int(n_acc[lane])):
            _, ref = decode_step(params, ref, block[:, i], cfg)
        for skey, leaves in vflat.items():
            for key, t in leaves.items():
                if not torch.equal(t[:, lane], flatten(ref[skey])[key][:, lane]):
                    bad.append(f"lane {lane} {skey}/{key}")
        if int(vc["pos"][lane]) != int(before["pos"][lane]) + int(n_acc[lane]):
            bad.append(f"lane {lane} pos")
        del ref
    print(f"    {name} verify_step (kb {block.shape[1]}): n_acc {n_acc.tolist()}; every K/V and "
          f"state leaf bit-equal to the accepted prefix stepped alone: {not bad}")
    if bad:
        raise SystemExit(f"chip_smoke: {name}'s verify_step rollback differs from the accepted "
                         f"prefix: {bad[:8]}")
    return n_acc.cpu(), out.cpu()


def step_idle_share(params, cfg, cache, tok, steps: int):
    """Over `steps` decode steps (torch.profiler, device activity only, as
    5a): (device idle share, device busy ms a step, device operations a
    step: the kernels and copies the profiler counts), or None where it
    records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        greedy(params, cfg, cache, tok, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_us = [(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0),
               e.count) for e in prof.key_averages()]
    busy = sum(us for us, _ in dev_us) / 1e6
    n_ops = sum(n for us, n in dev_us if us > 0)
    return None if busy <= 0 else (max(0.0, 1 - busy / wall), busy / steps * 1e3, n_ops / steps)


def idle_text(idle) -> str:
    """`step_idle_share`'s result as a line's words."""
    if idle is None:
        return "decode step device_idle_share=not measured"
    return (f"decode step device_idle_share={idle[0]:.3f} (device busy {idle[1]:.3f} ms and "
            f"{idle[2]:.1f} device operations a step)")


def hymba_path():
    """Phase 13a: hymba-1.5b at full width and depth, bf16, seeded weights
    drawn on the card: `forward` over a [2, 4096] prompt (twice the
    window), then 2 lanes x 128 greedy `decode_step`s from an empty
    2048-slot ring, the last step's logits against a `forward` over the
    same tokens (5e-2 * max(1, max|logit|)), then `verify_step` (kb 4) whose
    K/V and Mamba state equal the accepted prefix stepped alone, bit for
    bit. Prints ms a prefill and a decode step, tok/s, peak memory, the
    device idle share of a decode step and the Mamba updates' share of one.
    Returns {"13a-prefill" / "13a-decode": launches_by_shape}."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models import ssm
    from repro_torch.models.transformer import forward, init_cache, init_params, param_count
    from repro_torch.tree import tree_map

    cfg = family_config("hymba-1.5b")
    B, S = HYMBA_PROMPT
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    V = cfg.vocab_size
    print(f"  {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} / {cfg.n_kv_heads} heads "
          f"of {cfg.hd}, window {cfg.attn.window}, Mamba state {cfg.ssm.state_dim} (d_inner "
          f"{cfg.ssm.expand * cfg.d_model}), d_ff {cfg.d_ff}, vocab {V}, {cfg.dtype}; "
          f"{param_count(params)} params (init {time.perf_counter() - t0:.2f} s)")
    toks = torch.as_tensor(np.random.default_rng(21).integers(0, V, (B, S)).astype(np.int32),
                           device="cuda")
    counts = {}
    with torch.inference_mode():
        forward(params, cfg, toks[:, :64])                        # warm
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = forward(params, cfg, toks)["logits"]
        torch.cuda.synchronize()
        ms_prefill = (time.perf_counter() - t0) * 1e3
        counts["13a-prefill"] = ops.launches_by_shape()
        ok = bool(torch.isfinite(logits[..., :V]).all()) and tuple(logits.shape) == (B, S, cfg.padded_vocab)
        del logits
        print(f"    forward [{B}, {S}]: {ms_prefill:.1f} ms ({B * S / ms_prefill * 1e3:.0f} tok/s), "
              f"finite logits of shape [{B}, {S}, {cfg.padded_vocab}]: {ok}")
        if not ok:
            raise SystemExit("chip_smoke: 13a's prefill logits are not finite or misshapen")

        cache = init_cache(cfg, B, cfg.attn.window, device="cuda")
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fed, lg, _, cache = greedy(params, cfg, cache, toks[:, 0], HYMBA_STEPS)
        torch.cuda.synchronize()
        ms_step = (time.perf_counter() - t0) * 1e3 / HYMBA_STEPS
        counts["13a-decode"] = ops.launches_by_shape()
        ref = forward(params, cfg, fed)["logits"][:, -1, :V]
        err = rel_err(lg[:, :V], ref)
        print(f"    decode {B} lanes x {HYMBA_STEPS} steps over a {cache['sub0']['k'].shape[2]}-slot "
              f"ring: {ms_step:.3f} ms a step, {B / ms_step * 1e3:.1f} tok/s; last logits vs "
              f"forward over the same tokens: max_abs_err / max(1, max|logit|) = {err:.3e} "
              f"(tol 5e-2)")
        if not err <= 5e-2:
            raise SystemExit(f"chip_smoke: 13a's decode disagrees with its forward: {err}")
        last = torch.argmax(lg[:, :V], dim=-1).to(torch.int32)
        block = verify_block(params, cfg, cache, last, VERIFY_KB, seed=22)
        check_rollback(params, cfg, cache, block, "13a")
        peak = torch.cuda.max_memory_allocated()
        idle = step_idle_share(params, cfg, init_cache(cfg, B, cfg.attn.window, device="cuda"),
                               toks[:, 0], 16)
        # the recurrences alone: the 32 layers' Mamba decode updates of a step
        mp = [tree_map(lambda t: t[g], params["blocks"]["sub0"]["mamba"])
              for g in range(cfg.n_layers)]
        st = ssm.mamba_init_state(cfg, B, params["embed"].dtype, "cuda")
        h = torch.randn((B, cfg.d_model), device="cuda").to(params["embed"].dtype)
        ms_mamba = time_ms(lambda: [ssm.mamba_decode(p, h, st, cfg) for p in mp], reps=10)
    print(f"    peak max_memory_allocated={peak}; {idle_text(idle)}; the {cfg.n_layers} Mamba decode updates alone {ms_mamba:.3f} ms a step, "
          f"{ms_mamba / ms_step:.3f} of a decode step")
    del params, cache
    torch.cuda.empty_cache()
    return counts


def xlstm_path():
    """Phase 13b: xlstm-125m at full width and depth (12 blocks, m / s
    alternating, 4 heads), fp32, seeded weights: `forward` over [4, 1024] in
    "assoc" and in "scan" mode, equal within 1e-4 relative (the reference's
    bound), then 4 lanes x 128 greedy decode steps whose last logits match a
    forward over the same tokens within 5e-3 relative. No attention kernel
    lies on this path: every launch count must stay 0."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.transformer import forward, init_cache, init_params, param_count

    cfg = family_config("xlstm-125m", dtype="float32")
    B, S = XLSTM_PROMPT
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    V = cfg.vocab_size
    toks = torch.as_tensor(np.random.default_rng(23).integers(0, V, (B, S)).astype(np.int32),
                           device="cuda")
    print(f"  {cfg.n_layers} blocks {cfg.ssm.xlstm_pattern}, d_model {cfg.d_model}, "
          f"{cfg.ssm.xlstm_heads} heads, vocab {V}, {cfg.dtype}; {param_count(params)} params")
    ops.reset_launches()
    with torch.inference_mode():
        ms, out = {}, {}
        for mode in ("assoc", "scan"):
            forward(params, cfg, toks[:, :64], scan_mode=mode)      # warm
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out[mode] = forward(params, cfg, toks, scan_mode=mode)["logits"][..., :V]
            torch.cuda.synchronize()
            ms[mode] = (time.perf_counter() - t0) * 1e3
        err_modes = ((out["assoc"] - out["scan"]).abs().max() / out["scan"].abs().max()).item()
        del out
        cache = init_cache(cfg, B, XLSTM_STEPS, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fed, lg, _, cache = greedy(params, cfg, cache, toks[:, 0], XLSTM_STEPS)
        torch.cuda.synchronize()
        ms_step = (time.perf_counter() - t0) * 1e3 / XLSTM_STEPS
        ref = forward(params, cfg, fed)["logits"][:, -1, :V]
        err_dec = ((lg[:, :V] - ref).abs().max() / ref.abs().max()).item()
        idle = step_idle_share(params, cfg, init_cache(cfg, B, 16, device="cuda"), toks[:, 0], 16)
    launched = {k: n for k, n in ops.launches().items() if n}
    print(f"    forward [{B}, {S}]: assoc {ms['assoc']:.1f} ms, scan {ms['scan']:.1f} ms; "
          f"max|assoc - scan| / max|scan| = {err_modes:.3e} (tol 1e-4)")
    print(f"    decode {B} lanes x {XLSTM_STEPS} steps: {ms_step:.3f} ms a step, "
          f"{B / ms_step * 1e3:.1f} tok/s; last logits vs forward: {err_dec:.3e} relative (tol 5e-3); "
          f"{idle_text(idle)}")
    print(f"    kernel launches in 13b: {launched or 'none'} (xLSTM has no attention: its "
          f"recurrences are plain PyTorch on the card)")
    if not (err_modes <= 1e-4 and err_dec <= 5e-3 and not launched):
        raise SystemExit(f"chip_smoke: 13b failed: assoc vs scan {err_modes}, decode vs forward "
                         f"{err_dec}, launches {launched}")
    del params, cache
    torch.cuda.empty_cache()


def seamless_path():
    """Phase 13c: seamless-m4t-medium at full width and depth (12 encoder +
    12 decoder layers), bf16, seeded weights and stub frames: the encoder
    over [2, 512] frames and the decoder's `forward` over [2, 64] tokens
    (flash_prefill non-causal over the encoder, causal, and in the cross
    form at 64 queries over 512 keys); cross caches seeded from `_encode`,
    then 2 x 64 greedy decode steps (flash_decode over the self ring and
    over the 512 encoder slots), the last logits against a forward over the
    same tokens within 5e-2 * max(1, max|logit|). Returns {"13c-prefill" /
    "13c-decode": launches_by_shape}."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.transformer import forward, init_cache, init_params, param_count

    cfg = family_config("seamless-m4t-medium")
    (B, E), (_, S) = SEAMLESS_ENC, SEAMLESS_DEC
    dt = getattr(torch, cfg.dtype)
    params = init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    V = cfg.vocab_size
    rng = np.random.default_rng(24)
    enc = torch.as_tensor(rng.normal(size=(B, E, cfg.d_model)), device="cuda").to(dt)
    toks = torch.as_tensor(rng.integers(0, V, (B, S)).astype(np.int32), device="cuda")
    print(f"  {cfg.n_enc_layers} encoder + {cfg.n_layers} decoder layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.hd}, vocab {V}, {cfg.dtype}; {param_count(params)} params")
    counts = {}
    with torch.inference_mode():
        forward(params, cfg, toks[:, :8], enc_input=enc[:, :8])    # warm
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = forward(params, cfg, toks, enc_input=enc)["logits"][..., :V]
        torch.cuda.synchronize()
        ms_fwd = (time.perf_counter() - t0) * 1e3
        counts["13c-prefill"] = ops.launches_by_shape()
        ok = bool(torch.isfinite(logits).all())
        del logits
        cache = init_cache(cfg, B, SEAMLESS_STEPS, device="cuda", enc_len=E)
        seed_cross(params, cfg, cache, enc)
        ops.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fed, lg, _, cache = greedy(params, cfg, cache, toks[:, 0], SEAMLESS_STEPS)
        torch.cuda.synchronize()
        ms_step = (time.perf_counter() - t0) * 1e3 / SEAMLESS_STEPS
        counts["13c-decode"] = ops.launches_by_shape()
        ref = forward(params, cfg, fed, enc_input=enc)["logits"][:, -1, :V]
        err = rel_err(lg[:, :V], ref)
        cache = init_cache(cfg, B, 16, device="cuda", enc_len=E)
        seed_cross(params, cfg, cache, enc)
        idle = step_idle_share(params, cfg, cache, toks[:, 0], 16)
    print(f"    encoder [{B}, {E}] + decoder forward [{B}, {S}]: {ms_fwd:.1f} ms, finite logits: "
          f"{ok}; decode {B} lanes x {SEAMLESS_STEPS} steps (cross over {E} slots): "
          f"{ms_step:.3f} ms a step, {B / ms_step * 1e3:.1f} tok/s; last logits vs forward: "
          f"{err:.3e} of max(1, max|logit|) (tol 5e-2); {idle_text(idle)}")
    print(f"    launches by form: prefill {counts['13c-prefill']}; decode {counts['13c-decode']}")
    if not (ok and err <= 5e-2):
        raise SystemExit(f"chip_smoke: 13c failed: finite {ok}, decode vs forward {err}")
    del params, cache
    torch.cuda.empty_cache()
    return counts


def family_run(params, cfg, dev: str, toks, enc, steps: int, window_cfg=None, block=None):
    """One device's side of 13d: forward logits (host, fp32), `steps` greedy
    decode tokens from a fresh cache (cross caches seeded); with
    `window_cfg` the same from its cut ring over WRAP_STEPS steps, so the
    ring wraps, then a VERIFY_KB block on that wrapped ring (the card's
    own, checked against the accepted prefix; the CPU runs the card's
    `block`)."""
    import torch

    from repro_torch.models.transformer import forward, init_cache, verify_step
    from repro_torch.tree import tree_map

    V = cfg.vocab_size
    p = tree_map(lambda t: t.to(dev), params)
    toks = toks.to(dev)
    enc = None if enc is None else enc.to(dev)
    res = {}
    with torch.inference_mode():
        res["logits"] = forward(p, cfg, toks, enc_input=enc)["logits"][..., :V].float().cpu()
        cache = init_cache(cfg, toks.shape[0], steps, device=dev,
                           enc_len=enc.shape[1] if cfg.enc_dec else 0)
        if cfg.enc_dec:
            seed_cross(p, cfg, cache, enc)
        res["tokens"] = greedy(p, cfg, cache, toks[:, 0], steps)[0].cpu()
        if window_cfg is not None:
            wc = init_cache(window_cfg, toks.shape[0], WRAP_WINDOW, device=dev)
            fed, lg, _, wc = greedy(p, window_cfg, wc, toks[:, 0], WRAP_STEPS)
            res["wrap_tokens"] = fed.cpu()
            if block is None:
                last = torch.argmax(lg[:, :V], dim=-1).to(torch.int32)
                block = verify_block(p, window_cfg, wc, last, VERIFY_KB, seed=25)
                res["block"] = block.cpu()
                res["n_acc"], res["out"] = check_rollback(
                    p, window_cfg, wc, block, f"13d {cfg.name} (wrapped {WRAP_WINDOW}-slot ring)")
            else:
                out, n_acc, _, _ = verify_step(p, wc, block.to(dev), window_cfg)
                res["n_acc"], res["out"] = n_acc.cpu(), out.cpu()
    del p
    return res


def recurrent_card_vs_cpu():
    """Phase 13d: each family at full width cut to 2 layers (seamless 2 + 2),
    fp32, the same seeded weights on the card and the CPU: `forward` logits
    within 1e-3 * max(1, max|logit|) ([2, 64] tokens; seamless over 32 stub
    frames), 16 greedy decode steps' tokens identical (seamless through its
    cross caches); hymba again with its window cut to 64 over 96 steps, so
    its 64-slot ring wraps, tokens identical, then verify_step (kb 4) on
    that wrapped ring: the card's rollback bit-equal to the accepted
    prefix, n_acc and tokens identical to the CPU's."""
    import numpy as np
    import torch

    for name in RECURRENT_FAMILY:
        t0 = time.perf_counter()
        cfg = family_config(name, 2, "float32")
        params, _ = card_seeded_model(cfg)
        rng = np.random.default_rng(26)
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 64)).astype(np.int32))
        enc = (torch.as_tensor(rng.normal(size=(2, 32, cfg.d_model)), dtype=torch.float32)
               if cfg.enc_dec else None)
        hymba = cfg.block_kind == "hymba"
        wcfg = family_config(name, 2, "float32", window=WRAP_WINDOW) if hymba else None
        card = family_run(params, cfg, "cuda", toks, enc, CPU_STEPS, wcfg)
        cpu = family_run(params, cfg, "cpu", toks, enc, CPU_STEPS, wcfg, block=card.get("block"))
        err = rel_err(card["logits"], cpu["logits"])
        same = {k: bool(torch.equal(card[k], cpu[k]))
                for k in ("tokens", "wrap_tokens", "n_acc", "out") if k in card}
        print(f"    {name} (2 layers, fp32, {time.perf_counter() - t0:.1f} s): forward max_abs_err "
              f"/ max(1, max|logit|) = {err:.3e} (tol 1e-3); identical: {same}")
        if not (err <= 1e-3 and all(same.values())):
            raise SystemExit(f"chip_smoke: 13d, {name} on the card disagrees with the CPU: "
                             f"{err}, {same}")
        del params
        torch.cuda.empty_cache()
    print(f"  (13d cut hymba's window to {WRAP_WINDOW} for the wrap run and its verify block: "
          f"{WRAP_STEPS} steps over a {WRAP_WINDOW}-slot ring)")


def recurrent_training():
    """Phase 13e: (i) each family at full width cut to 2 layers, fp32, the
    first SyntheticLM [2, 64] batch's LM-loss gradients (`loss_and_grads`:
    remat, "assoc"; seamless's encoder over train()'s stub frames) on the
    card and the CPU, each leaf within `grads_close`'s bound (b_i's
    roundoff held below 1e-6 of the largest leaf); (ii)
    `launch.train.train` 10 steps at full width on [4, 256], cut to 4
    layers (seamless 4 + 4), fp32: its `get_config` returns the cut
    config while it runs. Gates: losses finite and the last below
    the first; flash_prefill launched in hymba's and seamless's training,
    seamless's in its cross form too. Returns {name: launches_by_shape}."""
    import numpy as np
    import torch

    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launcher
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.tree import flatten, tree_map

    B, S = GRAD_BATCH
    for name in RECURRENT_FAMILY:
        t0 = time.perf_counter()
        cfg = family_config(name, 2, "float32")
        host, _ = card_seeded_model(cfg)
        data = SyntheticLM(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=S, n_domains=8),
                           seed=0)
        toks, labels = (torch.from_numpy(a).long() for a in next(iter(data.batches(B, 1))))
        enc = (torch.from_numpy(np.random.default_rng(0).normal(size=(B, 16, cfg.d_model))).float()
               if cfg.enc_dec else None)
        grads, losses = {}, {}
        for dev in ("cuda", "cpu"):
            p = tree_map(lambda t: t.to(dev), host)
            total, _, g = loss_and_grads(cfg, p, toks.to(dev), labels.to(dev),
                                         enc_input=None if enc is None else enc.to(dev))
            grads[dev], losses[dev] = {k: t.cpu() for k, t in flatten(g).items()}, float(total)
            del p, g
        worst, bad, tiny = grads_close(grads["cuda"], grads["cpu"], roundoff=1e-6)
        lerr = abs(losses["cuda"] - losses["cpu"]) / max(1.0, abs(losses["cpu"]))
        print(f"    {name} (2 layers, fp32, {time.perf_counter() - t0:.1f} s): loss card "
              f"{losses['cuda']:.6f} cpu {losses['cpu']:.6f}; {len(grads['cpu'])} gradient "
              f"leaves, worst error / bound = {worst:.4f} (need <= 1); zero to rounding on "
              f"both (<= 1e-6 of the largest leaf): {tiny or 'none'}")
        if bad or not lerr <= 1e-4:
            raise SystemExit(f"chip_smoke: 13e, {name}'s gradients on the card disagree with the "
                             f"CPU's: loss {lerr}, {bad[:8]}")
        del host, grads
        torch.cuda.empty_cache()

    Bt, St = TRAIN_FAMILY_BATCH
    counts = {}
    for name in RECURRENT_FAMILY:
        gc.collect()
        torch.cuda.empty_cache()
        ops.reset_launches()
        t0 = time.perf_counter()
        cut = family_config(name, TRAIN_FAMILY_DEPTH, "float32")
        published, launcher.get_config = launcher.get_config, lambda arch: cut
        try:
            _, hist = launcher.train(name, steps=TRAIN_FAMILY_STEPS, batch=Bt, seq=St, lr=3e-4,
                                     reduced=False, log_every=1, seed=0, device="cuda")
        finally:
            launcher.get_config = published
        counts[name] = ops.launches_by_shape()
        losses = [h["loss"] for h in hist]
        el = [h["elapsed_s"] for h in hist]
        ms = (el[-1] - el[1]) / (len(el) - 2) * 1e3
        prefill = {k[-1] if len(k) == 7 else "causal": n for k, n in counts[name].items()
                   if k[0] == "flash_prefill"}
        print(f"    train {name} ({TRAIN_FAMILY_DEPTH} layers, fp32, [{Bt}, {St}]): "
              f"{time.perf_counter() - t0:.1f} s, {ms:.1f} ms a step (steps 2-{len(el)}), loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}; flash_prefill launches by form {prefill}")
        need = {"hymba-1.5b": ("causal",), "seamless-m4t-medium": ("causal", "noncausal", "cross"),
                "xlstm-125m": ()}[name]
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]
                and all(prefill.get(f, 0) > 0 for f in need)):
            raise SystemExit(f"chip_smoke: 13e, training {name} failed: losses {losses}, "
                             f"flash_prefill by form {prefill}")
    return counts


# ---------------------------------------------------------------------------
# phase 2, sparsemax past 1024 and in bf16; 11b's TKD step at S = 1280;
# phase 14: the unblocked expert stack, C2 on the trained miniature, the dry run
# ---------------------------------------------------------------------------

TKD_LONG = (4, 1280)        # 11b's long TKD step, [batch, seq]: sparsemax rows of 1280
E8_DIR = os.path.join(ROOT, "experiments", "cache", "sys_E8")
E8_LANES, E8_STEPS = 8, 64  # 14b's greedy decode


def ulp_bound(want, dtype):
    """One unit in the last place of each |want| in `dtype` (the smallest
    normal's spacing below it): the elementwise bound of a half-precision
    sparsemax row against the fp32 plain version cast to its dtype."""
    import torch

    fi = torch.finfo(dtype)
    e = torch.floor(torch.log2(torch.clamp(want.float().abs(), min=fi.tiny)))
    return torch.exp2(e) * fi.eps


def check_long_sparsemax():
    """Phase 2, sparsemax past 1024 (C18) and in bf16: the block-a-row kernel
    at 11b's long step's scores [4, 1280, 1280], at TKD's batch
    [8, 2048, 2048] and at [1, 2048, 8192] (fp32, 1e-5 of the
    plain version, a rerun bit-identical), and bf16 at [8, 2048, 2048]: read
    as fp32, written in bf16, bit-equal to the fp32 kernel's output cast to
    bf16 and within one bf16 ulp of the plain version over z.float() cast
    to bf16. Each row's bound is a read and a write of z at 3.35 TB/s.
    Returns {row: record}."""
    import torch

    from repro_torch.kernels import ref
    from repro_torch.kernels.sparsemax import sparsemax_cuda

    gen = torch.Generator(device="cuda").manual_seed(654)

    def rnd(shape, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device="cuda") * 3.0).to(dtype)

    records, failed = {}, []
    B, S = TKD_LONG
    for row, shape in (("sparsemax/tkd-1280", (B, S, S)), ("sparsemax/tkd-2048", (8, 2048, 2048)),
                       ("sparsemax/tkd-8192", (1, 2048, 8192))):
        records[row] = check_sparsemax(failed, row, rnd(shape))
    bf16 = torch.bfloat16
    z = rnd((8, 2048, 2048), bf16)
    got, again = sparsemax_cuda(z), sparsemax_cuda(z)
    from_f32 = sparsemax_cuda(z.float()).to(bf16)
    torch.cuda.synchronize()
    same = torch.equal(got, from_f32)
    if not torch.equal(got, again):
        failed.append("sparsemax/bf16: a rerun differs")
    if not same:
        failed.append("sparsemax/bf16: differs from the fp32 kernel's output cast to bf16")
    plain = lambda: ref.sparsemax_ref(z.float()).to(bf16)
    want = plain()
    kern = lambda: sparsemax_cuda(z)
    records["sparsemax/bf16"] = report(
        failed, "sparsemax/bf16", bf16, tuple(z.shape), got, want, ulp_bound(want, bf16),
        time_ms(kern), time_ms(plain), None, bound_ms(nb(z, got), 4 * z.numel(), H100_F32_FLOPS),
        graph=(kern, None))
    print(f"    (sparsemax/bf16 bit-equal to the fp32 kernel cast to bf16: {same})")
    del z, got, again, from_f32, want
    torch.cuda.empty_cache()
    if failed:
        raise SystemExit(f"chip_smoke: sparsemax past 1024 / in bf16 disagrees: {failed}")
    return records


def tkd_long_card_vs_cpu(cfg, params):
    """Phase 11b's long step: one TKD step at S = 1280 (sparsemax rows of
    1280: the block kernel) from 11a's frozen model on `TKD_LONG`
    SyntheticLM tokens, the predictor seeded as 11b's: the TKD loss's
    gradients on the card against the CPU's on the same embeddings and
    teacher logits, each leaf within 1e-3 * max|g_cpu| (`grads_close`, as
    11c), and one `train_hash_fn` step's loss within 1e-4 * max(1, |loss|).
    Returns the card's sparsemax launches."""
    import torch

    from repro_torch.core.hash_fn import hash_fn_apply, init_hash_fn
    from repro_torch.core.tkd import tkd_loss, train_hash_fn
    from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import forward, n_moe_layers
    from repro_torch.tree import flatten, leaf_grads, requiring_grad, tree_map

    cfg_t = train_config(cfg)
    E = cfg.moe.num_experts
    B, S = TKD_LONG
    data = SyntheticLM(SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=S, n_domains=8), seed=6)
    toks = torch.from_numpy(data.sample(B)[0]).long().cuda()
    with torch.no_grad():
        teacher = forward(params, cfg_t, toks, collect_router_logits=True)["router_logits"]
    emb = params["embed"][toks]
    hp = init_hash_fn(torch.Generator().manual_seed(1), cfg.d_model, n_moe_layers(cfg), E,
                      d_h=64, device="cpu")
    runs = {}
    threads = torch.get_num_threads()
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        # the CPU's 1280-step LSTM backward is thousands of small ops, which
        # many threads only slow down
        torch.set_num_threads(threads if dev == "cuda" else min(threads, 2))
        e, t = emb.detach().to(dev), teacher.detach().to(dev)
        ops.reset_launches()
        p = requiring_grad(tree_map(lambda x: x.to(dev), hp))
        loss, _ = tkd_loss(hash_fn_apply(p, e, E), t, T=min(30, E), lam=0.005)
        grads = flatten(leaf_grads(loss, p))
        _, hist = train_hash_fn(tree_map(lambda x: x.to(dev), hp), iter([(e, t)]), steps=1,
                                lr=3e-3, T=min(30, E), lam=0.005, verbose=False)
        runs[dev] = (grads, hist[0]["loss"], ops.launches()["sparsemax"])
        print(f"  ({dev}) TKD at [{B}, {S}]: {time.perf_counter() - t0:.1f} s, loss "
              f"{hist[0]['loss']:.6f}, sparsemax launches {runs[dev][2]}")
    torch.set_num_threads(threads)
    (g_card, l_card, n_card), (g_cpu, l_cpu, _) = runs["cuda"], runs["cpu"]
    worst, bad, _ = grads_close(g_card, g_cpu)
    if not abs(l_card - l_cpu) <= 1e-4 * max(1.0, abs(l_cpu)):
        bad.append(f"loss {l_card} vs {l_cpu}")
    print(f"  gate: TKD at S = {S}, {len(g_cpu)} leaves: worst error / bound = {worst:.4f} "
          f"(need <= 1); loss card {l_card:.6f} cpu {l_cpu:.6f}")
    if bad or n_card == 0:
        raise SystemExit(f"chip_smoke: 11b's TKD step at S = {S}, card against CPU: {bad}, "
                         f"sparsemax launches {n_card}")
    return n_card


def expert_stack_path(cfg):
    """Phase 14a: `moe.apply_expert_stack` (the reference's unblocked einsum
    FFN, plain PyTorch) at switch-base-8's batch shape [4, 640, 768 -> 3072],
    bf16, against B1 (`ops.expert_ffn`) on the same inputs within
    5e-2 * max(1, max|y|); both timed."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.models.moe import apply_expert_stack

    gen = torch.Generator(device="cuda").manual_seed(77)
    E, C, d, Fh = 4, 640, cfg.d_model, cfg.moe.d_expert
    bf16 = torch.bfloat16
    p = {"w_in": torch.randn((E, d, Fh), generator=gen, device="cuda") * d ** -0.5,
         "w_gate": torch.randn((E, d, Fh), generator=gen, device="cuda") * d ** -0.5,
         "w_out": torch.randn((E, Fh, d), generator=gen, device="cuda") * Fh ** -0.5}
    p = {k: v.to(bf16) for k, v in p.items()}
    xe = torch.randn((E, C, d), generator=gen, device="cuda").to(bf16)
    with torch.no_grad():
        ops.reset_launches()
        want = ops.expert_ffn(xe, p["w_in"], None, p["w_out"], act=cfg.act)
        if ops.launches()["expert_ffn"] != 1:
            raise SystemExit("chip_smoke: 14a's B1 call did not launch its kernel")
        got = apply_expert_stack(p, xe, cfg)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        tol = 5e-2 * max(1.0, want.float().abs().max().item())
        s_ms = time_ms(lambda: apply_expert_stack(p, xe, cfg))
        k_ms = time_ms(lambda: ops.expert_ffn(xe, p["w_in"], None, p["w_out"], act=cfg.act))
    print(f"  apply_expert_stack bf16 {(E, C, d, Fh)}: max_abs_err vs B1 {err:.3e} tol {tol:.3e} "
          f"{'ok' if err <= tol else 'FAIL'}; ms {s_ms:.4f} (B1 {k_ms:.4f})")
    if not err <= tol or not torch.isfinite(got.float()).all():
        raise SystemExit("chip_smoke: 14a, apply_expert_stack disagrees with B1")


def e8_config():
    """The committed trained miniature's config (benchmarks' bench_cfg(8)):
    switch-base-8 reduced to 4 layers, d_model 128, 8 experts top-1 at
    capacity factor 4, served in bf16."""
    from repro_torch.configs.base import get_config

    cfg = get_config("switch-base-8").reduced()
    return dataclasses.replace(
        cfg, n_layers=4, d_ff=128, dtype="bfloat16",
        moe=dataclasses.replace(cfg.moe, num_experts=8, top_k=1, capacity_factor=4.0,
                                d_expert=512))


def e8_card_vs_cpu():
    """Phase 14b (C2 on the trained miniature): sys_E8's model in bf16 with
    its trained hash predictor, `SiDADecodeEngine` on the card and on the
    CPU, E8_LANES lanes x E8_STEPS greedy steps, no fixed routing table, all
    8 experts resident and 3 slots a layer: the greedy tokens and the loads
    of every step identical (the gate the CPU test holds the port to against
    JAX)."""
    import numpy as np
    import torch

    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.core.decode_engine import SiDADecodeEngine
    from repro_torch.sharding.policy import param_shapes
    from repro_torch.tree import flatten, unflatten

    cfg = e8_config()
    model, _ = load_checkpoint(os.path.join(E8_DIR, "model"))
    hp, _ = load_checkpoint(os.path.join(E8_DIR, "hash"))
    like = flatten(param_shapes(cfg))
    params = unflatten({k: t.to(like[k].dtype) for k, t in flatten(model).items()})
    start = np.random.default_rng(11).integers(0, cfg.vocab_size, (E8_LANES,)).astype(np.int32)
    for slots in (8, 3):
        out = {}
        for dev in ("cuda", "cpu"):
            eng = SiDADecodeEngine(cfg, params, hp, slots_per_layer=slots, device=dev)
            toks, m = eng.generate(start, steps=E8_STEPS, cache_len=E8_STEPS + 8)
            eng.close()
            out[dev] = (np.asarray(toks), m.loads_per_step)
        same = float((out["cuda"][0] == out["cpu"][0]).mean())
        loads = out["cuda"][1] == out["cpu"][1]
        print(f"  sys_E8 bf16, {slots} slots, {E8_LANES} lanes x {E8_STEPS} steps: greedy tokens "
              f"identical card vs CPU {same:.6f} (need 1.0); per-step loads identical {loads}")
        if same < 1.0 or not loads:
            raise SystemExit("chip_smoke: 14b, the card's bf16 greedy tokens differ from the CPU's "
                             "on the trained miniature")


def dryrun_path():
    """Phase 14c: the port's dry run (`launch/dryrun.py`, a fake-tensor
    trace on the host, no JAX) of switch-base-8 x {train_4k, decode_32k} on
    the pod mesh: FLOPs and GB a device. Fails if a trace fails."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch.dryrun import analyse

    cfg = get_config("switch-base-8")
    for shape in ("train_4k", "decode_32k"):
        rec = analyse(cfg, shape, "pod", verbose=False)
        if rec["status"] != "ok":
            raise SystemExit(f"chip_smoke: 14c, the dry run of {cfg.name} x {shape} failed: "
                             f"{rec['error']}")
        gb = (rec["argument_size_in_bytes"] + rec["output_size_in_bytes"]
              - rec["alias_size_in_bytes"]) / 1e9
        print(f"  {cfg.name} x {shape} x pod ({rec['n_devices']} devices): trace "
              f"{rec['trace_s']:.1f} s, flops_global {rec['flops_global']:.4e}, flops a device "
              f"{rec['flops']:.4e}, arguments a device {rec['argument_size_in_bytes'] / 1e9:.4f} GB, "
              f"arguments + outputs - aliases {gb:.4f} GB a device")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np

    from repro_torch.configs.base import TierConfig, get_config
    from repro_torch.core.offload import sharded_tier_geometry, tier_geometry
    from repro_torch.kernels import build
    from repro_torch.models.moe import _capacity

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = nvidia_smi()
    print(f"== phase 1: device\n  {smi}  (torch {torch.__version__}, CUDA {torch.version.cuda})")
    t0 = time.perf_counter()
    build.library()
    print(f"  kernels built and loaded in {time.perf_counter() - t0:.2f} s "
          f"(build/repro_torch/{build.source_hash()})", flush=True)

    cfg = get_config("switch-base-8")
    slots, batch, seq, n_batches = 4, 8, 256, 8
    int8_slots, lanes, steps, cache_len = 8, 8, 64, 512
    tier_slots = 4          # int8-slot budget of 5c: 2 hot int8 + 3 warm int4 slots
    spec_k = 4              # 5e's draft block
    for line in build.build_log().splitlines():
        if line.startswith("== "):
            print(f"  nvcc {line[3:]}")
    print(f"== phase 2: kernels vs plain (switch-base-8 serving and decode shapes) "
          f"[{time.perf_counter() - t_start:.1f} s]")
    runs = decode_runs(cfg, slots, int8_slots, tier_slots, cache_len)
    # 5c's hot and warm blocks: the store's split of its int8 budget, at the
    # capacity the decode step gives each of its slots (phase 5c checks the store's)
    d, Fh = cfg.d_model, cfg.moe.d_expert
    hot, warm = tier_geometry(runs[2][1]["tier"], tier_slots, cfg.moe.num_experts,
                              [(d, Fh), (d, Fh), (Fh, d)])
    c_tier = _capacity(cfg, lanes, hot + warm)
    # phase 7's tiered batch serve: the same split, at the batch's capacity
    c_tb = batch_capacity(cfg, batch, seq, hot + warm)
    records = check_kernels(cfg, batch, seq, slots)
    records.update(check_decode_kernels(cfg, lanes, cache_len, slots, int8_slots, hot, c_tier,
                                        batch_capacity(cfg, batch, seq, slots), hot, c_tb,
                                        cfg.moe.num_experts))
    records.update(check_tier_paged_kernels(cfg, lanes, cache_len, runs[2][2]["paged"].page_size,
                                            warm, c_tier, warm, c_tb))
    print(f"  -- the training shapes (fp32 [8, 128] tokens; each Function's backward)")
    records.update(check_training_kernels(cfg))
    print(f"  -- sparsemax past 1024 (the block-a-row kernel) and in bf16")
    records.update(check_long_sparsemax())
    print(f"  -- the expert-parallel shapes (B1 / B5 / B6 over one shard's slice of a pool)")
    shapes = [(d, Fh), (d, Fh), (Fh, d)]
    ep_tier = TierConfig(int4_slots=True, tier_split=0.5, group_size=64)
    ep_tiers = sharded_tier_geometry(ep_tier, tier_slots, cfg.moe.num_experts, shapes, 2)
    e64_tiers = sharded_tier_geometry(ep_tier, E64_SLOTS, 64, shapes, E64_SHARDS)
    records.update(check_ep_kernels(cfg, ep_kernel_cases(
        cfg, lanes, slots, int8_slots, ep_tiers, e64_tiers,
        batch_capacity(cfg, 8, SERVER_BUCKETS[-1], slots))))
    t0 = time.perf_counter()
    print(f"  -- the attention-family shapes (GLU experts, GQA group 16, head_dim 160 / 256)")
    records.update(check_family_kernels(lanes, cache_len))
    print(f"  (the attention-family shapes took {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    print(f"  -- phase 13's forms (hymba's GQA group 5 and window, seamless's encoder and "
          f"cross-attention)")
    records.update(check_recurrent_family_kernels())
    print(f"  (phase 13's forms took {time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    print(f"  -- nemotron-3-nano's relu² experts (phase 10e's shapes: 128 slots, "
          f"[{NEMOTRON_BATCH[0]}, {NEMOTRON_BATCH[1]}] batches)")
    records.update(check_nemotron_kernels())
    print(f"  (nemotron's shapes took {time.perf_counter() - t0:.1f} s)")

    print(f"== phase 3: batch path (SiDAEngine, switch-base-8 full width and depth, bf16) "
          f"[{time.perf_counter() - t_start:.1f} s]")
    t0 = time.perf_counter()
    params, hp = seeded_model(cfg)
    print(f"  seeded init on the host: {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
               for _ in range(n_batches)]
    counts = main_path(cfg, params, hp, batches, slots)

    print(f"== phase 7: SiDA against the baselines (switch-base-8 full width and depth, bf16) "
          f"[{time.perf_counter() - t_start:.1f} s]")
    bcounts = baselines_path(cfg, params, hp, batches, slots, tier_slots, (hot, warm))

    print(f"== phase 4: card vs CPU on the whole batch path [{time.perf_counter() - t_start:.1f} s]")
    card_vs_cpu(cfg, batches[0], slots)

    print(f"== phase 5: decode path (SiDADecodeEngine, switch-base-8 full width and depth, bf16) "
          f"[{time.perf_counter() - t_start:.1f} s]")
    dcounts, dms = decode_path(cfg, params, hp, lanes, steps, cache_len, runs, (hot, warm))

    print(f"== phase 5e: speculative decode (SiDADecodeEngine spec_mode=draft, switch-base-8 "
          f"full width and depth, bf16) [{time.perf_counter() - t_start:.1f} s]")
    scounts = spec_path(cfg, params, with_draft_head(cfg, hp), lanes, steps, cache_len, spec_k,
                        spec_runs(cfg, tier_slots, cache_len), (hot, warm))
    print(f"== phase 9: request server (RequestServer, switch-base-8 full width and depth, bf16) "
          f"[{time.perf_counter() - t_start:.1f} s]")
    svcounts, tick_ms_of = server_path(
        cfg, params, hp, server_runs(cfg, slots, tier_slots, spec_k, cache_len), dms["bf16"])
    print(f"== phase 9f: request server under faults (switch-base-8 full width and depth, bf16) "
          f"[{time.perf_counter() - t_start:.1f} s]")
    t0 = time.perf_counter()
    server_faults_path(cfg, params, hp, fault_runs(cfg, slots, tier_slots, spec_k, cache_len))
    print(f"  phase 9f took {time.perf_counter() - t0:.1f} s")
    print(f"== phase 9g: two tenants under WFQ (switch-base-8 full width and depth, bf16) "
          f"[{time.perf_counter() - t_start:.1f} s]")
    t0 = time.perf_counter()
    tenants_path(cfg, params, hp, slots, cache_len)
    print(f"  phase 9g took {time.perf_counter() - t0:.1f} s")
    t12 = time.perf_counter()
    print(f"== phase 12a: expert-parallel request server, every shard on this card "
          f"(switch-base-8 full width and depth, bf16) [{time.perf_counter() - t_start:.1f} s]")
    ecounts, egeom = ep_server_path(cfg, params, hp,
                                    ep_server_runs(cfg, slots, int8_slots, tier_slots, cache_len),
                                    tick_ms_of["9a"])
    if egeom["12a-tiered-ep2"] != ep_tiers:
        raise SystemExit(f"chip_smoke: 12a's tiered store has (S8, S4) = "
                         f"{egeom['12a-tiered-ep2']}, phase 2 checked {ep_tiers}")
    print(f"== phase 12b: every expert resident, EP against one device "
          f"[{time.perf_counter() - t_start:.1f} s]")
    ep_all_resident(cfg, params, hp, lanes, cache_len)
    print(f"  phase 12a-b took {time.perf_counter() - t12:.1f} s")
    del params

    print(f"== phase 6: decode card vs CPU [{time.perf_counter() - t_start:.1f} s]")
    decode_card_vs_cpu(cfg, lanes, slots, int8_slots, "float32")
    decode_card_vs_cpu(cfg, lanes, slots, int8_slots, "bfloat16")
    tiered_paged_card_vs_cpu(cfg, lanes, tier_slots)
    print(f"== phase 6d: speculative decode card vs CPU [{time.perf_counter() - t_start:.1f} s]")
    spec_card_vs_cpu(cfg, lanes, slots, tier_slots, spec_k)
    print(f"== phase 8: async pipeline and baselines, card vs CPU "
          f"[{time.perf_counter() - t_start:.1f} s]")
    async_card_vs_cpu(cfg, batches[:2], slots, lanes)
    print(f"== phase 9e: request server card vs CPU [{time.perf_counter() - t_start:.1f} s]")
    server_card_vs_cpu(cfg, slots, tier_slots, spec_k, cache_len)
    t0 = time.perf_counter()
    server_faults_card_vs_cpu(cfg, slots, cache_len)
    print(f"  phase 9e under faults and tenants took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    print(f"== phase 12c: expert parallelism card vs CPU (fp32, 2 layers, EP-2, replicas, "
          f"re-homing) [{time.perf_counter() - t_start:.1f} s]")
    ep_card_vs_cpu(cfg)
    print(f"== phase 12d: switch-base-64 at full width ({E64_DEPTH} layers), EP-{E64_SHARDS} "
          f"decode [{time.perf_counter() - t_start:.1f} s]")
    e64counts, e64_store_tiers = ep_e64_path(lanes, cache_len)
    if e64_store_tiers != e64_tiers:
        raise SystemExit(f"chip_smoke: 12d's tiered store has (S8, S4) = {e64_store_tiers}, "
                         f"phase 2 checked {e64_tiers}")
    print(f"  phase 12c-d took {time.perf_counter() - t0:.1f} s")
    fcounts = {}
    for name, depth, fslots in MOE_FAMILY:
        print(f"== phase 10{'ab'[len(fcounts)]}: {name} at full width ({depth} layers, bf16) "
              f"[{time.perf_counter() - t_start:.1f} s]")
        t0 = time.perf_counter()
        fcounts[name], _ = moe_family_path(name, depth, fslots, lanes, cache_len)
        print(f"  phase 10{'ab'[len(fcounts) - 1]} took {time.perf_counter() - t0:.1f} s")
    print(f"== phase 10c: the MoE family, card vs CPU (full width, 1 layer, fp32) "
          f"[{time.perf_counter() - t_start:.1f} s]")
    t0 = time.perf_counter()
    for name, _, fslots in MOE_FAMILY:
        moe_family_card_vs_cpu(name, fslots)
    print(f"  phase 10c took {time.perf_counter() - t0:.1f} s")
    print(f"== phase 10d: the dense attention-family configs at full width (2 layers, bf16) "
          f"[{time.perf_counter() - t_start:.1f} s]")
    t0 = time.perf_counter()
    dense_counts = {name: dense_family_path(name, shape) for name, shape in DENSE_FAMILY}
    print(f"  phase 10d took {time.perf_counter() - t0:.1f} s")
    print(f"== phase 10e: nemotron-3-nano at full width ({NEMOTRON_DEPTH} blocks, bf16) "
          f"[{time.perf_counter() - t_start:.1f} s]")
    t0 = time.perf_counter()
    ncounts = nemotron_path()
    print(f"  phase 10e took {time.perf_counter() - t0:.1f} s")
    t11 = time.perf_counter()
    print(f"== phase 11a: LM training (launch.train, switch-base-8 full width and depth, fp32) "
          f"[{time.perf_counter() - t_start:.1f} s]")
    trained, tcounts = train_path(cfg, records)
    print(f"== phase 11b: TKD of the predictor and the draft head from 11a's model "
          f"[{time.perf_counter() - t_start:.1f} s]")
    hp_trained, hp_untrained, kcounts = tkd_path(cfg, trained)
    print(f"== phase 11b, past 1024: one TKD step at S = {TKD_LONG[1]}, card vs CPU "
          f"[{time.perf_counter() - t_start:.1f} s]")
    long_tkd = tkd_long_card_vs_cpu(cfg, trained)
    print(f"== phase 11d: serving what was trained (bf16, SiDA at {slots} slots vs Standard) "
          f"[{time.perf_counter() - t_start:.1f} s]")
    serve_trained_path(cfg, trained, hp_trained, hp_untrained, slots)
    print(f"== phase 11e: sparsity of 11a's model [{time.perf_counter() - t_start:.1f} s]")
    sparsity_path(cfg, trained)
    del trained, hp_trained
    torch.cuda.empty_cache()
    print(f"== phase 11c: training card vs CPU (full width, 2 layers, fp32) "
          f"[{time.perf_counter() - t_start:.1f} s]")
    offline_card_vs_cpu(cfg)
    print(f"  phase 11 took {time.perf_counter() - t11:.1f} s")
    t13 = time.perf_counter()
    rcounts = {}
    print(f"== phase 13a: hymba-1.5b at full width and depth (bf16) "
          f"[{time.perf_counter() - t_start:.1f} s]")
    rcounts.update(hymba_path())
    print(f"== phase 13b: xlstm-125m at full width and depth (fp32) "
          f"[{time.perf_counter() - t_start:.1f} s]")
    xlstm_path()
    print(f"== phase 13c: seamless-m4t-medium at full width and depth (bf16) "
          f"[{time.perf_counter() - t_start:.1f} s]")
    rcounts.update(seamless_path())
    print(f"== phase 13d: the three families, card vs CPU (full width, 2 layers, fp32) "
          f"[{time.perf_counter() - t_start:.1f} s]")
    recurrent_card_vs_cpu()
    print(f"== phase 13e: training the three families (gradients card vs CPU; train() at "
          f"{TRAIN_FAMILY_DEPTH} layers) [{time.perf_counter() - t_start:.1f} s]")
    tfcounts = recurrent_training()
    print(f"  phase 13 took {time.perf_counter() - t13:.1f} s")
    t14 = time.perf_counter()
    print(f"== phase 14a: the unblocked expert stack against B1 (switch-base-8 [4, 640], bf16) "
          f"[{time.perf_counter() - t_start:.1f} s]")
    expert_stack_path(cfg)
    print(f"== phase 14b: C2, the trained sys_E8 in bf16, greedy tokens card vs CPU "
          f"[{time.perf_counter() - t_start:.1f} s]")
    e8_card_vs_cpu()
    print(f"== phase 14c: the dry run (fake-tensor trace), switch-base-8 on the pod mesh "
          f"[{time.perf_counter() - t_start:.1f} s]")
    dryrun_path()
    print(f"  phase 14 took {time.perf_counter() - t14:.1f} s")
    print(f"== all phases passed in {time.perf_counter() - t_start:.1f} s")

    meta = {
        "expert_ffn": ("cuda", "src/repro_torch/csrc/expert_ffn_sm90.cu",
                       "src/repro/kernels/expert_gemm.py:269"),
        "sparsemax": ("cuda", "src/repro_torch/csrc/sparsemax.cu",
                      "src/repro/kernels/sparsemax.py:43"),
        # sparsemax again, at the decode predictor's [lanes, 128] ring scores
        "sparsemax/ring": ("cuda", "src/repro_torch/csrc/sparsemax.cu",
                           "src/repro/kernels/sparsemax.py:43"),
        "flash_prefill": ("cuda", "src/repro_torch/csrc/flash_prefill.cu",
                          "src/repro/kernels/flash_prefill.py:82"),
        "flash_decode": ("cuda", "src/repro_torch/csrc/flash_decode.cu",
                         "src/repro/kernels/flash_decode.py:80"),
        "expert_ffn_q": ("cuda", "src/repro_torch/csrc/expert_ffn_sm90.cu",
                         "src/repro/kernels/expert_gemm.py:98"),
        "expert_ffn_q4": ("cuda", "src/repro_torch/csrc/expert_ffn_sm90.cu",
                          "src/repro/kernels/expert_gemm.py:211"),
        "flash_decode_paged": ("cuda", "src/repro_torch/csrc/flash_decode.cu",
                               "src/repro/kernels/flash_decode.py:180"),
        # expert_ffn again, at the decode step's [slots, 8, d] capacity buffer
        "expert_ffn/decode": ("cuda", "src/repro_torch/csrc/expert_ffn_sm90.cu",
                              "src/repro/kernels/expert_gemm.py:269"),
        # and at the all-resident verify step's [E, 8, d] (phase 5e)
        "expert_ffn/spec": ("cuda", "src/repro_torch/csrc/expert_ffn_sm90.cu",
                            "src/repro/kernels/expert_gemm.py:269"),
        # expert_ffn at StandardServer's dispatch over all E experts
        "expert_ffn/standard": ("cuda", "src/repro_torch/csrc/expert_ffn_sm90.cu",
                                "src/repro/kernels/expert_gemm.py:269"),
        # the int8 and tiered batch serves' shapes
        "expert_ffn_q/batch": ("cuda", "src/repro_torch/csrc/expert_ffn_sm90.cu",
                               "src/repro/kernels/expert_gemm.py:98"),
        "expert_ffn_q/tiered-batch": ("cuda", "src/repro_torch/csrc/expert_ffn_sm90.cu",
                                      "src/repro/kernels/expert_gemm.py:98"),
        "expert_ffn_q4/tiered-batch": ("cuda", "src/repro_torch/csrc/expert_ffn_sm90.cu",
                                       "src/repro/kernels/expert_gemm.py:211"),
        # the training forward's shapes (phase 11a) and the TKD scores (11b),
        # each row with its Function's backward
        "expert_ffn/train": ("cuda", "src/repro_torch/csrc/expert_ffn.cu",
                             "src/repro/kernels/expert_gemm.py:269"),
        "flash_prefill/train": ("cuda", "src/repro_torch/csrc/flash_prefill.cu",
                                "src/repro/kernels/flash_prefill.py:82"),
        "sparsemax/tkd": ("cuda", "src/repro_torch/csrc/sparsemax.cu",
                          "src/repro/kernels/sparsemax.py:43"),
        # past 1024 (the block-a-row kernel: 11b's long step, TKD's batch at
        # 2048 and 8192) and in bf16
        "sparsemax/tkd-1280": ("cuda", "src/repro_torch/csrc/sparsemax.cu",
                               "src/repro/kernels/sparsemax.py:43"),
        "sparsemax/tkd-2048": ("cuda", "src/repro_torch/csrc/sparsemax.cu",
                               "src/repro/kernels/sparsemax.py:43"),
        "sparsemax/tkd-8192": ("cuda", "src/repro_torch/csrc/sparsemax.cu",
                               "src/repro/kernels/sparsemax.py:43"),
        "sparsemax/bf16": ("cuda", "src/repro_torch/csrc/sparsemax.cu",
                           "src/repro/kernels/sparsemax.py:43"),
    }
    # phase 10's shapes: the GLU expert FFN of the MoE family, every
    # attention form; each row's launches its own phase-10 run's
    sources = {
        "expert_ffn": ("src/repro_torch/csrc/expert_ffn_sm90.cu", "src/repro/kernels/expert_gemm.py:269"),
        "expert_ffn_q": ("src/repro_torch/csrc/expert_ffn_sm90.cu", "src/repro/kernels/expert_gemm.py:98"),
        "expert_ffn_q4": ("src/repro_torch/csrc/expert_ffn_sm90.cu", "src/repro/kernels/expert_gemm.py:211"),
        "flash_prefill": ("src/repro_torch/csrc/flash_prefill.cu", "src/repro/kernels/flash_prefill.py:82"),
        "flash_decode": ("src/repro_torch/csrc/flash_decode.cu", "src/repro/kernels/flash_decode.py:80"),
        "flash_decode_paged": ("src/repro_torch/csrc/flash_decode.cu", "src/repro/kernels/flash_decode.py:180"),
    }
    family_launches = {}
    for name, _, _ in MOE_FAMILY:
        short, c = name.split("-")[0], fcounts[name]
        family_launches.update({
            f"expert_ffn/{short}-batch": c["sida-threaded"]["expert_ffn"],
            f"expert_ffn/{short}-decode": c["decode-bf16"]["expert_ffn"],
            f"expert_ffn_q/{short}-decode-hot": c["decode-tiered-paged"]["expert_ffn_q"],
            f"expert_ffn_q4/{short}-decode-warm": c["decode-tiered-paged"]["expert_ffn_q4"]})
    # each attention row's launches: its own form's (heads, head_dim,
    # window, softcap) in the phase-10 run that serves it
    row_runs = {"moe": ("sida-threaded", "decode-bf16", "decode-tiered-paged"),
            "dense": ("ring", "ring", "paged")}
    for suffix, name, *_, window, cap, src in attention_family_cases(lanes, cache_len):
        fcfg = family_config(name, 2)
        by = (fcounts if src == "moe" else dense_counts)[name]["by_shape"]
        for kernel, run in zip(("flash_prefill", "flash_decode", "flash_decode_paged"), row_runs[src]):
            family_launches[f"{kernel}/{suffix}"] = by[run].get(
                (kernel, fcfg.n_heads, fcfg.n_kv_heads, fcfg.hd, window, float(cap)), 0)
    idle = [row for row, n in family_launches.items() if n == 0]
    if idle:
        raise SystemExit(f"chip_smoke: phase 2 held shapes that phase 10 never launched: {idle}")
    for row in family_launches:
        meta[row] = ("cuda", *sources[row.split("/")[0]])
    # each kernel's launches on the path that runs it: the batch serve for
    # the batch kernels, the bf16 decode for flash_decode, sparsemax's ring
    # and expert_ffn at the decode shape, the int8 decode and the int8 and
    # tiered batch serves for expert_ffn_q, the tiered paged decode and the
    # tiered batch serve for expert_ffn_q4, the tiered paged decode for
    # flash_decode_paged; each batch shape's own row its own serve's
    launches = {k: counts[k] for k in BATCH_KERNELS}
    launches["flash_decode"] = dcounts["bf16"]["flash_decode"]
    launches["sparsemax/ring"] = dcounts["bf16"]["sparsemax"]
    launches["expert_ffn/decode"] = dcounts["bf16"]["expert_ffn"]
    launches["expert_ffn/standard"] = bcounts["standard"]["expert_ffn"]
    launches["expert_ffn_q/batch"] = bcounts["sida-int8"]["expert_ffn_q"]
    launches["expert_ffn_q/tiered-batch"] = bcounts["sida-tiered"]["expert_ffn_q"]
    launches["expert_ffn_q4/tiered-batch"] = bcounts["sida-tiered"]["expert_ffn_q4"]
    launches["expert_ffn_q"] = (dcounts["int8"]["expert_ffn_q"]
                                + launches["expert_ffn_q/batch"]
                                + launches["expert_ffn_q/tiered-batch"])
    launches["expert_ffn_q4"] = (dcounts["tiered-paged"]["expert_ffn_q4"]
                                 + launches["expert_ffn_q4/tiered-batch"])
    launches["flash_decode_paged"] = dcounts["tiered-paged"]["flash_decode_paged"]
    launches["expert_ffn/spec"] = scounts["spec-bf16"]["expert_ffn"]
    launches["expert_ffn/train"] = tcounts["expert_ffn"]
    launches["flash_prefill/train"] = tcounts["flash_prefill"]
    launches["sparsemax/tkd"] = kcounts["sparsemax"]
    # the long rows: 11b's step at S = 1280 launches the block kernel at
    # [4, 1280, 1280]; no path gives rows of 2048 or 8192, or sparsemax in
    # bf16 (the predictor computes in fp32)
    launches["sparsemax/tkd-1280"] = long_tkd
    launches["sparsemax/tkd-2048"] = launches["sparsemax/tkd-8192"] = 0
    launches["sparsemax/bf16"] = 0
    launches.update(family_launches)
    # the expert-parallel rows: each its phase-12 run's launches of its kernel
    ep_rows = {"expert_ffn/ep2-decode": ecounts["12a-ep2"]["expert_ffn"],
               "expert_ffn/ep2-prefill": ecounts["12a-ep2"]["expert_ffn"],
               "expert_ffn/ep4-decode": ecounts["12a-ep4"]["expert_ffn"],
               "expert_ffn_q/ep4-decode": ecounts["12a-int8-ep4"]["expert_ffn_q"],
               "expert_ffn_q/ep2-tiered-hot": ecounts["12a-tiered-ep2"]["expert_ffn_q"],
               "expert_ffn_q4/ep2-tiered-warm": ecounts["12a-tiered-ep2"]["expert_ffn_q4"],
               "expert_ffn/e64-ep4-decode": e64counts["e64-ep4-bf16"]["expert_ffn"],
               "expert_ffn_q/e64-ep4-hot": e64counts["e64-ep4-tiered"]["expert_ffn_q"],
               "expert_ffn_q4/e64-ep4-warm": e64counts["e64-ep4-tiered"]["expert_ffn_q4"]}
    for row, n in ep_rows.items():
        meta[row] = ("cuda", *sources[row.split("/")[0]])
        launches[row] = n
    # phase 10e's rows: each its own nemotron run's launches of its kernel
    nemotron_runs = {"expert_ffn/nemotron-batch": "sida-bf16",
                     "expert_ffn_q/nemotron-batch": "sida-int8",
                     "expert_ffn_q/nemotron-tiered-hot": "sida-tiered",
                     "expert_ffn_q4/nemotron-tiered-warm": "sida-tiered"}
    for row, *_ in nemotron_cases():
        kernel = row.split("/")[0]
        meta[row] = ("cuda", *sources[kernel])
        launches[row] = ncounts[nemotron_runs[row]][kernel]
    # phase 13's forms: each row's launches of its own form in its run
    for row, rcfg, kernel, *_, window, _, form, run in recurrent_rows():
        key = (kernel, rcfg.n_heads, rcfg.n_kv_heads, rcfg.hd, window, 0.0) + ((form,) if form else ())
        meta[row] = ("cuda", *sources[kernel])
        launches[row] = rcounts[run].get(key, 0)
    idle = [row for row, _, *_ in recurrent_rows() if launches[row] == 0]
    if idle:
        raise SystemExit(f"chip_smoke: phase 2 held forms that phase 13 never launched: {idle}")
    train_cross = sum(n for k, n in tfcounts["seamless-m4t-medium"].items() if k[-1] == "cross")
    print(f"  phase 13e's seamless training launched flash_prefill in the cross form "
          f"{train_cross} times")
    # each decode kernel's launches on the speculative path (phase 5e): the
    # all-resident bf16 run for the ring kernels, the tiered paged run for
    # the quantised and paged ones; null for the batch serves' rows
    spec_launches = {"flash_decode": scounts["spec-bf16"]["flash_decode"],
                     "sparsemax/ring": scounts["spec-bf16"]["sparsemax"],
                     "expert_ffn/spec": scounts["spec-bf16"]["expert_ffn"],
                     "expert_ffn_q": scounts["spec-tiered-paged"]["expert_ffn_q"],
                     "expert_ffn_q4": scounts["spec-tiered-paged"]["expert_ffn_q4"],
                     "flash_decode_paged": scounts["spec-tiered-paged"]["flash_decode_paged"]}
    kernels = []
    for name, (route, source, replaces) in meta.items():
        r = records[name]
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "launches": launches[name], "spec_launches": spec_launches.get(name),
                        "server_launches": ({run: c[name] for run, c in svcounts.items()}
                                            if name in svcounts["9a"] else None),
                        "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
                        "device_ms": r["device_ms"],
                        "library_device_ms": r["library_device_ms"],
                        **{k: v for k, v in r.items()
                           if k.startswith(("gathered_", "sdpa_nocap_", "library_max",
                                            "backward"))}})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
