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
   (expert_ffn_q) and warm (expert_ffn_q4) blocks.
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
   kernels of that path), a per-step stage split, the profiled device idle
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
   run's kernels launch, all seven kernels over 9a-9d. (e) card vs CPU, fp32,
   2 layers at full width, capacity_factor 100, pre-admitted: 9a's, 9c's
   (a 768-token prompt in 3 chunks) and 9d's setups give every request the
   same tokens and the store the same counters on the card and the CPU.

The second-to-last lines are the kernels' JSON record (the seven kernels,
expert_ffn at the decode shape, at 5e's all-resident verify step
[8, 8, d] and at Standard's, expert_ffn_q and
expert_ffn_q4 at the batch serves' shapes, and sparsemax at the ring's;
`device_ms` and
`library_device_ms` are the graph-replayed times; `spec_launches` a decode
kernel's launches on 5e's speculative runs, null for the batch rows;
`server_launches` a kernel's launches on each of 9a-9d (null for the shape
rows); flash_decode_paged's
`gathered_*` times are its comparators on the keys gathered into a ring) and
the nvidia-smi line; the last line is {"ok": true, "device": {...}}. Imports
nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import dataclasses
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
    `graph` is (kernel call, library call or None), timed again on the device
    alone by `graph_ms`. Beside each kernel time: its rate in the unit of what
    bounds it (TFLOP/s or GB/s) and the share of the bound it reaches.
    Returns the case's record for the kernels' JSON line."""
    import torch

    err = (got.float() - want.float()).abs().max().item()
    ok = bool(err <= tol) and bool(torch.isfinite(got.float()).all())
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
          f"tol={tol:g} {'ok' if ok else 'FAIL'} kernel_ms={rate(k_ms)} plain_ms={p_ms:.4f} "
          f"library_ms={lib} bound_ms={bnd[0]:.4f} ({bnd[1]}){dev}", flush=True)
    if not ok:
        failed.append(f"{name} {dtype} {shape}")
    return dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms, bound_ms=bnd[0], bound_by=bnd[1],
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
    """Every resident slot of `store` against its host master, byte for byte
    (the fp / int8 rows and scale planes, the warm tier's int4 rows and group
    scales). Returns the number of slots checked; raises on a mismatch."""
    import torch

    from repro_torch.core.offload import EXPERT_TENSORS

    n = 0
    for l in range(store.L):
        g, s = store.layer_to_gs(l)
        moe_p = store.serve_params["blocks"][f"sub{s}"]["moe"]
        for e, slot in store.resident[(g, s)].items():
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

    from repro_torch.core.offload import quantize_expert_q4
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
        q, sc = quantize_expert_q4(w.numpy(), 64)
        return torch.from_numpy(q).to(dev), torch.from_numpy(sc).to(dev)

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
        print(f"    tok_s={m.tok_s:.1f} ms_per_step={1e3 * m.wall_s / m.steps:.3f} "
              f"wall_s={m.wall_s:.4f} tokens={m.tokens} stall_s={m.stall_s:.4f}")
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
        t0 = time.perf_counter()
        decode_stages(eng, start, 16, cache_len, gen_kw.get("paged"))
        t1 = time.perf_counter()
        decode_profile(eng, start, 16, cache_len, gen_kw)
        print(f"    (stage split {t1 - t0:.1f} s, profile {time.perf_counter() - t1:.1f} s)")
        out_counts[name] = counts
        ms_per_step[name] = 1e3 * m.wall_s / m.steps
        eng.close()
        del eng
    return out_counts, ms_per_step


def decode_stages(eng, start, steps: int, cache_len: int, paged=None):
    """Phase 5, per-step split: the generate loop with a synchronize after
    each stage, host clock around each."""
    import numpy as np
    import torch

    from repro_torch.core.decode_engine import DecodeMetrics, TableBuffer, hash_state_init

    B = len(start)
    stages = {"page_tick": [], "predict_ids_d2h": [], "prepare": [], "translate": [],
              "step_token_d2h": []}
    with torch.inference_mode():
        cache, pool = eng._make_cache(B, cache_len, paged)
        hstate = hash_state_init(eng.hash_params, B)
        tokens = torch.as_tensor(start, dtype=torch.int32, device=eng.device)
        tbuf, m = TableBuffer(eng.L, B, 1, eng.k), DecodeMetrics()
        torch.cuda.synchronize()
        for i in range(steps):
            tp = time.perf_counter()
            if pool is not None:
                cache = eng._page_tick(pool, cache, np.full((B,), i + 1, np.int64))
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            ids, alpha, hstate = eng._predict_step(tokens, hstate)
            table = tbuf.fill(i, ids, alpha)                 # ends in the ids' copy to host
            t1 = time.perf_counter()
            trans, ticket = eng._route_table(table, m)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            slot_ids, w = eng.store.translate_device(ids[:, :, None, :], alpha[:, :, None, :], trans)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            tokens, cache = eng._step(cache, tokens, slot_ids[:, :, 0, :], w[:, :, 0, :])
            tokens.cpu()
            t4 = time.perf_counter()
            if pool is not None:
                pool.unpin_all()
            if ticket is not None:
                ticket.release()
            for k, v in zip(stages, (t0 - tp, t1 - t0, t2 - t1, t3 - t2, t4 - t3)):
                stages[k].append(v)
    if pool is None:
        del stages["page_tick"]
    print(f"    per-step stage means over {steps} steps (synchronised): " + " ".join(
        f"{k}_ms={1e3 * float(np.mean(v)):.3f}" for k, v in stages.items()))


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
    run's path launched. Returns {run name: launch counts}."""
    import torch

    from repro_torch.kernels import ops
    from repro_torch.serving import RequestServer

    keys = ("completed", "rejected", "throughput_tok_s", "decode_tok_s", "p50_latency_s",
            "p95_latency_s", "p50_ttft_s", "p95_ttft_s", "cache_hit_rate", "h2d_mb",
            "upload_stall_s", "upload_overlap_s", "max_queue_depth", "spec_acceptance_rate",
            "spec_accepted_per_step")
    out_counts = {}
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
        del srv
    unused = [k for k in out_counts["9a"] if not any(c[k] for c in out_counts.values())]
    if unused:
        raise SystemExit(f"chip_smoke: kernels never launched on the server paths: {unused}")
    return out_counts


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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.core.offload import tier_geometry
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
    svcounts = server_path(cfg, params, hp, server_runs(cfg, slots, tier_slots, spec_k, cache_len),
                           dms["bf16"])
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
    }
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
                        **{k: v for k, v in r.items() if k.startswith("gathered_")}})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
