#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py          # needs one CUDA GPU; exits non-zero on any failure

1. Device: the card's name and power limit, then the build of every kernel
   in `src/repro_torch/csrc` (nvcc, one process per source) and its time.
2. Kernels vs plain: each hand-written kernel at the shapes the served
   switch-base-8 run gives it, in bf16 and fp32, against its plain PyTorch
   version — max abs error and tolerance, kernel / plain / library ms
   (CUDA events, warm L2, back to back) and the least time the H100 could
   take (989 TFLOP/s bf16 or 67 TFLOP/s fp32, 3.35 TB/s).
3. Main path: `SiDAEngine` on switch-base-8 at full width and depth (bf16,
   seeded random weights), 4 expert slots per MoE layer, 8 batches of
   8 x 256 tokens through the threaded serve; throughput, latency, memory,
   store traffic, and every kernel's launch count in that run (0 fails).
4. Card vs CPU: full width, 2 layers, fp32, one batch through the port on
   the card and on the CPU with the same weights: hash ids agree (>= 0.999),
   and the same table gives logits within tolerance.

The second-to-last lines are the kernels' JSON record and the nvidia-smi
line; the last line is {"ok": true, "device": {...}}. Imports nothing of
JAX or of the JAX package.
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


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes, t_ops = nbytes / H100_BYTES_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def nb(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def check_kernels(cfg, batch: int, seq: int, slots: int):
    """Phase 2: every kernel vs its plain version at the main path's shapes.
    Returns {kernel: record of the bf16 / main-path case}."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.expert_gemm import expert_ffn_cuda
    from repro_torch.kernels.flash_prefill import flash_prefill_cuda
    from repro_torch.kernels.sparsemax import sparsemax_cuda
    from repro_torch.models.moe import _block_tokens, _capacity

    dev = torch.device("cuda")
    gen = torch.Generator(device="cpu").manual_seed(123)

    def rnd(shape, scale, dtype):
        return (torch.randn(shape, generator=gen) * scale).to(dtype=dtype, device=dev)

    records, failed = {}, []

    def report(name, dtype, shape, got, want, tol, k_ms, p_ms, lib_ms, bnd):
        err = (got.float() - want.float()).abs().max().item()
        ok = bool(err <= tol) and bool(torch.isfinite(got.float()).all())
        lib = "null" if lib_ms is None else f"{lib_ms:.4f}"
        print(f"  {name:14s} {str(dtype).replace('torch.', ''):8s} {shape} max_abs_err={err:.3e} "
              f"tol={tol:g} {'ok' if ok else 'FAIL'} kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
              f"library_ms={lib} bound_ms={bnd[0]:.4f} ({bnd[1]})", flush=True)
        if not ok:
            failed.append(f"{name} {dtype} {shape}")
        return err

    # --- expert_ffn: [E=slots, C, d] through the slot stack (non-gated GELU)
    d, Fh = cfg.d_model, cfg.moe.d_expert
    T = batch * seq
    C = (T // _block_tokens(T)) * _capacity(cfg, _block_tokens(T), slots)
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
        k_ms = time_ms(lambda: expert_ffn_cuda(xe, wi, None, wo, act=cfg.act))
        p_ms = time_ms(lambda: ref.expert_ffn_ref(xe, wi, None, wo, act=cfg.act))
        l_ms = time_ms(lib)
        err = report("expert_ffn", dtype, (slots, C, d, Fh), got, want, tol, k_ms, p_ms, l_ms, bnd)
        if dtype == torch.bfloat16:
            records["expert_ffn"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                                         bound_ms=bnd[0], bound_by=bnd[1], library_ms=l_ms)

    # --- sparsemax: the predictor's scores [B, S, S] (fp32 only on the path)
    z = rnd((batch, seq, seq), 3.0, torch.float32)
    got = sparsemax_cuda(z)
    torch.cuda.synchronize()
    want = ref.sparsemax_ref(z)
    bnd = bound_ms(nb(z, got), 4 * z.numel(), H100_F32_FLOPS)
    k_ms, p_ms = time_ms(lambda: sparsemax_cuda(z)), time_ms(lambda: ref.sparsemax_ref(z))
    err = report("sparsemax", torch.float32, tuple(z.shape), got, want, 1e-5, k_ms, p_ms, None, bnd)
    records["sparsemax"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                                bound_ms=bnd[0], bound_by=bnd[1], library_ms=None)

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
            l_ms = None
            if not window and not cap:
                qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
                l_ms = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True))
            k_ms = time_ms(lambda: flash_prefill_cuda(q, k, v, window=window, cap=cap))
            p_ms = time_ms(lambda: ref.flash_prefill_ref(q, k, v, window, cap, True))
            err = report(f"flash_prefill{'/w' + str(window) + 'c' + str(int(cap)) if window else ''}",
                         dtype, tuple(q.shape), got, want, tol, k_ms, p_ms, l_ms, bnd)
            if dtype == torch.bfloat16 and not window:
                records["flash_prefill"] = dict(max_abs_err=err, ms=k_ms, plain_ms=p_ms,
                                                bound_ms=bnd[0], bound_by=bnd[1], library_ms=l_ms)
    if failed:
        raise SystemExit(f"chip_smoke: kernels disagree with their plain versions: {failed}")
    return records


def main_path(cfg, batches, slots: int):
    """Phase 3: the threaded SiDA serve at full width; returns launch counts."""
    import numpy as np
    import torch

    from repro_torch.core.engine import SiDAEngine
    from repro_torch.core.hash_fn import init_hash_fn
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_params, n_moe_layers

    t0 = time.perf_counter()
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    hp = init_hash_fn(torch.Generator().manual_seed(1), cfg.d_model, n_moe_layers(cfg),
                      cfg.moe.num_experts, d_h=64, device="cpu")
    eng = SiDAEngine(cfg, params, hp, slots_per_layer=slots, device="cuda")
    del params
    print(f"  setup_s={time.perf_counter() - t0:.2f} (seeded init on the host, engine build)")
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
    idle = [k for k, v in counts.items() if v == 0]
    if idle:
        raise SystemExit(f"chip_smoke: kernels never launched on the main path: {idle}")
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

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs on the GPU only", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import numpy as np

    from repro_torch.configs.base import get_config
    from repro_torch.kernels import build

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
    print("== phase 2: kernels vs plain (switch-base-8 serving shapes)")
    records = check_kernels(cfg, batch, seq, slots)

    print("== phase 3: main path (SiDAEngine, switch-base-8 full width and depth, bf16)")
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)
               for _ in range(n_batches)]
    counts = main_path(cfg, batches, slots)

    print("== phase 4: card vs CPU on the whole path")
    card_vs_cpu(cfg, batches[0], slots)
    print(f"== all phases passed in {time.perf_counter() - t_start:.1f} s")

    meta = {
        "expert_ffn": ("cuda", "src/repro_torch/csrc/expert_ffn.cu",
                       "src/repro/kernels/expert_gemm.py:269"),
        "sparsemax": ("cuda", "src/repro_torch/csrc/sparsemax.cu",
                      "src/repro/kernels/sparsemax.py:43"),
        "flash_prefill": ("cuda", "src/repro_torch/csrc/flash_prefill.cu",
                          "src/repro/kernels/flash_prefill.py:82"),
    }
    kernels = []
    for name, (route, source, replaces) in meta.items():
        r = records[name]
        kernels.append({"name": name, "route": route, "source": source, "replaces": replaces,
                        "launches": counts[name], "max_abs_err": r["max_abs_err"],
                        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
