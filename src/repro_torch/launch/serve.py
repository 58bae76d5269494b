"""Serving launcher: SiDA against the paper's baselines on a Switch config
(batch mode), or the continuous-batching request server.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch switch-base-8 \\
        --full --engine sida --slots 4 --batches 8 --batch 8 --seq 256 \\
        [--prefetch-depth 2 --staging-buffers 2]
    ... --engine standard | ondemand | prefetchall

    PYTHONPATH=src python -m repro_torch.launch.serve --engine server \\
        --requests 16 --rate 4 --lanes 4 --slots 2 [--no-realtime] \\
        [--kv-pages 16 --page-size 8 --prefill-chunk 8] [--spec-mode draft --spec-k 3]

Port of `repro/launch/serve.py`, with the same workloads
(`np.random.default_rng(0)` tokens or Poisson requests), the same hash width
(d_h 64), the same flags (the serving ones registered from
`serving/config.py::SERVE_FLAGS`, validated by `validate_serve_args`) and
the same output lines. Trains nothing: random weights from seeded
`torch.Generator`s (0 for the model, 1 for the hash function). Runs on CUDA
unless `--device cpu`. The flags of what is not ported yet parse and are
refused with `NotImplementedError`: `--tenants` and `--fault-plan` (ROADMAP
A13(b)), `--ep-shards` > 1 and `--rebalance-interval` (A14).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.core.baselines import OnDemandServer, PrefetchAllServer, StandardServer
from repro_torch.core.engine import SiDAEngine
from repro_torch.core.hash_fn import init_hash_fn
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_params, n_moe_layers
from repro_torch.serving import RequestServer, poisson_requests
from repro_torch.serving.config import ServingConfig, ServingConfigError, add_serving_args


def build_engine(engine: str, cfg, params, slots: int, eviction: str = "fifo", device=None,
                 prefetch_depth: int = 0, staging_buffers: int = 2,
                 host_quant: str = "none", quantized_slots: bool = False,
                 scale_granularity: str = "channel", tier=None):
    if engine == "standard":
        return StandardServer(cfg, params, device=device)
    if engine == "ondemand":
        return OnDemandServer(cfg, params, slots_per_layer=slots, device=device)
    if engine == "prefetchall":
        return PrefetchAllServer(cfg, params, slots_per_layer=slots, device=device)
    hp = init_hash_fn(
        torch.Generator().manual_seed(1), cfg.d_model, n_moe_layers(cfg),
        cfg.moe.num_experts, d_h=64, device="cpu",
    )
    return SiDAEngine(
        cfg, params, hp, slots_per_layer=slots, eviction=eviction, device=device,
        prefetch_depth=prefetch_depth, staging_buffers=staging_buffers, host_quant=host_quant, quantized_slots=quantized_slots,
        scale_granularity=scale_granularity, tier=tier,
    )


def validate_serve_args(args) -> ServingConfig:
    """Fail fast on incoherent flag combinations. The config rules live in
    `ServingConfig.from_args` / `validate`; this adds the launcher's own
    checks (which flags need `--engine server`) and turns a
    `ServingConfigError` into the CLI's SystemExit, as the reference does."""

    def die(msg: str) -> None:
        raise SystemExit(f"serve: invalid flags: {msg}")

    if args.engine != "server":
        server_only = {
            "--rebalance-interval": args.rebalance_interval,
            "--kv-pages": args.kv_pages,
            "--max-seq": args.max_seq,
            "--prefill-chunk": args.prefill_chunk,
            "--fault-plan": args.fault_plan,
            "--fence-timeout": args.fence_timeout,
            "--shed-margin": args.shed_margin,
            "--tenants": args.tenants,
        }
        for flag, val in server_only.items():
            if val:
                die(f"{flag} applies to the request server: use --engine server")
    if args.shed_margin and args.slo is None and not args.tenants:
        die("--shed-margin needs a deadline to protect: also pass --slo "
            "(or tenant default SLOs)")
    try:
        return ServingConfig.from_args(args)
    except ServingConfigError as e:
        die(str(e))


def run_request_server(cfg, params, args, serving_cfg=None, device=None) -> None:
    """`--engine server`: the request server over a Poisson arrival stream
    (`np.random.default_rng(0)`), with the reference's output lines: the
    run's flags, `summary()`, then the telemetry snapshot as JSON."""
    if serving_cfg is None:
        serving_cfg = validate_serve_args(args)
    hp = init_hash_fn(
        torch.Generator().manual_seed(1), cfg.d_model, n_moe_layers(cfg),
        cfg.moe.num_experts, d_h=64, device="cpu", draft=args.spec_mode == "draft",
    )
    srv = RequestServer(cfg, params, hp, serving_cfg, device=device)
    reqs = poisson_requests(
        np.random.default_rng(0), args.requests, rate_rps=args.rate,
        vocab_size=cfg.vocab_size, prompt_len_range=(4, args.seq),
        max_new_range=(2, args.new_tokens), slo_s=args.slo,
    )
    try:
        srv.run(reqs, realtime=not args.no_realtime)
    finally:
        srv.close()
    print(f"engine=server slots={args.slots} lanes={args.lanes} "
          f"eviction={args.eviction} rate={args.rate}rps "
          f"prefetch_depth={args.prefetch_depth} "
          f"quantized_slots={args.quantized_slots} "
          f"int4_slots={args.int4_slots} "
          f"tier_split={args.tier_split} "
          f"spec={args.spec_mode}/k{args.spec_k} "
          f"ep_shards={args.ep_shards} "
          f"replicate_hot={args.replicate_hot} "
          f"rebalance_interval={args.rebalance_interval} "
          f"kv_pages={args.kv_pages}x{args.page_size} "
          f"prefill_chunk={args.prefill_chunk} "
          f"fault_plan={args.fault_plan or 'none'} "
          f"shed_margin={args.shed_margin} "
          f"tenants={args.tenants or 'none'}")
    for k, v in srv.summary().items():
        print(f"  {k:20s} {v:.4f}")
    for name, block in srv.tenant_summary().items():
        print(f"  tenant {name}:")
        for k, v in block.items():
            print(f"    {k:20s} {v:.4f}")
    print(srv.telemetry.to_json())


def build_parser() -> argparse.ArgumentParser:
    """The serve CLI: launcher and workload flags here, every serving knob
    registered from `SERVE_FLAGS` (serving/config.py), as the reference's."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="switch-base-8",
                    help="architecture config name (configs/)")
    ap.add_argument("--engine", default="sida",
                    choices=["sida", "standard", "ondemand", "prefetchall", "server"],
                    help="batch engines (sida | standard | ondemand | prefetchall) or the "
                         "continuous-batching request server")
    ap.add_argument("--batches", type=int, default=8,
                    help="batch-mode workload: number of batches")
    ap.add_argument("--batch", type=int, default=4,
                    help="batch-mode workload: sequences per batch")
    ap.add_argument("--seq", type=int, default=32,
                    help="workload sequence / max prompt length")
    ap.add_argument("--full", action="store_true",
                    help="full-size config (default: reduced() laptop size)")
    ap.add_argument("--requests", type=int, default=16,
                    help="(server) Poisson-arrival requests (per tenant)")
    ap.add_argument("--rate", type=float, default=4.0,
                    help="(server) arrival rate, requests/sec")
    ap.add_argument("--new-tokens", type=int, default=8,
                    help="(server) max decode budget per request")
    ap.add_argument("--slo", type=float, default=None,
                    help="(server) latency SLO in seconds (EDF deadline)")
    ap.add_argument("--no-realtime", action="store_true",
                    help="(server) ignore arrival gaps (fast smoke runs)")
    add_serving_args(ap)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass cpu to run on the CPU)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    serving_cfg = validate_serve_args(args)
    if args.ep_shards > 1:
        raise NotImplementedError("expert-parallel serving is ported in ROADMAP A14")
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    # weights are made on the host; the engine keeps the experts there and
    # moves the rest to `device`
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    if args.engine == "server":
        run_request_server(cfg, params, args, serving_cfg, device=device)
        return

    rng = np.random.default_rng(0)
    batches = [
        rng.integers(0, cfg.vocab_size, (args.batch, args.seq)).astype(np.int32)
        for _ in range(args.batches)
    ]
    srv = build_engine(args.engine, cfg, params, args.slots, args.eviction, device,
                       args.prefetch_depth, args.staging_buffers,
                       host_quant=args.host_quant, quantized_slots=args.quantized_slots,
                       scale_granularity=args.scale_granularity, tier=serving_cfg.quant.tier)
    del params   # the engine holds what it serves
    metrics = srv.serve(batches)
    print(f"engine={args.engine} slots={args.slots} quantized_slots={args.quantized_slots} "
          f"int4_slots={args.int4_slots} tier_split={args.tier_split}")
    for k, v in metrics.summary().items():
        print(f"  {k:20s} {v:.4f}")
    print(f"  device_mem_mb        {srv.device_memory_bytes()/1e6:.2f}")
    if isinstance(srv, SiDAEngine):
        for k, v in srv.memory_saving().items():
            print(f"  {k:20s} {v:.4f}")
        st = srv.store.stats
        print(f"  loads={st.loads} hits={st.hits} evictions={st.evictions} "
              f"promotions={st.promotions} demotions={st.demotions} "
              f"h2d_mb={st.bytes_h2d/1e6:.2f} sync_upload_s={st.prepare_time:.4f}")
        if srv.prefetcher is not None:
            for k, v in srv.prefetcher.stats.summary().items():
                print(f"  {k:22s} {v:.4f}")
        srv.close()


if __name__ == "__main__":
    main()
