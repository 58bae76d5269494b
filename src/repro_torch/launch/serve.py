"""Serving launcher, batch mode: SiDA against the paper's baselines on a
Switch config.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch switch-base-8 \\
        --full --engine sida --slots 4 --batches 8 --batch 8 --seq 256 \\
        [--prefetch-depth 2 --staging-buffers 2]
    ... --engine standard | ondemand | prefetchall

Port of `repro/launch/serve.py`'s batch mode, with the same workload
(`np.random.default_rng(0)` tokens), the same hash width (d_h 64) and the
same summary lines. Trains nothing: random weights from seeded
`torch.Generator`s (0 for the model, 1 for the hash function). Runs on CUDA
unless `--device cpu`. `--prefetch-depth` (> 0) moves SiDA's uploads to the
async prefetch pipeline. `--host-quant int8` keeps int8 host masters
(dequantised at slot write), `--quantized-slots` keeps the slots int8 and
runs the int8 expert FFN, and `--int4-slots` (with `--quantized-slots`)
splits the slot budget into hot int8 and warm int4 slots (`--tier-split`,
`--quant-group`). The request server (`--engine server`, ROADMAP A13) and
the other serving flags come with later slices.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs.base import TierConfig, get_config
from repro_torch.core.baselines import OnDemandServer, PrefetchAllServer, StandardServer
from repro_torch.core.engine import SiDAEngine
from repro_torch.core.hash_fn import init_hash_fn
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_params, n_moe_layers


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


def serve_tier(args):
    """The `TierConfig` of --int4-slots, or None when tiering is off. Refuses
    what the reference's flag validation refuses."""
    if not args.int4_slots:
        return None
    if not args.quantized_slots:
        raise SystemExit("serve: invalid flags: the int4 warm tier extends the quantized "
                         "slot pool: also set --quantized-slots (hot tier stays int8)")
    if not 0.0 < args.tier_split <= 1.0:
        raise SystemExit(f"serve: invalid flags: --tier-split {args.tier_split} must be in "
                         "(0, 1]: the fraction of the slot byte budget held as int8 hot slots")
    if args.quant_group <= 0:
        raise SystemExit("serve: invalid flags: --quant-group must be >= 1 (int4 scale "
                         "group size along the contraction axis)")
    return TierConfig(int4_slots=True, tier_split=args.tier_split, group_size=args.quant_group)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="switch-base-8",
                    help="architecture config name (configs/)")
    ap.add_argument("--engine", default="sida",
                    choices=["sida", "standard", "ondemand", "prefetchall"],
                    help="batch engines: sida | standard | ondemand | prefetchall (the "
                         "request server is not ported yet)")
    ap.add_argument("--batches", type=int, default=8,
                    help="batch-mode workload: number of batches")
    ap.add_argument("--batch", type=int, default=4,
                    help="batch-mode workload: sequences per batch")
    ap.add_argument("--seq", type=int, default=32,
                    help="workload sequence length")
    ap.add_argument("--full", action="store_true",
                    help="full-size config (default: reduced() laptop size)")
    ap.add_argument("--slots", type=int, default=2,
                    help="device expert slots per MoE layer (the memory budget)")
    ap.add_argument("--eviction", default="fifo", choices=["fifo", "lru", "alpha"],
                    help="slot replacement: fifo | lru | alpha (α-mass)")
    # the JAX CLI's flags, with its choices and defaults (serving/config.py)
    ap.add_argument("--prefetch-depth", type=int, default=0,
                    help="async prefetch lookahead (0 = synchronous uploads)")
    ap.add_argument("--staging-buffers", type=int, default=2,
                    help="host staging slabs for the transfer thread")
    ap.add_argument("--host-quant", default="none", choices=["none", "int8"],
                    help="host expert tier format (int8 halves H2D bytes; dequantised "
                         "at slot write unless --quantized-slots)")
    ap.add_argument("--quantized-slots", action="store_true",
                    help="int8 device-resident slots + fused-dequant expert FFN (2-4x "
                         "resident experts per slot byte; implies --host-quant int8)")
    ap.add_argument("--scale-granularity", default="channel", choices=["channel", "tensor"],
                    help="int8 scale granularity per expert tensor")
    ap.add_argument("--int4-slots", action="store_true",
                    help="hierarchical residency tiers: keep the hot tier int8 and add a warm "
                         "tier of nibble-packed int4 slots with per-group scales (~2x experts "
                         "per byte); requires --quantized-slots")
    ap.add_argument("--tier-split", type=float, default=0.5,
                    help="fraction of the slot byte budget held as int8 hot slots; the "
                         "remainder becomes int4 warm slots (1.0 = all-hot, degenerate to "
                         "--quantized-slots)")
    ap.add_argument("--quant-group", type=int, default=64,
                    help="int4 scale group size along the contraction axis (smaller = "
                         "tighter error, more scale-plane bytes)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; pass cpu to run on the CPU)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    tier = serve_tier(args)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    # weights are made on the host; the engine keeps the experts there and
    # moves the rest to `device`
    params = init_params(torch.Generator().manual_seed(0), cfg, device="cpu")

    rng = np.random.default_rng(0)
    batches = [
        rng.integers(0, cfg.vocab_size, (args.batch, args.seq)).astype(np.int32)
        for _ in range(args.batches)
    ]
    srv = build_engine(args.engine, cfg, params, args.slots, args.eviction, device,
                       args.prefetch_depth, args.staging_buffers,
                       host_quant=args.host_quant, quantized_slots=args.quantized_slots,
                       scale_granularity=args.scale_granularity, tier=tier)
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
