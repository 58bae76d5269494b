"""Training launcher (port of `repro/launch/train.py`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch switch-base-8 \\
        --steps 30 --batch 8 --seq 128 [--ckpt DIR]

runs on the CUDA device; `--device cpu` with `--reduced` trains the
laptop-sized variant on the CPU. Weights come from a seeded CPU generator
(the same weights on any device), batches from `data.synthetic.SyntheticLM`,
the learning rate from `linear_warmup_cosine`. An encoder-decoder config's
encoder reads stub frame embeddings [batch, 16, d_model], drawn for step i
from `np.random.default_rng(i)` as the reference draws them.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs.base import get_config
from repro_torch.data.synthetic import SyntheticConfig, SyntheticLM
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.launch.steps import make_train_step
from repro_torch.models.transformer import init_params, param_count
from repro_torch.optim.adamw import adamw_init
from repro_torch.optim.schedule import linear_warmup_cosine


def train(
    arch: str,
    steps: int = 100,
    batch: int = 8,
    seq: int = 64,
    lr: float = 3e-4,
    reduced: bool = True,
    ckpt: str = "",
    log_every: int = 10,
    seed: int = 0,
    device: DeviceLike = None,
    dtype: Optional[str] = None,
):
    """-> (params, history); each history record holds the step, its
    lm_loss, lr and `elapsed_s`, the wall time from the first step's start
    to the moment its loss was read (which waits for the step's work)."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    if dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    print(f"arch={cfg.name} reduced={reduced} dtype={cfg.dtype} device={dev}")
    params = init_params(torch.Generator().manual_seed(seed), cfg, device=dev)
    print(f"params: {param_count(params):,}")
    opt = adamw_init(params)
    data = SyntheticLM(
        SyntheticConfig(vocab_size=cfg.vocab_size, seq_len=seq, n_domains=8), seed=seed,
    )
    sched = linear_warmup_cosine(lr, warmup=min(50, steps // 10 + 1), total=steps)
    step = make_train_step(cfg)

    history = []
    t0 = time.perf_counter()
    for i, (toks, labels) in enumerate(data.batches(batch, steps)):
        cur_lr = sched(i)
        enc = None
        if cfg.enc_dec:
            frames = np.random.default_rng(i).normal(size=(batch, 16, cfg.d_model))
            enc = torch.from_numpy(frames).to(dtype=getattr(torch, cfg.dtype), device=dev)
        params, opt, m = step(params, opt, torch.from_numpy(toks).to(dev),
                              torch.from_numpy(labels).to(dev), enc, lr_runtime=cur_lr)
        if i % log_every == 0 or i == steps - 1:
            loss = float(m["lm_loss"])
            elapsed = time.perf_counter() - t0
            history.append({"step": i, "loss": loss, "lr": cur_lr, "elapsed_s": elapsed})
            rate = (i + 1) * batch * seq / elapsed
            print(f"step {i:5d}  loss {loss:.4f}  lr {cur_lr:.2e}  tok/s {rate:,.0f}")
    if ckpt:
        save_checkpoint(ckpt, params, step=steps, extra={"arch": cfg.name})
        print(f"saved checkpoint to {ckpt}")
    return params, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    train(
        args.arch, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
        reduced=args.reduced, ckpt=args.ckpt, device=args.device,
    )


if __name__ == "__main__":
    main()
