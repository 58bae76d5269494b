"""Stand-ins for every model input, per (arch x input shape) (port of
`repro/launch/specs.py`): fake CPU tensors, with shapes and dtypes and no
memory, where the reference makes `ShapeDtypeStruct`s.

Shapes:
  train_4k     seq 4096,   batch 256  -> train_step(params, opt, tokens, labels)
  prefill_32k  seq 32768,  batch 32   -> prefill_step(params, tokens)
  decode_32k   seq 32768,  batch 128  -> serve_step(params, cache, tokens)
  long_500k    seq 524288, batch 1    -> serve_step (sub-quadratic archs only)

The audio frontend is a stub: `enc_input` is a precomputed frame-embedding
tensor of the right shape; VLM image tokens are ordinary vocabulary ids.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.sharding.policy import cache_shapes, fake_mode

AUDIO_ENC_FRAMES = 1536  # ~30 s of 20 ms frames (the stub frontend's output)


def input_specs(cfg: ModelConfig, shape: InputShape, mode=None) -> Dict[str, Any]:
    """The model inputs of `shape` (not the params, the optimizer or, except
    for decode, the cache) as fake tensors under `mode` (or a fresh fake
    mode): tokens and labels [B, S] int32, `enc_input` [B, 1536, d_model]
    for an encoder-decoder config; for decode, one token [B] and the cache
    `init_cache` makes for a seq_len budget."""
    B, S = shape.global_batch, shape.seq_len
    mode = fake_mode(mode)
    enc = AUDIO_ENC_FRAMES if cfg.enc_dec else 0
    with mode:
        if shape.kind == "decode":
            return {"tokens": torch.zeros((B,), dtype=torch.int32),
                    "cache": cache_shapes(cfg, B, S, enc, mode=mode)}
        out = {"tokens": torch.zeros((B, S), dtype=torch.int32)}
        if shape.kind == "train":
            out["labels"] = torch.zeros((B, S), dtype=torch.int32)
        if cfg.enc_dec:
            out["enc_input"] = torch.zeros((B, enc, cfg.d_model), dtype=getattr(torch, cfg.dtype))
    return out
