"""The program's `ModelConfig`, built from a configuration file's `model`
group alone, so the program's registry of presets does not move the cell."""
from __future__ import annotations

from typing import Dict


def build(spec: Dict):
    from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig

    m = dict(spec["model"])
    attn, moe = dict(m.pop("attn")), m.pop("moe")
    attn["layer_pattern"] = tuple(attn["layer_pattern"])
    return ModelConfig(**m, attn=AttnConfig(**attn), moe=MoEConfig(**moe))
