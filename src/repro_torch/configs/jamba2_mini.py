"""jamba2-mini [hybrid] — 1 attention : 7 Mamba sublayers, MoE every other.

AI21-Jamba2-Mini (https://huggingface.co/ai21labs/AI21-Jamba2-Mini,
config.json; the Jamba family, arXiv:2403.19887 and arXiv:2408.12570):
52B parameters, 12B active. 32 layers; layer i mixes with GQA attention
(32 query heads, 8 K/V heads of 128, no positional encoding) where
i % 8 == 4 and with Mamba-1 (d_inner 8192, N 16, conv 4 with bias, dt rank
256, RMSNorms on Δ / B / C) elsewhere; its FFN is MoE (16 SwiGLU experts of
width 14336, top-2) where i % 2 == 1 and a dense SwiGLU of width 14336
elsewhere. Untied head over 65,536 ids.

Not registered: the registry lists the JAX package's configurations, and
the JAX package has no jamba block kind. The benchmark builds its cell's
configuration from its own file (`perfbench/configs/jamba2-mini-d8.json`);
this is the published model for anything else that wants it.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba2-mini",
    family="hybrid",
    citation="arXiv:2403.19887",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab_size=65536,
    act="silu",
    glu=True,
    norm_eps=1e-6,
    tie_embeddings=False,
    block_kind="jamba",
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=14336, moe_every=2),
    attn=AttnConfig(layer_pattern=("mamba",) * 4 + ("global",) + ("mamba",) * 3, rope_theta=0.0),
    ssm=SSMConfig(state_dim=16, conv_dim=4, expand=2),
)
