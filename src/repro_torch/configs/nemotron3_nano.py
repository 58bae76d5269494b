"""nemotron3-nano [hybrid] — Mamba-2, MoE and attention blocks, one mixer a block.

NVIDIA-Nemotron-3-Nano-30B-A3B
(https://huggingface.co/nvidia/NVIDIA-Nemotron-3-Nano-30B-A3B-BF16,
config.json; the Nemotron-H family, arXiv:2504.03624, with Mamba-2's SSD,
arXiv:2405.21060): 31.6B parameters, 3.2B active. 52 blocks
`x += mixer(RMSNorm(x))` in the order of `hybrid_override_pattern`
(M Mamba-2, E MoE, * attention): 23 Mamba-2 mixers (64 heads of 64, state
128 in 8 groups, conv 4 with bias, chunk 128), 23 MoE layers (128 relu²
experts of width 1856, top-6 by a sigmoid router with a correction bias,
weights renormalised and scaled by 2.5, beside one relu² shared expert of
width 3712) and 6 GQA attention layers (32 query heads, 2 K/V heads of 128,
no positional encoding). Untied head over 131,072 ids.

Not registered: the registry lists the JAX package's configurations, and
the JAX package has no nemotron_h block kind. The benchmark builds its
cell's configuration from its own file
(`perfbench/configs/nemotron-3-nano-d13.json`); this is the published model
for anything else that wants it.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig, SSMConfig

PATTERN = "MEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEM*EMEMEMEM*EMEMEMEME"
KINDS = {"M": "mamba2", "E": "moe", "*": "global"}

CONFIG = ModelConfig(
    name="nemotron3-nano",
    family="hybrid",
    citation="arXiv:2504.03624",
    n_layers=len(PATTERN),
    d_model=2688,
    n_heads=32,
    n_kv_heads=2,
    head_dim=128,
    d_ff=0,
    vocab_size=131072,
    act="relu2",
    glu=False,
    norm_eps=1e-5,
    tie_embeddings=False,
    block_kind="nemotron_h",
    moe=MoEConfig(num_experts=128, top_k=6, d_expert=1856, num_shared_experts=1, d_shared=3712,
                  score_func="sigmoid", routed_scaling_factor=2.5),
    attn=AttnConfig(layer_pattern=tuple(KINDS[c] for c in PATTERN), rope_theta=0.0),
    ssm=SSMConfig(state_dim=128, conv_dim=4, mamba2_heads=64, mamba2_head_dim=64, n_groups=8,
                  chunk_size=128),
)
