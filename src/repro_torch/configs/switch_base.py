"""Switch Transformer base family — the paper's own models.

[arXiv:2101.03961 / Fedus et al. 2022] T5-base backbone: 12 layers,
d_model 768, 12 heads, d_ff 3072, vocab 32128, MoE every other layer,
top-1 routing, E ∈ {8, 64, 128, 256}. These are the models SiDA-MoE
evaluates (Table 2, Figs 2-4, 8-11). We model the decoder-only analogue
(the paper's measurements are agnostic to enc-dec vs dec-only — what
matters is the MoE layer structure and expert count).
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig, register


def _switch(num_experts: int) -> ModelConfig:
    return register(
        ModelConfig(
            name=f"switch-base-{num_experts}",
            family="moe",
            citation="arXiv:2101.03961",
            n_layers=12,
            d_model=768,
            n_heads=12,
            n_kv_heads=12,
            d_ff=3072,
            vocab_size=32128,
            act="gelu",
            glu=False,
            tie_embeddings=True,
            attn=AttnConfig(rope_theta=10000.0),
            moe=MoEConfig(
                num_experts=num_experts,
                top_k=1,
                d_expert=3072,
                moe_every=2,  # MoE on every other layer, as in Switch
                capacity_factor=1.25,
            ),
        )
    )


SWITCH_BASE_8 = _switch(8)
SWITCH_BASE_64 = _switch(64)
SWITCH_BASE_128 = _switch(128)
SWITCH_BASE_256 = _switch(256)
