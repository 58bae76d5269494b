"""qwen3-moe-235b-a22b [moe] — 128 routed experts, top-8, fine-grained FFN.

[hf:Qwen/Qwen3-30B-A3B family scaled per assignment] 94L, d_model 4096,
64 heads (GQA kv=4), head_dim 128, expert d_ff 1536, vocab 151936,
MoE 128 experts top-8 on every layer, qk-norm, no qkv bias.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        citation="hf:Qwen/Qwen3-30B-A3B",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        head_dim=128,
        d_ff=0,  # pure-MoE FFN: every layer routed
        vocab_size=151936,
        tie_embeddings=False,
        attn=AttnConfig(qk_norm=True, rope_theta=1000000.0),
        moe=MoEConfig(
            num_experts=128,
            top_k=8,
            d_expert=1536,
            router_aux_coef=0.001,
        ),
    )
)
