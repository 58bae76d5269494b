"""deepseek-moe-16b [moe] — fine-grained experts, 2 shared + 64 routed top-6.

[arXiv:2401.06066] 28L, d_model 2048, 16 heads (MHA kv=16), expert d_ff 1408,
vocab 102400, 64 routed experts top-6 plus 2 shared (always-active) experts.
Shared experts are never offloaded by SiDA (always resident); the hash
function predicts routed experts only.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig, register

CONFIG = register(
    ModelConfig(
        name="deepseek-moe-16b",
        family="moe",
        citation="arXiv:2401.06066",
        n_layers=28,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=0,  # pure-MoE FFN (shared experts provide the dense path)
        vocab_size=102400,
        tie_embeddings=False,
        attn=AttnConfig(rope_theta=10000.0),
        moe=MoEConfig(
            num_experts=64,
            top_k=6,
            d_expert=1408,
            num_shared_experts=2,
            d_shared=1408,
            router_aux_coef=0.001,
        ),
    )
)
