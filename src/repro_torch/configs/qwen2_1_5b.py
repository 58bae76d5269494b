"""qwen2-1.5b [dense] — GQA with QKV bias.

[arXiv:2407.10671] 28L, d_model 1536, 12 heads (GQA kv=2), d_ff 8960,
vocab 151936, qkv bias, tied embeddings.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-1.5b",
        family="dense",
        citation="arXiv:2407.10671",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab_size=151936,
        tie_embeddings=True,
        attn=AttnConfig(qkv_bias=True, rope_theta=1000000.0),
    )
)
