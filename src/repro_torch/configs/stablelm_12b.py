"""stablelm-12b [dense] — llama-style GQA decoder.

[hf:stabilityai/stablelm-2-1_6b family, 12b per assignment] 40L,
d_model 5120, 32 heads (GQA kv=8), d_ff 13824, vocab 100352.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="stablelm-12b",
        family="dense",
        citation="hf:stabilityai/stablelm-2-1_6b",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        d_ff=13824,
        vocab_size=100352,
        tie_embeddings=False,
        attn=AttnConfig(rope_theta=10000.0, qkv_bias=False),
    )
)
