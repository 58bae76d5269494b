"""smollm-135m [dense] — llama-arch small model.

[hf:HuggingFaceTB/SmolLM-135M] 30L, d_model 576, 9 heads (GQA kv=3),
d_ff 1536, vocab 49152, tied embeddings.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="smollm-135m",
        family="dense",
        citation="hf:HuggingFaceTB/SmolLM-135M",
        n_layers=30,
        d_model=576,
        n_heads=9,
        n_kv_heads=3,
        d_ff=1536,
        vocab_size=49152,
        tie_embeddings=True,
        attn=AttnConfig(rope_theta=10000.0),
    )
)
