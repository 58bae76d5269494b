"""chameleon-34b [vlm] — early-fusion; images are VQ tokens in the vocab.

[arXiv:2405.09818] 48L, d_model 8192, 64 heads (GQA kv=8), d_ff 22016,
vocab 65536 (text + VQ image codes), qk-norm for stability. Early fusion
means the "vision frontend" is a VQ tokenizer producing ordinary token ids;
per the spec carve-out, `input_specs()` provides pre-tokenised mixed
text+image id sequences (the backbone is what we implement).
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="chameleon-34b",
        family="vlm",
        citation="arXiv:2405.09818",
        n_layers=48,
        d_model=8192,
        n_heads=64,
        n_kv_heads=8,
        d_ff=22016,
        vocab_size=65536,
        tie_embeddings=False,
        modality="vision",
        attn=AttnConfig(qk_norm=True, rope_theta=10000.0),
    )
)
