"""seamless-m4t-medium [audio] — encoder-decoder, multimodal.

[arXiv:2308.11596] 12 encoder + 12 decoder layers, d_model 1024, 16 heads
(MHA, kv=16), d_ff 4096, vocab 256206. The audio frontend (mel-spectrogram +
conv feature extractor) is STUBBED per the spec carve-out: `input_specs()`
provides precomputed frame embeddings [batch, frames, d_model]; we implement
the transformer encoder + autoregressive text decoder with cross-attention.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="seamless-m4t-medium",
        family="audio",
        citation="arXiv:2308.11596",
        n_layers=12,
        n_enc_layers=12,
        enc_dec=True,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=4096,
        vocab_size=256206,
        act="gelu",
        glu=False,
        tie_embeddings=True,
        modality="audio",
        attn=AttnConfig(rope_theta=10000.0),
    )
)
