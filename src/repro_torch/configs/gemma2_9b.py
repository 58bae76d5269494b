"""gemma2-9b [dense] — local+global alternating attention, logit softcaps.

[arXiv:2408.00118] Gemma 2 technical report. 42L, d_model 3584, 16 heads
(GQA kv=8), head_dim 256, d_ff 14336 (GeGLU), vocab 256000, sliding window
4096 on local layers, attn softcap 50, final logit softcap 30.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="gemma2-9b",
        family="dense",
        citation="arXiv:2408.00118",
        n_layers=42,
        d_model=3584,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab_size=256000,
        act="gelu",
        glu=True,
        post_norm=True,
        tie_embeddings=True,
        embed_scale=True,
        final_logit_softcap=30.0,
        attn=AttnConfig(
            logit_softcap=50.0,
            window=4096,
            layer_pattern=("local", "global"),
            rope_theta=10000.0,
        ),
    )
)
