"""hymba-1.5b [hybrid] — parallel attention + mamba heads per layer.

[arXiv:2411.13676] 32L, d_model 1600, 25 attn heads (GQA kv=5),
d_ff 5504, vocab 32001, ssm_state 16. Hymba fuses an attention branch and
a Mamba branch *in parallel* inside each block (outputs mean-fused after
per-branch normalisation); most layers use sliding-window attention, which
is what makes 500k-token decode tractable.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, SSMConfig, register

CONFIG = register(
    ModelConfig(
        name="hymba-1.5b",
        family="hybrid",
        citation="arXiv:2411.13676",
        n_layers=32,
        d_model=1600,
        n_heads=25,
        n_kv_heads=5,
        d_ff=5504,
        vocab_size=32001,
        block_kind="hymba",
        attn=AttnConfig(window=2048, layer_pattern=("local",)),
        ssm=SSMConfig(state_dim=16, conv_dim=4, expand=2),
    )
)
