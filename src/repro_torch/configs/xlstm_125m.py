"""xlstm-125m [ssm] — sLSTM + mLSTM recurrent blocks, attention-free.

[arXiv:2405.04517] 12 blocks, d_model 768, 4 heads, vocab 50304, d_ff 0
(blocks carry their own up/down projections). Pattern alternates mLSTM
(matrix-memory, parallelisable) and sLSTM (scalar-memory, strictly
recurrent) as in the paper's 1:1 configs. O(1)-state decode => long_500k.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(
    ModelConfig(
        name="xlstm-125m",
        family="ssm",
        citation="arXiv:2405.04517",
        n_layers=12,
        d_model=768,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        block_kind="xlstm",
        tie_embeddings=True,
        ssm=SSMConfig(xlstm_pattern=("m", "s"), xlstm_heads=4),
    )
)
