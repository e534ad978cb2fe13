"""xlstm-350m — sLSTM + mLSTM blocks. [arXiv:2405.04517; unverified]

d_ff=0: blocks carry their own up/down projections (no separate FFN).
Fully recurrent -> long_500k runs (decode state is O(1) in sequence length).

Copy of ``repro.configs.xlstm_350m``.
"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    num_layers=24,
    d_model=1024,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    norm="layernorm",
    position="none",           # xLSTM uses no explicit positional encoding
    xlstm=XLSTMConfig(slstm_every=2, proj_factor_mlstm=2.0, chunk=128),
    run_long_context=True,
    source="arXiv:2405.04517",
)
