"""granite-3-2b — dense GQA. [hf:ibm-granite/granite-3.0-2b-base]

Copy of ``repro.configs.granite_3_2b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-3-2b",
    family="dense",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=49155,
    activation="swiglu",
    norm="rmsnorm",
    position="rope",
    rope_theta=10_000.0,
    tie_embeddings=True,
    run_long_context=False,
    source="hf:ibm-granite/granite-3.0-2b-base",
)
