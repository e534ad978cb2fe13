"""arctic-480b — MoE 128 experts top-2 + dense residual. [hf:Snowflake/snowflake-arctic-base]

Copy of ``repro.configs.arctic_480b``: the 469B-parameter class model of the
pooled-memory offload demo (optimizer state and inactive expert slabs in
the pooled-memory tier). One card runs it only at reduced widths
(``arctic-480b-smoke``).
"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    activation="swiglu",
    norm="rmsnorm",
    position="rope",
    rope_theta=10_000.0,
    moe=MoEConfig(num_experts=128, top_k=2, d_ff=4864,
                  dense_residual=True, dense_d_ff=4864),
    run_long_context=False,
    source="hf:Snowflake/snowflake-arctic-base",
)
