"""yi-9b — llama-arch dense GQA. [arXiv:2403.04652; hf]

Copy of ``repro.configs.yi_9b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="yi-9b",
    family="dense",
    num_layers=48,
    d_model=4096,
    num_heads=32,
    num_kv_heads=4,
    d_ff=11008,
    vocab_size=64000,
    activation="swiglu",
    norm="rmsnorm",
    position="rope",
    rope_theta=10_000.0,
    run_long_context=False,   # pure full attention -> long_500k skipped
    source="arXiv:2403.04652; hf:01-ai/Yi-9B",
)
