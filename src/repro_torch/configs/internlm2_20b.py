"""internlm2-20b — dense GQA. [arXiv:2403.17297; hf]

Copy of ``repro.configs.internlm2_20b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internlm2-20b",
    family="dense",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92544,
    activation="swiglu",
    norm="rmsnorm",
    position="rope",
    rope_theta=1_000_000.0,
    run_long_context=False,
    source="arXiv:2403.17297; hf:internlm/internlm2-20b",
)
