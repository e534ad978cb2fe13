"""qwen2-vl-72b — dense GQA VLM backbone with M-RoPE. [arXiv:2409.12191; hf]

Backbone only per assignment: the vision frontend is a STUB — input_specs()
provides token ids plus 3-D (t,h,w) M-RoPE position ids (and precomputed patch
embeddings are folded into the token stream upstream).

Copy of ``repro.configs.qwen2_vl_72b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=29568,
    vocab_size=152064,
    activation="swiglu",
    norm="rmsnorm",
    position="mrope",
    mrope_sections=(16, 24, 24),   # sums to head_dim//2 = 64
    rope_theta=1_000_000.0,
    run_long_context=False,
    source="arXiv:2409.12191; hf:Qwen/Qwen2-VL-72B",
)
