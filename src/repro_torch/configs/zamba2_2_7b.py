"""zamba2-2.7b — hybrid Mamba2 backbone + SHARED attention block. [arXiv:2411.15242; hf]

Sub-quadratic: long_500k runs for this arch. The shared attention block (one
set of weights, applied every `attn_every` layers) makes the layer scan
weight-invariant for the attention part — see models/zamba.py.

Copy of ``repro.configs.zamba2_2_7b``.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,           # shared block is MHA
    head_dim=80,
    d_ff=10240,
    vocab_size=32000,
    activation="geglu",
    norm="rmsnorm",
    position="rope",
    rope_theta=10_000.0,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, n_groups=1, chunk=128),
    attn_every=6,              # shared attention applied every 6th layer
    run_long_context=True,     # hybrid/SSM -> long_500k runs
    source="arXiv:2411.15242; hf:Zyphra/Zamba2-2.7B",
)
