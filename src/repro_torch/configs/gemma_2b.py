"""gemma-2b — GeGLU, head_dim=256, MQA (kv=1). [arXiv:2403.08295; hf]

Copy of ``repro.configs.gemma_2b``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    activation="geglu",
    norm="rmsnorm",
    position="rope",
    rope_theta=10_000.0,
    tie_embeddings=True,
    embedding_scale=True,     # gemma scales embeddings by sqrt(d_model)
    run_long_context=False,
    source="arXiv:2403.08295; hf:google/gemma-2b",
)
