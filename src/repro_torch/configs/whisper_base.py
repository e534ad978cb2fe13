"""whisper-base — encoder-decoder audio backbone. [arXiv:2212.04356; unverified]

Backbone only per assignment: the conv frontend is a STUB — input_specs()
provides precomputed frame embeddings (1500 frames, the 30 s window) for the
encoder; decoder shapes follow the assigned grid. Decoder exists -> decode
shapes run; long_500k skipped (full attention).

Copy of ``repro.configs.whisper_base``.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    num_layers=6,              # decoder layers
    encoder_layers=6,
    encoder_seq=1500,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,
    activation="gelu",
    norm="layernorm",
    position="learned",
    tie_embeddings=True,
    run_long_context=False,
    source="arXiv:2212.04356; hf:openai/whisper-base",
)
