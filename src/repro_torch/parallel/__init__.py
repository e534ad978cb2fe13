"""Parallelism over ``torch.distributed``: meshes and collectives
(:mod:`compat`), logical-axis sharding rules and the model's parallel
context (:mod:`sharding`), int8 error-feedback compression
(:mod:`compression`) and the GPipe loop (:mod:`pipeline`). Counterpart of
``repro.parallel``, with its exports."""
from repro_torch.parallel.sharding import (  # noqa: F401
    DEFAULT_RULES,
    ParallelContext,
    param_shardings,
    param_specs,
    single_device_context,
)
