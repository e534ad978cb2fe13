"""Parallelism over ``torch.distributed``: meshes, collectives and
``DeviceMesh`` (:mod:`compat`), logical-axis sharding rules, the model's
parallel context and its sharded run as DTensors (:mod:`sharding`), int8
error-feedback compression (:mod:`compression`) and the GPipe loop
(:mod:`pipeline`). Counterpart of ``repro.parallel``, with its exports
and :func:`shard_params` / :func:`device_mesh`."""
from repro_torch.parallel.compat import device_mesh  # noqa: F401
from repro_torch.parallel.sharding import (  # noqa: F401
    DEFAULT_RULES,
    ParallelContext,
    param_shardings,
    param_specs,
    shard_params,
    single_device_context,
)
