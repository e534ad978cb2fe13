"""Workload traces for the port: copies of the JAX package's numpy
generators (``repro.traces.specs`` / ``repro.traces.host``)."""
from repro_torch.traces.host import generate, system_traces  # noqa: F401
from repro_torch.traces.specs import (  # noqa: F401
    LINE,
    WORKLOAD_NAMES,
    WORKLOADS,
    WorkloadSpec,
    footprint_bytes,
    node_seed,
    trace_seed,
)
