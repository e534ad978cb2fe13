"""Workload traces for the port: copies of the JAX package's spec table and
numpy generators (``repro.traces.specs`` / ``repro.traces.host``), the
threefry device generator (``repro.traces.device``) and the backend
dispatch (``repro.traces.backend``)."""
from repro_torch.traces.backend import (  # noqa: F401
    BACKEND_NAMES,
    DEFAULT_BACKEND,
    DeviceBackend,
    NumpyBackend,
    get_backend,
    system_traces,
    validate_backend,
)
from repro_torch.traces.host import generate  # noqa: F401
from repro_torch.traces.specs import (  # noqa: F401
    LINE,
    PATTERN_IDS,
    WORKLOAD_NAMES,
    WORKLOADS,
    WorkloadSpec,
    footprint_bytes,
    node_seed,
    trace_seed,
)
