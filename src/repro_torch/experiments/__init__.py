"""The experiment API over the port's simulator: spec -> plan -> execute.

Counterpart of ``repro.experiments``:

* ``Experiment`` and the axis constructors (:mod:`.spec`) declare a paper
  figure as named axes over ``FamConfig`` overrides, ``SimFlags`` variants,
  workloads, node counts, T and seeds;
* ``plan`` / ``Plan`` (:mod:`.plan`) resolve the grid into compile groups
  keyed by ``(geometry_free_shape, policy tags, N, T_bucket)``, the cache
  padded to each group's largest geometry and the system axis to canonical
  widths (``s_bucket``);
* ``execute`` (:mod:`.executor`) runs each group as one batched simulator
  call on one device (one CUDA graph capture on the card), with traces
  from the ``device`` backend (generated on the card) or the ``numpy``
  backend (host generators, overlapped with the previous group).
"""
from repro_torch.experiments.executor import (  # noqa: F401
    ExperimentResult,
    RunInfo,
    execute,
    group_cache_keys,
    store_traces,
    trace_arrays,
)
from repro_torch.experiments.plan import (  # noqa: F401
    CompileGroup,
    CompileKey,
    Plan,
    plan_points,
    point_key,
    s_bucket,
    t_bucket,
)
from repro_torch.experiments.spec import (  # noqa: F401
    Axis,
    AxisValue,
    Experiment,
    ResolvedPoint,
    config_axis,
    flag_axis,
    grid_axis,
    mix_axis,
    nodes_axis,
    policy_axis,
    seed_axis,
    workload_axis,
)
from repro_torch.policies import DEFAULT_POLICY_SET, PolicySet  # noqa: F401
