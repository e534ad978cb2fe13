"""repro_torch.search — design-space search over the batched simulator.

Counterpart of ``repro.search``:

* :mod:`repro_torch.search.space` — declarative :class:`SearchSpace` of
  typed dimensions mapping sample vectors onto Experiment grid cells,
  split into static (a new runner key, a capture) and traced (free) moves;
* :mod:`repro_torch.search.proposers` — the ask/tell :class:`Proposer`
  registry (``random`` / ``evolutionary`` / ``halving``);
* :mod:`repro_torch.search.loop` — the driver batching each generation
  into one Experiment, with a capture-cost-penalized fitness;
* :mod:`repro_torch.search.objectives` — the objective registry (default:
  the fig14 mix-IPC objective; :mod:`repro_torch.tenants.search`
  registers the ``pond_tail`` fleet objective);
* :mod:`repro_torch.search.trajectory` — the deterministic JSONL
  trajectory and the ``best.json`` reproducible-winner record.

Driver: :mod:`repro_torch.benchmarks.fig_search` (``python -m
repro_torch.benchmarks.run search``).
"""
from repro_torch.search.loop import (  # noqa: F401
    best_experiment,
    candidate_objective,
    derived_string,
    generation_experiment,
    replay_best,
    run_search,
)
from repro_torch.search.objectives import (  # noqa: F401
    MixObjective,
    Objective,
    available_objectives,
    get_objective,
    register_objective,
)
from repro_torch.search.proposers import (  # noqa: F401
    EvolutionaryProposer,
    HalvingProposer,
    Proposer,
    RandomProposer,
    available,
    get_proposer,
    register_proposer,
)
from repro_torch.search.space import (  # noqa: F401
    Dimension,
    SearchSpace,
    categorical,
    cfg_field,
    continuous,
    flag,
    integer,
    log_continuous,
    policy_choice,
    policy_param,
)
from repro_torch.search.trajectory import (  # noqa: F401
    TrajectoryWriter,
    canonical_json,
    load_best,
    read_trajectory,
    resume_state,
    split_records,
    write_best,
)
