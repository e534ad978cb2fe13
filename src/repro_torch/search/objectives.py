"""Pluggable search objectives — what one generation builds and scores.

Counterpart of ``repro.search.objectives``.
:func:`repro_torch.search.loop.run_search` delegates two things per
generation to an objective object:

* **build** — turn the proposer's samples into ONE Experiment (the
  candidate ``grid_axis`` crossed with whatever scenario axis the
  objective measures on);
* **score** — reduce one candidate's rows of the executed result to a
  ``(per_key, objective)`` pair (higher is better; the per-key dict is
  what ``derived_string`` serializes into the replay contract).

The default :class:`MixObjective` is the original fig14 figure of merit
(geomean-over-mixes IPC uplift vs the embedded baseline row); its
trajectory header carries no objective name, as before objectives
existed. Alternative scenarios register here by name —
:mod:`repro_torch.tenants.search` registers ``pond_tail`` (per-tenant p99
tail-latency uplift with an SLO-violation penalty over a multi-tenant
fleet), which :func:`get_objective` imports on first lookup, so the
registry stays dependency-light.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

from repro_torch.configs.base import FamConfig
from repro_torch.experiments import Experiment
from repro_torch.search.space import SearchSpace


class Objective:
    """Interface contract (duck-typed; subclassing is optional).

    ``name`` is the registry/trajectory identifier; ``header_mixes()``
    is what the trajectory header's ``"mixes"`` slot records (the
    resume-compatibility fingerprint of the evaluation scenario);
    ``build``/``score`` are the two per-generation hooks described in
    the module docstring."""

    name = "abstract"

    def header_mixes(self) -> Any:
        raise NotImplementedError

    def build(self, space: SearchSpace, samples: Sequence[Mapping],
              labels: Sequence[str], *, base: FamConfig, T: int,
              seed: int, trace_backend: str, name: str) -> Experiment:
        raise NotImplementedError

    def score(self, result, label: str
              ) -> Tuple[Dict[str, float], float]:
        raise NotImplementedError


class MixObjective(Objective):
    """The original workload-mix IPC objective (fig14's figure of
    merit), expressed through the objective interface. Delegates to the
    loop's :func:`~repro_torch.search.loop.generation_experiment` /
    :func:`~repro_torch.search.loop.candidate_objective` so the grid shape,
    baseline row, and scoring stay byte-identical to pre-objective
    searches."""

    name = "fig14_ipc"

    def __init__(self, mixes: Mapping[str, Sequence[str]]):
        if not mixes:
            raise ValueError("MixObjective needs at least one mix")
        self.mixes = {k: tuple(v) for k, v in mixes.items()}

    def header_mixes(self) -> Dict[str, list]:
        return {k: list(v) for k, v in self.mixes.items()}

    def build(self, space, samples, labels, *, base, T, seed,
              trace_backend, name):
        from repro_torch.search.loop import generation_experiment
        return generation_experiment(space, samples, labels, self.mixes,
                                     base=base, T=T, seed=seed,
                                     trace_backend=trace_backend,
                                     name=name)

    def score(self, result, label):
        from repro_torch.search.loop import candidate_objective
        return candidate_objective(result, label, self.mixes)


# -- registry ---------------------------------------------------------------

_REGISTRY: Dict[str, Callable[..., Objective]] = {}


def register_objective(name: str, factory: Callable[..., Objective]
                       ) -> None:
    if name in _REGISTRY:
        raise ValueError(f"search objective {name!r} already registered")
    _REGISTRY[name] = factory


def available_objectives() -> list:
    return sorted(_REGISTRY)


def get_objective(name: str, **kw) -> Objective:
    """Instantiate a registered objective by name. A miss first imports
    :mod:`repro_torch.tenants.search` (which registers the fleet objectives on
    import) and retries, so ``get_objective("pond_tail")`` works without
    the caller knowing where it lives."""
    if name not in _REGISTRY:
        import repro_torch.tenants.search  # noqa: F401  (registers pond_tail)
    if name not in _REGISTRY:
        raise KeyError(f"unknown search objective {name!r} "
                       f"(available: {available_objectives()})")
    return _REGISTRY[name](**kw)


def resolve_objective(objective, mixes: Optional[Mapping[str, Sequence[str]]]
                      ) -> Objective:
    """The loop's argument-resolution shim: an explicit objective
    instance wins; a string looks up the registry; None falls back to
    the classic mix objective (which then REQUIRES ``mixes``)."""
    if objective is None:
        if mixes is None:
            raise ValueError("run_search needs either `mixes` (the "
                             "classic fig14 objective) or an explicit "
                             "`objective`")
        return MixObjective(mixes)
    if isinstance(objective, str):
        return get_objective(objective)
    return objective


register_objective(MixObjective.name, MixObjective)
