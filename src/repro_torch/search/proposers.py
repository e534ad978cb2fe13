"""Search proposers: ask/tell strategies over a :class:`SearchSpace`.

Counterpart of ``repro.search.proposers`` (plain numpy: the same proposals
and states as the reference for the same seed and fitnesses). Proposers
are plain classes registered by name (:func:`register_proposer` /
:func:`get_proposer` / :func:`available`) and constructed by the loop as
``cls(space, rng, population, **opts)`` with a seeded
``numpy.random.Generator``, never global random state: the loop owns the
generator and writes ``rng.bit_generator.state`` into the trajectory
after every generation, so a resumed search continues the exact stream.

The ask/tell contract (:class:`Proposer`):

* :meth:`ask` returns this generation's candidate samples (a list of
  ``{dim name: value}`` dicts);
* :meth:`round_T` scales the evaluation budget — the trace length the
  loop runs this generation at (successive halving screens wide at short
  T and promotes survivors to full T; everything else returns ``T``);
* :meth:`tell` feeds back the *penalized* fitnesses (objective minus the
  loop's penalty per cold runner key, see :mod:`repro_torch.search.loop`:
  a proposer maximizing fitness learns to stay inside warm groups);
* :meth:`state` / :meth:`load_state` round-trip the proposer's own state
  (populations, rung counters) as JSON-able dicts for an exact resume.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Protocol, Tuple, runtime_checkable

from repro_torch.search.space import SearchSpace

Sample = Dict[str, Any]


@runtime_checkable
class Proposer(Protocol):
    """The ask/tell surface every proposer implements."""

    name: str

    def ask(self) -> List[Sample]:
        ...

    def round_T(self, T: int) -> int:
        ...

    def tell(self, samples: List[Sample],
             fitnesses: List[float]) -> None:
        ...

    def state(self) -> dict:
        ...

    def load_state(self, state: dict) -> None:
        ...


_REGISTRY: Dict[str, type] = {}


def register_proposer(cls):
    """Register a proposer class under ``cls.name`` (decorator-friendly)."""
    _REGISTRY[cls.name] = cls
    return cls


def get_proposer(name: str) -> type:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"no proposer named {name!r}; available: "
                       f"{available()}") from None


def available() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _ranked(samples: List[Sample], fitnesses: List[float]) -> List[int]:
    """Indices sorted best-first with a deterministic index tie-break."""
    return sorted(range(len(samples)),
                  key=lambda i: (-fitnesses[i], i))


# ---------------------------------------------------------------------------
# random — the independent-draws baseline
# ---------------------------------------------------------------------------

@register_proposer
class RandomProposer:
    """Independent uniform draws every generation (the ArchGym-style
    random-walker baseline every tuned proposer must beat)."""

    name = "random"

    def __init__(self, space: SearchSpace, rng, population: int, **_):
        self.space = space
        self.rng = rng
        self.population = population

    def ask(self) -> List[Sample]:
        return [self.space.sample(self.rng) for _ in range(self.population)]

    def round_T(self, T: int) -> int:
        return T

    def tell(self, samples, fitnesses) -> None:
        pass                               # memoryless by design

    def state(self) -> dict:
        return {}

    def load_state(self, state: dict) -> None:
        pass


# ---------------------------------------------------------------------------
# evolutionary — mu+lambda GA with elitism and capture-aware mutation
# ---------------------------------------------------------------------------

@register_proposer
class EvolutionaryProposer:
    """(mu + lambda) evolution: tournament selection, uniform crossover,
    per-dimension mutation, elitism over the merged parent+child pool.

    Mutation is *capture-cost aware*: static dimensions (moves that
    change the runner key — ``SearchSpace.split``) mutate at
    ``static_mutation`` (default 4x rarer than ``mutation``), so after the
    first generation most proposals keep their static coordinates and land
    in warm groups. The penalized fitness the loop feeds back reinforces the same
    pressure.
    """

    name = "evolutionary"

    def __init__(self, space: SearchSpace, rng, population: int, *,
                 elite: int = 2, tournament: int = 2,
                 mutation: float = 0.4, static_mutation: float = 0.1,
                 mutation_scale: float = 0.2, **_):
        self.space = space
        self.rng = rng
        self.population = population
        self.elite = min(elite, population)
        self.tournament = tournament
        self.mutation = mutation
        self.static_mutation = static_mutation
        self.mutation_scale = mutation_scale
        self._static = set(space.split()[0])
        self.parents: List[Tuple[Sample, float]] = []

    def ask(self) -> List[Sample]:
        if not self.parents:
            return [self.space.sample(self.rng)
                    for _ in range(self.population)]
        out = [dict(self.parents[i][0])
               for i in range(min(self.elite, len(self.parents)))]
        while len(out) < self.population:
            a = self._select()
            b = self._select()
            out.append(self._mutate(self._crossover(a, b)))
        return out

    def _select(self) -> Sample:
        best: Optional[Tuple[Sample, float]] = None
        for _ in range(self.tournament):
            pick = self.parents[int(self.rng.integers(len(self.parents)))]
            if best is None or pick[1] > best[1]:
                best = pick
        return best[0]

    def _crossover(self, a: Sample, b: Sample) -> Sample:
        return {d.name: (a if self.rng.random() < 0.5 else b)[d.name]
                for d in self.space.dimensions}

    def _mutate(self, s: Sample) -> Sample:
        out = dict(s)
        for d in self.space.dimensions:
            p = self.static_mutation if d.name in self._static \
                else self.mutation
            if self.rng.random() < p:
                out[d.name] = d.mutate(out[d.name], self.rng,
                                       self.mutation_scale)
        return out

    def round_T(self, T: int) -> int:
        return T

    def tell(self, samples, fitnesses) -> None:
        pool = self.parents + list(zip([dict(s) for s in samples],
                                       [float(f) for f in fitnesses]))
        pool.sort(key=lambda sf: -sf[1])
        self.parents = pool[:self.population]

    def state(self) -> dict:
        return {"parents": [[s, f] for s, f in self.parents]}

    def load_state(self, state: dict) -> None:
        self.parents = [(dict(s), float(f))
                        for s, f in state.get("parents", [])]


# ---------------------------------------------------------------------------
# halving — successive halving over the T axis
# ---------------------------------------------------------------------------

@register_proposer
class HalvingProposer:
    """Successive halving over the evaluation budget (the T axis).

    Rung ``r`` of ``R`` evaluates ``population * eta^(R-1-r)`` candidates
    at ``T / eta^(R-1-r)`` events (clamped to ``min_T``), then promotes
    the top ``1/eta`` fraction to the next rung. The wide early rungs
    plan into their own (short-T-bucket) compile groups — that screening
    capture is the hyperband trade the cost model charges for — while
    every later rung at the same T shares its predecessor's bucket.
    After the last rung, :meth:`ask` restarts at rung 0 with fresh random
    draws seeded by the survivors (so a generations count beyond ``R``
    keeps searching instead of repeating the final rung).
    """

    name = "halving"

    def __init__(self, space: SearchSpace, rng, population: int, *,
                 rungs: int = 3, eta: int = 2, min_T: int = 1024, **_):
        self.space = space
        self.rng = rng
        self.population = population
        self.rungs = rungs
        self.eta = eta
        self.min_T = min_T
        self.rung = 0
        self.survivors: List[Sample] = []

    def _width(self, rung: int) -> int:
        return self.population * self.eta ** (self.rungs - 1 - rung)

    def ask(self) -> List[Sample]:
        if self.rung == 0 or not self.survivors:
            base = self.survivors[:max(len(self.survivors) // 2, 1)] \
                if self.survivors else []
            fresh = [self.space.sample(self.rng)
                     for _ in range(self._width(0) - len(base))]
            return [dict(s) for s in base] + fresh
        return [dict(s) for s in self.survivors]

    def round_T(self, T: int) -> int:
        scale = self.eta ** (self.rungs - 1 - self.rung)
        return max(T // scale, min(self.min_T, T))

    def tell(self, samples, fitnesses) -> None:
        ranked = _ranked(list(samples), list(fitnesses))
        if self.rung + 1 < self.rungs:
            keep = max(self._width(self.rung + 1), 1)
            self.survivors = [dict(samples[i]) for i in ranked[:keep]]
            self.rung += 1
        else:                              # final rung: restart the bracket
            keep = max(math.ceil(len(samples) / self.eta), 1)
            self.survivors = [dict(samples[i]) for i in ranked[:keep]]
            self.rung = 0

    def state(self) -> dict:
        return {"rung": self.rung, "survivors": self.survivors}

    def load_state(self, state: dict) -> None:
        self.rung = int(state.get("rung", 0))
        self.survivors = [dict(s) for s in state.get("survivors", [])]
