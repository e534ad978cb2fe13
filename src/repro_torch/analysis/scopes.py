"""Which code the tensor-safety checks apply to.

Counterpart of ``repro.analysis.scopes``, over the port's tree. The
TC/HS checks only make sense *inside the captured call graph*: the
functions whose kernels a compile group's CUDA graph captures, one
window of events at a time (:class:`repro_torch.core.famsim.GroupRunner`),
and that run step by step on the CPU. That is everything reached from
``famsim._make_step`` (the phase functions, the cache / SPP / throttle /
controller code, the policy protocol methods), the carry's
initialisation and the metrics the runner reads off its buffers, the
in-graph trace generator and the fused cache step's wrapper. A host sync
there either breaks the capture or stalls every replay. Host-side
builders, planners, drivers and the runner's own replay loop
legitimately branch on Python values and move tensors between devices,
so they are *out* of scope by construction; scoping is what keeps the
analyzer at zero false positives on the real tree.

Scope is declared per file (suffix-matched) as include/exclude sets of
top-level function or ``Class.method`` names; nested functions inherit
their parent's scope (``famsim._make_step`` is in scope, therefore the
``step`` closure it returns is too). A module outside the table can
opt whole-file into a scope with a marker comment in its first lines::

    # analysis-scope: jit              (TC/HS checks apply to the file)
    # analysis-scope: deterministic    (DT checks apply to the file)

— that is how the reference's fixture corpus under
``tests/fixtures/analysis/`` is scoped, and how a future module can opt
in without touching this table.

``@host_metric`` (see :mod:`repro_torch.analysis.annotations`) is the
*opposite* marker: it declares one function inside an in-scope module as
deliberately host-side, excluding it from TC/HS.

The DT (determinism) checks run on the modules whose outputs must be
bit-reproducible across processes: trace synthesis, plan/spec
construction, the simulator core, configs, policies, search, tenants and
the benchmark drivers. ``experiments/executor.py`` is deliberately NOT
in DT scope: measuring wall-clock is its job.

Names that differ from the reference's tables:

* ``STATIC_PARAM_NAMES`` adds ``device``, ``dev``, ``gen``, ``batch``,
  ``shape``, ``T`` and ``window``: devices, generators, lane shapes and
  lengths the port's builders take as Python values where JAX closes
  over them;
* ``STATIC_ANNOTATIONS`` adds ``device`` and ``dtype`` (``torch.device``,
  ``torch.dtype``);
* ``STATIC_ATTRS`` adds ``device``, ``is_cuda``, ``layout`` (a tensor's
  static facts), and ``STATIC_METHODS`` (new) the calls that return
  them: ``size()``, ``dim()``, ``numel()``, ``element_size()``,
  ``stride()``, ``is_contiguous()``;
* ``JIT_SCOPE`` keys are the port's files: ``core/famsim.py`` also
  excludes the runner and its capture and replay helpers
  (``GroupRunner``, ``_capture``, ``_drive``, ``_window_events``,
  ``_copy_into``, ``_tree_bytes``, ``_make_run``); ``traces/device.py``
  includes the in-graph generator (``node_generator``, ``generate``,
  ``draws``, ``_sat_int32``) where the reference names
  ``node_generator`` / ``_jitted_system``; beside the fused cache step's
  dispatch wrapper (``ops.py``'s ``cache_step``) the table names the
  kernel's launching wrapper (``kernel.py``'s ``fused_cache_step``) and
  its plain version (``ref.py``), which the reference's files opt into
  with the jit marker;
* ``DT_SCOPE_SUFFIXES`` are the port's directories, its
  ``benchmarks/`` package in place of the root ``benchmarks/``.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import FrozenSet, Optional, Tuple

#: parameter names that are static by convention inside the jit scope
#: (builder arguments fixed before any capture starts)
STATIC_PARAM_NAMES: FrozenSet[str] = frozenset({
    "self", "cls", "cfg", "config", "policies", "pol_set",
    "num_nodes", "degree", "warmup_frac", "pad_sets", "pad_ways",
    "trace_gen", "trace_key",
    # the port's own: devices, generators and shapes are Python values
    "device", "dev", "gen", "batch", "shape", "T", "window",
})

#: annotations that mark a parameter static (Python-level value)
STATIC_ANNOTATIONS: FrozenSet[str] = frozenset({
    "int", "str", "bool", "float", "FamConfig", "PolicySet", "SimFlags",
    "device", "dtype",
})

#: attribute reads that yield static Python values off traced tensors
STATIC_ATTRS: FrozenSet[str] = frozenset({
    "shape", "dtype", "ndim", "size", "at",
    "device", "is_cuda", "layout",
})

#: method calls that yield static Python values off traced tensors
STATIC_METHODS: FrozenSet[str] = frozenset({
    "size", "dim", "numel", "element_size", "stride", "is_contiguous",
})


@dataclass(frozen=True)
class Scope:
    """In-jit-scope selection for one file: ``include`` limits scope to
    the named top-level symbols, ``exclude`` removes them; with neither,
    the whole file is in scope."""

    include: Optional[FrozenSet[str]] = None
    exclude: FrozenSet[str] = frozenset()

    def contains(self, symbol: str) -> bool:
        parts = set(symbol.split("."))
        if (self.exclude & parts) or symbol in self.exclude:
            return False
        if self.include is None:
            return True
        return bool(self.include & parts) or symbol in self.include


def _s(include=None, exclude=()):
    return Scope(include=frozenset(include) if include is not None else None,
                 exclude=frozenset(exclude))


#: file suffix -> jit Scope. Builders/drivers listed in ``exclude`` are
#: host-side: they run once at build/plan time or drive the replays.
JIT_SCOPE = {
    "repro_torch/core/famsim.py": _s(exclude={
        "_resolve", "build_sim", "build_sweep", "sweep", "simulate",
        "_make_run", "GroupRunner", "_capture", "_drive", "_window_events",
        "_copy_into", "_tree_bytes"}),
    "repro_torch/core/dram_cache.py": _s(),
    "repro_torch/core/spp.py": _s(exclude={"storage_bits"}),
    "repro_torch/core/throttle.py": _s(),
    "repro_torch/core/fam_controller.py": _s(),
    "repro_torch/core/prefetch_queue.py": _s(),
    # only the dyn_* per-system-geometry helpers run in the graph; the
    # classic int-typed helpers are host-side shape math
    "repro_torch/core/addresses.py": _s(include={
        "dyn_block_bits", "dyn_blocks_per_page", "dyn_split",
        "dyn_block_addr"}),
    # metric reductions: host-side by design, but kept in scope so any
    # NEW host sync must be explicitly @host_metric-annotated
    "repro_torch/core/ipc_model.py": _s(),
    "repro_torch/policies/prefetch.py": _s(exclude={"params_of"}),
    "repro_torch/policies/scheduler.py": _s(exclude={"params_of", "__init__"}),
    "repro_torch/policies/replacement.py": _s(exclude={"params_of", "__init__"}),
    "repro_torch/policies/adaptation.py": _s(exclude={"params_of"}),
    # in-graph trace generation; the host-side param builders are out
    "repro_torch/traces/device.py": _s(include={
        "node_generator", "generate", "draws", "_sat_int32"}),
    # the fused cache step: the dispatch wrapper (fused_replacement_mode is
    # build-time validation on the policy OBJECT), the kernel's launching
    # wrapper and its plain version, which the step runs on CPU tensors
    # and on the "torch" backend
    "repro_torch/kernels/famsim_step/ops.py": _s(include={"cache_step"}),
    "repro_torch/kernels/famsim_step/kernel.py": _s(include={"fused_cache_step"}),
    "repro_torch/kernels/famsim_step/ref.py": _s(),
}

#: files/dirs (suffix-matched) under the determinism lints
DT_SCOPE_SUFFIXES: Tuple[str, ...] = (
    "repro_torch/traces/", "repro_torch/core/", "repro_torch/configs/",
    "repro_torch/policies/",
    "repro_torch/experiments/plan.py", "repro_torch/experiments/spec.py",
    # the search layer's trajectory/best artifacts are byte-identity
    # contracts: seeded-Generator-only RNG, no wall clock, no set-order
    # dependence anywhere in the package
    "repro_torch/search/",
    # tenant fleets lower onto compile-keyed experiments: seed derivation,
    # admission order, and the per-tenant record schema are all
    # byte-identity contracts
    "repro_torch/tenants/",
    "repro_torch/benchmarks/",
)

#: marker comments for whole-file opt-in (first MARKER_LINES lines)
MARKER_LINES = 8
JIT_MARKER = "# analysis-scope: jit"
DT_MARKER = "# analysis-scope: deterministic"

#: decorator that opts one function OUT of TC/HS (host-side metrics)
HOST_METRIC_DECORATOR = "host_metric"


def _norm(path: str) -> str:
    return path.replace("\\", "/")


def _has_marker(source: str, marker: str) -> bool:
    head = source.splitlines()[:MARKER_LINES]
    return any(line.strip().startswith(marker) for line in head)


def jit_scope_for(path: str, source: str) -> Optional[Scope]:
    """The jit Scope for ``path`` (None: TC/HS do not apply at all)."""
    norm = _norm(path)
    for suffix, scope in JIT_SCOPE.items():
        if norm.endswith(suffix):
            return scope
    if _has_marker(source, JIT_MARKER):
        return Scope()
    return None


def in_dt_scope(path: str, source: str) -> bool:
    norm = _norm(path)
    if any(s.rstrip("/") + "/" in norm or norm.endswith(s)
           for s in DT_SCOPE_SUFFIXES):
        return True
    return _has_marker(source, DT_MARKER)


def is_host_metric(node: ast.FunctionDef) -> bool:
    """True when the function is ``@host_metric``-decorated (by name —
    the analyzer never imports the code it scans)."""
    for dec in node.decorator_list:
        target = dec.func if isinstance(dec, ast.Call) else dec
        name = target.attr if isinstance(target, ast.Attribute) else \
            getattr(target, "id", None)
        if name == HOST_METRIC_DECORATOR:
            return True
    return False
