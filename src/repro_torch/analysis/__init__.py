"""Capture-safety & compile-key hygiene analyzer (static + runtime).

Counterpart of ``repro.analysis``, over the PyTorch port. The port's
performance rests on the same invariant as the reference's: *policy
choice and geometry-free shapes are static runner-key inputs; everything
else — ``FamParams`` leaves, policy numeric params, the effective cache
geometry — stays tensor data.* fig08/fig16 collapse to ONE captured CUDA
graph each only because that separation holds; a Python ``if`` on a
tensor, an ``.item()`` or ``.cpu()`` in the step, or a new field landing
on the wrong side of the runner key silently multiplies captures or drags
host syncs into the replayed window (where a capture fails outright).

``repro_torch.analysis`` enforces it two ways:

* **statically** — an AST analyzer (``python -m repro_torch.analysis
  [paths] --strict``, default the port's tree) with the reference's four
  check families (see :mod:`.checks`), each also catching torch's
  spellings:

  - ``CK1xx`` compile-key purity (traced fields / unhashables flowing
    into ``point_key`` / ``compile_tags`` / cache keys),
  - ``TC2xx`` tensor-unsafe Python control flow inside the captured call
    graph (:mod:`.scopes` defines the graph),
  - ``HS3xx`` host syncs / transfers of device tensors (``.item()``,
    ``.cpu()``, ``.numpy()``, ``nonzero``, boolean-mask indexing,
    ``synchronize``),
  - ``DT4xx`` determinism lints on trace/plan construction (torch's
    global generator included);

* **at runtime** — :mod:`.runtime` provides the ``CompileWatcher`` the
  executor uses to assert *actual CUDA graph captures == planned compile
  groups* per figure (``execute(plan, assert_compiles=True)``), and the
  sync guard ``no_implicit_transfers`` (``torch.cuda.set_sync_debug_mode
  ("error")``) around the hot loop, lifted only by the executor's
  explicit fetch (``explicit_fetch``).

The static-vs-traced field registry is **introspected, not
hand-written**: :mod:`.registry` reads the port's ``FamParams._fields`` /
``FamConfig`` / ``PolicySet``. Legitimate exceptions live in
``allowlist.toml`` next to this file — every entry carries a mandatory
``reason``.
"""
from __future__ import annotations

from repro_torch.analysis.checks import analyze_source
from repro_torch.analysis.cli import analyze_paths, main, run_analysis
from repro_torch.analysis.findings import Allowlist, Finding, load_allowlist
from repro_torch.analysis.registry import Registry, build_registry

__all__ = [
    "Allowlist", "Finding", "Registry", "analyze_paths", "analyze_source",
    "build_registry", "load_allowlist", "main", "run_analysis",
]
