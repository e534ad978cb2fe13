"""Runtime half of the sanitizer: prove what the static checks promise.

Counterpart of ``repro.analysis.runtime``. The planner says fig08/fig16
are ONE compile group each; the static checks say nothing in the
captured graph can silently split a group. The runtime watcher closes
the loop: the executor names every group runner
``famsim_group__<key digest>`` before it runs, the runner reports each
CUDA graph capture under its name at the capture site
(``repro_torch.core.famsim._capture`` calls :func:`report_capture`), and
:class:`CompileWatcher` counts the captures of that name prefix during
``execute`` — so *actual captures of group runners* can be asserted
equal to the planner's accounting (``execute(plan,
assert_compiles=True)``; the count lands in ``RunInfo.xla_compiles``, the
reference's name, and in each ``info.groups`` row). Counting by name
filters out captures made elsewhere (a runner built outside the
executor, the cross-checks' runners), which are not group runs.

:func:`no_implicit_transfers` wraps the hot loop in
``torch.cuda.set_sync_debug_mode("error")``: any operation that makes
the host wait for the device (``.item()``, ``.cpu()``, ``nonzero``, a
blocking host->device copy, a stream synchronize) raises. The executor's
own fetch of results and the runner's synchronize after its replays are
explicit by design, the counterpart of the reference's
``jax.device_get`` after ``block_until_ready``, and run inside
:func:`explicit_fetch`, which lifts the guard for its block. Honesty
note: on a machine without CUDA (this repo's CPU tests) there is no
device to wait for and the guard is a no-op, as the reference's transfer
guard is on its CPU backend; it bites on the card. The *load-bearing*
CPU check is the capture count (zero there, equal to the executor's).
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

import torch

#: the name PREFIX the executor gives every group runner before it runs
#: (suffixed ``__<runner-cache-key digest>`` per group)
GROUP_RUNNER_NAME = "famsim_group"

#: the watchers inside their ``with`` block, innermost last
_ACTIVE: List["CompileWatcher"] = []


def report_capture(name: Optional[str]) -> None:
    """Record one CUDA graph capture of the runner called ``name`` with
    every active watcher (the capture site calls this once a capture;
    ``None``: a runner that stands for no group)."""
    if name is None:
        return
    for watcher in _ACTIVE:
        watcher._record(name)


class CompileWatcher:
    """Count CUDA graph captures of the named group runners while active.

    Context manager; ``watcher.count`` is live during and after the
    block. A capture counts when its runner's name is ``name`` or starts
    with ``name + "__"``.
    """

    def __init__(self, name: str = GROUP_RUNNER_NAME):
        self.name = name
        self.count = 0
        self._by_name: Dict[str, int] = {}

    @property
    def by_name(self) -> Dict[str, int]:
        """Capture counts keyed by the runner's full name
        (``famsim_group__<digest>``): per-group attribution for the
        executor's ``info.groups`` rows."""
        return dict(self._by_name)

    def _record(self, name: str) -> None:
        if name == self.name or name.startswith(self.name + "__"):
            self.count += 1
            self._by_name[name] = self._by_name.get(name, 0) + 1

    def __enter__(self) -> "CompileWatcher":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)


#: ``torch.cuda.set_sync_debug_mode``'s names of its modes
_MODES = {"default": 0, "warn": 1, "error": 2}


@contextmanager
def _sync_debug_mode(mode: str) -> Iterator[None]:
    """``mode`` for the block, the previous one restored after it; nothing
    is set where the mode is already ``mode`` (outside the guard,
    :func:`explicit_fetch` leaves torch's settings alone)."""
    if not torch.cuda.is_available() or torch.cuda.get_sync_debug_mode() == _MODES[mode]:
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def no_implicit_transfers():
    """Make every host sync with the card raise for the enclosed block
    (``torch.cuda.set_sync_debug_mode("error")``, the previous mode
    restored after it); :func:`explicit_fetch` lifts it where the sync is
    meant. A no-op without CUDA; see the module docstring."""
    return _sync_debug_mode("error")


def explicit_fetch():
    """Allow host syncs for the enclosed block inside
    :func:`no_implicit_transfers`: the executor's fetch of results and
    the runner's synchronize after its replays (the reference's explicit
    ``jax.device_get`` after ``block_until_ready``)."""
    return _sync_debug_mode("default")
