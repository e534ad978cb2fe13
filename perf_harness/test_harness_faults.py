"""A run with the timed path broken underneath has to come out not
correct; the same run unbroken is correct.

Each test drives the rest of a run (set-up, the window, the check against
the plain reference) on the CPU at a small size, past the harness's look
for a card, with one fault planted in the program:

* ``state_unchanged``: the simulator's event step returns its carry
  unchanged;
* ``half_batch``: the runner leaves half of the systems out and gives them
  the mean of the rest;
* ``answer_altered``: the cache step's demand hit of one lane is flipped
  every 97th event, where it is produced.

The cells run on one card, so no exchange between cards exists to leave
out.
"""
import time

import pytest
import torch

from perf_harness.lib.runner import run_cell


def _state_unchanged(monkeypatch):
    from repro_torch.core import famsim
    make = famsim._make_step

    def broken(cfg, num_nodes, policies=None):
        step = make(cfg, num_nodes, policies)

        def unchanged(p, carry, inputs):
            return carry

        unchanged.key = step.key
        return unchanged

    monkeypatch.setattr(famsim, "_make_step", broken)


def _half_batch(monkeypatch):
    from repro_torch.core import famsim
    call = famsim.GroupRunner.__call__

    def broken(self, *args):
        out = call(self, *args)
        S = next(iter(out.values())).shape[0]
        h = (S + 1) // 2
        return {k: torch.cat([v[:h], v[:h].mean(0, keepdim=True).expand(S - h, *v.shape[1:])])
                for k, v in out.items()}

    monkeypatch.setattr(famsim.GroupRunner, "__call__", broken)


def _answer_altered(monkeypatch):
    from repro_torch.core import famsim
    step = famsim.cache_step
    calls = [0]

    def broken(cache, *args, **kw):
        cache, hit, probe_hits = step(cache, *args, **kw)
        calls[0] += 1
        if calls[0] % 97 == 0:
            hit = hit.clone()
            hit.view(-1)[0] = ~hit.view(-1)[0]
        return cache, hit, probe_hits

    monkeypatch.setattr(famsim, "cache_step", broken)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


def _run(cell):
    return run_cell(cell, 2 ** 31 + 4242, 0.01, False, "cpu", time.perf_counter())


def test_unbroken_run_is_correct(cell_name, small_cell):
    out = _run(small_cell(cell_name))
    assert out["correct"] and out["failed"] == 0
    assert list(out)[-1] == "checked"
    assert out["checked"]["max_rel_gap"] == {"value": 0.0, "limit": 0.0}
    reported = {m["name"] for m in small_cell(cell_name).end_to_end}
    assert set(out["metrics"]) == reported and "setup_s" in reported


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_makes_the_run_not_correct(cell_name, fault, small_cell, monkeypatch):
    FAULTS[fault](monkeypatch)
    out = _run(small_cell(cell_name))
    assert not out["correct"]
    assert out["failed"] > 0
    assert out["checked"]["max_rel_gap"]["value"] > out["checked"]["max_rel_gap"]["limit"]
