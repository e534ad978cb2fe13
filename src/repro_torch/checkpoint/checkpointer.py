"""Checkpointing with async save and a preemption hook.

Counterpart of ``repro.checkpoint.checkpointer``, with the same on-disk
layout::

    <dir>/step_<N>/
        manifest.json   - flattened keys, shapes, dtypes, step metadata
        arrays.npz      - one entry per leaf, on the host

written into ``.tmp_step_<N>`` and published by an atomic rename; only the
``keep`` newest steps stay. The keys are the port's own: the state's dict
path joined by ``/``, an ``nn.Module`` contributing its parameter names
(``params/layers.0.attn.wq``, ``opt/mu/layers.0.attn.wq/q``,
``opt/step``). The reference's keys join its stacked tree paths instead;
:func:`repro_torch.train.steps.train_state_from_numpy` reads those.

``save(..., blocking=False)`` copies every leaf to the host before it
returns (the training loop blocks for that copy only: the next step may
then write the parameters in place) and writes the files on a writer
thread. ``restore(step, template, device)`` loads a step into a state
shaped like ``template``: a tensor of the template already on ``device``
is filled in place, any other becomes a new tensor there.
``install_preemption_hook`` checkpoints on SIGTERM.
"""
from __future__ import annotations

import json
import shutil
import signal
import threading
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn


def _flatten(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, nn.Module):
        items = tree.named_parameters()
    else:
        items = tree.items()
    flat = {}
    for key, val in items:
        flat.update(_flatten(val, f"{prefix}/{key}" if prefix else str(key)))
    return flat


def _load_like(template, flat: Dict[str, np.ndarray], device, prefix: str = ""):
    if isinstance(template, torch.Tensor):
        if prefix not in flat:
            raise KeyError(f"checkpoint missing leaf {prefix}")
        arr = torch.from_numpy(np.asarray(flat[prefix]))
        if tuple(arr.shape) != tuple(template.shape):
            raise ValueError(f"{prefix}: shape {tuple(arr.shape)}, expected "
                             f"{tuple(template.shape)}")
        dev = template.device if device is None else torch.device(device)
        if template.device == dev:
            with torch.no_grad():
                template.copy_(arr)
            return template
        return arr.to(dev, template.dtype)
    if isinstance(template, nn.Module):
        if device is not None:
            template.to(device)
        for name, p in template.named_parameters():
            _load_like(p, flat, None, f"{prefix}/{name}" if prefix else name)
        return template
    return {k: _load_like(v, flat, device, f"{prefix}/{k}" if prefix else str(k))
            for k, v in template.items()}


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None

    # -- save ----------------------------------------------------------------
    def save(self, step: int, state, *, blocking: bool = True,
             metadata: Optional[Dict] = None):
        host = {k: v.detach().to("cpu", copy=True).numpy()
                for k, v in _flatten(state).items()}
        if blocking:
            self._write(step, host, metadata)
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host, metadata), daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: Dict[str, np.ndarray],
               metadata: Optional[Dict]):
        out = self.dir / f"step_{step:08d}"
        tmp = self.dir / f".tmp_step_{step:08d}"
        tmp.mkdir(parents=True, exist_ok=True)
        np.savez(tmp / "arrays.npz", **host)
        manifest = {
            "step": step,
            "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in host.items()},
            "metadata": metadata or {},
            "time": time.time(),
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
        if out.exists():
            shutil.rmtree(out)
        tmp.rename(out)          # atomic publish
        self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def all_steps(self):
        return [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")]

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return max(steps) if steps else None

    def load_arrays(self, step: int) -> Dict[str, np.ndarray]:
        with np.load(self.dir / f"step_{step:08d}" / "arrays.npz") as data:
            return {k: data[k] for k in data.files}

    def restore(self, step: int, template, device=None):
        """Load ``step`` into a state shaped like ``template`` on ``device``
        (default: where each template tensor lies)."""
        return _load_like(template, self.load_arrays(step), device)

    def restore_latest(self, template, device=None) -> Tuple[Optional[int], Any]:
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, template, device)


def install_preemption_hook(save_fn: Callable[[], None]):
    """Checkpoint on SIGTERM (preemption notice), then exit cleanly.
    Returns the handler it replaced."""
    def handler(signum, frame):
        save_fn()
        raise SystemExit(143)
    return signal.signal(signal.SIGTERM, handler)
