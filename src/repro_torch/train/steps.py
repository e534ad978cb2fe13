"""Step builders: the train step (gradients and AdamW, optional microbatch
accumulation) and the serve steps (prefill / decode).

Counterpart of ``repro.train.steps`` (its ``steps.py:22-119``), with
``torch.autograd`` in place of ``jax.value_and_grad``. The train state is
``{"params": LM, "opt": {"mu", "nu", "step"}}`` (see
:mod:`repro_torch.optim.adamw`); a step writes it in place and returns it.
Every parameter must get a gradient: a parameter that the loss does not
reach raises (``torch.autograd.grad`` without ``allow_unused``). The step
is the same on a sharded model (DTensor parameters from
:meth:`repro_torch.models.model_zoo.Model.shard`): the loss comes back
replicated, the gradients as DTensors, and the optimizer reduces them.

:func:`abstract_train_state` is the reference's shape-only state: the
parameters and moments on the ``meta`` device, nothing allocated and
nothing drawn.

:func:`train_state_from_numpy` carries the reference's train state
across, so one step can start from the same state in both packages.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model_zoo import (Model, check_keys, init_params,
                                          params_from_numpy, per_layer_arrays)
from repro_torch.parallel.sharding import is_dtensor, spmd
from repro_torch.optim.adamw import (Q_BLOCK, AdamWConfig, adamw_update, adamw_update_q8,
                                     global_norm, init_opt_state, init_opt_state_q8)

TrainState = Dict[str, Any]  # {"params", "opt"}
OPTIMIZERS = ("adamw", "adamw_q8")


def _check_optimizer(optimizer: str) -> None:
    if optimizer not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer {optimizer!r}; expected one of {OPTIMIZERS}")


def init_train_state(model: Model, seed, *, optimizer: str = "adamw") -> TrainState:
    _check_optimizer(optimizer)
    params = model.init(seed)
    init_fn = init_opt_state_q8 if optimizer == "adamw_q8" else init_opt_state
    return {"params": params, "opt": init_fn(params)}


def abstract_train_state(model: Model, seed=None, *, optimizer: str = "adamw") -> TrainState:
    """The train state's shapes and dtypes, for planning: the parameters
    (the assembly's module) and the optimizer's moments and step on the
    ``meta`` device. Nothing is allocated and no weight is drawn, so
    ``seed`` (kept for the reference's signature) is not used."""
    _check_optimizer(optimizer)
    del seed
    params = init_params(None, model.cfg, torch.device("meta"))
    init_fn = init_opt_state_q8 if optimizer == "adamw_q8" else init_opt_state
    return {"params": params, "opt": init_fn(params)}


def build_train_step(model: Model, opt_cfg: AdamWConfig, *,
                     microbatches: int = 1, optimizer: str = "adamw",
                     accum_dtype=torch.float32):
    """Returns ``train_step(state, batch, accept=None) -> (state, metrics)``.

    optimizer: "adamw" (float32 moments) or "adamw_q8" (int8 block-quantized
    moments). accum_dtype: the microbatch gradient-accumulation type.
    ``accept``, when given, is called with the step's global gradient norm
    before the update; if it returns False the update is dropped (the state
    is left as it was), as the trainer's grad-spike guard wants. It is asked
    first because the update writes the state in place."""
    _check_optimizer(optimizer)
    update_fn = adamw_update_q8 if optimizer == "adamw_q8" else adamw_update

    @spmd   # the backward of a sharded model meets the same plain constants
    def single(params, batch):
        names, leaves = zip(*params.named_parameters())
        loss, metrics = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                dict(zip(names, grads)))

    def split(x):
        B = x.shape[0]
        # batch entries that do not start with the global batch (M-RoPE
        # positions (3, B, S)) are split on axis 1
        positions = x.ndim >= 2 and x.shape[0] == 3 and x.shape[1] % microbatches == 0
        if is_dtensor(x):
            return _split_sharded(x, microbatches, 1 if positions else 0)
        if positions:
            return x.reshape((3, microbatches, -1) + x.shape[2:]).swapaxes(0, 1)
        return x.reshape((microbatches, B // microbatches) + x.shape[1:])

    def accumulate(params, batch):
        """Gradient accumulation over leading splits of the batch."""
        mb = {k: split(v) for k, v in batch.items()}
        # placed as the parameters on a sharded model
        grads_a = {n: torch.zeros_like(p, dtype=accum_dtype)
                   for n, p in params.named_parameters()}
        dev = next(iter(grads_a.values())).device
        loss_a = torch.zeros((), dtype=torch.float32, device=dev)
        metrics_a = {"xent": torch.zeros_like(loss_a), "aux": torch.zeros_like(loss_a)}
        for i in range(microbatches):
            loss, metrics, grads = single(params, {k: v[i] for k, v in mb.items()})
            for n, g in grads.items():
                grads_a[n].add_(g.to(accum_dtype) / microbatches)
            loss_a = loss_a + loss / microbatches
            metrics_a = {k: a + metrics[k] / microbatches for k, a in metrics_a.items()}
        return loss_a, metrics_a, grads_a

    def train_step(state: TrainState, batch, accept: Optional[Callable] = None
                   ) -> Tuple[TrainState, Dict]:
        params = state["params"]
        if microbatches > 1:
            loss, metrics, grads = accumulate(params, batch)
        else:
            loss, metrics, grads = single(params, batch)
        if accept is not None:
            gnorm = global_norm(grads)
            if not accept(gnorm):
                return state, dict(metrics, loss=loss, grad_norm=gnorm, skipped=True)
        new_params, new_opt, opt_metrics = update_fn(opt_cfg, grads, params, state["opt"])
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def _split_sharded(x, microbatches: int, dim: int):
    """A DTensor batch entry split into ``microbatches`` along ``dim``:
    where that dim is sharded, microbatch i takes the i-th slice of every
    rank's rows, so no row moves (a split of the global rows would gather
    them first); each microbatch keeps the entry's placements."""
    from torch.distributed.tensor import DTensor
    if not any(p.is_shard(dim) for p in x.placements):
        return list(x.unflatten(dim, (microbatches, -1)).unbind(dim))
    parts = x.to_local().unflatten(dim, (microbatches, -1)).unbind(dim)
    return [DTensor.from_local(t, x.device_mesh, x.placements, run_check=False)
            for t in parts]


def greedy_tokens(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the vocab (last dim), int32. A DTensor's vocab is
    gathered first: DTensor's argmax over a sharded dim fails for a batch
    of one row."""
    if is_dtensor(logits):
        from torch.distributed.tensor import Replicate
        vocab = logits.ndim - 1
        placements = tuple(Replicate() if p.is_shard(vocab) or p.is_partial() else p
                           for p in logits.placements)
        logits = logits.redistribute(logits.device_mesh, placements)
    return torch.argmax(logits, dim=-1).to(torch.int32)


def build_prefill_step(model: Model):
    def prefill_step(params, batch):
        logits, cache = model.prefill(params, batch)
        return greedy_tokens(logits), logits, cache
    return prefill_step


def build_decode_step(model: Model, *, greedy: bool = True):
    def serve_step(params, cache, batch):
        logits, cache = model.decode(params, cache, batch)
        return greedy_tokens(logits), cache
    return serve_step


# ---------------------------------------------------------------------------
# The reference's train state, carried across
# ---------------------------------------------------------------------------

def _nest(tree: Mapping[str, Any]) -> Dict[str, Any]:
    """A flat ``{"a/b/c": array}`` mapping (the reference Checkpointer's
    ``arrays.npz`` keys) as nested dicts; nested input passes through."""
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        if isinstance(val, Mapping):
            val = _nest(val)
        parts = key.split("/")
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val
    return out


@torch.no_grad()
def train_state_from_numpy(cfg: ModelConfig, tree: Mapping[str, Any],
                           optimizer: str = "adamw", device="cuda") -> TrainState:
    """The reference's train state ``{"params", "opt": {"mu", "nu",
    "step"}}`` as numpy arrays, layers stacked (the q8 moments as
    ``{"q", "s"}`` leaves), or the flat ``/``-keyed arrays of a reference
    ``Checkpointer`` step -> the port's state on ``device``, every key and
    shape checked."""
    _check_optimizer(optimizer)
    dev = resolve_device(device)
    tree = _nest(tree)
    params = params_from_numpy(cfg, tree["params"], dev)
    names = dict(params.named_parameters())
    opt = tree["opt"]
    state = {"step": torch.as_tensor(np.asarray(opt["step"]).astype(np.int32)).to(dev)}
    for moment in ("mu", "nu"):
        flat = per_layer_arrays(cfg, opt[moment])
        if optimizer == "adamw_q8":
            leaves: Dict[str, Dict[str, torch.Tensor]] = {}
            for key, arr in flat.items():
                name, part = key.rsplit(".", 1)
                if part not in ("q", "s"):
                    raise KeyError(f"opt/{moment}/{key}: expected q8 leaves q and s")
                leaves.setdefault(name, {})[part] = torch.tensor(np.asarray(arr)).to(dev)
            check_keys(f"opt/{moment}", leaves, names)
            for name, p in names.items():
                q, s = leaves[name]["q"], leaves[name]["s"]
                blocks = -(-p.shape[-1] // Q_BLOCK)
                if (q.dtype != torch.int8 or tuple(q.shape) != tuple(p.shape)
                        or tuple(s.shape) != tuple(p.shape[:-1]) + (blocks,)):
                    raise ValueError(f"opt/{moment}/{name}: codes {q.dtype} {tuple(q.shape)}, "
                                     f"scales {tuple(s.shape)} for a param of "
                                     f"{tuple(p.shape)}")
            state[moment] = {n: leaves[n] for n in names}
        else:
            check_keys(f"opt/{moment}", flat, names)
            state[moment] = {}
            for name, p in names.items():
                a = np.asarray(flat[name], dtype=np.float32)
                if a.shape != tuple(p.shape):
                    raise ValueError(f"opt/{moment}/{name}: shape {a.shape}, expected "
                                     f"{tuple(p.shape)}")
                state[moment][name] = torch.tensor(a).to(dev)
    return {"params": params, "opt": {"mu": state["mu"], "nu": state["nu"],
                                      "step": state["step"]}}
