"""Logical-axis sharding rules with divisibility fallback.

Counterpart of ``repro.parallel.sharding`` (its ``sharding.py:22-197``).
Tensors are annotated with *logical* axis names; a rule table maps
logical names to mesh axes. A mapping that does not divide the concrete
dimension is dropped (the dim is replicated) instead of erroring, so one
rule set serves all ten architectures.

* :data:`DEFAULT_RULES` and :class:`ParallelContext`, with the
  reference's fields and defaults (``use_ep``, ``capacity_factor`` 1.25,
  ``moe_token_chunk`` 8,192, ``remat`` "layer", ``attn_chunk`` 512,
  ``attn_schedule`` "rect"), its filtering of absent axes, ``axis_size``
  and ``spec_for``, which returns a :class:`P`: a tuple holding the
  entries of JAX's ``PartitionSpec``;
* ``placements_for``, the torch counterpart of ``sharding_for``: one
  DTensor placement (``Shard(dim)`` / ``Replicate()``) per mesh axis;
* ``constrain``, the counterpart of ``with_sharding_constraint``: it
  redistributes a DTensor to ``placements_for`` its logical axes and
  returns a plain tensor unchanged (a model that runs replicated has
  nothing to constrain);
* :func:`single_device_context`: a (1, 1) mesh over a one-rank process
  group (``gloo`` on the CPU, ``nccl`` on the card), made in the process
  over a ``HashStore`` when no group exists, the existing one reused when
  it does, and its one-rank ``DeviceMesh`` (:func:`compat.device_mesh`);
* the model's sharded run: :func:`shard_params` turns parameters (a
  module, in place, or a mapping such as the optimizer's moments) into
  DTensors placed by :func:`param_shardings`, each rank keeping its slice
  of the full tensor it holds, as JAX's ``NamedSharding`` gives it;
  :func:`distribute` does the same for any tree and placements (a batch,
  a cache); :func:`spmd` runs a model function with the plain tensors it
  meets (constants, positions, masks) taken as replicated DTensors, so
  the model's code is the same for both runs;
* :func:`logical_axes_for_leaf` and :func:`param_specs` over the port's
  dotted parameter names (``layers.3.attn.wq``, ``layers.3.moe.w_gate``,
  the int8 moments' ``...w_gate.q`` / ``.s``). The port keeps one tensor
  per layer where the reference stacks the layers, so a per-layer spec is
  the reference's stacked spec without its leading ``"layers"`` entry
  (``None`` under every rule).
"""
from __future__ import annotations

import functools
import sys
from dataclasses import dataclass, field
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.parallel.compat import Mesh, device_mesh

LogicalAxes = Tuple[Optional[str], ...]

# logical axis -> mesh axis (or tuple of mesh axes); None = replicate
DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),      # filtered to axes present in the mesh
    "seq": None,
    "kv_seq": None,                # long-context lever: set to "data"
    "embed": None,
    "param_embed": None,        # FSDP lever: set to "data"
    "q_heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "vocab": "model",
    "experts": "model",
    "expert_mlp": None,            # FSDP lever: set to "data"
    "inner": "model",              # mamba/xlstm inner projections
    "layers": None,
    "fsdp": None,                  # optional param sharding over "data"
}


class P(tuple):
    """A partition spec: one entry per tensor dim, each None, a mesh axis
    name or a tuple of them (the entries of JAX's ``PartitionSpec``)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


@dataclass
class ParallelContext:
    """Carries the mesh + rules through model code."""

    mesh: Mesh
    rules: Dict[str, Any] = field(default_factory=lambda: dict(DEFAULT_RULES))
    dp_axes: Tuple[str, ...] = ("data",)
    ep_axis: str = "model"
    use_ep: bool = True
    capacity_factor: float = 1.25
    moe_token_chunk: int = 8192
    remat: str = "layer"           # "none" | "layer"
    attn_chunk: int = 512
    attn_schedule: str = "rect"    # "rect" | "grouped"

    def __post_init__(self):
        present = set(self.mesh.axis_names)
        self.dp_axes = tuple(a for a in self.dp_axes if a in present)
        fixed = {}
        for k, v in self.rules.items():
            if isinstance(v, tuple):
                v = tuple(a for a in v if a in present) or None
                if v is not None and len(v) == 1:
                    v = v[0]
            elif v is not None and v not in present:
                v = None
            fixed[k] = v
        self.rules = fixed

    # -- helpers ------------------------------------------------------------
    def axis_size(self, mesh_axis) -> int:
        if mesh_axis is None:
            return 1
        if isinstance(mesh_axis, tuple):
            return int(np.prod([self.axis_size(a) for a in mesh_axis]))
        return self.mesh.shape[mesh_axis]

    def spec_for(self, shape: Sequence[int], logical: LogicalAxes) -> P:
        """Partition spec for a concrete shape, dropping non-dividing rules."""
        assert len(shape) == len(logical), (shape, logical)
        entries, used = [], set()
        for dim, name in zip(shape, logical):
            mesh_axis = self.rules.get(name) if name else None
            if mesh_axis is None:
                entries.append(None)
                continue
            axes = mesh_axis if isinstance(mesh_axis, tuple) else (mesh_axis,)
            axes = tuple(a for a in axes if a not in used)
            size = int(np.prod([self.mesh.shape[a] for a in axes])) if axes else 1
            if not axes or size <= 1 or dim % size != 0:
                # try a shrinking prefix (e.g. ("pod","data") -> ("pod",))
                while axes and dim % int(np.prod([self.mesh.shape[a] for a in axes])) != 0:
                    axes = axes[:-1]
                if not axes:
                    entries.append(None)
                    continue
            used.update(axes)
            entries.append(axes if len(axes) > 1 else axes[0])
        return P(*entries)

    def placements_for(self, shape: Sequence[int], logical: LogicalAxes) -> tuple:
        """DTensor placements, one per mesh axis in order: ``Shard(d)`` for
        the axis that splits tensor dim d under :meth:`spec_for`, else
        ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard
        on = {}
        for d, entry in enumerate(self.spec_for(shape, logical)):
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                if a is not None:
                    on[a] = d
        return tuple(Shard(on[a]) if a in on else Replicate()
                     for a in self.mesh.axis_names)

    def constrain(self, x: torch.Tensor, logical: LogicalAxes) -> torch.Tensor:
        """``with_sharding_constraint`` by logical axes: a DTensor is
        redistributed to :meth:`placements_for` its shape; a plain tensor
        (the replicated model) is returned unchanged."""
        if not is_dtensor(x):
            return x
        return x.redistribute(x.device_mesh, self.placements_for(tuple(x.shape), logical))


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (without importing DTensor when no
    module has)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def spmd(fn):
    """Run ``fn`` with DTensor's implicit replication: a plain tensor that
    meets a DTensor in an op is taken as replicated, as a constant is in
    a JAX program under ``jit``. Nothing changes for plain tensors."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        if "torch.distributed.tensor" not in sys.modules:
            return fn(*args, **kwargs)
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor.experimental import implicit_replication
        # the context is not re-entrant: its exit switches the mode off
        if DTensor._op_dispatcher._allow_implicit_replication:
            return fn(*args, **kwargs)
        with implicit_replication():
            return fn(*args, **kwargs)
    return run


def _one_rank_group(dev: torch.device):
    """The process group of a one-rank mesh: the world group of a
    one-process job (made here over a ``HashStore`` when none exists), or
    a new group of this rank alone inside a larger job."""
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    if dist.get_world_size() == 1:
        return dist.group.WORLD
    return dist.new_group([dist.get_rank()], backend=backend,
                          use_local_synchronization=True)


def single_device_context(device="cuda", **kw) -> ParallelContext:
    """A context over a (1, 1) ``("data", "model")`` mesh on ``device``,
    backed by a one-rank process group, so every collective of the
    sharded paths is issued (and is the identity). ``device="cuda"`` needs
    a card."""
    dev = resolve_device(device)
    group = _one_rank_group(dev)
    names = ("data", "model")
    mesh = Mesh((1, 1), names, devices=np.array([[dev]], dtype=object),
                groups={n: group for n in names}, rank=0)
    device_mesh(mesh, dev)
    return ParallelContext(mesh=mesh, **kw)


# ---------------------------------------------------------------------------
# Param logical-axis inference (by leaf name + rank)
# ---------------------------------------------------------------------------

_LEAF_LOGICAL: Dict[str, LogicalAxes] = {
    "embedding": ("vocab", "param_embed"),
    "unembed": ("param_embed", "vocab"),
    "pos_embedding": (None, "param_embed"),
    "wq": ("param_embed", "q_heads"),
    "wk": ("param_embed", "kv_heads"),
    "wv": ("param_embed", "kv_heads"),
    "wo": ("q_heads", "param_embed"),
    "gate": ("param_embed", "mlp"),
    "up": ("param_embed", "mlp"),
    "down": ("mlp", "param_embed"),
    "router": ("param_embed", None),
    "w_gate": ("experts", "param_embed", "expert_mlp"),
    "w_up": ("experts", "param_embed", "expert_mlp"),
    "w_down": ("experts", "expert_mlp", "param_embed"),
    "in_proj": ("param_embed", "inner"),
    "conv_w": (None, "inner"),
    "out_proj": ("inner", "param_embed"),
    "wif": ("param_embed", None),
    "wx": ("param_embed", None),
    "r": (None, None, None, None),
}
_REPLICATED = {"scale", "bias", "A_log", "D", "dt_bias", "norm_scale", "skip_scale"}


def _stacked_logical(names, rank: int) -> LogicalAxes:
    """The reference's ``logical_axes_for_leaf`` on its key names
    (innermost first) and rank."""
    name = names[0] if names else None
    # q8 optimizer moments: codes "q" inherit the parent param's axes; the
    # per-block scale "s" inherits all but the (blocked) last dim.
    if name in ("q", "s") and len(names) > 1:
        parent = names[1]
        logical = _LEAF_LOGICAL.get(parent)
        if parent in _REPLICATED or logical is None:
            return (None,) * rank
        if name == "q":
            if rank == len(logical) + 1:
                return ("layers",) + logical
            return logical if rank == len(logical) else (None,) * rank
        base = logical[:-1] + (None,)
        if rank == len(base) + 1:
            return ("layers",) + base
        return base if rank == len(base) else (None,) * rank
    if name in _REPLICATED or name is None:
        return (None,) * rank
    logical = _LEAF_LOGICAL.get(name)
    if logical is None:
        return (None,) * rank
    if rank == len(logical) + 1:       # stacked per-layer params: (L, ...)
        return ("layers",) + logical
    if rank != len(logical):
        return (None,) * rank
    return logical


def logical_axes_for_leaf(name: str, leaf) -> LogicalAxes:
    """Logical axes of the leaf at dotted ``name``. A name with a layer
    index (``layers.3.attn.wq``) is one layer of a stack the reference
    keeps on a leading axis: its axes are the stacked leaf's without that
    leading entry."""
    parts = name.split(".")
    names = [p for p in reversed(parts) if not p.isdigit()]
    rank = len(leaf.shape)
    if len(names) < len(parts):
        return _stacked_logical(names, rank + 1)[1:]
    return _stacked_logical(names, rank)


def _leaves(tree, prefix: str = ""):
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            yield from _leaves(val, name + ".")
        else:
            yield name, val


def param_specs(ctx: ParallelContext, params) -> Dict[str, P]:
    """``{dotted name: P}`` for a module's parameters, or for a (nested)
    mapping of tensors such as the optimizer's moments."""
    return {name: ctx.spec_for(tuple(leaf.shape), logical_axes_for_leaf(name, leaf))
            for name, leaf in _leaves(params)}


def param_shardings(ctx: ParallelContext, params) -> Dict[str, tuple]:
    """``{dotted name: DTensor placements}`` (:meth:`ParallelContext.placements_for`)."""
    return {name: ctx.placements_for(tuple(leaf.shape), logical_axes_for_leaf(name, leaf))
            for name, leaf in _leaves(params)}


# ---------------------------------------------------------------------------
# The sharded run: parameters and batches as DTensors
# ---------------------------------------------------------------------------

@torch.no_grad()
def distribute(tree, placements: Mapping[str, Any], ctx: ParallelContext, device="cuda"):
    """A (nested) mapping of full tensors -> the same mapping of DTensors
    over ``ctx``'s mesh, each placed by ``placements`` (``{dotted name:
    placements}``, as :func:`param_shardings` gives them). Every rank
    keeps its own slice of the full tensor it holds: nothing is sent."""
    from torch.distributed.tensor import distribute_tensor
    dm = device_mesh(ctx.mesh, device)

    def walk(node, prefix):
        out = {}
        for key, val in node.items():
            name = f"{prefix}{key}"
            if isinstance(val, Mapping):
                out[key] = walk(val, name + ".")
            else:
                out[key] = distribute_tensor(val.detach().to(dm.device_type), dm,
                                             placements[name], src_data_rank=None)
        return out
    return walk(tree, "")


def shard_params(model_or_params, ctx: ParallelContext, device="cuda"):
    """Parameters as DTensors placed by :func:`param_shardings`: a module's
    parameters are replaced in place (trainable as before) and the module
    is returned; a mapping (the optimizer's moments) gives a new mapping.
    ``device="cuda"`` needs a card."""
    if not isinstance(model_or_params, nn.Module):
        return distribute(model_or_params, param_shardings(ctx, model_or_params), ctx, device)
    module = model_or_params
    named = dict(module.named_parameters())
    sharded = distribute(named, param_shardings(ctx, module), ctx, device)
    for name, p in named.items():
        owner, _, leaf = name.rpartition(".")
        setattr(module.get_submodule(owner) if owner else module, leaf,
                nn.Parameter(sharded[name], requires_grad=p.requires_grad))
    return module
