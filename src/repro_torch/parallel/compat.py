"""Device meshes and the collectives over one of their axes.

Counterpart of ``repro.parallel.compat`` (its ``compat.py:14-40``). JAX
runs a mesh program as one SPMD function under ``shard_map``; torch has no
such transform, so the port's local functions call the collectives
themselves, each over the process group of one mesh axis:

* :class:`Mesh`: the axis names, their sizes (``shape``, a dict as JAX's
  ``Mesh.shape``), the devices, and, when the process belongs to a
  ``torch.distributed`` group whose size is the mesh's, one process group
  per axis (the ranks that differ only in that axis's coordinate). Ranks
  lie on the mesh row-major, as ``jax.make_mesh`` lays out devices. A mesh
  without ranks (shape only) serves specs and planning and refuses
  collectives;
* :func:`make_mesh`;
* :func:`axis_size`, :func:`axis_index`, and over one axis's group
  :func:`all_to_all` (differentiable: its backward is the reverse
  exchange), :func:`all_gather` (differentiable, of slices of a value
  every rank then holds replicated: its backward takes this rank's own
  slice of the cotangent and sums nothing), :func:`psum` / :func:`pmean`
  and :func:`ppermute` (pairs of axis indices, sent by
  ``batch_isend_irecv``; a pair from a rank to itself is a copy);
* :func:`grad_psum`: the identity whose backward sums the cotangent over
  some axes and scales it (the transpose of JAX's implicit broadcast of a
  replicated value into ``shard_map``). Both skip axes of size 1;
* :func:`device_mesh`: the ``torch.distributed`` ``DeviceMesh`` over a
  mesh's own process groups and axis names, for DTensors.

``shard_map`` has no counterpart: the port's sharded functions
(``models.moe.moe_sharded``, ``parallel.pipeline``) take this rank's
slices themselves. ``cost_analysis_dict`` reads XLA's cost analysis; the
port's counts come from ``repro_torch.roofline.op_cost``, whose
``flops_once`` / ``bytes_once`` play its part.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


class Mesh:
    """Named axes over ranks. ``shape`` maps each axis name to its size, in
    order; ``groups`` maps it to its process group (None without ranks);
    ``coords`` is this rank's index on each axis (all 0 without ranks)."""

    def __init__(self, axis_shapes: Sequence[int], axis_names: Sequence[str],
                 devices=None, groups: Optional[Dict[str, object]] = None,
                 rank: Optional[int] = None):
        if len(axis_shapes) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(axis_shapes)} for axes {tuple(axis_names)}")
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, map(int, axis_shapes)))
        self.devices = devices
        self.groups = groups
        self.rank = rank
        idx = (np.unravel_index(rank, tuple(self.shape.values()))
               if rank is not None else (0,) * len(self.axis_names))
        self.coords: Dict[str, int] = dict(zip(self.axis_names, map(int, idx)))

    def group(self, axis: str):
        if self.groups is None:
            raise RuntimeError(f"mesh {self.shape} has no ranks: no collective over "
                               f"axis {axis!r} (build it with make_mesh inside a "
                               "torch.distributed process group)")
        return self.groups[axis]

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def _axis_groups(shape: Tuple[int, ...], names: Tuple[str, ...], rank: int):
    """One process group per axis holding this rank. Every rank creates
    every group, in the same order, as ``dist.new_group`` requires."""
    ranks = np.arange(int(np.prod(shape))).reshape(shape)
    groups = {}
    for ax, name in enumerate(names):
        moved = np.moveaxis(ranks, ax, -1).reshape(-1, shape[ax])
        for members in moved:
            g = dist.new_group([int(r) for r in members])
            if rank in members:
                groups[name] = g
    return groups


def make_mesh(axis_shapes: Sequence[int], axis_names: Sequence[str], devices=None) -> Mesh:
    """A mesh of ``axis_shapes`` over ``axis_names``. Inside a
    ``torch.distributed`` process group of exactly ``prod(axis_shapes)``
    ranks it holds one group per axis (a one-rank mesh reuses the world
    group for each axis); otherwise it has no ranks. ``devices`` is kept
    as given (the ranks' devices, or None)."""
    shape = tuple(int(s) for s in axis_shapes)
    names = tuple(axis_names)
    need = int(np.prod(shape))
    if not (dist.is_available() and dist.is_initialized()) or dist.get_world_size() != need:
        return Mesh(shape, names, devices)
    rank = dist.get_rank()
    if need == 1:
        groups = {name: dist.group.WORLD for name in names}
    else:
        groups = _axis_groups(shape, names, rank)
    return Mesh(shape, names, devices, groups, rank)


def axis_size(mesh: Mesh, axis) -> int:
    """Size of one axis, or the product over a tuple of axes (1 for None)."""
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return int(np.prod([axis_size(mesh, a) for a in axis], dtype=np.int64))
    return mesh.shape[axis]


def axis_index(mesh: Mesh, axis) -> int:
    """This rank's index along one axis, or along a tuple of axes taken
    major to minor (0 for None)."""
    if axis is None:
        return 0
    if isinstance(axis, tuple):
        idx = 0
        for a in axis:
            idx = idx * mesh.shape[a] + mesh.coords[a]
        return idx
    return mesh.coords[axis]


def all_to_all(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_axis=0, concat_axis=0,
    tiled=False)``: x's leading axis (the axis's size) is split, slice j
    goes to axis index j, and slot i of the result came from index i.
    Gradients flow (the backward is the reverse exchange)."""
    from torch.distributed.nn.functional import all_to_all_single
    n = axis_size(mesh, axis)
    if x.shape[0] != n:
        raise ValueError(f"all_to_all over {axis!r} of size {n}: leading axis {x.shape[0]}")
    x = x.contiguous()
    return all_to_all_single(torch.empty_like(x), x, group=mesh.group(axis))


class _GatherReplicated(torch.autograd.Function):
    """Slices gathered along ``dim`` into a value every rank holds whole.
    The cotangent of that value is replicated too, so the backward takes
    this rank's own slice of it; a sum over the ranks would count it once
    per rank."""

    @staticmethod
    def forward(ctx, x, group, n, index, dim):
        ctx.n, ctx.index, ctx.dim = n, index, dim
        x = x.movedim(dim, 0).contiguous()
        out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.n, dim=ctx.dim)[ctx.index], None, None, None, None


def all_gather(x: torch.Tensor, mesh: Mesh, axis: str, dim: int = 0) -> torch.Tensor:
    """The axis's slices of ``x`` concatenated along ``dim`` in axis order,
    a value every rank of the axis then holds (differentiable: the
    backward returns this rank's slice of the cotangent). An axis of size
    1 gathers nothing."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    return _GatherReplicated.apply(x, mesh.group(axis), n, axis_index(mesh, axis), dim)


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups, scale):
        ctx.groups, ctx.scale = groups, scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        # a fresh buffer: the reduce writes in place
        g = (g * ctx.scale if ctx.scale != 1.0 else g.clone()).contiguous()
        for group in ctx.groups:
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        return g, None, None


def grad_psum(x: torch.Tensor, mesh: Mesh, axes: Sequence[str] = (),
              scale: float = 1.0) -> torch.Tensor:
    """``x`` in the forward; in the backward its cotangent times ``scale``,
    summed over ``axes`` (axes of size 1 skipped). Returns ``x`` itself
    when there is nothing to do."""
    groups = [mesh.group(a) for a in axes if axis_size(mesh, a) > 1]
    if not groups and scale == 1.0:
        return x
    return _SumGrad.apply(x, groups, float(scale))


def device_mesh(mesh: Mesh, device="cuda"):
    """The ``DeviceMesh`` of ``mesh`` on ``device``'s type, with the same
    axis names, over the mesh's own process groups (no group is made;
    the ranks lie row-major, as :func:`make_mesh` lays them out). Built
    once a mesh and device type. ``device="cuda"`` needs a card."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.device import resolve_device
    kind = resolve_device(device).type
    cache = mesh.__dict__.setdefault("_device_meshes", {})
    if kind not in cache:
        if mesh.groups is None:
            raise RuntimeError(f"mesh {mesh.shape} has no ranks: no DeviceMesh (build it "
                               "with make_mesh inside a torch.distributed process group)")
        shape = tuple(mesh.shape.values())
        n = int(np.prod(shape))
        # a one-rank mesh may be one rank of a larger job
        ranks = torch.arange(n) if n > 1 else torch.tensor([dist.get_rank()])
        cache[kind] = DeviceMesh.from_group(
            [mesh.group(a) for a in mesh.axis_names], kind,
            mesh=ranks.reshape(shape), mesh_dim_names=mesh.axis_names)
    return cache[kind]


def psum(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over the axis (a new tensor; ``x`` is left alone)."""
    out = x.clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group(axis))
    return out


def pmean(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Mean of ``x`` over the axis: the sum divided by the axis's size."""
    return psum(x, mesh, axis) / axis_size(mesh, axis)


def ppermute(x: torch.Tensor, mesh: Mesh, axis: str,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """``jax.lax.ppermute``: for each (src, dst) pair of axis indices, dst
    receives src's ``x``; an index that receives nothing gets zeros."""
    group = mesh.group(axis)
    me = axis_index(mesh, axis)
    out = torch.zeros_like(x)
    x = x.contiguous()
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(x)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(group, dst), group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out

