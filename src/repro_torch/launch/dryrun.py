"""Multi-pod dry run: every (arch x shape x mesh) cell of the grid run once
on a fake process group of 256 ranks (16 x 16), or 512 with
``--multi-pod`` (2 x 16 x 16), under ``FakeTensorMode``: nothing is
allocated and nothing is sent, but every rank-local op of the step is
dispatched, so the cell's op counts, collectives and memory are those of
one rank of the production mesh.

Counterpart of ``repro.launch.dryrun``, which lowers and compiles each
cell with XLA on 512 host devices. Here the parameters are placed by
``Model.shard`` (the reference's ``param_shardings``), the batch and the
cache by ``batch_placements`` / ``cache_placements``, and the step runs
once under :class:`repro_torch.roofline.op_cost.OpCounter` with the
``"torch"`` attention backend (the reference lowers its jnp attention,
not Pallas) and under ``MemTracker``
(``torch.distributed._tools.mem_tracker``) for the peak:

* train: ``build_train_step`` with the reference's microbatches
  (:func:`_pick_microbatches`), AdamW, and at pool scale
  (:func:`_wants_offload`) ``adamw_q8`` with bfloat16 parameters and
  bfloat16 gradient accumulation;
* prefill: ``build_prefill_step``; decode: ``build_decode_step`` on the
  cell's cache.

The record keeps the reference's keys (``arch``, ``shape``, ``mesh``,
``chips``, ``kind``, ``memory``, ``roofline``, ``microbatches``,
``fsdp``, ``offload``, ``optimizer``, ``status``) and adds ``mesh_s``
(the fake group's mesh: one process group per axis group, 320 at 512
ranks), ``build_s`` / ``run_s`` (building and placing the state; the
counted run) and ``seconds``. Memory, per rank:

* ``argument_bytes``: the rank's local shards of the state (parameters,
  moments) and of the batch and cache (and a decode's int32 index, which
  the port's decode takes as an int); ``--offload on`` counts the
  sharded moment slabs of at least 1 MiB as ``host_argument_bytes``
  instead (the reference's ``pinned_host`` rule, ``dryrun.py:113-132``;
  the port's optimizer reads them where they are, so the counted step is
  unchanged);
* ``output_bytes``: the step's outputs; ``alias_bytes``: those written
  in place into an input (the train state, a decode cache), as the
  reference's donated buffers;
* ``peak_device_bytes``: the tracker's peak over the step, less host
  bytes; ``temp_bytes`` = peak - arguments - outputs + aliases, so
  ``peak = argument + output + temp - alias`` as in the reference.

An error is recorded, never skipped (``status: "error"`` with the
exception and its traceback), and the exit code is 1 if any cell failed.

The fake group is this process's default process group: the dry run
makes it (``init_process_group("fake", ...)``) and refuses to run in a
process that already belongs to another group. Records are written only
under ``--out``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --multi-pod --device cpu --out DIR
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import time
import traceback
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import SHAPES_BY_NAME, ShapeSpec
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.device import resolve_device
from repro_torch.models.model_zoo import (batch_placements, build_model, cache_placements,
                                          init_params)
from repro_torch.optim.adamw import AdamWConfig, init_opt_state, init_opt_state_q8
from repro_torch.parallel.compat import device_mesh, make_mesh
from repro_torch.parallel.sharding import (DEFAULT_RULES, ParallelContext, distribute,
                                           is_dtensor)
from repro_torch.roofline.analysis import analyze
from repro_torch.roofline.op_cost import OpCounter
from repro_torch.train.steps import build_decode_step, build_prefill_step, build_train_step

# activation budget for picking microbatch count (bytes per device)
_ACT_BUDGET = 2 << 30
#: the production meshes: one pod (data x model), two pods (pod x data x model)
POD1 = ((16, 16), ("data", "model"))
POD2 = ((2, 16, 16), ("pod", "data", "model"))


def _needs_fsdp(cfg) -> bool:
    # fp32 master params per device with TP-only sharding over model=16
    return cfg.param_count() * 4 / 16 > 4e9


def _wants_offload(cfg) -> bool:
    # moments don't fit on device even fully sharded -> pooled-memory tier
    return cfg.param_count() * 12 / 256 > 8e9


def _pick_microbatches(cfg, shape: ShapeSpec, dp: int) -> int:
    if shape.kind != "train":
        return 1
    b_loc = max(shape.global_batch // dp, 1)
    per_sample = shape.seq_len * cfg.d_model * 2 * max(cfg.num_layers, 1)
    mb = 1
    while b_loc // mb > 1 and (b_loc // mb) * per_sample > _ACT_BUDGET:
        mb *= 2
    return min(mb, b_loc)


def make_context(cfg, shape: ShapeSpec, mesh, *, fsdp=None,
                 schedule: str = "rect") -> ParallelContext:
    rules = dict(DEFAULT_RULES)
    fsdp = _needs_fsdp(cfg) if fsdp is None else fsdp
    if shape.kind == "train" and fsdp:
        rules["param_embed"] = "data"
        rules["expert_mlp"] = "data"
    if shape.kind == "decode":
        rules["kv_seq"] = "model"   # flash-decoding style KV-seq sharding
    return ParallelContext(mesh=mesh, rules=rules,
                           dp_axes=("pod", "data"),
                           attn_schedule=schedule)


def model_flops_for(cfg, shape: ShapeSpec) -> float:
    n_active = cfg.active_param_count()
    n_total = cfg.param_count()
    if shape.kind == "train":
        return 6.0 * (n_active if cfg.moe else n_total) * shape.tokens
    return 2.0 * n_active * shape.tokens


def mesh_tag(multi_pod: bool, mesh_shape: Optional[Sequence[int]] = None) -> str:
    """The record's ``mesh``: "16x16", "2x16x16", or the shape given."""
    shape = mesh_shape or (POD2 if multi_pod else POD1)[0]
    return "x".join(str(s) for s in shape)


def chips_of(mesh_shape: Sequence[int]) -> int:
    return int(np.prod(mesh_shape))


def mesh_axes(mesh_shape: Sequence[int]) -> Tuple[str, ...]:
    return POD2[1] if len(mesh_shape) == 3 else POD1[1]


def fake_mesh(mesh_shape: Sequence[int], device="cuda"):
    """A mesh of ``mesh_shape`` over a fake process group of as many ranks
    in this process (rank 0), with its ``DeviceMesh`` on ``device`` made
    outside any fake-tensor mode. The fake group becomes the default
    group; one of another size, which the dry run made, is replaced. A
    real group is left alone: the call raises."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    world = chips_of(mesh_shape)
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run makes its own fake process group; this process "
                               f"already belongs to a {dist.get_backend()!r} group")
        if dist.get_world_size() != world:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    mesh = make_mesh(tuple(mesh_shape), mesh_axes(mesh_shape))
    device_mesh(mesh, device)
    return mesh


def fake_mode():
    """The dry run's ``FakeTensorMode``: real constants the model keeps
    (cached RoPE tables) are taken as fake inputs."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


@contextlib.contextmanager
def sharding_cached():
    """Under a fake-tensor mode DTensor takes itself to be tracing and
    skips its caches of sharding propagation and of redistribution plans
    (they are kept off for symbolic shapes, which the dry run has none
    of): route both through caches for the run. Both are pure functions
    of their specs; uncached, planning a 2 x 16 x 16 mesh's
    redistributions takes tens of ms an op."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import _redistribute
    prop = DTensor._op_dispatcher.sharding_propagator
    plan = _redistribute._gen_transform_infos_non_cached
    prop.propagate_op_sharding_non_cached = prop.propagate_op_sharding
    _redistribute._gen_transform_infos_non_cached = functools.lru_cache(maxsize=None)(plan)
    try:
        yield
    finally:
        del prop.propagate_op_sharding_non_cached       # the class's method again
        _redistribute._gen_transform_infos_non_cached = plan


def _local(t):
    return t._local_tensor if is_dtensor(t) else t


def _leaves(tree):
    if isinstance(tree, torch.nn.Module):
        yield from (p for _, p in tree.named_parameters())
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


def _bytes(tree) -> int:
    return sum(_local(t).numel() * _local(t).element_size() for t in _leaves(tree))


def _storages(tree) -> set:
    return {_local(t).untyped_storage()._cdata for t in _leaves(tree)}


def _host_slabs(opt) -> list:
    """The moment leaves ``--offload on`` counts as host memory: sharded
    ones of at least 1 MiB (global), as the reference's ``_host``."""
    out = []
    for mom in ("mu", "nu"):
        for leaf in _leaves(opt[mom]):
            sharded = is_dtensor(leaf) and any(p.is_shard() for p in leaf.placements)
            if sharded and leaf.numel() * leaf.element_size() >= (1 << 20):
                out.append(leaf)
    return out


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False, *,
               offload: str = "auto", schedule: str = "rect", cfg=None,
               capacity_factor: Optional[float] = None,
               microbatches: Optional[int] = None,
               mesh_shape: Optional[Sequence[int]] = None,
               seq_len: Optional[int] = None, device="cuda"):
    """Build one cell on the fake mesh and run its step once under the
    counter. Returns (counter, info). ``cfg`` replaces the registry's
    config of ``arch``, ``capacity_factor`` the context's MoE capacity
    factor, ``microbatches`` the picked count; ``mesh_shape`` (default
    16 x 16, or 2 x 16 x 16 with ``multi_pod``) sets the fake mesh and
    ``seq_len`` cuts the shape's sequence (a test's cut size)."""
    dev = resolve_device(device)
    cfg = cfg or get_config(arch)
    shape = SHAPES_BY_NAME[shape_name]
    if seq_len is not None:
        shape = dataclasses.replace(shape, seq_len=seq_len)
    # pool-scale strategy (arctic-class): ZeRO-3 sharding + bf16 params +
    # int8 moments + bf16 grad accumulation; ``--offload on`` counts the
    # sharded moment slabs as host memory
    pool_scale = _wants_offload(cfg) and shape.kind == "train"
    optimizer = "adamw_q8" if pool_scale else "adamw"
    if pool_scale:
        cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    mesh_shape = tuple(mesh_shape or (POD2 if multi_pod else POD1)[0])
    t0 = time.perf_counter()
    mesh = fake_mesh(mesh_shape, dev)
    t_mesh = time.perf_counter() - t0
    chips = chips_of(mesh_shape)
    ctx = make_context(cfg, shape, mesh, schedule=schedule)
    if capacity_factor is not None:
        ctx.capacity_factor = capacity_factor
    model = build_model(cfg, ctx, device=dev, kernel_backend="torch")
    dp = int(np.prod([mesh.shape[a] for a in ctx.dp_axes]))

    t0 = time.perf_counter()
    with fake_mode(), sharding_cached():
        params = model.shard(init_params(None, cfg, dev))
        batch = cell_batch(model, shape)
        extra, host = {}, []
        if shape.kind == "train":
            mb = microbatches or _pick_microbatches(cfg, shape, dp)
            init_opt = init_opt_state_q8 if optimizer == "adamw_q8" else init_opt_state
            inputs = {"params": params, "opt": init_opt(params)}
            do_offload = offload == "on"
            host = _host_slabs(inputs["opt"]) if do_offload else []
            step = build_train_step(
                model, AdamWConfig(), microbatches=mb, optimizer=optimizer,
                accum_dtype=torch.bfloat16 if pool_scale else torch.float32)
            run = lambda: step(inputs, batch)
            extra = {"microbatches": mb, "fsdp": ctx.rules.get("param_embed") == "data",
                     "offload": bool(do_offload), "optimizer": optimizer}
        elif shape.kind == "prefill":
            inputs = {"params": params}
            step = build_prefill_step(model)
            run = lambda: step(params, batch)
        else:
            raw_cache = model.cache_struct(shape)
            cache = distribute(raw_cache, cache_placements(ctx, raw_cache), ctx, dev)
            inputs = {"params": params, "cache": cache}
            step = build_decode_step(model)
            run = lambda: step(params, cache, batch)
        t_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        counter, _, memory = count_step(run, [inputs, batch], host)
        t_run = time.perf_counter() - t0
        if "index" in batch:
            # the reference passes the decode index as an int32 scalar array
            memory["argument_bytes"] += 4
            memory["peak_device_bytes"] += 4
    terms = analyze(counter, chips, model_flops_for(cfg, shape))
    info = {
        "arch": arch, "shape": shape_name, "mesh": mesh_tag(multi_pod, mesh_shape),
        "chips": chips, "kind": shape.kind,
        "mesh_s": round(t_mesh, 4), "build_s": round(t_build, 2), "run_s": round(t_run, 2),
        "memory": memory,
        "roofline": terms.to_dict(),
        **extra,
    }
    return counter, info


def cell_batch(model, shape: ShapeSpec):
    """The cell's batch (``Model.batch_struct``) placed by
    ``batch_placements``; a decode batch's ``index`` stays an int."""
    raw = model.batch_struct(shape)
    index = raw.pop("index", None)
    batch = distribute(raw, batch_placements(model.ctx, raw), model.ctx, model.device)
    if index is not None:
        batch["index"] = index
    return batch


def count_step(run, inputs, host=()):
    """Run ``run()`` once under the op counter and a ``MemTracker`` (inside
    the caller's fake-tensor mode). ``inputs`` are the step's arguments,
    ``host`` those of them held in host memory. Returns (counter, the
    step's outputs, the reference's ``memory`` record)."""
    from torch.distributed._tools.mem_tracker import MemTracker
    arg_bytes = _bytes(inputs)
    in_storages = _storages(inputs)
    tracker = MemTracker()
    tracker.track_external(*[_local(t) for t in _leaves(inputs)])
    with OpCounter() as counter, tracker:
        out = run()
    peak = sum(s["Total"] for s in tracker.get_tracker_snapshot("peak").values())
    host_bytes = _bytes(list(host))
    out_leaves = list(_leaves(out))
    out_bytes = _bytes(out_leaves)
    alias = sum(_bytes(t) for t in out_leaves
                if _local(t).untyped_storage()._cdata in in_storages)
    dev_args = arg_bytes - host_bytes
    peak_dev = max(peak - host_bytes, dev_args + out_bytes - alias)
    return counter, out, {
        "argument_bytes": dev_args,
        "output_bytes": out_bytes,
        "temp_bytes": peak_dev - dev_args - out_bytes + alias,
        "alias_bytes": alias,
        "host_argument_bytes": host_bytes,
        "host_temp_bytes": 0,
        "peak_device_bytes": peak_dev,
    }


def run_cell(arch, shape_name, multi_pod, out_dir: Optional[Path], offload="auto",
             schedule="rect", **kw) -> dict:
    """One cell (``kw``: :func:`lower_cell`'s options): its record,
    written to ``out_dir`` when given; an error is recorded with its
    traceback."""
    t0 = time.perf_counter()
    mesh_shape = kw.get("mesh_shape")
    try:
        _, info = lower_cell(arch, shape_name, multi_pod, offload=offload,
                             schedule=schedule, **kw)
        info["status"] = "ok"
    except Exception as e:  # recorded, not silently skipped
        info = {"arch": arch, "shape": shape_name, "mesh": mesh_tag(multi_pod, mesh_shape),
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:]}
    info["seconds"] = round(time.perf_counter() - t0, 2)
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{arch}__{shape_name}.json").write_text(json.dumps(info, indent=2))
    status = info["status"]
    extra = "" if status == "ok" else info["error"][:160]
    print(f"[{info['mesh']}] {arch:24s} {shape_name:12s} {status} "
          f"seconds={info['seconds']} "
          f"bottleneck={info.get('roofline', {}).get('bottleneck', '-')} {extra}",
          flush=True)
    return info


def cells(archs, shape: str = "all"):
    """``(arch, shape, skipped)`` in the order ``main`` runs them: each
    arch's shapes (``cfg.shapes()`` for ``all``), a shape in
    ``cfg.skipped_shapes()`` skipped."""
    out = []
    for arch in archs:
        cfg = get_config(arch)
        names = [s.name for s in cfg.shapes()] if shape == "all" else shape.split(",")
        out += [(arch, name, name in cfg.skipped_shapes()) for name in names]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--offload", default="auto", choices=["auto", "on", "off"])
    ap.add_argument("--schedule", default="rect", choices=["rect", "grouped"])
    ap.add_argument("--device", default="cuda",
                    help="the fake tensors' device (default: cuda; cpu needs no card)")
    ap.add_argument("--out", default=None, metavar="DIR",
                    help="write each cell's record to DIR/<arch>__<shape>.json")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    tag = "pod2" if args.multi_pod else "pod1"
    if args.schedule != "rect":
        tag += f"_{args.schedule}"
    out_dir = Path(args.out) if args.out else None

    n_ok = n_err = n_skip = 0
    for arch, shape_name, skipped in cells(archs, args.shape):
        if skipped:
            print(f"[{tag}] {arch:24s} {shape_name:12s} SKIP "
                  "(full attention; see DESIGN.md §Arch-applicability)", flush=True)
            n_skip += 1
            continue
        info = run_cell(arch, shape_name, args.multi_pod, out_dir, offload=args.offload,
                        schedule=args.schedule, device=args.device)
        n_ok += info["status"] == "ok"
        n_err += info["status"] != "ok"
    print(f"done: ok={n_ok} err={n_err} skip={n_skip}")
    raise SystemExit(1 if n_err else 0)


if __name__ == "__main__":
    main()
