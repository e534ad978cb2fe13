"""Per-op cost of a torch program, counted as it runs.

Counterpart of ``repro.roofline.hlo_parse``: the reference parses the
compiled HLO text of a step and charges each instruction by a cost model,
multiplying ``while`` bodies by their known trip counts. The port has no
compiled module to parse, so :class:`OpCounter`, a ``TorchDispatchMode``,
charges each aten op as it dispatches, by the same cost model
(``hlo_parse.py:209-251``):

    dot-like ops        flops = 2 * result elements * contracted size
    (mm, bmm, addmm,    bytes = operands + result
     baddbmm, SDPA)
    index / gather /    bytes = 2 * result + indices
    index_select / embedding
    index_put / scatter bytes = 2 * updates + indices + result
    views, detach,      0
    aliases, empty
    collectives         bytes = operands + result, and the operand bytes
                        tallied per kind (all-reduce, all-gather,
                        reduce-scatter, all-to-all, collective-permute)
    everything else     bytes = operands + result

A Python loop is counted as it runs, so a loop's trip count multiplies
its body for free, as ``analyze_hlo``'s ``known_trip_count`` does.

Per-device terms need the local ops only. On DTensors the counter lets
the DTensor-level op pass (it returns ``NotImplemented``, as
``MemTracker`` does) and counts the local ops it turns into; DTensor's
own bookkeeping, sharding propagation (which runs each op once more on
fake tensors of the global shape to learn the output's metadata) and the
shards' offsets, runs with every dispatch mode switched off
(:func:`dtensor_bookkeeping_unobserved`), so neither the global "shadow"
ops nor their index tensors are counted, and a fake-tensor run never
meets their ``tolist()``.

Work a dispatch mode cannot see is charged by hand: a kernel called
through ``ctypes`` calls :func:`charge` when :func:`active` finds a
counter (the wrappers of ``fused_cache_step`` and ``flash_attention``
do), and runs its plain version on CPU tensors under :func:`uncounted`,
so a count reads the same work whatever implements it. A CUDA-graph
replay launches nothing a mode sees: count an eager window, or the
capture, and multiply by the replays.

``flops_once`` / ``bytes_once`` are the cross-check the reference keeps
from XLA's ``cost_analysis()``: ``torch.utils.flop_counter``'s
``FlopCounterMode`` formulas over the same (local) ops, and, since that
counter counts no bytes, operands + result of every op that is not a
view.
"""
from __future__ import annotations

import contextlib
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import torch
from torch.utils._python_dispatch import (TorchDispatchMode, _disable_current_modes,
                                          _get_current_dispatch_mode_stack)

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                  "collective-permute")

#: the chunk of the ``"torch"`` backend's attention (``ParallelContext.attn_chunk``)
ATTN_CHUNK = 512

_aten = torch.ops.aten
# dot-like ops: (index of the left operand, index of its contracted dim)
_DOTS = {
    _aten.mm.default: (0, -1), _aten.bmm.default: (0, -1),
    _aten.addmm.default: (1, -1), _aten.baddbmm.default: (1, -1),
    _aten.mv.default: (0, -1), _aten.dot.default: (0, -1),
    _aten.addmv.default: (1, -1),
}
_SDPA = ("_scaled_dot_product_flash_attention", "_scaled_dot_product_efficient_attention",
         "_scaled_dot_product_cudnn_attention", "_scaled_dot_product_flash_attention_for_cpu")
_GATHERS = ("index", "gather", "index_select", "embedding")
_SCATTERS = ("index_put", "index_put_", "_index_put_impl_", "scatter", "scatter_",
             "scatter_add", "scatter_add_", "scatter_reduce", "scatter_reduce_",
             "index_add", "index_add_", "index_copy", "index_copy_")
_FREE = ("detach", "alias", "lift_fresh", "_unsafe_view", "empty", "empty_like",
         "empty_strided", "new_empty", "new_empty_strided", "_local_scalar_dense",
         "sym_size", "sym_stride", "sym_numel", "sym_storage_offset", "is_contiguous",
         "is_same_size", "is_nonzero", "_has_compatible_shallow_copy_type")
# collectives by op name (the c10d_functional ops of DTensor and the c10d
# ops of torch.distributed): (kind, index of the operand argument) or None
# for the ops that move nothing of their own (wait, the receiving side)
_COLLECTIVES = {
    "all_reduce": ("all-reduce", 0), "all_reduce_": ("all-reduce", 0),
    "all_reduce_coalesced": ("all-reduce", 0), "all_reduce_coalesced_": ("all-reduce", 0),
    "allreduce_": ("all-reduce", 0), "allreduce_coalesced_": ("all-reduce", 0),
    "all_gather_into_tensor": ("all-gather", 0),
    "all_gather_into_tensor_out": ("all-gather", 0),
    "all_gather_into_tensor_coalesced": ("all-gather", 0),
    "allgather_": ("all-gather", 1), "_allgather_base_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "allgather_coalesced_": ("all-gather", 1),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "reduce_scatter_": ("reduce-scatter", 1), "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "all_to_all_single": ("all-to-all", 0), "all_to_all": ("all-to-all", 0),
    "alltoall_base_": ("all-to-all", 1), "alltoall_": ("all-to-all", 1),
    "send": ("collective-permute", 0), "broadcast": ("all-gather", 0),
    "broadcast_": ("all-gather", 0),
    "wait_tensor": None, "recv_": None, "recv_any_source_": None, "barrier": None,
    "monitored_barrier_": None,
}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "_c10d_functional_autograd")


def _tensors(x) -> List[torch.Tensor]:
    """The tensors in an argument (a tensor, or a list / tuple of them,
    nested)."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in _tensors(item)]
    return []


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(x))


@dataclass
class OpCost:
    """Flops, bytes and collective bytes / counts per kind: the fields of
    ``hlo_parse.OpCost``."""

    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: Dict[str, float] = field(default_factory=dict)
    coll_count: Dict[str, float] = field(default_factory=dict)

    def add(self, other: "OpCost", mult: float = 1.0):
        self.flops += other.flops * mult
        self.bytes += other.bytes * mult
        for k, v in other.coll_bytes.items():
            self.coll_bytes[k] = self.coll_bytes.get(k, 0.0) + v * mult
        for k, v in other.coll_count.items():
            self.coll_count[k] = self.coll_count.get(k, 0) + v * mult

    @property
    def collective_bytes(self) -> float:
        return sum(self.coll_bytes.values())


def _dot_flops(func, args, out) -> float:
    lhs_i, contract = _DOTS[func]
    lhs = args[lhs_i]
    return 2.0 * out.numel() * lhs.shape[contract]


def _sdpa_flops(args) -> float:
    """q (B, H, Sq, D) against k (B, Hk, Sk, D) and v (B, Hk, Sk, Dv): the
    two dots q.k and p.v at q's heads."""
    q, k, v = args[:3]
    rows = q.numel() // q.shape[-1]                  # B * H * Sq
    return 2.0 * rows * k.shape[-2] * (q.shape[-1] + v.shape[-1])


def op_cost(func, args, kwargs, out) -> Tuple[OpCost, bool]:
    """(cost of one aten op by the cost model above, whether the
    cross-check leaves it out: views, allocations and collectives)."""
    c = OpCost()
    name = func._schema.name.split("::")[-1]
    namespace = func.namespace
    if namespace in _COLLECTIVE_NAMESPACES and name in _COLLECTIVES:
        rule = _COLLECTIVES[name]
        if rule is not None:
            kind, i = rule
            operand = _nbytes(args[i]) if len(args) > i else 0
            c.bytes = operand + _nbytes(out)
            c.coll_bytes[kind] = float(operand)
            c.coll_count[kind] = 1
        return c, True
    if func.is_view or name in _FREE or not _tensors(out):
        return c, True
    operands = _nbytes(list(args) + list(kwargs.values()))
    result = _nbytes(out)
    if func in _DOTS:
        c.flops = _dot_flops(func, args, out)
        c.bytes = operands + result
    elif name in _SDPA:
        c.flops = _sdpa_flops(args)
        c.bytes = operands + result
    elif name in _GATHERS:
        # the indices: every operand but the source (embedding: weight first)
        c.bytes = 2 * result + _nbytes(list(args[1:]) + list(kwargs.values()))
    elif name in _SCATTERS:
        if name.startswith(("index_put", "_index_put")):
            indices, updates = args[1], args[2]
        else:                                    # (self, dim, index, src, ...)
            indices, updates = args[2], args[3] if len(args) > 3 else None
        c.bytes = 2 * _nbytes(updates) + _nbytes(indices) + result
    else:
        c.bytes = operands + result
        if name == "convolution":
            c.flops = 2.0 * out.numel()          # the reference's conservative floor
    return c, False


@contextlib.contextmanager
def dtensor_bookkeeping_unobserved():
    """Run DTensor's sharding propagation and its shard offset arithmetic
    (a strided shard's offsets, a shard's global offset) with every
    dispatch mode off (the counter, a memory tracker, a fake-tensor mode):
    what they compute is metadata, not work of the program. Re-entrant;
    restores every attribute on exit. Does nothing when DTensor has not
    been imported."""
    if "torch.distributed.tensor" not in sys.modules:
        yield
        return
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor import _utils as dt_utils
    from torch.distributed.tensor import placement_types as pt
    prop = DTensor._op_dispatcher.sharding_propagator
    targets = [(prop, "propagate_op_sharding"), (prop, "propagate_op_sharding_non_cached"),
               (dt_utils, "_compute_local_shape_and_global_offset")]
    strided = getattr(pt, "_StridedShard", None)
    if strided is not None:
        targets += [(strided, n) for n in ("local_shard_size_and_offset",
                                           "_local_shard_size_and_offset")
                    if n in vars(strided)]
    undo = []
    for owner, name in targets:
        raw = vars(owner).get(name)             # None: the class's method
        fn = getattr(owner, name, None)
        if fn is None or getattr(fn, "_unobserved", False):
            continue
        run = _with_modes_off(fn)
        setattr(owner, name, staticmethod(run) if isinstance(raw, staticmethod) else run)
        undo.append((owner, name, raw))
    try:
        yield
    finally:
        for owner, name, raw in reversed(undo):
            if raw is None:
                delattr(owner, name)
            else:
                setattr(owner, name, raw)


def _with_modes_off(fn):
    def run(*args, **kwargs):
        with _disable_current_modes():
            return fn(*args, **kwargs)
    run._unobserved = True
    return run


class OpCounter(TorchDispatchMode):
    """Counts the local aten ops run inside it (``with OpCounter() as c``).

    ``cost`` is the total :class:`OpCost`; ``charges`` maps each name given
    to :meth:`charge` to ``[flops, bytes, calls]`` (included in ``cost``);
    ``flops_once`` / ``bytes_once`` are the cross-check (module
    docstring); ``ops`` counts the ops seen, by overload."""

    def __init__(self):
        super().__init__()
        self.cost = OpCost()
        self.charges: Dict[str, List[float]] = {}
        self.ops: Dict[object, int] = {}
        self.flops_once = 0.0
        self.bytes_once = 0.0
        self._paused = 0
        self._stack = None
        self._flop_counter = None

    def __enter__(self):
        from torch.utils.flop_counter import FlopCounterMode
        self._flop_counter = FlopCounterMode(display=False)
        self._stack = contextlib.ExitStack()
        self._stack.enter_context(dtensor_bookkeeping_unobserved())
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._stack.close()
            self.flops_once = float(self._flop_counter.get_total_flops())

    def charge(self, name: str, flops: float, nbytes: float) -> None:
        """Add work this mode cannot see (a kernel called through ctypes);
        the cross-check (``flops_once`` / ``bytes_once``) covers the
        dispatched ops only."""
        if self._paused:
            return
        self.cost.flops += flops
        self.cost.bytes += nbytes
        rec = self.charges.setdefault(name, [0.0, 0.0, 0])
        rec[0] += flops
        rec[1] += nbytes
        rec[2] += 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        # by name: DTensor's module need not be imported
        if any(t.__name__ == "DTensor" for t in types):
            return NotImplemented              # count the local ops it runs
        out = func(*args, **kwargs)
        if not self._paused:
            cost, free = op_cost(func, args, kwargs, out)
            self.cost.add(cost)
            self.ops[func] = self.ops.get(func, 0) + 1
            if not free:
                self.bytes_once += cost.bytes
                self._flop_counter._count_flops(func._overloadpacket, out, args, kwargs)
        return out


def active() -> List[OpCounter]:
    """The counters active in this thread, outermost first."""
    return [m for m in _get_current_dispatch_mode_stack() if isinstance(m, OpCounter)]


def charge(name: str, flops: float, nbytes: float) -> None:
    """Charge every active counter (see :meth:`OpCounter.charge`)."""
    for counter in active():
        counter.charge(name, flops, nbytes)


@contextlib.contextmanager
def uncounted():
    """Pause every active counter: a kernel's plain version on CPU tensors
    runs here after its wrapper charged the kernel's cost."""
    counters = active()
    for c in counters:
        c._paused += 1
    try:
        yield
    finally:
        for c in counters:
            c._paused -= 1


def tensor_bytes(*tensors) -> int:
    """Bytes of the tensors given (lists / tuples flattened)."""
    return _nbytes(list(tensors))


def attention_cost(q_shape: Sequence[int], k_shape: Sequence[int], itemsize: int,
                   chunk: int = ATTN_CHUNK) -> Tuple[float, float]:
    """(flops, bytes) charged to one tiled-attention call of q (B, Sq, Hq,
    D) over k / v (B, Sk, Hkv, D): the flops are the two dots of the
    ``"torch"`` backend's attention at the same shapes (full attention for
    Sq <= chunk, else query chunks over the whole key range, queries
    padded to a whole chunk: the "rect" program computes every tile, so a
    causal call costs as much as an unmasked one), 4 * B * Hq * Sq' * Sk *
    D; the bytes are q, k, v and the output, read or written once."""
    B, Sq, Hq, D = q_shape
    Sk, Hkv = k_shape[1], k_shape[2]
    rows = Sq if Sq <= chunk else -(-Sq // chunk) * chunk
    flops = 4.0 * B * Hq * rows * Sk * D
    nbytes = itemsize * (2 * B * Sq * Hq * D + 2 * B * Sk * Hkv * D)
    return flops, float(nbytes)
