"""CUDA wrappers for the tier's metadata: the batched set-associative
cache lookup and the whole access.

:func:`cache_lookup` launches ``csrc/cache_lookup.cu`` (one warp per query)
on CUDA tensors and runs the plain version (:func:`ref.cache_lookup_ref`)
on CPU tensors. It replaces the TPU kernel ``cache_lookup`` of
``repro.kernels.cache_lookup.kernel``.

:func:`tier_access` launches ``csrc/tier_access.cu`` (a chain kernel for
every probe, touch, fill, SPP step and DWRR cycle of one
``TieredBlockPool.access``, then a copy kernel for the filled blocks) on
the tier's tensors and geometry. It takes CUDA tensors only: the access's
plain version is the pool's own loop (``TieredBlockPool._access_torch``),
which the pool runs on CPU tensors. With the batched probe after it, it
replaces the TPU kernel and the scans around it in
``repro.core.tiering.TieredBlockPool.access``.

Both sources are built at first use by :mod:`repro_torch.kernels.nvcc`.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.cache_lookup.ref import cache_lookup_ref

SOURCE = Path(__file__).with_name("csrc") / "cache_lookup.cu"

_entry = nvcc.CudaEntry(SOURCE, "cache_lookup",
                        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p])
build = _entry.build

ACCESS_SOURCE = Path(__file__).with_name("csrc") / "tier_access.cu"
MAX_WAYS = 32                   # kMaxWays: lane = way in one warp
MAX_DEGREE = 32                 # kMaxDegree
MAX_SHARED_BYTES = 47 * 1024    # kMaxSharedBytes in the source
# fill copies (copy_kind in the source): same type in 16-byte units or
# bytes; float32 -> bfloat16 four elements at a time or one
COPY_KINDS = {"vector": 0, "bytes": 1, "bf16x4": 2, "bf16": 3}

_access_entry = nvcc.CudaEntry(
    ACCESS_SOURCE, "tier_access",
    [ctypes.c_void_p] * 21 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
    + [ctypes.c_void_p] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 9
    + [ctypes.c_float] + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def cache_lookup(tags, queries):
    """tags: (sets, ways) int32, +1 encoded; queries: (K,) int32.

    Returns (hit (K,) bool, way (K,) int32, slot (K,) int32), the values of
    :func:`ref.cache_lookup_ref`. CUDA tensors launch the kernel (counted
    in ``cache_lookup.launches``); CPU tensors run the plain version."""
    nvcc.check_tensor("tags", tags, torch.int32, (None, None), None)
    dev = tags.device
    nvcc.check_tensor("queries", queries, torch.int32, (None,), dev)
    sets, ways = tags.shape
    if sets == 0 or ways == 0:
        raise ValueError(f"tags must have at least one set and way, got {tuple(tags.shape)}")
    if dev.type == "cpu":
        return cache_lookup_ref(tags, queries)
    if dev.type != "cuda":
        raise ValueError(f"cache_lookup runs on cuda or cpu tensors, not {dev}")
    K = queries.shape[0]
    hit = torch.empty(K, dtype=torch.bool, device=dev)
    way = torch.empty(K, dtype=torch.int32, device=dev)
    slot = torch.empty(K, dtype=torch.int32, device=dev)
    if K:
        _entry(tags.data_ptr(), queries.data_ptr(), hit.data_ptr(),
               way.data_ptr(), slot.data_ptr(), K, sets, ways, nvcc.stream(dev))
        cache_lookup.launches += 1
    return hit, way, slot


cache_lookup.launches = 0


def access_shared_bytes(sets, ways, K):
    """Dynamic shared memory of one chain launch, as the source lays it
    out: the tag and lru rows and seven ints per id, rounded to 16 bytes,
    then one byte per slot for the fill flags, rounded to 16 bytes."""
    return 4 * (-(-(2 * sets * ways + 7 * K) // 4) * 4) + -(-sets * ways // 16) * 16


def access_layout(sets, ways, K, degree):
    """Shared bytes of one chain launch. Raises ValueError for a geometry
    the kernel cannot hold: more ways than a warp has lanes, a prefetch
    degree above MAX_DEGREE, or tag and lru rows and ids beyond the
    card's shared memory. The SPP tables stay in device memory, so their
    size sets no limit."""
    if ways > MAX_WAYS:
        raise ValueError(f"tier_access holds a set's ways in one warp: at most "
                         f"{MAX_WAYS} ways, got {ways}")
    if degree > MAX_DEGREE:
        raise ValueError(f"tier_access takes a prefetch degree of at most "
                         f"{MAX_DEGREE}, got {degree}")
    smem = access_shared_bytes(sets, ways, K)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"tier_access needs {smem} B of shared memory for {sets} x "
                         f"{ways} tag and lru rows and {K} ids, more than "
                         f"{MAX_SHARED_BYTES}")
    return smem


def copy_path(slow, fast):
    """(kind, units per row) of the fill copy from ``slow`` to ``fast``
    rows: 16-byte units where both rows allow them, else bytes; float32 ->
    bfloat16 four elements at a time where aligned, else one."""
    E = slow.shape[1]
    if slow.dtype == fast.dtype:
        row = E * slow.element_size()
        if row % 16 == 0 and slow.data_ptr() % 16 == 0 and fast.data_ptr() % 16 == 0:
            return "vector", row // 16
        return "bytes", row
    if slow.dtype == torch.float32 and fast.dtype == torch.bfloat16:
        if E % 4 == 0 and slow.data_ptr() % 16 == 0 and fast.data_ptr() % 8 == 0:
            return "bf16x4", E // 4
        return "bf16", E
    raise TypeError(f"tier_access copies {slow.dtype} -> {fast.dtype} blocks: only "
                    f"the same type or float32 -> bfloat16")


def tier_access(cache, side, spp, wfq, counters, slow, fast, ids, *, page_span, degree,
                sig_bits, threshold, weight, quantum, max_deficit, prefetch=True):
    """One tier access up to its final probe, on CUDA tensors: the chain
    kernel, then the copy kernel, counted once in ``tier_access.launches``,
    with no host sync. Its plain version is
    ``repro_torch.core.tiering.TieredBlockPool._access_torch``, which the
    pool runs for tensors on the CPU; any other device raises here.

    Tensors (int32 unless named), written in place where marked:
      cache: (tags (sets, ways), lru (sets, ways), stamp ()), in place;
      side: (slot_of_block (num_blocks,), block_of_slot (sets * ways,)),
        in place;
      spp: (st_tag, st_last, st_sig (ST,), pt_delta, pt_weight (PT, 4),
        pt_sigw (PT,)), in place;
      wfq: (current_round, demand_deficit, prefetch_deficit), each ();
      counters: (hits, demand_misses, prefetch_hits, prefetches), float32 ();
      slow: (num_blocks, E); fast: (sets * ways, E), in place, float32 ->
        bfloat16 or one type (:func:`copy_path`);
      ids: (K,).
    Scalars: blocks per SPP page, prefetch degree, SPP signature bits and
    confidence threshold, DWRR weight, quantum and deficit cap.

    Returns (wfq (3,) int32, counters (4,) float32): the new WFQ state and
    counters, in the orders above."""
    tags, lru, stamp = cache
    slot_of_block, block_of_slot = side
    nvcc.check_tensor("ids", ids, torch.int32, (None,), None)
    dev = ids.device
    if dev.type != "cuda":
        raise ValueError(f"tier_access launches on cuda tensors, not {dev}; the plain "
                         f"version is TieredBlockPool._access_torch")
    nvcc.check_tensor("tags", tags, torch.int32, (None, None), dev)
    (sets, ways), K = tags.shape, ids.shape[0]
    nb, E = slot_of_block.shape[0], slow.shape[-1]
    ST, PT = spp[0].shape[0], spp[5].shape[0]
    if sets == 0 or ways == 0 or nb == 0:
        raise ValueError(f"tier_access needs at least one set, way and block, got "
                         f"{sets} x {ways} and {nb} blocks")
    if prefetch and K == 0:
        raise ValueError("tier_access with prefetch needs at least one id")
    smem = access_layout(sets, ways, K, degree)
    i32, f32 = torch.int32, torch.float32
    for name, t, shape, dtype in (
            ("lru", lru, (sets, ways), i32), ("stamp", stamp, (), i32),
            ("slot_of_block", slot_of_block, (nb,), i32),
            ("block_of_slot", block_of_slot, (sets * ways,), i32),
            ("slow", slow, (nb, E), None), ("fast", fast, (sets * ways, E), None),
            *((n, x, shape, i32) for n, x, shape in zip(
                ("st_tag", "st_last", "st_sig", "pt_delta", "pt_weight", "pt_sigw"), spp,
                ((ST,), (ST,), (ST,), (PT, 4), (PT, 4), (PT,)))),
            *((f"wfq[{j}]", x, (), i32) for j, x in enumerate(wfq)),
            *((f"counters[{j}]", x, (), f32) for j, x in enumerate(counters))):
        nvcc.check_tensor(name, t, dtype, shape, dev)
    kind, units = copy_path(slow, fast)
    max_fills = min(K + (degree if prefetch else 0), sets * ways)
    counters_out = torch.empty(4, dtype=f32, device=dev)
    wfq_out = torch.empty(3, dtype=i32, device=dev)
    fills = torch.empty(1 + max_fills, dtype=i32, device=dev)
    ptr = lambda ts: [t.data_ptr() for t in ts]
    _access_entry(
        *ptr((tags, lru, stamp, slot_of_block, block_of_slot, *spp, *wfq, wfq_out,
              *counters, counters_out, ids)),
        K, fills.data_ptr(), max_fills, slow.data_ptr(), fast.data_ptr(), units,
        COPY_KINDS[kind], sets, ways, nb, page_span, degree, ST, PT, sig_bits, threshold,
        weight, quantum, max_deficit, int(prefetch), nvcc.stream(dev))
    tier_access.launches += 1
    return wfq_out, counters_out


tier_access.launches = 0
