"""TieredBlockPool — the paper's DRAM-cache/prefetch mechanism as a runtime.

Counterpart of ``repro.core.tiering``. Two storage regions hold
fixed-size blocks (KV pages, expert slabs):

* fast region — a device pool of ``fast_blocks`` slots (the "DRAM
  cache"; slot == cache data location, managed by
  :mod:`repro_torch.core.dram_cache` set-associative metadata);
* slow region — the pooled/"FAM" tier holding every block (the source of
  truth), passed to every call.

``access(ids)`` demand-fills misses slow -> fast (eviction via set-LRU),
trains the SPP engine on the block-id stream, arbitrates demand vs
prefetch copies with DWRR and prefetches the predicted blocks, in the JAX
reference's order. Reads then gather from the fast region.
``cfg.kernel_backend`` routes the access, :meth:`probe` and :meth:`read`
through the CUDA kernels ``tier_access``, ``cache_lookup`` and
``block_gather`` (``"cuda"``; their plain versions on CPU tensors) or the
plain versions (``"torch"``).

**In place.** Where JAX returns a new state, the port writes the fast
pool, the side tables, the cache metadata and the SPP tables in place and
returns a state that shares them: the state passed in is consumed.

**The access's two routes.** On the card, ``tier_access`` runs the whole
access up to its final probe in a chain kernel and a copy kernel, with no
host sync. Its plain version, :meth:`TieredBlockPool._access_torch`, is an
eager loop: a masked touch and a masked fill per id replace the
reference's ``cond``, and the DWRR schedule runs on host ints after one
sync per access (:func:`wfq.schedule_batch_host`).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import KERNEL_BACKENDS, FamConfig
from repro_torch.core import dram_cache as dc
from repro_torch.core import spp as spp_lib
from repro_torch.core.wfq import (PREFETCH, WfqState, init_wfq,
                                  schedule_batch_host)
from repro_torch.device import resolve_device
from repro_torch.kernels.block_gather import gather_blocks
from repro_torch.kernels.cache_lookup import tier_access
from repro_torch.kernels.cache_lookup import lookup as cache_lookup

F32, I32, I64 = torch.float32, torch.int32, torch.int64


class TierState(NamedTuple):
    fast: torch.Tensor            # (fast_blocks, block_elems) fast-tier storage
    slot_of_block: torch.Tensor   # (num_blocks,) int32 fast slot or -1
    block_of_slot: torch.Tensor   # (fast_blocks,) int32 resident block or -1
    cache: dc.CacheState          # set-assoc metadata over block ids
    spp: spp_lib.SppState
    wfq: WfqState
    # telemetry
    demand_misses: torch.Tensor
    hits: torch.Tensor
    prefetches: torch.Tensor
    prefetch_hits: torch.Tensor


def _at(t, i):
    """t[i] for a 0-d index tensor, as a (1, ...) tensor (no host sync)."""
    return t.index_select(0, i.to(I64).view(1))


def _put(t, i, value):
    """t[i] = value for a 0-d index tensor, in place (no host sync)."""
    t.index_copy_(0, i.to(I64).view(1), value.reshape((1,) + t.shape[1:]))


class TieredBlockPool:
    """Manager of one tiered pool; methods take and return a TierState."""

    def __init__(self, cfg: FamConfig, num_blocks: int, fast_blocks: int,
                 block_elems: int, *, page_span: int = 16,
                 prefetch_degree: Optional[int] = None,
                 wfq_weight: Optional[int] = None, dtype=torch.bfloat16,
                 device="cuda"):
        if fast_blocks % cfg.cache_ways:
            raise ValueError(f"fast_blocks ({fast_blocks}) must be a multiple of "
                             f"cache_ways ({cfg.cache_ways})")
        self.cfg = cfg
        self.num_blocks = num_blocks
        self.fast_blocks = fast_blocks
        self.block_elems = block_elems
        self.page_span = page_span          # blocks per "page" for SPP
        self.degree = prefetch_degree or cfg.prefetch_degree
        self.weight = cfg.wfq_weight if wfq_weight is None else wfq_weight
        self.dtype = dtype
        self.num_sets = fast_blocks // cfg.cache_ways
        self.device = resolve_device(device)
        # the exact geometry as device tensors, so no cache op converts a
        # Python int (a host-to-device copy) per call
        self._sets = torch.tensor(self.num_sets, dtype=I32, device=self.device)
        self._ways = torch.tensor(cfg.cache_ways, dtype=I32, device=self.device)

    # -- construction -------------------------------------------------------
    def init(self, slow: torch.Tensor) -> TierState:
        if tuple(slow.shape) != (self.num_blocks, self.block_elems):
            raise ValueError(f"slow must be {(self.num_blocks, self.block_elems)}, "
                             f"got {tuple(slow.shape)}")
        if slow.device != self.device:
            raise ValueError(f"slow is on {slow.device}, the pool on {self.device}")
        dev = self.device
        f0 = lambda: torch.zeros((), dtype=F32, device=dev)
        return TierState(
            fast=torch.zeros((self.fast_blocks, self.block_elems), dtype=self.dtype,
                             device=dev),
            slot_of_block=torch.full((self.num_blocks,), -1, dtype=I32, device=dev),
            block_of_slot=torch.full((self.fast_blocks,), -1, dtype=I32, device=dev),
            cache=dc.init_cache(self.num_sets, self.cfg.cache_ways, device=dev),
            spp=spp_lib.init_spp(self.cfg, device=dev), wfq=init_wfq(device=dev),
            demand_misses=f0(), hits=f0(), prefetches=f0(), prefetch_hits=f0())

    # -- internals -----------------------------------------------------------
    def _lookup(self, st: TierState, block_id):
        return dc.lookup(st.cache, block_id, num_sets=self._sets, ways=self._ways)

    def _fill(self, st: TierState, slow: torch.Tensor, block_id, enable):
        """Copy one block slow -> fast, evicting the set-LRU victim, in place.

        ``enable`` masks the written values: with it false every write puts
        back what was there (with no eviction, ``slot_of_block[0]`` is
        rewritten with itself), as in the reference."""
        _, evicted, slot = dc.insert(st.cache, block_id, enable=enable,
                                     num_sets=self._sets, ways=self._ways)
        sob = st.slot_of_block
        ev_idx = evicted.clamp(min=0)
        _put(sob, ev_idx, torch.where(evicted >= 0, -1, _at(sob, ev_idx)))
        _put(sob, block_id, torch.where(enable, slot, _at(sob, block_id)))
        _put(st.block_of_slot, slot,
             torch.where(enable, block_id, _at(st.block_of_slot, slot)))
        data = torch.where(enable, _at(slow, block_id).to(self.dtype),
                           _at(st.fast, slot))
        _put(st.fast, slot, data)

    # -- the demand/prefetch flow (paper Fig. 7) -----------------------------
    def access(self, st: TierState, slow: torch.Tensor, ids: torch.Tensor,
               *, prefetch: bool = True) -> Tuple[TierState, torch.Tensor]:
        """Ensure residency for ``ids`` (K,) and return their fast slots.

        Demand misses fill immediately; then SPP-predicted blocks are
        prefetched subject to DWRR arbitration against the step's demand
        count. ``kernel_backend="torch"``, or ``"cuda"`` on CPU tensors,
        runs that as the plain loop (:meth:`_access_torch`); ``"cuda"`` on
        CUDA tensors launches the ``tier_access`` kernels (never the loop);
        any other device raises."""
        ids = ids.to(I32).contiguous()
        backend = self.cfg.kernel_backend
        if backend not in KERNEL_BACKENDS:
            raise ValueError(f"unknown kernel backend {backend!r}; expected one "
                             f"of {KERNEL_BACKENDS}")
        if backend == "torch" or ids.device.type == "cpu":
            st = self._access_torch(st, slow, ids, prefetch=prefetch)
        elif ids.device.type == "cuda":
            st = self._access_cuda(st, slow, ids, prefetch=prefetch)
        else:
            raise ValueError(f"the tier access runs on cuda or cpu tensors, not "
                             f"{ids.device}")
        hit, _, kslot = self.probe(st, ids)
        # every demand id was just filled, so the metadata probe resolves
        # them all; the side table only backs up a (never-taken) miss
        slots = torch.where(hit, kslot, st.slot_of_block[ids.to(I64)])
        return st, slots

    def _access_cuda(self, st: TierState, slow: torch.Tensor, ids: torch.Tensor,
                     *, prefetch: bool = True) -> TierState:
        """The access up to its final probe through the ``tier_access``
        kernels: the cache, side and SPP tables and the fast tier in place,
        the WFQ state and the counters in new tensors."""
        cfg = self.cfg
        wfq, counters = tier_access(
            st.cache, (st.slot_of_block, st.block_of_slot), st.spp, st.wfq,
            (st.hits, st.demand_misses, st.prefetch_hits, st.prefetches), slow, st.fast,
            ids, page_span=self.page_span, degree=self.degree,
            sig_bits=cfg.spp_signature_bits, threshold=cfg.spp_confidence_threshold,
            weight=self.weight, quantum=cfg.wfq_quantum, max_deficit=cfg.wfq_max_deficit,
            prefetch=prefetch)
        hits, misses, pf_hits, prefetches = counters.unbind()
        return st._replace(wfq=WfqState(*wfq.unbind()), hits=hits, demand_misses=misses,
                           prefetch_hits=pf_hits, prefetches=prefetches)

    def _access_torch(self, st: TierState, slow: torch.Tensor, ids: torch.Tensor,
                      *, prefetch: bool = True) -> TierState:
        """The access up to its final probe as an eager loop: the plain
        version of the ``tier_access`` kernels. ``ids``: (K,) int32."""
        K = ids.shape[0]
        cfg = self.cfg
        misses = []
        for i in range(K):
            bid = ids[i]
            hit, si, way = self._lookup(st, bid)
            dc.touch(st.cache, si, way, enable=hit)
            miss = ~hit
            self._fill(st, slow, bid, miss)
            misses.append(miss)
        misses = torch.stack(misses) if misses else torch.zeros(0, dtype=torch.bool,
                                                                device=ids.device)
        # the reference adds 0/1 per id; integer sums below 2**24 are exact
        # in float32 in any order, so one add per counter is bit-identical
        n_miss = misses.sum()
        n_hit = (K - n_miss).to(F32)
        st = st._replace(hits=st.hits + n_hit,
                         demand_misses=st.demand_misses + n_miss.to(F32),
                         prefetch_hits=st.prefetch_hits + n_hit)

        if prefetch:
            # train SPP on the block stream; "page" = page_span blocks
            pages = ids // self.page_span
            blks = ids % self.page_span
            for i in range(K):
                _, sig = spp_lib.update(cfg, st.spp, pages[i], blks[i])
            cand, valid = spp_lib.predict(cfg, st.spp, pages[-1], blks[-1], sig,
                                          self.degree, bpp=self.page_span)
            cand = cand.clamp(0, self.num_blocks - 1).to(I32)

            # DWRR arbitration: this step's demand copies vs prefetch copies
            n_pf = valid.sum()
            cr, dd, pd, nd, npf = torch.stack(
                [*st.wfq, n_miss.to(I32), n_pf.to(I32)]).tolist()
            (cr, dd, pd), order = schedule_batch_host(
                (cr, dd, pd), nd, npf, weight=self.weight,
                quantum=cfg.wfq_quantum, max_deficit=cfg.wfq_max_deficit,
                r=1, max_issues=self.degree + K)
            granted = order.count(PREFETCH)
            st = st._replace(wfq=WfqState(*torch.tensor(
                [cr, dd, pd], dtype=I32).to(self.device).unbind()))

            ranks = torch.cumsum(valid.to(I32), 0, dtype=I32) - 1
            prefetches = st.prefetches
            for i in range(self.degree):
                bid = cand[i]
                fresh = ~self._lookup(st, bid)[0]
                do = valid[i] & fresh & (ranks[i] < granted)
                self._fill(st, slow, bid, do)
                prefetches = prefetches + do.to(F32)
            st = st._replace(prefetches=prefetches)
        return st

    def probe(self, st: TierState, ids: torch.Tensor):
        """Batched residency probe over the set-assoc metadata (paper Fig. 6:
        hash -> tag row -> compare): (hit, way, slot) per id, slot =
        set * ways + way = the fast-pool data slot."""
        return cache_lookup(st.cache.tags, ids.to(I32).contiguous(),
                            self.cfg.kernel_backend)

    def read(self, st: TierState, slots: torch.Tensor) -> torch.Tensor:
        """Gather blocks from the fast region."""
        return gather_blocks(st.fast, slots.to(I32).contiguous(),
                             self.cfg.kernel_backend)

    def hit_rate(self, st: TierState) -> torch.Tensor:
        total = st.hits + st.demand_misses
        return st.hits / torch.clamp(total, min=1.0)
