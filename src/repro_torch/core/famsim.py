"""Multi-node FAM memory-system simulator (paper §V methodology), in PyTorch.

Counterpart of ``repro.core.famsim``. One LLC-miss event per node per
step, for S independent simulated systems of N nodes at once: every
per-node tensor carries leading ``(S, N)`` dimensions (where JAX vmaps)
and a Python loop over events takes the place of ``lax.scan``. Each step:

  A. (per node) advance the clock, retire completed prefetches into the
     DRAM cache, probe cache and prefetch queue for the demand, train the
     prefetch policy and generate candidates, run the core (stride)
     prefetcher, apply the adaptation policy's issue tokens. All of the
     event's cache work is ONE call of the fused cache step
     (:mod:`repro_torch.kernels.famsim_step`): one CUDA kernel launch for
     all S x N lanes;
  B. (per system) the scheduler policy times the step's demand and
     prefetch arrivals through the FAM controller's service chains;
  C. (per node) latency and IPC accounting, prefetch-queue fills,
     adaptation.

:class:`GroupRunner` drives the step over the events in windows of
:data:`GRAPH_EVENTS`, each step updating fixed carry buffers in place. On
CUDA tensors one window of in-place steps is captured once in a CUDA graph
and replayed for every window, so the host issues one graph launch per
window instead of some 700 kernels per event; on CPU tensors the same
windows run step by step. A ``GroupRunner`` keeps its buffers and graph,
so the executor caches one per runner key and refills it for every group
of that key.

``FamConfig`` gives the shapes (the padded cache allocation, table sizes,
degrees) and the static ``telemetry`` tag (:mod:`repro_torch.obs`: windowed
counters in the carry, a ``"telemetry"`` metric); ``FamParams`` every
per-system value, the effective cache geometry included; a ``PolicySet``
names the policy implementations.
State tensors are updated in place where JAX returns new arrays.

Entry points (:func:`build_sim`, :func:`sweep`, :func:`simulate`) take a
``device`` and default to ``"cuda"``; pass ``device="cpu"`` to run on the
CPU (the cache step then runs its plain version). :func:`build_sweep`'s
runner runs on its traces' device.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.analysis.runtime import (GROUP_RUNNER_NAME, explicit_fetch,
                                          report_capture)
from repro_torch.configs.base import KERNEL_BACKENDS, FamConfig
from repro_torch.core import dram_cache as dc
from repro_torch.core import prefetch_queue as pq
from repro_torch.core.addresses import (PAGE_BITS, dyn_block_addr,
                                        dyn_blocks_per_page, dyn_split)
from repro_torch.core.fam_params import FamParams, stack_params, tree_map
from repro_torch.device import resolve_device
from repro_torch.kernels.famsim_step import (cache_step, fused_cache_step,
                                             fused_replacement_mode)
from repro_torch.obs import telemetry as obs_telemetry
from repro_torch.obs.spans import maybe_span
from repro_torch.policies import DEFAULT_POLICY_SET, PolicySet, SimFlags

__all__ = ["SimFlags", "PolicySet", "NodeState", "build_sim", "build_sweep",
           "sweep", "simulate"]

F32, I32 = torch.float32, torch.int32
FAM_PAGE_MULT = 0x61C88647
#: Events per CUDA graph. 100 divides the fig08 grid's lengths (12,000
#: events, and the 2,000 and 200 of its checks), so no padded event runs there.
GRAPH_EVENTS = 100
#: The last graphed run: events per graph, replays, padded events, the
#: graph's private memory pool in bytes, and the wall seconds of the
#: capture and of the replays (window copies included, synchronised).
last_graph: Dict[str, float] = {}
# step configurations whose kernels a warm-up step has loaded (see _capture)
_warmed = set()


def _resolve(policies: Optional[PolicySet]) -> PolicySet:
    return DEFAULT_POLICY_SET if policies is None else policies


class NodeState(NamedTuple):
    clock: torch.Tensor
    pf: tuple                      # prefetch-policy state (SPP: SppState)
    cache: dc.CacheState
    queue: pq.PrefetchQueue
    throttle: tuple                # adaptation-policy state (ThrottleState)
    core_last: torch.Tensor        # last demand line addr (for stride detect)
    core_stride: torch.Tensor
    core_buf_line: torch.Tensor    # (.., core_fill_entries) line addr +1; 0 empty
    core_buf_fin: torch.Tensor     # fill completion times
    core_buf_ptr: torch.Tensor
    # accumulators
    instr: torch.Tensor
    cycles: torch.Tensor
    fam_lat_sum: torch.Tensor
    fam_cnt: torch.Tensor
    demand_fam: torch.Tensor       # demands to FAM-resident data
    demand_hit: torch.Tensor       # ... that hit the DRAM cache
    corepf_fam: torch.Tensor
    corepf_hit: torch.Tensor
    pf_issued: torch.Tensor        # DRAM-cache prefetches issued to FAM


def _per_node(p: FamParams) -> FamParams:
    """(S,) params -> (S, 1), broadcasting against (S, N) node tensors."""
    return tree_map(lambda t: t.unsqueeze(-1), p)


def _init_node(cfg: FamConfig, p: FamParams, num_nodes: int,
               pad_sets: Optional[int] = None, pad_ways: Optional[int] = None,
               policies: Optional[PolicySet] = None) -> NodeState:
    """Fresh (S, N) node state; ``p`` is the per-node view (fields (S, 1)).
    ``pad_sets``/``pad_ways`` size the cache allocation (>= every effective
    geometry in the batch); default: ``cfg``'s own geometry."""
    impls = _resolve(policies).impls()
    dev = p.base_ipc.device
    B = (p.base_ipc.shape[0], num_nodes)
    f0 = lambda: torch.zeros(B, dtype=F32, device=dev)
    i0 = lambda: torch.zeros(B, dtype=I32, device=dev)
    E = cfg.core_fill_entries
    return NodeState(
        clock=f0(), pf=impls.prefetch.init(cfg, B, dev),
        cache=dc.init_cache(pad_sets or cfg.num_sets, pad_ways or cfg.cache_ways,
                            B, dev),
        queue=pq.init_queue(cfg.prefetch_queue, B, dev),
        throttle=impls.adaptation.init(p, p.policy["adaptation"], B),
        core_last=torch.full(B, -1, dtype=I32, device=dev), core_stride=i0(),
        core_buf_line=torch.zeros(B + (E,), dtype=I32, device=dev),
        core_buf_fin=torch.zeros(B + (E,), dtype=F32, device=dev),
        core_buf_ptr=i0(),
        instr=f0(), cycles=f0(), fam_lat_sum=f0(), fam_cnt=f0(),
        demand_fam=f0(), demand_hit=f0(), corepf_fam=f0(), corepf_hit=f0(),
        pf_issued=f0())


def _is_fam_page(allocation_ratio, page):
    """allocation ratio X => X/(X+1) of pages live in FAM (paper §V-A.4)."""
    mod = allocation_ratio.to(torch.int64) + 1
    return (dc.u32_hash(page, FAM_PAGE_MULT, 16) % mod) != 0


def _phase_a(cfg: FamConfig, p: FamParams, ns: NodeState, addr, gap, warm,
             live, impls):
    """Per-node pre-arbitration work on (S, N) lanes. Returns (ns, req)
    where req carries each node's demand + prefetch candidates. ``live``
    (S, 1) gates every state write, so a non-live step is an exact no-op."""
    pf_pol, ad_pol = p.policy["prefetch"], p.policy["adaptation"]
    repl = impls.replacement.bind(p.policy["replacement"])
    bb = p.block_bits
    S, N = addr.shape
    clock = ns.clock + torch.where(live, gap, 0.0)

    # retire completed prefetches: the C earliest finished, in lax.top_k's
    # order (descending score, lower slot first among ties); the slots are
    # distinct, so the queue drains with one scatter and the sequential
    # part (same-set fills interact) lives in the cache step
    q = ns.queue
    done = (q.block > 0) & (q.finish <= clock[..., None]) & live[..., None]
    score = torch.where(done, -q.finish, -torch.inf)
    idxs = torch.sort(score, stable=True, dim=-1, descending=True).indices[
        ..., :cfg.completions_per_step]
    sel = q.block.gather(-1, idxs)
    fill_blocks = sel - 1
    fill_ok = done.gather(-1, idxs) & (sel > 0)
    q.block.scatter_(-1, idxs, torch.where(fill_ok, 0, sel))

    page, block_in_page = dyn_split(addr, bb)
    gblock = dyn_block_addr(addr, bb)
    is_fam = _is_fam_page(p.allocation_ratio, page) & ~p.all_local & live

    # core-prefetch fill buffer (LLC side): a demand whose line was core-
    # prefetched is served on-chip once the fill lands
    line = addr >> 6
    cb_match = ns.core_buf_line == (line + 1)[..., None]
    cpb_hit = cb_match.any(-1) & p.core_prefetch
    cpb_fin = torch.where(cb_match, ns.core_buf_fin, 0.0).amax(-1)

    # prefetch-policy train + predict (FAM-bound demands train)
    pf_state, ctx = impls.prefetch.train(cfg, pf_pol, ns.pf, page,
                                         block_in_page,
                                         enable=is_fam & p.dram_prefetch)
    bpp = dyn_blocks_per_page(bb)
    cand_gblock, cand_valid = impls.prefetch.predict(
        cfg, pf_pol, pf_state, page, block_in_page, ctx,
        cfg.prefetch_degree, bpp)

    # core (stride) prefetcher target addresses
    stride = line - ns.core_last
    stride_ok = (stride == ns.core_stride) & (stride != 0) & (stride.abs() < 32)
    k = torch.arange(1, cfg.core_pf_degree + 1, dtype=I32, device=addr.device)
    cpf_lines = line[..., None] + stride[..., None] * k
    cpf_pages = cpf_lines >> (PAGE_BITS - 6)
    cpf_fam = _is_fam_page(p.allocation_ratio[..., None], cpf_pages) & \
        ~p.all_local[..., None]
    cpf_valid = stride_ok[..., None] & cpf_fam & \
        (p.core_prefetch & live)[..., None]
    cpf_gblock = cpf_lines >> (bb[..., None] - 6)

    # the event's ENTIRE cache interaction, fused: C fill inserts -> demand
    # probe + touch -> D+CPF pure probes. The demand probe is masked out
    # entirely when DRAM-cache prefetch is off.
    cache, hit, probe_hits = cache_step(
        ns.cache, fill_blocks, fill_ok, gblock, is_fam & p.dram_prefetch,
        torch.cat([cand_gblock, cpf_gblock], -1),
        p.num_sets.expand(S, N).contiguous(),
        p.cache_ways.expand(S, N).contiguous(),
        policy=repl, backend=cfg.kernel_backend)
    D = cfg.prefetch_degree
    cand_hit, cpf_raw_hits = probe_hits[..., :D], probe_hits[..., D:]

    inflight, inflight_fin = pq.contains(q, gblock)
    inflight = inflight & is_fam & ~hit & p.dram_prefetch
    hit = hit & ~cpb_hit
    inflight = inflight & ~cpb_hit
    demand_to_fam = is_fam & ~hit & ~inflight & ~cpb_hit

    cand_inflight = pq.contains(q, cand_gblock)[0]
    fresh = ~cand_hit & ~cand_inflight
    pf_valid = cand_valid & fresh & (is_fam & p.dram_prefetch)[..., None]
    # adaptation: grant tokens for the surviving candidates (the rate
    # controller must not drift on non-live steps)
    want = pf_valid.sum(-1, dtype=I32)
    thr, grant = impls.adaptation.take(p, ad_pol, ns.throttle, want,
                                       impls.adaptation.gate(p) & live)
    rank = pf_valid.cumsum(-1, dtype=I32)
    pf_valid = pf_valid & (rank <= grant[..., None])
    # queue-space gate (§III-A2: drop when the queue is full/threshold)
    free = (q.block == 0).sum(-1, dtype=I32)
    pf_valid = pf_valid & (pf_valid.cumsum(-1, dtype=I32) <= free[..., None])

    # core prefetches may hit the DRAM cache (probed by the cache step)
    cpf_hits = cpf_raw_hits & p.dram_prefetch[..., None]
    cpf_to_fam = cpf_valid & ~cpf_hits
    if cfg.telemetry:
        # telemetry-only signal (repro_torch.obs): prefetch candidates
        # dropped because the block was already cached or in flight; only
        # under the static tag, so the default step launches nothing more
        pf_redundant = (cand_valid & ~fresh &
                        (is_fam & p.dram_prefetch)[..., None]).to(F32).sum(-1)

    ns = ns._replace(clock=clock, pf=pf_state, cache=cache, queue=q,
                     throttle=thr,
                     core_last=torch.where(live, line, ns.core_last),
                     core_stride=torch.where(live & (stride != 0), stride,
                                             ns.core_stride))
    # cpf_lines rides along so phase C fills the buffer with exactly the
    # lines validated here
    req = dict(gblock=gblock, is_fam=is_fam, hit=hit, inflight=inflight,
               inflight_fin=inflight_fin, demand_to_fam=demand_to_fam,
               cpb_hit=cpb_hit, cpb_fin=cpb_fin,
               pf_blocks=cand_gblock, pf_valid=pf_valid, cpf_lines=cpf_lines,
               cpf_valid=cpf_valid, cpf_hits=cpf_hits & cpf_valid,
               cpf_to_fam=cpf_to_fam, gap=gap, warm=warm, live=live)
    if cfg.telemetry:
        req["pf_redundant"] = pf_redundant
    return ns, req


def _phase_c(cfg: FamConfig, p: FamParams, ns: NodeState, req,
             d_fin, pf_fin, cpf_fin, impls):
    """Per-node post-arbitration accounting + queue fills. Returns
    ``(ns, lat)``: the per-event demand latency rides out for the
    telemetry accumulator (unused with telemetry off)."""
    ad_pol = p.policy["adaptation"]
    clock = ns.clock
    local_lat = p.local_mem_latency

    fam_demand_lat = torch.clamp(d_fin - clock, min=1.0)
    lat = torch.where(
        req["cpb_hit"], torch.maximum(req["cpb_fin"] - clock, p.llc_latency),
        torch.where(~req["is_fam"], local_lat,
                    torch.where(req["hit"], local_lat,
                                torch.where(req["inflight"],
                                            torch.maximum(req["inflight_fin"] - clock,
                                                          local_lat),
                                            fam_demand_lat))))

    # fill the prefetch queue with issued prefetches
    queue = ns.queue
    for i in range(cfg.prefetch_degree):
        pq.try_insert(queue, req["pf_blocks"][..., i], pf_fin[..., i], 0.95,
                      enable=req["pf_valid"][..., i])

    fam_miss = req["is_fam"] & ~req["hit"] & ~req["inflight"]
    # record core-prefetch fills (round-robin fill buffer)
    fin = torch.where(req["cpf_hits"], (clock + local_lat)[..., None], cpf_fin)
    buf_line, buf_fin, ptr = ns.core_buf_line, ns.core_buf_fin, ns.core_buf_ptr
    for i in range(cfg.core_pf_degree):
        ok = req["cpf_valid"][..., i]
        pos = ptr.to(torch.int64).unsqueeze(-1)
        old_l = buf_line.gather(-1, pos).squeeze(-1)
        old_f = buf_fin.gather(-1, pos).squeeze(-1)
        buf_line.scatter_(-1, pos, torch.where(
            ok, req["cpf_lines"][..., i] + 1, old_l).unsqueeze(-1))
        buf_fin.scatter_(-1, pos, torch.where(ok, fin[..., i], old_f).unsqueeze(-1))
        ptr = (ptr + ok.to(I32)) % cfg.core_fill_entries

    live = req["live"]
    n_pf = req["pf_valid"].sum(-1, dtype=I32)
    thr = impls.adaptation.observe(p, ad_pol, ns.throttle, lat, fam_miss,
                                   req["hit"], n_pf, enable=live)
    thr = impls.adaptation.adapt(p, ad_pol, thr,
                                 enable=impls.adaptation.gate(p) & live)

    # node-level accounting: per-event compute gaps shrink by 1/cores while
    # one event's stall only blocks one core: stall = lat / (mlp * cores)
    stall = torch.where(live, lat / (p.mlp * p.cores_per_node), 0.0)
    w = req["warm"].to(F32)
    f = lambda b: b.to(F32)
    ns = ns._replace(
        clock=clock + stall, queue=queue, throttle=thr,
        core_buf_line=buf_line, core_buf_fin=buf_fin, core_buf_ptr=ptr,
        instr=ns.instr + w * req["gap"] * p.base_ipc,
        cycles=ns.cycles + w * (req["gap"] + stall),
        fam_lat_sum=ns.fam_lat_sum + w * torch.where(req["is_fam"], lat, 0.0),
        fam_cnt=ns.fam_cnt + w * f(req["is_fam"]),
        demand_fam=ns.demand_fam + w * f(req["is_fam"]),
        demand_hit=ns.demand_hit + w * f(req["hit"]),
        corepf_fam=ns.corepf_fam + w * f(req["cpf_valid"]).sum(-1),
        corepf_hit=ns.corepf_hit + w * f(req["cpf_hits"]).sum(-1),
        pf_issued=ns.pf_issued + w * f(n_pf))
    return ns, lat


def _make_step(cfg: FamConfig, num_nodes: int,
               policies: Optional[PolicySet] = None):
    """The per-event step: step(p, (nodes, fam_busy), (addr, gap, warm,
    live)) -> (nodes, fam_busy), with ``p`` the per-node params view
    (fields (S, 1)), addr/gap (S, N), warm/live (S, 1) and fam_busy (S, 2).
    Validates the configuration when built, not mid-run.

    ``cfg.telemetry`` (a static tag, see :mod:`repro_torch.obs`) extends
    the carry with the windowed-counter accumulator (S, n_windows, C) and
    the inputs with each system's window index (S,) int32:
    step(p, (nodes, fam_busy, tele), (addr, gap, warm, live, win)). With
    the default 0 the step is built exactly as without it."""
    impls = _resolve(policies).impls()
    n_win = cfg.telemetry
    if cfg.kernel_backend not in KERNEL_BACKENDS:
        raise ValueError(f"FamConfig.kernel_backend={cfg.kernel_backend!r}; "
                         f"expected one of {KERNEL_BACKENDS}")
    if cfg.kernel_backend == "cuda":
        fused_replacement_mode(impls.replacement)
    N, D, CPF = num_nodes, cfg.prefetch_degree, cfg.core_pf_degree

    def step(p, carry, inputs):
        if n_win:
            nodes, fam_busy, tele = carry
            addr, gap, warm, live, win = inputs
        else:
            nodes, fam_busy = carry
            addr, gap, warm, live = inputs
        S = addr.shape[0]
        sp = p.policy["scheduler"]
        nodes, req = _phase_a(cfg, p, nodes, addr, gap, warm, live, impls)

        # finite prefetch input queue at the FAM controller: when the
        # prefetch-class backlog exceeds the cap, CXL backpressure stops
        # prefetch issue at the nodes (the scheduler policy owns the gate)
        backlog_ok = impls.scheduler.backlog_ok(p, sp, fam_busy, nodes.clock)
        req["pf_valid"] = req["pf_valid"] & backlog_ok[..., None]
        req["cpf_to_fam"] = req["cpf_to_fam"] & backlog_ok[..., None]

        clock = nodes.clock
        p_arr = torch.cat([clock.repeat_interleave(D, -1),
                           clock.repeat_interleave(CPF, -1)], -1)
        p_valid = torch.cat([req["pf_valid"].reshape(S, N * D),
                             req["cpf_to_fam"].reshape(S, N * CPF)], -1)
        p_bytes = torch.cat([p.block_bytes.expand(S, N * D),
                             p.demand_bytes.expand(S, N * CPF)], -1)
        t = impls.scheduler.arbitrate(p, sp, fam_busy, clock,
                                      req["demand_to_fam"],
                                      p.demand_bytes.expand(S, N),
                                      p_arr, p_valid, p_bytes)
        pf_fin = t.prefetch_finish[:, :N * D].reshape(S, N, D)
        cpf_fin = t.prefetch_finish[:, N * D:].reshape(S, N, CPF)
        nodes, lat = _phase_c(cfg, p, nodes, req, t.demand_finish, pf_fin,
                              cpf_fin, impls)
        if n_win:
            tele = obs_telemetry.accumulate(tele, win, live=live, req=req,
                                            lat=lat, nodes=nodes,
                                            new_busy=t.new_busy)
            return nodes, t.new_busy, tele
        return nodes, t.new_busy

    step.key = (cfg, num_nodes, policies)
    return step


def _init_carry(cfg: FamConfig, p: FamParams, num_nodes: int,
                pad_sets: Optional[int] = None, pad_ways: Optional[int] = None,
                policies: Optional[PolicySet] = None):
    """(nodes, fam_busy), and the zero telemetry windows when
    ``cfg.telemetry``."""
    nodes = _init_node(cfg, p, num_nodes, pad_sets, pad_ways, policies)
    S, dev = p.base_ipc.shape[0], p.base_ipc.device
    busy = torch.zeros((S, 2), dtype=F32, device=dev)
    if cfg.telemetry:
        return nodes, busy, obs_telemetry.init_windows(cfg.telemetry, S, dev)
    return nodes, busy


def _metrics(nodes: NodeState, p: FamParams,
             telemetry: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """(S, N) figures of merit; ``p`` is the per-node params view. With
    ``telemetry`` (S, n_windows, C) also the windowed counters, one
    per-system (node-summed) matrix each, as ``"telemetry"``."""
    out = {
        "ipc": nodes.instr / torch.clamp(nodes.cycles, min=1.0),
        "fam_latency": nodes.fam_lat_sum / torch.clamp(nodes.fam_cnt, min=1.0),
        "demand_hit_fraction": nodes.demand_hit /
            torch.clamp(nodes.demand_fam, min=1.0),
        "corepf_hit_fraction": nodes.corepf_hit /
            torch.clamp(nodes.corepf_fam, min=1.0),
        "prefetches_issued": nodes.pf_issued,
        "issue_rate": nodes.throttle.issue_rate,
        # occupancy over the EFFECTIVE geometry (padded region stays empty)
        "cache_occupancy": dc.occupancy(nodes.cache, p.num_sets, p.cache_ways),
    }
    if telemetry is not None:
        out["telemetry"] = telemetry
    return out


def _leaves(tree):
    """The tensors of a carry (tuples and NamedTuples of tensors), in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [leaf for node in tree for leaf in _leaves(node)]


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    nodes = [_clone(node) for node in tree]
    return type(tree)(*nodes) if hasattr(tree, "_fields") else type(tree)(nodes)


def _in_place(step):
    """``step`` as an update of fixed carry buffers: step_(p, buf, inputs)
    runs one event on ``buf`` and copies each new carry tensor into its
    buffer, so every buffer keeps its storage from event to event (what a
    captured graph replays against). Tensors the step already updated in
    place are its buffers and need no copy."""
    def step_(p, buf, inputs):
        new = step(p, buf, inputs)
        for b, n in zip(_leaves(buf), _leaves(new)):
            if n is not b:
                b.copy_(n)

    return step_


def _capture(step, p, buf, xs, run_window, name=GROUP_RUNNER_NAME):
    """One CUDA graph of ``run_window`` (``len(xs[0])`` in-place steps on
    ``buf``, inputs read from the window buffers ``xs``). Returns (graph,
    kernel launches per event). The capture is reported under ``name``
    (:func:`repro_torch.analysis.runtime.report_capture`; None reports
    nothing).

    The first capture of a step configuration in the process runs one
    in-place step on a side stream first, on the window's first event,
    which is not live (an exact no-op): it loads the kernels the step uses.
    Nothing is launched by the capture itself, so the launches its wrapper
    calls counted, and the warm-up's, are taken back here; the caller
    counts the replayed ones."""
    dev = xs[0].device
    launches = fused_cache_step.launches
    key = (step.key, dev, tuple((t.shape, t.dtype) for t in _leaves(buf) + list(xs)))
    with maybe_span("compile", events=len(xs[0]), lanes=xs[0].shape[1] * xs[0].shape[2]):
        if key not in _warmed:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                _in_place(step)(p, buf, tuple(x[0] for x in xs))
            torch.cuda.current_stream(dev).wait_stream(side)
            _warmed.add(key)
        # the capture's own synchronizes (this one and torch.cuda.graph's)
        # are explicit: they bracket the capture, nothing runs in them
        with explicit_fetch():
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            reserved, t0 = torch.cuda.memory_reserved(dev), time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            before = fused_cache_step.launches
            with torch.cuda.graph(graph):
                run_window()
    per_event = (fused_cache_step.launches - before) // len(xs[0])
    fused_cache_step.launches = launches
    last_graph.update(pool_bytes=torch.cuda.memory_reserved(dev) - reserved,
                      capture_s=time.perf_counter() - t0)
    report_capture(name)
    return graph, per_event


def _window_events(addrs, gaps, warm, live, win, window):
    """The per-event input streams, event-major and padded to whole windows
    with events that are neither live nor warm (exact no-ops); the window
    index, when given, is padded with its last value."""
    pad = -addrs.shape[-1] % window
    events = [addrs.permute(2, 0, 1), gaps.permute(2, 0, 1),
              warm.unsqueeze(-1), live.unsqueeze(-1)]
    events = [torch.cat([x, x.new_zeros((pad,) + x.shape[1:])]) for x in events]
    if win is not None:
        events.append(torch.cat([win, win[-1:].expand((pad,) + win.shape[1:])]))
    return events


def _window_fn(step, p, buf, xs):
    """One window of in-place steps on ``buf``, inputs read from ``xs``."""
    step_ = _in_place(step)

    def run_window():
        for i in range(len(xs[0])):
            step_(p, buf, tuple(x[i] for x in xs))

    return run_window


def _drive(run_window, graph, per_event, xs, events, T):
    """Copy each window's events into ``xs`` and run it: a replay of
    ``graph``, or ``run_window`` step by step when there is none."""
    window = len(xs[0])
    n_windows = len(events[0]) // window
    t0 = time.perf_counter()
    for w in range(n_windows):
        for x, full in zip(xs, events):
            x.copy_(full[w * window:(w + 1) * window])
        if graph is None:
            run_window()
        else:
            graph.replay()
    if graph is not None:
        with explicit_fetch():                 # the reference's block_until_ready
            torch.cuda.synchronize(xs[0].device)
        fused_cache_step.launches += per_event * T
        last_graph.update(events=window, replays=n_windows,
                          padded=n_windows * window - T,
                          replay_s=time.perf_counter() - t0)


def _copy_into(dst, src):
    """Copy every tensor of ``src`` into the tensor at the same place of
    ``dst`` (trees of NamedTuples, tuples and dicts of equal structure),
    in place."""
    if isinstance(dst, torch.Tensor):
        if dst.shape != src.shape or dst.dtype != src.dtype:
            raise ValueError(f"buffer {tuple(dst.shape)} {dst.dtype} cannot take "
                             f"{tuple(src.shape)} {src.dtype}")
        dst.copy_(src)
    elif isinstance(dst, dict):
        if dst.keys() != src.keys():
            raise ValueError(f"buffer keys {sorted(dst)} != {sorted(src)}")
        for k in dst:
            _copy_into(dst[k], src[k])
    else:
        for d, s_ in zip(dst, src, strict=True):
            _copy_into(d, s_)


def _tree_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    nodes = tree.values() if isinstance(tree, dict) else tree
    return sum(_tree_bytes(n) for n in nodes)


class GroupRunner:
    """The dynamic-T runner of one compile group, which owns every tensor
    its steps read or write, so one object serves every group of its
    runner key (:mod:`repro_torch.experiments`' runner cache).

    ``runner(params (S,), addrs (S, N, T_pad), gaps, t_true (S,),
    warm_start (S,))`` simulates the first ``t_true`` events of each
    system; the padded tail steps run with ``live=False`` and are exact
    no-ops, so every metric is bit-identical to an unpadded run of length
    ``t_true``. ``warm_start`` is the first accumulated event,
    ``int(t_true * warmup_frac)`` computed on the host.

    The first call clones the params and the initial carry into buffers
    the runner keeps, with the window input buffers, and on CUDA tensors
    captures one window in a CUDA graph over them (unless ``eager``). Every
    call, the first included, copies its params into the param buffers
    (whose per-node views the steps read), its initial carry (which
    depends on the params: the adaptation and prefetch states) into the
    carry buffers, and each window's events into the input buffers: the
    graph is replayed on the new group's values, and on the CPU the same
    buffers run step by step. Everything else the steps see is computed
    from those buffers (:meth:`drive` runs the events from a given carry).
    A call whose shapes differ from the first raises. ``eager=True`` runs the steps on the card without a graph, for
    comparison. ``name`` is what the runner's capture is reported under
    (:mod:`repro_torch.analysis.runtime`: the executor names each group's
    runner ``famsim_group__<key digest>``; None reports nothing).
    """

    def __init__(self, cfg: FamConfig, num_nodes: int,
                 pad_sets: Optional[int] = None, pad_ways: Optional[int] = None,
                 policies: Optional[PolicySet] = None, *, eager: bool = False,
                 name: Optional[str] = GROUP_RUNNER_NAME):
        self.cfg, self.num_nodes, self.name = cfg, num_nodes, name
        self.pad_sets, self.pad_ways, self.policies = pad_sets, pad_ways, policies
        self.eager, self.window = eager, GRAPH_EVENTS
        self.step = _make_step(cfg, num_nodes, policies)
        self.shape = None
        self.p = self.pn = self.buf = self.xs = None
        self.run_window = self.graph = self.per_event = None
        #: the graph's private memory pool, from the capture's reserved bytes
        self.pool_bytes = 0
        #: calls so far (a cached runner's calls after its first are cache hits)
        self.calls = 0

    def nbytes(self) -> int:
        """Device bytes the runner keeps alive: its buffers and graph pool."""
        if self.buf is None:
            return 0
        return (_tree_bytes(self.p) + _tree_bytes(self.buf) +
                _tree_bytes(self.xs) + self.pool_bytes)

    def count_event(self):
        """The work of one event, as :class:`repro_torch.roofline.op_cost.
        OpCounter` counts it (after a first call): one eager in-place step
        on the runner's buffers over a dead event (neither live nor warm,
        an exact no-op; every event runs the same ops). Its kernel launch
        is taken back from ``fused_cache_step.launches``, as a capture's
        are."""
        from repro_torch.roofline.op_cost import OpCounter
        if self.buf is None:
            raise RuntimeError("count_event needs the runner to have run once")
        dev = self.xs[0].device
        dead = tuple(torch.zeros_like(x[0]) for x in self.xs)
        launches = fused_cache_step.launches
        with torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
            with OpCounter() as counter:
                _in_place(self.step)(self.pn, self.buf, dead)
        fused_cache_step.launches = launches
        return counter

    def __call__(self, p: FamParams, addrs, gaps, t_true, warm_start):
        N, T_pad = addrs.shape[1:]
        cfg, dev = self.cfg, addrs.device
        pn = _per_node(p)
        i = torch.arange(T_pad, device=dev)[:, None]
        live = i < t_true[None, :]
        warm = (i >= warm_start[None, :]) & live
        gaps = gaps.to(F32) / pn.cores_per_node[..., None]   # aggregate stream
        carry = _init_carry(cfg, pn, N, self.pad_sets, self.pad_ways, self.policies)
        win = None
        if cfg.telemetry:
            obs_telemetry.constants(dev)                     # before any capture
            win = obs_telemetry.window_index(i, t_true[None, :], cfg.telemetry)
        buf = self.drive(p, carry, addrs.to(I32), gaps, warm, live, win)
        out = _metrics(buf[0], self.pn, buf[2] if cfg.telemetry else None)
        # the buffers are overwritten by the next call
        return {k: v.clone() for k, v in out.items()}

    def drive(self, p: FamParams, carry, addrs, gaps, warm, live, win=None):
        """Run the events from ``carry``: addrs (S, N, T) int32, gaps
        (S, N, T) float32 (already divided by cores per node), warm/live
        (T, S) bool and, for a telemetry step, ``win`` (T, S) int32, each
        event's telemetry window. Copies ``p`` (stacked, not per node) and
        ``carry`` into the runner's buffers and returns the carry buffers,
        which the next call overwrites."""
        if addrs.shape[1] != self.num_nodes:
            raise ValueError(f"traces have {addrs.shape[1]} nodes, runner built for "
                             f"{self.num_nodes}")
        if self.shape is None:
            self.shape = addrs.shape
            self.p = tree_map(torch.clone, p)
            self.pn = _per_node(self.p)
        elif addrs.shape != self.shape:
            raise ValueError(f"traces {tuple(addrs.shape)}, runner built for "
                             f"{tuple(self.shape)}")
        else:
            _copy_into(self.p, p)
        self.calls += 1
        events = _window_events(addrs, gaps, warm, live, win, self.window)
        if self.buf is None:
            self.buf = _clone(carry)
            self.xs = [torch.zeros_like(x[:self.window]) for x in events]
            self.run_window = _window_fn(self.step, self.pn, self.buf, self.xs)
        else:
            _copy_into(self.buf, carry)
        # the runner's own card is the current device while it captures,
        # steps and replays (kernel launches and graph streams use it)
        on_card = addrs.device.type == "cuda"
        with torch.cuda.device(addrs.device) if on_card else contextlib.nullcontext():
            if on_card and not self.eager and self.graph is None:
                self.graph, self.per_event = _capture(self.step, self.pn, self.buf,
                                                      self.xs, self.run_window, self.name)
                self.pool_bytes = int(last_graph["pool_bytes"])
            _drive(self.run_window, None if self.eager else self.graph, self.per_event,
                   self.xs, events, addrs.shape[-1])
        return self.buf


def _make_run(cfg: FamConfig, num_nodes: int, warmup_frac: float = 0.2,
              pad_sets: Optional[int] = None, pad_ways: Optional[int] = None,
              policies: Optional[PolicySet] = None, eager: bool = False):
    """Batched fixed-T runner: run(params (S,), addrs (S, N, T), gaps
    (S, N, T)) -> metrics dict of (S, N) tensors: a fresh
    :class:`GroupRunner` over all T events (``eager``: see there)."""
    def run(p: FamParams, addrs, gaps):
        S, T = addrs.shape[0], addrs.shape[-1]
        full = lambda v: torch.full((S,), v, dtype=I32, device=addrs.device)
        return GroupRunner(cfg, num_nodes, pad_sets, pad_ways, policies, eager=eager)(
            p, addrs, gaps, full(T), full(int(T * warmup_frac)))

    return run


#: build_sweep's runners: one a (static shape, nodes, warmup, policy tags)
_SWEEP_CACHE: Dict = {}


def build_sweep(cfg: FamConfig, num_nodes: int, warmup_frac: float = 0.2,
                policies: Optional[PolicySet] = None):
    """Batched runner: fn(params_batch, addrs (S, N, T), gaps (S, N, T))
    -> metrics dict of (S, N) tensors, on the traces' device.

    One entry per ``(cfg.static_shape(), num_nodes, warmup_frac, policy
    compile tags)``, as the reference's: every sweep point that only varies
    per-system values (flags, block size, policy numeric params, any cache
    geometry fitting the donor's allocation) reuses it. An entry keeps one
    :class:`GroupRunner` a trace shape and device (the reference's jit
    retraces on a new shape): a later call of that shape refills its
    buffers and, on the card, replays its graph."""
    policies = _resolve(policies)
    key = (cfg.static_shape(), num_nodes, warmup_frac, policies.compile_tags())
    if key not in _SWEEP_CACHE:
        runners: Dict = {}

        def run(params_batch: FamParams, addrs, gaps):
            S, T = addrs.shape[0], addrs.shape[-1]
            shape = (tuple(addrs.shape), addrs.device)
            if shape not in runners:
                runners[shape] = GroupRunner(cfg, num_nodes, policies=policies)
            full = lambda v: torch.full((S,), v, dtype=I32, device=addrs.device)
            return runners[shape](params_batch, addrs, gaps, full(T),
                                  full(int(T * warmup_frac)))

        _SWEEP_CACHE[key] = run
    return _SWEEP_CACHE[key]


def build_sim(cfg: FamConfig, flags: SimFlags, num_nodes: int,
              policies: Optional[PolicySet] = None, device="cuda"):
    """Returns run(addrs (N, T), gaps (N, T), warmup_frac=0.2) -> metrics
    dict of (N,) tensors: the one-system entry point, the same program as
    :func:`sweep` with S = 1."""
    dev = resolve_device(device)
    p = stack_params([FamParams.of(cfg, flags, policies, device=dev)])

    def run(addrs, gaps, warmup_frac: float = 0.2):
        addrs = torch.as_tensor(addrs, device=dev)[None]
        gaps = torch.as_tensor(gaps, device=dev)[None]
        out = _make_run(cfg, num_nodes, warmup_frac,
                        policies=policies)(p, addrs, gaps)
        return {k: v[0] for k, v in out.items()}

    return run


def sweep(cfg: FamConfig, params_batch: FamParams, flags: Optional[SimFlags],
          addrs, gaps, warmup_frac: float = 0.2,
          policies: Optional[PolicySet] = None,
          device="cuda") -> Dict[str, torch.Tensor]:
    """Run S independent simulated systems at once.

    cfg: shape donor — every system shares ``cfg.geometry_free_shape()``
        and its effective cache geometry must fit inside the donor's
        allocation (``num_sets``, ``cache_ways``); block size is per system.
    params_batch: ``FamParams`` with leading axis S (``stack_params``).
    flags: optional ``SimFlags`` applied to all S systems; ``None`` keeps
        the flags already in ``params_batch``.
    addrs/gaps: (S, N, T) per-system node traces (numpy or tensors).

    Returns the metrics dict with (S, N) tensors on ``device``.
    """
    dev = resolve_device(device)
    if flags is not None:
        params_batch = params_batch.with_flags(flags)
    params_batch = tree_map(lambda t: t.to(dev), params_batch)
    for field, cap in (("num_sets", cfg.num_sets),
                       ("cache_ways", cfg.cache_ways)):
        eff = getattr(params_batch, field)
        if bool((eff > cap).any()):
            raise ValueError(
                f"params_batch effective {field} (max {int(eff.max())}) "
                f"exceeds the donor's padded allocation ({cap}); build the "
                "donor from the max swept geometry")
    addrs = torch.as_tensor(addrs, device=dev)
    gaps = torch.as_tensor(gaps, device=dev)
    N = addrs.shape[1]
    return _make_run(cfg, N, warmup_frac, policies=policies)(
        params_batch, addrs, gaps)


def simulate(cfg: FamConfig, flags: SimFlags, workload_names, T: int = 60_000,
             seed: int = 0, trace_backend: str = "numpy",
             policies: Optional[PolicySet] = None,
             device="cuda") -> Dict[str, np.ndarray]:
    """Generate the node traces and run one system. The default trace
    backend is ``"numpy"``, as in the reference; ``"device"`` generates
    them with the threefry generator on ``device``."""
    from repro_torch.traces.backend import system_traces
    addrs, gaps = system_traces(workload_names, T, seed, backend=trace_backend,
                                device=device)
    run = build_sim(cfg, flags, len(workload_names), policies=policies,
                    device=device)
    return {k: v.cpu().numpy() for k, v in run(addrs, gaps).items()}
