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

``FamConfig`` gives the shapes (the padded cache allocation, table sizes,
degrees); ``FamParams`` every per-system value, the effective cache
geometry included; a ``PolicySet`` names the policy implementations.
State tensors are updated in place where JAX returns new arrays.

Entry points (:func:`build_sim`, :func:`sweep`, :func:`simulate`) take a
``device`` and default to ``"cuda"``; pass ``device="cpu"`` to run on the
CPU (the cache step then runs its plain version).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import KERNEL_BACKENDS, FamConfig
from repro_torch.core import dram_cache as dc
from repro_torch.core import prefetch_queue as pq
from repro_torch.core.addresses import (PAGE_BITS, dyn_block_addr,
                                        dyn_blocks_per_page, dyn_split)
from repro_torch.core.fam_params import FamParams, stack_params, tree_map
from repro_torch.kernels.famsim_step import cache_step, fused_replacement_mode
from repro_torch.policies import DEFAULT_POLICY_SET, PolicySet, SimFlags

__all__ = ["SimFlags", "PolicySet", "NodeState", "build_sim", "sweep",
           "simulate"]

F32, I32 = torch.float32, torch.int32
FAM_PAGE_MULT = 0x61C88647


def _resolve(policies: Optional[PolicySet]) -> PolicySet:
    return DEFAULT_POLICY_SET if policies is None else policies


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA device is available; "
                           "pass device='cpu' to run on the CPU")
    return dev


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
    return ns, req


def _phase_c(cfg: FamConfig, p: FamParams, ns: NodeState, req,
             d_fin, pf_fin, cpf_fin, impls) -> NodeState:
    """Per-node post-arbitration accounting + queue fills."""
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
    return ns._replace(
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


def _make_step(cfg: FamConfig, num_nodes: int,
               policies: Optional[PolicySet] = None):
    """The per-event step: step(p, (nodes, fam_busy), (addr, gap, warm,
    live)) -> (nodes, fam_busy), with ``p`` the per-node params view
    (fields (S, 1)), addr/gap (S, N), warm/live (S, 1) and fam_busy (S, 2).
    Validates the configuration when built, not mid-run."""
    impls = _resolve(policies).impls()
    if cfg.telemetry:
        raise NotImplementedError("telemetry (FamConfig.telemetry > 0) is "
                                  "not ported yet")
    if cfg.kernel_backend not in KERNEL_BACKENDS:
        raise ValueError(f"FamConfig.kernel_backend={cfg.kernel_backend!r}; "
                         f"expected one of {KERNEL_BACKENDS}")
    if cfg.kernel_backend == "cuda":
        fused_replacement_mode(impls.replacement)
    N, D, CPF = num_nodes, cfg.prefetch_degree, cfg.core_pf_degree

    def step(p, carry, inputs):
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
        nodes = _phase_c(cfg, p, nodes, req, t.demand_finish, pf_fin,
                         cpf_fin, impls)
        return nodes, t.new_busy

    return step


def _init_carry(cfg: FamConfig, p: FamParams, num_nodes: int,
                pad_sets: Optional[int] = None, pad_ways: Optional[int] = None,
                policies: Optional[PolicySet] = None):
    nodes = _init_node(cfg, p, num_nodes, pad_sets, pad_ways, policies)
    busy = torch.zeros((p.base_ipc.shape[0], 2), dtype=F32,
                       device=p.base_ipc.device)
    return nodes, busy


def _metrics(nodes: NodeState, p: FamParams) -> Dict[str, torch.Tensor]:
    """(S, N) figures of merit; ``p`` is the per-node params view."""
    return {
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


def run_steps(step, p: FamParams, carry, addrs, gaps, warm, live):
    """Drive ``step`` over the events: addrs (S, N, T) int32, gaps
    (S, N, T) float32 (already divided by cores per node), warm/live
    (T, S) bool; ``p`` is the per-node view. Returns the final carry."""
    addrs_t = addrs.permute(2, 0, 1).contiguous()
    gaps_t = gaps.permute(2, 0, 1).contiguous()
    warm, live = warm.unsqueeze(-1), live.unsqueeze(-1)
    for i in range(addrs_t.shape[0]):
        carry = step(p, carry, (addrs_t[i], gaps_t[i], warm[i], live[i]))
    return carry


def _simulate(cfg, num_nodes, p, addrs, gaps, warm, live, pad_sets, pad_ways,
              policies):
    step = _make_step(cfg, num_nodes, policies)
    pn = _per_node(p)
    gaps = gaps.to(F32) / pn.cores_per_node[..., None]   # aggregate stream
    carry = _init_carry(cfg, pn, num_nodes, pad_sets, pad_ways, policies)
    nodes, _ = run_steps(step, pn, carry, addrs.to(I32), gaps, warm, live)
    return _metrics(nodes, pn)


def _make_run(cfg: FamConfig, num_nodes: int, warmup_frac: float = 0.2,
              pad_sets: Optional[int] = None, pad_ways: Optional[int] = None,
              policies: Optional[PolicySet] = None):
    """Batched fixed-T runner: run(params (S,), addrs (S, N, T), gaps
    (S, N, T)) -> metrics dict of (S, N) tensors."""
    def run(p: FamParams, addrs, gaps):
        S, N, T = addrs.shape
        if N != num_nodes:
            raise ValueError(f"traces have {N} nodes, runner built for {num_nodes}")
        dev = addrs.device
        warm = (torch.arange(T, device=dev) >= int(T * warmup_frac))
        warm = warm[:, None].expand(T, S)
        live = torch.ones((T, S), dtype=torch.bool, device=dev)
        return _simulate(cfg, num_nodes, p, addrs, gaps, warm, live,
                         pad_sets, pad_ways, policies)

    return run


def _make_run_masked(cfg: FamConfig, num_nodes: int,
                     pad_sets: Optional[int] = None,
                     pad_ways: Optional[int] = None,
                     policies: Optional[PolicySet] = None):
    """Dynamic-T runner for padded traces: run(params (S,), addrs
    (S, N, T_pad), gaps, t_true (S,), warm_start (S,)) simulates only the
    first ``t_true`` events of each system; the padded tail steps run with
    ``live=False`` and are exact no-ops, so every metric is bit-identical
    to an unpadded run of length ``t_true``. ``warm_start`` is the first
    accumulated event, ``int(t_true * warmup_frac)`` computed on the host.
    """
    def run(p: FamParams, addrs, gaps, t_true, warm_start):
        S, N, T_pad = addrs.shape
        if N != num_nodes:
            raise ValueError(f"traces have {N} nodes, runner built for {num_nodes}")
        i = torch.arange(T_pad, device=addrs.device)[:, None]
        live = i < t_true[None, :]
        warm = (i >= warm_start[None, :]) & live
        return _simulate(cfg, num_nodes, p, addrs, gaps, warm, live,
                         pad_sets, pad_ways, policies)

    return run


def build_sim(cfg: FamConfig, flags: SimFlags, num_nodes: int,
              policies: Optional[PolicySet] = None, device="cuda"):
    """Returns run(addrs (N, T), gaps (N, T), warmup_frac=0.2) -> metrics
    dict of (N,) tensors: the one-system entry point, the same program as
    :func:`sweep` with S = 1."""
    dev = _device(device)
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
    dev = _device(device)
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
    """Generate the node traces (``numpy`` backend) and run one system."""
    from repro_torch.traces import system_traces
    addrs, gaps = system_traces(workload_names, T, seed, backend=trace_backend)
    run = build_sim(cfg, flags, len(workload_names), policies=policies,
                    device=device)
    return {k: v.cpu().numpy() for k, v in run(addrs, gaps).items()}
