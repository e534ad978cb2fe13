"""Plain reference of the FAM memory-system simulator, one system at a time.

A straightforward scalar implementation of the simulator's semantics (the
paper's event model, arXiv:2406.14778 §V): Python ints for every integer
state and Python floats rounded to float32 after each arithmetic result,
so that it follows the float32 arithmetic of the program under test. It
imports nothing of that program and takes nothing it made: the parameters
come from the benchmark's configuration file, the traces from
``reference.traces``.

One event per node per step, for one system of N nodes:

  A. per node: advance the clock, retire up to ``completions_per_step``
     finished prefetches into the set-associative LRU DRAM cache, probe
     cache and prefetch queue for the demand (and touch it on a hit), train
     SPP and walk its lookahead, run the stride core prefetcher, probe the
     candidates for redundancy, grant prefetch tokens;
  B. per system: time the demands and prefetches through the FAM
     controller's service chains, FIFO or fluid two-class WFQ;
  C. per node: latency and IPC accounting, prefetch-queue inserts, the
     core fill buffer, the MIMD rate adaptation.

``simulate(..., rnd=round_bf16)`` computes every float result in bfloat16
instead: the lower-precision control of the benchmark's comparison.
"""
from __future__ import annotations

import math
import struct
from typing import Callable, Dict, List, Sequence

_F32 = struct.Struct("<f")
_U32S = struct.Struct("<I")

PAGE_BITS = 12
HASH_MULT = 0x9E3779B1
FAM_PAGE_MULT = 0x61C88647
U32 = 0xFFFFFFFF
SIG_SHIFT = 4
PT_WAYS = 4
MAX_WEIGHT = 15
QUEUE_THRESHOLD = 0.95
INF = math.inf

METRICS = ("ipc", "fam_latency", "demand_hit_fraction", "corepf_hit_fraction",
           "prefetches_issued", "issue_rate", "cache_occupancy")


def round_f32(x: float) -> float:
    """``x`` rounded to the nearest float32 (exact for + - * / of float32
    operands computed in double first)."""
    return _F32.unpack(_F32.pack(x))[0]


def round_bf16(x: float) -> float:
    """``x`` rounded to float32, then to bfloat16 (nearest, ties to even)."""
    bits = _U32S.unpack(_F32.pack(x))[0]
    if bits & 0x7F800000 != 0x7F800000:
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return _F32.unpack(_U32S.pack(bits & U32))[0]


def u32_hash(x: int, mult: int, shift: int) -> int:
    return (((x & U32) * mult) & U32) >> shift


class Params:
    """One system's values, as the simulated hardware states them."""

    def __init__(self, cfg: Dict, flags: Dict, rnd: Callable[[float], float]):
        r = rnd
        self.base_ipc = r(cfg["base_ipc"])
        self.mlp = r(cfg["mlp"])
        self.cores = r(cfg["cores_per_node"])
        self.llc_latency = r(cfg["llc_latency"])
        self.local_lat = r(cfg["local_mem_latency"])
        self.fam_mem_latency = r(cfg["fam_mem_latency"])
        self.cxl_min = r(int(cfg["cxl_min_latency_ns"] * cfg["clock_ghz"]))
        self.cycles_per_byte = r(1 / (cfg["fam_bw_gbps"] / cfg["clock_ghz"]))
        self.demand_bytes = r(cfg["demand_bytes"])
        self.block_bytes = r(cfg["block_bytes"])
        self.num_sets = max(1, cfg["dram_cache_bytes"] // cfg["block_bytes"]
                            // cfg["cache_ways"])
        self.ways = cfg["cache_ways"]
        self.block_bits = int(cfg["block_bytes"]).bit_length() - 1
        self.alloc_mod = cfg["allocation_ratio"] + 1
        self.core_prefetch = bool(flags.get("core_prefetch", True))
        self.dram_prefetch = bool(flags.get("dram_prefetch", True))
        self.bw_adapt = bool(flags.get("bw_adapt", False))
        self.all_local = bool(flags.get("all_local", False))
        self.use_wfq = bool(flags.get("wfq", False))
        self.weight = r(float(flags.get("wfq_weight", cfg["wfq_weight"])))
        self.backlog_cap = r(cfg["wfq_backlog_cap"])
        self.threshold = r(cfg["spp_confidence_threshold"])
        self.sample_interval = cfg["sample_interval"]
        self.noise = r(cfg["latency_noise_threshold"])
        self.mimd = r(cfg["mimd_increase"])
        self.alpha = r(cfg["ema_alpha"])
        self.min_rate = r(cfg["min_issue_rate"])
        # shapes
        self.Q = cfg["prefetch_queue"]
        self.D = cfg["prefetch_degree"]
        self.CPF = cfg["core_pf_degree"]
        self.C = cfg["completions_per_step"]
        self.E = cfg["core_fill_entries"]
        self.ST = cfg["spp_signature_entries"]
        self.PT = cfg["spp_pattern_entries"]
        self.sig_mask = (1 << cfg["spp_signature_bits"]) - 1


class Node:
    """One compute node: clock, SPP tables, DRAM cache metadata, prefetch
    queue, rate controller, core prefetcher and the accumulators."""

    def __init__(self, p: Params, rnd):
        r = rnd
        self.clock = 0.0
        self.st_tag = [0] * p.ST
        self.st_last = [0] * p.ST
        self.st_sig = [0] * p.ST
        self.pt_delta = [0] * (p.PT * PT_WAYS)
        self.pt_weight = [0] * (p.PT * PT_WAYS)
        self.pt_sigw = [0] * p.PT
        self.tags = [0] * (p.num_sets * p.ways)
        self.lru = [0] * (p.num_sets * p.ways)
        self.stamp = 0
        self.q_block = [0] * p.Q                 # block + 1; 0 = empty
        self.q_finish = [0.0] * p.Q
        # rate controller (token bucket under MIMD adaptation)
        self.issue_rate = 1.0
        self.tokens = 0.0
        self.min_latency = r(r(p.fam_mem_latency + p.cxl_min) +
                             r(p.cycles_per_byte * p.demand_bytes))
        self.lat_sum = self.lat_cnt = self.lat_ema = 0.0
        self.win_issued = self.win_useful = 0.0
        self.acc_ema = 0.5
        self.events = 0
        # stride core prefetcher and its LLC fill buffer
        self.core_last = -1
        self.core_stride = 0
        self.buf_line = [0] * p.E
        self.buf_fin = [0.0] * p.E
        self.buf_ptr = 0
        # accumulators
        self.instr = self.cycles = self.fam_lat_sum = self.fam_cnt = 0.0
        self.demand_fam = self.demand_hit = 0.0
        self.corepf_fam = self.corepf_hit = self.pf_issued = 0.0


def _is_fam_page(p: Params, page: int) -> bool:
    return u32_hash(page, FAM_PAGE_MULT, 16) % p.alloc_mod != 0 and not p.all_local


def _set_base(p: Params, block: int) -> int:
    return (u32_hash(block, HASH_MULT, 7) % p.num_sets) * p.ways


def _probe(p: Params, nd: Node, block: int):
    """(hit, row base, way) of a tag lookup; way 0 when it misses."""
    base = _set_base(p, block)
    row = nd.tags[base:base + p.ways]
    tag = block + 1
    if tag in row:
        return True, base, row.index(tag)
    return False, base, 0


def _insert(p: Params, nd: Node, block: int) -> None:
    """Fill ``block``: its way if present, else the first vacant way, else
    the least recently used one; stamp it."""
    base = _set_base(p, block)
    tag = block + 1
    W = p.ways
    row = nd.tags[base:base + W]
    if tag in row:
        way = row.index(tag)
    elif 0 in row:
        way = row.index(0)
    else:
        ages = nd.lru[base:base + W]
        way = ages.index(min(ages))
    nd.stamp += 1
    nd.tags[base + way] = tag
    nd.lru[base + way] = nd.stamp


def _in_queue(nd: Node, block: int):
    """(in flight, latest finish among the matching entries, 0.0 if none)."""
    tag = block + 1
    qb = nd.q_block
    if tag not in qb:
        return False, 0.0
    qf = nd.q_finish
    return True, max([0.0] + [qf[i] for i in range(len(qb)) if qb[i] == tag])


def _spp_train(p: Params, nd: Node, page: int, block: int, enable: bool) -> int:
    """Train SPP on (page, block); returns the current signature."""
    idx = u32_hash(page, HASH_MULT, 8) % p.ST
    tag = page + 1
    st_tag, st_last, old_sig = nd.st_tag[idx], nd.st_last[idx], nd.st_sig[idx]
    hit = st_tag == tag
    delta = block - st_last
    train = hit and delta != 0 and enable
    if train:
        pt_i = old_sig % p.PT
        row = pt_i * PT_WAYS
        dl, wt = nd.pt_delta, nd.pt_weight
        way = -1
        for k in range(PT_WAYS):
            if dl[row + k] == delta and wt[row + k] > 0:
                way = k
                break
        if way >= 0:
            wt[row + way] = min(wt[row + way] + 1, MAX_WEIGHT)
        else:
            ws = wt[row:row + PT_WAYS]
            way = ws.index(min(ws))
            wt[row + way] = 1
        dl[row + way] = delta
        if nd.pt_sigw[pt_i] < 4 * MAX_WEIGHT:
            nd.pt_sigw[pt_i] += 1
    mask = p.sig_mask
    new_sig = (((old_sig << SIG_SHIFT) ^ (delta & mask)) & mask) if hit else block & mask
    if enable:
        nd.st_tag[idx] = tag
        nd.st_last[idx] = block
        nd.st_sig[idx] = new_sig
    return new_sig


def _spp_predict(p: Params, nd: Node, page: int, block: int, sig: int, bpp: int,
                 r) -> List[int]:
    """Lookahead blocks (global block addresses; -1 where none)."""
    mask = p.sig_mask
    out = [-1] * p.D
    cur_sig, cur_block, conf = sig, block, 1.0
    dl, wt = nd.pt_delta, nd.pt_weight
    for k in range(p.D):
        pt_i = cur_sig % p.PT
        row = pt_i * PT_WAYS
        ws = wt[row:row + PT_WAYS]
        w = max(ws)
        way = ws.index(w)
        sigw = max(nd.pt_sigw[pt_i], 1)
        step_conf = r(float(w) / float(sigw))
        new_conf = r(conf * min(r(step_conf * 4.0), 1.0))
        delta = dl[row + way]
        nb = cur_block + delta
        if not (w > 0 and new_conf >= p.threshold and 0 <= nb < bpp and delta != 0):
            break
        out[k] = page * bpp + nb
        cur_sig = ((cur_sig << SIG_SHIFT) ^ (delta & mask)) & mask
        cur_block, conf = nb, new_conf
    return out


def _service_chain(arr, srv, valid, busy0, r):
    """Finish times of a FIFO service chain, in closed form:
    busy_i = cs_i + max(max_{j<=i}(arr_j - (cs_j - s_j)), busy0)."""
    finish = []
    cs, run, new_busy = 0.0, -INF, busy0
    for i in range(len(arr)):
        s = srv[i] if valid[i] else 0.0
        cs = s if i == 0 else r(cs + s)
        a = arr[i] if valid[i] else -INF
        v = a - r(cs - s) if a != -INF else -INF
        run = max(run, r(v) if v != -INF else v)
        f = r(cs + max(run, busy0))
        finish.append(f)
        if valid[i] and f > new_busy:
            new_busy = f
    return finish, new_busy


def _arbitrate(p: Params, busy, d_arr, d_valid, p_arr, p_valid, p_bytes, r):
    """Phase B: demand and prefetch finish times, and the new busy pair."""
    d_svc = r(p.cycles_per_byte * p.demand_bytes)
    p_svc = [r(p.cycles_per_byte * b) for b in p_bytes]
    lat_fixed = r(p.fam_mem_latency + p.cxl_min)
    N = len(d_arr)
    if p.use_wfq:
        W = p.weight
        slow_d = r(r(W + 1.0) / W)
        slow_p = r(W + 1.0)
        d_busy0, p_busy0 = busy
        d_srv = [r(d_svc * (slow_d if p_busy0 > a else 1.0)) for a in d_arr]
        d_fin, d_busy = _service_chain(d_arr, d_srv, d_valid, d_busy0, r)
        pp_srv = [r(s * (slow_p if d_busy0 > a else 1.0)) for s, a in zip(p_svc, p_arr)]
        p_fin, p_busy = _service_chain(p_arr, pp_srv, p_valid, p_busy0, r)
        new_busy = [d_busy, p_busy]
    else:
        arr = list(d_arr) + list(p_arr)
        srv = [d_svc] * N + p_svc
        val = list(d_valid) + list(p_valid)
        order = sorted(range(len(arr)), key=lambda k: (arr[k] if val[k] else INF, k))
        fin_o, b = _service_chain([arr[k] for k in order], [srv[k] for k in order],
                                  [val[k] for k in order], busy[0], r)
        fin = [0.0] * len(arr)
        for j, k in enumerate(order):
            fin[k] = fin_o[j]
        d_fin, p_fin = fin[:N], fin[N:]
        new_busy = [b, b]
    d_fin = [r(f + lat_fixed) if v else 0.0 for f, v in zip(d_fin, d_valid)]
    p_fin = [r(f + lat_fixed) if v else 0.0 for f, v in zip(p_fin, p_valid)]
    return d_fin, p_fin, new_busy


def _phase_a(p: Params, nd: Node, addr: int, gap: float, r):
    clock = r(nd.clock + gap)
    nd.clock = clock
    # retire the C earliest finished prefetches (ties: the lower slot)
    qb, qf = nd.q_block, nd.q_finish
    done = [i for i in range(p.Q) if qb[i] > 0 and qf[i] <= clock]
    done.sort(key=lambda i: (qf[i], i))
    fills = []
    for i in done[:p.C]:
        fills.append(qb[i] - 1)
        qb[i] = 0

    bb = p.block_bits
    page = addr >> PAGE_BITS
    bpp = 1 << (PAGE_BITS - bb)
    block_in_page = (addr >> bb) & (bpp - 1)
    gblock = addr >> bb
    is_fam = _is_fam_page(p, page)
    enable = is_fam and p.dram_prefetch

    line = addr >> 6
    cpb_hit, cpb_fin = False, 0.0
    if line + 1 in nd.buf_line:
        cpb_hit = p.core_prefetch
        cpb_fin = max([0.0] + [f for l, f in zip(nd.buf_line, nd.buf_fin) if l == line + 1])

    sig = _spp_train(p, nd, page, block_in_page, enable)
    cands = _spp_predict(p, nd, page, block_in_page, sig, bpp, r)
    cand_valid = [c >= 0 for c in cands]
    cands = [c if c >= 0 else page * bpp for c in cands]

    stride = line - nd.core_last
    stride_ok = stride == nd.core_stride and stride != 0 and abs(stride) < 32
    cpf_lines = [line + stride * k for k in range(1, p.CPF + 1)]
    cpf_valid = [stride_ok and p.core_prefetch and
                 _is_fam_page(p, cl >> (PAGE_BITS - 6)) for cl in cpf_lines]
    cpf_blocks = [cl >> (bb - 6) for cl in cpf_lines]

    # the cache step: fills, demand probe + touch, redundancy probes
    for b in fills:
        _insert(p, nd, b)
    hit, base, way = _probe(p, nd, gblock)
    hit = hit and enable
    if hit:
        nd.stamp += 1
        nd.lru[base + way] = nd.stamp
    cand_hit = [_probe(p, nd, c)[0] for c in cands]
    cpf_raw = [_probe(p, nd, c)[0] for c in cpf_blocks]

    inflight, inflight_fin = _in_queue(nd, gblock)
    inflight = inflight and is_fam and not hit and p.dram_prefetch
    hit = hit and not cpb_hit
    inflight = inflight and not cpb_hit
    demand_to_fam = is_fam and not hit and not inflight and not cpb_hit

    pf_valid = [v and not h and not _in_queue(nd, c)[0] and enable
                for v, h, c in zip(cand_valid, cand_hit, cands)]
    # token bucket (active under bandwidth adaptation)
    want = sum(pf_valid)
    if p.bw_adapt:
        tokens = min(r(nd.tokens + r(nd.issue_rate * max(want, 1))), 8.0)
        grant = min(want, int(math.floor(tokens)))
        nd.tokens = r(tokens - grant)
    else:
        grant = want
    free = qb.count(0)
    rank = 0
    for k in range(p.D):
        if pf_valid[k]:
            rank += 1
            if rank > grant:
                pf_valid[k] = False
    rank = 0
    for k in range(p.D):
        if pf_valid[k]:
            rank += 1
            if rank > free:
                pf_valid[k] = False

    cpf_hits = [h and p.dram_prefetch for h in cpf_raw]
    cpf_to_fam = [v and not h for v, h in zip(cpf_valid, cpf_hits)]
    nd.core_last = line
    if stride != 0:
        nd.core_stride = stride
    return dict(is_fam=is_fam, hit=hit, inflight=inflight, inflight_fin=inflight_fin,
                demand_to_fam=demand_to_fam, cpb_hit=cpb_hit, cpb_fin=cpb_fin,
                pf_blocks=cands, pf_valid=pf_valid, cpf_lines=cpf_lines,
                cpf_valid=cpf_valid, cpf_hits=[h and v for h, v in zip(cpf_hits, cpf_valid)],
                cpf_to_fam=cpf_to_fam)


def _adapt(p: Params, nd: Node, r) -> None:
    """One MIMD sampling cycle of the issue rate (paper Fig. 9)."""
    a = p.alpha
    avg = r(nd.lat_sum / max(nd.lat_cnt, 1.0))
    ema = avg if nd.lat_ema == 0.0 else r(r(r(1 - a) * nd.lat_ema) + r(a * avg))
    min_lat = min(nd.min_latency, ema)
    acc = r(nd.win_useful / max(nd.win_issued, 1.0))
    acc_ema = r(r(r(1 - a) * nd.acc_ema) + r(a * acc))
    thresh = r(p.noise * min_lat)
    if ema > thresh:
        excess = min(max(r(r(ema - thresh) / max(thresh, 1.0)), 0.0), 1.0)
        dec = r(1.0 - r(r(0.5 * excess) * r(1.0 - r(0.5 * acc_ema))))
        rate = r(nd.issue_rate * dec)
    else:
        rate = r(nd.issue_rate * p.mimd)
    nd.issue_rate = min(max(rate, p.min_rate), 1.0)
    nd.min_latency, nd.lat_ema, nd.acc_ema = min_lat, ema, acc_ema
    nd.lat_sum = nd.lat_cnt = nd.win_issued = nd.win_useful = 0.0
    nd.events = 0


def _phase_c(p: Params, nd: Node, q, d_fin: float, pf_fin, cpf_fin, gap: float,
             warm: bool, r) -> None:
    clock = nd.clock
    local = p.local_lat
    if q["cpb_hit"]:
        lat = max(r(q["cpb_fin"] - clock), p.llc_latency)
    elif not q["is_fam"] or q["hit"]:
        lat = local
    elif q["inflight"]:
        lat = max(r(q["inflight_fin"] - clock), local)
    else:
        lat = max(r(d_fin - clock), 1.0)

    # prefetch-queue inserts (first free slot, below the 95 % cap)
    qb, qf = nd.q_block, nd.q_finish
    cap = int(QUEUE_THRESHOLD * p.Q)
    for k in range(p.D):
        if q["pf_valid"][k] and p.Q - qb.count(0) < cap and 0 in qb:
            slot = qb.index(0)
            qb[slot] = q["pf_blocks"][k] + 1
            qf[slot] = pf_fin[k]

    fam_miss = q["is_fam"] and not q["hit"] and not q["inflight"]
    for k in range(p.CPF):
        if q["cpf_valid"][k]:
            pos = nd.buf_ptr
            nd.buf_line[pos] = q["cpf_lines"][k] + 1
            nd.buf_fin[pos] = r(clock + local) if q["cpf_hits"][k] else cpf_fin[k]
            nd.buf_ptr = (pos + 1) % p.E

    n_pf = sum(q["pf_valid"])
    # observe, then adapt once per sampling cycle
    if fam_miss:
        nd.lat_sum = r(nd.lat_sum + lat)
        nd.lat_cnt = r(nd.lat_cnt + 1.0)
    nd.win_useful = r(nd.win_useful + (1.0 if q["hit"] else 0.0))
    nd.win_issued = r(nd.win_issued + float(n_pf))
    nd.events += 1
    if p.bw_adapt and nd.events >= p.sample_interval:
        _adapt(p, nd, r)

    stall = r(lat / r(p.mlp * p.cores))
    nd.clock = r(clock + stall)
    if warm:
        nd.instr = r(nd.instr + r(gap * p.base_ipc))
        nd.cycles = r(nd.cycles + r(gap + stall))
        if q["is_fam"]:
            nd.fam_lat_sum = r(nd.fam_lat_sum + lat)
            nd.fam_cnt = r(nd.fam_cnt + 1.0)
            nd.demand_fam = r(nd.demand_fam + 1.0)
        if q["hit"]:
            nd.demand_hit = r(nd.demand_hit + 1.0)
        nd.corepf_fam = r(nd.corepf_fam + float(sum(q["cpf_valid"])))
        nd.corepf_hit = r(nd.corepf_hit + float(sum(q["cpf_hits"])))
        nd.pf_issued = r(nd.pf_issued + float(n_pf))


def simulate(cfg: Dict, flags: Dict, addrs, gaps, warmup_frac: float = 0.2,
             rnd: Callable[[float], float] = round_f32) -> Dict[str, List[float]]:
    """Run one system of N nodes over its traces: ``addrs`` (N, T) byte
    addresses, ``gaps`` (N, T) float32 compute gaps. Returns each metric's
    per-node values (float32 values as Python floats)."""
    r = rnd
    p = Params(cfg, flags, r)
    N, T = len(addrs), len(addrs[0])
    addrs = [[int(a) for a in row] for row in addrs]
    gaps = [[r(float(g) / p.cores) for g in row] for row in gaps]
    nodes = [Node(p, r) for _ in range(N)]
    busy = [0.0, 0.0]
    warm_start = int(T * warmup_frac)
    D, CPF = p.D, p.CPF
    for t in range(T):
        reqs = [_phase_a(p, nd, addrs[n][t], gaps[n][t], r) for n, nd in enumerate(nodes)]
        if p.use_wfq:                    # CXL backpressure on prefetch issue
            for nd, q in zip(nodes, reqs):
                if not r(busy[1] - nd.clock) < p.backlog_cap:
                    q["pf_valid"] = [False] * D
                    q["cpf_to_fam"] = [False] * CPF
        p_arr = [nd.clock for nd in nodes for _ in range(D)] + \
            [nd.clock for nd in nodes for _ in range(CPF)]
        p_valid = [v for q in reqs for v in q["pf_valid"]] + \
            [v for q in reqs for v in q["cpf_to_fam"]]
        p_bytes = [p.block_bytes] * (N * D) + [p.demand_bytes] * (N * CPF)
        d_fin, p_fin, busy = _arbitrate(
            p, busy, [nd.clock for nd in nodes], [q["demand_to_fam"] for q in reqs],
            p_arr, p_valid, p_bytes, r)
        warm = t >= warm_start
        for n, (nd, q) in enumerate(zip(nodes, reqs)):
            _phase_c(p, nd, q, d_fin[n], p_fin[n * D:(n + 1) * D],
                     p_fin[N * D + n * CPF:N * D + (n + 1) * CPF], gaps[n][t], warm, r)
    return metrics(p, nodes, r)


def metrics(p: Params, nodes: Sequence[Node], r) -> Dict[str, List[float]]:
    out = {k: [] for k in METRICS}
    for nd in nodes:
        out["ipc"].append(r(nd.instr / max(nd.cycles, 1.0)))
        out["fam_latency"].append(r(nd.fam_lat_sum / max(nd.fam_cnt, 1.0)))
        out["demand_hit_fraction"].append(r(nd.demand_hit / max(nd.demand_fam, 1.0)))
        out["corepf_hit_fraction"].append(r(nd.corepf_hit / max(nd.corepf_fam, 1.0)))
        out["prefetches_issued"].append(nd.pf_issued)
        out["issue_rate"].append(nd.issue_rate)
        filled = sum(1 for t in nd.tags if t > 0)
        out["cache_occupancy"].append(r(r(float(filled)) / r(float(p.num_sets * p.ways))))
    return out
