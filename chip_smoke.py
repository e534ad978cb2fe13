#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # the checks below, 3.5-6 min on an H100
    python3 chip_smoke.py --profile  # also a torch.profiler window of the grid

Phases (each prints its seconds; any failed check raises, exit code != 0):

1. the card's name and power limit; build the CUDA kernel from
   ``src/repro_torch/kernels/famsim_step/csrc`` (nvcc, sm_90a);
2. kernel vs plain version on the card: random op streams over padded
   geometries (effective sets/ways below the padding, ways above 32 too)
   and a populated fig08-sized state (72 lanes, 16384 x 16), LRU and SRRIP,
   exact equality of tags, lru, stamp, hit and probe hits; times per launch
   and per plain step and the byte bound;
3. the main path: the fig08 quick grid (6 block sizes x 6 workloads x
   {base, dram} = 72 systems, 1 node, T = 12,000, numpy traces, cache
   padded to 16384 x 16) through ``repro_torch.core.famsim.sweep`` with the
   kernel launched once per event; per-block-size ipc_gain /
   rel_fam_latency geomeans and simulated events/s/device;
4. the same grid at T = 2,000 with ``kernel_backend="cuda"`` and
   ``"torch"``: every metric bit-identical; the golden configuration
   against ``src/repro_torch/testdata/famsim_golden.json``.

The last two lines of standard output are the kernel table (JSON) and
``{"ok": true, "device": {...}}``; the card's name and power limit come
earlier. Without a CUDA device it exits non-zero before printing results.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

FIG08_BLOCKS = (64, 128, 256, 512, 1024, 4096)
QUICK_WORKLOADS = ("603.bwaves_s", "628.pop2_s", "LU", "bfs", "canneal", "mg")
T_MAIN = 12_000
T_CHECK = 2_000
HBM_BYTES_PER_S = 3.35e12      # H100 SXM published HBM3 rate
DEVICE = "cuda"
KERNEL_SOURCE = "src/repro_torch/kernels/famsim_step/csrc/famsim_step.cu"
KERNEL_REPLACES = "src/repro/kernels/famsim_step/kernel.py:138"


def check(ok, msg):
    if not ok:
        raise RuntimeError(f"check failed: {msg}")


class Phases:
    def __init__(self):
        self.seconds = {}

    def run(self, name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.seconds[name] = time.perf_counter() - t0
        print(f"phase {name}: {self.seconds[name]:.3f} s", flush=True)
        return out


# --------------------------------------------------------------------------
# phase 2: kernel vs plain version
# --------------------------------------------------------------------------

def _populate(torch, tags, lru, num_sets, ways, mode, gen):
    """Fill each lane's effective region with blocks that hash to their set
    (about 90 % of the ways), with random recency values."""
    from repro_torch.core.dram_cache import _set_index
    dev = tags.device
    for lane in range(tags.shape[0]):
        ns, ew = int(num_sets[lane]), int(ways[lane])
        pool = torch.randint(0, 1 << 26, (ns * ew * 2,), generator=gen,
                             device="cpu").to(dev, torch.int32)
        si = _set_index(pool, ns).to(torch.int64)
        order = torch.argsort(si, stable=True)
        si, pool = si[order], pool[order]
        rank = torch.arange(si.numel(), device=dev) - torch.searchsorted(si, si)
        keep = (rank < ew) & (torch.rand(si.shape, generator=gen).to(dev) < 0.9)
        tags[lane, si[keep], rank[keep]] = pool[keep] + 1
    if mode == "lru":
        lru.copy_(torch.randint(0, 1 << 20, lru.shape, generator=gen).to(dev, torch.int32))
    else:
        lru.copy_(torch.randint(0, 4, lru.shape, generator=gen).to(dev, torch.int32))
    lru.mul_((tags > 0).to(torch.int32))


def _ops(torch, tags, C, P, gen):
    """One event's inputs per lane: fills, demand and probes drawn half
    from blocks present in the state, half fresh."""
    dev = tags.device
    L = tags.shape[0]
    present = []
    for lane in range(L):
        t = tags[lane][tags[lane] > 0]
        present.append(t[torch.randint(0, t.numel(), (C + 1 + P,), generator=gen).to(dev)] - 1)
    present = torch.stack(present).to(torch.int32)
    fresh = torch.randint(0, 1 << 26, (L, C + 1 + P), generator=gen).to(dev, torch.int32)
    pick = torch.rand((L, C + 1 + P), generator=gen).to(dev) < 0.5
    blocks = torch.where(pick, present, fresh)
    fills, demand, probes = blocks[:, :C], blocks[:, C], blocks[:, C + 1:]
    fen = torch.rand((L, C), generator=gen).to(dev) < 0.7
    den = torch.rand((L,), generator=gen).to(dev) < 0.8
    return (fills.contiguous(), fen, demand.contiguous(), den, probes.contiguous())


def _compare_stream(torch, lanes, pad_sets, pad_ways, num_sets, ways, mode,
                    steps, C, P, gen, populate):
    """Kernel and plain version on the card from the same state; exact."""
    from repro_torch.kernels.famsim_step import cache_step_ref, fused_cache_step
    from repro_torch.core.dram_cache import CacheState
    from repro_torch.policies.replacement import _SrripBound
    from repro_torch.core.dram_cache import init_cache
    dev = torch.device(DEVICE)
    ns = torch.tensor(num_sets, dtype=torch.int32, device=dev)
    ew = torch.tensor(ways, dtype=torch.int32, device=dev)
    k = init_cache(pad_sets, pad_ways, batch=(lanes,), device=dev)
    if populate:
        _populate(torch, k.tags, k.lru, num_sets, ways, mode, gen)
    r = CacheState(k.tags.clone(), k.lru.clone(), k.stamp.clone())
    policy = _SrripBound(3) if mode == "srrip" else None
    max_err = 0
    for _ in range(steps):
        if populate:
            args = _ops(torch, k.tags, C, P, gen)
        else:
            args = (torch.randint(0, 4 * pad_sets * pad_ways, (lanes, C), generator=gen).to(dev, torch.int32),
                    torch.rand((lanes, C), generator=gen).to(dev) < 0.7,
                    torch.randint(0, 4 * pad_sets * pad_ways, (lanes,), generator=gen).to(dev, torch.int32),
                    torch.rand((lanes,), generator=gen).to(dev) < 0.8,
                    torch.randint(0, 4 * pad_sets * pad_ways, (lanes, P), generator=gen).to(dev, torch.int32))
        khit, kph = fused_cache_step(k.tags, k.lru, k.stamp, *args, ns, ew,
                                     mode=mode, max_rrpv=3 if mode == "srrip" else 0)
        _, rhit, rph = cache_step_ref(r, *args, ns, ew, policy=policy)
        torch.cuda.synchronize()
        for a, b, name in ((k.tags, r.tags, "tags"), (k.lru, r.lru, "lru"),
                           (k.stamp, r.stamp, "stamp"), (khit, rhit, "hit"),
                           (kph, rph, "probe_hits")):
            err = int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
            max_err = max(max_err, err)
            check(err == 0, f"kernel != plain ({mode}, {name}, pad {pad_sets}x{pad_ways})")
    return max_err, k, r, ns, ew, policy


def _cache_step_bytes(torch, state, args, ns, ew, policy):
    """Bytes one call must move on this state and these inputs.

    Replays the step on a copy of ``state`` to see which rows the data
    needs, each counted once: a tag row per enabled fill, per enabled
    demand and per probe; an lru row only per enabled fill that evicts
    (no present block, no vacant way). Writes are the tag and lru
    elements whose value changes. Plus the per-lane inputs and outputs
    (fills, enables, demand, probes, geometry, stamp; hit, probe hits)."""
    from repro_torch.core import dram_cache as dc
    from repro_torch.kernels.famsim_step import cache_step_ref
    copy = lambda: dc.CacheState(state.tags.clone(), state.lru.clone(), state.stamp.clone())
    fills, fen, demand, den, probes = args
    L, C = fills.shape
    P = probes.shape[1]
    row = 4 * state.tags.shape[-1]
    lane = torch.arange(L, device=fills.device)
    # (lane, set) of each row, one pair per query: si is (L,) or (L, P)
    key = lambda si: torch.stack([lane.view(-1, *[1] * (si.dim() - 1)).expand(si.shape),
                                  si.to(torch.int64)], -1).reshape(-1, 2)
    s = copy()
    wmask = dc._way_mask(s, ew)
    tag_rows, lru_rows = [], []
    for c in range(C):
        present, si, _ = dc.lookup(s, fills[:, c], ns, ew)
        vacant = ((s.tags[lane, si.to(torch.int64)] == 0) & wmask).any(-1)
        en = fen[:, c]
        tag_rows.append(key(si)[en])
        lru_rows.append(key(si)[en & ~present & ~vacant])
        dc.insert(s, fills[:, c], enable=en, num_sets=ns, ways=ew, policy=policy)
    tag_rows.append(key(dc.lookup(s, demand, ns, ew)[1])[den])
    tag_rows.append(key(dc.lookup(s, probes, ns, ew)[1]))   # a touch leaves tags alone
    n_rows = lambda rows: int(torch.unique(torch.cat(rows), dim=0).shape[0])
    reads = (n_rows(tag_rows) + n_rows(lru_rows)) * row
    after = copy()
    cache_step_ref(after, *args, ns, ew, policy=policy)
    writes = 4 * int((after.tags != state.tags).sum() + (after.lru != state.lru).sum())
    io = L * (C * 5 + 5 + P * 4 + 8 + 4) + L * (1 + P + 4)
    return reads + writes + io


def kernel_vs_plain(torch, gen):
    from repro_torch.configs.base import FamConfig
    from repro_torch.kernels.famsim_step import cache_step_ref, fused_cache_step
    max_err = 0
    # random op streams: small padded geometries, effective below the
    # padding, W_pad = 40 for the chunked path over more than 32 ways
    for pad_sets, pad_ways in ((16, 4), (64, 8), (32, 40)):
        lanes = 8
        num_sets = [max(1, pad_sets * (i + 1) // lanes) for i in range(lanes)]
        ways = [max(1, pad_ways * ((i * 3) % lanes + 1) // lanes) for i in range(lanes)]
        for mode in ("lru", "srrip"):
            e, *_ = _compare_stream(torch, lanes, pad_sets, pad_ways, num_sets,
                                    ways, mode, 25, 4, 6, gen, populate=False)
            max_err = max(max_err, e)
    # the fig08 geometry: 72 lanes, 16384 x 16, C = 8, P = 6, populated
    cfg = FamConfig()
    C, P = cfg.completions_per_step, cfg.prefetch_degree + cfg.core_pf_degree
    num_sets = [FamConfig(block_bytes=b).num_sets for b in FIG08_BLOCKS for _ in range(12)]
    ways = [cfg.cache_ways] * len(num_sets)
    pad_sets = FamConfig(block_bytes=FIG08_BLOCKS[0]).num_sets
    timing = {}
    for mode in ("lru", "srrip"):
        e, k, r, ns, ew, policy = _compare_stream(
            torch, len(num_sets), pad_sets, cfg.cache_ways, num_sets, ways,
            mode, 20, C, P, gen, populate=True)
        max_err = max(max_err, e)
        if mode == "lru":      # the main path's mode
            args = _ops(torch, k.tags, C, P, gen)
            launch = lambda: fused_cache_step(k.tags, k.lru, k.stamp, *args, ns, ew, mode=mode)
            call_ms = _time(torch, launch, 200)
            plain_ms = _time(torch, lambda: cache_step_ref(r, *args, ns, ew, policy=policy), 20)
            # the timed launches repeat these inputs, so after the first one
            # every launch sees a state like k's now: the bound is taken there
            nbytes = _cache_step_bytes(torch, k, args, ns, ew, policy)
            timing = dict(ms=_device_ms(torch, launch, 100), call_ms=call_ms,
                          plain_ms=plain_ms, bytes=nbytes,
                          bound_ms=nbytes / HBM_BYTES_PER_S * 1e3)
    print(f"fused_cache_step @ 72 lanes x 16384 x 16, C={C}, P={P}, lru: "
          f"kernel {timing['ms'] * 1e3:.2f} us device time/launch "
          f"({timing['call_ms'] * 1e3:.2f} us per wrapper call, back to back), "
          f"plain {timing['plain_ms'] * 1e3:.1f} us/step, bound "
          f"{timing['bound_ms'] * 1e3:.4f} us ({timing['bytes']} B)", flush=True)
    return max_err, timing


def _device_ms(torch, fn, n):
    """Mean device time of the cache-step kernel over n calls, from
    torch.profiler's kernel events (the wrapper's host work excluded)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == DeviceType.CUDA and "cache_step_kernel" in e.name]
    check(len(us) == n, f"profiler saw {len(us)} of {n} kernel launches")
    return float(np.mean(us)) / 1e3


def _time(torch, fn, n):
    """Time per call on the stream: CUDA events around n back-to-back
    calls after a warm-up (host-bound when the host issues slower than the
    device runs)."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


# --------------------------------------------------------------------------
# phases 3-4: the main path
# --------------------------------------------------------------------------

def fig08_grid(T, kernel_backend):
    """(donor cfg, stacked params, addrs (72, 1, T), gaps) for the fig08
    quick grid: block size x workload x {base, dram}."""
    from repro_torch.configs.base import FamConfig, fam_replace
    from repro_torch.core.fam_params import FamParams, stack_params
    from repro_torch.policies import SimFlags
    from repro_torch.traces import system_traces
    base = fam_replace(FamConfig(), num_nodes=1, kernel_backend=kernel_backend)
    variants = {"base": SimFlags(core_prefetch=False, dram_prefetch=False),
                "dram": SimFlags()}
    traces = {w: system_traces([w], T, 0) for w in QUICK_WORKLOADS}
    params, addrs, gaps, keys = [], [], [], []
    for bs in FIG08_BLOCKS:
        for w in QUICK_WORKLOADS:
            for v, flags in variants.items():
                params.append(FamParams.of(fam_replace(base, block_bytes=bs), flags,
                                           device="cpu"))
                addrs.append(traces[w][0])
                gaps.append(traces[w][1])
                keys.append((bs, w, v))
    donor = fam_replace(base, block_bytes=FIG08_BLOCKS[0])
    return donor, stack_params(params), np.stack(addrs), np.stack(gaps), keys


def run_grid(T, kernel_backend):
    import torch
    from repro_torch.core.famsim import sweep
    donor, p, addrs, gaps, keys = fig08_grid(T, kernel_backend)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = sweep(donor, p, None, addrs, gaps, device=DEVICE)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    seconds = time.perf_counter() - t0
    return out, keys, seconds


def fig08_rows(out, keys):
    from repro_torch.core.ipc_model import geomean
    idx = {k: i for i, k in enumerate(keys)}
    rows = []
    for bs in FIG08_BLOCKS:
        gains, rels = [], []
        for w in QUICK_WORKLOADS:
            b, d = idx[(bs, w, "base")], idx[(bs, w, "dram")]
            gains.append(float(out["ipc"][d, 0] / max(out["ipc"][b, 0], 1e-9)))
            rels.append(float(out["fam_latency"][d, 0] / max(out["fam_latency"][b, 0], 1e-9)))
        rows.append(f"fig08_block{bs} ipc_gain={geomean(gains):.3f};"
                    f"rel_fam_latency={geomean(rels):.3f}")
    return rows


def main_path(torch):
    from repro_torch.kernels.famsim_step import fused_cache_step
    fused_cache_step.launches = 0
    out, keys, seconds = run_grid(T_MAIN, "cuda")
    launches = fused_cache_step.launches
    check(launches == T_MAIN, f"kernel launched {launches} times, expected {T_MAIN}")
    for k, v in out.items():
        check(v.shape == (len(keys), 1) and np.isfinite(v).all(), f"metric {k}")
    for row in fig08_rows(out, keys):
        print(row)
    events = len(keys) * T_MAIN
    print(f"main path: {len(keys)} systems x 1 node x {T_MAIN} events in "
          f"{seconds:.3f} s = {events / seconds:.1f} events/s/device "
          f"({seconds / T_MAIN * 1e3:.3f} ms/step)", flush=True)
    return launches, seconds


def backends_and_golden(torch):
    from repro_torch.configs.base import FamConfig
    from repro_torch.core.famsim import SimFlags, build_sim
    a, _, sa = run_grid(T_CHECK, "cuda")
    b, _, sb = run_grid(T_CHECK, "torch")
    for k in a:
        check(np.array_equal(a[k], b[k]), f"cuda and torch backends differ on {k}")
    print(f"backends bit-identical at T={T_CHECK}: cuda {sa:.3f} s, torch {sb:.3f} s")
    golden = json.loads((ROOT / "src/repro_torch/testdata/famsim_golden.json").read_text())
    # the stored traces, not this machine's numpy draws: the golden values
    # are the JAX reference's on exactly these inputs
    run = build_sim(FamConfig(), SimFlags(), len(golden["workloads"]), device=DEVICE)
    out = run(np.asarray(golden["addrs"], np.int64), np.asarray(golden["gaps"], np.float32))
    out = {k: v.cpu().numpy() for k, v in out.items()}
    for k, want in golden["metrics"].items():
        want = np.asarray(want, np.float32)
        if k in golden["counters"]:
            check(np.array_equal(out[k], want), f"golden {k}: {out[k]} != {want}")
        else:
            check(np.allclose(out[k], want, rtol=golden["rtol"], atol=0),
                  f"golden {k}: {out[k]} vs {want}")
    print(f"golden configuration matches at rtol {golden['rtol']}")


def profile_window(torch, steps=200):
    """torch.profiler over ``steps`` events of the fig08 grid: device busy
    share and the kernels per step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import famsim
    donor, p, addrs, gaps, _ = fig08_grid(steps, "cuda")
    famsim.sweep(donor, p, None, addrs[..., :20], gaps[..., :20], device=DEVICE)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        famsim.sweep(donor, p, None, addrs, gaps, device=DEVICE)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_us = sum(e.time_range.elapsed_us() for e in kernels)
    ours = [e.time_range.elapsed_us() for e in kernels if "cache_step_kernel" in e.name]
    print(f"profile: {steps} steps, wall {wall / steps * 1e3:.3f} ms/step, device busy "
          f"{dev_us / 1e3 / steps:.4f} ms/step ({dev_us / 1e6 / wall:.2%} of wall), "
          f"{len(kernels) / steps:.1f} device kernels/step; cache_step_kernel "
          f"{np.mean(ours) if ours else float('nan'):.2f} us/launch device time over "
          f"{len(ours)} launches")
    print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=15))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace a window of the grid with torch.profiler")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.kernels.famsim_step import build

    phases = Phases()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda}")
    lib, log = phases.run("build", build)
    print(f"built {lib.name}\n{log.strip()}", flush=True)
    gen = torch.Generator().manual_seed(0)
    max_err, timing = phases.run("kernel_vs_plain", kernel_vs_plain, torch, gen)
    launches, _ = phases.run("main_path", main_path, torch)
    phases.run("backends_and_golden", backends_and_golden, torch)
    if args.profile:
        phases.run("profile", profile_window, torch)
    print("phase seconds: " + json.dumps({k: round(v, 3) for k, v in phases.seconds.items()}))
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "fused_cache_step", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES, "launches": launches,
        "max_abs_err": max_err, "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": "bytes", "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
