"""Multi-node pooled-memory study (paper §V-B/§V-C in miniature) on the
PyTorch port: 4 compute nodes share one FAM pool; compare the paper's
configurations.

Counterpart of ``examples/multinode_fam.py``, declared through
``repro_torch.experiments``: the five configurations are one flag axis,
all differing only in per-system values, so ``plan()`` resolves them into
ONE compile group — one captured CUDA graph replayed over the 5 simulated
systems, every node trace generated on the device
(``repro_torch.traces``, no host-side generation).

Run:  PYTHONPATH=src python examples/torch_multinode_fam.py [--device cpu] [--T 12000]
"""
import argparse

import numpy as np

from repro_torch.configs.base import FamConfig
from repro_torch.core.famsim import SimFlags
from repro_torch.experiments import Experiment, flag_axis

# paper §V-B/§V-C methodology: copies of the same application per node
WORKLOADS = ("603.bwaves_s",) * 4
T = 12_000

CONFIGS = {
    "baseline (no prefetch)": SimFlags(core_prefetch=False,
                                       dram_prefetch=False),
    "core prefetch": SimFlags(dram_prefetch=False),
    "+ DRAM-cache prefetch (FIFO)": SimFlags(),
    "+ BW adaptation (source)": SimFlags(bw_adapt=True),
    "+ WFQ w=2 (memory node)": SimFlags(wfq=True, wfq_weight=2),
}


def run(device="cuda", T=T, workloads=WORKLOADS):
    """Plan and run the five configurations; returns (result, {config:
    geometric-mean IPC})."""
    cfg = FamConfig()
    print(f"{len(workloads)} nodes sharing FAM ({cfg.fam_bw_gbps} GB/s DDR), "
          f"allocation ratio {cfg.allocation_ratio}:1, "
          f"{cfg.dram_cache_bytes >> 20} MB DRAM cache, "
          f"{cfg.block_bytes} B blocks")

    exp = Experiment(name="multinode_fam", base=cfg, workloads=tuple(workloads),
                     T=T, axes=(flag_axis("config", CONFIGS),))
    plan = exp.plan()
    print(f"plan: {plan.num_points} systems -> {plan.num_groups} compile "
          f"group(s) {plan.describe()}")

    res = exp.run(cross_check_shard=True, device=device)
    info = res.info
    print(f"{info.systems} configurations x {len(workloads)} nodes x {T} "
          f"events: capture {info.compile_s:.1f}s + run {info.run_s:.1f}s "
          f"on {info.devices} device(s); sharded-vs-vmap bit_exact="
          f"{info.shard_check['bit_exact']}")

    base, gms = None, {}
    print(f"{'config':32s} {'gm IPC':>8s} {'gain':>6s} {'FAM lat':>8s} "
          f"{'prefetches':>10s}")
    for name in CONFIGS:
        out = res.get(config=name)
        gm = gms[name] = float(np.exp(np.mean(np.log(out["ipc"]))))
        if base is None:
            base = gm
        print(f"{name:32s} {gm:8.3f} {gm/base:6.2f}x "
              f"{np.mean(out['fam_latency']):8.0f} "
              f"{int(out['prefetches_issued'].sum()):10d}")
    return res, gms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--T", type=int, default=T, help="events a node")
    args = ap.parse_args(argv)
    run(args.device, T=args.T)


if __name__ == "__main__":
    main()
