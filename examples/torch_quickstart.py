"""Quickstart of the PyTorch port: the three layers of this framework in
one run, on the card (``--device cpu`` for the CPU).

Counterpart of ``examples/quickstart.py``, through ``repro_torch``'s
public API:

1. paper core — run the FAM simulator: DRAM-cache prefetching vs baseline;
2. production tiering — TieredBlockPool serving a block stream (SPP+DWRR);
3. model zoo — the loss of a reduced assigned architecture.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu] [--T 8000]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.base import FamConfig, fam_replace
from repro_torch.configs.registry import get_config
from repro_torch.core.famsim import SimFlags, simulate
from repro_torch.core.tiering import TieredBlockPool
from repro_torch.models import build_model
from repro_torch.parallel import single_device_context


def demo_simulator(device="cuda", T=8000):
    print("== 1. FAM simulator (paper §V, 1 node, bwaves-like stream) ==")
    cfg = FamConfig()
    base = simulate(cfg, SimFlags(core_prefetch=False, dram_prefetch=False),
                    ["603.bwaves_s"], T=T, device=device)
    pf = simulate(cfg, SimFlags(), ["603.bwaves_s"], T=T, device=device)
    print(f"  baseline IPC {base['ipc'][0]:.3f} | +core+DRAM-cache prefetch "
          f"{pf['ipc'][0]:.3f}  (gain {pf['ipc'][0]/base['ipc'][0]:.2f}x)")
    print(f"  FAM latency {base['fam_latency'][0]:.0f} -> "
          f"{pf['fam_latency'][0]:.0f} cycles; demand hit fraction "
          f"{pf['demand_hit_fraction'][0]:.2f}")
    return base, pf


def demo_tiering(device="cuda", num_blocks=256, fast_blocks=32, block_elems=64,
                 walk=96):
    print("== 2. TieredBlockPool (HBM cache over the pooled tier) ==")
    cfg = fam_replace(FamConfig(), cache_ways=4)
    pool = TieredBlockPool(cfg, num_blocks=num_blocks, fast_blocks=fast_blocks,
                           block_elems=block_elems, dtype=torch.float32, device=device)
    slow = torch.arange(num_blocks * block_elems, dtype=torch.float32,
                        device=pool.device).reshape(num_blocks, block_elems)
    st = pool.init(slow)
    for i in range(0, walk, 4):                     # streaming block walk
        ids = torch.arange(i, i + 4, dtype=torch.int32, device=pool.device) % num_blocks
        st, slots = pool.access(st, slow, ids)
        torch.testing.assert_close(pool.read(st, slots), slow[ids.long()],
                                   rtol=0, atol=0)
    hit_rate = float(pool.hit_rate(st))
    print(f"  hit rate {hit_rate:.2f} with {int(st.prefetches)} SPP prefetches "
          "(correctness verified)")
    return hit_rate


def demo_model(device="cuda", arch="zamba2-2.7b-smoke", batch=2, seq=32):
    print("== 3. Model zoo (zamba2 reduced config, its loss) ==")
    cfg = get_config(arch)
    m = build_model(cfg, single_device_context(device=device, remat="none"), device=device)
    params = m.init(0)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                           generator=torch.Generator().manual_seed(1)).to(m.device)
    with torch.no_grad():
        loss, _ = m.loss(params, {"tokens": tokens, "labels": tokens})
    print(f"  {cfg.name}: loss {float(loss):.3f} "
          f"(~ln vocab {np.log(cfg.vocab_size):.3f})")
    return float(loss)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--T", type=int, default=8000, help="simulated events")
    args = ap.parse_args(argv)
    demo_simulator(args.device, T=args.T)
    demo_tiering(args.device)
    demo_model(args.device)
    print("quickstart OK")


if __name__ == "__main__":
    main()
