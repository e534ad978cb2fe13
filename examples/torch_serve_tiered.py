"""Serving driver on the PyTorch port: batched generation with the Engine,
plus the paper's tiered-KV mechanism on a long-context decode — KV blocks
live in the pooled tier, the HBM cache + SPP prefetcher serve the decode
stream, attention reads resident blocks through the hand-written
paged-attention kernel (its plain version on the CPU).

Counterpart of ``examples/serve_tiered.py``.

Run:  PYTHONPATH=src python examples/torch_serve_tiered.py [--device cpu]
"""
import argparse

import torch

from repro_torch.configs.base import FamConfig, fam_replace
from repro_torch.configs.registry import get_config
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import build_model
from repro_torch.serve.engine import Engine, ServeConfig
from repro_torch.serve.tiered_kv import TieredKV, TieredKVConfig


def demo_engine(device="cuda", arch="granite-3-2b-smoke", batch=4, prompt=16,
                new_tokens=12):
    print("== batched generation (granite smoke config) ==")
    cfg = get_config(arch)
    model = build_model(cfg, None, device=device)
    params = model.init(0)
    engine = Engine(model, params, ServeConfig(max_new_tokens=new_tokens))
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                            generator=torch.Generator().manual_seed(1)).to(model.device)
    gen, stats = engine.generate({"tokens": prompts})
    print(f"  generated {gen.shape} tokens, e.g. {gen[0].tolist()}")
    return gen


def demo_tiered_kv(device="cuda", context=512, step=64, Hq=8, Hkv=2, D=32):
    print("== tiered KV decode (paper mechanism on the KV block stream) ==")
    # full attention needs every context block resident: capacity 2x the
    # 32-block context (set-assoc conflicts aside); the windowed variant in
    # tests/test_torch_tiering.py shows the cache-pressure regime
    dev = resolve_device(device)
    fam = fam_replace(FamConfig(), cache_ways=8)
    kvc = TieredKVConfig(block_tokens=16, fast_blocks=2 * context // 16)
    tk = TieredKV(fam, kvc, max_blocks=context // 16, kv_heads=Hkv, head_dim=D,
                  device=dev)
    gen = torch.Generator().manual_seed(2)
    k = torch.randn((context, Hkv, D), generator=gen).to(dev)
    v = torch.randn((context, Hkv, D), generator=gen).to(dev)
    slow = tk.pack(k, v)
    st = tk.init(slow)
    errs = []
    for length in range(step, context + 1, step):     # growing context decode
        q = torch.randn((Hq, D), generator=torch.Generator().manual_seed(length)).to(dev)
        st, out = tk.decode_step(st, slow, q, length)
        ref = flash_attention_ref(q[None, None], k[None, :length],
                                  v[None, :length], causal=False)[0, 0]
        errs.append(float((out - ref).abs().max()))
    hr = float(tk.pool.hit_rate(st))
    print(f"  {len(errs)} decode steps over growing context: max err {max(errs):.2e}, "
          f"fast-tier hit rate {hr:.2f}, "
          f"{int(st.prefetches)} prefetches issued")
    assert max(errs) < 5e-4
    return max(errs), hr


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--context", type=int, default=512,
                    help="tokens of the tiered-KV context (a multiple of 64)")
    ap.add_argument("--new-tokens", type=int, default=12, help="tokens the Engine generates")
    args = ap.parse_args(argv)
    demo_engine(args.device, new_tokens=args.new_tokens)
    demo_tiered_kv(args.device, context=args.context)
    print("serve_tiered OK")


if __name__ == "__main__":
    main()
