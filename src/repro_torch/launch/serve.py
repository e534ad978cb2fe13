"""Serving launcher: ``--arch <id>`` -> batched generation with the Engine.

Counterpart of ``repro.launch.serve``: every architecture of the
registry. Weights are random, drawn on the device from ``--seed``; the
prompts are random ids from a ``torch.Generator`` seeded with ``--seed +
1``, and the audio family's frames standard normals from one seeded with
``--seed + 2`` (both drawn on the CPU, so every device gets the same
inputs); M-RoPE's three position planes are ``arange(S)`` each. Runs on
the card unless ``--device cpu``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b-smoke \\
        --device cpu --batch 4 --prompt-len 16 --max-new 24 --temperature 0.8
"""
from __future__ import annotations

import argparse
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import get_config
    from repro_torch.models import build_model
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = get_config(args.arch)
    model = build_model(cfg, device=args.device)
    params = model.init(args.seed)
    engine = Engine(model, params,
                    ServeConfig(max_new_tokens=args.max_new,
                                temperature=args.temperature,
                                seed=args.seed))
    prompts = torch.Generator().manual_seed(args.seed + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                                     generator=prompts).to(model.device)}
    if cfg.position == "mrope":
        batch["positions"] = torch.arange(args.prompt_len, dtype=torch.int32,
                                          device=model.device).expand(
            3, args.batch, args.prompt_len)
    if cfg.is_encoder_decoder:
        frames = torch.Generator().manual_seed(args.seed + 2)
        batch["frames"] = torch.randn((args.batch, cfg.encoder_seq, cfg.d_model),
                                      generator=frames).to(model.device)

    t0 = time.perf_counter()
    gen, stats = engine.generate(batch)
    dt = time.perf_counter() - t0
    tps = args.batch * args.max_new / dt
    print(f"arch={cfg.name} generated {gen.shape[0]}x{gen.shape[1]} tokens "
          f"in {dt:.2f}s ({tps:.1f} tok/s on this backend)")
    for row in gen[: min(3, len(gen))]:
        print("  ", row.tolist())


if __name__ == "__main__":
    main()
