"""Training launcher: ``--arch <id>`` -> a training run through the
port's train step, trainer and checkpointer.

Counterpart of ``repro.launch.train``. The model is built with the
reference's parallel context: :func:`repro_torch.parallel.single_device_context`
on ``--device`` (a one-rank process group), so MoE layers take the
expert-parallel ``moe_sharded`` as the reference's launcher does; with
``--production`` / ``--multi-pod`` a context over the 16 x 16 / 2 x 16 x
16 production mesh, which needs a ``torch.distributed`` job of that many
ranks (else ``RuntimeError``, as the reference's). Weights are random from
seed 0 and the data is :class:`repro_torch.data.pipeline.SyntheticLM`;
runs on the card unless ``--device cpu``. The first line printed names
the mesh.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m-smoke \\
        --device cpu --steps 6
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-moe-1b-a400m \\
        --steps 50 --batch 4 --seq 2048 --optimizer adamw_q8
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adamw_q8"])
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--checkpoint-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--production", action="store_true",
                    help="16x16 production mesh (requires 256 ranks)")
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.parallel.sharding import ParallelContext, single_device_context
    from repro_torch.train.steps import build_train_step, init_train_state
    from repro_torch.train.trainer import Trainer, TrainerConfig

    cfg = get_config(args.arch)
    if args.production:
        mesh = make_production_mesh(multi_pod=args.multi_pod)
        ctx = ParallelContext(mesh=mesh, dp_axes=("pod", "data"))
    else:
        ctx = single_device_context(device=args.device)
    model = build_model(cfg, ctx, device=args.device)
    n = cfg.param_count()
    print(f"arch={cfg.name} params={n/1e6:.1f}M mesh={dict(ctx.mesh.shape)} "
          f"device={model.device} steps={args.steps}")

    state = init_train_state(model, 0, optimizer=args.optimizer)
    step_fn = build_train_step(
        model, AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                           total_steps=args.steps),
        microbatches=args.microbatches, optimizer=args.optimizer)

    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size,
                                  seq_len=args.seq,
                                  global_batch=args.batch))
    trainer = Trainer(
        TrainerConfig(total_steps=args.steps,
                      checkpoint_every=args.checkpoint_every,
                      checkpoint_dir=args.ckpt_dir),
        step_fn, state, None,
        on_straggler=lambda s, f: print(f"[watchdog] step {s} {f:.1f}x slow"))
    start = trainer.maybe_restore() if args.resume else 0
    trainer.data_iter = iter(data.iterator(start_step=start, device=model.device))
    report = trainer.run()
    print(f"done: loss {np.mean(report.losses[:3]):.3f} -> "
          f"{np.mean(report.losses[-3:]):.3f}; "
          f"{report.straggler_steps} straggler steps; "
          f"checkpoints in {args.ckpt_dir}")
    return report


if __name__ == "__main__":
    main()
