"""End-to-end training driver on the PyTorch port: train an LM for a few
hundred steps with the full substrate — deterministic data pipeline,
AdamW, layer-checkpointed transformer, async checkpointing, preemption
hook, straggler watchdog, and restart-exactness.

Counterpart of ``examples/train_lm.py``. Default size is small; pass
--dmodel 768 --layers 12 --steps 300 for the full ~100M run. Runs on the
card unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_train_lm.py --steps 60
"""
import argparse
import os
import tempfile

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.parallel import single_device_context
from repro_torch.train.steps import build_train_step, init_train_state
from repro_torch.train.trainer import Trainer, TrainerConfig


def train(steps=60, dmodel=256, layers=4, vocab=2048, batch=8, seq=128,
          ckpt_dir=None, resume=False, device="cuda", warmup_steps=20,
          checkpoint_every=25):
    """Train the demo LM; returns the trainer's report (asserting the loss
    fell)."""
    cfg = ModelConfig(
        name="train-demo", family="dense", num_layers=layers,
        d_model=dmodel, num_heads=max(dmodel // 64, 2),
        num_kv_heads=max(dmodel // 128, 1), d_ff=4 * dmodel,
        vocab_size=vocab)
    n = cfg.param_count()
    print(f"model: {n/1e6:.1f}M params, {steps} steps, batch {batch}x{seq}")

    ctx = single_device_context(device=device)
    model = build_model(cfg, ctx, device=device)
    state = init_train_state(model, 0)
    step_fn = build_train_step(
        model, AdamWConfig(lr=1e-3, warmup_steps=warmup_steps, total_steps=steps))

    data = SyntheticLM(DataConfig(vocab_size=vocab, seq_len=seq, global_batch=batch))
    trainer = Trainer(
        TrainerConfig(total_steps=steps, checkpoint_every=checkpoint_every,
                      checkpoint_dir=ckpt_dir or os.path.join(tempfile.gettempdir(),
                                                              "repro_torch_train_lm")),
        step_fn, state, None)
    start = trainer.maybe_restore() if resume else 0
    trainer.data_iter = iter(data.iterator(start_step=start, device=model.device))

    report = trainer.run()
    first = np.mean(report.losses[:5])
    last = np.mean(report.losses[-5:])
    print(f"loss {first:.3f} -> {last:.3f} over {report.steps} steps "
          f"({report.restarts} restarts, "
          f"{report.straggler_steps} straggler steps)")
    assert last < first, "loss did not decrease"
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--dmodel", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--vocab", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    train(args.steps, args.dmodel, args.layers, args.vocab, args.batch, args.seq,
          args.ckpt_dir, args.resume, args.device)
    print("train_lm OK")


if __name__ == "__main__":
    main()
