"""The port's training path: step builders (:mod:`steps`) and the trainer
(:mod:`trainer`)."""
from repro_torch.train.steps import (  # noqa: F401
    abstract_train_state,
    build_decode_step,
    build_prefill_step,
    build_train_step,
    init_train_state,
    train_state_from_numpy,
)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: F401
