"""AdamW for the port's trainer (:mod:`adamw`)."""
from repro_torch.optim.adamw import (  # noqa: F401
    AdamWConfig,
    adamw_update,
    adamw_update_q8,
    clip_by_global_norm,
    global_norm,
    init_opt_state,
    init_opt_state_q8,
    schedule,
)
