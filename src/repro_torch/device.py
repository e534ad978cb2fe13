"""Where the port's entry points run: ``device="cuda"`` (their default)
needs a CUDA device and never falls back to the CPU."""
from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; ``"cuda"`` becomes the current card
    (``cuda:N``), so it compares equal to the device of the tensors made
    on it."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' but no CUDA device is available; "
                               "pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
