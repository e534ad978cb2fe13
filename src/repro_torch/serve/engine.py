"""Batched serving engine: prefill + decode loop with greedy/temperature
sampling over any zoo model.

Counterpart of ``repro.serve.engine`` (``ServeConfig``, ``Engine``). One
prefill (of the tokens and the family's extras: ``positions`` for
M-RoPE, ``frames`` for the audio family), its KV caches grown to ``S +
max_new_tokens`` positions (recurrent states pass through), then
``max_new_tokens - 1`` decode steps at positions ``S, S + 1, ...``.
Greedy sampling is ``argmax`` (the first index on ties, as
``jnp.argmax``). Temperature sampling draws with
``torch.multinomial`` from a ``torch.Generator`` seeded with
``ServeConfig.seed``: it cannot reproduce the reference's threefry draws,
only their distribution. The sampled tokens stay on the device and come
to the host in one copy at the end.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.models.model_zoo import Model, pad_cache


@dataclass
class ServeConfig:
    max_new_tokens: int = 32
    temperature: float = 0.0       # 0 = greedy
    seed: int = 0


class Engine:
    """Simple synchronous batch engine: one batch, prefill then decode."""

    def __init__(self, model: Model, params: nn.Module, cfg: ServeConfig):
        self.model = model
        self.params = params
        self.cfg = cfg

    @torch.no_grad()
    def generate(self, batch: Dict[str, torch.Tensor]) -> Tuple[np.ndarray, Dict]:
        """batch: prefill inputs on the model's device: ``tokens`` (B, S)
        and the family's extras (``positions`` (3, B, S), ``frames`` (B,
        encoder_seq, d_model)).

        Returns (generated (B, max_new_tokens) int32, stats)."""
        cfg = self.cfg
        B, S = batch["tokens"].shape
        logits, cache = self.model.prefill(self.params, batch)
        cache = pad_cache(cache, S + cfg.max_new_tokens)
        gen = torch.Generator(device=logits.device).manual_seed(cfg.seed)
        tok = self._sample(logits, gen)
        outs = [tok]
        for t in range(1, cfg.max_new_tokens):
            db = {"tokens": tok[:, None], "index": S + t - 1}
            logits, cache = self.model.decode(self.params, cache, db)
            tok = self._sample(logits, gen)
            outs.append(tok)
        out = torch.stack(outs, dim=1).cpu().numpy()
        return out, {"prefill_len": S, "new_tokens": cfg.max_new_tokens}

    def _sample(self, logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        if self.cfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        probs = torch.softmax(logits.to(torch.float32) / self.cfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)
