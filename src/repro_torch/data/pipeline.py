"""Deterministic synthetic LM data pipeline.

Counterpart of ``repro.data.pipeline``: batches are a pure function of
(seed, step), so a restart from a checkpoint needs no data state. The
token stream is a mixture of Zipf-distributed unigrams with a Markov
bigram rule, so the loss decreases. :meth:`SyntheticLM._batch_np` is the
reference's, line for line (numpy's ``default_rng((seed, step))``); the
port only moves the arrays to a torch device. A host thread prefetches
batches ahead of the training loop.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    bigram_jump: int = 7     # deterministic bigram successor offset


def to_device(arrays: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def _batch_np(self, step: int) -> Dict[str, np.ndarray]:
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        B, S, V = c.global_batch, c.seq_len, c.vocab_size
        # zipf unigram draws, folded into vocab
        base = rng.zipf(c.zipf_a, size=(B, S)) % V
        # half the positions follow a deterministic bigram rule -> learnable
        follow = rng.random((B, S)) < 0.5
        shifted = (np.roll(base, 1, axis=1) * c.bigram_jump + 1) % V
        tokens = np.where(follow, shifted, base).astype(np.int32)
        labels = np.roll(tokens, -1, axis=1)
        labels[:, -1] = 0
        return {"tokens": tokens, "labels": labels}

    def batch(self, step: int, device="cuda") -> Dict[str, torch.Tensor]:
        """``tokens`` and ``labels`` (B, S) int32 on ``device``."""
        return to_device(self._batch_np(step), resolve_device(device))

    def iterator(self, start_step: int = 0, prefetch: int = 2, device="cuda"
                 ) -> Iterator[Dict[str, torch.Tensor]]:
        """Host prefetch thread: generation overlaps device compute."""
        dev = resolve_device(device)
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                try:
                    q.put(self._batch_np(step), timeout=0.5)
                    step += 1
                except queue.Full:
                    continue

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield to_device(q.get(), dev)
        finally:
            stop.set()
