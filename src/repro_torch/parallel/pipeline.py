"""Pipeline parallelism over a mesh axis (GPipe, ring ``ppermute``).

Counterpart of ``repro.parallel.pipeline`` (its ``pipeline.py:23-67``).
Each rank of the axis owns one stage; microbatches stream through the
stages by a ring ``ppermute`` (``dist.batch_isend_irecv``). With S stages
and M microbatches the loop runs S + M - 1 ticks and stage s computes
microbatch t - s at tick t; the bubble fraction is (S - 1) / (S + M - 1).
The last stage's outputs are broadcast to every stage by ``psum``.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.parallel.compat import Mesh, axis_index, axis_size, ppermute, psum


def pipeline_forward(layer_fn: Callable, mesh: Mesh, axis: str, num_stages: int,
                     microbatches: int):
    """Build fn(stage_params, x) running ``layer_fn`` as a pipeline over
    ``axis``, one stage a rank.

    stage_params: this rank's stage (the reference's slice of the stacked
    params along ``axis``); x: (M, mb, ...) microbatched input, the same on
    every rank. Returns the pipeline output (M, mb, ...) on every rank.
    ``microbatches`` is the reference's argument; M is read from x."""
    if axis_size(mesh, axis) != num_stages:
        raise ValueError(f"{num_stages} stages over axis {axis!r} of size "
                         f"{axis_size(mesh, axis)}: one stage a rank")
    del microbatches

    def staged(stage_params, x_mb: torch.Tensor) -> torch.Tensor:
        stage = axis_index(mesh, axis)
        M = x_mb.shape[0]
        ring = [(i, (i + 1) % num_stages) for i in range(num_stages)]
        buf = torch.zeros_like(x_mb)           # the last stage's outputs
        cur = x_mb[0] * 0.0                    # activation entering this stage
        for t in range(num_stages + M - 1):
            mb_idx = t - stage
            feed = x_mb[min(max(t, 0), M - 1)] if stage == 0 else cur
            active = 0 <= mb_idx < M
            out = layer_fn(stage_params, feed)
            if not active:
                out = torch.zeros_like(out)
            # pass to the next stage (ring; the last stage's output wraps unused)
            cur = ppermute(out, mesh, axis, ring)
            if stage == num_stages - 1 and active:
                buf[mb_idx] = out
        # broadcast the last stage's results to every stage
        last = buf if stage == num_stages - 1 else torch.zeros_like(buf)
        return psum(last, mesh, axis)

    return staged
