"""Roofline terms of one step, from the port's op counts.

Counterpart of ``repro.roofline.analysis`` (its ``analysis.py:93-177``).
Three terms per (arch x shape x mesh) cell, all in seconds per step:

    compute    = flops_per_device / chip.peak_flops
    memory     = bytes_per_device / chip.hbm_bw
    collective = collective_operand_bytes_per_device / (chip.links * chip.link_bw)

The counts are a rank's own: :class:`repro_torch.roofline.op_cost.OpCounter`
counts the local ops of a sharded step (a DTensor's shard, not the global
tensor), so the per-device terms need no division by the chip count.

The chip is an argument (:class:`ChipSpec`), :data:`H100_SXM` by default,
so a test can hold the terms to the reference's with the reference's own
constants. A term is a bound from counted work, not a measurement.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict


@dataclass(frozen=True)
class ChipSpec:
    """Peak rates of one chip: dense bf16 FLOP/s, memory bytes/s, and its
    links for collectives (bytes/s per link and direction)."""

    name: str
    peak_flops: float
    hbm_bw: float
    link_bw: float
    links: int


#: NVIDIA H100 SXM5 80 GB, from NVIDIA's H100 Tensor Core GPU datasheet:
#: 989 TFLOP/s dense bf16 (1,979 with sparsity), 3.35 TB/s HBM3, NVLink 4
#: at 900 GB/s a GPU, i.e. 18 links x 25 GB/s in each direction. The rates
#: assume the card's full 700 W power limit.
H100_SXM = ChipSpec("NVIDIA H100 SXM", peak_flops=989e12, hbm_bw=3.35e12,
                    link_bw=25e9, links=18)


@dataclass
class RooflineTerms:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    chips: int
    model_flops: float = 0.0     # 6*N*D (train) or 2*N_active*D (serve), global
    chip: ChipSpec = H100_SXM
    coll_bytes: Dict[str, float] = field(default_factory=dict)
    coll_count: Dict[str, float] = field(default_factory=dict)
    #: the cross-check (``op_cost`` docstring): FlopCounterMode's flops and
    #: operand + result bytes of the same ops
    xla_flops_once: float = 0.0
    xla_bytes_once: float = 0.0

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / self.chip.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / self.chip.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / (self.chip.links * self.chip.link_bw)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline lower bound: max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (counted flops summed over chips)."""
        total = self.flops_per_device * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def mfu_bound(self) -> float:
        """Roofline-implied MFU: model flops / (chips*peak*step_time)."""
        t = self.step_time_s
        if t <= 0:
            return 0.0
        return self.model_flops / (self.chips * self.chip.peak_flops * t)

    def to_dict(self) -> Dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s,
            "useful_flops_ratio": self.useful_flops_ratio,
            "mfu_bound": self.mfu_bound,
            "coll_bytes": dict(self.coll_bytes),
            "coll_count": dict(self.coll_count),
            "xla_flops_once": self.xla_flops_once,
            "xla_bytes_once": self.xla_bytes_once,
        }


def analyze(counts, chips: int, model_flops: float,
            chip: ChipSpec = H100_SXM) -> RooflineTerms:
    """The terms of a counted step: ``counts`` is an
    :class:`~repro_torch.roofline.op_cost.OpCounter` that ran the step (or
    its ``OpCost``, with no cross-check). The counter's loops ran in full,
    so the counts carry every trip, as the reference's loop-aware
    ``analyze_hlo`` does; ``xla_flops_once`` / ``xla_bytes_once`` hold the
    cross-check: ``torch.utils.flop_counter.FlopCounterMode``'s flops over
    the same local ops, and their operand + result bytes."""
    cost = getattr(counts, "cost", counts)
    return RooflineTerms(
        flops_per_device=cost.flops, bytes_per_device=cost.bytes,
        collective_bytes_per_device=cost.collective_bytes,
        chips=chips, model_flops=model_flops, chip=chip,
        coll_bytes=dict(cost.coll_bytes), coll_count=dict(cost.coll_count),
        xla_flops_once=float(getattr(counts, "flops_once", 0.0)),
        xla_bytes_once=float(getattr(counts, "bytes_once", 0.0)))
