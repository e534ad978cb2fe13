"""The simulated memory system's configuration (paper Table II).

Counterpart of ``repro.configs.base``: only :class:`FamConfig` and
:func:`fam_replace` are carried over. ``kernel_backend`` selects how the
per-event DRAM-cache step runs: ``"cuda"`` (the default) goes through the
hand-written kernel in :mod:`repro_torch.kernels.famsim_step` (its plain
PyTorch version on CPU tensors), ``"torch"`` forces the plain version on
any device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

KERNEL_BACKENDS = ("cuda", "torch")


@dataclass(frozen=True)
class FamConfig:
    """Simulated system configuration — paper Table II.

    Latencies are in core cycles at 3.3 GHz unless noted. The simulator is
    event-granular (one LLC-miss event per node per step) with a
    bandwidth/queueing model at the FAM controller.
    """

    # cores / cache front-end
    clock_ghz: float = 3.3
    cores_per_node: int = 2            # scaled node stream (Table II has 8
                                       # OoO cores; the simulated system is
                                       # scaled down like the paper does)
    base_ipc: float = 2.0              # achievable IPC per core, no FAM stalls
    mlp: float = 6.0                   # per-core memory-level parallelism
    llc_latency: int = 30
    # local memory (DDR4-3200, 2ch 2rank)
    local_mem_latency: int = 90        # ~27 ns row hit + controller, in cycles
    local_mem_bw_gbps: float = 51.2    # 2ch DDR4-3200
    # CXL fabric (Table II)
    cxl_min_latency_ns: float = 70.0
    cxl_bw_gbps: float = 128.0         # per direction
    cxl_flit_bytes: int = 256
    # pooled FAM device (DDR4-2400, 2ch 2rank)
    fam_mem_latency: int = 110
    fam_bw_gbps: float = 38.4          # 2ch DDR4-2400
    fam_queue_depth: int = 1024
    # DRAM cache (§III)
    dram_cache_bytes: int = 16 << 20   # 16 MB default (fig. 16 sweeps 4-32 MB)
    block_bytes: int = 256             # sub-page block (fig. 8 sweeps 64-4096)
    demand_bytes: int = 64             # LLC line
    cache_ways: int = 16
    # prefetcher (§III-A)
    prefetch_degree: int = 4
    prefetch_queue: int = 64           # per-node, scaled with the stream
                                       # (Table II: 256 at full scale)
    # core-side prefetch / fill micro-architecture (static shapes)
    core_pf_degree: int = 2            # stride-prefetch lines per trigger
    completions_per_step: int = 8      # prefetch fills retired per event
    core_fill_entries: int = 64        # LLC fill-buffer entries (core pf)
    spp_signature_bits: int = 12
    spp_pattern_entries: int = 4096
    spp_signature_entries: int = 1024
    spp_confidence_threshold: float = 0.25
    spp_max_lookahead: int = 8
    # BW adaptation (§IV-B)
    sample_interval: int = 512         # events per sampling cycle
    latency_noise_threshold: float = 1.25
    mimd_increase: float = 1.125
    ema_alpha: float = 0.25
    min_issue_rate: float = 0.05
    # WFQ (§IV-A): finite FAM-side prefetch input queue -> CXL backpressure
    wfq_backlog_cap: float = 2000.0    # cycles of queued prefetch service
    wfq_weight: int = 2
    wfq_quantum: int = 1
    wfq_max_deficit: int = 8
    # topology
    num_nodes: int = 1
    allocation_ratio: int = 8          # FAM:DRAM footprint ratio (§V-A def 4)
    # cache-step implementation: "cuda" = the hand-written kernel (its plain
    # version on CPU tensors), "torch" = the plain version on any device
    kernel_backend: str = "cuda"
    # in-run telemetry windows (0 = off); not ported yet, must stay 0
    telemetry: int = 0

    @property
    def num_sets(self) -> int:
        blocks = self.dram_cache_bytes // self.block_bytes
        return max(1, blocks // self.cache_ways)

    @property
    def cxl_min_latency_cycles(self) -> int:
        return int(self.cxl_min_latency_ns * self.clock_ghz)

    def fam_service_cycles(self, nbytes: int) -> float:
        """Cycles of FAM DDR occupancy to move `nbytes`."""
        return nbytes / (self.fam_bw_gbps / self.clock_ghz)  # bytes / (B/cycle)


def fam_replace(cfg: FamConfig, **kw) -> FamConfig:
    return dataclasses.replace(cfg, **kw)
