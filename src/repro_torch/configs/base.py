"""Config schema of the port: model architectures and the simulated
memory system.

Counterpart of ``repro.configs.base``, of which it keeps its own copy:

* :class:`ModelConfig` (with :class:`MoEConfig`, :class:`SSMConfig`,
  :class:`XLSTMConfig`), :class:`ShapeSpec` and :func:`smoke_variant`,
  field for field as in the reference;
* :class:`FamConfig` (paper Table II) and :func:`fam_replace`.
  ``kernel_backend`` selects how the per-event DRAM-cache step runs:
  ``"cuda"`` (the default) goes through the hand-written kernel in
  :mod:`repro_torch.kernels.famsim_step` (its plain PyTorch version on CPU
  tensors), ``"torch"`` forces the plain version on any device.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Optional, Tuple

KERNEL_BACKENDS = ("cuda", "torch")


# ---------------------------------------------------------------------------
# Input shapes (assigned; identical grid for every LM-family architecture)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    """One (input-shape) cell of the assigned grid."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        if self.kind == "decode":
            # one new token per sequence against a seq_len KV cache
            return self.global_batch
        return self.seq_len * self.global_batch


TRAIN_4K = ShapeSpec("train_4k", seq_len=4_096, global_batch=256, kind="train")
PREFILL_32K = ShapeSpec("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill")
DECODE_32K = ShapeSpec("decode_32k", seq_len=32_768, global_batch=128, kind="decode")
LONG_500K = ShapeSpec("long_500k", seq_len=524_288, global_batch=1, kind="decode")

ALL_SHAPES: Tuple[ShapeSpec, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
SHAPES_BY_NAME = {s.name: s for s in ALL_SHAPES}


# ---------------------------------------------------------------------------
# Model architecture config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden dim
    dense_residual: bool = False   # arctic: dense FFN in parallel with MoE
    dense_d_ff: int = 0            # hidden dim of the dense residual branch
    router_jitter: float = 0.0
    load_balance_coef: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) mixer parameters."""

    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64             # SSD head dim (P)
    n_groups: int = 1
    chunk: int = 128               # SSD chunk length for the parallel form

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block stack parameters (alternating mLSTM / sLSTM)."""

    slstm_every: int = 2           # place an sLSTM block every k-th block (rest mLSTM)
    proj_factor_mlstm: float = 2.0
    proj_factor_slstm: float = 1.3333
    chunk: int = 128               # mLSTM chunked-parallel length
    parallel_mlstm: bool = False   # §Perf: chunked-parallel mLSTM (vs scan)
    conv_width: int = 4


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyperparameters for one assigned config."""

    name: str
    family: str                    # dense | moe | hybrid | ssm | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0              # 0 -> d_model // num_heads
    activation: str = "swiglu"     # swiglu | geglu | gelu
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    position: str = "rope"         # rope | mrope | learned | none
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    logit_softcap: float = 0.0
    embedding_scale: bool = False  # gemma: scale embeddings by sqrt(d_model)
    # --- attention window (0 = full causal). Used for long-context variants.
    sliding_window: int = 0
    # --- MoE
    moe: Optional[MoEConfig] = None
    # --- hybrid (zamba2): mamba backbone with a SHARED attention block
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0            # hybrid: run shared attn block every k layers
    # --- xLSTM
    xlstm: Optional[XLSTMConfig] = None
    # --- encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_seq: int = 0           # frames after the (stubbed) conv frontend
    # --- VLM (qwen2-vl): M-RoPE sections over (t, h, w)
    mrope_sections: Tuple[int, int, int] = (0, 0, 0)
    # --- numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # --- which shape cells this arch runs (long_500k only if sub-quadratic)
    run_long_context: bool = False  # True only for sub-quadratic archs
    # --- source provenance
    source: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)

    # -- derived sizes ------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, L = self.d_model, self.num_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.xlstm is not None:
            per_layer = _xlstm_layer_params(self)
        elif self.ssm is not None:
            per_layer = _mamba2_layer_params(self)
            if self.attn_every:
                # one SHARED attention+mlp block (weights reused): count once
                emb += _attn_params(self) + _mlp_params(self, self.d_ff)
        else:
            per_layer = _attn_params(self)
            if self.moe is not None:
                per_layer += self.moe.num_experts * _mlp_params(self, self.moe.d_ff)
                per_layer += d * self.moe.num_experts  # router
                if self.moe.dense_residual:
                    per_layer += _mlp_params(self, self.moe.dense_d_ff or self.d_ff)
            else:
                per_layer += _mlp_params(self, self.d_ff)
            per_layer += 2 * d  # norms
        total = emb + L * per_layer + d  # final norm
        if self.is_encoder_decoder:
            enc_layer = _attn_params(self) + _mlp_params(self, self.d_ff) + 2 * self.d_model
            cross = self.encoder_layers and self.num_layers * (
                _attn_params(self) + self.d_model)  # cross-attn per decoder layer
            total += self.encoder_layers * enc_layer + cross
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top_k experts count)."""
        if self.moe is None:
            return self.param_count()
        d, L = self.d_model, self.num_layers
        inactive = (self.moe.num_experts - self.moe.top_k) * _mlp_params(self, self.moe.d_ff)
        return int(self.param_count() - L * inactive)

    def shapes(self) -> Tuple[ShapeSpec, ...]:
        out = [TRAIN_4K, PREFILL_32K, DECODE_32K]
        if self.run_long_context:
            out.append(LONG_500K)
        return tuple(out)

    def skipped_shapes(self) -> Tuple[str, ...]:
        return () if self.run_long_context else ("long_500k",)


def _attn_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    return d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d


def _mlp_params(cfg: ModelConfig, d_ff: int) -> int:
    gated = cfg.activation in ("swiglu", "geglu")
    return (3 if gated else 2) * cfg.d_model * d_ff


def _mamba2_layer_params(cfg: ModelConfig) -> int:
    s = cfg.ssm
    d = cfg.d_model
    d_in = s.d_inner(d)
    nh = s.n_heads(d)
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return (d * (2 * d_in + 2 * s.n_groups * s.d_state + nh)   # in_proj
            + conv_dim * s.d_conv                               # conv1d
            + nh * 2                                            # A_log, D
            + d_in * d                                          # out_proj
            + d)                                                # norm


def _xlstm_layer_params(cfg: ModelConfig) -> int:
    x = cfg.xlstm
    d = cfg.d_model
    # mLSTM block: qkv + gates + out; sLSTM: 4 gates recurrent. Use mLSTM cost
    # as the per-layer estimate (dominant and within a few % of sLSTM here).
    d_in = int(d * x.proj_factor_mlstm)
    return 2 * d * d_in + d_in * d + 3 * d_in + 2 * d


# ---------------------------------------------------------------------------
# Reduced configs for CPU smoke tests
# ---------------------------------------------------------------------------

def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """A tiny same-family config: runs a real fwd/train step on CPU."""
    kw = dict(
        num_layers=2,
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 2) or 1,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
    )
    if cfg.moe is not None:
        kw["moe"] = replace(cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2),
                            d_ff=64, dense_d_ff=64 if cfg.moe.dense_residual else 0)
    if cfg.ssm is not None:
        kw["ssm"] = replace(cfg.ssm, d_state=16, head_dim=16, chunk=16)
        kw["num_layers"] = 4 if cfg.attn_every else 2
    if cfg.attn_every:
        kw["attn_every"] = 2
    if cfg.xlstm is not None:
        kw["xlstm"] = replace(cfg.xlstm, chunk=16)
        kw["num_heads"] = 2
        kw["num_kv_heads"] = 2
        kw["head_dim"] = 32
    if cfg.is_encoder_decoder:
        kw["encoder_layers"] = 2
        kw["encoder_seq"] = 24
    if cfg.position == "mrope":
        kw["head_dim"] = 32
        kw["mrope_sections"] = (4, 6, 6)   # 16 = head_dim // 2
    name = cfg.name + "-smoke"
    return replace(cfg, name=name, **kw)


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
    # in-run telemetry windows (repro_torch.obs; 0 = off, the default): a
    # static tag in geometry_free_shape(), one graph capture per value
    telemetry: int = 0

    @property
    def num_sets(self) -> int:
        blocks = self.dram_cache_bytes // self.block_bytes
        return max(1, blocks // self.cache_ways)

    def geometry_free_shape(self) -> Tuple:
        """The shape-deciding fields minus the cache geometry: what no
        padding unifies. ``num_sets``, ``cache_ways`` and ``block_bytes``
        are not here: the planner pads the cache to the largest swept
        geometry and each system's own geometry rides in ``FamParams``."""
        return (self.prefetch_queue, self.prefetch_degree,
                self.spp_signature_bits, self.spp_pattern_entries,
                self.spp_signature_entries, self.spp_max_lookahead,
                self.core_pf_degree, self.completions_per_step,
                self.core_fill_entries, self.kernel_backend,
                self.telemetry)

    def static_shape(self) -> Tuple:
        """This config's own cache geometry (as the allocation) plus the
        geometry-free shape: configs with equal static shapes run one
        simulator program."""
        return (self.num_sets, self.cache_ways) + self.geometry_free_shape()

    @property
    def cxl_min_latency_cycles(self) -> int:
        return int(self.cxl_min_latency_ns * self.clock_ghz)

    def fam_service_cycles(self, nbytes: int) -> float:
        """Cycles of FAM DDR occupancy to move `nbytes`."""
        return nbytes / (self.fam_bw_gbps / self.clock_ghz)  # bytes / (B/cycle)


def fam_replace(cfg: FamConfig, **kw) -> FamConfig:
    return dataclasses.replace(cfg, **kw)
