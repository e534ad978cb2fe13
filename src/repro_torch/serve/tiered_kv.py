"""Tiered paged KV cache: the paper's DRAM-cache prefetching applied to
decode serving.

Counterpart of ``repro.serve.tiered_kv``. KV for a long context lives as
fixed-size token blocks in a two-tier pool: the slow (pooled) tier holds
all blocks, the fast tier caches hot blocks under ``TieredBlockPool``
(set-assoc LRU metadata, SPP over the block-id stream, DWRR
demand/prefetch arbitration). Each decode step:

1. the access pattern is the sequence's block list that attention needs
   (blocks [0..n] for full attention, the trailing window otherwise);
2. ``TieredBlockPool.access`` demand-fills misses and prefetches
   predictions;
3. attention reads the resident blocks from the fast pool through the
   ``paged_attention`` kernel (block table = fast slots), which takes the
   pool's K and V halves as strided views, without a copy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.configs.base import FamConfig
from repro_torch.core.tiering import TieredBlockPool, TierState
from repro_torch.kernels.paged_attention import decode_attention


@dataclass
class TieredKVConfig:
    block_tokens: int = 16          # tokens per KV block ("sub-page block")
    fast_blocks: int = 64           # fast-tier capacity (blocks)
    window_blocks: int = 0          # 0 = full attention


class TieredKV:
    """Single-layer tiered KV pool (per kv-head-packed layout).

    One pool block holds ``block_tokens`` tokens of K and V for all kv
    heads: (2, T, Hkv, D) flattened.
    """

    def __init__(self, fam_cfg: FamConfig, kv_cfg: TieredKVConfig,
                 max_blocks: int, kv_heads: int, head_dim: int,
                 dtype=torch.float32, device="cuda"):
        self.kv_cfg = kv_cfg
        self.Hkv, self.D = kv_heads, head_dim
        self.T = kv_cfg.block_tokens
        self.elems = 2 * self.T * kv_heads * head_dim
        self.pool = TieredBlockPool(
            fam_cfg, num_blocks=max_blocks, fast_blocks=kv_cfg.fast_blocks,
            block_elems=self.elems, page_span=16, dtype=dtype, device=device)
        self.dtype = dtype
        self.device = self.pool.device

    def pack(self, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        """k/v: (S, Hkv, D) with S = max_blocks*T -> slow region blocks on
        the pool's device."""
        S = k.shape[0]
        nb = S // self.T
        kv = torch.stack([k, v], 0).to(self.device)     # (2, S, Hkv, D)
        kv = kv.reshape(2, nb, self.T, self.Hkv, self.D).permute(1, 0, 2, 3, 4)
        return kv.reshape(nb, self.elems).to(self.dtype)

    def init(self, slow_blocks: torch.Tensor) -> TierState:
        return self.pool.init(slow_blocks)

    def decode_step(self, st: TierState, slow: torch.Tensor, q: torch.Tensor,
                    length) -> Tuple[TierState, torch.Tensor]:
        """q: (Hq, D) one token's queries; length: valid tokens (an int or
        a 0-d int tensor).

        Returns (state, attn_out (Hq, D)). Touches the blocks the window
        needs, then runs paged attention over fast-tier slots."""
        kvc = self.kv_cfg
        dev = self.device
        nb_total = slow.shape[0]
        length = torch.as_tensor(length, dtype=torch.int32).to(dev)
        n_blocks = (length + self.T - 1) // self.T
        if kvc.window_blocks:
            first = torch.clamp(n_blocks - kvc.window_blocks, min=0)
            count = kvc.window_blocks
        else:
            first = torch.zeros((), dtype=torch.int32, device=dev)
            count = nb_total
        pos = first + torch.arange(count, dtype=torch.int32, device=dev)
        ids = torch.clamp(pos, 0, nb_total - 1)
        live = pos < n_blocks
        ids = torch.where(live, ids, ids[0])
        st, slots = self.pool.access(st, slow, ids)

        # the fast region as a paged pool: K and V are strided views
        fast = st.fast.view(-1, 2, self.T, self.Hkv, self.D)
        table = torch.where(live, slots, 0)[None]       # (1, count)
        eff_len = length - first * self.T if kvc.window_blocks else length
        out = decode_attention(q[None], fast[:, 0], fast[:, 1], table,
                               eff_len.reshape(1).to(torch.int32),
                               self.pool.cfg.kernel_backend)
        return st, out[0]
