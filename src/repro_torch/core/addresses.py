"""Address math for sub-page block caching (paper §III).

Counterpart of ``repro.core.addresses``. Node physical addresses are
decomposed as  page | block | offset:
    page  = addr >> page_bits
    block = (addr >> block_bits) & (blocks_per_page - 1)

The classic forms take ``block_bytes`` as a Python int (shift amounts
constant); the ``dyn_*`` forms take ``block_bits`` as a tensor (one value
per simulated system), which is how the simulator uses them. Both give
identical integers for identical inputs.
"""
from __future__ import annotations

import torch

PAGE_BITS = 12  # 4 KiB pages


def block_bits(block_bytes: int) -> int:
    return int(block_bytes).bit_length() - 1


def split(addr, block_bytes: int):
    """addr (cache-line granular, in bytes) -> (page, block_in_page)."""
    bb = block_bits(block_bytes)
    page = addr >> PAGE_BITS
    block = (addr >> bb) & ((1 << (PAGE_BITS - bb)) - 1)
    return page, block


def block_addr(addr, block_bytes: int):
    """Global block index of a byte address."""
    return addr >> block_bits(block_bytes)


def blocks_per_page(block_bytes: int) -> int:
    return 1 << (PAGE_BITS - block_bits(block_bytes))


def from_page_block(page, block, block_bytes: int):
    return (page << (PAGE_BITS - block_bits(block_bytes))) + block


def dyn_block_bits(block_bytes) -> torch.Tensor:
    """``31 - clz(b)`` on int32: floor(log2(b)) for b > 0, -1 for b == 0
    and 31 for b < 0 (the sign bit), exact for every int32."""
    b = torch.as_tensor(block_bytes, dtype=torch.int32)
    log2 = torch.floor(torch.log2(b.clamp(min=1).double())).to(torch.int32)
    return torch.where(b > 0, log2,
                       torch.where(b < 0, 31, -1).to(torch.int32))


def dyn_blocks_per_page(block_bits):
    """``blocks_per_page`` with a tensor ``block_bits`` shift amount."""
    return torch.bitwise_left_shift(
        torch.ones_like(block_bits, dtype=torch.int32), PAGE_BITS - block_bits)


def dyn_split(addr, block_bits):
    """-> (page, block_in_page) with a tensor ``block_bits``."""
    page = addr >> PAGE_BITS
    block = (addr >> block_bits) & (dyn_blocks_per_page(block_bits) - 1)
    return page, block


def dyn_block_addr(addr, block_bits):
    """Global block index with a tensor ``block_bits`` shift amount."""
    return addr >> block_bits
