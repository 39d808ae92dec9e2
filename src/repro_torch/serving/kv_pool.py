"""KV caches: block-paged pools with the host-side block allocator, and
the contiguous layout's capacity accounting.

Port of ``repro.serving.kv_pool`` without the prefix cache. In the paged
layout attention KV lives in shared pools of fixed-size blocks
``[num_blocks, block_size, Hkv, D]`` per layer (stacked layers carry a
leading repeats axis), in bf16, fp32, int8 or fp8 (e4m3); the 8-bit pools
carry float32 scale pools ``[num_blocks, block_size, Hkv]`` beside them,
which the byte accounting counts. Each slot owns a block-table row mapping
absolute position ``p`` to ``(table[p // block_size], p % block_size)``.
Mamba2 layers keep their float32 conv and SSM states per batch row in
either layout. The contiguous layout (``models.init_caches``) holds one
full-length row per slot, committed up front; it needs no allocator.

Invariants (as in the JAX package):

  I1. Block 0 is the reserved garbage block: unallocated table entries are
      0, so writes past a row's allocation land there and are never read.
  I2. Every allocated block belongs to exactly one slot, so the flattened
      KV writes of one window never collide outside the garbage block.
  I3. A slot's allocation covers every position its decode loop can write:
      prompt + max_new + window slack.
  I4. A released slot's table row is zeroed before its blocks can be handed
      out again, so a finished row's stale writes go to the garbage block.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..models.attention import kv_leaves
from ..models.config import SSM, ModelConfig, scan_plan
from ..models.ssm import init_mamba2_state
from ..models.transformer import check_supported, stack_layer_caches

KV_LEAVES = ("k", "v", "k_scale", "v_scale")


def blocks_for(n_tokens: int, block_size: int) -> int:
    """Blocks covering ``n_tokens`` positions (ceiling division)."""
    return -(-int(n_tokens) // block_size)


def default_num_blocks(max_batch: int, max_len: int, block_size: int) -> int:
    """Worst-case pool size (every slot filled to max_len) + garbage block."""
    return max_batch * blocks_for(max_len, block_size) + 1


def init_paged_caches(cfg: ModelConfig, batch: int, num_blocks: int,
                      block_size: int, dtype=torch.bfloat16, device="cuda"):
    """Zeroed caches with the params tree's layout: ``prefix`` holds one
    dict per prefix layer, ``scan`` one per period position with a leading
    repeats axis. Attention layers hold ``{"k", "v"}`` pools ``[NB, bs,
    Hkv, D]`` in ``dtype`` (a torch dtype or a kv-dtype name); int8 and
    fp8 add ``{"k_scale", "v_scale"}`` ``[NB, bs, Hkv]`` float32 ones, so
    the garbage block holds codes of 0 and scales of 1. Mamba2 layers keep
    ``{"conv", "ssm"}`` states of ``batch`` rows in float32."""
    check_supported(cfg)
    shape = (num_blocks, block_size, cfg.n_kv_heads, cfg.resolved_head_dim)

    def make(spec):
        if spec.mixer == SSM:
            return init_mamba2_state(cfg, batch, device)
        return kv_leaves(shape, dtype, device)

    return stack_layer_caches(scan_plan(cfg), make)


def _attn_leaves(tree, names=KV_LEAVES) -> List[torch.Tensor]:
    return [t for entry in tree["prefix"] + tree["scan"]
            for name, t in entry.items() if name in names]


def kv_capacity_bytes(tree) -> int:
    """Device bytes held by the attention KV (paged pools or contiguous
    rows) and its scales, as the JAX package counts them; Mamba2 states
    are not KV and are not counted."""
    return sum(t.numel() * t.element_size() for t in _attn_leaves(tree))


def kv_scale_bytes(tree) -> int:
    """The part of ``kv_capacity_bytes`` held by quantization scales."""
    return sum(t.numel() * t.element_size()
               for t in _attn_leaves(tree, ("k_scale", "v_scale")))


def kv_bytes_per_block(tree, num_blocks: int) -> int:
    """Bytes one pool block costs across all attention layers (0 for a
    model without attention)."""
    return kv_capacity_bytes(tree) // num_blocks


class BlockAllocator:
    """Host-side block free list + block-table shadow.

    The device copy of ``tables`` is refreshed by the executor whenever
    ``version`` changes (admission / release), so released rows' stale
    writes always route through an up-to-date table (I4).
    """

    def __init__(self, num_blocks: int, block_size: int, max_batch: int,
                 max_len: int):
        if num_blocks < 2:
            raise ValueError("need at least one block beyond the reserved 0")
        self.num_blocks = num_blocks
        self.block_size = block_size
        self.max_blocks_per_seq = blocks_for(max_len, block_size)
        # LIFO free list; block 0 reserved as the garbage block (I1)
        self.free: List[int] = list(range(num_blocks - 1, 0, -1))
        self.tables = np.zeros((max_batch, self.max_blocks_per_seq), np.int32)
        self.owned: Dict[int, List[int]] = {}
        self.version = 0

    def blocks_needed(self, n_tokens: int) -> int:
        return blocks_for(n_tokens, self.block_size)

    def can_allocate(self, n_blocks: int) -> bool:
        return len(self.free) >= n_blocks

    @property
    def blocks_in_use(self) -> int:
        return sum(len(b) for b in self.owned.values())

    def allocate(self, slot: int, n_tokens: int) -> None:
        """Claim blocks covering ``n_tokens`` positions for ``slot``."""
        if slot in self.owned:
            raise ValueError(f"slot {slot} already allocated")
        nb = self.blocks_needed(n_tokens)
        if nb > self.max_blocks_per_seq:
            # never clamp: a short allocation would break I3
            raise ValueError(
                f"{n_tokens} tokens need {nb} blocks but a sequence's block "
                f"table holds {self.max_blocks_per_seq} (max_len too small)")
        if not self.can_allocate(nb):
            raise ValueError("allocate() without can_allocate()")
        blocks = [self.free.pop() for _ in range(nb)]
        self.owned[slot] = blocks
        self.tables[slot, :] = 0
        self.tables[slot, :nb] = blocks
        self.version += 1

    def grow(self, slot: int, n_tokens: int) -> bool:
        """Extend a live slot's allocation in place to cover ``n_tokens``
        (a request switching to a wider tree template needs a larger
        write window, I3). Appends blocks to the slot's table row; returns
        False, leaving the allocation untouched, when the free list or the
        table row cannot cover it. Never shrinks: a narrower template
        stops reading the extra blocks, which free with the slot."""
        cur = self.owned.get(slot)
        if cur is None:
            raise ValueError(f"grow() on unallocated slot {slot}")
        nb = self.blocks_needed(n_tokens)
        if nb <= len(cur):
            return True
        extra = nb - len(cur)
        if nb > self.max_blocks_per_seq or not self.can_allocate(extra):
            return False
        blocks = [self.free.pop() for _ in range(extra)]
        self.tables[slot, len(cur):nb] = blocks
        cur.extend(blocks)
        self.version += 1
        return True

    def release(self, slot: int) -> List[int]:
        """Return the slot's blocks and zero its table row (I4)."""
        blocks = self.owned.pop(slot, [])
        self.free.extend(blocks)
        self.tables[slot, :] = 0
        self.version += 1
        return blocks
