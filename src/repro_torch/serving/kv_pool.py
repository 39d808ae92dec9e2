"""KV caches: block-paged pools with the host-side block allocator, and
the contiguous layout's capacity accounting.

Port of ``repro.serving.kv_pool`` for one replica (the cross-replica
``PrefixIndex`` is dp > 1 work). In the paged
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
      0, so writes past a row's allocation land there and are never read
      (validity is ``position < kv_len``).
  I2. Every block a slot can WRITE is owned by exactly one slot (refcount
      1), so the flattened KV writes of one window never collide outside
      the garbage block. Prefix-cached blocks map into several tables at
      once (refcount = mappers) but are read-only: every position a row
      writes lies past its shared prefix, and ``copy_on_write`` is the
      escape hatch.
  I3. A slot's allocation covers every position its decode loop can write:
      prompt + max_new + window slack.
  I4. A released slot's table row is zeroed before its blocks can be handed
      out again, so a finished row's stale writes go to the garbage block.
  I5. A block is on the free list or the eviction LRU iff its refcount is
      zero; matching returns only COMPUTED blocks (content fully written
      by the registering row's prefill), so a hit never serves
      half-prefilled KV.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

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


def prefix_block_keys(prompt, block_size: int,
                      kv_dtype: str = "bf16") -> List[bytes]:
    """Content-chained cache keys for the FULL blocks inside ``prompt[:-1]``
    (the region admission prefills: the last prompt token is re-read by
    the first verify window and its block is written by decode).

    ``key[i]`` is the raw bytes of the token prefix ``prompt[:(i+1)*bs]``
    as int32, so two prompts share a key iff they share those tokens
    verbatim (no hash collisions; a block's key embeds every preceding
    token). Target and draft KV are keyed together: both pools cache the
    same positions through one block table. Keys are salted with
    ``kv_dtype`` ("bf16", "fp32", "int8", "fp8"): a block holds the
    dtype's encoding, so one prefix under two kv dtypes never aliases.
    The bytes equal the JAX package's keys."""
    p = np.ascontiguousarray(np.asarray(prompt, np.int32))
    n_full = max(0, (len(p) - 1)) // block_size
    salt = kv_dtype.encode() + b"|"
    return [salt + p[:(i + 1) * block_size].tobytes() for i in range(n_full)]


class BlockAllocator:
    """Host-side refcounted block allocator, block-table shadow and prompt
    prefix cache.

    The device copy of ``tables`` is refreshed by the executor whenever
    ``version`` changes (admission / growth / release / copy-on-write), so
    released rows' stale writes always route through an up-to-date table
    (I4).

    Prefix caching: ``allocate(..., keys=)`` registers the row's full
    prompt blocks under ``prefix_block_keys``; the scheduler marks them
    computed as the chunked-prefill cursor passes them. ``match_prefix``
    returns the longest run of computed cached blocks for a new prompt;
    ``allocate(..., prefix=)`` maps them copy-free into the new row's
    table (refcount + 1), so the row prefills only the uncovered tail.
    Released cached blocks (refcount 0) park on an LRU instead of the free
    list and are evicted (unregistered, then reused) only when allocation
    outgrows the free list.
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
        self.ref = np.zeros(num_blocks, np.int32)     # mappers per block
        self.index: Dict[bytes, int] = {}             # cache key -> block
        self.block_key: Dict[int, bytes] = {}         # block -> cache key
        self.computed: set = set()                    # content fully written
        self.lru: "OrderedDict[int, None]" = OrderedDict()  # ref-0 cached
        # slot -> table indices mapped read-only (prefix-matched blocks);
        # copy_on_write drops an index once the slot owns a private copy
        self.read_only: Dict[int, set] = {}
        self.version = 0

    # -- queries ---------------------------------------------------------
    def blocks_needed(self, n_tokens: int) -> int:
        return blocks_for(n_tokens, self.block_size)

    def can_allocate(self, n_blocks: int, prefix: Sequence[int] = ()) -> bool:
        """True when ``n_blocks`` fresh blocks are claimable (free list plus
        evictable ref-0 cached blocks). Pass the ``prefix`` blocks an
        admission maps as well: those parked on the LRU leave it in
        ``allocate`` and must not count as reclaimable too."""
        lru_hits = sum(1 for b in prefix if b in self.lru)
        return len(self.free) + len(self.lru) - lru_hits >= n_blocks

    @property
    def blocks_in_use(self) -> int:
        """Unique blocks mapped by live slots (a shared block counts once)."""
        return int((self.ref > 0).sum())

    def match_prefix(self, keys: Sequence[bytes]) -> List[int]:
        """Longest run of cached, computed blocks covering ``keys`` from the
        front (I5: a half-prefilled registration never matches). A pure
        query: refcounts move in ``allocate(prefix=...)``."""
        out: List[int] = []
        for key in keys:
            b = self.index.get(key)
            if b is None or b not in self.computed:
                break
            out.append(b)
        return out

    # -- internals -------------------------------------------------------
    def _unregister(self, block: int) -> None:
        key = self.block_key.pop(block, None)
        if key is not None and self.index.get(key) == block:
            del self.index[key]
        self.computed.discard(block)

    def _take_block(self) -> int:
        """A writable block: the free list first, then the least recently
        parked LRU block, unregistered before reuse so a stale key never
        resolves to new content."""
        if self.free:
            return self.free.pop()
        block, _ = self.lru.popitem(last=False)
        self._unregister(block)
        return block

    # -- mutation --------------------------------------------------------
    def allocate(self, slot: int, n_tokens: int, prefix: Sequence[int] = (),
                 keys: Sequence[bytes] = ()) -> None:
        """Claim blocks covering ``n_tokens`` positions for ``slot``.

        ``prefix``: cached blocks from ``match_prefix``, mapped copy-free
        as the row's leading blocks (refcount + 1, read-only for this row:
        its first written position lies past them). ``keys``: the row's
        ``prefix_block_keys``; its full prompt blocks register under them
        (the first registration wins when identical prompts race)."""
        if slot in self.owned:
            raise ValueError(f"slot {slot} already allocated")
        nb = self.blocks_needed(n_tokens)
        if nb > self.max_blocks_per_seq:
            # never clamp: a short allocation would break I3
            raise ValueError(
                f"{n_tokens} tokens need {nb} blocks but a sequence's block "
                f"table holds {self.max_blocks_per_seq} (max_len too small)")
        prefix = list(prefix)
        if len(prefix) > nb:
            raise ValueError("prefix longer than the allocation")
        if not self.can_allocate(nb - len(prefix), prefix):
            raise ValueError("allocate() without can_allocate()")
        # take the shared references first, so eviction below never
        # reclaims a matched block
        for b in prefix:
            if self.ref[b] == 0:
                self.lru.pop(b)
            self.ref[b] += 1
        fresh = [self._take_block() for _ in range(nb - len(prefix))]
        for b in fresh:
            self.ref[b] = 1
        blocks = prefix + fresh
        self.owned[slot] = blocks
        self.read_only[slot] = set(range(len(prefix)))
        for i, key in enumerate(keys[:nb]):
            b = blocks[i]
            if key not in self.index and b not in self.block_key:
                self.index[key] = b
                self.block_key[b] = key
        self.tables[slot, :] = 0
        self.tables[slot, :nb] = blocks
        self.version += 1

    def mark_computed(self, slot: int, n_tokens: int) -> None:
        """Flag the slot's registered blocks that ``n_tokens`` valid cache
        positions (the prefill cursor) cover in full as matchable (I5)."""
        for i, b in enumerate(self.owned.get(slot, ())):
            if (i + 1) * self.block_size > n_tokens:
                break
            if b in self.block_key:
                self.computed.add(b)

    def grow(self, slot: int, n_tokens: int) -> bool:
        """Extend a live slot's allocation in place to cover ``n_tokens``
        (a request switching to a wider tree template needs a larger
        write window, I3). Appends blocks to the slot's table row; returns
        False, leaving the allocation untouched, when the pool or the
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
        blocks = [self._take_block() for _ in range(extra)]
        for b in blocks:
            self.ref[b] = 1
        self.tables[slot, len(cur):nb] = blocks
        cur.extend(blocks)
        self.version += 1
        return True

    def copy_on_write(self, slot: int,
                      block_idx: int) -> Optional[Tuple[int, int]]:
        """Make the slot's ``block_idx``-th block privately writable.

        Returns ``(old, new)`` when a fresh block was mapped: the caller
        must copy the device KV ``old -> new`` in every pool
        (``Executor.copy_block``) before the next forward. Returns None
        when the block was already exclusive (a sole-owner cached block is
        unregistered instead: its content is about to leave its key)."""
        blocks = self.owned[slot]
        old = blocks[block_idx]
        if self.ref[old] == 1:
            if old in self.block_key:
                self._unregister(old)
            self.read_only.get(slot, set()).discard(block_idx)
            return None
        if not self.can_allocate(1):
            # the caller needs the write: skipping the copy would corrupt
            # a shared block, so this is a hard error
            raise RuntimeError(
                f"copy-on-write of shared block {old} needs a free block "
                f"but the pool is exhausted; raise kv_num_blocks")
        new = self._take_block()
        self.ref[new] = 1
        self.ref[old] -= 1
        blocks[block_idx] = new
        self.read_only.get(slot, set()).discard(block_idx)
        self.tables[slot, block_idx] = new
        self.version += 1
        return old, new

    def release(self, slot: int) -> List[int]:
        """Drop the slot's mappings and zero its table row (I4). A block
        reaching refcount 0 returns to the free list, except a computed
        cached block, which parks on the LRU so a later prompt with its
        prefix still hits it (I5); a block with other mappers stays."""
        blocks = self.owned.pop(slot, [])
        self.read_only.pop(slot, None)
        for b in blocks:
            self.ref[b] -= 1
            if self.ref[b] < 0:
                raise RuntimeError(f"refcount underflow on block {b}")
            if self.ref[b] == 0:
                if b in self.block_key and b in self.computed:
                    self.lru[b] = None
                    self.lru.move_to_end(b)       # most recently released
                else:
                    self._unregister(b)
                    self.free.append(b)
        self.tables[slot, :] = 0
        self.version += 1
        return blocks
