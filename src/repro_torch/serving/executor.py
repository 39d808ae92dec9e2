"""Device-side half of the serving stack (port of
``repro.serving.executor``).

The ``Executor`` owns what lives on the device: the KV caches (paged pools
or contiguous rows), the one ``DecodeState`` and the step functions built
by ``SpecDecoder`` with chunked prefill, so every step advances decoding
rows AND consumes prompt chunks for prefilling rows in the same two
forwards. Admission writes the prompt into ``gen``, arms the prefill
cursor (past a prefix-cache hit), sets the row's temperature and threefry
key and zeroes the slot's Mamba2 states; ``sync_tables`` pushes the
allocator's host block tables when they change. Each step has a
greedy-only variant, chosen on the host when no occupied row samples:
greedy batches run the same launches as before sampling was ported.

Stepping is split into ``dispatch`` and ``harvest`` (DESIGN.md §9), so the
engine can run a two-deep pipeline. ``dispatch`` applies the scheduler's
staged mutations on the device ahead of the step (retirement, the
per-slot commit-limit freeze, template re-selection), computes the live
mask, runs the step eagerly on the one compute stream, and snapshots the
step's outputs (``a``, ``rank``, ``live``, ``n``, ``gen``) into one device
buffer before anything later can write the state in place: the next
admission writes ``n`` and ``gen`` of its slot, and in PyTorch a handle
would otherwise alias them. On the card the snapshot goes to a pinned
host buffer by a non-blocking copy with an event; ``harvest`` waits for
that event only, never for the device. Every host-to-device copy
(block tables, an admitted row's prompt and key, the staged mutations)
also goes through pinned staging buffers with ``non_blocking=True``, so
nothing between two steps waits for the step in flight. One stream keeps
the order that makes this safe: a released block is reused only by a
later step, a block marked computed is read only by a later step. On the
CPU the same calls copy plainly and the step runs to its end inside
``dispatch``.

Copy-on-write's device half is ``copy_block``: one block of every
attention leaf of both pools, scales included.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..core import acceptance, prng
from ..core.spec_decode import DecodeState, SpecDecoder
from ..kernels.decode_attention import as_bytes
from ..models import init_caches
from ..models.config import SSM, ModelConfig, scan_plan
from . import kv_pool

# "no staged commit limit": n never reaches it, so the freeze
# ``done |= n >= limits`` leaves such rows alone
NO_LIMIT = np.int64(np.iinfo(np.int32).max)


def zero_ssm_rows(cfg: ModelConfig, caches, slot: int) -> None:
    """Reset batch row ``slot`` of every Mamba2 conv and SSM state to the
    init state (zeros), in place. Chunked prefill reuses slots, so a
    recycled slot's recurrent state must be cleared before its first chunk;
    attention KV needs nothing (validity is ``position < kv_len``)."""
    plan = scan_plan(cfg)
    for spec, entry in zip(plan.prefix, caches["prefix"]):
        if spec.mixer == SSM:
            for leaf in entry.values():
                leaf[slot].zero_()
    for spec, entry in zip(plan.period, caches["scan"]):
        if spec.mixer == SSM:
            for leaf in entry.values():            # [R, B, ...]
                leaf[:, slot].zero_()


def copy_block_leaves(caches, src: int, dst: int) -> None:
    """Copy pool block ``src`` onto ``dst`` in every attention leaf of
    ``caches`` (``k``, ``v`` and, on 8-bit pools, ``k_scale`` /
    ``v_scale``), as bytes; Mamba2 states are per row and untouched."""
    for lead, entries in ((0, caches["prefix"]), (1, caches["scan"])):
        for entry in entries:
            for name, leaf in entry.items():
                if name in kv_pool.KV_LEAVES:
                    b = as_bytes(leaf)
                    b.select(lead, dst).copy_(b.select(lead, src))


class HostStaging:
    """Pinned host buffers for the copies between host and card, so that
    neither direction makes the host wait for the stream.

    ``upload`` fills a pinned buffer and copies it to the device with
    ``non_blocking=True``; the buffer is handed out again only once the
    event recorded after that copy has completed (a small ring per shape,
    grown when every buffer is still owned by a queued copy).
    ``download`` starts a non-blocking device-to-host copy into a pinned
    buffer and records an event; the buffer returns to the pool through
    ``give_back`` once the host has read it."""

    def __init__(self):
        self._rings = {}
        self._free = {}

    def upload(self, dst: torch.Tensor, src: np.ndarray) -> None:
        src = np.ascontiguousarray(src)
        key = (src.shape, src.dtype.str)
        ring = self._rings.setdefault(key, [])
        for buf, event in ring:
            if event.query():
                break
        else:
            buf = torch.from_numpy(src).pin_memory()
            event = torch.cuda.Event()
            ring.append((buf, event))
        buf.numpy()[...] = src
        dst.copy_(buf, non_blocking=True)
        event.record()

    def download(self, src: torch.Tensor):
        key = (tuple(src.shape), src.dtype)
        pool = self._free.setdefault(key, [])
        buf = pool.pop() if pool else torch.empty(
            src.shape, dtype=src.dtype, pin_memory=True)
        buf.copy_(src, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return buf, event

    def give_back(self, buf: torch.Tensor) -> None:
        self._free[(tuple(buf.shape), buf.dtype)].append(buf)


@dataclasses.dataclass
class StepResult:
    """Host copy of one step's outputs. ``a`` is None for mode="ar",
    ``rank`` [B, D] (accepted sibling rank per depth, -1 where rejected)
    only for tree steps; ``live`` marks the rows the step committed tokens
    for; ``n`` / ``gen`` are the committed counts and tokens after it."""
    a: Optional[np.ndarray]
    rank: Optional[np.ndarray]
    live: np.ndarray
    n: np.ndarray
    gen: np.ndarray


@dataclasses.dataclass
class StepHandle:
    """One dispatched step. ``tree_sel`` is the host copy of the per-slot
    templates the step ran with; ``rids`` (stamped by the scheduler) the
    request id per slot at dispatch (-1: empty). On the card the outputs
    are in flight to ``buf`` until ``event`` completes; on the CPU
    ``result`` is filled at dispatch."""
    n_draft: int
    tree_sel: Optional[np.ndarray] = None
    rids: Optional[np.ndarray] = None
    t_dispatch: float = 0.0
    result: Optional[StepResult] = None
    buf: Optional[torch.Tensor] = None
    event: Any = None
    parts: Tuple[Tuple[str, tuple], ...] = ()


class Executor:
    """Owns the DecodeState + KV caches and runs the step functions."""

    def __init__(self, dec: SpecDecoder, target_cfg: ModelConfig,
                 draft_cfg: Optional[ModelConfig], mode: str, max_batch: int,
                 max_len: int, paged: bool, kv_block_size: int,
                 num_blocks: Optional[int], kv_dtype: str,
                 device: torch.device, seed: int = 0):
        self.dec = dec
        self.cfgs = [c for c in (target_cfg, draft_cfg) if c is not None]
        self.mode = mode
        self.max_batch = max_batch
        self.max_len = max_len
        self.kv_dtype = kv_dtype
        self.device = device
        self._steps = {}
        self._tables_version = -1
        # draft forwards per step: one PARD window (flat or tree), K for
        # VSD, none for AR
        self._n_draft = 0 if mode == "ar" else (dec.k if mode == "vsd" else 1)
        # request keys derive from this one (on the host: two words)
        self._rng_base = prng.key(seed)
        self._staging = HostStaging() if device.type == "cuda" else None

        # caches in the kv_dtype by name: int8 / fp8 add their scale leaves
        cfgs = self.cfgs
        if paged:
            caches = [kv_pool.init_paged_caches(c, max_batch, num_blocks,
                                                kv_block_size, kv_dtype, device)
                      for c in cfgs]
            self.kv_per_block = sum(kv_pool.kv_bytes_per_block(c, num_blocks)
                                    for c in caches)
        else:
            caches = [init_caches(c, max_batch, max_len, kv_dtype, device)
                      for c in cfgs]
            self.kv_per_block = 0
        self.kv_capacity = sum(kv_pool.kv_capacity_bytes(c) for c in caches)
        self.kv_scale_bytes = sum(kv_pool.kv_scale_bytes(c) for c in caches)

        def zeros(*shape, dt=torch.int64):
            return torch.zeros(shape, dtype=dt, device=device)

        self.state = DecodeState(
            gen=zeros(max_batch, max_len),
            n=zeros(max_batch) + 2,                  # dummy-safe empty rows
            m=zeros(max_batch) + 1,
            done=torch.ones(max_batch, dtype=torch.bool, device=device),
            tcache=caches[0], dcache=caches[1] if len(caches) > 1 else None,
            tables=(zeros(max_batch, kv_pool.blocks_for(max_len, kv_block_size),
                          dt=torch.int32) if paged else None),
            temp=zeros(max_batch, dt=torch.float32),
            rngs=acceptance.make_row_keys(seed, np.arange(max_batch), device),
            tree_idx=zeros(max_batch) if dec.tree is not None else None,
            pf_pos=zeros(max_batch), pf_len=zeros(max_batch))
        if dec.tree is not None:
            # the bank's device tables are built here, not in a dispatch
            dec._bank_tensors(self.state.gen.device)

    def _upload(self, dst: torch.Tensor, src: np.ndarray) -> None:
        """``dst.copy_(src)``: through pinned staging on the card, a plain
        copy on the CPU."""
        if self._staging is None:
            dst.copy_(torch.from_numpy(np.ascontiguousarray(src)))
        else:
            self._staging.upload(dst, src)

    def sync_tables(self, alloc: Optional[kv_pool.BlockAllocator]) -> None:
        """Push the host block tables to the device when stale (before any
        forward that reads them, kv_pool I4). No-op without an allocator
        (contiguous layout)."""
        if alloc is not None and self._tables_version != alloc.version:
            self._upload(self.state.tables, alloc.tables)
            self._tables_version = alloc.version

    def admit_row(self, slot: int, prompt: np.ndarray, tree_idx: int = 0,
                  temperature: float = 0.0, rid: int = 0,
                  seed: Optional[int] = None, pf_start: int = 0) -> None:
        """Arm ``slot`` for a new request: prompt into ``gen``, counters to
        the committed state, prefill cursor at ``pf_start`` (past the
        blocks a prefix-cache hit maps), Mamba2 states zeroed, template
        ``tree_idx`` (tree drafting), the temperature, and the row's key:
        ``key(seed)`` for a request with its own seed, else the engine key
        folded with the request id ``rid``. No forward runs here: the
        steps prefill chunk by chunk. Scalars are written by fills and the
        two arrays through ``_upload``, so nothing waits for the step in
        flight."""
        p = len(prompt)
        row = np.zeros((self.max_len,), np.int64)
        row[:p] = prompt
        st = self.state
        self._upload(st.gen[slot], row)
        st.n[slot].fill_(p)
        st.m[slot].fill_(p - 1)
        st.done[slot].fill_(False)
        st.pf_pos[slot].fill_(int(pf_start))
        st.pf_len[slot].fill_(p - 1)
        st.temp[slot].fill_(float(temperature))
        row_key = (prng.fold_in(self._rng_base, rid) if seed is None
                   else prng.key(seed))
        self._upload(st.rngs[slot], row_key.numpy())
        for cfg, caches in zip(self.cfgs, (st.tcache, st.dcache)):
            zero_ssm_rows(cfg, caches, slot)
        if st.tree_idx is not None:
            st.tree_idx[slot].fill_(int(tree_idx))

    def copy_block(self, src: int, dst: int) -> None:
        """Device half of ``BlockAllocator.copy_on_write``: copy block
        ``src`` onto ``dst`` in the target and draft pools (they share
        block indices)."""
        for caches in (self.state.tcache, self.state.dcache):
            if caches is not None:
                copy_block_leaves(caches, src, dst)

    def _step_fn(self, variant: str, greedy_only: bool):
        key = (variant, greedy_only)
        if key not in self._steps:
            if self.mode == "ar":
                # the 1-wide decode window, and the prefill_chunk-wide mixed
                # window for ticks where some row still prefills
                self._steps[key] = self.dec._build_ar_step(
                    chunked=variant == "mixed", greedy_only=greedy_only)
            elif self.dec.tree is not None:
                self._steps[key] = self.dec._build_tree_step(
                    chunked=True, greedy_only=greedy_only)
            else:
                self._steps[key] = self.dec._build_spec_step(
                    self.mode, chunked=True, greedy_only=greedy_only)
        return self._steps[key]

    def dispatch(self, retire: Optional[np.ndarray] = None,
                 tree_sel: Optional[np.ndarray] = None,
                 limits: Optional[np.ndarray] = None,
                 any_prefilling: bool = True,
                 any_sampled: bool = True) -> StepHandle:
        """Run one step and return its handle without waiting for it.

        ``retire`` [B] bool, ``limits`` [B] int (``NO_LIMIT`` for empty
        slots) and ``tree_sel`` [B] int are the scheduler's staged
        mutations (None: none), applied on the device ahead of the step:
        ``done |= retire | (n >= limits)``, ``temp = 0`` on retired rows,
        ``tree_idx = tree_sel``. ``live = ~(done | pf_pos < pf_len)`` is
        computed on the state after them. ``any_prefilling`` (host
        knowledge) selects the AR window width; ``any_sampled=False`` (no
        occupied row has temperature > 0) the greedy-only step. Greedy rows
        never read their keys and a sampled row's key is fresh at
        admission, so switching variants between steps keeps every row's
        tokens."""
        t0 = time.perf_counter()
        variant = "mixed" if (any_prefilling and self.mode == "ar") \
            else "decode"
        step = self._step_fn(variant, greedy_only=not any_sampled)
        b = self.max_batch
        ctl = np.zeros((3, b), np.int64)
        ctl[1] = NO_LIMIT
        for i, arr in ((0, retire), (1, limits), (2, tree_sel)):
            if arr is not None:
                ctl[i] = np.asarray(arr, np.int64)
        ctl_d = torch.empty((3, b), dtype=torch.int64, device=self.device)
        self._upload(ctl_d, ctl)
        st = self.state
        retired = ctl_d[0] != 0
        done = st.done | retired | (st.n >= ctl_d[1])
        tree_idx = st.tree_idx
        if tree_sel is not None and tree_idx is not None:
            tree_idx = ctl_d[2]
        st = dataclasses.replace(
            st, done=done, tree_idx=tree_idx,
            temp=st.temp.masked_fill(retired, 0.0))
        live = ~(st.done | (st.pf_pos < st.pf_len))
        a = rank = None
        if self.mode == "ar":
            self.state = step(st)
        elif self.dec.tree is not None:
            self.state, a, rank = step(st)
        else:
            self.state, a = step(st)
        outs = [("live", live), ("n", self.state.n), ("gen", self.state.gen),
                ("a", a), ("rank", rank)]
        outs = [(name, t) for name, t in outs if t is not None]
        handle = StepHandle(n_draft=self._n_draft,
                            tree_sel=(None if tree_sel is None
                                      else np.asarray(tree_sel)),
                            t_dispatch=t0,
                            parts=tuple((name, tuple(t.shape))
                                        for name, t in outs))
        # one snapshot of the outputs, taken before anything later writes
        # the state in place
        snap = torch.cat([t.reshape(-1).long() for _, t in outs])
        if self._staging is None:
            handle.result = self._unpack(handle, snap.numpy())
        else:
            handle.buf, handle.event = self._staging.download(snap)
        return handle

    @staticmethod
    def _unpack(handle: StepHandle, flat: np.ndarray) -> StepResult:
        got, i = {}, 0
        for name, shape in handle.parts:
            n = int(np.prod(shape))
            got[name] = flat[i:i + n].reshape(shape).copy()
            i += n
        got["live"] = got["live"].astype(bool)
        return StepResult(a=got.get("a"), rank=got.get("rank"),
                          live=got["live"], n=got["n"], gen=got["gen"])

    def harvest(self, handle: StepHandle) -> StepResult:
        """Host copy of a step's outputs. On the card this waits for that
        step's own copy event (not for the device or later steps)."""
        if handle.result is None:
            handle.event.synchronize()
            handle.result = self._unpack(handle, handle.buf.numpy())
            self._staging.give_back(handle.buf)
            handle.buf = handle.event = None
        return handle.result
