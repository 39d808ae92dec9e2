"""Device-side half of the serving stack (port of
``repro.serving.executor``).

The ``Executor`` owns what lives on the device: the KV caches (paged pools
or contiguous rows), the one ``DecodeState`` and the step functions built
by ``SpecDecoder`` with chunked prefill, so every step advances decoding
rows AND consumes prompt chunks for prefilling rows in the same two
forwards. Admission writes the prompt into ``gen``, arms the prefill
cursor and zeroes the slot's Mamba2 states; retirement freezes the row;
``sync_tables`` pushes the allocator's host block tables when they
change; the scheduler's template
re-selections (tree drafting) are applied to ``tree_idx`` at the next
dispatch, before the step.

``dispatch`` runs one step eagerly on the current stream and returns a
handle of device tensors; ``harvest`` copies them to the host, which waits
for the step. CUDA graphs and the overlapped (pipelined) loop come with
later work.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.spec_decode import DecodeState, SpecDecoder
from ..models import init_caches
from ..models.config import SSM, ModelConfig, scan_plan
from . import kv_pool


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


@dataclasses.dataclass
class StepHandle:
    """One dispatched step's outputs, still on the device. ``a`` is None
    for mode="ar", ``rank`` [B, D] only for tree steps; ``live`` marks the
    rows the step committed tokens for; ``tree_sel`` is the host copy of
    the per-slot templates the step ran with."""
    a: Optional[torch.Tensor]
    rank: Optional[torch.Tensor]
    live: torch.Tensor
    n: torch.Tensor
    gen: torch.Tensor
    n_draft: int
    tree_sel: Optional[np.ndarray] = None


@dataclasses.dataclass
class StepResult:
    """Host copy of a ``StepHandle``."""
    a: Optional[np.ndarray]
    rank: Optional[np.ndarray]
    live: np.ndarray
    n: np.ndarray
    gen: np.ndarray


class Executor:
    """Owns the DecodeState + KV caches and runs the step functions."""

    def __init__(self, dec: SpecDecoder, target_cfg: ModelConfig,
                 draft_cfg: Optional[ModelConfig], mode: str, max_batch: int,
                 max_len: int, paged: bool, kv_block_size: int,
                 num_blocks: Optional[int], kv_dtype: str,
                 device: torch.device):
        self.dec = dec
        self.cfgs = [c for c in (target_cfg, draft_cfg) if c is not None]
        self.mode = mode
        self.max_len = max_len
        self.device = device
        self._steps = {}
        self._tables_version = -1
        # draft forwards per step: one PARD window (flat or tree), none for AR
        self._n_draft = 0 if mode == "ar" else 1

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
            tree_idx=zeros(max_batch) if dec.tree is not None else None,
            pf_pos=zeros(max_batch), pf_len=zeros(max_batch))

    def sync_tables(self, alloc: Optional[kv_pool.BlockAllocator]) -> None:
        """Push the host block tables to the device when stale (before any
        forward that reads them, kv_pool I4). No-op without an allocator
        (contiguous layout)."""
        if alloc is not None and self._tables_version != alloc.version:
            self.state.tables.copy_(torch.from_numpy(alloc.tables))
            self._tables_version = alloc.version

    def admit_row(self, slot: int, prompt: np.ndarray, tree_idx: int = 0) -> None:
        """Arm ``slot`` for a new request: prompt into ``gen``, counters to
        the committed state, prefill cursor at 0, Mamba2 states zeroed,
        template ``tree_idx`` (tree drafting). No forward runs here: the
        steps prefill chunk by chunk."""
        p = len(prompt)
        row = np.zeros((self.max_len,), np.int64)
        row[:p] = prompt
        st = self.state
        st.gen[slot] = torch.from_numpy(row).to(self.device)
        st.n[slot] = p
        st.m[slot] = p - 1
        st.done[slot] = False
        st.pf_pos[slot] = 0
        st.pf_len[slot] = p - 1
        for cfg, caches in zip(self.cfgs, (st.tcache, st.dcache)):
            zero_ssm_rows(cfg, caches, slot)
        if st.tree_idx is not None:
            self.set_tree_idx(slot, tree_idx)

    def retire_row(self, slot: int) -> None:
        self.state.done[slot] = True

    def set_tree_idx(self, slot: int, tree_idx: int) -> None:
        """Pin ``slot`` to bank template ``tree_idx`` (tree drafting)."""
        self.state.tree_idx[slot] = int(tree_idx)

    def _step_fn(self, variant: str):
        if variant not in self._steps:
            if self.mode == "ar":
                # the 1-wide decode window, and the prefill_chunk-wide mixed
                # window for ticks where some row still prefills
                self._steps[variant] = self.dec._build_ar_step(
                    chunked=variant == "mixed")
            elif self.dec.tree is not None:
                self._steps[variant] = self.dec._build_tree_step(
                    chunked=True, greedy_only=True)
            else:
                self._steps[variant] = self.dec._build_spec_step(
                    "pard", chunked=True, greedy_only=True)
        return self._steps[variant]

    def dispatch(self, any_prefilling: bool = True,
                 tree_sel: Optional[np.ndarray] = None) -> StepHandle:
        """Run one step. ``any_prefilling`` (host knowledge) selects the AR
        window width; ``tree_sel`` [B] (tree drafting) holds the scheduler's
        staged per-slot templates, applied to ``tree_idx`` before the step."""
        variant = "mixed" if (any_prefilling and self.mode == "ar") \
            else "decode"
        st = self.state
        if tree_sel is not None:
            st.tree_idx.copy_(torch.from_numpy(
                np.asarray(tree_sel, np.int64)))
        live = ~(st.done | (st.pf_pos < st.pf_len))
        a = rank = None
        if self.mode == "ar":
            self.state = self._step_fn(variant)(st)
        elif self.dec.tree is not None:
            self.state, a, rank = self._step_fn(variant)(st)
        else:
            self.state, a = self._step_fn(variant)(st)
        return StepHandle(a=a, rank=rank, live=live, n=self.state.n,
                          gen=self.state.gen, n_draft=self._n_draft,
                          tree_sel=(None if tree_sel is None
                                    else np.asarray(tree_sel)))

    def harvest(self, handle: StepHandle) -> StepResult:
        """Host copies of a step's outputs (waits for the step)."""
        def host(t):
            return None if t is None else t.cpu().numpy()
        return StepResult(a=host(handle.a), rank=host(handle.rank),
                          live=host(handle.live), n=host(handle.n),
                          gen=host(handle.gen))
