"""Batched serving engine (port of ``repro.serving.engine``): the facade
over the scheduler (host) and the executor (device).

  * prefill is a step workload: admission claims a slot and KV blocks and
    writes the prompt into the generation buffer; each step then advances
    decoding rows and consumes a prompt chunk for every prefilling row in
    the same forwards (chunked prefill);
  * KV lives in a block-paged pool with per-slot block tables
    (``kv_layout="paged"``) or in full-length rows per slot
    (``"contiguous"``);
  * one step advances all active slots; finished slots free at once and
    new requests admit on the next tick (continuous batching);
  * modes: "pard" (one draft forward + one verify forward per step) and
    "ar" (the baseline); greedy verification makes them token-identical;
  * tree drafting (``tree=`` a static template, ``adaptive_tree=True`` the
    default bank with per-request re-selection): the PARD draft fills a
    candidate tree and one forward verifies it, still token-identical.

The engine runs on the CUDA card unless ``device="cpu"`` is passed; the
params must already live on that device (``models.init_params`` or
``interop.params_from_numpy``).
"""
from __future__ import annotations

from typing import Optional

from ..core.spec_decode import SpecDecoder
from ..device import resolve_device
from ..models.config import ModelConfig
from . import kv_pool
from .config import EngineConfig, SamplingParams
from .executor import Executor
from .scheduler import Completion, Scheduler, TreeController  # noqa: F401


class Engine:
    """``Engine(target_params, target_cfg, draft_params, draft_cfg,
    config=EngineConfig(...), device=None)``."""

    def __init__(self, target_params, target_cfg: ModelConfig,
                 draft_params=None, draft_cfg: Optional[ModelConfig] = None,
                 *, config: Optional[EngineConfig] = None, device=None):
        self.config = config = config or EngineConfig()
        self.device = resolve_device(device)
        self.mode = config.mode
        if self.mode == "ar":
            # the AR baseline never reads draft caches
            draft_params = draft_cfg = None
        elif draft_params is None:
            raise ValueError("mode 'pard' needs a draft model")
        for name, params in (("target", target_params), ("draft", draft_params)):
            if params is None:
                continue
            where = params["embed"]["embedding"].device
            if where.type != self.device.type:
                raise ValueError(f"{name} params are on {where}, the engine "
                                 f"runs on {self.device}")
        self.paged = config.paged
        self.dec = SpecDecoder(
            target_params, target_cfg, draft_params, draft_cfg,
            k=config.k if self.mode != "ar" else 1,
            kv_block_size=config.kv_block_size if self.paged else 0,
            prefill_chunk=config.prefill_chunk,
            tree=config.tree if self.mode == "pard" else None)
        self.k = self.dec.k            # a tree bank overrides k (its depth)
        self.bank = self.dec.tree      # TemplateBank, or None: no tree
        nb = None
        self.alloc = None
        if self.paged:
            nb = config.kv_num_blocks or kv_pool.default_num_blocks(
                config.max_batch, config.max_len, config.kv_block_size)
            self.alloc = kv_pool.BlockAllocator(
                nb, config.kv_block_size, config.max_batch, config.max_len)
        self.ex = Executor(self.dec, target_cfg, draft_cfg, self.mode,
                           config.max_batch, config.max_len, self.paged,
                           config.kv_block_size, nb, config.kv_dtype,
                           self.device)
        self.ctrl = (TreeController(self.bank, config.max_batch,
                                    config.tree_ewma)
                     if config.adaptive_tree and self.bank is not None
                     else None)
        self.sched = Scheduler(self.dec, self.ex, self.alloc,
                               max_batch=config.max_batch,
                               max_len=config.max_len, eos_id=config.eos_id,
                               admit_window=config.admit_window,
                               prefill_budget=config.prefill_budget,
                               ctrl=self.ctrl,
                               tree_reselect_every=config.tree_reselect_every)
        # contiguous rows are committed up front: their peak is the capacity
        self.peak_kv_bytes_in_use = 0 if self.paged else self.kv_capacity_bytes()

    def submit(self, prompt, max_new: Optional[int] = None,
               params: Optional[SamplingParams] = None) -> int:
        """Queue a request: ``submit(prompt, max_new)`` or
        ``submit(prompt, params=SamplingParams(max_new=..))``."""
        return self.sched.submit(prompt, max_new, params=params)

    def run(self, max_steps: int = 100000):
        """Serve until every request completed (or ``max_steps`` steps)."""
        sched = self.sched
        while sched.has_work() and sched.stats["steps"] < max_steps:
            admitted = sched.admit()
            if sched.queue and not admitted and not sched.has_live():
                # every block is free and still nothing fits the head
                req = sched.queue[0]
                raise RuntimeError(
                    f"request {req.rid} (prompt={len(req.prompt)}, "
                    f"max_new={req.max_new}) needs more KV blocks than the "
                    f"pool holds; raise kv_num_blocks or max_len")
            self.ex.sync_tables(self.alloc)
            self.peak_kv_bytes_in_use = max(self.peak_kv_bytes_in_use,
                                            self.kv_bytes_in_use())
            sched.step()
        return sched.completions

    def mean_accepted(self) -> float:
        return self.sched.mean_accepted()

    def latency_summary(self):
        return self.sched.latency_summary()

    def kv_capacity_bytes(self) -> int:
        """Device bytes of the KV pools (target + draft)."""
        return self.ex.kv_capacity

    def kv_bytes_in_use(self) -> int:
        """KV bytes of the blocks live requests hold (contiguous: all)."""
        if not self.paged:
            return self.kv_capacity_bytes()
        return self.alloc.blocks_in_use * self.ex.kv_per_block

    @property
    def stats(self):
        return self.sched.stats

    @property
    def completions(self):
        return self.sched.completions

    @property
    def queue(self):
        return self.sched.queue
