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
  * modes: "pard" (one draft forward + one verify forward per step),
    "vsd" (K AR draft forwards + one verify forward: the paper's vanilla
    speculative decoding baseline) and "ar"; greedy verification makes
    them token-identical;
  * sampling: a per-request temperature (``SamplingParams``; the engine's
    ``temperature`` by default) and seed; one batch mixes greedy and
    sampled rows, and a request's sampled tokens depend only on its seed
    (or the engine seed and its request id), never on the batch;
  * tree drafting (``tree=`` a static template, ``adaptive_tree=True`` the
    default bank with per-request re-selection): the PARD draft fills a
    candidate tree and one forward verifies it, still token-identical
    (a Mamba2 or hybrid draft too; the target attention-only);
  * ``prefix_cache=True`` (paged only; attention-only models) reuses
    prompt KV across requests: full prompt blocks register under
    content keys, admission maps the longest computed block-aligned
    prefix copy-free into the new row's table (target and draft keyed
    together) and prefills only the tail; refcount-0 cached blocks are
    evicted LRU;
  * ``run(pipelined=True)`` / ``run_pipelined()`` dispatch step t + 1
    before harvesting step t, so the host's scheduling between steps
    overlaps the card's step (DESIGN.md §9); tokens equal the
    synchronous loop's.

The engine runs on the CUDA card unless ``device="cpu"`` is passed; the
params must already live on that device (``models.init_params`` or
``interop.params_from_numpy``).
"""
from __future__ import annotations

from collections import deque
from typing import Optional

from ..core.spec_decode import SpecDecoder, has_ssm
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
            raise ValueError(f"mode {self.mode!r} needs a draft model")
        for name, params in (("target", target_params), ("draft", draft_params)):
            if params is None:
                continue
            where = params["embed"]["embedding"].device
            if where.type != self.device.type:
                raise ValueError(f"{name} params are on {where}, the engine "
                                 f"runs on {self.device}")
        if config.prefix_cache and any(
                c is not None and has_ssm(c) for c in (target_cfg, draft_cfg)):
            # a hit moves the prefill cursor past the cached blocks, but
            # the recurrent state is per row and starts from zero: it
            # would never see the cached tokens
            raise ValueError(
                "prefix_cache needs attention-only target and draft models: "
                "a Mamba2 state is not cached with the KV blocks")
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
                           self.device, seed=config.seed)
        self.ctrl = (TreeController(self.bank, config.max_batch,
                                    config.tree_ewma)
                     if config.adaptive_tree and self.bank is not None
                     else None)
        self.sched = Scheduler(self.dec, self.ex, self.alloc,
                               max_batch=config.max_batch,
                               max_len=config.max_len, eos_id=config.eos_id,
                               temperature=config.temperature,
                               admit_window=config.admit_window,
                               prefill_budget=config.prefill_budget,
                               ctrl=self.ctrl,
                               tree_reselect_every=config.tree_reselect_every,
                               prefix_cache=config.prefix_cache)
        # contiguous rows are committed up front: their peak is the capacity
        self.peak_kv_bytes_in_use = 0 if self.paged else self.kv_capacity_bytes()

    def submit(self, prompt, max_new: Optional[int] = None,
               temperature: Optional[float] = None,
               tree_idx: Optional[int] = None,
               params: Optional[SamplingParams] = None) -> int:
        """Queue a request: ``submit(prompt, max_new, temperature=..,
        tree_idx=..)`` or ``submit(prompt, params=SamplingParams(max_new=..,
        temperature=.., seed=.., tree_idx=..))``; ``temperature`` overrides
        the engine default for this request (0 = greedy), ``tree_idx`` pins
        one bank template."""
        return self.sched.submit(prompt, max_new, temperature, tree_idx,
                                 params=params)

    def run(self, max_steps: int = 100000,
            pipelined: Optional[bool] = None):
        """Serve until every request completed (or ``max_steps`` steps).
        ``pipelined=False`` processes each step right after dispatching it;
        ``pipelined=True`` keeps two steps in flight, dispatching step t + 1
        (with the mutations staged from step t - 1) before harvesting step
        t. One loop serves both depths. ``None``: ``config.pipelined``."""
        if pipelined is None:
            pipelined = self.config.pipelined
        sched = self.sched
        depth = 2 if pipelined else 1
        inflight = deque()
        sched._harvest_done_t = None       # no inter-run wall time
        while sched.has_work() or inflight:
            dispatched = False
            if sched.has_work() and sched.stats["steps"] < max_steps:
                admitted = sched.admit()
                if sched.queue and not admitted and not inflight \
                        and not sched.has_live():
                    # every block is free, nothing in flight can free more,
                    # and still nothing in the window fits
                    req = sched.queue[0]
                    raise RuntimeError(
                        f"request {req.rid} (prompt={len(req.prompt)}, "
                        f"max_new={req.max_new}) needs more KV blocks than "
                        f"the pool holds; raise kv_num_blocks or max_len")
                self.ex.sync_tables(self.alloc)
                self.peak_kv_bytes_in_use = max(self.peak_kv_bytes_in_use,
                                                self.kv_bytes_in_use())
                if sched.has_live():
                    inflight.append(sched.dispatch())
                    dispatched = True
            if inflight and (len(inflight) >= depth or not dispatched):
                sched.process(inflight.popleft())
            if not dispatched and not inflight:
                break                  # step budget spent, fully drained
        return sched.completions

    def run_pipelined(self, max_steps: int = 100000):
        """``run`` with two steps in flight."""
        return self.run(max_steps, pipelined=True)

    def mean_accepted(self) -> float:
        return self.sched.mean_accepted()

    def prefix_hit_rate(self) -> float:
        return self.sched.prefix_hit_rate()

    def latency_summary(self):
        return self.sched.latency_summary()

    def kv_capacity_bytes(self) -> int:
        """Device bytes of the KV pools (target + draft)."""
        return self.ex.kv_capacity

    def kv_bytes_in_use(self) -> int:
        """KV bytes of the blocks live requests hold, a block shared by
        prefix-cache hits counted once (contiguous: all)."""
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
