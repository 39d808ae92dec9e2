"""Host-side half of the serving stack (port of
``repro.serving.scheduler`` for one replica).

The ``Scheduler`` owns every decision that does not touch the device:

  * the request queue and FIFO-fair skip-ahead admission: a bounded prefix
    of the queue (``admit_window``) is scanned per free slot, so one
    pool-oversized request cannot starve smaller ones behind it, and
    nothing beyond the window may overtake it;
  * chunked-prefill budgeting: at most ``prefill_budget // chunk_width``
    rows prefill at once (None = no limit);
  * block allocation and release through ``kv_pool.BlockAllocator``
    (paged layout; contiguous rows are committed up front);
  * tree drafting: each request's template (pinned by
    ``SamplingParams.tree_idx``, or picked by the adaptive
    ``TreeController`` at admission and re-picked between windows), with
    per-template window slack;
  * sampling: each request's temperature (None = the engine default) and
    seed go to the executor at admission, and each step tells it whether
    any occupied slot samples (else it runs the greedy-only step);
  * prefix-cache admission (paged, ``prefix_cache=True``): the longest
    computed block-aligned prefix of the prompt is mapped copy-free from
    the allocator's content-keyed index and only the tail is prefilled
    (the prefill cursor starts past the hit; a full hit takes no prefill
    lane);
  * per-request latency accounting (queue wait, TTFT, inter-commit
    percentiles), per-step wall time and the host overhead between a
    harvest and the next dispatch.

Stepping follows the executor's dispatch/harvest split (DESIGN.md §9).
``dispatch()`` issues one step with every staged mutation (retirements
from earlier harvests, template re-selections, commit limits) and at once
advances what the dispatch alone decides: step counters, the prefill
cursor mirrors and the computed flags of prefix-cached blocks (the chunk
schedule depends only on the cursor). ``process(handle)`` harvests a step
and folds in what depends on its results: acceptance statistics and the
controller, where the slot still holds the request the step was
dispatched for; completions cut from the step's own snapshot; block
release; retirement, staged for the next dispatch. The synchronous loop
(``step``) is dispatch followed at once by process; the pipelined one
processes step t after dispatching step t + 1. Device work lives in
``serving.executor.Executor``.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np

from ..core.spec_decode import SpecDecoder, TemplateBank
from . import kv_pool
from .config import SamplingParams
from .executor import NO_LIMIT, Executor, StepHandle, StepResult


@dataclasses.dataclass
class Request:
    """One queued request."""
    rid: int
    prompt: np.ndarray          # 1-D int
    params: SamplingParams

    @property
    def max_new(self) -> int:
        return self.params.max_new

    @property
    def tree_idx(self) -> Optional[int]:
        return self.params.tree_idx

    @property
    def temperature(self) -> Optional[float]:
        return self.params.temperature    # None = the engine default

    @property
    def seed(self) -> Optional[int]:
        return self.params.seed           # None = (engine seed, rid) stream


@dataclasses.dataclass
class Completion:
    """A finished request: prompt + generated tokens and its latencies
    (seconds; ``tok_*`` are inter-commit percentiles in seconds)."""
    rid: int
    tokens: np.ndarray
    generated: int
    wall_submitted: float
    wall_done: float
    queue_wait: float = 0.0
    ttft: float = 0.0
    tok_p50: float = 0.0
    tok_p95: float = 0.0


def _weighted_percentile(samples: List, q: float) -> float:
    """Percentile over (value, weight) pairs (weights are token counts)."""
    if not samples:
        return 0.0
    vals = np.repeat([v for v, _ in samples], [c for _, c in samples])
    return float(np.percentile(vals, q))


@dataclasses.dataclass
class _Slot:
    """Host mirror of one occupied slot."""
    req: Request
    limit: int                  # prompt + max_new
    pf: int                     # prefill cursor mirror
    pf_len: int
    submit_t: float
    admit_t: float
    temperature: float = 0.0    # resolved at admission
    tree: int = 0               # bank template in use
    steps: int = 0              # live steps so far
    first_t: float = float("nan")
    last_t: float = 0.0
    last_n: int = 0
    samples: List = dataclasses.field(default_factory=list)


class TreeController:
    """Acceptance-statistics template selection.

    Keeps, per slot and per (depth d, sibling rank c), an EWMA of "depth d
    was evaluated this step and rank c's candidate was the accepted one",
    updated only at steps where rank c was offered (c < the in-use
    template's branching at d): the conditional accept probability of rank
    c. A template's score is its expected accepted length under
    independence across ranks: E(t) = sum_d prod_{d' <= d} min(1,
    sum_{c < b_d'} p[d', c]).

    Admission selects on a global EWMA that every retiring request folds
    its row into; per-slot rows are seeded from it at admission and drive
    the between-windows re-selection (``Scheduler._reshape_slots``).
    """

    def __init__(self, bank: TemplateBank, max_batch: int, ewma: float = 0.2):
        self.bank = bank
        self.ewma = ewma
        d, mb = bank.max_depth, bank.max_branching
        self.offer = np.zeros((len(bank), d), np.int32)   # [T, D] branching
        for t, tpl in enumerate(bank.templates):
            self.offer[t] = tpl.branching
        # optimistic prior: rank 0 accepts half the time, each extra rank
        # adds a little, so wide templates stay in play until data arrives
        prior = np.zeros((d, mb))
        prior[:, 0] = 0.5
        if mb > 1:
            prior[:, 1:] = 0.15
        self.global_p = prior.copy()
        self.slot_p = np.tile(prior, (max_batch, 1, 1))
        self._offer_mask = (np.arange(mb)[None, None, :]
                            < self.offer[:, :, None])           # [T, D, mb]
        self._ranks = np.arange(mb)
        self._depths = np.arange(d)

    def seed_slot(self, slot: int) -> None:
        self.slot_p[slot] = self.global_p

    def retire_slot(self, slot: int) -> None:
        """Fold a finished request's statistics into the admission prior."""
        self.global_p += 0.5 * (self.slot_p[slot] - self.global_p)

    def update(self, live: np.ndarray, tree_idx: np.ndarray, a: np.ndarray,
               rank: np.ndarray) -> None:
        """live [B] (rows decoding before the step), tree_idx [B], a [B]
        accepted depths, rank [B, D] accepted sibling rank per depth (-1
        where rejected). A cell (slot, dep, c) moves iff depth dep was
        evaluated (dep <= a) and rank c was offered."""
        idx = np.nonzero(live)[0]
        if idx.size == 0:
            return
        br = self.offer[np.asarray(tree_idx)[idx]]            # [n, D]
        evaluated = self._depths[None, :] <= np.asarray(a)[idx, None]
        offered = self._ranks[None, None, :] < br[:, :, None]  # [n, D, mb]
        upd = evaluated[:, :, None] & offered
        obs = (np.asarray(rank)[idx][:, :, None]
               == self._ranks[None, None, :]).astype(self.slot_p.dtype)
        p = self.slot_p[idx]
        self.slot_p[idx] = np.where(upd, p + self.ewma * (obs - p), p)

    def select(self, slot: Optional[int] = None, feasible=None) -> int:
        """Best-scoring template (per-slot statistics, or the global prior
        for admission) among ``feasible`` template indices (default all);
        the earliest wins ties within 1e-9."""
        p = self.global_p if slot is None else self.slot_p[slot]
        cands = range(len(self.bank)) if feasible is None else list(feasible)
        s = np.minimum(1.0, np.where(self._offer_mask, p[None], 0.0).sum(-1))
        scores = np.cumprod(s, axis=1).sum(axis=1)
        best, best_e = next(iter(cands)), -1.0
        for t in cands:
            if scores[t] > best_e + 1e-9:
                best, best_e = t, float(scores[t])
        return best


class Scheduler:
    """Queue, admission and accounting over one Executor. ``alloc`` is
    None in the contiguous layout; ``bank`` / ``ctrl`` are set for tree
    drafting (``ctrl`` only when adaptive); ``temperature`` is the engine
    default of requests that set none; ``prefix_cache`` (paged only)
    matches and registers prompt blocks at admission."""

    def __init__(self, dec: SpecDecoder, executor: Executor,
                 alloc: Optional[kv_pool.BlockAllocator], *, max_batch: int,
                 max_len: int, eos_id: Optional[int], admit_window: int,
                 temperature: float = 0.0,
                 prefill_budget: Optional[int],
                 ctrl: Optional[TreeController] = None,
                 tree_reselect_every: int = 4, prefix_cache: bool = False):
        self.dec, self.ex, self.alloc = dec, executor, alloc
        self.prefix_cache = prefix_cache and alloc is not None
        self.paged = alloc is not None
        self.bank, self.ctrl = dec.tree, ctrl
        self.tree_reselect_every = tree_reselect_every
        self.max_len = max_len
        self.temperature = temperature
        self.eos_id = eos_id
        self.admit_window = admit_window
        self.chunk = dec.chunk_width
        self.prefill_lanes = (None if prefill_budget is None
                              else max(1, prefill_budget // self.chunk))
        self.slots: List[Optional[_Slot]] = [None] * max_batch
        self.queue: deque = deque()
        self.completions: List[Completion] = []
        self.step_ms: List[float] = []
        # per-step host overhead: harvest done -> next dispatch, ms
        self.host_overhead_ms: List[float] = []
        self._harvest_done_t: Optional[float] = None
        self._last_harvest_t = 0.0
        # retirements decided at process time, applied by the next dispatch
        self.pending_retire = np.zeros(max_batch, bool)
        self._next_rid = 0
        self._submit_t: Dict[int, float] = {}
        self.stats: Dict = dict(
            steps=0, committed=0, accepted=0, live_steps=0,
            draft_forwards=0, target_forwards=0, round_hist=None,
            prefill_steps=0, prefill_chunks=0, prefill_tokens=0,
            prefix_lookup_blocks=0, prefix_hit_blocks=0)
        if self.bank is not None:
            self.stats["tree_hist"] = np.zeros(len(self.bank), np.int64)
            self.stats["tree_switches"] = 0

    # ------------------------------------------------------------- submit
    def submit(self, prompt, max_new: Optional[int] = None,
               temperature: Optional[float] = None,
               tree_idx: Optional[int] = None,
               params: Optional[SamplingParams] = None) -> int:
        if params is None:
            params = SamplingParams(max_new=max_new, temperature=temperature,
                                    tree_idx=tree_idx)
        elif temperature is not None or tree_idx is not None:
            raise ValueError("pass per-request options inside "
                             "SamplingParams, not alongside it")
        params = params.merged(max_new)
        prompt = np.asarray(prompt, np.int64)
        tree_idx = params.tree_idx
        if tree_idx is not None and (
                self.bank is None or not 0 <= tree_idx < len(self.bank)):
            raise ValueError(
                f"tree_idx={tree_idx} needs a TemplateBank with more "
                f"than {tree_idx} templates")
        if not self.paged or self.bank is None:
            # contiguous rows are written batch-wide (the widest window,
            # start-clamped writes past max_len would corrupt committed
            # KV), so the bank-wide slack holds whatever template is pinned
            slack = self.dec.window_slack
        elif tree_idx is not None:
            slack = self.dec.row_slack(tree_idx)
        else:
            slack = self.dec.min_row_slack
        need = len(prompt) + params.max_new + slack
        if len(prompt) < 2 or need > self.max_len:
            raise ValueError(
                f"request needs {need} cache positions (prompt="
                f"{len(prompt)}, max_new={params.max_new}, window slack="
                f"{slack}) but max_len={self.max_len}; "
                f"prompts also need >= 2 tokens")
        rid = self._next_rid
        self._next_rid += 1
        self.queue.append(Request(rid, prompt, params))
        self._submit_t[rid] = time.perf_counter()
        return rid

    def has_work(self) -> bool:
        return bool(self.queue) or self.has_live()

    def has_live(self) -> bool:
        return any(s is not None for s in self.slots)

    def prefilling_count(self) -> int:
        return sum(1 for s in self.slots if s is not None and s.pf < s.pf_len)

    # ---------------------------------------------------------- admission
    def _slack(self, tmpl: int) -> int:
        return self.dec.row_slack(tmpl) if self.bank is not None \
            else self.dec.window_slack

    def _feasible_templates(self, req: Request) -> List[int]:
        """Bank templates whose window slack fits ``req`` inside max_len
        (never empty: submit validated the smallest or bank-wide slack)."""
        budget = self.max_len - len(req.prompt) - req.max_new
        return [t for t in range(len(self.bank))
                if self.dec.row_slack(t) <= budget]

    def _pick_template(self, req: Request) -> int:
        if self.bank is None:
            return 0
        if req.tree_idx is not None:
            return req.tree_idx
        feasible = self._feasible_templates(req)
        if self.ctrl is None:
            return 0 if 0 in feasible else feasible[0]
        return self.ctrl.select(feasible=feasible)

    def _try_admit(self, slot: int, req: Request) -> bool:
        """Admit ``req`` into ``slot`` when its KV blocks (paged, after
        prefix matching) and a prefill lane exist right now; no side
        effects otherwise."""
        p = len(req.prompt)
        tmpl = self._pick_template(req)
        need = p + req.max_new + self._slack(tmpl)
        keys: List[bytes] = []
        hit: List[int] = []
        if self.paged:
            if self.prefix_cache:
                keys = kv_pool.prefix_block_keys(
                    req.prompt, self.alloc.block_size, self.ex.kv_dtype)
                hit = self.alloc.match_prefix(keys)
            nb = self.alloc.blocks_needed(need)
            if not self.alloc.can_allocate(nb - len(hit), hit) \
                    and self.bank is not None and req.tree_idx is None:
                # the pick outgrows the pool: serve on the narrowest
                # feasible template (reshaping may widen it later)
                tmpl = min(self._feasible_templates(req),
                           key=self.dec.row_slack)
                need = p + req.max_new + self._slack(tmpl)
                nb = self.alloc.blocks_needed(need)
            if not self.alloc.can_allocate(nb - len(hit), hit):
                return False                       # memory backpressure
        pf_start = len(hit) * self.alloc.block_size if self.paged else 0
        if pf_start < p - 1 and self.prefill_lanes is not None \
                and self.prefilling_count() >= self.prefill_lanes:
            return False                           # prefill budget exhausted
        now = time.perf_counter()
        if self.paged:
            self.alloc.allocate(slot, need, prefix=hit, keys=keys)
            self.stats["prefix_lookup_blocks"] += len(keys)
            self.stats["prefix_hit_blocks"] += len(hit)
            # defensive copy-on-write (kv_pool I2): with block-aligned
            # matching the first written position lies past the shared
            # prefix, so this maps nothing today
            first_write = min(pf_start, p - 1) // self.alloc.block_size
            for i in sorted(self.alloc.read_only.get(slot, ())):
                if i >= first_write:
                    pair = self.alloc.copy_on_write(slot, i)
                    if pair is not None:
                        self.ex.copy_block(*pair)
        temp = self.temperature if req.temperature is None \
            else req.temperature
        self.ex.admit_row(slot, req.prompt, tmpl, float(temp), req.rid,
                          req.seed, pf_start=pf_start)
        # admission re-arms the whole row, so a retirement still staged
        # for the slot's previous request must not reach the next dispatch
        self.pending_retire[slot] = False
        self.slots[slot] = _Slot(req=req, limit=p + req.max_new, pf=pf_start,
                                 pf_len=p - 1,
                                 submit_t=self._submit_t.pop(req.rid, now),
                                 admit_t=now, temperature=float(temp),
                                 tree=tmpl, last_t=now, last_n=p)
        if self.ctrl is not None:
            self.ctrl.seed_slot(slot)
        return True

    def admit(self) -> int:
        """Fill free slots from a bounded prefix of the queue: position 0
        is tried first, and a later request may overtake only when every
        earlier one in the window cannot fit now."""
        admitted = 0
        while self.queue and None in self.slots:
            slot = self.slots.index(None)
            window = min(len(self.queue), self.admit_window)
            qi = next((i for i in range(window)
                       if self._try_admit(slot, self.queue[i])), None)
            if qi is None:
                break
            del self.queue[qi]
            admitted += 1
        return admitted

    # ----------------------------------------------------------- stepping
    def dispatch(self) -> StepHandle:
        """Issue one step with the staged mutations (retirements, the
        slots' templates, commit limits: a row that filled its budget in a
        step not yet harvested freezes itself) and advance what the
        dispatch alone decides: step counters, prefill cursor mirrors and
        computed blocks (readable by any later step, by stream order)."""
        now = time.perf_counter()
        if self._harvest_done_t is not None:
            self.host_overhead_ms.append((now - self._harvest_done_t) * 1e3)
            self._harvest_done_t = None
        tree_sel = None
        if self.bank is not None:
            tree_sel = np.asarray([0 if s is None else s.tree
                                   for s in self.slots], np.int64)
        limits = np.asarray([NO_LIMIT if s is None else s.limit
                             for s in self.slots], np.int64)
        any_prefilling = self.prefilling_count() > 0
        # retired rows' temperatures are zeroed by this dispatch before the
        # step, so the occupied slots are exactly the rows that may sample
        any_sampled = any(s is not None and s.temperature > 0
                          for s in self.slots)
        handle = self.ex.dispatch(retire=self.pending_retire,
                                  tree_sel=tree_sel, limits=limits,
                                  any_prefilling=any_prefilling,
                                  any_sampled=any_sampled)
        handle.rids = np.asarray([-1 if s is None else s.req.rid
                                  for s in self.slots], np.int64)
        self.pending_retire = np.zeros(len(self.slots), bool)
        self.stats["steps"] += 1
        self.stats["prefill_steps"] += any_prefilling
        self.stats["target_forwards"] += 1
        self.stats["draft_forwards"] += handle.n_draft
        for slot, s in enumerate(self.slots):
            if s is not None and s.pf < s.pf_len:
                cl = min(self.chunk, s.pf_len - s.pf)
                s.pf += cl
                self.stats["prefill_chunks"] += 1
                self.stats["prefill_tokens"] += cl
                if self.prefix_cache:
                    self.alloc.mark_computed(slot, s.pf)
        return handle

    def process(self, handle: StepHandle) -> None:
        """Harvest one step and fold its results in."""
        res = self.ex.harvest(handle)
        now = time.perf_counter()
        self._harvest_done_t = now
        # the wall time the step held the loop: from the later of its
        # dispatch and the previous harvest (pipelined: harvest to harvest)
        start = max(handle.t_dispatch, self._last_harvest_t)
        self.step_ms.append((now - start) * 1e3)
        self._last_harvest_t = now
        self._note_results(handle, res)
        self._harvest_completions(handle, res, now)

    def step(self) -> None:
        """One synchronous step: dispatch, then process at once."""
        self.process(self.dispatch())

    def _note_results(self, handle: StepHandle, res: StepResult) -> None:
        """Acceptance statistics from the device's live mask (rows the step
        committed for); per-slot accounting and the controller only where
        the slot still holds the request the step was dispatched for."""
        n_live = int(res.live.sum())
        if res.a is not None:
            self.stats["accepted"] += int(res.a.sum())
            self.stats["live_steps"] += n_live
            self.stats["committed"] += int(res.a.sum()) + n_live
            # accepts per sibling rank: a chain accepts at rank 0 only
            rhist = (np.asarray([res.a.sum()], np.int64) if res.rank is None
                     else np.bincount(res.rank[res.rank >= 0],
                                      minlength=self.bank.max_branching))
            old = self.stats["round_hist"]
            self.stats["round_hist"] = rhist if old is None else old + rhist
        else:
            self.stats["committed"] += n_live
        if self.bank is None:
            return
        # attribute to the templates the step was dispatched with
        np.add.at(self.stats["tree_hist"], handle.tree_sel[res.live], 1)
        cur = np.asarray([-1 if s is None else s.req.rid
                          for s in self.slots], np.int64)
        acct = res.live & (handle.rids == cur)
        for slot in np.nonzero(acct)[0]:
            self.slots[slot].steps += 1
        if self.ctrl is not None and acct.any():
            self.ctrl.update(acct, handle.tree_sel, res.a, res.rank)
            self._reshape_slots(acct)

    def _harvest_completions(self, handle: StepHandle, res: StepResult,
                             now: float) -> None:
        """Completions (EOS or max_new) from the step's own snapshot, so
        what a later step in flight speculates for the slot never reaches
        the output. The slot frees at once: its blocks return to the
        allocator (a step in flight writes a released row only past its
        prompt, and a later step that reuses the blocks runs after it) and
        its retirement is staged for the next dispatch."""
        for slot, s in enumerate(self.slots):
            if s is None or int(handle.rids[slot]) != s.req.rid:
                # empty, or re-admitted while the step was in flight: the
                # snapshot belongs to the slot's previous request
                continue
            n = int(res.n[slot])
            c = n - s.last_n
            if c > 0:
                if np.isnan(s.first_t):
                    s.first_t = now
                s.samples.append(((now - s.last_t) / c, c))
                s.last_t, s.last_n = now, n
            p = len(s.req.prompt)
            end = None
            if self.eos_id is not None and n > p:
                row = res.gen[slot, p:n].tolist()
                if self.eos_id in row:
                    # truncate at the EOS: tokens committed after it in the
                    # same window are dropped
                    end = min(p + row.index(self.eos_id) + 1, s.limit)
            if n >= s.limit or end is not None:
                end = min(n, s.limit) if end is None else end
                self.completions.append(Completion(
                    rid=s.req.rid, tokens=res.gen[slot, :end].copy(),
                    generated=end - p, wall_submitted=s.submit_t,
                    wall_done=now, queue_wait=s.admit_t - s.submit_t,
                    ttft=(0.0 if np.isnan(s.first_t)
                          else s.first_t - s.submit_t),
                    tok_p50=_weighted_percentile(s.samples, 50),
                    tok_p95=_weighted_percentile(s.samples, 95)))
                self.slots[slot] = None
                self.pending_retire[slot] = True
                if self.ctrl is not None:
                    self.ctrl.retire_slot(slot)
                if self.paged:
                    self.alloc.release(slot)

    def _reshape_slots(self, live) -> None:
        """Between-windows template re-selection (adaptive trees): every
        ``tree_reselect_every`` live steps a slot re-scores the bank under
        its own statistics and switches when another template wins and the
        slot can hold it (within max_len; paged: growable in place, else it
        keeps its shape). The switch is staged: the next dispatch applies
        it. Greedy output does not depend on the shape."""
        for slot in np.nonzero(live)[0]:
            s = self.slots[slot]
            if s.req.tree_idx is not None:
                continue                # pinned requests keep their shape
            if s.steps % self.tree_reselect_every:
                continue
            best = self.ctrl.select(slot=int(slot),
                                    feasible=self._feasible_templates(s.req))
            if best == s.tree:
                continue
            need = len(s.req.prompt) + s.req.max_new + self.dec.row_slack(best)
            if self.paged and not self.alloc.grow(int(slot), need):
                continue                # pool too tight: keep the old shape
            s.tree = best
            self.stats["tree_switches"] += 1

    # ------------------------------------------------------------ summary
    def mean_accepted(self) -> float:
        """Mean committed tokens per live row per verify step (a + 1)."""
        if not self.stats["live_steps"]:
            return 0.0
        return 1.0 + self.stats["accepted"] / self.stats["live_steps"]

    def prefix_hit_rate(self) -> float:
        """Share of looked-up prompt blocks served from the prefix cache
        (0.0 when caching is off or nothing was looked up)."""
        lookups = self.stats["prefix_lookup_blocks"]
        return self.stats["prefix_hit_blocks"] / lookups if lookups else 0.0

    def latency_summary(self) -> Dict[str, float]:
        """Percentiles over completions and steps, in milliseconds, with
        the host overhead between a harvest and the next dispatch (the
        host time the pipelined loop hides)."""
        comps = self.completions

        def pct(vals, q):
            return float(np.percentile(vals, q)) if len(vals) else 0.0

        return dict(
            requests=len(comps),
            queue_wait_p50_ms=pct([c.queue_wait for c in comps], 50) * 1e3,
            ttft_p50_ms=pct([c.ttft for c in comps], 50) * 1e3,
            ttft_p95_ms=pct([c.ttft for c in comps], 95) * 1e3,
            tok_p50_ms=_weighted_percentile(
                [(c.tok_p50, max(1, c.generated)) for c in comps], 50) * 1e3,
            tok_p95_ms=_weighted_percentile(
                [(c.tok_p95, max(1, c.generated)) for c in comps], 95) * 1e3,
            step_p50_ms=pct(self.step_ms, 50),
            step_p95_ms=pct(self.step_ms, 95),
            host_overhead_p50_ms=pct(self.host_overhead_ms, 50),
            host_overhead_p95_ms=pct(self.host_overhead_ms, 95))
