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
  * per-request latency accounting (queue wait, TTFT, inter-commit
    percentiles) and per-step wall time.

Each step is dispatched and processed back to back (the synchronous loop).
Device work lives in ``serving.executor.Executor``.
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
from .executor import Executor, StepHandle


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
    default of requests that set none."""

    def __init__(self, dec: SpecDecoder, executor: Executor,
                 alloc: Optional[kv_pool.BlockAllocator], *, max_batch: int,
                 max_len: int, eos_id: Optional[int], admit_window: int,
                 temperature: float = 0.0,
                 prefill_budget: Optional[int],
                 ctrl: Optional[TreeController] = None,
                 tree_reselect_every: int = 4):
        self.dec, self.ex, self.alloc = dec, executor, alloc
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
        self._next_rid = 0
        self._submit_t: Dict[int, float] = {}
        self.stats: Dict = dict(
            steps=0, committed=0, accepted=0, live_steps=0,
            draft_forwards=0, target_forwards=0, round_hist=None,
            prefill_steps=0, prefill_chunks=0, prefill_tokens=0)
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
        """Admit ``req`` into ``slot`` when its KV blocks (paged) and a
        prefill lane exist right now; no side effects otherwise."""
        p = len(req.prompt)
        tmpl = self._pick_template(req)
        need = p + req.max_new + self._slack(tmpl)
        if self.paged:
            nb = self.alloc.blocks_needed(need)
            if not self.alloc.can_allocate(nb) and self.bank is not None \
                    and req.tree_idx is None:
                # the pick outgrows the pool: serve on the narrowest
                # feasible template (reshaping may widen it later)
                tmpl = min(self._feasible_templates(req),
                           key=self.dec.row_slack)
                need = p + req.max_new + self._slack(tmpl)
                nb = self.alloc.blocks_needed(need)
            if not self.alloc.can_allocate(nb):
                return False                       # memory backpressure
        if self.prefill_lanes is not None \
                and self.prefilling_count() >= self.prefill_lanes:
            return False                           # prefill budget exhausted
        now = time.perf_counter()
        if self.paged:
            self.alloc.allocate(slot, need)
        temp = self.temperature if req.temperature is None \
            else req.temperature
        self.ex.admit_row(slot, req.prompt, tmpl, float(temp), req.rid,
                          req.seed)
        self.slots[slot] = _Slot(req=req, limit=p + req.max_new, pf=0,
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
    def step(self) -> None:
        """Dispatch one step and fold its results in."""
        t0 = time.perf_counter()
        tree_sel = None
        if self.bank is not None:
            tree_sel = np.asarray([0 if s is None else s.tree
                                   for s in self.slots], np.int64)
        any_prefilling = self.prefilling_count() > 0
        any_sampled = any(s is not None and s.temperature > 0
                          for s in self.slots)
        handle = self.ex.dispatch(any_prefilling=any_prefilling,
                                  tree_sel=tree_sel, any_sampled=any_sampled)
        self.stats["steps"] += 1
        self.stats["prefill_steps"] += any_prefilling
        self.stats["target_forwards"] += 1
        self.stats["draft_forwards"] += handle.n_draft
        for s in self.slots:
            if s is not None and s.pf < s.pf_len:
                cl = min(self.chunk, s.pf_len - s.pf)
                s.pf += cl
                self.stats["prefill_chunks"] += 1
                self.stats["prefill_tokens"] += cl
        self._process(handle)
        self.step_ms.append((time.perf_counter() - t0) * 1e3)

    def _process(self, handle: StepHandle) -> None:
        res = self.ex.harvest(handle)
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
        if self.bank is not None:
            # attribute to the templates the step was dispatched with
            np.add.at(self.stats["tree_hist"], handle.tree_sel[res.live], 1)
            for slot in np.nonzero(res.live)[0]:
                self.slots[slot].steps += 1
            if self.ctrl is not None and n_live:
                self.ctrl.update(res.live, handle.tree_sel, res.a, res.rank)
                self._reshape_slots(res.live)
        now = time.perf_counter()
        for slot, s in enumerate(self.slots):
            if s is None:
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
                self.ex.retire_row(slot)
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

    def latency_summary(self) -> Dict[str, float]:
        """Percentiles over completions and steps, in milliseconds."""
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
            step_p95_ms=pct(self.step_ms, 95))
