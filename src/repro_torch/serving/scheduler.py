"""Host-side half of the serving stack (port of
``repro.serving.scheduler`` for one replica).

The ``Scheduler`` owns every decision that does not touch the device:

  * the request queue and FIFO-fair skip-ahead admission: a bounded prefix
    of the queue (``admit_window``) is scanned per free slot, so one
    pool-oversized request cannot starve smaller ones behind it, and
    nothing beyond the window may overtake it;
  * chunked-prefill budgeting: at most ``prefill_budget // chunk_width``
    rows prefill at once (None = no limit);
  * block allocation and release through ``kv_pool.BlockAllocator``;
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

from ..core.spec_decode import SpecDecoder
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
    first_t: float = float("nan")
    last_t: float = 0.0
    last_n: int = 0
    samples: List = dataclasses.field(default_factory=list)


class Scheduler:
    """Queue, admission and accounting over one Executor."""

    def __init__(self, dec: SpecDecoder, executor: Executor,
                 alloc: kv_pool.BlockAllocator, *, max_batch: int,
                 max_len: int, eos_id: Optional[int], admit_window: int,
                 prefill_budget: Optional[int]):
        self.dec, self.ex, self.alloc = dec, executor, alloc
        self.max_len = max_len
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
            draft_forwards=0, target_forwards=0, prefill_chunks=0,
            prefill_tokens=0)

    # ------------------------------------------------------------- submit
    def submit(self, prompt, max_new: Optional[int] = None,
               params: Optional[SamplingParams] = None) -> int:
        if params is None:
            params = SamplingParams(max_new=max_new)
        elif max_new is not None and params.max_new not in (None, max_new):
            raise ValueError(f"conflicting max_new: {max_new} vs "
                             f"SamplingParams.max_new={params.max_new}")
        elif max_new is not None:
            params = dataclasses.replace(params, max_new=max_new)
        if params.max_new is None:
            raise ValueError("max_new is required")
        prompt = np.asarray(prompt, np.int64)
        need = len(prompt) + params.max_new + self.dec.window_slack
        if len(prompt) < 2 or need > self.max_len:
            raise ValueError(
                f"request needs {need} cache positions (prompt="
                f"{len(prompt)}, max_new={params.max_new}, window slack="
                f"{self.dec.window_slack}) but max_len={self.max_len}; "
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
    def _try_admit(self, slot: int, req: Request) -> bool:
        """Admit ``req`` into ``slot`` when its KV blocks and a prefill
        lane exist right now; no side effects otherwise."""
        p = len(req.prompt)
        need = p + req.max_new + self.dec.window_slack
        if not self.alloc.can_allocate(self.alloc.blocks_needed(need)):
            return False                           # memory backpressure
        if self.prefill_lanes is not None \
                and self.prefilling_count() >= self.prefill_lanes:
            return False                           # prefill budget exhausted
        now = time.perf_counter()
        self.alloc.allocate(slot, need)
        self.ex.admit_row(slot, req.prompt)
        self.slots[slot] = _Slot(req=req, limit=p + req.max_new, pf=0,
                                 pf_len=p - 1,
                                 submit_t=self._submit_t.pop(req.rid, now),
                                 admit_t=now, last_t=now, last_n=p)
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
        handle = self.ex.dispatch(any_prefilling=self.prefilling_count() > 0)
        self.stats["steps"] += 1
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
        else:
            self.stats["committed"] += n_live
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
                self.alloc.release(slot)

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
