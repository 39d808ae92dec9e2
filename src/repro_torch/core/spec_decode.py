"""Speculative decoding core shared with the serving engine: PARD and AR.

Port of the greedy, chunked, paged half of ``repro.core.spec_decode``.
A step advances a ``DecodeState``:

  * the generation buffer ``gen [B, L]`` holds committed tokens and ``n``
    counts them; commits write a full (K+1)-slot window at offset n (slots
    past the accepted count are garbage, overwritten before any read);
  * KV rollback is positional: the next window's ``cache_pos`` re-covers
    rejected entries, which are invisible meanwhile (validity is
    ``position < kv_len``);
  * PARD draft (paper Eq. 7): ONE forward over the 2K-slot window
    ``[new committed tokens (A <= K+1) | mask x (K-1) | pad]`` proposes
    all K tokens; ONE target forward verifies them over ``[last committed,
    d_1..d_K]``;
  * chunked prefill: a row with ``pf_pos < pf_len`` feeds prompt chunks
    through the same two forwards instead of draft/verify windows, commits
    nothing, and advances its cursor.

Greedy verification is exactly lossless against AR decoding. Sampling,
VSD, tree drafting and the uniform-batch ``generate_*`` paths come with
later slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..models import forward
from ..models.config import ModelConfig
from .acceptance import greedy_chain_accept


@dataclasses.dataclass
class DecodeState:
    """Everything one step reads and writes (int64 counters, bool flags).

      gen    [B, L]   committed tokens (prompt + generated)
      n      [B]      committed count (reads are always < n)
      m      [B]      draft progress: committed tokens the draft has seen
      done   [B]      frozen rows: steps leave their gen/n/m unchanged
      tcache, dcache  paged KV pools of target and draft (written in place)
      tables [B, MBS] int32 block tables, shared by target and draft
      pf_pos [B]      chunked-prefill cursor: prompt tokens already cached
      pf_len [B]      prompt tokens to prefill (prompt length - 1: the last
                      prompt token is re-read by the first verify window)
    """
    gen: torch.Tensor
    n: torch.Tensor
    m: torch.Tensor
    done: torch.Tensor
    tcache: Any
    dcache: Any = None
    tables: Optional[torch.Tensor] = None
    pf_pos: Optional[torch.Tensor] = None
    pf_len: Optional[torch.Tensor] = None


def _arange(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.arange(n, device=like.device)


def _row_read(buf, pos, width: int):
    """buf [B, L]; the ``width`` slots at per-row offset ``pos``, with
    ``lax.dynamic_slice``'s clamping of the start into the buffer."""
    start = pos.clamp(0, buf.shape[1] - width)
    return buf.gather(1, start[:, None] + _arange(width, buf)[None, :])


def _row_write(buf, vec, pos):
    """buf [B, L] with vec [B, W] written at per-row offset ``pos``
    (start clamped like ``lax.dynamic_update_slice``)."""
    start = pos.clamp(0, buf.shape[1] - vec.shape[1])
    idx = start[:, None] + _arange(vec.shape[1], buf)[None, :]
    return buf.scatter(1, idx, vec)


def _draft_window(gen, n, m, k: int, mask_id: int):
    """[B, 2K] PARD draft window: new committed tokens + mask chain."""
    i = _arange(2 * k, gen)[None, :]
    a = (n - m)[:, None]                          # committed, unprocessed
    tok = gen.gather(1, (m[:, None] + i).clamp(0, gen.shape[1] - 1))
    is_real = i < a
    is_mask = (i >= a) & (i < a + (k - 1))
    return torch.where(is_real, tok,
                       torch.where(is_mask, mask_id, 0))


def _chunk_window(gen, pf, cl, width: int):
    """[B, width] prompt chunk at the prefill cursor ``pf``; slots past the
    per-row real count ``cl`` are zero pads whose KV writes the next chunk
    or the first decode window re-covers."""
    tok = _row_read(gen, pf, width)
    return torch.where(_arange(width, gen)[None, :] < cl[:, None], tok, 0)


def _phase(state: DecodeState):
    """(prefilling [B], pf [B]) from the state's prefill cursor fields."""
    return state.pf_pos < state.pf_len, state.pf_pos


class SpecDecoder:
    """Bundles target + draft and builds the engine's step functions.

    Params are the port's trees (``models.init_params`` or
    ``interop.params_from_numpy``); each forward runs in its params'
    storage dtype. ``kv_block_size`` is the paged pool's block size.
    """

    def __init__(self, target_params, target_cfg: ModelConfig,
                 draft_params=None, draft_cfg: Optional[ModelConfig] = None,
                 *, k: int = 8, kv_block_size: int = 64,
                 prefill_chunk: int = 8):
        if kv_block_size < 1:
            raise NotImplementedError(
                "contiguous KV caches come with a later slice of the port")
        if draft_cfg is not None and draft_cfg.vocab_size != target_cfg.vocab_size:
            raise ValueError("speculative decoding requires a shared vocab")
        self.tp, self.tc = target_params, target_cfg
        self.dp, self.dc = draft_params, draft_cfg
        self.k = k
        self.kv_block_size = kv_block_size
        self.prefill_chunk = prefill_chunk

    @property
    def window_slack(self) -> int:
        """Positions a step may touch beyond the committed count: the 2K
        draft window vs the K+1 verify window (AR decoders: the chunked AR
        window), +2."""
        slack = max(2 * self.k, self.k + 1)
        if self.dp is None:
            slack = max(slack, self.prefill_chunk)
        return slack + 2

    @property
    def chunk_width(self) -> int:
        """Prompt tokens one engine step consumes per prefilling row: the
        narrower of the 2K draft and K+1 verify windows (one cursor feeds
        both models); AR engines use ``prefill_chunk``."""
        if self.dp is None:
            return self.prefill_chunk
        return min(2 * self.k, self.k + 1)

    def _forward(self, params, cfg, tokens, caches, cache_pos, tables):
        return forward(params, cfg, tokens, caches=caches,
                       cache_pos=cache_pos, block_tables=tables,
                       kv_block_size=self.kv_block_size,
                       dtype=params["embed"]["embedding"].dtype)

    # ----------------------------------------------------------------- AR
    def _build_ar_step(self, chunked: bool = False):
        """One greedy AR step (the engine's mode="ar"). ``chunked=True``
        widens the window to ``prefill_chunk`` slots so prefilling rows
        consume prompt chunks in the same forward; decoding rows carry
        their last token at slot 0 plus pads (re-covered next step)."""
        w = self.prefill_chunk if chunked else 1

        def step(state: DecodeState) -> DecodeState:
            gen, n, done = state.gen, state.n, state.done
            toks = gen.gather(1, (n - 1)[:, None])
            cp = n - 1
            pf_pos = state.pf_pos
            frozen = done
            if chunked:
                prefilling, pf = _phase(state)
                cl = torch.minimum(torch.full_like(pf, w), state.pf_len - pf)
                toks = torch.nn.functional.pad(toks, (0, w - 1))
                toks = torch.where(prefilling[:, None],
                                   _chunk_window(gen, pf, cl, w), toks)
                cp = torch.where(prefilling, pf, cp)
                frozen = done | prefilling
                pf_pos = torch.where(prefilling, pf + cl, pf)
            logits, tcache = self._forward(self.tp, self.tc, toks,
                                           state.tcache, cp, state.tables)
            nxt = logits[:, 0].argmax(dim=-1)
            gen2 = _row_write(gen, nxt[:, None], n)
            return dataclasses.replace(
                state, gen=torch.where(frozen[:, None], gen, gen2),
                n=torch.where(frozen, n, n + 1), tcache=tcache, pf_pos=pf_pos)
        return step

    # --------------------------------------------------------------- PARD
    def _pard_depth_logits(self, gen, n, m, dcache, tables, pfinfo=None):
        """ONE PARD draft forward (Eq. 7): proposal logits for depths 1..K.
        Slot A-1 (the last real token) proposes depth 1, the K-1 mask
        slots the rest. Prefilling rows (``pfinfo = (prefilling, pf, cl)``)
        feed a prompt chunk instead; their proposals are never committed.
        Returns (lg [B, K, V], draft caches)."""
        k = self.k
        tok = _draft_window(gen, n, m, k, self.dc.mask_token_id)
        pos = m
        if pfinfo is not None:
            prefilling, pf, cl = pfinfo
            tok = torch.where(prefilling[:, None],
                              _chunk_window(gen, pf, cl, 2 * k), tok)
            pos = torch.where(prefilling, pf, pos)
        logits, dcache = self._forward(self.dp, self.dc, tok, dcache, pos,
                                       tables)
        sl = ((n - m - 1)[:, None] + _arange(k, gen)[None, :]).clamp(0, 2 * k - 1)
        lg = logits.gather(1, sl[:, :, None].expand(-1, -1, logits.shape[-1]))
        return lg, dcache

    def _build_spec_step(self, mode: str, chunked: bool = False,
                         greedy_only: bool = False):
        """One greedy PARD step with chunked prefill (the engine's step).
        Returns ``step(state) -> (state, a)`` where ``a [B]`` is each row's
        accepted draft count (0 for frozen rows)."""
        if mode != "pard":
            raise NotImplementedError("VSD comes with a later slice of the port")
        if not (chunked and greedy_only):
            raise NotImplementedError(
                "the unchunked step (generate_*) and sampled acceptance come "
                "with later slices of the port")
        k = self.k
        cw = self.chunk_width

        def step(state: DecodeState):
            gen, n, m, done = state.gen, state.n, state.m, state.done
            tables = state.tables
            prefilling, pf = _phase(state)
            cl = torch.minimum(torch.full_like(pf, cw), state.pf_len - pf)
            lg, dcache = self._pard_depth_logits(gen, n, m, state.dcache,
                                                 tables, (prefilling, pf, cl))
            props = lg.argmax(dim=-1)                              # [B, K]

            # verify window: [last committed, d_1..d_K]
            vin = torch.cat([gen.gather(1, (n - 1)[:, None]), props], dim=1)
            vin = torch.where(prefilling[:, None],
                              _chunk_window(gen, pf, cl, k + 1), vin)
            vpos = torch.where(prefilling, pf, n - 1)
            logits, tcache = self._forward(self.tp, self.tc, vin,
                                           state.tcache, vpos, tables)
            a, _, commit = greedy_chain_accept(logits, props)

            # frozen rows commit nothing: done rows stay done, prefilling
            # rows consumed a prompt chunk instead of a verify window
            frozen = done | prefilling
            j = _arange(k + 1, gen)[None, :]
            props_ext = torch.cat([props, props[:, -1:]], dim=1)
            vec = torch.where(j < a[:, None], props_ext,
                              torch.where(j == a[:, None], commit[:, None], 0))
            vec = torch.where(frozen[:, None], _row_read(gen, n, k + 1), vec)
            new_state = dataclasses.replace(
                state, gen=_row_write(gen, vec, n),
                n=n + torch.where(frozen, 0, a + 1),
                m=torch.where(frozen, m, n), tcache=tcache, dcache=dcache,
                pf_pos=torch.where(prefilling, pf + cl, pf))
            return new_state, torch.where(frozen, 0, a)
        return step

    def generate_ar(self, *args, **kwargs):
        raise NotImplementedError(
            "uniform-batch generate_* on contiguous caches comes with a later "
            "slice of the port; serve through serving.engine.Engine")

    generate_spec = generate_ar
