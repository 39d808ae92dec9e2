"""Speculative decoding core shared with the serving engine: AR, VSD,
PARD and PARD trees.

Port of the chunked half of ``repro.core.spec_decode``, on paged or
contiguous KV. A step advances a ``DecodeState``:

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
  * VSD draft (the paper's vanilla speculative decoding baseline): the
    same window's committed tokens advance the draft and propose token 1,
    then K-1 one-token AR forwards propose the rest (K draft forwards);
  * chunked prefill: a row with ``pf_pos < pf_len`` feeds prompt chunks
    through the same two forwards instead of draft/verify windows, commits
    nothing, and advances its cursor;
  * tree drafting (``TreeTemplate`` / ``TemplateBank``): the same single
    draft forward populates a static top-k candidate tree per row (the
    row's template is ``DecodeState.tree_idx``), one target forward
    verifies the packed tree under ancestor-mask attention, the longest
    root path matching the target argmax commits, and
    ``compact_tree_caches`` moves the winning path's KV onto the committed
    positions.

Greedy verification is exactly lossless against AR decoding, flat or
tree. Temperature is per row (``DecodeState.temp``; one batch mixes
greedy and sampled rows): sampled rows propose by sampling and the flat
chain accepts by Leviathan speculative sampling, the tree by multi-round
recursive rejection sampling (``core.acceptance``). Draws come from per-row
threefry keys (``DecodeState.rngs``, ``core.prng``): a row's stream
depends only on its own key and step count, and the bits are the JAX
package's. Each step builder has a ``greedy_only`` variant without the
sampled machinery, which the engine picks on the host when no occupied
row samples: a step never reads ``temp`` back from the device.

Mamba2 (SSM) layers cannot roll back positionally: every forward of an
SSM model over a window with slots past what the row keeps (the draft's
mask chain, the verify window's rejected drafts, pads of a short prompt
chunk or of the AR window) collects its Mamba2 records (``collect_ssm``)
and ``gather_ssm_states`` then sets each row's state to the one after its last
kept token. The uniform-batch ``generate_*`` paths come with a later
slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..models import forward
from ..models.attention import (TreeAttnInfo, as_bytes,
                                contiguous_flat_index, paged_flat_index)
from ..models.config import SSM, ModelConfig, scan_plan
from ..models.ssm import gather_state
from . import acceptance, prng
from .acceptance import (greedy_chain_accept, greedy_tree_accept_rows,
                         tree_child_map)


@dataclasses.dataclass
class DecodeState:
    """Everything one step reads and writes (int64 counters, bool flags).

      gen    [B, L]   committed tokens (prompt + generated)
      n      [B]      committed count (reads are always < n)
      m      [B]      draft progress: committed tokens the draft has seen
      done   [B]      frozen rows: steps leave their gen/n/m unchanged
      tcache, dcache  KV caches of target and draft (written in place):
                      paged pools, or contiguous rows when tables is None
      tables [B, MBS] int32 block tables, shared by target and draft
                      (None: contiguous caches)
      temp   [B]      f32 per-row temperature (0 = greedy)
      rngs   [B, 2]   per-row threefry keys: a sampled step splits each
                      decoding row's key once, so a row's stream depends
                      only on its own key and step count
      tree_idx [B]    per-row template index into the decoder's
                      ``TemplateBank`` (None when tree drafting is off)
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
    temp: Optional[torch.Tensor] = None
    rngs: Optional[torch.Tensor] = None
    tree_idx: Optional[torch.Tensor] = None
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


def _topk_indices(logits, k: int):
    """Indices of the ``k`` largest logits along the last axis, descending,
    lowest index first on ties (``lax.top_k``'s order), by ``k``
    argmax-and-mask passes: rank 0 is exactly the flat path's argmax."""
    idx = []
    cur = logits
    for j in range(k):
        i = cur.argmax(dim=-1)
        idx.append(i)
        if j + 1 < k:
            cur = cur.scatter(-1, i[..., None], float("-inf"))
    return torch.stack(idx, dim=-1)


def _has_ssm(cfg: ModelConfig) -> bool:
    plan = scan_plan(cfg)
    return any(s.mixer == SSM for s in plan.prefix + plan.period)


def ssm_leaves(cfg: ModelConfig, caches) -> list:
    """Every Mamba2 conv and SSM state tensor of ``caches``: the leaves a
    forward without ``collect_ssm`` advances in place."""
    plan = scan_plan(cfg)
    out = []
    for specs, entries in ((plan.prefix, caches["prefix"]),
                           (plan.period, caches["scan"])):
        for spec, entry in zip(specs, entries):
            if spec.mixer == SSM:
                out.extend(entry.values())
    return out


def _pick_next(logits, temp, keys):
    """[B, V] logits -> [B] next token: the argmax for temp == 0 rows, a
    sample of softmax(logits / temp) under the row's own key otherwise."""
    greedy = logits.argmax(dim=-1)
    s = acceptance.row_categorical(keys, acceptance.scale_logits(logits, temp))
    return torch.where(temp > 0, s, greedy)


def _split_keys(state: DecodeState, prefilling):
    """(next keys, this step's keys) of a sampled step: each row's key
    splits once, but a prefilling row keeps its key, so a request's sampled
    tokens do not depend on how its prompt was prefilled."""
    next_keys, use = acceptance.split_row_keys(state.rngs)
    if prefilling is not None:
        next_keys = torch.where(prefilling[:, None], state.rngs, next_keys)
    return next_keys, use


def _sampling_keys(state: DecodeState, prefilling):
    """(next keys, draft keys, acceptance keys) of a sampled speculative
    step: this step's keys folded with 0 and 1."""
    next_keys, use = _split_keys(state, prefilling)
    return (next_keys, acceptance.fold_row_keys(use, 0),
            acceptance.fold_row_keys(use, 1))


def gather_ssm_states(records, idx) -> None:
    """Set the Mamba2 state of every record of a ``collect_ssm`` forward
    to the state after ``idx[b] + 1`` tokens of the window (row b's last
    kept slot), in place in the caches. Each layer costs one
    ``ssd_chunked`` from its incoming state with dt = 0 past ``idx[b]``."""
    if not records:
        return
    idx = idx.long().clamp(0, records[0]["dt"].shape[1] - 1)
    for record in records:
        gather_state(record, idx)


# ---------------------------------------------------------------------------
# Candidate trees: static templates for tree-structured PARD drafting
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TreeTemplate:
    """Static top-k candidate tree, built from per-depth branching factors:
    every node at depth d-1 expands into one child per top-k rank
    c < branching[d-1] of the draft's depth-d proposal distribution.

    Slot 0 is the root (the re-processed last committed token); nodes are
    laid out breadth-first, so a node's parent precedes it. The window
    (1 + num_nodes slots) must fit a uint32 ancestor bitmask: <= 32 slots.
    """
    branching: Tuple[int, ...]
    parent: Any          # np [S] int32; parent[0] = -1
    depth: Any           # np [S] int32; depth[0] = 0
    choice: Any          # np [S] int32; top-k rank at the node's depth
    anc: Any             # np [S] uint32 packed ancestor-or-self bitmask

    @staticmethod
    def from_branching(branching) -> "TreeTemplate":
        branching = tuple(int(x) for x in branching)
        if not branching or any(x < 1 for x in branching):
            raise ValueError(f"branching factors must be >= 1: {branching}")
        parent, depth, choice = [-1], [0], [0]
        prev, slot = [0], 1
        for d, bd in enumerate(branching, start=1):
            new = []
            for p in prev:
                for c in range(bd):
                    parent.append(p)
                    depth.append(d)
                    choice.append(c)
                    new.append(slot)
                    slot += 1
            prev = new
        if slot > 32:
            raise ValueError(
                f"tree template needs {slot} window slots but the packed "
                f"ancestor bitmask holds 32 (shrink the branching factors)")
        anc = [1]
        for s in range(1, slot):
            anc.append(anc[parent[s]] | (1 << s))
        return TreeTemplate(
            branching=branching,
            parent=np.asarray(parent, np.int32),
            depth=np.asarray(depth, np.int32),
            choice=np.asarray(choice, np.int32),
            anc=np.asarray(anc, np.uint32))

    @staticmethod
    def flat(k: int) -> "TreeTemplate":
        """Degenerate single-branch chain: token-identical to flat K."""
        return TreeTemplate.from_branching((1,) * k)

    @property
    def num_slots(self) -> int:
        return len(self.parent)

    @property
    def num_nodes(self) -> int:
        return len(self.parent) - 1

    @property
    def max_depth(self) -> int:
        return len(self.branching)

    @property
    def is_chain(self) -> bool:
        return all(b == 1 for b in self.branching)


@dataclasses.dataclass(frozen=True)
class TemplateBank:
    """Templates of one shared depth, selectable per row.

    Slot metadata is padded to the widest template (``max_slots``) and
    stacked; the tree step gathers each row's arrays by
    ``DecodeState.tree_idx``. Padded slots carry zeros (anc == 0,
    depth == 0) and are masked by ``nslots``, so they are never accepted.
    """
    templates: Tuple[TreeTemplate, ...]
    parent: Any      # np [T, S] int32
    depth: Any       # np [T, S] int32
    choice: Any      # np [T, S] int32
    anc: Any         # np [T, S] uint32
    child_map: Any   # np [T, S, MB] int32 (0 = absent child)
    nslots: Any      # np [T] int32

    @staticmethod
    def from_templates(templates) -> "TemplateBank":
        """Pack templates (TreeTemplates or branching tuples) into one bank;
        all must share one depth so a row can re-select between windows."""
        templates = tuple(
            t if isinstance(t, TreeTemplate) else
            TreeTemplate.from_branching(t) for t in templates)
        if not templates:
            raise ValueError("a template bank needs at least one template")
        if len({t.max_depth for t in templates}) != 1:
            raise ValueError(
                "bank templates must share one depth (pad branchings with "
                f"trailing 1s): {[t.branching for t in templates]}")
        n_t = len(templates)
        s = max(t.num_slots for t in templates)
        mb = max(max(t.branching) for t in templates)
        parent = np.zeros((n_t, s), np.int32)
        depth = np.zeros((n_t, s), np.int32)
        choice = np.zeros((n_t, s), np.int32)
        anc = np.zeros((n_t, s), np.uint32)
        cmap = np.zeros((n_t, s, mb), np.int32)
        for i, t in enumerate(templates):
            ns = t.num_slots
            parent[i, :ns] = t.parent
            depth[i, :ns] = t.depth
            choice[i, :ns] = t.choice
            anc[i, :ns] = t.anc
            cm = tree_child_map(t)
            cmap[i, :ns, :cm.shape[1]] = cm
        return TemplateBank(
            templates=templates, parent=parent, depth=depth, choice=choice,
            anc=anc, child_map=cmap,
            nslots=np.asarray([t.num_slots for t in templates], np.int32))

    @staticmethod
    def default(k: int = 4) -> "TemplateBank":
        """The three-shape bank at depth ``k``: a flat-K chain, a balanced
        tree and a shallow-wide tree. Each later shape must fit the 32-slot
        cap and the window the earlier picks established, so a wide hedge
        never widens every row's padded verify window."""
        def nslots(br):
            slots, width = 1, 1
            for x in br:
                width *= x
                slots += width
            return slots

        shapes, cap = [(1,) * k], 32
        for heads in [[(2, 2, 2), (2, 2), (2,)],
                      [(4, 2), (3, 2), (3,), (2, 2, 2), (2, 2)]]:
            for head in heads:
                br = (head + (1,) * (k - len(head)))[:k]
                if len(head) <= k and nslots(br) <= cap and br not in shapes:
                    shapes.append(br)
                    cap = min(cap, nslots(br))
                    break
        return TemplateBank.from_templates(shapes)

    def __len__(self) -> int:
        return len(self.templates)

    @property
    def max_depth(self) -> int:
        return self.templates[0].max_depth

    @property
    def max_slots(self) -> int:
        """Widest template's slot count: the packed window width."""
        return int(self.parent.shape[1])

    @property
    def max_branching(self) -> int:
        return int(self.child_map.shape[2])

    @property
    def key(self) -> str:
        return "|".join("x".join(map(str, t.branching))
                        for t in self.templates)


def _move_entries(leaf, lead: int, src, dst):
    """leaf[..., dst] = leaf[..., src] over the flat entries of the two
    axes after ``lead`` leading axes, gathering before scattering."""
    flat = as_bytes(leaf).view(tuple(leaf.shape[:lead]) + (-1,)
                               + tuple(leaf.shape[lead + 2:]))
    flat.index_copy_(lead, dst, flat.index_select(lead, src))


def compact_tree_caches(cfg: ModelConfig, caches, src_pos, dst_start,
                        depth: int, tables, block_size: int):
    """Copy the winning tree path's KV onto the committed positions, IN
    PLACE: for d = 1..depth the entry at ``src_pos[:, d-1]`` is copied to
    position ``dst_start + d - 1`` (rejected depths and frozen rows carry
    src == dst, an identity copy). All sources are gathered before any
    destination is written. Paged caches map positions through ``tables``
    (frozen rows' copies may land on the garbage block, where duplicate
    destinations are harmless); contiguous rows clamp the destination
    start into [0, max_len - depth] like ``lax.dynamic_update_slice`` and
    the source into the row. Every leaf moves, so a quantized cache's
    scales move with their codes (fp8 as bytes). Returns ``caches``."""
    dev = src_pos.device
    dst_pos = dst_start[:, None] + torch.arange(depth, device=dev)[None]
    if tables is None:
        plan_leaf = (caches["prefix"][0]["k"] if caches["prefix"]
                     else caches["scan"][0]["k"][0])
        max_len = plan_leaf.shape[1]
        rows = torch.arange(src_pos.shape[0], device=dev)[:, None] * max_len
        src = (rows + src_pos.long().clamp(0, max_len - 1)).reshape(-1)
        dst = contiguous_flat_index(dst_start, depth, max_len)
    else:
        src = paged_flat_index(tables, src_pos.long(), block_size).reshape(-1)
        dst = paged_flat_index(tables, dst_pos.long(), block_size).reshape(-1)
    for entry in caches["prefix"]:
        for leaf in entry.values():
            _move_entries(leaf, 0, src, dst)
    for entry in caches["scan"]:
        for leaf in entry.values():
            _move_entries(leaf, 1, src, dst)
    return caches


def as_bank(tree) -> "TemplateBank":
    """A branching iterable, TreeTemplate or TemplateBank as a bank."""
    if isinstance(tree, TemplateBank):
        return tree
    if not isinstance(tree, TreeTemplate):
        tree = TreeTemplate.from_branching(tree)
    return TemplateBank.from_templates((tree,))


class SpecDecoder:
    """Bundles target + draft and builds the engine's step functions.

    Params are the port's trees (``models.init_params`` or
    ``interop.params_from_numpy``); each forward runs in its params'
    storage dtype. ``kv_block_size`` is the paged pool's block size; 0
    selects contiguous caches (``DecodeState.tables`` is then None).
    ``tree`` (a branching iterable, ``TreeTemplate`` or ``TemplateBank``)
    turns on tree drafting; K then is the bank's depth.
    """

    def __init__(self, target_params, target_cfg: ModelConfig,
                 draft_params=None, draft_cfg: Optional[ModelConfig] = None,
                 *, k: int = 8, kv_block_size: int = 64,
                 prefill_chunk: int = 8, tree=None):
        if draft_cfg is not None and draft_cfg.vocab_size != target_cfg.vocab_size:
            raise ValueError("speculative decoding requires a shared vocab")
        if kv_block_size < 0:
            raise ValueError(f"kv_block_size must be >= 0, got {kv_block_size}")
        self.tp, self.tc = target_params, target_cfg
        self.dp, self.dc = draft_params, draft_cfg
        if tree is not None:
            tree = as_bank(tree)
            if _has_ssm(target_cfg):
                raise NotImplementedError(
                    "tree verification relies on positional KV rollback; "
                    "an SSM/hybrid target cannot roll back a packed tree "
                    "window")
            if draft_cfg is not None and _has_ssm(draft_cfg):
                raise NotImplementedError(
                    "tree drafting with an SSM/hybrid draft is not ported "
                    "yet")
            k = tree.max_depth
        self.tree: Optional[TemplateBank] = tree
        self.k = k
        self.kv_block_size = kv_block_size
        self.prefill_chunk = prefill_chunk
        self._bank_on = {}

    @property
    def window_slack(self) -> int:
        """Positions a step may touch beyond the committed count: the 2K
        draft window vs the verify window (K+1 flat, the bank's widest
        template for a tree; AR decoders: the chunked AR window), +2. VSD's
        proposal forwards write positions n .. n+K-2, inside it."""
        verify = self.tree.max_slots if self.tree is not None else self.k + 1
        slack = max(2 * self.k, verify)
        if self.dp is None:
            slack = max(slack, self.prefill_chunk)
        return slack + 2

    @property
    def chunk_width(self) -> int:
        """Prompt tokens one engine step consumes per prefilling row: the
        narrower of the 2K draft and the verify window (K+1 flat, the
        bank's max_slots tree; one cursor feeds both models); AR engines
        use ``prefill_chunk``."""
        if self.dp is None:
            return self.prefill_chunk
        verify = self.tree.max_slots if self.tree is not None else self.k + 1
        return min(2 * self.k, verify)

    def row_slack(self, tmpl_idx: int) -> int:
        """Window slack of ONE request pinned to bank template
        ``tmpl_idx``: its own verify window instead of the bank's widest.
        Paged allocations sized with it still cover every position the row
        reads; the batch's wider writes past it land in the garbage block."""
        if self.tree is None:
            raise ValueError("row_slack applies to tree drafting")
        return max(2 * self.k, int(self.tree.nslots[tmpl_idx])) + 2

    @property
    def min_row_slack(self) -> int:
        """The smallest per-request slack any bank template needs."""
        if self.tree is None:
            return self.window_slack
        return min(self.row_slack(i) for i in range(len(self.tree)))

    def _forward(self, params, cfg, tokens, caches, cache_pos, tables,
                 positions=None, tree_info=None, records=None):
        """One forward over a window. Given a ``records`` list, Mamba2
        layers leave their states and append their records for
        ``gather_ssm_states``."""
        return forward(params, cfg, tokens, positions, caches=caches,
                       cache_pos=cache_pos, block_tables=tables,
                       kv_block_size=self.kv_block_size,
                       dtype=params["embed"]["embedding"].dtype,
                       tree_info=tree_info, collect_ssm=records)

    # ----------------------------------------------------------------- AR
    def _build_ar_step(self, chunked: bool = False,
                       greedy_only: bool = False):
        """One AR step (the engine's mode="ar"): temp == 0 rows commit the
        argmax, temp > 0 rows sample softmax(logits / temp) under their own
        key. ``chunked=True`` widens the window to ``prefill_chunk`` slots
        so prefilling rows consume prompt chunks in the same forward;
        decoding rows carry their last token at slot 0 plus pads
        (re-covered next step). A Mamba2 target keeps the state after slot
        0 (decoding rows) or after the chunk's last real token: unlike the
        JAX engine's AR step, the pads never reach the recurrent state.

        ``greedy_only=True`` leaves the keys alone. The JAX engine's AR
        step splits every row's key on every step, sampling or not; the
        tokens are the same, because a sampled row gets a fresh key at
        admission and every step while it is decoding samples."""
        w = self.prefill_chunk if chunked else 1

        def step(state: DecodeState) -> DecodeState:
            gen, n, done = state.gen, state.n, state.done
            toks = gen.gather(1, (n - 1)[:, None])
            cp = n - 1
            pf_pos = state.pf_pos
            frozen = done
            records = ssm_idx = prefilling = None
            if chunked:
                prefilling, pf = _phase(state)
                cl = torch.minimum(torch.full_like(pf, w), state.pf_len - pf)
                toks = torch.nn.functional.pad(toks, (0, w - 1))
                toks = torch.where(prefilling[:, None],
                                   _chunk_window(gen, pf, cl, w), toks)
                cp = torch.where(prefilling, pf, cp)
                frozen = done | prefilling
                pf_pos = torch.where(prefilling, pf + cl, pf)
                records, ssm_idx = [], torch.where(prefilling, cl - 1, 0)
            logits, tcache = self._forward(self.tp, self.tc, toks,
                                           state.tcache, cp, state.tables,
                                           records=records)
            gather_ssm_states(records, ssm_idx)
            rngs = state.rngs
            if greedy_only:
                nxt = logits[:, 0].argmax(dim=-1)
            else:
                rngs, use = _split_keys(state, prefilling)
                nxt = _pick_next(logits[:, 0], state.temp, use)
            gen2 = _row_write(gen, nxt[:, None], n)
            return dataclasses.replace(
                state, gen=torch.where(frozen[:, None], gen, gen2),
                n=torch.where(frozen, n, n + 1), tcache=tcache, pf_pos=pf_pos,
                rngs=rngs)
        return step

    # --------------------------------------------------------------- PARD
    def _pard_depth_logits(self, gen, n, m, dcache, tables, pfinfo=None):
        """ONE PARD draft forward (Eq. 7): proposal logits for depths 1..K.
        Slot A-1 (the last real token) proposes depth 1, the K-1 mask
        slots the rest; a Mamba2 draft keeps the state after slot A-1.
        Prefilling rows (``pfinfo = (prefilling, pf, cl)``) feed a prompt
        chunk instead (state after its last real token); their proposals
        are never committed. Returns (lg [B, K, V], draft caches)."""
        k = self.k
        tok = _draft_window(gen, n, m, k, self.dc.mask_token_id)
        pos = m
        ssm_idx = n - m - 1
        if pfinfo is not None:
            prefilling, pf, cl = pfinfo
            tok = torch.where(prefilling[:, None],
                              _chunk_window(gen, pf, cl, 2 * k), tok)
            pos = torch.where(prefilling, pf, pos)
            ssm_idx = torch.where(prefilling, cl - 1, ssm_idx)
        records = []
        logits, dcache = self._forward(self.dp, self.dc, tok, dcache, pos,
                                       tables, records=records)
        gather_ssm_states(records, ssm_idx)
        sl = ((n - m - 1)[:, None] + _arange(k, gen)[None, :]).clamp(0, 2 * k - 1)
        lg = logits.gather(1, sl[:, :, None].expand(-1, -1, logits.shape[-1]))
        return lg, dcache

    def _propose_vsd(self, gen, n, m, dcache, tables, pfinfo, temp, dkeys):
        """VSD draft: call 1 runs the committed window (real tokens only,
        K+1 slots) and proposes token 1 from slot A-1; K-1 one-token AR
        forwards propose the rest, each sampled under ``fold_in(dkeys, j)``
        (argmax when ``dkeys`` is None). Returns (props [B, K], proposal
        logits [B, K, V], draft caches).

        The caches are written in place. A Mamba2 draft's states are copied
        after call 1's gather and restored after the proposals, as the JAX
        package throws away what the proposal forwards did to its cache.
        Their attention KV at positions n .. n+K-2 stays and is harmless:
        it lies past every committed token, so nothing reads it before the
        next step's call 1, which starts at m' = n, writes its window over
        it."""
        k = self.k
        tok = _draft_window(gen, n, m, k, self.dc.mask_token_id)[:, :k + 1]
        pos = m
        ssm_idx = n - m - 1
        if pfinfo is not None:
            prefilling, pf, cl = pfinfo
            tok = torch.where(prefilling[:, None],
                              _chunk_window(gen, pf, cl, k + 1), tok)
            pos = torch.where(prefilling, pf, pos)
            ssm_idx = torch.where(prefilling, cl - 1, ssm_idx)
        records = []
        logits, dcache = self._forward(self.dp, self.dc, tok, dcache, pos,
                                       tables, records=records)
        gather_ssm_states(records, ssm_idx)
        leaves = ssm_leaves(self.dc, dcache)
        snapshot = [leaf.clone() for leaf in leaves]
        rows = _arange(gen.shape[0], gen)
        lg = [logits[rows, (n - m - 1).clamp(0, k)]]
        props = []
        for j in range(k):
            if dkeys is None:
                pj = lg[-1].argmax(dim=-1)
            else:
                pj = _pick_next(lg[-1], temp,
                                acceptance.fold_row_keys(dkeys, j))
            props.append(pj)
            if j == k - 1:
                break
            lgn, dcache = self._forward(self.dp, self.dc, pj[:, None], dcache,
                                        n + j, tables)
            lg.append(lgn[:, 0])
        for leaf, saved in zip(leaves, snapshot):
            leaf.copy_(saved)
        return torch.stack(props, dim=1), torch.stack(lg, dim=1), dcache

    def _build_spec_step(self, mode: str, chunked: bool = False,
                         greedy_only: bool = False):
        """One flat speculative step with chunked prefill (the engine's
        step): mode "pard" drafts with one PARD forward, "vsd" with K AR
        draft forwards. Returns ``step(state) -> (state, a)`` where ``a
        [B]`` is each row's accepted draft count (0 for frozen rows).

        Greedy rows propose the draft's argmax and keep the longest prefix
        matching the target argmax; sampled rows (temp > 0) propose by
        sampling the draft's softmax(logits / temp) and accept by Leviathan
        speculative sampling. ``greedy_only=True`` builds the variant
        without the sampled machinery and without key splitting, which
        commits the same tokens when no row samples."""
        if not chunked:
            raise NotImplementedError(
                "the unchunked step (generate_*) comes with a later slice of "
                "the port")
        k = self.k
        cw = self.chunk_width

        def step(state: DecodeState):
            gen, n, m, done = state.gen, state.n, state.m, state.done
            tables, temp = state.tables, state.temp
            prefilling, pf = _phase(state)
            cl = torch.minimum(torch.full_like(pf, cw), state.pf_len - pf)
            pfinfo = (prefilling, pf, cl)
            next_keys, dkeys, akeys = ((state.rngs, None, None) if greedy_only
                                       else _sampling_keys(state, prefilling))
            if mode == "pard":
                lg, dcache = self._pard_depth_logits(gen, n, m, state.dcache,
                                                     tables, pfinfo)
                props = lg.argmax(dim=-1)                          # [B, K]
                if not greedy_only:
                    # one key per row draws the whole [K, V] block
                    sampled = prng.categorical(
                        dkeys, acceptance.scale_logits(lg, temp))
                    props = torch.where((temp > 0)[:, None], sampled, props)
            else:
                props, lg, dcache = self._propose_vsd(
                    gen, n, m, state.dcache, tables, pfinfo, temp, dkeys)

            # verify window: [last committed, d_1..d_K]
            vin = torch.cat([gen.gather(1, (n - 1)[:, None]), props], dim=1)
            vin = torch.where(prefilling[:, None],
                              _chunk_window(gen, pf, cl, k + 1), vin)
            vpos = torch.where(prefilling, pf, n - 1)
            records = []
            logits, tcache = self._forward(self.tp, self.tc, vin,
                                           state.tcache, vpos, tables,
                                           records=records)
            a, _, commit = greedy_chain_accept(logits, props)
            if not greedy_only:
                qprob = torch.softmax(acceptance.scale_logits(lg, temp), -1)
                p_full = acceptance.temp_softmax(logits, temp)
                a_s, _, commit_s = acceptance.leviathan_accept(
                    p_full, qprob, props, akeys)
                sampled = temp > 0
                a = torch.where(sampled, a_s, a)
                commit = torch.where(sampled, commit_s, commit)
            # a Mamba2 target keeps the state after the last accepted draft
            # (slot a), a prefilling row after its chunk's last real token
            gather_ssm_states(records, torch.where(prefilling, cl - 1, a))

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
                rngs=next_keys, pf_pos=torch.where(prefilling, pf + cl, pf))
            return new_state, torch.where(frozen, 0, a)
        return step

    # --------------------------------------------------------------- tree
    def _bank_tensors(self, device):
        """The bank's per-slot metadata as int64 tensors on ``device``."""
        t = self._bank_on.get(device)
        if t is None:
            bank = self.tree
            s = bank.max_slots

            def dev(a):
                return torch.as_tensor(np.asarray(a, np.int64), device=device)

            t = dict(parent=dev(bank.parent), depth=dev(bank.depth),
                     choice=dev(bank.choice), anc=dev(bank.anc),
                     child_map=dev(bank.child_map), nslots=dev(bank.nslots),
                     # causal ancestor-or-self masks: slot i sees 0..i
                     chain_anc=dev((np.int64(2) << np.arange(s)) - 1))
            self._bank_on[device] = t
        return t

    def _build_tree_step(self, chunked: bool = False,
                         greedy_only: bool = False):
        """One tree-verification step over per-row templates with chunked
        prefill (the engine's step when trees are on). Returns
        ``step(state) -> (state, a, rank)``: ``a [B]`` accepted depths (0
        for frozen rows), ``rank [B, D]`` the accepted sibling rank per
        depth (-1 where rejected or frozen), the adaptive controller's
        signal.

        Each row's template metadata is gathered from the bank by
        ``state.tree_idx``. Draft: ONE PARD forward gives one proposal
        distribution per depth; a greedy row's template takes the top-b_d
        tokens at depth d, a sampled row draws every node i.i.d. from its
        depth's softmax(logits / temp). Verify: ONE target forward over the
        packed tree with logical positions root + depth and the tree mask;
        ``win_len`` bounds each row to its own template. Prefilling rows
        ride the same forwards: their chunk is a causal "tree"
        (all-lower-bits ancestor masks, ``win_len`` = the chunk's real
        tokens), sliced at the chunk width and padded to the window.
        Commit: a greedy row keeps the longest root path matching the
        target argmax, a sampled row runs multi-round recursive rejection
        sampling over each surviving node's children;
        ``compact_tree_caches`` then moves the path's KV onto the committed
        positions, and losing branches are re-covered by the next window
        like flat rejects. ``greedy_only=True`` builds the variant without
        the sampled machinery and without key splitting."""
        if not chunked:
            raise NotImplementedError(
                "the unchunked tree step (generate_*) comes with a later "
                "slice of the port")
        bank = self.tree
        d, s = bank.max_depth, bank.max_slots
        max_b = bank.max_branching
        cw = self.chunk_width                       # min(2K, max_slots)

        def step(state: DecodeState):
            gen, n, m, done = state.gen, state.n, state.m, state.done
            tables = state.tables
            meta = self._bank_tensors(gen.device)
            sel = state.tree_idx.long()
            parent, depth = meta["parent"][sel], meta["depth"][sel]  # [B, S]
            choice, anc = meta["choice"][sel], meta["anc"][sel]
            nslots = meta["nslots"][sel]
            node_depth = depth[:, 1:]                              # [B, N]
            temp = state.temp

            prefilling, pf = _phase(state)
            cl = torch.minimum(torch.full_like(pf, cw), state.pf_len - pf)
            next_keys, dkeys, akeys = ((state.rngs, None, None) if greedy_only
                                       else _sampling_keys(state, prefilling))

            # draft: depth distributions -> per-row template tokens; one
            # top-max_b per depth covers every template's ranks
            lg, dcache = self._pard_depth_logits(gen, n, m, state.dcache,
                                                 tables, (prefilling, pf, cl))
            topk = _topk_indices(lg, max_b)                        # [B,D,MB]
            di = (node_depth - 1).clamp(min=0)
            per_node = topk.gather(1, di[:, :, None].expand(-1, -1, max_b))
            props = per_node.gather(2, choice[:, 1:, None])[..., 0]  # [B, N]
            if not greedy_only:
                # sampled rows: i.i.d. candidates per node (multi-round
                # acceptance needs sibling draws from q, not top-k)
                scaled = acceptance.scale_logits(lg, temp)         # [B,D,V]
                sampled = temp > 0
                props = torch.where(
                    sampled[:, None],
                    acceptance.sample_tree_props_rows(scaled, node_depth,
                                                      dkeys), props)

            # verify: one target forward over the packed tree
            vin = torch.cat([gen.gather(1, (n - 1)[:, None]), props], dim=1)
            positions = (n - 1)[:, None] + depth
            chunk = torch.nn.functional.pad(_chunk_window(gen, pf, cl, cw),
                                            (0, s - cw))
            vin = torch.where(prefilling[:, None], chunk, vin)
            positions = torch.where(prefilling[:, None],
                                    pf[:, None] + _arange(s, gen)[None, :],
                                    positions)
            win_start = torch.where(prefilling, pf, n - 1)
            tinfo = TreeAttnInfo(
                win_start=win_start,
                anc=torch.where(prefilling[:, None], meta["chain_anc"][None],
                                anc),
                win_len=torch.where(prefilling, cl, nslots))
            logits, tcache = self._forward(self.tp, self.tc, vin,
                                           state.tcache, win_start, tables,
                                           positions=positions,
                                           tree_info=tinfo)
            out = greedy_tree_accept_rows(logits, props, parent, depth,
                                          choice, anc, nslots, d)
            if not greedy_only:
                out_s = acceptance.sampled_tree_accept_rows(
                    acceptance.temp_softmax(logits, temp),
                    torch.softmax(scaled, dim=-1), props,
                    meta["child_map"][sel], akeys, d, max_b)
                out = [torch.where(sampled.reshape((-1,) + (1,) * (g.ndim - 1)),
                                   s_, g) for s_, g in zip(out_s, out)]
            a, tok_depth, src_slot, commit_tok, rank = out

            # frozen rows commit nothing: done rows stay done, prefilling
            # rows consumed a prompt chunk instead of a verify window
            frozen = done | prefilling
            dflt = torch.arange(1, d + 1, device=gen.device)[None, :]
            # rejected depths and frozen rows: identity copy (src == dst)
            src_slot = torch.where((src_slot > 0) & ~frozen[:, None],
                                   src_slot, dflt)
            j = _arange(d + 1, gen)[None, :]
            tok_ext = torch.cat([tok_depth, tok_depth[:, -1:]], dim=1)
            vec = torch.where(j < a[:, None], tok_ext,
                              torch.where(j == a[:, None],
                                          commit_tok[:, None], 0))
            vec = torch.where(frozen[:, None], _row_read(gen, n, d + 1), vec)
            # only the winning path's KV survives at committed positions
            compact_tree_caches(self.tc, tcache, (n - 1)[:, None] + src_slot,
                                n, d, tables, self.kv_block_size)
            new_state = dataclasses.replace(
                state, gen=_row_write(gen, vec, n),
                n=n + torch.where(frozen, 0, a + 1),
                m=torch.where(frozen, m, n), tcache=tcache, dcache=dcache,
                rngs=next_keys, pf_pos=torch.where(prefilling, pf + cl, pf))
            return (new_state, torch.where(frozen, 0, a),
                    torch.where(frozen[:, None], -1, rank))
        return step

    def generate_ar(self, *args, **kwargs):
        raise NotImplementedError(
            "uniform-batch generate_* on contiguous caches comes with a later "
            "slice of the port; serve through serving.engine.Engine")

    generate_spec = generate_ar
