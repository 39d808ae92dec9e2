"""Greedy speculative acceptance (port of ``repro.core.acceptance``).

The flat greedy rule and the greedy tree rule (per-row templates) are
ported; the sampled rules (Leviathan acceptance, multi-round tree
acceptance) come with the sampling slice.
"""
from __future__ import annotations

import numpy as np
import torch


def greedy_chain_accept(logits: torch.Tensor, props: torch.Tensor):
    """Greedy flat verification: longest draft prefix matching the target
    argmax. logits [B, K+1, V] at each verify slot, props [B, K].
    Returns (a [B], accepted [B, K], commit_tok [B]). ``argmax`` keeps the
    lowest index on ties, as ``jnp.argmax`` does."""
    k = props.shape[1]
    all_argmax = logits.argmax(dim=-1)                       # [B, K+1]
    accepted = torch.cumprod((props == all_argmax[:, :k]).long(), dim=1)
    a = accepted.sum(dim=1)
    commit = all_argmax.gather(1, a[:, None])[:, 0]          # correction / bonus
    return a, accepted, commit


def tree_child_map(tree) -> np.ndarray:
    """[S, max_b] int32 — window slot of parent s's child at sibling rank c
    (0 where absent; slot 0 is the root and never a child). Host-side,
    static per template."""
    cm = np.zeros((tree.num_slots, max(tree.branching)), np.int32)
    for t in range(1, tree.num_slots):
        cm[tree.parent[t], tree.choice[t]] = t
    return cm


def greedy_tree_accept_rows(logits, props, parent, depth, choice, anc,
                            nslots, d_max: int):
    """Greedy tree verification with a per-row template: a node survives
    iff its token equals the target argmax at its parent slot and its
    parent survives. Sibling tokens are distinct top-k ranks, so at most
    one node per depth survives. Survival is read through the ancestor
    bitmask: slot s survives iff every ancestor-or-self bit is matched.

    logits [B, S, V] at each window slot; props [B, S-1] node tokens;
    parent / depth / choice [B, S] and anc [B, S] (int64 uint32 bits) are
    the row's template metadata (padded slots past ``nslots[b]`` carry
    zeros and are never accepted); d_max is the bank depth.
    Returns (a [B], tok_depth [B, D], src_slot [B, D] — accepted node's
    window slot per depth, 0 where rejected —, commit_tok [B], rank [B, D]
    — accepted sibling rank per depth, -1 where rejected), all int64.
    """
    s = anc.shape[1]
    dev = logits.device
    slot_ids = torch.arange(s, device=dev)
    tgt = logits.argmax(dim=-1)                                    # [B, S]
    # node tokens must match the target argmax at their PARENT slot
    par_tok = tgt.gather(1, parent[:, 1:].long().clamp(min=0))
    nslots = nslots.long()
    node_valid = slot_ids[None, 1:] < nslots[:, None]
    matched = (props.long() == par_tok) & node_valid               # [B, N]
    bits = torch.where(matched, 1 << slot_ids[None, 1:], 0).sum(dim=1) | 1
    path_ok = ((anc.long() & ~bits[:, None]) == 0) \
        & (slot_ids[None] < nslots[:, None])                       # [B, S]
    a = path_ok[:, 1:].sum(dim=1)
    best_slot = torch.where(path_ok, slot_ids[None], 0).amax(dim=1)
    commit_tok = tgt.gather(1, best_slot[:, None])[:, 0]           # correction / bonus

    darange = torch.arange(1, d_max + 1, device=dev)
    pick = path_ok[:, 1:, None] & (depth[:, 1:, None].long()
                                   == darange[None, None])         # [B, N, D]
    tok_depth = (pick * props.long()[:, :, None]).sum(dim=1)       # [B, D]
    src_slot = (pick * slot_ids[None, 1:, None]).sum(dim=1)        # [B, D]
    rank = torch.where(src_slot > 0, choice.long().gather(1, src_slot), -1)
    return a, tok_depth, src_slot, commit_tok, rank


def greedy_tree_accept(tree, logits, props):
    """Single-template convenience wrapper around the per-row rule (every
    row shares ``tree``)."""
    b = props.shape[0]

    def rows(arr):
        t = torch.as_tensor(np.asarray(arr, np.int64), device=logits.device)
        return t[None].expand((b,) + t.shape)

    nslots = torch.full((b,), tree.num_slots, device=logits.device)
    return greedy_tree_accept_rows(logits, props, rows(tree.parent),
                                   rows(tree.depth), rows(tree.choice),
                                   rows(tree.anc), nslots, tree.max_depth)
