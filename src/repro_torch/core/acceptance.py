"""Token acceptance for speculative decoding (port of
``repro.core.acceptance``): one module for every verifier, in four rules
that pair up as (greedy, sampled) x (chain, tree):

  * ``greedy_chain_accept``: the longest prefix matching the target argmax;
  * ``leviathan_accept``: Leviathan speculative sampling, accept draft
    token x with min(1, p(x)/q(x)) and on the first reject commit a token
    from the clipped residual norm(max(p - q, 0));
  * ``greedy_tree_accept_rows``: the longest root path whose node tokens
    match the target argmax at their parent slot;
  * ``sampled_tree_accept_rows``: multi-round recursive rejection sampling
    over sibling candidates, the residual renormalised after every
    rejected sibling; every committed token is distributed exactly as the
    target's own sampling distribution.

Sampling state is per row: the sampled rules take ``keys [B, 2]`` (one
threefry key per row, ``core.prng``), so a request's draws depend only on
its own key and step count, never on batch composition or KV layout. The
keys draw the JAX package's own bits: given the same probabilities, the
two packages commit the same tokens.
"""
from __future__ import annotations

import numpy as np
import torch

from . import prng

_EPS = 1e-9
_LOG_EPS = 1e-30


# ---------------------------------------------------------------------------
# Per-row PRNG plumbing
# ---------------------------------------------------------------------------

def make_row_keys(seed: int, ids, device=None) -> torch.Tensor:
    """[B, 2] int64: one independent key per row, derived from a shared
    seed and a per-row id (the batch index, or the request id)."""
    ids = torch.as_tensor(np.asarray(ids, np.int64), device=device)
    return prng.fold_in(prng.key(seed, device), ids)


def split_row_keys(keys: torch.Tensor):
    """keys [B, 2] -> (next_keys, use_keys): each row's key advances one
    step; ``use_keys`` seeds this step's draws, ``next_keys`` is stored."""
    both = prng.split(keys, 2)                               # [B, 2, 2]
    return both[:, 0], both[:, 1]


def fold_row_keys(keys: torch.Tensor, tag) -> torch.Tensor:
    """Derive an independent per-row stream ``tag`` from ``keys``."""
    return prng.fold_in(keys, tag)


def row_uniform(keys: torch.Tensor) -> torch.Tensor:
    """One U(0, 1) draw per row: keys [B, 2] -> [B] f32."""
    return prng.uniform(keys)


def row_categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """keys [B, 2], logits [B, V] -> [B] int64 (independent per row)."""
    return prng.categorical(keys, logits)


def _row_take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, T, ...], idx [B] -> [B, ...]."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def scale_logits(logits: torch.Tensor, temp: torch.Tensor) -> torch.Tensor:
    """logits / temp in f32 with a per-row temperature; rows with temp == 0
    divide by 1 instead (the greedy rules decide those rows, but no NaN may
    be produced)."""
    t = torch.where(temp > 0, temp, 1.0).float()
    t = t.reshape(t.shape + (1,) * (logits.ndim - 1))
    return logits.float() / t


def temp_softmax(logits: torch.Tensor, temp: torch.Tensor) -> torch.Tensor:
    """softmax(logits / temp) with a per-row temperature."""
    return torch.softmax(scale_logits(logits, temp), dim=-1)


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


def leviathan_accept(p_full, qprob, props, keys):
    """Leviathan speculative sampling (the flat T > 0 acceptance rule).

    p_full [B, K+1, V] target probabilities at each verify position, qprob
    [B, K, V] draft proposal distributions, props [B, K] proposed tokens,
    keys [B, 2] this step's per-row keys. Returns (a [B], accepted [B, K],
    commit_tok [B]); the correction token comes from the clipped residual
    at the first reject, and when a == K the padded q row is 0, so the
    residual is the target distribution (the bonus draw)."""
    b, k = props.shape
    k_acc = fold_row_keys(keys, 0)
    k_res = fold_row_keys(keys, 1)
    props = props.long()
    p_at = p_full[:, :k].gather(-1, props[..., None])[..., 0]
    q_at = qprob.gather(-1, props[..., None])[..., 0]
    u = prng.uniform(k_acc, (k,))                              # [B, K]
    accepted = torch.cumprod((u * q_at < p_at).long(), dim=1)
    a = accepted.sum(dim=1)
    q_ext = torch.cat([qprob, torch.zeros_like(qprob[:, :1])], dim=1)
    resid = (_row_take(p_full, a) - _row_take(q_ext, a)).clamp(min=0.0)
    resid = resid / resid.sum(dim=-1, keepdim=True).clamp(min=_EPS)
    commit_tok = row_categorical(k_res, torch.log(resid + _LOG_EPS))
    return a, accepted, commit_tok


def speculative_accept(p_full, qprob, props, rng):
    """Single-key wrapper around ``leviathan_accept``: row b draws from
    ``split(rng, B)[b]``."""
    return leviathan_accept(p_full, qprob, props,
                            prng.split(rng, props.shape[0]))


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
    # sampled siblings may repeat a token, so on rows that a mixed batch
    # verifies by sampling (and discards here) two nodes of a depth can
    # pass and their slots sum past the window: clamp the index, as JAX's
    # gather does, instead of reading out of bounds
    rank = torch.where(src_slot > 0,
                       choice.long().gather(1, src_slot.clamp(max=s - 1)), -1)
    return a, tok_depth, src_slot, commit_tok, rank


def _template_rows(arr, b: int, device) -> torch.Tensor:
    """Template metadata [S, ...] -> per-row int64 [B, S, ...]."""
    t = torch.as_tensor(np.asarray(arr, np.int64), device=device)
    return t[None].expand((b,) + t.shape)


def greedy_tree_accept(tree, logits, props):
    """Single-template convenience wrapper around the per-row rule (every
    row shares ``tree``)."""
    b, dev = props.shape[0], logits.device
    nslots = torch.full((b,), tree.num_slots, device=dev)
    return greedy_tree_accept_rows(
        logits, props, _template_rows(tree.parent, b, dev),
        _template_rows(tree.depth, b, dev), _template_rows(tree.choice, b, dev),
        _template_rows(tree.anc, b, dev), nslots, tree.max_depth)


def sampled_tree_accept_rows(p_full, q_depth, props, child_map, keys,
                             d_max: int, max_b: int):
    """Multi-round recursive rejection sampling with a per-row template.

    At each depth the surviving node's children are tried in sibling
    order; round c accepts child token x with probability min(1,
    r(x)/q_d(x)), where r is the target distribution at the surviving node,
    renormalised after every rejected sibling to norm(max(r - q_d, 0)).
    Children must be i.i.d. samples of q_d, the draft's depth-d proposal
    distribution. A row offered fewer than ``max_b`` siblings at a depth
    skips the extra rounds (no accept, no residual update); a row whose
    surviving node has no children commits a token from the unmodified
    target distribution, which is the bonus draw.

    p_full [B, S, V] target probabilities per window slot (scaled); q_depth
    [B, D, V] draft proposal distribution per depth (scaled); props [B,
    S-1] node tokens; child_map [B, S, max_b] window slot of a slot's child
    at rank c (0 = absent); keys [B, 2] this step's per-row keys.

    Draw c of the sequence ``ctr`` = 0, 1, ... takes ``fold_in(keys, c)``:
    at each depth the max_b rounds' uniforms, then the correction, and the
    bonus last, as in the JAX package. The draws depend on nothing the
    rounds compute, so every uniform and the Gumbel noise of every
    correction and of the bonus are drawn up front in two vectorised
    calls; the rounds then run on those draws. Returns (a, tok_depth,
    src_slot, commit_tok, rank) shaped as ``greedy_tree_accept_rows``'s.
    """
    b = props.shape[0]
    dev = props.device
    rows = torch.arange(b, device=dev)
    props = props.long()
    # the ctr sequence: depth d's rounds take (d-1)(max_b+1) + c, its
    # correction (d-1)(max_b+1) + max_b, the bonus d_max (max_b+1)
    n_ctr = d_max * (max_b + 1) + 1
    ctr_keys = fold_row_keys(keys[:, None, :],
                             torch.arange(n_ctr, device=dev)[None])  # [B,n,2]
    u_all = prng.uniform(ctr_keys)                                   # [B, n]
    draw_keys = torch.cat([ctr_keys[:, max_b::max_b + 1], ctr_keys[:, -1:]],
                          dim=1)                          # corrections, bonus
    noise = prng.gumbel(draw_keys, (p_full.shape[-1],))             # [B,D+1,V]

    cur = torch.zeros(b, dtype=torch.long, device=dev)   # surviving slot
    alive = torch.ones(b, dtype=torch.bool, device=dev)
    a = torch.zeros(b, dtype=torch.long, device=dev)
    commit = torch.zeros(b, dtype=torch.long, device=dev)
    toks, slots, ranks = [], [], []
    ctr = 0
    for d in range(1, d_max + 1):
        q_d = q_depth[:, d - 1]                                    # [B, V]
        r = p_full[rows, cur]                                      # [B, V]
        cm_cur = child_map[rows, cur].long()                       # [B, mb]
        found = torch.zeros(b, dtype=torch.bool, device=dev)
        sel_slot = torch.zeros_like(a)
        sel_tok = torch.zeros_like(a)
        sel_rank = torch.full_like(a, -1)
        for c in range(max_b):
            slot_c = cm_cur[:, c]
            has = slot_c > 0            # the row offers a rank-c sibling
            x = props[rows, (slot_c - 1).clamp(min=0)]
            qx = q_d[rows, x]
            rx = r[rows, x]
            u = u_all[:, ctr]
            ctr += 1
            acc = (u * qx < rx) & alive & ~found & has
            sel_slot = torch.where(acc, slot_c, sel_slot)
            sel_tok = torch.where(acc, x, sel_tok)
            sel_rank = torch.where(acc, c, sel_rank)
            found = found | acc
            # renormalised clipped residual for the next round (rows that
            # accepted, or were not offered this round, stop updating)
            nr = (r - q_d).clamp(min=0.0)
            nr = nr / nr.sum(dim=-1, keepdim=True).clamp(min=_EPS)
            r = torch.where((found | ~has)[:, None], r, nr)
        # every sibling rejected: the correction comes from the final
        # residual, and the row stops here
        corr = (noise[:, d - 1] + torch.log(r + _LOG_EPS)).argmax(dim=-1)
        ctr += 1
        die = alive & ~found
        commit = torch.where(die, corr, commit)
        a = a + (alive & found).long()
        cur = torch.where(found, sel_slot, cur)
        toks.append(torch.where(alive & found, sel_tok, 0))
        slots.append(torch.where(alive & found, sel_slot, 0))
        ranks.append(torch.where(alive, sel_rank, -1))
        alive = alive & found
    # a fully accepted path: the bonus token from the target distribution
    # at the deepest accepted node
    bonus = (noise[:, d_max] + torch.log(p_full[rows, cur] + _LOG_EPS)
             ).argmax(dim=-1)
    commit = torch.where(alive, bonus, commit)
    return (a, torch.stack(toks, dim=1), torch.stack(slots, dim=1), commit,
            torch.stack(ranks, dim=1))


def sampled_tree_accept(tree, p_full, q_depth, props, keys):
    """Single-template wrapper around ``sampled_tree_accept_rows``."""
    cm = _template_rows(tree_child_map(tree), props.shape[0], props.device)
    return sampled_tree_accept_rows(p_full, q_depth, props, cm, keys,
                                    tree.max_depth, max(tree.branching))


def sample_tree_props_rows(scaled_logits, node_depth, keys):
    """i.i.d. draft candidates for ``sampled_tree_accept_rows``: node i
    draws from softmax(scaled_logits[:, node_depth[b, i] - 1]) under the
    key ``fold_in(keys[b], i)``. scaled_logits [B, D, V] (already divided
    by the temperature); node_depth [B, N] (padded slots carry 0 and draw
    an unused depth-1 sample); keys [B, 2]. All N nodes draw in one
    vectorised call over [B, N, V], the bits of N separate draws. Returns
    props [B, N]."""
    n = node_depth.shape[1]
    v = scaled_logits.shape[-1]
    di = (node_depth.long() - 1).clamp(min=0)
    lg = scaled_logits.gather(1, di[:, :, None].expand(-1, -1, v))  # [B,N,V]
    node_keys = fold_row_keys(keys[:, None, :],
                              torch.arange(n, device=keys.device)[None])
    return prng.categorical(node_keys, lg)


def sample_tree_props(tree, scaled_logits, keys):
    """Single-template wrapper around ``sample_tree_props_rows``."""
    depth = _template_rows(tree.depth[1:], scaled_logits.shape[0],
                           scaled_logits.device)
    return sample_tree_props_rows(scaled_logits, depth, keys)
