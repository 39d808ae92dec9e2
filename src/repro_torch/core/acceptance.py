"""Greedy speculative acceptance (port of ``repro.core.acceptance``).

Only the flat greedy rule is ported; the sampled rules (Leviathan
acceptance, tree acceptance) come with the sampling slice.
"""
from __future__ import annotations

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
