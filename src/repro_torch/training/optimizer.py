"""AdamW with global-norm clipping, and the cosine schedule.

Port of ``repro.training.optimizer``: the same arithmetic (clip by the
global norm, f32 moments, bias correction, decoupled weight decay), in
plain tensor code (``torch._foreach_*``). Unlike the functional JAX
version, ``update`` writes the params and the moments in place, so a step
of a 1B-parameter model keeps one copy of each; it returns them all the
same, so a caller reads it as the JAX code is read. It updates the leaves
in pieces of at most ``PIECE`` elements, so its float32 temporaries (the
clipped gradient, the denominator, the update) stay under 1 GiB whatever
the model's size: a 3.3B-parameter model with its moments and gradients
(53 GB in float32) then fits one 80 GB card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Tuple, Union

import numpy as np
import torch

PIECE = 1 << 26                      # elements updated together (256 MiB)


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a params tree (nested dicts and lists), in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zeros_like(v) for v in tree]
    return torch.zeros_like(tree, dtype=torch.float32)


class AdamWState(NamedTuple):
    step: int
    mu: Any
    nu: Any


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Union[Callable[[int], float], float] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: float = 1.0

    def init(self, params) -> AdamWState:
        return AdamWState(0, _zeros_like(params), _zeros_like(params))

    def _lr(self, step: int) -> float:
        return float(self.lr(step)) if callable(self.lr) else float(self.lr)

    @torch.no_grad()
    def update(self, grads, state: AdamWState, params
               ) -> Tuple[Any, AdamWState, dict]:
        """One step: params and state updated in place and returned, with
        metrics ``grad_norm`` (before clipping, a 0-d f32 tensor) and
        ``lr``."""
        ps, gs = leaves(params), leaves(grads)
        mus, nus = leaves(state.mu), leaves(state.nu)
        if not (len(ps) == len(gs) == len(mus) == len(nus)):
            raise ValueError("params, grads and optimizer state differ in "
                             "structure")
        gnorm = torch.linalg.vector_norm(torch.stack(
            [torch.linalg.vector_norm(g.float()) for g in gs]))
        clip = torch.where(gnorm > self.clip_norm,
                           self.clip_norm / (gnorm + 1e-9), 1.0)

        step = state.step + 1
        # bias corrections in float32, as the JAX code computes them
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.float32(step))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.float32(step))
        lr = self._lr(step)
        # views of the params and the moments (contiguous leaves), so the
        # in-place writes land in the leaves
        pieces = [[x for t in ts for x in (t.reshape(-1) if ts is gs
                                           else t.view(-1)).split(PIECE)]
                  for ts in (ps, gs, mus, nus)]
        start = 0
        while start < len(pieces[0]):
            end, size = start, 0
            while end < len(pieces[0]) and (
                    end == start or size + pieces[0][end].numel() <= PIECE):
                size += pieces[0][end].numel()
                end += 1
            self._update_pieces(*(p[start:end] for p in pieces), clip, bc1,
                                bc2, lr)
            start = end
        return params, AdamWState(step, state.mu, state.nu), {
            "grad_norm": gnorm, "lr": lr}

    def _update_pieces(self, ps, gs, mus, nus, clip, bc1, bc2, lr):
        """The AdamW arithmetic on flat pieces of the leaves (views of the
        params and the moments, written in place)."""
        gs = torch._foreach_mul([g.float() for g in gs], clip)
        torch._foreach_mul_(mus, self.b1)
        torch._foreach_add_(mus, gs, alpha=1 - self.b1)
        torch._foreach_mul_(nus, self.b2)
        torch._foreach_addcmul_(nus, gs, gs, value=1 - self.b2)

        denom = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mus, bc1)
        torch._foreach_div_(upd, denom)
        p32 = [p.float() for p in ps]
        if self.weight_decay:
            torch._foreach_add_(upd, p32, alpha=self.weight_decay)
        torch._foreach_add_(p32, upd, alpha=-lr)
        for p, new in zip(ps, p32):
            if new is not p:
                p.copy_(new)


def cosine_schedule(peak: float, warmup: int, total: int,
                    floor_frac: float = 0.1) -> Callable[[int], float]:
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine decay
    to ``floor_frac * peak`` at ``total``."""
    def f(step) -> float:
        step = float(step)
        if step < warmup:
            return peak * step / max(warmup, 1)
        prog = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        return peak * (floor_frac + (1 - floor_frac) * 0.5
                       * (1 + math.cos(math.pi * prog)))
    return f
