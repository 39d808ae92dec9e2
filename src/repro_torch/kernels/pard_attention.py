"""PARD-COD training attention with its gradient: the CUDA kernels' wrapper
and the plain PyTorch version.

Port of the Pallas TPU kernel ``repro.kernels.pard_attention`` (wrapper
``ops.pard_attention``), its oracle ``ref.pard_attention_ref`` and the
model's ``pard_mask``. Every attention of the PARD adaptation loss comes
here: a packed COD batch (``core.cod.pack_batch``) whose attention pattern
is a function of two int32 fields per token, ``segment`` and ``base``:
query (s_q, b_q) sees key (s_k, b_k) iff both segments are > 0 and

    s_k == 1 and b_k < b_q            real context
    1 < s_k < s_q and b_k == b_q      earlier masks of the same chain
    s_k == s_q and b_k == b_q         self

Segment 0 is padding: it sees nothing (output 0) and nobody sees it.

``pard_attention`` is a ``torch.autograd.Function`` on CUDA tensors whose
forward launches ``csrc/pard_attention.cu`` and whose backward launches
``csrc/pard_attention_bwd.cu``. The kernels read kv head h // G for query
head h instead of repeating K/V as the TPU wrapper does (the same function;
dK/dV sum over the G query heads). CPU tensors take the plain version.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from .decode_attention import _DTYPE_CODE, attend, launch, on_card, ptr
from .flash_attention import (EMPTY, FULL, PARTIAL, TILE, c_ints,
                              check_train_inputs)


@dataclasses.dataclass(frozen=True)
class PardMaskInfo:
    """Per-token COD metadata of a packed batch: segment, base [B, T] int32.
    ``tiles`` is the bfloat16 kernels' class table of the two
    (``pard_tile_classes``), made at its first read and shared by every
    layer that attends under this object."""
    segment: torch.Tensor
    base: torch.Tensor

    @functools.cached_property
    def tiles(self) -> torch.Tensor:
        return pard_tile_classes(self.segment, self.base)


def pard_mask(q_seg, q_base, k_seg, k_base):
    """Boolean [..., Tq, Tk] PARD training mask from the metadata."""
    qs, qb = q_seg[..., :, None], q_base[..., :, None]
    ks, kb = k_seg[..., None, :], k_base[..., None, :]
    real_ctx = (ks == 1) & (kb < qb)
    chain = (ks > 1) & (ks < qs) & (kb == qb)
    self_tok = (ks == qs) & (kb == qb)
    return (qs > 0) & (ks > 0) & (real_ctx | chain | self_tok)


def pard_tile_classes(segment, base):
    """uint8 [B, nt, nt] class of each (64-query tile, 64-key tile) pair of
    a packed batch (nt = ceil(T / 64)), from summaries of the live tokens
    (segment > 0) of each tile. The kernels read it. The rule is
    conservative against ``pard_mask``: EMPTY implies no allowed pair,
    FULL implies every pair allowed (so a tile holding padding or a token
    past T is never FULL), anything else is PARTIAL.

    A tile's live tokens fall in three parts: those of its least segment,
    those of its greatest, and the rest. Each part keeps its segment min /
    max, its least segment above 1 and its base min / max; a pair of tiles
    may hold an allowed pair only if some pair of their parts may. (In the
    segment-major packing a tile that straddles a segment boundary spans
    all bases; summarised whole, it would meet every tile of both
    segments.)"""
    b, t = segment.shape
    nt = -(-t // TILE)
    pad = (0, nt * TILE - t)
    seg = torch.nn.functional.pad(segment, pad).view(b, nt, TILE)
    bas = torch.nn.functional.pad(base, pad).view(b, nt, TILE)
    live = seg > 0
    big = torch.iinfo(torch.int32).max

    def lo(sel, x):
        return torch.where(sel, x, big).amin(-1)

    def hi(sel, x):
        return torch.where(sel, x, -big).amax(-1)

    # FULL from whole-tile summaries: every key of segment 1 and below
    # every query's base
    all_live = live.all(-1)
    full = (all_live[:, :, None] & all_live[:, None, :]
            & (hi(live, seg)[:, None, :] == 1)
            & (hi(live, bas)[:, None, :] < lo(live, bas)[:, :, None]))

    s_first, s_last = lo(live, seg)[..., None], hi(live, seg)[..., None]
    parts = torch.stack([live & (seg == s_first), live & (seg == s_last),
                         live & (seg > s_first) & (seg < s_last)], 2)
    seg, bas = seg[:, :, None], bas[:, :, None]          # [B, nt, 1, TILE]
    s_lo, s_hi = lo(parts, seg), hi(parts, seg)           # [B, nt, 3]
    s_lo2 = lo(parts & (seg > 1), seg)
    b_lo, b_hi = lo(parts, bas), hi(parts, bas)

    def q(x):
        return x[:, :, None, :, None]

    def k(x):
        return x[:, None, :, None, :]

    overlap = (k(b_lo) <= q(b_hi)) & (q(b_lo) <= k(b_hi))
    # some key of segment 1 below some query's base (real context); a key
    # of a segment in [2, s_q) at a shared base (chain); a shared segment
    # at a shared base (self). Parts without a live token have lo > hi.
    real_ctx = (k(s_lo) == 1) & (k(b_lo) < q(b_hi))
    chain = (k(s_lo2) < q(s_hi)) & overlap
    self_tok = (k(s_lo) <= q(s_hi)) & (q(s_lo) <= k(s_hi)) & overlap
    possible = (real_ctx | chain | self_tok).flatten(3).any(-1)
    return torch.where(full, FULL, torch.where(possible, PARTIAL, EMPTY)).to(
        torch.uint8)


def pard_attention_ref(q, k, v, segment, base, *, scale=None, softcap=0.0):
    """The plain version: the masked f32 softmax of ``attend`` under
    ``pard_mask``. q: [B, T, Hq, D]; k, v: [B, T, Hkv, D]; segment, base:
    [B, T]. Padding rows give 0."""
    return attend(q, k, v, pard_mask(segment, base, segment, base),
                  softcap=softcap, scale=scale)


def _check(q, k, v, info, *more):
    b, t = q.shape[:2]
    if k.shape[1] != t:
        raise ValueError(f"COD attention is self-attention: {k.shape[1]} keys "
                         f"for {t} queries")
    check_train_inputs(q, k, v, ("segment", info.segment, (b, t), torch.int32),
                       ("base", info.base, (b, t), torch.int32), *more)


def _tiles(q, info):
    """The class table's pointer: the bfloat16 kernels read it; the float32
    ones (a mask scan per tile) take a null pointer."""
    return ptr(info.tiles) if q.dtype == torch.bfloat16 else ctypes.c_void_p()


def pard_attention_fwd(q, k, v, info, *, scale=None, softcap=0.0):
    """Launch the forward kernel: (out [B, T, Hq, D], lse [B, Hq, T] f32).
    ``info``: the batch's ``PardMaskInfo``."""
    b, t, hq, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    _check(q, k, v, info)
    out = torch.empty_like(q)
    lse = torch.empty(b, hq, t, dtype=torch.float32, device=q.device)
    launch("pard_attention", q, ptr(q), ptr(k), ptr(v), ptr(info.segment),
           ptr(info.base), _tiles(q, info), ptr(out), ptr(lse),
           *c_ints(b, t, hq, k.shape[2], d, _DTYPE_CODE[q.dtype]),
           ctypes.c_float(scale), ctypes.c_float(float(softcap)))
    return out, lse


def pard_attention_bwd(q, k, v, info, out, lse, dout, *, scale=None,
                       softcap=0.0):
    """Launch the backward kernel (three passes): (dq, dk, dv)."""
    b, t, hq, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    _check(q, k, v, info, ("out", out, q.shape, q.dtype),
           ("dout", dout, q.shape, q.dtype),
           ("lse", lse, (b, hq, t), torch.float32))
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    launch("pard_attention_bwd", q, ptr(q), ptr(k), ptr(v), ptr(info.segment),
           ptr(info.base), _tiles(q, info), ptr(out), ptr(dout), ptr(lse),
           ptr(delta), ptr(dq), ptr(dk), ptr(dv),
           *c_ints(b, t, hq, k.shape[2], d, _DTYPE_CODE[q.dtype]),
           ctypes.c_float(scale), ctypes.c_float(float(softcap)))
    return dq, dk, dv


class _PardAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, info, scale, softcap):
        out, lse = pard_attention_fwd(q, k, v, info, scale=scale,
                                      softcap=softcap)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.info = info
        ctx.opts = dict(scale=scale, softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = pard_attention_bwd(q, k, v, ctx.info, out, lse,
                                        dout.contiguous(), **ctx.opts)
        return dq, dk, dv, None, None, None


def pard_attention(q, k, v, info, *, scale=None, softcap=0.0):
    """COD training attention over a packed batch, differentiable.

    q: [B, T, Hq, D]; k, v: [B, T, Hkv, D]; ``info``: the batch's
    ``PardMaskInfo`` (segment, base [B, T] int32, segment 0 = padding).
    Returns [B, T, Hq, D] in q's dtype.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not on_card(q):
        return pard_attention_ref(q, k, v, info.segment, info.base,
                                  scale=scale, softcap=softcap)
    return _PardAttention.apply(q, k, v, info, float(scale), float(softcap))
