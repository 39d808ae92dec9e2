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
import math

import torch

from .decode_attention import _DTYPE_CODE, attend, launch, on_card, ptr
from .flash_attention import c_ints, check_train_inputs


@dataclasses.dataclass(frozen=True)
class PardMaskInfo:
    """Per-token COD metadata of a packed batch: segment, base [B, T] int."""
    segment: torch.Tensor
    base: torch.Tensor


def pard_mask(q_seg, q_base, k_seg, k_base):
    """Boolean [..., Tq, Tk] PARD training mask from the metadata."""
    qs, qb = q_seg[..., :, None], q_base[..., :, None]
    ks, kb = k_seg[..., None, :], k_base[..., None, :]
    real_ctx = (ks == 1) & (kb < qb)
    chain = (ks > 1) & (ks < qs) & (kb == qb)
    self_tok = (ks == qs) & (kb == qb)
    return (qs > 0) & (ks > 0) & (real_ctx | chain | self_tok)


def pard_attention_ref(q, k, v, segment, base, *, scale=None, softcap=0.0):
    """The plain version: the masked f32 softmax of ``attend`` under
    ``pard_mask``. q: [B, T, Hq, D]; k, v: [B, T, Hkv, D]; segment, base:
    [B, T]. Padding rows give 0."""
    return attend(q, k, v, pard_mask(segment, base, segment, base),
                  softcap=softcap, scale=scale)


def _check(q, k, v, segment, base, *more):
    b, t = q.shape[:2]
    if k.shape[1] != t:
        raise ValueError(f"COD attention is self-attention: {k.shape[1]} keys "
                         f"for {t} queries")
    check_train_inputs(q, k, v, ("segment", segment, (b, t), torch.int32),
                       ("base", base, (b, t), torch.int32), *more)


def pard_attention_fwd(q, k, v, segment, base, *, scale=None, softcap=0.0):
    """Launch the forward kernel: (out [B, T, Hq, D], lse [B, Hq, T] f32)."""
    b, t, hq, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    _check(q, k, v, segment, base)
    out = torch.empty_like(q)
    lse = torch.empty(b, hq, t, dtype=torch.float32, device=q.device)
    launch("pard_attention", q, ptr(q), ptr(k), ptr(v), ptr(segment),
           ptr(base), ptr(out), ptr(lse),
           *c_ints(b, t, hq, k.shape[2], d, _DTYPE_CODE[q.dtype]),
           ctypes.c_float(scale), ctypes.c_float(float(softcap)))
    return out, lse


def pard_attention_bwd(q, k, v, segment, base, out, lse, dout, *, scale=None,
                       softcap=0.0):
    """Launch the backward kernel (three passes): (dq, dk, dv)."""
    b, t, hq, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    _check(q, k, v, segment, base, ("out", out, q.shape, q.dtype),
           ("dout", dout, q.shape, q.dtype),
           ("lse", lse, (b, hq, t), torch.float32))
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    launch("pard_attention_bwd", q, ptr(q), ptr(k), ptr(v), ptr(segment),
           ptr(base), ptr(out), ptr(dout), ptr(lse), ptr(delta), ptr(dq),
           ptr(dk), ptr(dv), *c_ints(b, t, hq, k.shape[2], d,
                                    _DTYPE_CODE[q.dtype]),
           ctypes.c_float(scale), ctypes.c_float(float(softcap)))
    return dq, dk, dv


class _PardAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, segment, base, scale, softcap):
        out, lse = pard_attention_fwd(q, k, v, segment, base, scale=scale,
                                      softcap=softcap)
        ctx.save_for_backward(q, k, v, segment, base, out, lse)
        ctx.opts = dict(scale=scale, softcap=softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, segment, base, out, lse = ctx.saved_tensors
        dq, dk, dv = pard_attention_bwd(q, k, v, segment, base, out, lse,
                                        dout.contiguous(), **ctx.opts)
        return dq, dk, dv, None, None, None, None


def pard_attention(q, k, v, segment, base, *, scale=None, softcap=0.0):
    """COD training attention over a packed batch, differentiable.

    q: [B, T, Hq, D]; k, v: [B, T, Hkv, D]; segment, base: [B, T] int32
    (segment 0 = padding). Returns [B, T, Hq, D] in q's dtype.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not on_card(q):
        return pard_attention_ref(q, k, v, segment, base, scale=scale,
                                  softcap=softcap)
    return _PardAttention.apply(q, k, v, segment, base, float(scale),
                                float(softcap))
