"""Full-sequence causal GQA attention with its gradient: the CUDA kernels'
wrapper and the plain PyTorch version.

Port of the Pallas TPU kernel ``repro.kernels.flash_attention`` (wrapper
``ops.flash_attention``) and its oracle ``ref.flash_attention_ref``. The
cache-free forward sends every attention of the AR training loss here.
Query i and key j count from 0; key j is visible iff j <= i (when causal)
and j > i - window (when window > 0); the optional softcap c * tanh(s / c)
applies to the scaled scores. A query that sees no key returns 0.

``flash_attention`` is a ``torch.autograd.Function`` on CUDA tensors: its
forward launches ``csrc/flash_attention.cu`` and keeps the per-row
log-sum-exp, its backward launches ``csrc/flash_attention_bwd.cu`` (the TPU
kernel has no backward; the JAX package differentiates its jnp path). CPU
tensors take the plain version, which autograd differentiates.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .decode_attention import _DTYPE_CODE, _HEAD_DIMS, attend, launch, on_card, ptr

# Tiles of the bfloat16 kernels: 64 queries x 64 keys, each in one class
# (csrc/train_attention_tile.cuh, tattn::kEmpty / kPartial / kFull)
TILE = 64
EMPTY, PARTIAL, FULL = 0, 1, 2


def flash_allowed(t: int, s: int, *, causal=True, window=0, device=None):
    """Boolean [T, S] visibility of key j to query i."""
    qp = torch.arange(t, device=device)[:, None]
    kp = torch.arange(s, device=device)[None, :]
    allowed = torch.ones(t, s, dtype=torch.bool, device=device)
    if causal:
        allowed &= kp <= qp
    if window:
        allowed &= kp > qp - window
    return allowed


def flash_tile_classes(t: int, s: int, *, causal=True, window=0, device=None):
    """uint8 [nq, nk] class of each (64-query tile, 64-key tile) pair, from
    the indices alone, as the kernels' ``CausalMask::tile_class`` computes
    it: EMPTY (no pair allowed), FULL (every pair allowed: no row past
    ``t``, no key past ``s``) or PARTIAL."""
    q0 = torch.arange(0, t, TILE, device=device)[:, None]
    k0 = torch.arange(0, s, TILE, device=device)[None, :]
    q1, k1 = (q0 + TILE).clamp(max=t), (k0 + TILE).clamp(max=s)
    empty = torch.zeros(q0.shape[0], k0.shape[1], dtype=torch.bool,
                        device=device)
    full = (q0 + TILE <= t) & (k0 + TILE <= s)
    if causal:
        empty |= k0 > q1 - 1
        full &= k0 + TILE - 1 <= q0
    if window > 0:
        empty |= k1 - 1 <= q0 - window
        full &= k0 > q0 + TILE - 1 - window
    return torch.where(empty, EMPTY, torch.where(full, FULL, PARTIAL)).to(
        torch.uint8)


def flash_attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0,
                        scale=None):
    """The plain version: the masked f32 softmax of ``attend``.

    q: [B, T, Hq, D]; k, v: [B, S, Hkv, D]. Returns [B, T, Hq, D] in q's
    dtype; rows that see no key give 0.
    """
    b, t = q.shape[:2]
    allowed = flash_allowed(t, k.shape[1], causal=causal, window=window,
                            device=q.device)
    return attend(q, k, v, allowed[None].expand(b, -1, -1), softcap=softcap,
                  scale=scale)


def check_train_inputs(q, k, v, *more):
    """Raise on what the training kernels do not take: q [B, T, Hq, D] and
    k, v [B, S, Hkv, D] of one dtype (float32 / bfloat16), D in (32, 48,
    64, 128), contiguous, 16-byte aligned, on one device; ``more``: further
    (name, tensor, shape, dtype) operands."""
    b, t, hq, d = q.shape
    if k.dim() != 4 or v.shape != k.shape or k.shape[0] != b \
            or k.shape[-1] != d:
        raise ValueError(f"K/V shapes {tuple(k.shape)} / {tuple(v.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    if hq % k.shape[2]:
        raise ValueError(f"{hq} query heads do not group over {k.shape[2]} "
                         f"kv heads")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not built (kernels take {_HEAD_DIMS})")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"dtypes q={q.dtype} k={k.dtype} v={v.dtype}: the "
                        f"training kernels take one of float32/bfloat16")
    named = [("q", q, None, None), ("k", k, None, None),
             ("v", v, None, None)] + list(more)
    for name, x, shape, dtype in named:
        if shape is not None and tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                             f"{tuple(shape)}")
        if dtype is not None and x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")


def c_ints(*xs):
    return tuple(ctypes.c_int(int(x)) for x in xs)


def flash_attention_fwd(q, k, v, *, causal=True, window=0, softcap=0.0,
                        scale=None):
    """Launch the forward kernel: (out [B, T, Hq, D], lse [B, Hq, T] f32)."""
    b, t, hq, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    check_train_inputs(q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty(b, hq, t, dtype=torch.float32, device=q.device)
    launch("flash_attention", q, ptr(q), ptr(k), ptr(v), ptr(out), ptr(lse),
           *c_ints(b, t, k.shape[1], hq, k.shape[2], d, _DTYPE_CODE[q.dtype]),
           ctypes.c_float(scale), *c_ints(bool(causal), window),
           ctypes.c_float(float(softcap)))
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal=True, window=0,
                        softcap=0.0, scale=None):
    """Launch the backward kernel (three passes): (dq, dk, dv) in the
    inputs' dtype."""
    b, t, hq, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    check_train_inputs(q, k, v, ("out", out, q.shape, q.dtype),
                       ("dout", dout, q.shape, q.dtype),
                       ("lse", lse, (b, hq, t), torch.float32))
    delta = torch.empty_like(lse)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    launch("flash_attention_bwd", q, ptr(q), ptr(k), ptr(v), ptr(out),
           ptr(dout), ptr(lse), ptr(delta), ptr(dq), ptr(dk), ptr(dv),
           *c_ints(b, t, k.shape[1], hq, k.shape[2], d, _DTYPE_CODE[q.dtype]),
           ctypes.c_float(scale), *c_ints(bool(causal), window),
           ctypes.c_float(float(softcap)))
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, scale):
        out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                       softcap=softcap, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    scale=None):
    """Causal GQA attention over a full sequence, differentiable.

    q: [B, T, Hq, D]; k, v: [B, S, Hkv, D]. Returns [B, T, Hq, D] in q's
    dtype. Unlike the TPU wrapper, T and S are not padded.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if not on_card(q):
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, scale=scale)
    return _FlashAttention.apply(q, k, v, causal, int(window), float(softcap),
                                 float(scale))
