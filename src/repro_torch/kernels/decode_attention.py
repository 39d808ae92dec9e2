"""Paged decode / verify attention: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``repro.kernels.decode_attention.decode_attention_paged`` (the
Pallas TPU kernel) and its oracle ``ref.decode_attention_paged_ref``. A
small query window attends to a block-paged KV pool through per-row block
tables. Every attention of the serving engine's step goes through here:
the PARD draft window (Tq = 2K), the verify window (Tq = K+1) and prompt
chunks.

``decode_attention_paged`` launches ``csrc/decode_attention_paged.cu`` for
CUDA tensors and takes the plain version only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import build, launches

NEG_INF = -1e30

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def gather_pages(pages: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Per-row contiguous view of a paged pool.

    pages: [NB, bs, ...]; block_tables: [B, MBS] -> [B, MBS * bs, ...].
    """
    g = pages[block_tables.long()]                       # [B, MBS, bs, ...]
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + g.shape[3:])


def attend(q, k, v, q_pos, kv_len, *, window=0, softcap=0.0, scale=None):
    """Masked GQA attention core in f32 (the plain arithmetic).

    q: [B, Tq, Hq, D]; k, v: [B, S, Hkv, D] where key index = position;
    q_pos: [B, Tq]; kv_len: [B]. Key p is visible to query i iff
    p < kv_len, p <= q_pos[i] and, with a window, p > q_pos[i] - window.
    A query that sees no key returns 0, as the kernel does.
    """
    b, tq, hq, d = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, tq, hkv, g, d).float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    kp = torch.arange(s, device=q.device)[None, None, :]            # [1,1,S]
    qp = q_pos.long()[:, :, None]                                    # [B,Tq,1]
    allowed = (kp < kv_len.long()[:, None, None]) & (kp <= qp)
    if window:
        allowed &= kp > qp - window
    allowed = allowed[:, None, None]                                 # [B,1,1,Tq,S]
    logits = torch.where(allowed, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(allowed, torch.exp(logits - m), 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    probs = p / torch.where(denom == 0, 1.0, denom)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, tq, hq, d).to(q.dtype)


def decode_attention_paged_ref(q, k_pages, v_pages, block_tables, kv_len,
                               q_pos, *, window=0, softcap=0.0, scale=None):
    """The plain version: gather each row's pages into a contiguous view,
    then the masked f32 softmax of ``attend``."""
    k = gather_pages(k_pages, block_tables)
    v = gather_pages(v_pages, block_tables)
    return attend(q, k, v, q_pos, kv_len, window=window, softcap=softcap,
                  scale=scale)


def _check(q, k_pages, v_pages, block_tables, kv_len, q_pos):
    b, tq, hq, d = q.shape
    nb, bs, hkv, dk = k_pages.shape
    if v_pages.shape != k_pages.shape or dk != d:
        raise ValueError(f"pool shapes {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not fit q {tuple(q.shape)}")
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not built (kernel takes {_HEAD_DIMS})")
    if q.dtype not in _DTYPE_CODE or k_pages.dtype not in _DTYPE_CODE \
            or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"dtypes q={q.dtype} k={k_pages.dtype} "
                        f"v={v_pages.dtype}: kernel takes float32/bfloat16")
    if block_tables.shape[0] != b or kv_len.shape != (b,) \
            or q_pos.shape != (b, tq):
        raise ValueError("block_tables [B, MBS], kv_len [B] and q_pos "
                         "[B, Tq] must match q's batch and window")
    for name, t in (("block_tables", block_tables), ("kv_len", kv_len),
                    ("q_pos", q_pos)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("kv_len", kv_len),
                    ("q_pos", q_pos)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages)):
        if t.data_ptr() % 16:                 # 16-byte vector loads
            raise ValueError(f"{name} must be 16-byte aligned")


def _lib():
    lib = build.load("decode_attention_paged")
    fn = lib.decode_attention_paged
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp] * 7 + [ci] * 10 + [ctypes.c_float, ci,
                                             ctypes.c_float, vp]
        fn.restype = ci
    return fn


def decode_attention_paged(q, k_pages, v_pages, block_tables, kv_len, q_pos,
                           *, k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None, window=0,
                           softcap=0.0, scale=None):
    """Paged-pool decode/verify attention.

    q: [B, Tq, Hq, D]; k_pages, v_pages: [NB, block, Hkv, D] (block 0 is
    the reserved garbage block); block_tables: [B, MBS] int32; kv_len: [B]
    int32; q_pos: [B, Tq] int32. Returns [B, Tq, Hq, D] in q's dtype.
    Quantized pools (``k_scale`` / ``v_scale``) are not ported yet.
    """
    if k_scale is not None or v_scale is not None:
        raise NotImplementedError(
            "quantized KV scales come with the quantized-KV slice of the port")
    d = q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if q.device.type == "cpu":
        return decode_attention_paged_ref(q, k_pages, v_pages, block_tables,
                                          kv_len, q_pos, window=window,
                                          softcap=softcap, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    _check(q, k_pages, v_pages, block_tables, kv_len, q_pos)
    b, tq, hq, _ = q.shape
    nb, bs, hkv, _ = k_pages.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _lib()(q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
                     block_tables.data_ptr(), kv_len.data_ptr(),
                     q_pos.data_ptr(),
                     out.data_ptr(), b, tq, hq, hkv, d, nb, bs,
                     block_tables.shape[1], _DTYPE_CODE[q.dtype],
                     _DTYPE_CODE[k_pages.dtype], float(scale), int(window),
                     float(softcap), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"decode_attention_paged launch failed: CUDA error "
                           f"{err}")
    launches["decode_attention_paged"] += 1
    return out
