"""Tree-verification attention: the CUDA kernels' wrappers and their plain
PyTorch versions.

Ports of the Pallas TPU kernels ``repro.kernels.tree_attention``
(``tree_attention_paged`` and the contiguous ``tree_attention``) and their
oracles ``ref.tree_attention_paged_ref`` / ``ref.tree_attention_ref``. One
target forward scores a packed candidate tree: the window's KV sits at
cache slots ``win_start .. win_start + Tq - 1`` while ``q_pos`` holds each
node's logical position (root + depth), so visibility inside the window is
an ancestor relation carried by a per-query bitmask (``tree_allowed``).
Windows hold at most 32 slots.

Ancestor masks are uint32 bit patterns. PyTorch code keeps them in int64
(values in [0, 2**32)); the kernels receive an int32 tensor holding the
same bits and read it as uint32. ``anc`` may be passed as either.

K/V may be quantized (int8 / fp8 codes with float32 ``k_scale`` /
``v_scale``), as in ``decode_attention``. Each wrapper launches its kernel
(``csrc/tree_attention_paged.cu``, ``csrc/tree_attention.cu``) for CUDA
tensors and takes the plain version only for CPU tensors.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from .decode_attention import (attend, check_inputs, dequant, dims,
                               gather_pages, gather_scales, launch, on_card,
                               plan_args, ptr)

MAX_SLOTS = 32          # one uint32 ancestor mask per query


class TreeAttnInfo(NamedTuple):
    """Packed candidate-tree metadata of a verify window.

    win_start: [B] int — cache slot of window slot 0 (the re-processed
               last committed token); keys below it are committed context.
    anc:       [B, Tq] int — per query slot, bit j set iff window slot j is
               an ancestor-or-self (bit 0 = the root); uint32 bits.
    win_len:   [B] int (optional) — meaningful window slots per row; slots
               past it are invisible. None = all Tq slots.
    """
    win_start: torch.Tensor
    anc: torch.Tensor
    win_len: Optional[torch.Tensor] = None


def anc_bits(anc: torch.Tensor) -> torch.Tensor:
    """uint32 ancestor masks as int64 values in [0, 2**32), from int64 or
    from int32 holding the bits."""
    if anc.dtype == torch.int32:
        return anc.long() & 0xFFFFFFFF
    if anc.dtype != torch.int64:
        raise TypeError(f"anc must be int64 or int32 bits, got {anc.dtype}")
    return anc


def anc_int32(anc: torch.Tensor) -> torch.Tensor:
    """The int32 tensor holding ``anc``'s uint32 bits (the kernels' input);
    exact, with no reliance on a narrowing cast's wrap-around."""
    if anc.dtype == torch.int32:
        return anc
    a = anc_bits(anc)
    return torch.where(a >= 2 ** 31, a - 2 ** 32, a).to(torch.int32)


def tree_allowed(q_pos, kv_pos, tree_info: TreeAttnInfo, window: int = 0):
    """Boolean [B, Tq, Tk] visibility under tree verification. Context keys
    (cache index < win_start) obey the optional sliding window against the
    query's logical position; window keys obey the ancestor bitmask."""
    tq = q_pos.shape[1]
    ws = tree_info.win_start.long()[:, None, None]                  # [B,1,1]
    kvp = kv_pos.long()[:, None, :]                                 # [B,1,Tk]
    ctx = kvp < ws
    if window:
        ctx = ctx & (kvp > q_pos.long()[:, :, None] - window)
    j = kvp - ws
    wl = tq if tree_info.win_len is None \
        else tree_info.win_len.long()[:, None, None]
    in_win = (j >= 0) & (j < wl) & (j < tq)
    bits = (anc_bits(tree_info.anc)[:, :, None] >> j.clamp(0, tq - 1)) & 1
    return ctx | (in_win & (bits == 1))


def _full_win_len(q, win_len):
    if win_len is not None:
        return win_len
    return torch.full((q.shape[0],), q.shape[1], dtype=torch.int32,
                      device=q.device)


def tree_attention_ref(q, k, v, kv_len, q_pos, win_start, anc, *,
                       win_len=None, k_scale=None, v_scale=None, window=0,
                       softcap=0.0, scale=None):
    """The contiguous plain version over k, v [B, S, Hkv, D], dequantized
    first with scales: the tree mask, bounded by eff_len = min(kv_len,
    win_start + win_len)."""
    k, v = dequant(k, v, k_scale, v_scale)
    b, s = q.shape[0], k.shape[1]
    win_len = _full_win_len(q, win_len)
    kv_pos = torch.arange(s, device=q.device)[None, :].expand(b, s)
    allowed = tree_allowed(q_pos, kv_pos,
                           TreeAttnInfo(win_start, anc, win_len), window)
    eff = torch.minimum(kv_len.long(), win_start.long() + win_len.long())
    allowed &= (kv_pos < eff[:, None])[:, None, :]
    return attend(q, k, v, allowed, softcap=softcap, scale=scale)


def tree_attention_paged_ref(q, k_pages, v_pages, block_tables, kv_len,
                             q_pos, win_start, anc, *, win_len=None,
                             k_scale=None, v_scale=None, window=0,
                             softcap=0.0, scale=None):
    """The paged plain version: gather each row's pages (and scales) into
    a contiguous view, then the contiguous plain version."""
    ks, vs = gather_scales(k_scale, v_scale, block_tables)
    return tree_attention_ref(q, gather_pages(k_pages, block_tables),
                              gather_pages(v_pages, block_tables), kv_len,
                              q_pos, win_start, anc, win_len=win_len,
                              k_scale=ks, v_scale=vs, window=window,
                              softcap=softcap, scale=scale)


def _tree_ints(q, kv_len, q_pos, win_start, win_len):
    b, tq = q.shape[:2]
    if tq > MAX_SLOTS:
        raise ValueError(f"tree window of {tq} slots: the uint32 ancestor "
                         f"mask holds {MAX_SLOTS}")
    return (("kv_len", kv_len, (b,)), ("q_pos", q_pos, (b, tq)),
            ("win_start", win_start, (b,)), ("win_len", win_len, (b,)))


def tree_attention_paged(q, k_pages, v_pages, block_tables, kv_len, q_pos,
                         win_start, anc, *, win_len=None,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None, window=0,
                         softcap=0.0, scale=None):
    """Paged-pool tree-verification attention.

    q: [B, Tq, Hq, D], Tq <= 32; k_pages, v_pages: [NB, block, Hkv, D]
    (block 0 = the reserved garbage block); block_tables: [B, MBS] int32;
    kv_len: [B] int32; q_pos: [B, Tq] int32 logical positions; win_start:
    [B] int32; anc: [B, Tq] ancestor bitmasks (int64, or int32 bits);
    win_len: optional [B] int32 meaningful window slots (None = Tq);
    k_scale, v_scale: [NB, block, Hkv] float32, with int8 / fp8 pools.
    Returns [B, Tq, Hq, D] in q's dtype. On the card, bf16 q with bf16,
    int8 or fp8 pools takes the split-KV tensor-core loop; the call reads
    no device value.
    """
    b, tq, _, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    win_len = _full_win_len(q, win_len)
    if not on_card(q):
        return tree_attention_paged_ref(
            q, k_pages, v_pages, block_tables, kv_len, q_pos, win_start, anc,
            win_len=win_len, k_scale=k_scale, v_scale=v_scale, window=window,
            softcap=softcap, scale=scale)
    anc32 = anc_int32(anc)
    check_inputs(q, k_pages, v_pages, (
        ("block_tables", block_tables, (b, block_tables.shape[-1])),
        *_tree_ints(q, kv_len, q_pos, win_start, win_len),
        ("anc", anc32, (b, tq))), k_scale, v_scale)
    nb, bs = k_pages.shape[:2]
    out = torch.empty_like(q)
    head, tail = dims(q, k_pages, scale, window, softcap)
    launch("tree_attention_paged", q, ptr(q), ptr(k_pages), ptr(v_pages),
           ptr(k_scale), ptr(v_scale), ptr(block_tables), ptr(kv_len), ptr(q_pos), ptr(win_start),
           ptr(win_len), ptr(anc32), ptr(out), *head,
           *(ctypes.c_int(x) for x in (nb, bs, block_tables.shape[1])), *tail,
           *plan_args(q, k_pages.shape[2], block_tables.shape[1] * bs))
    return out


def tree_attention(q, k, v, kv_len, q_pos, win_start, anc, *, win_len=None,
                   k_scale: Optional[torch.Tensor] = None,
                   v_scale: Optional[torch.Tensor] = None, window=0,
                   softcap=0.0, scale=None):
    """Contiguous-cache tree-verification attention.

    q: [B, Tq, Hq, D], Tq <= 32; k, v: [B, S, Hkv, D]; the other operands
    as in ``tree_attention_paged``. S is not padded: the sweep stops at
    min(kv_len, S, win_start + win_len); k_scale, v_scale: [B, S, Hkv]
    float32, with int8 / fp8 caches. On the card, bf16 q with a bf16, int8
    or fp8 cache takes the split-KV tensor-core loop, planned with the
    reach S; the call reads no device value.
    """
    b, tq, _, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    win_len = _full_win_len(q, win_len)
    if not on_card(q):
        return tree_attention_ref(q, k, v, kv_len, q_pos, win_start, anc,
                                  win_len=win_len, k_scale=k_scale,
                                  v_scale=v_scale, window=window,
                                  softcap=softcap, scale=scale)
    if k.shape[0] != b:
        raise ValueError(f"cache batch {k.shape[0]} != q batch {b}")
    anc32 = anc_int32(anc)
    check_inputs(q, k, v, (*_tree_ints(q, kv_len, q_pos, win_start, win_len),
                           ("anc", anc32, (b, tq))), k_scale, v_scale)
    out = torch.empty_like(q)
    head, tail = dims(q, k, scale, window, softcap)
    s = k.shape[1]
    launch("tree_attention", q, ptr(q), ptr(k), ptr(v), ptr(k_scale),
           ptr(v_scale), ptr(kv_len),
           ptr(q_pos), ptr(win_start), ptr(win_len), ptr(anc32), ptr(out),
           *head, ctypes.c_int(s), *tail, *plan_args(q, k.shape[2], s))
    return out
