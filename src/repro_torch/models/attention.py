"""GQA self-attention on block-paged KV pools or contiguous KV caches.

Port of the cached GQA paths of ``repro.models.attention``. Two layouts:

  * paged: a pool holds fixed-size KV blocks ``[NB, block, Hkv, D]``; a
    per-row block table ``[B, MBS]`` maps absolute position ``p`` to
    ``(table[b, p // block], p % block)``. Block 0 is the reserved garbage
    block: positions past a row's table, or unallocated entries, write
    there and are never read (reads are bounded by ``kv_len``);
  * contiguous: one full-length row ``[B, max_len, Hkv, D]`` per batch row,
    indexed by absolute position; a window's write start is clamped to
    ``max_len - T`` like ``lax.dynamic_update_slice`` (the scheduler's
    slack keeps that from happening).

Unlike the JAX code, which returns new caches, the port writes each
window's K/V IN PLACE (``index_copy_`` over the leading two axes of the
layer's view of the stacked leaf), so a step never copies a cache.

Quantized KV (``kv_dtype`` "int8" / "fp8", e4m3): each cache carries
``k_scale`` / ``v_scale`` leaves of float32 scales, one per (position, kv
head), beside the 8-bit ``k`` / ``v``. A window's K/V is quantized at
append (``quantize_kv``) and written with its scales through the same
flat entries; the kernels dequantize inside their KV stream.

Every attention call goes through a kernel wrapper: causal windows to
``decode_attention_paged`` / ``decode_attention``, tree verify windows
(``TreeAttnInfo``) to ``tree_attention_paged`` / ``tree_attention``. The
cache-free forward (training) sends a packed COD batch (``PardMaskInfo``)
to ``pard_attention`` and a causal full sequence to ``flash_attention``;
both are differentiable and write nothing in place.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..kernels.decode_attention import (as_bytes, decode_attention,
                                        decode_attention_paged,
                                        dequantize_kv)  # noqa: F401
from ..kernels.flash_attention import flash_attention
from ..kernels.pard_attention import PardMaskInfo, pard_mask  # noqa: F401
from ..kernels.pard_attention import pard_attention
from ..kernels.tree_attention import (TreeAttnInfo, anc_int32,  # noqa: F401
                                      tree_allowed, tree_attention,
                                      tree_attention_paged)
from .layers import apply_rope


@dataclasses.dataclass(frozen=True)
class CacheBatch:
    """KV addressing of one forward window, shared by every layer.

    tables [B, MBS] int32 (None: contiguous caches); write_index [B * T]
    flat entries over a cache's two leading axes that the window's tokens
    write to; kv_len [B] int32 (= cache_pos + T); q_pos [B, T] int32 query
    positions; tree: the window's ``TreeAttnInfo`` with int32 operands
    (None: causal windows).
    """
    tables: Optional[torch.Tensor]
    write_index: torch.Tensor
    kv_len: torch.Tensor
    q_pos: torch.Tensor
    tree: Optional[TreeAttnInfo] = None

    @staticmethod
    def build(cache_pos, positions, t: int, *, block_tables=None,
              block_size: int = 0, max_len: int = 0, tree_info=None):
        if block_tables is not None:
            pos = cache_pos.long()[:, None] + torch.arange(
                t, device=cache_pos.device)[None, :]
            write_index = paged_flat_index(block_tables, pos,
                                           block_size).reshape(-1)
            block_tables = block_tables.to(torch.int32).contiguous()
        else:
            write_index = contiguous_flat_index(cache_pos, t, max_len)
        tree = None
        if tree_info is not None:
            win_len = tree_info.win_len
            if win_len is None:
                win_len = torch.full_like(cache_pos, t)
            tree = TreeAttnInfo(
                win_start=tree_info.win_start.to(torch.int32).contiguous(),
                anc=anc_int32(tree_info.anc).contiguous(),
                win_len=win_len.to(torch.int32).contiguous())
        return CacheBatch(tables=block_tables, write_index=write_index,
                          kv_len=(cache_pos + t).to(torch.int32),
                          q_pos=positions.to(torch.int32).contiguous(),
                          tree=tree)


def paged_flat_index(block_tables, pos, block_size: int):
    """Map absolute positions [B, T] to flat pool-entry indices through the
    per-row block tables. Positions past a row's table resolve to the
    reserved garbage block 0."""
    ent = pos // block_size
    mbs = block_tables.shape[1]
    blk = torch.gather(block_tables.long(), 1, ent.clamp(0, mbs - 1))
    blk = torch.where(ent >= mbs, 0, blk)
    return blk * block_size + pos % block_size


def contiguous_flat_index(cache_pos, t: int, max_len: int):
    """Flat entries [B * T] of a contiguous cache [B, max_len, ...] that a
    T-token window at per-row ``cache_pos`` writes: row b's start is clamped
    into [0, max_len - T], as ``lax.dynamic_update_slice`` clamps it."""
    b = cache_pos.shape[0]
    start = cache_pos.long().clamp(0, max_len - t)
    rows = torch.arange(b, device=cache_pos.device)[:, None] * max_len
    return (rows + start[:, None]
            + torch.arange(t, device=cache_pos.device)[None, :]).reshape(-1)


def write_cache(buf, new, write_index):
    """Write new KV [B, T, ...] into a cache in place at the flat entries
    ``write_index`` [B * T] over its two leading axes: a pool [NB, bs, ...]
    (``paged_flat_index``) or a contiguous cache [B, max_len, ...]
    (``contiguous_flat_index``). Rows own disjoint entries, so only
    garbage-block entries can repeat (their content is never read)."""
    flat = as_bytes(buf).view((-1,) + tuple(buf.shape[2:]))
    flat.index_copy_(0, write_index, as_bytes(
        new.reshape((-1,) + tuple(new.shape[2:])).to(buf.dtype)))


# the KV storage dtypes by EngineConfig / --kv-dtype name. int8 and fp8
# store each [D] vector quantized against a per-(position, kv head) float32
# scale in sibling "k_scale" / "v_scale" leaves
KV_DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32,
             "int8": torch.int8, "fp8": torch.float8_e4m3fn}

# the largest magnitude of a quantized dtype: one scale unit maps amax on it
_QUANT_MAXVAL = {torch.int8: 127.0, torch.float8_e4m3fn: 448.0}


def resolve_kv_dtype(kv_dtype) -> torch.dtype:
    """A KV_DTYPES name or a torch dtype -> the storage dtype."""
    if isinstance(kv_dtype, str):
        return KV_DTYPES[kv_dtype]
    return kv_dtype


def kv_dtype_is_quantized(dtype) -> bool:
    return resolve_kv_dtype(dtype) in _QUANT_MAXVAL


def quantize_kv(x, qdtype):
    """Symmetric quantization of x [..., D] per vector over the last axis:
    (codes [..., D] in ``qdtype``, scales [...] float32) with
    ``dequantize_kv(codes, scales) ~= x``. int8: scale amax / 127, round
    half to even, clip; fp8 (e4m3): scale amax / 448, the cast rounds. An
    all-zero vector takes scale 1 (the garbage block's zeros stay zero), so
    no scale is 0. The fp8 values are clamped to +-448 before the cast: at
    a subnormal amax (x = 1.1754944e-38) the scale loses bits and x / scale
    passes 448, which the reference casts to NaN."""
    qdtype = resolve_kv_dtype(qdtype)
    maxval = _QUANT_MAXVAL[qdtype]
    xf = x.float()
    amax = xf.abs().amax(dim=-1)
    scale = torch.where(amax > 0, amax / maxval, 1.0)
    scaled = xf / scale[..., None]
    if qdtype == torch.int8:
        scaled = torch.round(scaled)
    return scaled.clamp(-maxval, maxval).to(qdtype), scale


def init_gqa_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
                   device="cuda"):
    """Zeroed contiguous KV rows ``{"k", "v"}`` of [batch, max_len, Hkv, D]
    in ``dtype`` (a torch dtype or a KV_DTYPES name); a quantized dtype
    adds ``k_scale`` / ``v_scale`` [batch, max_len, Hkv] float32 ones."""
    return kv_leaves((batch, max_len, cfg.n_kv_heads, cfg.resolved_head_dim),
                     dtype, device)


def kv_leaves(shape, dtype, device):
    """Zeroed ``{"k", "v"}`` of ``shape`` [.., .., Hkv, D] in ``dtype``,
    plus scale leaves of ones [.., .., Hkv] when ``dtype`` is quantized."""
    dtype = resolve_kv_dtype(dtype)
    c = {n: torch.zeros(shape, dtype=dtype, device=device) for n in ("k", "v")}
    if kv_dtype_is_quantized(dtype):
        for n in ("k_scale", "v_scale"):
            c[n] = torch.ones(shape[:-1], dtype=torch.float32, device=device)
    return c


def _qk_rmsnorm(x, scale, eps):
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def _proj(x, w):
    """x [B, T, d] against w [d, H, hd] -> [B, T, H, hd]."""
    return (x @ w.to(x.dtype).flatten(1)).unflatten(-1, tuple(w.shape[1:]))


def gqa_apply(params, cfg, x, *, layer_window: int = 0, cache=None,
              batch: Optional[CacheBatch] = None, positions=None,
              mask_info: Optional[PardMaskInfo] = None):
    """Self attention of ``x`` [B, T, d]. Returns y [B, T, d].

    With ``cache`` (``{"k", "v"}`` and, quantized, ``{"k_scale",
    "v_scale"}``, written in place) the window attends
    to the layer's cache through ``batch``. Without it the whole sequence
    attends to itself at RoPE ``positions`` [B, T]: under the COD mask of
    ``mask_info`` (PARD training), else causally in token order (AR
    training, cache-free forwards).
    """
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if "bq" in params:
        q = q + params["bq"].to(x.dtype)
        k = k + params["bk"].to(x.dtype)
        v = v + params["bv"].to(x.dtype)
    if cfg.qk_norm:
        q = _qk_rmsnorm(q, params["q_norm"], cfg.norm_eps)
        k = _qk_rmsnorm(k, params["k_norm"], cfg.norm_eps)
    rope_pos = positions if cache is None else batch.q_pos
    if cfg.use_rope:
        q = apply_rope(q, rope_pos, cfg.rope_theta)
        k = apply_rope(k, rope_pos, cfg.rope_theta)
    q = q.contiguous()
    kw = dict(softcap=cfg.attn_softcap, scale=cfg.attn_scale or None)
    if cache is None:
        k, v = k.contiguous(), v.contiguous()
        if mask_info is not None:
            out = pard_attention(q, k, v, mask_info, **kw)
        else:
            out = flash_attention(q, k, v, causal=True, window=layer_window,
                                  **kw)
    else:
        out = _cached_attend(q, k, v, cache, batch, window=layer_window, **kw)
    wo = params["wo"].to(x.dtype)                      # [Hq, hd, d]
    return out.flatten(2) @ wo.flatten(0, 1)


def _cached_attend(q, k, v, cache, batch: CacheBatch, **kw):
    """Write the window's K/V into the cache in place (quantized at append
    when the cache holds scales), then attend to it."""
    if "k_scale" in cache:
        k, ks = quantize_kv(k, cache["k"].dtype)
        v, vs = quantize_kv(v, cache["v"].dtype)
        write_cache(cache["k_scale"], ks, batch.write_index)
        write_cache(cache["v_scale"], vs, batch.write_index)
        kw.update(k_scale=cache["k_scale"], v_scale=cache["v_scale"])
    write_cache(cache["k"], k, batch.write_index)
    write_cache(cache["v"], v, batch.write_index)
    tr = batch.tree
    if batch.tables is not None:
        if tr is None:
            return decode_attention_paged(q, cache["k"], cache["v"],
                                          batch.tables, batch.kv_len,
                                          batch.q_pos, **kw)
        return tree_attention_paged(q, cache["k"], cache["v"], batch.tables,
                                    batch.kv_len, batch.q_pos, tr.win_start,
                                    tr.anc, win_len=tr.win_len, **kw)
    if tr is None:
        return decode_attention(q, cache["k"], cache["v"], batch.kv_len,
                                batch.q_pos, **kw)
    return tree_attention(q, cache["k"], cache["v"], batch.kv_len,
                          batch.q_pos, tr.win_start, tr.anc,
                          win_len=tr.win_len, **kw)
