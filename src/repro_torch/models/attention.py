"""GQA self-attention on block-paged KV pools.

Port of the paged GQA path of ``repro.models.attention``. A pool holds
fixed-size KV blocks ``[NB, block, Hkv, D]``; a per-row block table
``[B, MBS]`` maps absolute position ``p`` to ``(table[b, p // block],
p % block)``. Block 0 is the reserved garbage block: positions past a
row's table, or unallocated entries, write there and are never read
(reads are bounded by ``kv_len``).

Unlike the JAX code, which returns new pools, the port writes each
window's K/V into the pools IN PLACE (``index_copy_`` on the layer's
``[NB, bs, Hkv, D]`` view of the stacked ``[R, NB, bs, Hkv, D]`` leaf), so
a step never copies a pool. Every attention call goes through the paged
decode kernel (``kernels.decode_attention``).
"""
from __future__ import annotations

import dataclasses

import torch

from ..kernels.decode_attention import decode_attention_paged
from .layers import apply_rope


@dataclasses.dataclass(frozen=True)
class PagedBatch:
    """Paged-KV addressing of one forward window, shared by every layer.

    tables [B, MBS] int32, write_index [B * T] flat pool entries the
    window's tokens write to, kv_len [B] int32 (= cache_pos + T) and
    q_pos [B, T] int32 query positions.
    """
    tables: torch.Tensor
    write_index: torch.Tensor
    kv_len: torch.Tensor
    q_pos: torch.Tensor

    @staticmethod
    def build(block_tables, cache_pos, positions, t: int, block_size: int):
        pos = cache_pos.long()[:, None] + torch.arange(
            t, device=cache_pos.device)[None, :]
        return PagedBatch(
            tables=block_tables.to(torch.int32).contiguous(),
            write_index=paged_flat_index(block_tables, pos,
                                         block_size).reshape(-1),
            kv_len=(cache_pos + t).to(torch.int32),
            q_pos=positions.to(torch.int32).contiguous())


def paged_flat_index(block_tables, pos, block_size: int):
    """Map absolute positions [B, T] to flat pool-entry indices through the
    per-row block tables. Positions past a row's table resolve to the
    reserved garbage block 0."""
    ent = pos // block_size
    mbs = block_tables.shape[1]
    blk = torch.gather(block_tables.long(), 1, ent.clamp(0, mbs - 1))
    blk = torch.where(ent >= mbs, 0, blk)
    return blk * block_size + pos % block_size


def write_cache_paged(pages, new, write_index):
    """Write new KV [B, T, ...] into the pool [NB, bs, ...] in place at the
    flat entries ``write_index`` [B * T]. Rows own disjoint blocks, so only
    garbage-block entries can repeat (their content is never read)."""
    flat = pages.view((-1,) + tuple(pages.shape[2:]))
    flat.index_copy_(0, write_index,
                     new.reshape((-1,) + tuple(new.shape[2:])).to(pages.dtype))


def _qk_rmsnorm(x, scale, eps):
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def _proj(x, w):
    """x [B, T, d] against w [d, H, hd] -> [B, T, H, hd]."""
    return (x @ w.to(x.dtype).flatten(1)).unflatten(-1, tuple(w.shape[1:]))


def gqa_apply(params, cfg, x, *, layer_window: int = 0, cache,
              paged: PagedBatch):
    """Self attention of the window ``x`` [B, T, d] against the layer's
    paged pools ``cache = {"k", "v"}`` (written in place). Returns y."""
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
    if cfg.use_rope:
        q = apply_rope(q, paged.q_pos, cfg.rope_theta)
        k = apply_rope(k, paged.q_pos, cfg.rope_theta)
    write_cache_paged(cache["k"], k, paged.write_index)
    write_cache_paged(cache["v"], v, paged.write_index)
    out = decode_attention_paged(
        q.contiguous(), cache["k"], cache["v"], paged.tables, paged.kv_len,
        paged.q_pos, window=layer_window, softcap=cfg.attn_softcap,
        scale=cfg.attn_scale or None)
    wo = params["wo"].to(x.dtype)                      # [Hq, hd, d]
    return out.flatten(2) @ wo.flatten(0, 1)
