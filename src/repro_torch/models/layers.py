"""Dense building blocks: RMSNorm, RoPE, softcap, embeddings, gated MLP.

Port of the dense half of ``repro.models.layers``. Params are plain dicts
of tensors with the JAX package's leaf names and layouts. Matrices are
stored in the working dtype (the JAX code casts them with
``.astype(x.dtype)`` at use); norm scales stay float32 because the JAX
code multiplies by them in float32. MoE comes with a later slice.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def rmsnorm_apply(params, x: torch.Tensor, eps: float = 1e-5,
                  gemma_style: bool = False) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    scale = params["scale"].float()
    y = y * (1.0 + scale) if gemma_style else y * scale
    return y.to(dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., seq, heads, head_dim]; positions: [..., seq] (int)."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)     # [hd/2]
    angles = positions[..., None].float() * freqs               # [..., seq, hd/2]
    angles = angles[..., None, :]                               # over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return x
    return torch.tanh(x / cap) * cap


def embed_apply(params, tokens: torch.Tensor, cfg,
                dtype=torch.bfloat16) -> torch.Tensor:
    x = params["embedding"].to(dtype)[tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype)
    return x


def unembed_apply(params, x: torch.Tensor, cfg) -> torch.Tensor:
    table = params.get("unembed", params["embedding"]).to(x.dtype)
    logits = softcap(x @ table.T, cfg.final_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        # padded vocab rows (and the PARD mask id) can never be predicted
        logits[..., cfg.vocab_size:] = -1e9
    return logits


def mlp_apply(params, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    h = x @ params["wi"].to(x.dtype)
    # jax.nn.gelu defaults to the tanh approximation
    fn = (lambda t: F.gelu(t, approximate="tanh")) if act == "gelu" else F.silu
    if "wg" in params:
        h = fn(x @ params["wg"].to(x.dtype)) * h
    else:
        h = fn(h)
    return h @ params["wo"].to(x.dtype)
