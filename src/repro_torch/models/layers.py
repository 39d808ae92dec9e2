"""Building blocks: RMSNorm, LayerNorm, RoPE, softcap, embeddings, the
gated MLP and the top-k mixture of experts.

Port of ``repro.models.layers``. Params are plain dicts of tensors with
the JAX package's leaf names and layouts. Matrices are stored in the
working dtype (the JAX code casts them with ``.astype(x.dtype)`` at use;
the MoE router too); norm scales stay float32 because the JAX code
multiplies by them in float32.
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


def layernorm_apply(params, x: torch.Tensor,
                    eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * params["scale"].float() \
        + params["bias"].float()
    return y.to(dtype)


def norm_shapes(cfg):
    """{name: (shape, init)} of one norm of ``cfg``'s flavour: LayerNorm
    adds a zero ``bias`` to the unit ``scale``."""
    d = cfg.d_model
    shapes = {"scale": ((d,), "ones")}
    if cfg.use_layernorm:
        shapes["bias"] = ((d,), "zeros")
    return shapes


def norm_apply(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """The norm of ``cfg``'s flavour (the JAX ``make_norm``): LayerNorm
    under ``use_layernorm``; else RMSNorm, multiplying by (1 + scale) under
    ``post_block_norms`` (gemma2)."""
    if cfg.use_layernorm:
        return layernorm_apply(params, x, cfg.norm_eps)
    return rmsnorm_apply(params, x, cfg.norm_eps,
                         gemma_style=cfg.post_block_norms)


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


def mlp_shapes(d: int, f: int, gated: bool):
    """{name: (shape, init)} of a dense MLP (``init_mlp``)."""
    mlp = {"wi": ((d, f), d), "wo": ((f, d), f)}
    if gated:
        mlp["wg"] = ((d, f), d)
    return mlp


def moe_shapes(cfg):
    """{name: (shape, init)} of a MoE block (``init_moe``): the router
    [d, e], the experts' gated MLPs stacked on a leading expert axis
    (``we_i`` / ``we_g`` [e, d, f], ``we_o`` [e, f, d]) and, with
    ``moe_num_shared``, one dense gated MLP ``shared`` of width f x
    num_shared that every token passes through."""
    e, d = cfg.moe_num_experts, cfg.d_model
    f = cfg.moe_d_ff or cfg.d_ff
    moe = {"router": ((d, e), d), "we_i": ((e, d, f), d),
           "we_g": ((e, d, f), d), "we_o": ((e, f, d), f)}
    if cfg.moe_num_shared:
        moe["shared"] = mlp_shapes(d, f * cfg.moe_num_shared, True)
    return moe


MOE_GROUP = 256                 # routed tokens of one capacity group


def moe_capacity(cfg, n: int, dropless: bool):
    """(tokens per group g, slots per expert and group cap) of ``n``
    routed tokens, the JAX ``moe_apply``'s rule: dropless is one group
    with cap = n; else g is min(``MOE_GROUP``, n) halved until it divides
    n (so up to ``MOE_GROUP`` tokens form one group, and an odd n above
    it gives g = 1), cap = min(max(4, factor g k / e), g)."""
    if dropless:
        return n, n
    g = min(MOE_GROUP, n)
    while n % g:
        g //= 2
    cap = max(4, int(cfg.moe_capacity_factor * g * cfg.moe_top_k
                     / cfg.moe_num_experts))
    return g, min(cap, g)


def moe_route(params, x: torch.Tensor, cfg):
    """Router of ``moe_apply`` on x [n, d]: (probs [n, e] float32, the
    top-k experts [n, k] in descending order, ties toward the lower
    index as ``lax.top_k`` breaks them, their gates [n, k] renormalized
    to sum to 1 in float32)."""
    logits = (x @ params["router"].to(x.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort keeps equal probabilities in index order;
    # torch.topk promises no order among ties, and bf16 logits tie often
    idx = torch.sort(probs, dim=-1, descending=True,
                     stable=True).indices[:, :cfg.moe_top_k].contiguous()
    gates = probs.gather(1, idx)
    return probs, idx, gates / (gates.sum(-1, keepdim=True) + 1e-9)


def moe_apply(params, x: torch.Tensor, cfg, dropless: bool = False):
    """x [B, T, d] -> (y [B, T, d], load-balance loss, keep [B T, k]).

    Top-k routing with per-group expert capacity, the JAX ``moe_apply``
    step for step (``moe_route``, ``moe_capacity``): the B T tokens split
    into groups of g in order; each (token, slot) takes the next of its
    expert's cap slots in its group, counted in (token, slot) order, and
    is dropped (``keep`` False, gate 0) once they are full. Kept rows are
    scattered to a zeroed [e, G, cap, d] buffer, each expert's gated MLP
    runs as one batched product over experts, and each token sums its k
    slots' outputs weighted by its gates (rounded to x's dtype, as in
    JAX) in float32, rounded once. Dropless mode is one group with cap =
    n, so no token is dropped and routing is per token. Static shapes,
    and no value is read back to the host. The load-balance loss is e x
    sum over experts of (mean router probability) x (mean number of the
    token's k slots routed there), counted before drops."""
    b, t, d = x.shape
    e, k = cfg.moe_num_experts, cfg.moe_top_k
    n = b * t
    xt = x.reshape(n, d)
    probs, idx, gates = moe_route(params, xt, cfg)
    g, cap = moe_capacity(cfg, n, dropless)
    ng = n // g

    # rank of each (token, slot) among its group's picks of its expert
    onehot = (idx.view(ng, g * k, 1) == torch.arange(
        e, device=x.device)).long()                          # [G, g k, e]
    rank = (onehot.cumsum(1) - onehot).gather(
        2, idx.view(ng, g * k, 1)).view(n, k)
    keep = rank < cap
    gates = gates.to(x.dtype) * keep

    # kept rows to their (expert, group, rank) slot; dropped ones to a
    # spare last row, which nothing reads
    group = torch.arange(n, device=x.device).view(n, 1) // g
    dest = torch.where(keep, (idx * ng + group) * cap + rank, e * ng * cap)
    src = xt.unsqueeze(1).expand(n, k, d).reshape(n * k, d)
    buf = xt.new_zeros(e * ng * cap + 1, d).index_copy(0, dest.view(-1), src)
    xe = buf[:-1].view(e, ng * cap, d)
    hi = torch.bmm(xe, params["we_i"].to(x.dtype))
    hg = torch.bmm(xe, params["we_g"].to(x.dtype))
    ye = torch.bmm(F.silu(hg) * hi, params["we_o"].to(x.dtype))
    picked = ye.view(e * ng * cap, d).index_select(
        0, torch.where(keep, dest, 0).view(-1)).view(n, k, d)
    y = (gates.float().unsqueeze(-1) * picked.float()).sum(1).to(x.dtype)
    if "shared" in params:
        y = y + mlp_apply(params["shared"], xt)

    count = onehot.view(n, k, e).sum(1).float()
    aux = e * (probs.mean(0) * count.mean(0)).sum()
    return y.view(b, t, d), aux, keep
