"""Decoder-only transformer on paged KV pools or contiguous KV caches.

Port of ``repro.models.transformer`` for GQA, Mamba2 (SSM) and hybrid
configs with dense or top-k MoE MLPs (granite-moe, jamba), with the dense
families' block variants: LayerNorm and the parallel attention + MLP
block (command-r), sandwich norms with (1 + scale) RMSNorm (gemma2).
Params keep the JAX package's tree: ``embed``, ``final_norm``, ``prefix``
(a list of layer dicts) and ``scan`` (one dict per period position, every
leaf stacked on a leading ``n_repeats`` axis); the layer loop indexes the
stacked leaves.

  param_shapes(cfg)                              -> tree of leaf shapes
  init_params(cfg, seed, device, dtype)          -> seeded random params
  init_caches(cfg, batch, max_len, dtype, device) -> contiguous KV caches
  forward(params, cfg, tokens, caches=, cache_pos=, block_tables=,
          kv_block_size=, tree_info=)            -> (logits, caches)
  forward(..., caches=, collect_ssm=records)     -> (logits, caches)
  forward(params, cfg, tokens, positions, mask_info=, remat=)
                                                 -> (logits, None)
  forward(..., return_hidden=True)               -> (logits, caches, hidden)
  forward(..., return_aux=True)                  -> (logits, caches[, hidden],
                                                     load-balance loss)

Without caches the forward is the training path: the whole sequence
attends to itself (``flash_attention``, or ``pard_attention`` under a COD
``mask_info``), and autograd differentiates it; ``remat`` recomputes each
layer in the backward pass (``torch.utils.checkpoint``) instead of keeping
its activations. Mamba2 layers keep a float32 ``{"conv", "ssm"}`` state
per batch row in the caches (``init_caches``); a forward with caches
updates it in place, or, with a ``collect_ssm`` list, leaves it and
appends the records ``core.spec_decode.gather_ssm_states`` needs to set
it to the state after any token of the window. MoE layers route their
tokens as the JAX package does: dropless in cached windows of at most 64
rows (decode, verify, prefill chunks), with per-group capacity (tokens
past it dropped) in cache-free forwards and wider windows. Other
architectures (MLA, cross-attention, encoders) come with later slices.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from . import layers as L
from .attention import CacheBatch, gqa_apply, init_gqa_cache
from .config import (ATTN_GLOBAL, ATTN_LOCAL, MLP_DENSE, MLP_MOE, MLP_NONE,
                     SSM, ModelConfig, scan_plan)
from .layers import mlp_shapes
from .ssm import init_mamba2_state, mamba2_apply

# leaves the JAX code multiplies in float32 (norm scales and LayerNorm
# biases, the Mamba2 conv, decay, skip and gate-norm leaves); every other
# leaf (the MoE router too) is cast to the activation dtype at use, so the
# port stores it in that dtype
F32_LEAVES = ("scale", "bias", "q_norm", "k_norm", "conv_w", "conv_b",
              "A_log", "D", "dt_bias", "ssm_norm")


def check_supported(cfg: ModelConfig) -> None:
    """Raise for configs outside the ported slices: GQA decoders
    (LayerNorm, parallel blocks and sandwich norms included), Mamba2 (SSM)
    stacks and hybrids of the two, with dense or MoE MLPs. MLA,
    cross-attention and encoders are refused."""
    plan = scan_plan(cfg)
    bad = [s for s in plan.prefix + plan.period
           if s.mixer not in (ATTN_GLOBAL, ATTN_LOCAL, SSM)
           or s.mlp not in (MLP_DENSE, MLP_MOE, MLP_NONE)
           or (s.mlp == MLP_NONE and s.mixer != SSM)]
    flags = [f for f in ("abs_pos", "is_encoder_decoder") if getattr(cfg, f)]
    if bad or flags or cfg.attn_kind != "gqa":
        raise NotImplementedError(
            f"{cfg.name}: only GQA, Mamba2 and hybrid decoders with dense "
            f"or MoE MLPs are ported so far (unsupported layers "
            f"{sorted({str(s) for s in bad})}, flags {flags})")


def _layer_shapes(cfg: ModelConfig, spec):
    """{name: (shape, init)}: init is a fan-in (normal / sqrt(fan_in)),
    "ones", "zeros", "conv" (normal x 0.1) or "a_log" (log(linspace(1, 16,
    H))) — the JAX package's _init_layer with init_gqa / init_mlp /
    init_moe / init_mamba2. A parallel block has no ``norm2`` (its MLP
    reads ``norm1``'s output); sandwich norms add ``post_norm1`` (and
    ``post_norm2`` with an MLP)."""
    d = cfg.d_model
    if spec.mixer == SSM:
        d_in, n, h = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_nheads
        conv_dim = d_in + 2 * n
        mixer = {"in_proj": ((d, 2 * d_in + 2 * n + h), d),
                 "conv_w": ((cfg.ssm_conv, conv_dim), "conv"),
                 "conv_b": ((conv_dim,), "zeros"), "A_log": ((h,), "a_log"),
                 "D": ((h,), "ones"), "dt_bias": ((h,), "zeros"),
                 "ssm_norm": ((d_in,), "ones"),
                 "out_proj": ((d_in, d), d_in)}
    else:
        mixer = gqa_shapes(cfg)
    layer = {"norm1": L.norm_shapes(cfg), "mixer": mixer}
    if spec.mlp != MLP_NONE and not cfg.parallel_block:
        layer["norm2"] = L.norm_shapes(cfg)
    if spec.mlp == MLP_DENSE:
        layer["mlp"] = mlp_shapes(d, cfg.first_dense_d_ff or cfg.d_ff,
                                  cfg.mlp_gated)
    elif spec.mlp == MLP_MOE:
        layer["mlp"] = L.moe_shapes(cfg)
    if cfg.post_block_norms:
        layer["post_norm1"] = L.norm_shapes(cfg)
        if spec.mlp != MLP_NONE:
            layer["post_norm2"] = L.norm_shapes(cfg)
    return layer


def gqa_shapes(cfg: ModelConfig):
    """{name: (shape, init)} of a GQA mixer (``init_gqa``)."""
    d = cfg.d_model
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    mixer = {"wq": ((d, hq, hd), d), "wk": ((d, hkv, hd), d),
             "wv": ((d, hkv, hd), d), "wo": ((hq, hd, d), hq * hd)}
    if cfg.qkv_bias:
        mixer.update(bq=((hq, hd), "zeros"), bk=((hkv, hd), "zeros"),
                     bv=((hkv, hd), "zeros"))
    if cfg.qk_norm:
        mixer.update(q_norm=((hd,), "ones"), k_norm=((hd,), "ones"))
    return mixer


def _stack(tree, n: int):
    if isinstance(tree, dict):
        return {k: _stack(v, n) for k, v in tree.items()}
    shape, init = tree
    return ((n,) + shape, init)


def _param_tree(cfg: ModelConfig):
    check_supported(cfg)
    plan = scan_plan(cfg)
    d, v = cfg.d_model, cfg.padded_vocab
    embed = {"embedding": ((v, d), d)}
    if not cfg.tie_embeddings:
        embed["unembed"] = ((v, d), d)
    return {"embed": embed, "final_norm": L.norm_shapes(cfg),
            "prefix": [_layer_shapes(cfg, s) for s in plan.prefix],
            "scan": [_stack(_layer_shapes(cfg, s), plan.n_repeats)
                     for s in plan.period]}


def _map(tree, fn, name=""):
    if isinstance(tree, dict):
        return {k: _map(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn, name) for v in tree]
    return fn(name, tree)


def param_shapes(cfg: ModelConfig):
    """The params tree of ``cfg`` with each leaf's shape."""
    return _map(_param_tree(cfg), lambda _, leaf: leaf[0])


def leaf_dtype(name: str, dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if name in F32_LEAVES else dtype


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                dtype=torch.bfloat16):
    """Seeded random params, drawn directly on ``device`` in their storage
    dtype: normal / sqrt(fan_in) matrices, unit norm scales, zero biases;
    Mamba2 conv weights normal x 0.1 and A_log = log(linspace(1, 16, H)),
    as the JAX package's init_mamba2 draws them."""
    return init_tree(_param_tree(cfg), seed, device, dtype)


def init_tree(tree, seed: int, device, dtype):
    """Draw every ``(shape, init)`` leaf of ``tree`` as ``init_params``
    describes, from one generator seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(name, leaf):
        shape, init = leaf
        dt = leaf_dtype(name, dtype)
        if init == "ones":
            return torch.ones(shape, dtype=dt, device=device)
        if init == "zeros":
            return torch.zeros(shape, dtype=dt, device=device)
        if init == "a_log":           # the same for every stacked layer
            a = torch.linspace(1.0, 16.0, shape[-1], dtype=dt, device=device)
            return torch.log(a).expand(shape).contiguous()
        w = torch.randn(shape, generator=gen, dtype=dt, device=device)
        return w.mul_(0.1 if init == "conv" else 1.0 / math.sqrt(init))

    return _map(tree, make)


def _index(tree, r: int):
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def _unstack(tree, n: int):
    """The ``n`` per-layer trees of a stacked tree, one ``unbind`` per leaf:
    its backward writes each stacked gradient once, where ``n`` indexings
    would each zero-fill a stacked-size gradient for autograd to sum."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: v[r] for k, v in per.items()} for r in range(n)]
    return tree.unbind(0)


def stack_layer_caches(plan, make):
    """The caches tree of ``plan``: ``make(spec)`` per prefix layer, and per
    period position its result stacked on a leading repeats axis."""
    def stacked(spec):
        return {n: t.expand((plan.n_repeats,) + t.shape).contiguous()
                for n, t in make(spec).items()}

    return {"prefix": [make(s) for s in plan.prefix],
            "scan": [stacked(s) for s in plan.period]}


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype=torch.bfloat16, device="cuda"):
    """Zeroed contiguous caches with the params tree's layout: ``prefix``
    holds one dict per prefix layer, ``scan`` one per period position with
    a leading repeats axis. Attention layers hold ``{"k", "v"}`` [batch,
    max_len, Hkv, D] in ``dtype`` (a torch dtype or a kv-dtype name:
    "bf16", "fp32", "int8", "fp8"; int8 and fp8 add ``{"k_scale",
    "v_scale"}`` [batch, max_len, Hkv] float32 ones); Mamba2 layers
    ``{"conv", "ssm"}`` in float32 (``init_mamba2_state``) whatever the
    kv dtype, as in the JAX package."""
    check_supported(cfg)

    def make(spec):
        if spec.mixer == SSM:
            return init_mamba2_state(cfg, batch, device)
        return init_gqa_cache(cfg, batch, max_len, dtype, device)

    return stack_layer_caches(scan_plan(cfg), make)


def _cache_len(caches) -> int:
    """max_len of contiguous caches (every attention layer shares it; 0
    without attention layers)."""
    for entry in caches["prefix"]:
        if "k" in entry:
            return entry["k"].shape[1]
    for entry in caches["scan"]:
        if "k" in entry:
            return entry["k"].shape[2]
    return 0


def _apply_layer(lp, cfg: ModelConfig, spec, x, *, cache=None, batch=None,
                 positions=None, mask_info=None, collect=None,
                 dropless=False):
    """(x after the layer, its load-balance loss: a 0-d float32 tensor
    for a MoE layer, else None)."""
    h = L.norm_apply(lp["norm1"], x, cfg)
    if spec.mixer == SSM:
        y, record = mamba2_apply(lp["mixer"], cfg, h, state=cache,
                                 collect_states=collect is not None)
        if record is not None:
            collect.append(record)
    else:
        window = cfg.sliding_window if spec.mixer == ATTN_LOCAL else 0
        y = gqa_apply(lp["mixer"], cfg, h, layer_window=window, cache=cache,
                      batch=batch, positions=positions, mask_info=mask_info)
    if cfg.post_block_norms:
        y = L.norm_apply(lp["post_norm1"], y, cfg)
    if spec.mlp == MLP_NONE:
        return x + y, None
    if cfg.parallel_block:
        return x + y + L.mlp_apply(lp["mlp"], h, act=cfg.mlp_act), None
    x = x + y
    h2 = L.norm_apply(lp["norm2"], x, cfg)
    aux = None
    if spec.mlp == MLP_MOE:
        m, aux, _ = L.moe_apply(lp["mlp"], h2, cfg, dropless=dropless)
    else:
        m = L.mlp_apply(lp["mlp"], h2, act=cfg.mlp_act)
    if cfg.post_block_norms:
        m = L.norm_apply(lp["post_norm2"], m, cfg)
    return x + m, aux


def forward(params: Dict[str, Any], cfg: ModelConfig, tokens: torch.Tensor,
            positions=None, *, caches=None, cache_pos=None, block_tables=None,
            kv_block_size: int = 0, dtype=torch.bfloat16,
            last_only: bool = False, tree_info=None, mask_info=None,
            remat: bool = False, collect_ssm: Optional[list] = None,
            return_hidden: bool = False, return_aux: bool = False):
    """Run the decoder stack.

    tokens [B, T]. With ``caches`` (written in place), a window against KV
    caches: from ``serving.kv_pool.init_paged_caches`` with block_tables
    [B, MBS] int32, or from ``init_caches`` with block_tables None;
    cache_pos [B] write offset; positions [B, T] (default cache_pos +
    arange(T)); tree_info: the verify window's ``TreeAttnInfo`` (tree
    attention instead of causal). Without caches, the training forward:
    positions [B, T] feed RoPE (default arange(T)); ``mask_info``, a COD
    ``PardMaskInfo``, replaces the causal mask; ``remat`` recomputes each
    layer in the backward pass. Mamba2 layers scan the window from their
    cached state and write the new state in place; given a
    ``collect_ssm`` list they leave it and append one record each
    (``models.ssm.mamba2_apply``) for ``core.spec_decode.gather_ssm_states``.
    MoE layers route dropless in a cached window of at most 64 rows and
    with per-group capacity otherwise (the JAX forward's rule).
    Returns (logits [B, T or 1, padded_vocab], caches), and with
    ``return_hidden`` also the pre-final-norm features [B, T or 1, d] (the
    JAX forward's ``aux["hidden"]``, which EAGLE heads condition on), and
    with ``return_aux`` last the MoE layers' load-balance losses summed
    in layer order (a 0-d float32 tensor; 0 without MoE layers).
    """
    check_supported(cfg)
    plan = scan_plan(cfg)
    b, t = tokens.shape
    collect = collect_ssm
    if caches is None:
        if (tree_info is not None or block_tables is not None
                or collect is not None):
            raise ValueError("tree_info, block_tables and collect_ssm need "
                             "caches")
        if positions is None:
            positions = torch.arange(t, device=tokens.device).expand(b, t)
        layer_kw = [dict(positions=positions, mask_info=mask_info)] * (
            len(plan.prefix) + plan.n_repeats * len(plan.period))
    else:
        if mask_info is not None:
            raise ValueError("COD masks are for cache-free (training) forwards")
        if positions is None:
            positions = cache_pos[:, None] + torch.arange(
                t, device=tokens.device)[None, :]
        batch = None
        if any(s.mixer != SSM for s in plan.prefix + plan.period):
            batch = CacheBatch.build(
                cache_pos, positions, t, block_tables=block_tables,
                block_size=kv_block_size,
                max_len=0 if block_tables is not None else _cache_len(caches),
                tree_info=tree_info)
        # routing that depends on the window's other rows would break
        # speculative decoding's equality with AR: decode, verify and
        # prefill-chunk windows route dropless
        dropless = t <= 64
        layer_kw = [dict(cache=c, batch=batch, collect=collect,
                         dropless=dropless)
                    for c in caches["prefix"]] + [
            dict(cache=_index(caches["scan"][j], r), batch=batch,
                 collect=collect, dropless=dropless)
            for r in range(plan.n_repeats) for j in range(len(plan.period))]

    layers = [(params["prefix"][i], spec) for i, spec in enumerate(plan.prefix)]
    scan = [_unstack(p, plan.n_repeats) for p in params["scan"]]
    layers += [(scan[j][r], spec) for r in range(plan.n_repeats)
               for j, spec in enumerate(plan.period)]
    x = L.embed_apply(params["embed"], tokens, cfg, dtype=dtype)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for (lp, spec), kw in zip(layers, layer_kw):
        run = functools.partial(_apply_layer, lp, cfg, spec, **kw)
        x, aux = checkpoint(run, x, use_reentrant=False) if remat else run(x)
        if aux is not None:
            aux_total = aux_total + aux
    if last_only:
        x = x[:, -1:]
    hidden = x
    x = L.norm_apply(params["final_norm"], x, cfg)
    logits = L.unembed_apply(params["embed"], x, cfg)
    out = (logits, caches) + ((hidden,) if return_hidden else ())
    return out + (aux_total,) if return_aux else out
