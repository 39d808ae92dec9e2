"""EAGLE-style target-dependent draft head: the paper's main comparison
point (Fig. 1a, Tables 3 and 5). Port of ``repro.core.eagle``.

One transformer layer autoregresses over the target's last-layer
features: its input at step t is ``W_fuse [e(x_t); f_{t-1}]``, where f is
the target's pre-final-norm hidden state (predicted by the head itself
past the committed prefix), and its logits reuse the target's embedding
and unembedding. Unlike PARD's single draft forward, the draft phase is K
sequential one-row head passes; the head is trained per target
(``eagle_loss``).

  eagle_param_shapes(cfg)                          -> tree of leaf shapes
  init_eagle(cfg, seed, device, dtype)             -> seeded random head
  eagle_forward(ep, tp, cfg, tokens, feats, positions, cache=, cache_pos=)
                                                   -> (logits, f_hat, cache)
  eagle_loss(ep, tp, cfg, tokens)                  -> (loss, {"ce", "feat_l1"})
  EagleDecoder(tp, cfg, ep, k=, max_len=).generate(prompt, max_new)
                                                   -> (tokens, SpecStats)

The head's attention goes through the port's kernels like the target's:
``decode_attention`` on its contiguous cache, ``flash_attention`` (forward
and backward) in the cache-free loss.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..models import forward, init_caches
from ..models import layers as L
from ..models.attention import CacheBatch, gqa_apply, init_gqa_cache
from ..models.config import ModelConfig
from ..models.transformer import (_map, check_supported, gqa_shapes,
                                  init_tree, mlp_shapes)
from .acceptance import greedy_chain_accept
from .spec_decode import (SpecStats, _row_read, _row_write, has_ssm,
                          uniform_batch)


def _eagle_tree(cfg: ModelConfig):
    """{name: (shape, init)} of the head (the JAX ``init_eagle``): the
    fuse matrix, one pre-norm GQA layer with a gated SiLU MLP, and the
    output norm."""
    check_supported(cfg)
    d = cfg.d_model
    return {"fuse": ((2 * d, d), 2 * d),
            "layer": {"norm1": {"scale": ((d,), "ones")},
                      "mixer": gqa_shapes(cfg),
                      "norm2": {"scale": ((d,), "ones")},
                      "mlp": mlp_shapes(d, cfg.d_ff, gated=True)},
            "out_norm": {"scale": ((d,), "ones")}}


def eagle_param_shapes(cfg: ModelConfig):
    """The head's params tree of ``cfg`` with each leaf's shape."""
    return _map(_eagle_tree(cfg), lambda _, leaf: leaf[0])


def init_eagle(cfg: ModelConfig, seed: int = 0, device="cuda",
               dtype=torch.bfloat16):
    """Seeded random head params on ``device``: normal / sqrt(fan_in)
    matrices in ``dtype``, unit float32 norm scales."""
    return init_tree(_eagle_tree(cfg), seed, device, dtype)


def _layer_apply(lp, cfg: ModelConfig, x, positions, cache, cache_pos):
    """The head's layer. With ``cache`` ({"k", "v"} [B, max_len, Hkv, D],
    written in place) the window at ``cache_pos`` attends to the cache;
    without, the sequence attends to itself causally."""
    h = L.rmsnorm_apply(lp["norm1"], x, cfg.norm_eps)
    if cache is None:
        y = gqa_apply(lp["mixer"], cfg, h, positions=positions)
    else:
        batch = CacheBatch.build(cache_pos, positions, x.shape[1],
                                 max_len=cache["k"].shape[1])
        y = gqa_apply(lp["mixer"], cfg, h, cache=cache, batch=batch)
    x = x + y
    h2 = L.rmsnorm_apply(lp["norm2"], x, cfg.norm_eps)
    return x + L.mlp_apply(lp["mlp"], h2)


def eagle_forward(eagle_params, target_params, cfg: ModelConfig, tokens,
                  feats, positions, *, cache=None, cache_pos=None):
    """tokens [B, T] (x_t); feats [B, T, D] (f_{t-1}, the target feature at
    the PREVIOUS position), in the activation dtype; positions [B, T].
    Returns (logits [B, T, padded_vocab], f_hat [B, T, D], cache)."""
    e = L.embed_apply(target_params["embed"], tokens, cfg, dtype=feats.dtype)
    x = torch.cat([e, feats], dim=-1) @ eagle_params["fuse"].to(feats.dtype)
    x = _layer_apply(eagle_params["layer"], cfg, x, positions, cache,
                     cache_pos)
    h = L.rmsnorm_apply(eagle_params["out_norm"], x, cfg.norm_eps)
    return L.unembed_apply(target_params["embed"], h, cfg), x, cache


def eagle_loss(eagle_params, target_params, cfg: ModelConfig, tokens, *,
               feat_weight: float = 0.1, dtype=torch.float32):
    """Distillation on a token batch [B, T]: teacher-forced target features,
    cross-entropy to the target's next-token argmax plus ``feat_weight``
    times the L1 regression of the next feature (the EAGLE recipe).
    ``dtype`` is the activation dtype of both forwards (the JAX package's:
    float32). Gradients reach the head only: the target runs without
    autograd and its embedding is detached. Returns (loss, {"ce",
    "feat_l1"})."""
    with torch.no_grad():
        t_logits, _, f = forward(target_params, cfg, tokens, dtype=dtype,
                                 return_hidden=True)
    b, t = tokens.shape
    # the head's input at position i: token x_i, feature f_{i-1}
    feats_in = torch.cat([torch.zeros_like(f[:, :1]), f[:, :-1]], dim=1)
    pos = torch.arange(t, device=tokens.device).expand(b, t)
    embed = {"embed": {n: w.detach()
                       for n, w in target_params["embed"].items()}}
    logits, f_hat, _ = eagle_forward(eagle_params, embed, cfg, tokens,
                                     feats_in, pos)
    labels = t_logits[:, 1:].argmax(dim=-1)
    logp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    ce = -logp.gather(-1, labels[..., None]).mean()
    reg = (f_hat[:, :-1].float() - f[:, 1:].float()).abs().mean()
    return ce + feat_weight * reg, {"ce": ce, "feat_l1": reg}


class EagleDecoder:
    """Greedy speculative decoding of a uniform batch with an EAGLE head
    (a chain, as in the paper's Table 3). The draft phase is K sequential
    one-row head passes; the verify is one (K+1)-row target forward, as in
    ``SpecDecoder``. Forwards run in the target params' dtype; caches are
    contiguous, in ``kv_dtype``. Dense GQA targets only: a Mamba2 state
    cannot take back a rejected verify window here."""

    def __init__(self, target_params, cfg: ModelConfig, eagle_params, *,
                 k: int = 4, max_len: int = 1024, kv_dtype="bf16"):
        if has_ssm(cfg):
            raise ValueError("EAGLE decoding needs a target without Mamba2 "
                             "layers: the verify window rolls back by "
                             "position")
        self.tp, self.cfg, self.ep = target_params, cfg, eagle_params
        self.k, self.max_len, self.kv_dtype = k, max_len, kv_dtype
        self.dtype = target_params["embed"]["embedding"].dtype

    def _step(self, gen, n, done, tcache, ecache, feat_prev):
        """One iteration: (gen, n, feat_prev, a [B] accepted drafts (0 on
        done rows), accepted [B, K] prefix masks of live rows). The head's
        cache keeps its entries across iterations: those at accepted
        positions came from committed context, and the next iteration's
        ``cache_pos`` re-covers the rejected tail."""
        k, cfg = self.k, self.cfg
        cur = gen.gather(1, (n - 1)[:, None])                      # [B, 1]
        feats = feat_prev[:, None]                                 # [B, 1, D]
        props = []
        for j in range(k):
            pos = n - 1 + j
            lg, f_hat, _ = eagle_forward(self.ep, self.tp, cfg, cur, feats,
                                         pos[:, None], cache=ecache,
                                         cache_pos=pos)
            cur = lg[:, -1].argmax(dim=-1)[:, None]
            props.append(cur[:, 0])
            feats = f_hat[:, -1:]
        props = torch.stack(props, dim=1)                          # [B, K]

        vin = torch.cat([gen.gather(1, (n - 1)[:, None]), props], dim=1)
        logits, _, hidden = forward(self.tp, cfg, vin, caches=tcache,
                                    cache_pos=n - 1, dtype=self.dtype,
                                    return_hidden=True)
        a, accepted, commit = greedy_chain_accept(logits, props)
        j = torch.arange(k + 1, device=gen.device)[None, :]
        props_ext = torch.cat([props, props[:, -1:]], dim=1)
        vec = torch.where(j < a[:, None], props_ext,
                          torch.where(j == a[:, None], commit[:, None], 0))
        vec = torch.where(done[:, None], _row_read(gen, n, k + 1), vec)
        # the feature at the last committed token's predecessor (input a)
        rows = torch.arange(gen.shape[0], device=gen.device)
        feat_next = torch.where(done[:, None], feat_prev, hidden[rows, a])
        return (_row_write(gen, vec, n), torch.where(done, n, n + a + 1),
                feat_next, torch.where(done, 0, a),
                torch.where(done[:, None], 0, accepted))

    @torch.no_grad()
    def generate(self, prompt, max_new: int):
        """``prompt [B, P]`` (P >= 2) -> ([B, P + max_new] tokens,
        SpecStats). The target prefills ``prompt[:, :-1]``; the head
        prefills the same tokens with teacher-forced features, as in
        ``eagle_loss``."""
        dev = self.tp["embed"]["embedding"].device
        prompt = uniform_batch(prompt, dev)
        b, p = prompt.shape
        if p < 2:
            raise ValueError("prompts must have at least 2 tokens")
        k, cfg = self.k, self.cfg
        tcache = init_caches(cfg, b, self.max_len, self.kv_dtype, dev)
        ecache = init_gqa_cache(cfg, b, self.max_len, self.kv_dtype, dev)
        zero = torch.zeros(b, dtype=torch.long, device=dev)
        _, _, hidden = forward(self.tp, cfg, prompt[:, :-1], caches=tcache,
                               cache_pos=zero, dtype=self.dtype,
                               return_hidden=True)            # f_0 .. f_{P-2}
        feat_prev = hidden[:, -1]
        feats_in = torch.cat([torch.zeros_like(hidden[:, :1]),
                              hidden[:, :-1]], dim=1)
        pos = torch.arange(p - 1, device=dev).expand(b, p - 1)
        eagle_forward(self.ep, self.tp, cfg, prompt[:, :-1], feats_in, pos,
                      cache=ecache, cache_pos=zero)

        gen = torch.zeros(b, p + max_new + 2 * k + 2, dtype=torch.long,
                          device=dev)
        gen[:, :p] = prompt
        n = zero + p
        done = torch.zeros(b, dtype=torch.bool, device=dev)
        target_n = p + max_new
        acc_hist = torch.zeros(k, dtype=torch.long, device=dev)
        iters, acc_total, live, live_iters = 0, 0, b, 0
        while True:
            gen, n, feat_prev, a, accepted = self._step(
                gen, n, done, tcache, ecache, feat_prev)
            acc_hist += accepted.sum(dim=0)
            done = n >= target_n
            # the accepted total and the rows still live, in one copy
            acc, live_next = torch.stack([a.sum(), (~done).sum()]).tolist()
            iters += 1
            live_iters += live
            acc_total += acc
            live = live_next
            if live == 0 or iters > max_new + 2:
                break
        stats = SpecStats(
            iterations=iters,
            tokens_generated=int((n.clamp(max=target_n) - p).sum()),
            draft_forwards=iters * k, target_forwards=iters,
            accept_hist=acc_hist.cpu().numpy(),
            acceptance_rate=acc_total / max(live_iters, 1) / k,
            mean_accepted=acc_total / max(live_iters, 1) + 1.0)
        return gen[:, :target_n], stats

