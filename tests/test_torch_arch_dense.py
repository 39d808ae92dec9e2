"""The dense families deepseek-67b, command-r-35b and gemma2-27b in the
port, on their ``-smoke`` configs on the CPU, against the JAX package.

A port of ``tests/test_arch_smoke.py`` for the three families. What they
add to the llama-style decoder: LayerNorm and the parallel attention + MLP
block (command-r), sandwich norms with (1 + scale) RMSNorm, alternating
local (window 64 at smoke size) and global layers, an attention softcap
of 50, a final softcap of 30, a query scale of (d / h)^-0.5, gelu and an
embedding scale (gemma2). Sequences are 80-96 tokens, so gemma2's window
bites.

Weights come from the JAX ``init_params`` through
``interop.params_from_numpy``; the JAX attention runs its jnp path
(``_BACKEND = "xla"``, set and restored per test). Tolerances:

- fp32 forward logits within 2e-4 (atol and rtol): the two packages sum
  in different orders over two layers of width 256; the largest
  difference measured is 2.5e-5 on logits up to 12.2 (gemma2).
- one AR step: loss within 1e-5 relative; every gradient leaf within
  1e-5 of its largest entry; one ``Trainer`` step's metrics within 1e-4
  relative and its params within 1e-4, as ``test_torch_ssm_training.py``
  holds the tiny models, except entries whose gradient is nonzero but
  below 1e-5 of its leaf's largest: AdamW's first update lr g / (|g| +
  eps) moves them by lr in the direction of a gradient that is float32
  noise, so they are held within 2 lr;
- prefill + decode against one cached forward and the cache-free
  forward, paged and contiguous: 2e-4, the port against itself (the JAX
  test's 2e-3 is for bf16-free fp32 too; the port holds 10x tighter).
- greedy PARD through the ``Engine`` (K = 4, fp32, each family's draft
  its own ``-smoke`` config cut to 1 layer): tokens equal AR's.

COD has no window: the JAX package's packed forward lets a gemma2 mask
token's local layer see real tokens further back than the window. The port
refuses COD on a model with local layers past its window.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.adaptation import ar_loss as jax_ar_loss
from repro.core.adaptation import pard_adaptation_loss as jax_pard_loss
from repro.models import attention as jax_attention
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import transformer as jax_transformer
from repro.models.attention import PardMaskInfo as JaxPardMaskInfo
from repro.models.config import scan_plan as jax_scan_plan
from repro.training import optimizer as jax_optimizer
from repro.training.train_loop import Trainer as JaxTrainer
from repro_torch.configs import get_config
from repro_torch.core.adaptation import ar_loss, pard_adaptation_loss
from repro_torch.core.cod import CodConfig, pack_batch
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch import train as launch_train
from repro_torch.models import forward, init_caches, layers, param_shapes
from repro_torch.models.transformer import check_supported
from repro_torch.serving import kv_pool
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import Engine
from repro_torch.training.optimizer import AdamW, cosine_schedule
from repro_torch.training.train_loop import Trainer

FAMILIES = ["deepseek-67b", "command-r-35b", "gemma2-27b"]
TOL = dict(atol=2e-4, rtol=2e-4)
SEQ = 96
COD = (4, 0.7, 0.2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jnp_backend():
    prev = jax_attention._BACKEND
    jax_attention.set_attention_backend("xla")
    yield
    jax_attention.set_attention_backend(prev)


@functools.lru_cache(maxsize=None)
def model(family):
    """(port cfg, port fp32 params, JAX cfg, JAX params) of the family's
    ``-smoke`` config, the JAX params from PRNGKey(0)."""
    name = family + "-smoke"
    cfg, jcfg = get_config(name), jax_get_config(name)
    jp = jax.jit(jax_init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                    jcfg)
    jp = jax.tree.map(np.asarray, jp)
    return cfg, params_from_numpy(jp, cfg, "cpu", torch.float32), jcfg, jp


def tokens(cfg, b=2, t=SEQ, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, t)).astype(np.int32)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("family", FAMILIES)
def test_configs_are_served(family):
    """Full and ``-smoke`` names resolve to the JAX package's configs, and
    ``check_supported`` takes both; the params tree has the JAX tree's
    leaves (LayerNorm biases, no ``norm2`` under a parallel block, the
    sandwich norms)."""
    for suffix in ("", "-smoke"):
        mine = get_config(family + suffix)
        assert dataclasses.asdict(mine) == dataclasses.asdict(
            jax_get_config(family + suffix))
        check_supported(mine)
    cfg, _, _, jp = model(family)
    shapes = jax.tree.map(lambda a: a.shape, jp)
    assert param_shapes(cfg) == shapes
    layer = param_shapes(cfg)["scan"][0]
    assert ("bias" in layer["norm1"]) == cfg.use_layernorm
    assert ("norm2" in layer) != cfg.parallel_block
    assert ("post_norm2" in layer) == cfg.post_block_norms


def test_norms_match_jax():
    from repro.models import layers as jax_layers
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3 + 1
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    np.testing.assert_allclose(
        layers.layernorm_apply(tp, torch.from_numpy(x), 1e-5).numpy(),
        np.asarray(jax_layers.layernorm_apply(p, jnp.asarray(x), 1e-5)),
        atol=1e-5, rtol=1e-5)
    for family in FAMILIES:
        cfg, jcfg = get_config(family), jax_get_config(family)
        _, jnorm = jax_layers.make_norm(jcfg)
        q = p if cfg.use_layernorm else {"scale": p["scale"]}
        np.testing.assert_allclose(
            layers.norm_apply({k: torch.from_numpy(v) for k, v in q.items()},
                              torch.from_numpy(x), cfg).numpy(),
            np.asarray(jnorm(q, jnp.asarray(x))), atol=1e-5, rtol=1e-5)


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("family", FAMILIES)
def test_forward_logits_match_jax(family):
    cfg, tp, jcfg, jp = model(family)
    x = tokens(cfg)
    want = np.asarray(jax_forward(jax.tree.map(jnp.asarray, jp), jcfg,
                                  jnp.asarray(x), dtype=jnp.float32)[0])
    got = forward(tp, cfg, torch.from_numpy(x).long(),
                  dtype=torch.float32)[0].numpy()
    assert got.shape == (2, SEQ, cfg.padded_vocab)
    np.testing.assert_allclose(got[..., :cfg.vocab_size],
                               want[..., :cfg.vocab_size], **TOL)
    assert int(got.argmax(-1).max()) < cfg.vocab_size
    if cfg.final_softcap:
        assert np.abs(got[..., :cfg.vocab_size]).max() < cfg.final_softcap


# --------------------------------------------------------------- training
def _leaves(tree):
    return jax.tree.leaves(tree)


@pytest.mark.parametrize("family", FAMILIES)
def test_ar_step_matches_jax(family):
    """The AR loss and every gradient leaf against ``jax.value_and_grad``
    of the JAX ``ar_loss``, then one ``Trainer`` step against the JAX
    ``Trainer``'s."""
    cfg, tp, jcfg, jp = model(family)
    x = tokens(cfg, t=SEQ - 16, seed=2)
    jparams = jax.tree.map(jnp.asarray, jp)
    jl, jg = jax.value_and_grad(
        lambda p: jax_ar_loss(p, jcfg, jnp.asarray(x), dtype=jnp.float32)[0]
    )(jparams)
    params = params_from_numpy(jp, cfg, "cpu", torch.float32)
    for p in _leaves(params):
        p.requires_grad_(True)
    loss, _ = ar_loss(params, cfg, torch.from_numpy(x).long(),
                      dtype=torch.float32)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    grads = params_to_numpy(jax.tree.map(lambda p: p.grad, params))
    for got, want in zip(_leaves(grads), _leaves(jg)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * max(np.abs(want).max(), 1e-3))

    # one Trainer step on the same tokens x, from the same weights
    tr = Trainer(cfg, AdamW(lr=cosine_schedule(3e-3, 2, 3)), device="cpu")
    jtr = JaxTrainer(jcfg, jax_optimizer.AdamW(
        lr=jax_optimizer.cosine_schedule(3e-3, 2, 3)))
    tparams, _, hist = tr.fit(params_from_numpy(jp, cfg), iter([x]), 1,
                              log_fn=None)
    jparams, _, jhist = jtr.fit(jparams, iter([x]), 1, log_fn=None)
    for key in ("loss", "grad_norm", "lr"):
        assert hist[0][key] == pytest.approx(jhist[0][key], rel=1e-4), key
    lr = hist[0]["lr"]
    for got, want, g in zip(_leaves(params_to_numpy(tparams)),
                            _leaves(jparams), _leaves(jg)):
        want, g = np.asarray(want), np.abs(np.asarray(g))
        # AdamW's first update is lr g / (|g| + eps): where |g| is float32
        # noise (below 1e-5 of the leaf's largest) its sign, and so a move
        # of up to lr either way, is noise too
        noise = (g > 0) & (g < 1e-5 * g.max())
        bound = np.where(noise, 2 * lr, 1e-4)
        assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


# ------------------------------------------------------------------ caches
def _caches(cfg, layout):
    if layout == "paged":
        tables = torch.tensor([[1, 3, 5, 7, 9, 11, 13],
                               [2, 4, 6, 8, 10, 12, 14]], dtype=torch.int32)
        pools = kv_pool.init_paged_caches(cfg, 2, 15, 16, torch.float32,
                                          "cpu")
        return pools, dict(block_tables=tables, kv_block_size=16)
    return init_caches(cfg, 2, 112, torch.float32, "cpu"), {}


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("family", FAMILIES)
def test_prefill_decode_equals_one_cached_forward(family, layout):
    """A 70-token prefill, a 16-token window, then 10 one-token decode
    windows give the logits of one cached forward over all 96 tokens and
    of the cache-free forward (gemma2's window of 64 bites on both)."""
    cfg, tp, _, _ = model(family)
    x = torch.from_numpy(tokens(cfg, seed=3)).long()
    kw = dict(dtype=torch.float32)
    free = forward(tp, cfg, x, **kw)[0]
    caches, ckw = _caches(cfg, layout)
    full = forward(tp, cfg, x, caches=caches,
                   cache_pos=torch.zeros(2, dtype=torch.long), **ckw, **kw)[0]
    caches, ckw = _caches(cfg, layout)
    outs, t = [], 0
    for w in [70, 16] + [1] * 10:
        lg, caches = forward(tp, cfg, x[:, t:t + w], caches=caches,
                             cache_pos=torch.full((2,), t), **ckw, **kw)
        outs.append(lg)
        t += w
    stepped = torch.cat(outs, dim=1)
    v = cfg.vocab_size
    np.testing.assert_allclose(full[..., :v].numpy(), free[..., :v].numpy(),
                               **TOL)
    np.testing.assert_allclose(stepped[..., :v].numpy(),
                               full[..., :v].numpy(), **TOL)


def _draft_cfg(cfg):
    return dataclasses.replace(cfg, name=cfg.name + "-1l", num_layers=1)


@pytest.mark.parametrize("family", FAMILIES)
def test_greedy_pard_equals_ar_through_the_engine(family):
    """fp32, K = 4, paged KV; prompts of 90, 20 and 70 tokens (gemma2's
    window of 64 bites on two of them), max_batch 2 so a slot recycles.
    The draft is the family's ``-smoke`` config cut to 1 layer, with its
    own seeded weights and the same vocab."""
    cfg, tp, _, _ = model(family)
    dcfg = _draft_cfg(cfg)
    from repro_torch.models import init_params
    dp = init_params(dcfg, 7, "cpu", torch.float32)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
               for n in (90, 20, 70)]
    out = {}
    for mode in ("ar", "pard"):
        eng = Engine(tp, cfg, dp, dcfg, config=EngineConfig(
            mode=mode, k=4, max_batch=2, max_len=160, kv_block_size=16,
            kv_dtype="fp32"), device="cpu")
        rids = {eng.submit(p, 12): i for i, p in enumerate(prompts)}
        out[mode] = {rids[c.rid]: np.asarray(c.tokens) for c in eng.run()}
    for i, p in enumerate(prompts):
        assert len(out["pard"][i]) == len(p) + 12
        np.testing.assert_array_equal(out["pard"][i], out["ar"][i])


# --------------------------------------------------------- COD and windows
def _packed(cfg, n, seed=0):
    toks = tokens(cfg, b=2, t=n, seed=seed)
    return toks, pack_batch(toks, CodConfig(*COD), cfg.mask_token_id,
                            seed=seed)


def test_cod_past_the_window_raises():
    """``pard_adaptation_loss``, ``Trainer(loss_kind="pard")`` and the
    launcher refuse gemma2 sequences longer than its window of 64; within
    the window the COD loss equals the JAX package's, and models without
    local layers take any length."""
    cfg, tp, jcfg, jp = model("gemma2-27b")
    _, packed = _packed(cfg, SEQ)
    batch = {k: torch.from_numpy(v) for k, v in packed.items()
             if k != "n_tokens"}
    with pytest.raises(ValueError, match="window"):
        pard_adaptation_loss(tp, cfg, batch, k_max=COD[0],
                             dtype=torch.float32)
    tr = Trainer(cfg, AdamW(), loss_kind="pard", cod=CodConfig(*COD),
                 device="cpu")
    with pytest.raises(ValueError, match="window"):
        tr.make_batch(tokens(cfg, t=SEQ))
    with pytest.raises(ValueError, match="window"):
        launch_train.main(["--arch", "gemma2-27b-smoke", "--pard", "--seq",
                           str(SEQ), "--steps", "1", "--device", "cpu"])

    toks, packed = _packed(cfg, 48)
    batch = tr.make_batch(toks, seed=0)
    loss, _ = pard_adaptation_loss(tp, cfg, batch, k_max=COD[0],
                                   dtype=torch.float32)
    jb = {k: jnp.asarray(v) for k, v in packed.items() if k != "n_tokens"}
    jl, _ = jax_pard_loss(jax.tree.map(jnp.asarray, jp), jcfg, jb,
                          k_max=COD[0], dtype=jnp.float32)
    assert float(loss) == pytest.approx(float(jl), rel=1e-5)

    dcfg, dtp, _, _ = model("deepseek-67b")
    _, packed = _packed(dcfg, SEQ)
    batch = {k: torch.from_numpy(v) for k, v in packed.items()
             if k != "n_tokens"}
    loss, _ = pard_adaptation_loss(dtp, dcfg, batch, k_max=COD[0],
                                   dtype=torch.float32)
    assert torch.isfinite(loss)


def _local_layer_out(jcfg, jp, toks, packed):
    """The JAX package's first (local, window 64) layer on one packed COD
    row, under the COD mask (``mask_info``) and under the causal window
    the served model applies (``mask_info=None``, the row's real tokens
    only)."""
    plan = jax_scan_plan(jcfg)
    spec = plan.period[0]
    assert spec.mixer == "attn_local" and plan.n_repeats == 1
    lp = jax.tree.map(lambda a: jnp.asarray(a)[0], jp["scan"][0])
    embed = {k: jnp.asarray(v) for k, v in jp["embed"].items()}
    from repro.models import layers as jax_layers
    x = jax_layers.embed_apply(embed, jnp.asarray(packed["input_ids"][:1]),
                               jcfg, dtype=jnp.float32)
    pos = jnp.asarray(packed["position_ids"][:1])
    cod, _, _ = jax_transformer._apply_layer(
        lp, jcfg, spec, x, pos, mask_info=JaxPardMaskInfo(
            jnp.asarray(packed["segment"][:1]),
            jnp.asarray(packed["base"][:1])))
    n = toks.shape[1]
    served, _, _ = jax_transformer._apply_layer(
        lp, jcfg, spec, x[:, :n], pos[:, :n])
    return np.asarray(cod[0]), np.asarray(served[0])


def test_jax_cod_leaks_tokens_past_the_window_into_local_mask_tokens():
    """The fault the refusal avoids, on gemma2-27b-smoke (window 64) at
    T = 96: in the JAX package, changing real token 0 moves the
    local-layer output of a mask token at position >= 64 under the COD
    mask, while the served (windowed causal) local layer at that position
    does not move."""
    cfg, _, jcfg, jp = model("gemma2-27b")
    toks, packed = _packed(cfg, SEQ)
    seg, pos = packed["segment"][0], packed["position_ids"][0]
    late = np.nonzero((seg >= 2) & (pos >= cfg.sliding_window))[0]
    assert late.size, "the packed row holds mask tokens past the window"
    q = int(late[0])
    other_toks = toks.copy()
    other_toks[0, 0] = (toks[0, 0] + 1) % cfg.vocab_size
    other = dict(packed, input_ids=packed["input_ids"].copy())
    other["input_ids"][0, 0] = other_toks[0, 0]
    assert seg[0] == 1 and pos[0] == 0
    cod_a, served_a = _local_layer_out(jcfg, jp, toks, packed)
    cod_b, served_b = _local_layer_out(jcfg, jp, other_toks, other)
    assert np.abs(cod_a[q] - cod_b[q]).max() > 1e-3       # the leak
    p = int(pos[q])
    assert np.array_equal(served_a[p], served_b[p])       # served: unseen
