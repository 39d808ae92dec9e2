"""The port's EAGLE head (``repro_torch.core.eagle``) on the CPU, against
the JAX package's ``repro.core.eagle`` and against the port's own AR
decoding.

The head is the JAX ``init_eagle(PRNGKey(9), cfg)`` on tiny-target (from
``init_params(PRNGKey(0))``), both converted numpy -> torch in fp32. The
JAX EAGLE decoder's forwards default to bf16 activations, so its
module-level ``forward`` is pinned to fp32 (``monkeypatch``); its caches
stay bf16 on both sides, as in the JAX defaults.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import eagle as jax_eagle
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models.attention import init_gqa_cache as jax_init_gqa_cache
from repro_torch.configs import get_config
from repro_torch.core import eagle, spec_decode as sd
from repro_torch.interop import eagle_params_from_numpy, params_from_numpy
from repro_torch.models.attention import init_gqa_cache
from repro_torch.training.optimizer import AdamW, leaves

K = 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_fp32(monkeypatch):
    """Pin the JAX EAGLE module's target forwards to fp32 for one test."""
    monkeypatch.setattr(jax_eagle, "forward",
                        functools.partial(jax_forward, dtype=jnp.float32))


@functools.lru_cache(maxsize=None)
def models():
    """(port cfg, port target, port head, JAX cfg, JAX target, JAX head)."""
    cfg, jcfg = get_config("tiny-target"), jax_get_config("tiny-target")
    jtp = jax.jit(jax_init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                     jcfg)
    jep = jax.jit(jax_eagle.init_eagle, static_argnums=1)(
        jax.random.PRNGKey(9), jcfg)
    to_np = functools.partial(jax.tree.map, np.asarray)
    tp = params_from_numpy(to_np(jtp), cfg, "cpu", torch.float32)
    ep = eagle_params_from_numpy(to_np(jep), cfg, "cpu", torch.float32)
    return cfg, tp, ep, jcfg, jtp, jep


def tokens(b, t, seed):
    return np.random.default_rng(seed).integers(0, 512, (b, t)).astype(
        np.int32)


def _np_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _np_leaves(tree[k])]
    return [np.asarray(tree, np.float32)]


def test_params_convert_and_init_shapes():
    """The converted head keeps JAX's tree and leaves; ``init_eagle`` draws
    the same tree with float32 norm scales."""
    cfg, _, ep, _, _, jep = models()
    for got, want in zip(_np_leaves(ep), _np_leaves(jep)):
        np.testing.assert_array_equal(got, want)
    fresh = eagle.init_eagle(cfg, 3, "cpu", torch.bfloat16)
    assert jax.tree.structure(jax.tree.map(lambda x: 0, fresh)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, jep))
    assert fresh["fuse"].dtype == torch.bfloat16
    assert fresh["out_norm"]["scale"].dtype == torch.float32
    assert fresh["fuse"].shape == (2 * cfg.d_model, cfg.d_model)


@pytest.mark.parametrize("cached", [False, True])
def test_eagle_forward_matches_jax(cached):
    """Logits and f_hat within 1e-4 of JAX in fp32, cache-free and over a
    contiguous fp32 cache (a prefill window, then one row at its end)."""
    cfg, tp, ep, jcfg, jtp, jep = models()
    b, t = 2, 9
    toks = tokens(b, t, 0)
    feats = np.random.default_rng(1).standard_normal(
        (b, t, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(t), (b, t))
    if not cached:
        got = eagle.eagle_forward(ep, tp, cfg, torch.from_numpy(toks).long(),
                                  torch.from_numpy(feats),
                                  torch.from_numpy(pos.copy()))
        want = jax.jit(jax_eagle.eagle_forward, static_argnums=2)(
            jep, jtp, jcfg, jnp.asarray(toks), jnp.asarray(feats),
            jnp.asarray(pos))
        pairs = [(got[0], want[0]), (got[1], want[1])]
    else:
        cache = init_gqa_cache(cfg, b, 32, torch.float32, "cpu")
        jcache = jax_init_gqa_cache(jcfg, b, 32, jnp.float32)
        pairs = []
        for lo, hi in ((0, t - 1), (t - 1, t)):
            cp = np.full((b,), lo, np.int32)
            got = eagle.eagle_forward(
                ep, tp, cfg, torch.from_numpy(toks[:, lo:hi]).long(),
                torch.from_numpy(feats[:, lo:hi]),
                torch.from_numpy(pos[:, lo:hi].copy()), cache=cache,
                cache_pos=torch.from_numpy(cp).long())
            want = jax.jit(jax_eagle.eagle_forward, static_argnums=2)(
                jep, jtp, jcfg, jnp.asarray(toks[:, lo:hi]),
                jnp.asarray(feats[:, lo:hi]), jnp.asarray(pos[:, lo:hi]),
                cache=jcache, cache_pos=jnp.asarray(cp))
            jcache = want[2]
            pairs += [(got[0], want[0]), (got[1], want[1])]
        np.testing.assert_allclose(cache["k"].numpy(),
                                   np.asarray(jcache["k"]), atol=1e-5)
    for g, w in pairs:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-4)


def test_eagle_loss_and_grads_match_jax():
    """The loss value within 1e-5 relative and every head gradient within
    1e-4 of JAX autodiff; the target takes no gradient."""
    cfg, tp, ep, jcfg, jtp, jep = models()
    toks = tokens(3, 16, 2)
    (jloss, jparts), jgrads = jax.jit(jax.value_and_grad(
        lambda e: jax_eagle.eagle_loss(e, jtp, jcfg, jnp.asarray(toks)),
        has_aux=True))(jep)
    head = jax.tree.map(lambda x: x.clone().requires_grad_(True), ep)
    for p in leaves(tp):
        p.requires_grad_(True)
    try:
        loss, parts = eagle.eagle_loss(head, tp, cfg,
                                       torch.from_numpy(toks).long())
        loss.backward()
        assert all(p.grad is None for p in leaves(tp))
    finally:
        for p in leaves(tp):
            p.requires_grad_(False)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    for name in ("ce", "feat_l1"):
        np.testing.assert_allclose(parts[name].item(), float(jparts[name]),
                                   rtol=1e-5)
    got = _np_leaves(jax.tree.map(lambda x: x.grad, head))
    want = _np_leaves(jgrads)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)


def test_eagle_decoder_matches_jax_and_ar(jax_fp32):
    """Greedy tokens equal the JAX EagleDecoder's (bf16 caches on both
    sides, fp32 forwards) and the port's own generate_ar; K head passes
    per iteration."""
    cfg, tp, ep, jcfg, jtp, jep = models()
    x = tokens(2, 8, 3)
    got, st = eagle.EagleDecoder(tp, cfg, ep, k=K, max_len=128).generate(
        x, 16)
    want, jst = jax_eagle.EagleDecoder(
        jtp, jcfg, jep, k=K, max_len=128).generate(jnp.asarray(x), 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for f in ("iterations", "tokens_generated", "draft_forwards",
              "target_forwards"):
        assert getattr(st, f) == getattr(jst, f), f
    np.testing.assert_array_equal(st.accept_hist, np.asarray(jst.accept_hist))
    assert abs(st.mean_accepted - jst.mean_accepted) <= 1e-6
    assert st.draft_forwards == K * st.iterations
    ar, _ = sd.SpecDecoder(tp, cfg, k=K, max_len=128,
                           kv_block_size=0).generate_ar(x, 16)
    assert torch.equal(got, ar)


@pytest.mark.parametrize("kv_dtype", ["fp32", "bf16"])
def test_eagle_decoder_is_lossless(kv_dtype):
    """Inside the port, greedy EAGLE tokens equal AR tokens at any head."""
    cfg, tp, ep, *_ = models()
    x = tokens(3, 11, 4)
    ar, _ = sd.SpecDecoder(tp, cfg, k=K, max_len=128, kv_block_size=0,
                           kv_dtype=kv_dtype).generate_ar(x, 12)
    got, st = eagle.EagleDecoder(tp, cfg, ep, k=K, max_len=128,
                                 kv_dtype=kv_dtype).generate(x, 12)
    assert torch.equal(got, ar)
    assert st.tokens_generated == 3 * 12 and st.target_forwards == st.iterations


def test_eagle_loss_decreases():
    """25 AdamW steps at lr 3e-3 on one batch end below the first loss."""
    cfg, tp, ep, *_ = models()
    head = jax.tree.map(lambda x: x.clone().requires_grad_(True), ep)
    opt = AdamW(lr=3e-3)
    state = opt.init(head)
    toks = torch.from_numpy(tokens(8, 32, 5)).long()
    losses = []
    for _ in range(25):
        loss, _ = eagle.eagle_loss(head, tp, cfg, toks)
        loss.backward()
        grads = jax.tree.map(lambda x: x.grad, head)
        head, state, _ = opt.update(grads, state, head)
        for p in leaves(head):
            p.grad = None
        losses.append(loss.item())
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_eagle_decoder_refuses_ssm_targets():
    ssm = get_config("tiny-ssm")
    from repro_torch.models import init_params
    with pytest.raises(ValueError, match="Mamba2"):
        eagle.EagleDecoder(init_params(ssm, 0, "cpu", torch.float32), ssm, {})
