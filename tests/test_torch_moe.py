"""The port's top-k MoE block (``models.layers.moe_apply``) against the JAX
package's ``moe_apply``, on the CPU in float32.

Weights come from the JAX ``init_moe``; the inputs from numpy seeds. Both
routes take the same discrete decisions (the top-k experts, the ranks
within each expert's group and so which (token, slot)s are dropped), so
the outputs agree to float32 summation order: within 2e-4 (atol and
rtol; the largest difference measured is below 1e-6 on outputs of order
1). The load-balance loss is held within 1e-6 relative. Drops are forced
with ``moe_capacity_factor=0.5`` and checked against the ranks recomputed
from the JAX router's top-k indices. Ties: a router with duplicated
columns gives equal probabilities, and both packages must pick the lower
expert index first.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import layers as jax_layers
from repro_torch.configs import get_config
from repro_torch.interop import (cast_params, params_from_numpy,
                                params_to_numpy)
from repro_torch.models import layers
from repro_torch.models.transformer import F32_LEAVES, init_tree

TOL = dict(atol=2e-4, rtol=2e-4)
GRANITE = "granite-moe-3b-a800m-smoke"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**over):
    """(port cfg, JAX cfg) of granite-smoke with ``over`` replaced; 8
    experts top 2 by default, so a group of 16 tokens has cap 4 at
    factor 0.5 and drops."""
    over = {"moe_num_experts": 8, **over}
    return (dataclasses.replace(get_config(GRANITE), **over),
            dataclasses.replace(jax_get_config(GRANITE), **over))


def _moe_params(jcfg, seed=0):
    """(port params, JAX params as numpy) of one block from ``init_moe``."""
    jp = jax.tree.map(np.asarray,
                      jax_layers.init_moe(jax.random.PRNGKey(seed), jcfg))
    return jax.tree.map(lambda a: torch.from_numpy(a.copy()), jp), jp


def _shapes(cfg):
    def shape(tree):
        if isinstance(tree, dict):
            return {k: shape(v) for k, v in tree.items()}
        return tree[0]
    return shape(layers.moe_shapes(cfg))


def _x(d, b=2, t=16, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (b, t, d)).astype(np.float32)


def _jax_moe(jp, x, jcfg, dropless):
    y, aux = jax_layers.moe_apply(jax.tree.map(jnp.asarray, jp),
                                  jnp.asarray(x), jcfg, return_aux=True,
                                  dropless=dropless)
    return np.asarray(y), float(aux["load_balance_loss"])


def _jax_keep(jp, x, jcfg, dropless):
    """([n, k] kept (token, slot)s, [n, k] experts): the JAX router's
    top-k indices, and the ranks recounted from them in (token, slot)
    order per group (g and cap from ``moe_capacity``, which
    ``test_capacity_rule`` holds to values worked by hand from the JAX
    code)."""
    n, d = x.shape[0] * x.shape[1], x.shape[2]
    e, k = jcfg.moe_num_experts, jcfg.moe_top_k
    logits = jnp.asarray(x.reshape(n, d)) @ jnp.asarray(jp["router"])
    _, idx = jax.lax.top_k(jax.nn.softmax(logits.astype(jnp.float32)), k)
    idx = np.asarray(idx)
    g, cap = layers.moe_capacity(jcfg, n, dropless)
    keep = np.zeros((n, k), bool)
    for start in range(0, n, g):
        seen = np.zeros(e, int)
        for i in range(start, start + g):
            for j in range(k):
                keep[i, j] = seen[idx[i, j]] < cap
                seen[idx[i, j]] += 1
    return keep, idx


def test_moe_shapes_match_init_moe():
    for shared in (0, 1):
        cfg, jcfg = _cfgs(moe_num_shared=shared)
        jp = jax_layers.init_moe(jax.random.PRNGKey(0), jcfg)
        assert _shapes(cfg) == jax.tree.map(lambda a: a.shape, jp)
        assert ("shared" in jp) == bool(shared)


@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("mode", ["dropless", "capacity", "drops"])
def test_moe_apply_matches_jax(mode, shared):
    """Output within 2e-4, load-balance loss equal, the same (token,
    slot)s dropped. ``drops`` halves the capacity factor so that some
    expert overflows its 4 slots in a group."""
    over = {"moe_num_shared": shared}
    if mode == "drops":
        over["moe_capacity_factor"] = 0.5
    cfg, jcfg = _cfgs(**over)
    tp, jp = _moe_params(jcfg)
    x = _x(cfg.d_model)
    dropless = mode == "dropless"
    want, want_aux = _jax_moe(jp, x, jcfg, dropless)
    got, aux, keep = layers.moe_apply(tp, torch.from_numpy(x), cfg,
                                      dropless=dropless)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert float(aux) == pytest.approx(want_aux, rel=1e-6)
    want_keep, _ = _jax_keep(jp, x, jcfg, dropless)
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    if mode == "dropless":
        assert keep.all()
    if mode == "drops":
        assert 0 < int((~keep).sum()) < keep.numel()


def test_ties_break_toward_the_lower_index():
    """Duplicated router columns tie experts (0, 4), (1, 5), ...: the
    port's top-k indices equal ``lax.top_k``'s, the lower index first,
    and the outputs still agree with JAX's."""
    cfg, jcfg = _cfgs(moe_top_k=3)
    tp, jp = _moe_params(jcfg)
    router = np.tile(jp["router"][:, :4], (1, 2))
    jp = dict(jp, router=router)
    tp = dict(tp, router=torch.from_numpy(router))
    x = _x(cfg.d_model, seed=2)
    probs, idx, _ = layers.moe_route(tp, torch.from_numpy(x).view(
        -1, cfg.d_model), cfg)
    _, want_idx = _jax_keep(jp, x, jcfg, True)
    p = probs.numpy()
    assert np.array_equal(p[:, :4], p[:, 4:])          # every pair ties
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    # the two top picks are a tied pair, lower index first
    assert (idx[:, 1] == idx[:, 0] + 4).all()
    for dropless in (True, False):
        want, want_aux = _jax_moe(jp, x, jcfg, dropless)
        got, aux, _ = layers.moe_apply(tp, torch.from_numpy(x), cfg,
                                       dropless=dropless)
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        assert float(aux) == pytest.approx(want_aux, rel=1e-6)


@pytest.mark.parametrize("n,want", [(2048, (256, 64)), (1023, (1, 1)),
                                    (384, (128, 32)), (95, (95, 23)),
                                    (40, (40, 10)), (6, (6, 4))])
def test_capacity_rule(n, want):
    """granite's 40 experts top 8: the training batch (4 x 512) routes in
    groups of 256 with 64 slots per expert; 384 tokens halve the group to
    128; an odd token count above 256 gives groups of one token, where
    nothing can be dropped, while up to 256 tokens form one group; cap is
    at least 4 and at most the group."""
    cfg = get_config("granite-moe-3b-a800m")
    assert layers.moe_capacity(cfg, n, False) == want
    assert layers.moe_capacity(cfg, n, True) == (n, n)


def test_dropless_routing_is_per_token():
    """Dropless mode: a token's output does not depend on its batch-mates
    (the property speculative decoding needs); capacity mode with drops
    lets them in."""
    cfg, _ = _cfgs(moe_capacity_factor=0.5)
    tp = init_tree(layers.moe_shapes(cfg), 0, "cpu", torch.float32)
    x = torch.from_numpy(_x(cfg.d_model, b=4, t=8, seed=3))
    for dropless in (True, False):
        alone = torch.cat([layers.moe_apply(tp, x[i:i + 1], cfg,
                                            dropless=dropless)[0]
                           for i in range(4)])
        together = layers.moe_apply(tp, x, cfg, dropless=dropless)[0]
        assert torch.equal(alone, together) == dropless


def test_gradients_match_jax():
    """d(sum(y * w) + aux) / d(router, experts, shared, x) against
    ``jax.grad`` in capacity mode with drops."""
    cfg, jcfg = _cfgs(moe_capacity_factor=0.5, moe_num_shared=1)
    tp, jp = _moe_params(jcfg)
    x = _x(cfg.d_model, seed=4)
    w = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = jax_layers.moe_apply(p, xx, jcfg, return_aux=True)
        return jnp.sum(y * jnp.asarray(w)) + aux["load_balance_loss"]

    jg, jgx = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, jp),
                                              jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    leaves = jax.tree_util.tree_leaves(tp)
    for p in leaves:
        p.requires_grad_(True)
    y, aux, _ = layers.moe_apply(tp, xt, cfg)
    ((y * torch.from_numpy(w)).sum() + aux).backward()
    for got, want in zip(jax.tree_util.tree_leaves(
            jax.tree.map(lambda p: p.grad.numpy(), tp)),
            jax.tree_util.tree_leaves(jg)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * max(np.abs(want).max(), 1e-3))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=0,
                               atol=1e-5 * np.abs(np.asarray(jgx)).max())


@pytest.mark.parametrize("name", [GRANITE, "jamba-1.5-large-398b-smoke"])
def test_params_round_trip(name):
    """The JAX ``init_params`` tree of the MoE configs into the port and
    back, leaf for leaf; ``cast_params`` to bf16 keeps the router and the
    experts in bf16 and the norm scales in float32."""
    from repro.models import init_params as jax_init_params
    cfg = get_config(name)
    jp = jax.tree.map(np.asarray, jax_init_params(
        jax.random.PRNGKey(0), jax_get_config(name)))
    tp = params_from_numpy(jp, cfg)
    back = params_to_numpy(tp)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(got, want)
    moe = [lp["mlp"] for lp in tp["scan"] if "router" in lp.get("mlp", {})]
    assert moe, "the config has a MoE layer"
    half = cast_params(tp, torch.bfloat16)
    for path, leaf in jax.tree_util.tree_flatten_with_path(half)[0]:
        last = path[-1].key
        want = torch.float32 if last in F32_LEAVES else torch.bfloat16
        assert leaf.dtype == want, (path, leaf.dtype)
