"""The port's configs, layers and paged forward against the JAX package.

Weights come from the JAX package's ``init_params`` and cross through
``interop.params_from_numpy``; inputs are numpy arrays from a seed. The
forward runs in float32 on both sides; tolerance 2e-3 (atol and rtol),
as the JAX package's own backend-equivalence tests use for the same
models (different summation orders over 4 layers).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import acceptance as jax_acceptance
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import layers as jax_layers
from repro.models.attention import paged_flat_index as jax_flat_index
from repro.models.attention import set_attention_backend
from repro.models.attention import write_cache_paged as jax_write_cache
from repro.models.config import layer_plan as jax_layer_plan
from repro.models.config import scan_plan as jax_scan_plan
from repro.serving import kv_pool as jax_kv_pool
from repro_torch.configs import CONFIGS, get_config
from repro_torch.core.acceptance import greedy_chain_accept
from repro_torch.interop import params_from_numpy
from repro_torch.models import forward, init_params, layers, param_shapes
from repro_torch.models.attention import paged_flat_index, write_cache
from repro_torch.models.config import ModelConfig, layer_plan, scan_plan
from repro_torch.serving import kv_pool

TOL = dict(atol=2e-3, rtol=2e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _restore_backend():
    yield
    set_attention_backend("xla")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_configs_match_jax(name):
    for suffix in ("", "-smoke"):
        mine, theirs = get_config(name + suffix), jax_get_config(name + suffix)
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert (mine.padded_vocab, mine.mask_token_id) == \
            (theirs.padded_vocab, theirs.mask_token_id)
        assert [dataclasses.astuple(s) for s in layer_plan(mine)] == \
            [dataclasses.astuple(s) for s in jax_layer_plan(theirs)]
        sp, jsp = scan_plan(mine), jax_scan_plan(theirs)
        assert (len(sp.prefix), len(sp.period), sp.n_repeats) == \
            (len(jsp.prefix), len(jsp.period), jsp.n_repeats)


def test_layers_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 32)).astype(np.float32)
    pos = rng.integers(0, 3000, (2, 5)).astype(np.int32)
    np.testing.assert_allclose(
        layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                          500000.0).numpy(),
        np.asarray(jax_layers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                         500000.0)), atol=2e-5, rtol=2e-5)
    h = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        layers.rmsnorm_apply({"scale": torch.from_numpy(scale)},
                             torch.from_numpy(h), 1e-5).numpy(),
        np.asarray(jax_layers.rmsnorm_apply({"scale": jnp.asarray(scale)},
                                            jnp.asarray(h), 1e-5)),
        atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        layers.softcap(torch.from_numpy(h), 3.0).numpy(),
        np.asarray(jax_layers.softcap(jnp.asarray(h), 3.0)), atol=1e-6)
    mlp = {n: rng.standard_normal(s).astype(np.float32) * 0.1
           for n, s in (("wi", (64, 96)), ("wg", (64, 96)), ("wo", (96, 64)))}
    np.testing.assert_allclose(
        layers.mlp_apply({k: torch.from_numpy(v) for k, v in mlp.items()},
                         torch.from_numpy(h)).numpy(),
        np.asarray(jax_layers.mlp_apply(
            {k: jnp.asarray(v) for k, v in mlp.items()}, jnp.asarray(h))),
        atol=1e-5, rtol=1e-5)
    cfg = get_config("tiny-target")
    emb = rng.standard_normal((cfg.padded_vocab, 128)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size + 1, (2, 5))
    e_t = layers.embed_apply({"embedding": torch.from_numpy(emb)},
                             torch.from_numpy(toks), cfg, torch.float32)
    e_j = jax_layers.embed_apply({"embedding": jnp.asarray(emb)},
                                 jnp.asarray(toks), cfg, jnp.float32)
    np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
    lg_t = layers.unembed_apply({"embedding": torch.from_numpy(emb)}, e_t, cfg)
    lg_j = jax_layers.unembed_apply({"embedding": jnp.asarray(emb)}, e_j, cfg)
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), atol=1e-3,
                               rtol=1e-5)
    assert (lg_t[..., cfg.vocab_size:] == -1e9).all()


@pytest.mark.parametrize("name", ["tiny-target", "tiny-draft",
                                  "qwen2.5-0.5b-smoke", "llama3.2-1b-smoke"])
def test_param_tree_matches_jax(name):
    cfg, jcfg = get_config(name), jax_get_config(name)
    want = jax.tree.map(lambda a: tuple(a.shape),
                        jax.eval_shape(lambda: jax_init_params(
                            jax.random.PRNGKey(0), jcfg)))
    assert jax.tree.map(tuple, param_shapes(cfg),
                        is_leaf=lambda x: isinstance(x, tuple)) == want
    params = init_params(cfg, 3, "cpu", torch.bfloat16)
    again = init_params(cfg, 3, "cpu", torch.bfloat16)
    flat = jax.tree_util.tree_leaves_with_path(
        params, is_leaf=lambda x: isinstance(x, torch.Tensor))
    for path, leaf in flat:
        name_ = path[-1].key
        assert leaf.dtype == (torch.float32 if name_ in ("scale", "q_norm",
                                                         "k_norm")
                              else torch.bfloat16), name_
    emb = params["embed"]["embedding"].float()
    assert abs(emb.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.05
    assert torch.equal(emb, again["embed"]["embedding"].float())


def test_interop_copies_and_checks_shapes():
    cfg = get_config("tiny-draft")
    jp = _np(jax_init_params(jax.random.PRNGKey(1), jax_get_config("tiny-draft")))
    tp = params_from_numpy(jp, cfg, "cpu", torch.float32)
    np.testing.assert_array_equal(tp["scan"][0]["mixer"]["wq"].numpy(),
                                  jp["scan"][0]["mixer"]["wq"])
    bad = jax.tree.map(lambda a: a, jp)
    bad["embed"]["embedding"] = bad["embed"]["embedding"][:-1]
    with pytest.raises(ValueError):
        params_from_numpy(bad, cfg)


def test_paged_write_matches_jax():
    rng = np.random.default_rng(1)
    pages = rng.standard_normal((7, 4, 2, 8)).astype(np.float32)
    new = rng.standard_normal((2, 5, 2, 8)).astype(np.float32)
    tables = np.array([[3, 1, 0], [5, 2, 6]], np.int32)
    cache_pos = np.array([6, 9], np.int32)          # row 0 runs past its table
    pos = cache_pos[:, None] + np.arange(5)[None, :]
    np.testing.assert_array_equal(
        paged_flat_index(torch.from_numpy(tables), torch.from_numpy(pos),
                         4).numpy(),
        np.asarray(jax_flat_index(jnp.asarray(tables), jnp.asarray(pos), 4)))
    want = np.asarray(jax_write_cache(jnp.asarray(pages), jnp.asarray(new),
                                      jnp.asarray(cache_pos),
                                      jnp.asarray(tables), 4))
    got = torch.from_numpy(pages.copy())
    idx = paged_flat_index(torch.from_numpy(tables),
                           torch.from_numpy(pos).long(), 4).reshape(-1)
    write_cache(got, torch.from_numpy(new), idx)
    # block 0 takes the past-table writes in an unspecified order
    np.testing.assert_array_equal(got.numpy()[1:], want[1:])


def _variant(name):
    cfg, jcfg = get_config("tiny-target"), jax_get_config("tiny-target")
    extra = {"base": {},
             "bias+qknorm": dict(qkv_bias=True, qk_norm=True),
             "window+softcap": dict(sliding_window=12, attn_softcap=20.0,
                                    final_softcap=15.0)}[name]
    return (dataclasses.replace(cfg, **extra),
            dataclasses.replace(jcfg, **extra))


def _perturb(tree, rng):
    """Non-trivial biases and qk-norm scales (init makes them 0 / 1)."""
    for layer in tree["scan"]:
        for n in ("bq", "bk", "bv", "q_norm", "k_norm"):
            if n in layer["mixer"]:
                a = layer["mixer"][n]
                layer["mixer"][n] = (a + 0.3 * rng.standard_normal(a.shape)
                                     ).astype(np.float32)
    return tree


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("variant", ["base", "bias+qknorm", "window+softcap"])
def test_paged_forward_matches_jax(backend, variant):
    """Prefill then a decode window through the paged pools, fp32."""
    cfg, jcfg = _variant(variant)
    rng = np.random.default_rng(2)
    jp = _perturb(_np(jax_init_params(jax.random.PRNGKey(0), jcfg)), rng)
    tp = params_from_numpy(jp, cfg, "cpu", torch.float32)
    jp = jax.tree.map(jnp.asarray, jp)
    toks = rng.integers(0, cfg.vocab_size, (2, 20)).astype(np.int32)
    tables = np.array([[1, 3, 5, 7], [2, 4, 6, 8]], np.int32)
    set_attention_backend(backend)

    pools = jax_kv_pool.init_paged_caches(jcfg, 2, num_blocks=9, block_size=8,
                                          dtype=jnp.float32)
    kw = dict(block_tables=jnp.asarray(tables), kv_block_size=8,
              dtype=jnp.float32)
    l1, pools, _ = jax_forward(jp, jcfg, jnp.asarray(toks[:, :16]),
                               caches=pools, cache_pos=jnp.zeros(2, jnp.int32),
                               **kw)
    l2, _, _ = jax_forward(jp, jcfg, jnp.asarray(toks[:, 16:]), caches=pools,
                           cache_pos=jnp.asarray([16, 11], jnp.int32), **kw)

    tpools = kv_pool.init_paged_caches(cfg, 2, 9, 8, torch.float32, "cpu")
    tkw = dict(block_tables=torch.from_numpy(tables), kv_block_size=8,
               dtype=torch.float32)
    t1, tpools = forward(tp, cfg, torch.from_numpy(toks[:, :16]).long(),
                         caches=tpools, cache_pos=torch.zeros(2).long(), **tkw)
    t2, _ = forward(tp, cfg, torch.from_numpy(toks[:, 16:]).long(),
                    caches=tpools, cache_pos=torch.tensor([16, 11]), **tkw)
    np.testing.assert_allclose(t1.numpy(), np.asarray(l1), **TOL)
    np.testing.assert_allclose(t2.numpy(), np.asarray(l2), **TOL)

    last, _ = forward(tp, cfg, torch.from_numpy(toks[:, 16:]).long(),
                      caches=tpools, cache_pos=torch.tensor([16, 11]),
                      last_only=True, **tkw)
    np.testing.assert_allclose(last.numpy(), t2.numpy()[:, -1:], atol=1e-5)


def test_forward_outside_the_slice_raises():
    cfg = get_config("tiny-target")
    params = init_params(cfg, 0, "cpu", torch.float32)
    with pytest.raises(ValueError):          # block tables without caches
        forward(params, cfg, torch.zeros(1, 4, dtype=torch.long),
                block_tables=torch.ones(1, 1, dtype=torch.int32))
    moe = ModelConfig(name="m", arch_type="moe", num_layers=1, d_model=32,
                      n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=64,
                      moe_num_experts=4, moe_top_k=2)
    with pytest.raises(NotImplementedError):
        init_params(moe, 0, "cpu")
    mla = ModelConfig(name="mla", arch_type="dense", num_layers=1,
                      d_model=32, n_heads=2, n_kv_heads=2, d_ff=64,
                      vocab_size=64, attn_kind="mla", kv_lora_rank=16,
                      qk_nope_head_dim=8, qk_rope_head_dim=8, v_head_dim=8)
    with pytest.raises(NotImplementedError):
        kv_pool.init_paged_caches(mla, 2, 3, 8, device="cpu")


def test_greedy_chain_accept_matches_jax():
    rng = np.random.default_rng(4)
    logits = rng.integers(0, 3, (6, 5, 7)).astype(np.float32)   # many ties
    props = rng.integers(0, 3, (6, 4))
    props[0] = logits[0, :4].argmax(-1)                         # full accept
    got = greedy_chain_accept(torch.from_numpy(logits),
                              torch.from_numpy(props))
    want = jax_acceptance.greedy_chain_accept(jnp.asarray(logits),
                                              jnp.asarray(props))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0][0] == 4
