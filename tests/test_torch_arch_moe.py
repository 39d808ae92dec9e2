"""The MoE families granite-moe-3b-a800m (40 experts top 8 at full size)
and jamba-1.5-large-398b (Mamba2 + attention + MoE, no RoPE) in the port,
on their ``-smoke`` configs on the CPU, against the JAX package.

Weights come from the JAX ``init_params`` through
``interop.params_from_numpy``; the JAX attention runs its jnp path
(``_BACKEND = "xla"``, set and restored per test). Tolerances:

- fp32 forward logits within 2e-4 (atol and rtol), cache-free (capacity
  routing, groups spanning the two rows) and in cached windows (dropless
  at most 64 rows, capacity past that); the load-balance loss within 1e-5
  relative;
- one AR step (loss with 0.01 x the load-balance loss) and one COD step:
  the loss within 1e-5 relative, every gradient leaf within 1e-5 of its
  largest entry; one ``Trainer`` step as ``test_torch_arch_dense.py``
  holds it;
- engine tokens equal: the port's PARD to the JAX Engine's (JAX pinned to
  fp32 activations), and the port's VSD, static and adaptive trees
  (granite), contiguous KV and prefix-cache hits to its own AR.

A jamba target has a Mamba2 layer, so it serves flat only (trees raise,
as in the JAX package), and its AR is compared with the port's PARD, not
with the JAX AR engine (whose chunked AR step lets pads into the state).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import spec_decode as jax_sd
from repro.core.adaptation import ar_loss as jax_ar_loss
from repro.core.adaptation import pard_adaptation_loss as jax_pard_loss
from repro.models import attention as jax_attention
from repro.models import forward as jax_forward
from repro.models import init_caches as jax_init_caches
from repro.models import init_params as jax_init_params
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import Engine as JaxEngine
from repro.training import optimizer as jax_optimizer
from repro.training.train_loop import Trainer as JaxTrainer
from repro_torch.configs import get_config
from repro_torch.core.adaptation import ar_loss, pard_adaptation_loss
from repro_torch.core.cod import CodConfig, pack_batch
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import forward, init_caches, param_shapes
from repro_torch.models.config import MLP_MOE, SSM, layer_plan
from repro_torch.models.transformer import check_supported
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import Engine
from repro_torch.training.optimizer import AdamW, cosine_schedule
from repro_torch.training.train_loop import Trainer

GRANITE, JAMBA = "granite-moe-3b-a800m", "jamba-1.5-large-398b"
FAMILIES = [GRANITE, JAMBA]
TOL = dict(atol=2e-4, rtol=2e-4)
SEQ = 96
COD = (4, 0.7, 0.2)
SMALL = dict(k=4, max_batch=2, max_len=192, kv_block_size=16,
             kv_dtype="fp32")
MAX_NEW = 12


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


@pytest.fixture
def jax_fp32(monkeypatch):
    """Pin the JAX decoder's forwards to fp32 activations for one test."""
    monkeypatch.setattr(jax_sd, "forward",
                        functools.partial(jax_forward, dtype=jnp.float32))


@functools.lru_cache(maxsize=None)
def model(family):
    """(port cfg, port fp32 params, JAX cfg, JAX params as numpy) of the
    family's ``-smoke`` config, the JAX params from PRNGKey(0)."""
    name = family + "-smoke"
    cfg, jcfg = get_config(name), jax_get_config(name)
    jp = jax.jit(jax_init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                    jcfg)
    jp = jax.tree.map(np.asarray, jp)
    return cfg, params_from_numpy(jp, cfg, "cpu", torch.float32), jcfg, jp


def tokens(cfg, b=2, t=SEQ, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, t)).astype(np.int32)


def _leaves(tree):
    return jax.tree.leaves(tree)


# ------------------------------------------------------------------ configs
@pytest.mark.parametrize("family", FAMILIES)
def test_configs_are_served(family):
    """Full and ``-smoke`` names resolve to the JAX package's configs,
    ``check_supported`` takes both, and the params tree has the JAX
    tree's leaves and shapes (router, stacked experts)."""
    for suffix in ("", "-smoke"):
        mine = get_config(family + suffix)
        assert dataclasses.asdict(mine) == dataclasses.asdict(
            jax_get_config(family + suffix))
        check_supported(mine)
    cfg, _, _, jp = model(family)
    assert param_shapes(cfg) == jax.tree.map(lambda a: a.shape, jp)
    plan = layer_plan(cfg)
    assert any(s.mlp == MLP_MOE for s in plan)
    assert any(s.mixer == SSM for s in plan) == (family == JAMBA)


@pytest.mark.parametrize("name", ["deepseek-v2-lite-16b",
                                  "llama-3.2-vision-11b", "whisper-tiny"])
def test_other_architectures_still_refused(name):
    """MLA (deepseek-v2), cross-attention (llama-3.2-vision) and encoders
    (whisper) stay outside the port: ``check_supported`` raises
    ``NotImplementedError`` naming the layers (with two distinct
    unsupported layer kinds, as deepseek-v2's MLA + dense and MLA + MoE,
    it raised ``TypeError`` while sorting them before)."""
    mine = type(get_config("tiny-target"))(**dataclasses.asdict(
        jax_get_config(name + "-smoke")))
    with pytest.raises(NotImplementedError, match="unsupported layers"):
        check_supported(mine)


# ------------------------------------------------------------------ forward
@pytest.mark.parametrize("family", FAMILIES)
def test_forward_logits_match_jax(family):
    """Cache-free, B 2 x T 96: 192 tokens route in one capacity group
    spanning both rows."""
    cfg, tp, jcfg, jp = model(family)
    x = tokens(cfg)
    jl, _, jaux = jax_forward(jax.tree.map(jnp.asarray, jp), jcfg,
                              jnp.asarray(x), dtype=jnp.float32)
    got, _, aux = forward(tp, cfg, torch.from_numpy(x).long(),
                          dtype=torch.float32, return_aux=True)
    v = cfg.vocab_size
    assert got.shape == (2, SEQ, cfg.padded_vocab)
    np.testing.assert_allclose(got[..., :v].numpy(),
                               np.asarray(jl)[..., :v], **TOL)
    assert float(aux) == pytest.approx(float(jaux["load_balance_loss"]),
                                       rel=1e-5)
    assert float(aux) > 0


@pytest.mark.parametrize("family", FAMILIES)
def test_cached_windows_match_jax(family):
    """A 70-token prefill (capacity routing: wider than 64), a 16-token
    window and 10 one-token windows (dropless) on contiguous caches, in
    both packages: logits within 2e-4, window by window."""
    cfg, tp, jcfg, jp = model(family)
    x = tokens(cfg, seed=3)
    caches = init_caches(cfg, 2, SEQ + 16, torch.float32, "cpu")
    jcaches = jax_init_caches(jcfg, 2, SEQ + 16, jnp.float32)
    jparams = jax.tree.map(jnp.asarray, jp)
    t, v = 0, cfg.vocab_size
    for w in [70, 16] + [1] * 10:
        lg, caches = forward(tp, cfg, torch.from_numpy(x[:, t:t + w]).long(),
                             caches=caches, cache_pos=torch.full((2,), t),
                             dtype=torch.float32)
        jl, jcaches, _ = jax_forward(
            jparams, jcfg, jnp.asarray(x[:, t:t + w]), caches=jcaches,
            cache_pos=jnp.full((2,), t, jnp.int32), dtype=jnp.float32)
        np.testing.assert_allclose(lg[..., :v].numpy(),
                                   np.asarray(jl)[..., :v], **TOL)
        t += w


def test_dropless_windows_equal_a_cache_free_forward_without_drops():
    """granite-smoke, B 1 x T 257: an odd token count above the group
    size of 256 routes in groups of one token with one slot per expert,
    so the cache-free forward drops nothing, and windows of at most 64
    rows (dropless) reproduce it."""
    cfg, tp, _, _ = model(GRANITE)
    x = torch.from_numpy(tokens(cfg, b=1, t=257, seed=6)).long()
    free = forward(tp, cfg, x, dtype=torch.float32)[0]
    caches = init_caches(cfg, 1, 264, torch.float32, "cpu")
    outs, t = [], 0
    for w in (64, 64, 64, 41, 1, 23):
        outs.append(forward(tp, cfg, x[:, t:t + w], caches=caches,
                            cache_pos=torch.full((1,), t),
                            dtype=torch.float32)[0])
        t += w
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), free.numpy(),
                               **TOL)


# --------------------------------------------------------------- training
def _grads_match(params, jg):
    grads = params_to_numpy(jax.tree.map(lambda p: p.grad, params))
    for got, want in zip(_leaves(grads), _leaves(jg)):
        want = np.asarray(want)
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * max(np.abs(want).max(), 1e-3))


@pytest.mark.parametrize("family", FAMILIES)
def test_ar_step_matches_jax(family):
    """The AR loss with 0.01 x the load-balance loss and every gradient
    leaf against ``jax.value_and_grad`` of the JAX ``ar_loss``, then one
    ``Trainer`` step (which adds the same term) against the JAX
    ``Trainer``'s."""
    cfg, _, jcfg, jp = model(family)
    x = tokens(cfg, t=SEQ - 16, seed=2)
    jparams = jax.tree.map(jnp.asarray, jp)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jax_ar_loss(p, jcfg, jnp.asarray(x), dtype=jnp.float32,
                              aux_weight=0.01), has_aux=True)(jparams)
    params = params_from_numpy(jp, cfg, "cpu", torch.float32)
    for p in _leaves(params):
        p.requires_grad_(True)
    loss, metrics = ar_loss(params, cfg, torch.from_numpy(x).long(),
                            dtype=torch.float32, aux_weight=0.01)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    nll = float(metrics["nll"].detach())
    assert nll == pytest.approx(float(jm["nll"]), rel=1e-5)
    assert float(loss.detach()) > nll                  # the aux is in
    _grads_match(params, jg)

    tr = Trainer(cfg, AdamW(lr=cosine_schedule(3e-3, 2, 3)), device="cpu")
    jtr = JaxTrainer(jcfg, jax_optimizer.AdamW(
        lr=jax_optimizer.cosine_schedule(3e-3, 2, 3)))
    tparams, _, hist = tr.fit(params_from_numpy(jp, cfg), iter([x]), 1,
                              log_fn=None)
    jparams, _, jhist = jtr.fit(jparams, iter([x]), 1, log_fn=None)
    for key in ("loss", "nll", "grad_norm", "lr"):
        assert hist[0][key] == pytest.approx(jhist[0][key], rel=1e-4), key
    lr = hist[0]["lr"]
    for got, want, g in zip(_leaves(params_to_numpy(tparams)),
                            _leaves(jparams), _leaves(jg)):
        want, g = np.asarray(want), np.abs(np.asarray(g))
        # AdamW's first update is lr g / (|g| + eps): where |g| is float32
        # noise (below 1e-5 of the leaf's largest) so is its sign
        noise = (g > 0) & (g < 1e-5 * g.max())
        bound = np.where(noise, 2 * lr, 1e-4)
        assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


def test_cod_step_matches_jax():
    """granite-smoke: the COD loss, its metrics (the load-balance loss
    reported, not added) and every gradient leaf against the JAX
    ``pard_adaptation_loss``."""
    cfg, _, jcfg, jp = model(GRANITE)
    toks = tokens(cfg, t=48, seed=4)
    packed = pack_batch(toks, CodConfig(*COD), cfg.mask_token_id, seed=0)
    jb = {k: jnp.asarray(v) for k, v in packed.items() if k != "n_tokens"}
    (jl, jm), jg = jax.value_and_grad(
        lambda p: jax_pard_loss(p, jcfg, jb, k_max=COD[0],
                                dtype=jnp.float32), has_aux=True)(
        jax.tree.map(jnp.asarray, jp))
    params = params_from_numpy(jp, cfg, "cpu", torch.float32)
    for p in _leaves(params):
        p.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in packed.items()
             if k != "n_tokens"}
    loss, metrics = pard_adaptation_loss(params, cfg, batch, k_max=COD[0],
                                         dtype=torch.float32)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    assert set(metrics) == set(jm)
    for key, want in jm.items():
        assert float(metrics[key]) == pytest.approx(float(want), rel=1e-5), \
            key
    _grads_match(params, jg)


def test_launcher_trains_granite_smoke():
    hist = launch_train.main(["--arch", GRANITE + "-smoke", "--steps", "3",
                              "--batch", "2", "--seq", "33", "--device",
                              "cpu"])
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert all(h["loss"] > h["nll"] for h in hist)


# ---------------------------------------------------------------- serving
def prompts(cfg):
    rng = np.random.default_rng(5)
    return [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
            for n in (7, 40, 21)]


def port_tokens(family, **kw):
    cfg, tp, _, _ = model(family)
    eng = Engine(tp, cfg, tp, cfg, config=EngineConfig(**{**SMALL, **kw}),
                 device="cpu")
    rids = {eng.submit(p, MAX_NEW): i for i, p in enumerate(prompts(cfg))}
    return eng, {rids[c.rid]: np.asarray(c.tokens) for c in eng.run()}


def jax_engine_tokens(family, **kw):
    cfg, _, jcfg, jp = model(family)
    jparams = jax.tree.map(jnp.asarray, jp)
    eng = JaxEngine(jparams, jcfg, jparams, jcfg,
                    config=JaxEngineConfig(**{**SMALL, **kw}))
    rids = {eng.submit(p, MAX_NEW): i for i, p in enumerate(prompts(cfg))}
    return {rids[c.rid]: np.asarray(c.tokens) for c in eng.run()}


def same(got, want):
    return [bool(np.array_equal(got[i], want[i])) for i in sorted(want)]


@pytest.mark.parametrize("family", FAMILIES)
def test_engine_tokens_match_jax(family, jax_fp32):
    """PARD K 4 on paged KV, the target drafting for itself, 3 requests
    through 2 slots: the port's tokens equal the JAX Engine's, and the
    port's AR equals its PARD."""
    want = jax_engine_tokens(family, mode="pard")
    eng, pard = port_tokens(family, mode="pard")
    _, ar = port_tokens(family, mode="ar")
    assert same(pard, want) == [True] * 3
    assert same(ar, pard) == [True] * 3
    assert eng.mean_accepted() > 1.5


RUNS = {"vsd": dict(mode="vsd"),
        "contiguous pard": dict(mode="pard", kv_layout="contiguous"),
        "tree (2,2,1)": dict(mode="pard", tree=(2, 2, 1)),
        "adaptive tree": dict(mode="pard", adaptive_tree=True),
        "adaptive tree contiguous": dict(mode="pard", adaptive_tree=True,
                                         kv_layout="contiguous"),
        "prefix cache": dict(mode="pard", prefix_cache=True)}


@pytest.mark.parametrize("run", list(RUNS))
def test_granite_paths_equal_ar(run):
    """VSD, contiguous KV, static and adaptive trees and prefix-cache hits
    on granite-smoke give the port's AR tokens: every cached window is
    at most 64 rows, so MoE routing is per token."""
    _, ar = port_tokens(GRANITE, mode="ar")
    eng, got = port_tokens(GRANITE, **RUNS[run])
    assert same(got, ar) == [True] * 3


def test_granite_prefix_cache_warm_equals_cold():
    """Requests sharing a 33-token system prompt: the warm run maps the
    shared blocks and gives the cold run's tokens."""
    cfg, tp, _, _ = model(GRANITE)
    rng = np.random.default_rng(7)
    sys_p = rng.integers(0, cfg.vocab_size, size=33)
    shared = [np.concatenate([sys_p, rng.integers(0, cfg.vocab_size, 5)])
              for _ in range(4)]
    out = {}
    for name, kw in (("cold", {}), ("warm", dict(prefix_cache=True))):
        eng = Engine(tp, cfg, tp, cfg, config=EngineConfig(
            **{**SMALL, "max_batch": 1, **kw}), device="cpu")
        rids = {eng.submit(p, 8): i for i, p in enumerate(shared)}
        out[name] = {rids[c.rid]: c.tokens for c in eng.run()}
        if name == "warm":
            assert eng.prefix_hit_rate() > 0.5
    assert same(out["warm"], out["cold"]) == [True] * 4


def test_jamba_target_under_a_tree_raises():
    cfg, tp, _, _ = model(JAMBA)
    with pytest.raises(NotImplementedError):
        Engine(tp, cfg, tp, cfg, config=EngineConfig(
            **SMALL, mode="pard", tree=(2, 1)), device="cpu")


def test_jamba_contiguous_pard_equals_ar():
    _, ar = port_tokens(JAMBA, mode="ar", kv_layout="contiguous")
    _, pard = port_tokens(JAMBA, mode="pard", kv_layout="contiguous")
    assert same(pard, ar) == [True] * 3


@pytest.mark.parametrize("family", FAMILIES)
def test_serve_launcher_runs_smoke(family, capsys):
    launch_serve.main(["--target", family + "-smoke", "--draft",
                       family + "-smoke", "--device", "cpu", "--requests",
                       "2", "--max-new", "8", "--prompt-len", "24"])
    out = capsys.readouterr().out
    assert "tok/s" in out


def test_adamw_pieces_equal_one_pass(monkeypatch):
    """``AdamW.update`` cuts the leaves into pieces of ``PIECE`` elements
    (to bound its temporaries for granite's 3.3B parameters on one
    card): three steps on granite-smoke's gradients give bit for bit the
    params and moments of one pass over whole leaves."""
    from repro_torch.training import optimizer
    cfg, tp, _, _ = model(GRANITE)
    gen = torch.Generator().manual_seed(0)
    grads = jax.tree.map(lambda p: torch.randn(p.shape, generator=gen), tp)
    out = []
    for piece in (1 << 26, 1000, 77):
        monkeypatch.setattr(optimizer, "PIECE", piece)
        params = jax.tree.map(torch.clone, tp)
        opt = AdamW(lr=1e-2)
        state = opt.init(params)
        for _ in range(3):
            params, state, _ = opt.update(grads, state, params)
        out.append(_leaves(params) + _leaves(state.mu) + _leaves(state.nu))
    for got in out[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out[0], got))
