"""The port's uniform-batch ``SpecDecoder.generate_ar`` / ``generate_spec``
on contiguous caches, on the CPU, against the JAX package's decoder and
against itself.

Both packages run fp32 activations and fp32 KV: the JAX decoder's
forwards default to bf16 activations, so its module-level ``forward`` is
pinned to fp32 (``monkeypatch``, undone after each test). Tokens and the
run statistics are then equal, greedy and at T = 0.8 with a seed: the
port's threefry draws the JAX package's bits. The weights come from the
JAX ``init_params`` and are converted numpy -> torch; each model drafts
for itself, so drafts get accepted (random tiny-draft weights accept
none).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import acceptance as jax_acceptance
from repro.core import spec_decode as jax_sd
from repro.models import forward as jax_forward
from repro.models import init_caches as jax_init_caches
from repro.models import init_params as jax_init_params
from repro.models.config import ModelConfig as JaxModelConfig
from repro_torch.configs import get_config
from repro_torch.core import spec_decode as sd
from repro_torch.interop import params_from_numpy
from repro_torch.models import init_caches, init_params
from repro_torch.models.config import ModelConfig
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import Engine

HYBRID = dict(name="hybrid-test", arch_type="hybrid", num_layers=4,
              attn_every=2, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
              d_ff=128, vocab_size=512, ssm_state=16, ssm_headdim=32,
              ssm_chunk=8, tie_embeddings=True, max_seq_len=1024,
              source="test")
MAX_LEN = 128
MAX_NEW = 16
STAT_FIELDS = ("iterations", "tokens_generated", "draft_forwards",
               "target_forwards")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_fp32(monkeypatch):
    """Pin the JAX decoder's forwards to fp32 activations for one test."""
    monkeypatch.setattr(jax_sd, "forward",
                        functools.partial(jax_forward, dtype=jnp.float32))


@functools.lru_cache(maxsize=None)
def model(name):
    """(port cfg, port fp32 params, JAX cfg, JAX params) of one model:
    tiny-target from PRNGKey(0), tiny-ssm and the dense hybrid from
    PRNGKey(3)."""
    if name == "hybrid":
        cfg, jcfg = ModelConfig(**HYBRID), JaxModelConfig(**HYBRID)
    else:
        cfg, jcfg = get_config(name), jax_get_config(name)
    seed = 0 if name == "tiny-target" else 3
    jp = jax.jit(jax_init_params, static_argnums=1)(
        jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu",
                           torch.float32)
    return cfg, tp, jcfg, jp


def decoders(name, temperature=0.0, tree=None):
    """The port's and the JAX package's decoders at ``temperature``, the
    model ``name`` drafting for itself (so drafts get accepted), K = 4 (a
    tree's depth), fp32 KV on contiguous caches. ``tree``: "static" (2,
    2, 1) or "bank" (the default bank at depth 4). The pair is kept across
    tests (both read their temperature at each call), so each JAX decoder
    compiles its prefills and steps once."""
    pair = _decoders(name, tree)
    for dec in pair:
        dec.temperature = temperature
    return pair


@functools.lru_cache(maxsize=None)
def _decoders(name, tree):
    cfg, params, jcfg, jparams = model(name)
    mine_tree = theirs_tree = None
    if tree == "static":
        mine_tree = theirs_tree = (2, 2, 1)
    elif tree == "bank":
        mine_tree = sd.TemplateBank.default(4)
        theirs_tree = jax_sd.TemplateBank.default(4)
    kw = dict(k=4, max_len=MAX_LEN, kv_dtype="fp32")
    mine = sd.SpecDecoder(params, cfg, params, cfg, kv_block_size=0,
                          tree=mine_tree, **kw)
    theirs = jax_sd.SpecDecoder(jparams, jcfg, jparams, jcfg,
                                tree=theirs_tree, **kw)
    return mine, theirs


def port_pair(dtype=torch.float32):
    """tiny-target and tiny-draft with the port's own random weights (the
    checks inside the port)."""
    tc, dc = get_config("tiny-target"), get_config("tiny-draft")
    return (tc, init_params(tc, 0, "cpu", dtype),
            dc, init_params(dc, 1, "cpu", dtype))


def prompt(b=2, p=12, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (b, p)).astype(
        np.int32)


def assert_same_run(mine, theirs):
    """Equal tokens, forward counts and histograms; mean accepted within
    1e-6."""
    (t_m, s_m), (t_j, s_j) = mine, theirs
    np.testing.assert_array_equal(t_m.numpy(), np.asarray(t_j))
    for f in STAT_FIELDS:
        assert getattr(s_m, f) == getattr(s_j, f), f
    if s_j.accept_hist is None:
        assert s_m.accept_hist is None
    else:
        np.testing.assert_array_equal(s_m.accept_hist,
                                      np.asarray(s_j.accept_hist))
    if s_j.round_hist is not None:
        np.testing.assert_array_equal(s_m.round_hist,
                                      np.asarray(s_j.round_hist))
    assert abs(s_m.mean_accepted - s_j.mean_accepted) <= 1e-6
    assert abs(s_m.acceptance_rate - s_j.acceptance_rate) <= 1e-6


# ------------------------------------------------------------ against JAX
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_generate_ar_matches_jax(temperature, jax_fp32):
    mine, theirs = decoders("tiny-target", temperature)
    x = prompt()
    assert_same_run(mine.generate_ar(x, MAX_NEW, seed=5),
                    theirs.generate_ar(jnp.asarray(x), MAX_NEW, seed=5))


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("mode", ["pard", "vsd"])
def test_generate_spec_flat_matches_jax(mode, temperature, jax_fp32):
    mine, theirs = decoders("tiny-target", temperature)
    x = prompt(seed=1)
    got = mine.generate_spec(x, MAX_NEW, mode=mode, seed=7)
    assert_same_run(got, theirs.generate_spec(jnp.asarray(x), MAX_NEW,
                                              mode=mode, seed=7))
    assert got[1].mean_accepted > 1.5         # drafts do get accepted
    if temperature and mode == "pard":        # and rejected
        assert got[1].accept_hist[-1] < got[1].accept_hist[0]


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("tree", ["static", "bank"])
def test_generate_spec_tree_matches_jax(tree, temperature, jax_fp32):
    """A static (2, 2, 1) tree, and the default bank at depth 4 with a
    per-row ``tree_idx``; the target drafts for itself."""
    mine, theirs = decoders("tiny-target", temperature, tree)
    idx = [1, 2] if tree == "bank" else None
    x = prompt(seed=2)
    got = mine.generate_spec(x, MAX_NEW, seed=11, tree_idx=idx)
    assert_same_run(got, theirs.generate_spec(jnp.asarray(x), MAX_NEW,
                                              seed=11, tree_idx=idx))
    assert got[1].round_hist.shape == (mine.tree.max_branching,)


@pytest.mark.parametrize("name", ["tiny-ssm", "hybrid"])
@pytest.mark.parametrize("mode", ["ar", "pard"])
def test_ssm_generate_matches_jax(mode, name, jax_fp32):
    """Mamba2 and the dense hybrid drafting for themselves: AR and flat
    PARD tokens and stats equal to the JAX decoder's."""
    mine, theirs = decoders(name)
    x = prompt(seed=3)
    if mode == "ar":
        assert_same_run(mine.generate_ar(x, MAX_NEW),
                        theirs.generate_ar(jnp.asarray(x), MAX_NEW))
    else:
        assert_same_run(mine.generate_spec(x, MAX_NEW, mode=mode),
                        theirs.generate_spec(jnp.asarray(x), MAX_NEW,
                                             mode=mode))


def test_init_state_matches_jax():
    """The contiguous DecodeState: counters, buffer, caches and each row's
    threefry key (bit for bit) from (seed, b)."""
    mine, theirs = decoders("tiny-target", 0.8)
    x = prompt(b=3, p=9)
    got = mine.init_state(x, 40, seed=13)
    want = theirs.init_state(jnp.asarray(x), 40, seed=13)
    for f in ("gen", "n", "m", "done", "temp", "pf_pos", "pf_len"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), f)
    np.testing.assert_array_equal(
        got.rngs.numpy(), np.asarray(want.rngs).astype(np.int64))
    np.testing.assert_array_equal(
        got.rngs.numpy(),
        np.asarray(jax_acceptance.make_row_keys(13, np.arange(3))).astype(
            np.int64))
    assert got.tree_idx is None and got.dcache is not None
    assert mine.init_state(x, 40, with_draft=False).dcache is None
    k_m = got.tcache["scan"][0]["k"]
    assert k_m.shape == tuple(want.tcache["scan"][0]["k"].shape)
    assert k_m.dtype == torch.float32 and not k_m.any()


def _cache_leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _cache_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _cache_leaves(v)]
    return [np.asarray(tree, np.float32)]


@pytest.mark.parametrize("name,plen", [("tiny-target", None),
                                       ("tiny-ssm", 5), ("hybrid", None),
                                       ("hybrid", 5)])
def test_prefill_row_matches_jax(name, plen):
    """Every cache leaf within 1e-5 of the JAX prefill; with ``plen`` a
    Mamba2 state is the one after token plen - 1 of a right-padded row."""
    cfg, tp, jcfg, jp = model(name)
    toks = prompt(b=2, p=9, seed=4)
    caches = init_caches(cfg, 2, 32, "fp32", "cpu")
    sd.prefill_row(tp, cfg, torch.from_numpy(toks).long(), plen, caches)
    jc = jax_init_caches(jcfg, 2, 32, dtype=jnp.float32)
    fwd = functools.partial(jax_forward, dtype=jnp.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_sd, "forward", fwd)
        jc = jax.jit(jax_sd.prefill_row, static_argnums=(1, 3))(
            jp, jcfg, jnp.asarray(toks), plen, jc)
    got, want = _cache_leaves(caches), _cache_leaves(jc)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)
    if plen is not None:
        short = init_caches(cfg, 2, 32, "fp32", "cpu")
        sd.prefill_row(tp, cfg, torch.from_numpy(toks[:, :plen]).long(),
                       None, short)
        for g, w in zip(sd.ssm_leaves(cfg, caches), sd.ssm_leaves(cfg, short)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                       atol=1e-5)


# --------------------------------------------------------- inside the port
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_greedy_spec_equals_ar(dtype):
    """Greedy PARD, VSD, a tree and the bank are lossless against AR, in
    fp32 and in bf16 (bf16 params and KV)."""
    tc, tp, dc, dp = port_pair(dtype)
    kv = "fp32" if dtype == torch.float32 else "bf16"
    x = prompt(b=2, p=10, seed=6)
    ar, _ = sd.SpecDecoder(tp, tc, dp, dc, k=4, max_len=MAX_LEN,
                           kv_block_size=0,
                           kv_dtype=kv).generate_ar(x, MAX_NEW)
    for mode, tree, idx in (("pard", None, None), ("vsd", None, None),
                            ("pard", (2, 2, 1, 1), None),
                            ("pard", sd.TemplateBank.default(4), [2, 1])):
        dec = sd.SpecDecoder(tp, tc, dp, dc, k=4, max_len=MAX_LEN,
                             kv_block_size=0, kv_dtype=kv, tree=tree)
        got, st = dec.generate_spec(x, MAX_NEW, mode=mode, tree_idx=idx)
        assert torch.equal(got, ar), (mode, tree)
        assert st.tokens_generated == 2 * MAX_NEW
        assert st.draft_forwards == (4 if mode == "vsd" else 1) * st.iterations


@pytest.mark.parametrize("name", ["tiny-ssm", "hybrid"])
@pytest.mark.parametrize("mode", ["pard", "vsd"])
def test_ssm_greedy_spec_equals_ar(mode, name):
    """Mamba2 and the dense hybrid drafting for themselves: greedy flat
    PARD and VSD tokens equal AR tokens, drafts get accepted, and the VSD
    proposals leave no trace in the draft's recurrent state."""
    cfg, tp, _, _ = model(name)
    dec = sd.SpecDecoder(tp, cfg, tp, cfg, k=4, max_len=MAX_LEN,
                         kv_block_size=0, kv_dtype="fp32")
    x = prompt(b=2, p=11, seed=9)
    ar, _ = dec.generate_ar(x, MAX_NEW)
    got, st = dec.generate_spec(x, MAX_NEW, mode=mode)
    assert torch.equal(got, ar)
    assert st.mean_accepted > 1.5


@pytest.mark.parametrize("name", ["tiny-ssm", "hybrid"])
def test_ar_engine_equals_generate_ar(name):
    """The port's AR engine (paged and contiguous) on a Mamba2 model gives
    exactly the port's own generate_ar tokens, request by request."""
    cfg, tp, _, _ = model(name)
    prompts = [prompt(b=1, p=p, seed=7 + p)[0] for p in (7, 13, 20)]
    dec = sd.SpecDecoder(tp, cfg, max_len=MAX_LEN, kv_block_size=0,
                         kv_dtype="fp32")
    want = [dec.generate_ar(p[None], MAX_NEW)[0][0].numpy() for p in prompts]
    for layout in ("paged", "contiguous"):
        eng = Engine(tp, cfg, config=EngineConfig(
            mode="ar", max_batch=2, max_len=MAX_LEN, kv_block_size=16,
            kv_dtype="fp32", kv_layout=layout), device="cpu")
        rids = {eng.submit(p, MAX_NEW): i for i, p in enumerate(prompts)}
        got = {rids[c.rid]: c.tokens for c in eng.run()}
        for i, w in enumerate(want):
            np.testing.assert_array_equal(got[i], w, err_msg=layout)


def test_sampled_runs_repeat_and_depend_on_the_seed():
    mine, _ = decoders("tiny-target", 0.8)
    x = prompt(seed=8)
    a, _ = mine.generate_spec(x, MAX_NEW, seed=1)
    b, _ = mine.generate_spec(x, MAX_NEW, seed=1)
    c, _ = mine.generate_spec(x, MAX_NEW, seed=2)
    assert torch.equal(a, b) and not torch.equal(a, c)


def test_generate_refuses_what_it_does_not_serve():
    tc, tp, dc, dp = port_pair()
    x = prompt()
    paged = sd.SpecDecoder(tp, tc, dp, dc, k=4, kv_block_size=16)
    with pytest.raises(ValueError, match="contiguous"):
        paged.generate_ar(x, 4)
    with pytest.raises(ValueError, match="contiguous"):
        paged.generate_spec(x, 4)
    flat = sd.SpecDecoder(tp, tc, dp, dc, k=4, kv_block_size=0)
    with pytest.raises(ValueError, match="tree_idx"):
        flat.generate_spec(x, 4, tree_idx=[0, 0])
    with pytest.raises(ValueError, match="mode"):
        flat.generate_spec(x, 4, mode="eagle")
    with pytest.raises(ValueError, match="2 tokens"):
        flat.generate_spec(x[:, :1], 4)
    with pytest.raises(ValueError, match="draft"):
        sd.SpecDecoder(tp, tc, kv_block_size=0).generate_spec(x, 4)
    tree = sd.SpecDecoder(tp, tc, dp, dc, kv_block_size=0, tree=(2, 1))
    with pytest.raises(ValueError, match="mode='pard'"):
        tree.generate_spec(x, 4, mode="vsd")
    with pytest.raises(ValueError, match="tree_idx"):
        tree.generate_spec(x, 4, tree_idx=[0, 1])
    ssm_cfg, ssm_p, _, _ = model("tiny-ssm")
    with pytest.raises(NotImplementedError):
        sd.SpecDecoder(ssm_p, ssm_cfg, ssm_p, ssm_cfg, kv_block_size=0,
                       tree=(2, 1))
