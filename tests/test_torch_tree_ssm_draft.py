"""Tree drafting with a Mamba2 (``tiny-ssm``) or dense-hybrid draft under a
dense target (``tiny-target``), in the port on the CPU, against the JAX
package and against AR.

Both packages run fp32 activations and fp32 KV: the JAX decoder's module
``forward`` is pinned to fp32 for this module (restored after it). The
port's threefry keys draw the JAX package's bits, so tokens are equal
greedy and at T = 0.8, through ``SpecDecoder.generate_spec`` (a static
(2, 2, 1, 1) tree and the default bank at depth 4) and through the
``Engine`` (paged and contiguous KV, the static tree and the adaptive
bank). Each engine batch mixes a greedy request with two sampled ones;
``max_batch=2`` with 3 requests recycles a slot, whose draft state must be
cleared at admission. Greedy tokens equal the target's ``generate_ar``.
The tree step leaves the draft's recurrent state after the last real
token of its window (slot A - 1), which a prefill of the committed tokens
reproduces within 1e-5. An SSM or hybrid *target* under a tree stays
refused by both packages.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import spec_decode as jax_sd
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models.config import ModelConfig as JaxModelConfig
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.config import SamplingParams as JaxSamplingParams
from repro.serving.engine import Engine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.core import spec_decode as sd
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import init_caches
from repro_torch.models.config import ModelConfig
from repro_torch.serving.config import EngineConfig, SamplingParams
from repro_torch.serving.engine import Engine

HYBRID = dict(name="hybrid-test", arch_type="hybrid", num_layers=4,
              attn_every=2, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
              d_ff=128, vocab_size=512, ssm_state=16, ssm_headdim=32,
              ssm_chunk=8, tie_embeddings=True, max_seq_len=1024,
              source="test")
T = 0.8
MAX_NEW = 16
MAX_LEN = 128
SMALL = dict(max_batch=2, max_len=256, kv_block_size=16, kv_dtype="fp32",
             seed=5)
TREES = {"static": dict(tree=(2, 2, 1, 1)),
         "adaptive": dict(adaptive_tree=True, k=4)}
STAT_FIELDS = ("iterations", "tokens_generated", "draft_forwards",
               "target_forwards")


@pytest.fixture(autouse=True, scope="module")
def _one_thread_and_fp32_jax():
    """One torch thread, and the JAX decoder's forwards in fp32, for this
    module only."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_sd, "forward",
               functools.partial(jax_forward, dtype=jnp.float32))
    yield
    mp.undo()
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def model(name):
    """(port cfg, port fp32 params, JAX cfg, JAX params): tiny-target from
    PRNGKey(0), the drafts from PRNGKey(3)."""
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


def _banks(tree):
    if tree == "static":
        return (2, 2, 1, 1), (2, 2, 1, 1)
    return sd.TemplateBank.default(4), jax_sd.TemplateBank.default(4)


@functools.lru_cache(maxsize=None)
def _decoders(draft, tree):
    tc, tp, jtc, jtp = model("tiny-target")
    dc, dp, jdc, jdp = model(draft)
    mine_tree, theirs_tree = _banks(tree)
    kw = dict(k=4, max_len=MAX_LEN, kv_dtype="fp32")
    mine = sd.SpecDecoder(tp, tc, dp, dc, kv_block_size=0, tree=mine_tree,
                          **kw)
    theirs = jax_sd.SpecDecoder(jtp, jtc, jdp, jdc, tree=theirs_tree, **kw)
    return mine, theirs


def decoders(draft, tree, temperature):
    """The port's and the JAX package's decoders; kept across tests (both
    read their temperature at each call), so each JAX decoder compiles its
    prefills and steps once."""
    pair = _decoders(draft, tree)
    for dec in pair:
        dec.temperature = temperature
    return pair


def prompt(b=2, p=12, seed=0):
    return np.random.default_rng(seed).integers(0, 512, (b, p)).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def target_ar(b=2, p=12, seed=0):
    return ar_decoder().generate_ar(prompt(b, p, seed), MAX_NEW)[0]


@functools.lru_cache(maxsize=None)
def ar_decoder():
    tc, tp, _, _ = model("tiny-target")
    return sd.SpecDecoder(tp, tc, k=4, max_len=MAX_LEN, kv_block_size=0,
                          kv_dtype="fp32")


def assert_same_run(mine, theirs):
    (t_m, s_m), (t_j, s_j) = mine, theirs
    np.testing.assert_array_equal(t_m.numpy(), np.asarray(t_j))
    for f in STAT_FIELDS:
        assert getattr(s_m, f) == getattr(s_j, f), f
    np.testing.assert_array_equal(s_m.accept_hist, np.asarray(s_j.accept_hist))
    np.testing.assert_array_equal(s_m.round_hist, np.asarray(s_j.round_hist))
    assert abs(s_m.mean_accepted - s_j.mean_accepted) <= 1e-6


# ------------------------------------------------------------ generate_spec
# a JAX decoder compiles a step per tree and sampling mode, so the JAX
# side takes three cells here and two engine cells below: each draft, tree
# kind, layout and temperature meets JAX at least once
@pytest.mark.parametrize("draft,tree,temperature", [
    ("tiny-ssm", "static", 0.0), ("tiny-ssm", "bank", T),
    ("hybrid", "static", T)])
def test_generate_spec_tree_matches_jax(draft, tree, temperature):
    """Tokens and stats equal to the JAX decoder's; greedy tokens equal
    the target's AR tokens."""
    mine, theirs = decoders(draft, tree, temperature)
    idx = [1, 2] if tree == "bank" else None
    x = prompt()
    got = mine.generate_spec(x, MAX_NEW, seed=11, tree_idx=idx)
    assert_same_run(got, theirs.generate_spec(jnp.asarray(x), MAX_NEW,
                                              seed=11, tree_idx=idx))
    if temperature == 0.0:
        np.testing.assert_array_equal(got[0].numpy(), target_ar().numpy())
    else:                       # sampled drafts do get accepted
        assert got[1].mean_accepted > 1.2


@pytest.mark.parametrize("tree", ["static", "bank"])
@pytest.mark.parametrize("draft", ["tiny-ssm", "hybrid"])
def test_generate_spec_tree_greedy_equals_ar(draft, tree):
    """Inside the port, every pair of draft and tree: greedy tokens equal
    the target's AR tokens, on rows pinned to different templates."""
    mine, _ = decoders(draft, tree, 0.0)
    idx = [2, 0] if tree == "bank" else None
    got, stats = mine.generate_spec(prompt(), MAX_NEW, tree_idx=idx)
    np.testing.assert_array_equal(got.numpy(), target_ar().numpy())
    assert stats.target_forwards == stats.iterations


@pytest.mark.parametrize("draft", ["tiny-ssm", "hybrid"])
def test_tree_step_leaves_the_draft_state_after_the_last_real_token(draft):
    """After every tree step the draft's Mamba2 states equal those of a
    prefill of the committed tokens 0 .. m - 1 (m: the step's old n), as
    the reference's ``_pard_depth_logits`` leaves them; at T = 0.8 so that
    drafts get accepted and the rows' counts diverge."""
    mine, _ = decoders(draft, "static", T)
    dc, dp = mine.dc, mine.dp
    x = torch.from_numpy(prompt(b=3, seed=4)).long()
    state = mine.init_state(x, MAX_LEN, seed=2)
    sd.prefill_row(mine.tp, mine.tc, x[:, :-1], None, state.tcache)
    sd.prefill_row(dp, dc, x[:, :-1], None, state.dcache)
    step = mine._build_tree_step()
    accepted = 0
    for _ in range(6):
        state, a, _ = step(state)
        accepted += int(a.sum())
        ref = init_caches(dc, 3, MAX_LEN, "fp32", "cpu")
        m = state.m
        toks = state.gen[:, :int(m.max())]
        sd.prefill_row(dp, dc, toks, m, ref)
        for got, want in zip(sd.ssm_leaves(dc, state.dcache),
                             sd.ssm_leaves(dc, ref)):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=1e-5)
    assert accepted > 0


# ------------------------------------------------------------------ engine
def prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 512, size=n).astype(np.int32) for n in (7, 13, 20)]


def request_params(sp_cls):
    """Greedy, the engine's (seed, rid) stream at T, and a seed of its
    own at T."""
    return [sp_cls(max_new=MAX_NEW, temperature=0.0),
            sp_cls(max_new=MAX_NEW, temperature=T),
            sp_cls(max_new=MAX_NEW, temperature=T, seed=11)]


def serve_port(draft, layout, tree):
    tc, tp, _, _ = model("tiny-target")
    dc, dp, _, _ = model(draft)
    eng = Engine(tp, tc, dp, dc, config=EngineConfig(
        kv_layout=layout, **TREES[tree], **SMALL), device="cpu")
    rids = {eng.submit(p, params=spm): i for i, (p, spm) in
            enumerate(zip(prompts(), request_params(SamplingParams)))}
    return eng, {rids[c.rid]: np.asarray(c.tokens) for c in eng.run()}


def serve_jax(draft, layout, tree):
    _, _, jtc, jtp = model("tiny-target")
    _, _, jdc, jdp = model(draft)
    eng = JaxEngine(jtp, jtc, jdp, jdc, config=JaxEngineConfig(
        kv_layout=layout, **TREES[tree], **SMALL))
    rids = {eng.submit(p, params=spm): i for i, (p, spm) in
            enumerate(zip(prompts(), request_params(JaxSamplingParams)))}
    return {rids[c.rid]: np.asarray(c.tokens) for c in eng.run()}


@functools.lru_cache(maxsize=None)
def engine_ar():
    return ar_decoder().generate_ar(prompts()[0][None],
                                    MAX_NEW)[0][0].numpy()


# the port serves every combination of draft, layout and tree below and
# must agree with itself across layouts
JAX_CELLS = [("tiny-ssm", "paged", "static"),
             ("hybrid", "contiguous", "adaptive")]


@pytest.mark.parametrize("draft,layout,tree", JAX_CELLS)
def test_engine_tree_tokens_match_jax(draft, layout, tree):
    eng, mine = serve_port(draft, layout, tree)
    theirs = serve_jax(draft, layout, tree)
    for i in range(3):
        np.testing.assert_array_equal(mine[i], theirs[i], err_msg=str(i))
    np.testing.assert_array_equal(mine[0], engine_ar())
    assert all(len(mine[i]) == len(p) + MAX_NEW
               for i, p in enumerate(prompts()))
    assert eng.stats["draft_forwards"] == eng.stats["steps"]


@pytest.mark.parametrize("tree", ["static", "adaptive"])
@pytest.mark.parametrize("draft", ["tiny-ssm", "hybrid"])
def test_engine_tree_layouts_agree(draft, tree):
    """Paged and contiguous KV give the same tokens, greedy and sampled;
    the greedy request equals AR."""
    _, paged = serve_port(draft, "paged", tree)
    _, contiguous = serve_port(draft, "contiguous", tree)
    for i in range(3):
        np.testing.assert_array_equal(paged[i], contiguous[i], err_msg=str(i))
    np.testing.assert_array_equal(paged[0], engine_ar())


# ---------------------------------------------------------------- refusals
@pytest.mark.parametrize("target", ["tiny-ssm", "hybrid"])
def test_ssm_target_under_a_tree_still_raises(target):
    cfg, params, jcfg, jparams = model(target)
    with pytest.raises(NotImplementedError, match="SSM/hybrid target"):
        sd.SpecDecoder(params, cfg, params, cfg, tree=(2, 1))
    with pytest.raises(NotImplementedError, match="SSM/hybrid target"):
        Engine(params, cfg, params, cfg,
               config=EngineConfig(tree=(2, 1), **SMALL), device="cpu")
    with pytest.raises(NotImplementedError, match="SSM/hybrid target"):
        jax_sd.SpecDecoder(jparams, jcfg, jparams, jcfg, tree=(2, 1))


def test_draft_vocab_mismatch_still_raises():
    tc, tp, _, _ = model("tiny-target")
    dc = ModelConfig(**{**HYBRID, "vocab_size": 500})
    with pytest.raises(ValueError, match="shared vocab"):
        sd.SpecDecoder(tp, tc, None, dc, tree=(2, 1))


def test_serve_launcher_runs_an_ssm_draft_under_trees(capsys):
    """``--draft tiny-ssm --tree 2,2,1,1`` and ``--adaptive-tree`` serve
    every request on the CPU."""
    base = ["--target", "tiny-target", "--draft", "tiny-ssm", "--requests",
            "3", "--max-new", "8", "--device", "cpu"]
    for extra in (["--tree", "2,2,1,1"], ["--adaptive-tree", "--k", "4",
                                          "--contiguous"]):
        comps = serve.main(base + extra)
        assert len(comps) == 3 and all(len(c.tokens) > 8 for c in comps)
    out = capsys.readouterr().out
    assert "tree bank=2x2x1x1" in out and "tree_hist=" in out
