"""The port's serving stack on the CPU: kv_pool, EngineConfig, the step
windows, and the engine end to end against itself (PARD == AR) and
against the JAX package's Engine.

Token parity with the JAX Engine: the JAX Engine always runs its forwards
in bf16 activations (XLA's CPU kernels); the port's bf16 engine rounds its
bf16 products in oneDNN's order instead. With random tiny weights some
argmaxes are near ties, and one flip makes a request's later tokens
diverge. The floor is therefore a share of tokens up to the first
divergence, 0.5 over the batch (measured: 0.89 on this batch); exact
equality is asserted where it is promised — PARD against AR inside the
port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import spec_decode as jax_sd
from repro.models import init_params as jax_init_params
from repro.serving import config as jax_config
from repro.serving import kv_pool as jax_kv_pool
from repro.serving.engine import Engine as JaxEngine
from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.core import spec_decode as sd
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve
from repro_torch.serving import kv_pool
from repro_torch.serving.config import EngineConfig, SamplingParams
from repro_torch.serving.engine import Engine

MATCH_FLOOR = 0.5


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_models():
    tc, dc = jax_get_config("tiny-target"), jax_get_config("tiny-draft")
    return (tc, jax_init_params(jax.random.PRNGKey(0), tc),
            dc, jax_init_params(jax.random.PRNGKey(1), dc))


def _port_models(jax_models, dtype):
    _, tp, _, dp = jax_models
    tc, dc = get_config("tiny-target"), get_config("tiny-draft")
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return (tc, params_from_numpy(to_np(tp), tc, "cpu", dtype),
            dc, params_from_numpy(to_np(dp), dc, "cpu", dtype))


def _prompts(seed, n, lo=4, hi=30):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, size=int(k)).astype(np.int32)
            for k in rng.integers(lo, hi, size=n)]


def _serve(models, prompts, max_new=12, **cfg):
    tc, tp, dc, dp = models
    eng = Engine(tp, tc, dp, dc, config=EngineConfig(**cfg), device="cpu")
    rids = {eng.submit(p, max_new): i for i, p in enumerate(prompts)}
    comps = eng.run()
    return eng, {rids[c.rid]: c.tokens for c in comps}


SMALL = dict(k=4, max_batch=2, max_len=256, kv_block_size=16)


# ------------------------------------------------------------------ kv_pool
def test_block_math_matches_jax():
    for n, bs in ((1, 64), (64, 64), (65, 64), (402, 16)):
        assert kv_pool.blocks_for(n, bs) == jax_kv_pool.blocks_for(n, bs)
    assert kv_pool.default_num_blocks(4, 1024, 64) == \
        jax_kv_pool.default_num_blocks(4, 1024, 64) == 65


def test_allocator_matches_jax():
    mine = kv_pool.BlockAllocator(12, 8, 3, 64)
    theirs = jax_kv_pool.BlockAllocator(12, 8, 3, 64)
    for op, slot, n in (("a", 0, 20), ("a", 1, 9), ("r", 0, 0), ("a", 2, 30),
                        ("a", 0, 8), ("r", 1, 0), ("a", 1, 17)):
        for alloc in (mine, theirs):
            if op == "a":
                assert alloc.can_allocate(alloc.blocks_needed(n))
                alloc.allocate(slot, n)
            else:
                alloc.release(slot)
        np.testing.assert_array_equal(mine.tables, theirs.tables)
        assert mine.blocks_in_use == theirs.blocks_in_use
        assert mine.version == theirs.version
    assert not mine.can_allocate(5)
    with pytest.raises(ValueError):
        mine.allocate(2, 8)                        # slot already allocated
    with pytest.raises(ValueError):
        kv_pool.BlockAllocator(50, 8, 1, 64).allocate(0, 65)   # past max_len


def test_paged_caches_match_jax_layout():
    cfg, jcfg = get_config("tiny-target"), jax_get_config("tiny-target")
    mine = kv_pool.init_paged_caches(cfg, 2, 9, 8, torch.bfloat16, "cpu")
    theirs = jax_kv_pool.init_paged_caches(jcfg, 2, 9, 8, jnp.bfloat16)
    assert jax.tree.map(lambda t: tuple(t.shape), mine,
                        is_leaf=lambda x: isinstance(x, torch.Tensor)) == \
        jax.tree.map(lambda a: tuple(a.shape), theirs)
    assert kv_pool.kv_capacity_bytes(mine) == \
        jax_kv_pool.kv_capacity_bytes(jcfg, theirs)
    assert kv_pool.kv_bytes_per_block(mine, 9) == \
        jax_kv_pool.kv_bytes_per_block(jcfg, theirs, 9)


# ------------------------------------------------------------------ config
def test_engine_config_defaults_match_jax():
    mine, theirs = EngineConfig(), jax_config.EngineConfig()
    for f in dataclasses.fields(mine):
        assert getattr(mine, f.name) == getattr(theirs, f.name), f.name
    assert SamplingParams().max_new is None


@pytest.mark.parametrize("kw", [
    dict(mode="vsd", tp=2), dict(tree=(2, 2), tp=2),
    dict(prefix_cache=True, dp=2), dict(tp=2), dict(dp=2),
    dict(temperature=0.7, dp=2)])
def test_engine_config_outside_the_slice_raises(kw):
    """tp / dp > 1 still raise, with sampling, VSD, trees or the prefix
    cache (all in the port's slices) or without."""
    with pytest.raises(NotImplementedError):
        EngineConfig(**kw)


@pytest.mark.parametrize("kw", [
    dict(kv_layout="contiguous", kv_dtype="int8"), dict(kv_dtype="int8"),
    dict(kv_dtype="fp8", tree=(2, 1))])
def test_quantized_kv_configs_serve(jax_models, kw):
    """int8 / fp8 KV construct and serve: every request completes with
    tokens inside the vocab, and the caches hold 8-bit codes beside f32
    scales."""
    models = _port_models(jax_models, torch.float32)
    prompts = _prompts(9, 3)
    eng, toks = _serve(models, prompts, max_new=6, **dict(SMALL, **kw))
    leaf = eng.ex.state.tcache["scan"][0]
    assert leaf["k"].dtype == (torch.int8 if kw["kv_dtype"] == "int8"
                               else torch.float8_e4m3fn)
    assert leaf["k_scale"].dtype == torch.float32
    assert leaf["k_scale"].shape == leaf["k"].shape[:-1]
    for i, p in enumerate(prompts):
        assert len(toks[i]) == len(p) + 6
        assert 0 <= toks[i].min() and toks[i].max() < 512


def test_engine_config_validates():
    for kw in (dict(mode="x"), dict(k=0), dict(kv_dtype="fp16"),
               dict(temperature=-0.5)):
        with pytest.raises(ValueError):
            EngineConfig(**kw)
    assert SamplingParams(max_new=4, temperature=0.5, seed=3).seed == 3
    with pytest.raises(ValueError):
        SamplingParams(max_new=4, temperature=-0.5)


# ----------------------------------------------------------- step windows
def test_windows_match_jax():
    rng = np.random.default_rng(5)
    gen = rng.integers(0, 500, (4, 40))
    n = np.array([10, 39, 5, 20])
    m = np.array([7, 30, 4, 20 - 9])
    pf = np.array([0, 8, 33, 3])
    cl = np.array([9, 2, 7, 0])
    t = [torch.from_numpy(x) for x in (gen, n, m, pf, cl)]
    j = [jnp.asarray(x.astype(np.int32)) for x in (gen, n, m, pf, cl)]
    np.testing.assert_array_equal(
        sd._draft_window(t[0], t[1], t[2], 8, 512).numpy(),
        np.asarray(jax_sd._draft_window(j[0], j[1], j[2], 8, 512)))
    np.testing.assert_array_equal(
        sd._chunk_window(t[0], t[3], t[4], 9).numpy(),
        np.asarray(jax_sd._chunk_window(j[0], j[3], j[4], 9)))


def test_window_sizes_match_jax(jax_models):
    tc, tp, dc, dp = _port_models(jax_models, torch.float32)
    jtc, jtp, jdc, jdp = jax_models
    for k, chunk in ((8, 8), (4, 3)):
        for with_draft in (True, False):
            mine = sd.SpecDecoder(tp, tc, dp if with_draft else None,
                                  dc if with_draft else None, k=k,
                                  prefill_chunk=chunk)
            theirs = jax_sd.SpecDecoder(jtp, jtc, jdp if with_draft else None,
                                        jdc if with_draft else None, k=k,
                                        prefill_chunk=chunk, kv_block_size=64)
            assert (mine.window_slack, mine.chunk_width) == \
                (theirs.window_slack, theirs.chunk_width)


# ------------------------------------------------------------------ engine
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pard_equals_ar(jax_models, dtype):
    """Greedy PARD is lossless: token-identical to AR inside the port."""
    models = _port_models(jax_models, dtype)
    prompts = _prompts(2, 6)
    kernels.launches.clear()
    eng, pard = _serve(models, prompts, mode="pard", **SMALL)
    _, ar = _serve(models, prompts, mode="ar", **SMALL)
    assert kernels.launches["decode_attention_paged"] == 0   # plain path
    assert eng.stats["draft_forwards"] == eng.stats["steps"]
    for i, p in enumerate(prompts):
        assert len(pard[i]) == len(p) + 12
        np.testing.assert_array_equal(pard[i], ar[i])


@pytest.mark.parametrize("mode", ["pard", "ar"])
def test_prefill_steps_counts_steps_with_a_prefilling_row(jax_models, mode):
    """``stats["prefill_steps"]``: the steps in which some row consumed a
    prompt chunk (the AR engine's wide windows)."""
    models = _port_models(jax_models, torch.float32)
    prompt = _prompts(3, 1, lo=20, hi=21)
    eng, _ = _serve(models, prompt, max_new=5, mode=mode, **SMALL)
    want = -(-(len(prompt[0]) - 1) // eng.sched.chunk)
    assert eng.stats["prefill_steps"] == want
    assert eng.stats["prefill_chunks"] == want
    assert eng.stats["steps"] > want


def test_matches_jax_engine(jax_models):
    prompts = _prompts(2, 6)
    jtc, jtp, jdc, jdp = jax_models
    jeng = JaxEngine(jtp, jtc, jdp, jdc,
                     config=jax_config.EngineConfig(mode="pard", **SMALL))
    rids = {jeng.submit(p, 12): i for i, p in enumerate(prompts)}
    want = {rids[c.rid]: c.tokens for c in jeng.run()}
    _, got = _serve(_port_models(jax_models, torch.bfloat16), prompts,
                    mode="pard", **SMALL)
    shares = []
    for i, p in enumerate(prompts):
        a, b = got[i][len(p):], want[i][len(p):]
        np.testing.assert_array_equal(got[i][:len(p)], p)
        diff = np.nonzero(a != b)[0]
        shares.append((diff[0] if diff.size else len(a)) / len(a))
    assert np.mean(shares) >= MATCH_FLOOR, shares


def test_backpressure_eos_and_validation(jax_models):
    models = _port_models(jax_models, torch.float32)
    prompts = _prompts(7, 5, lo=20, hi=40)
    # a pool of 9 blocks of 16 holds two requests at a time
    eng, tight = _serve(models, prompts, mode="pard", kv_num_blocks=9,
                        **dict(SMALL, max_batch=4))
    _, roomy = _serve(models, prompts, mode="pard", **dict(SMALL, max_batch=4))
    assert eng.peak_kv_bytes_in_use <= 8 * eng.ex.kv_per_block
    for i in range(len(prompts)):
        np.testing.assert_array_equal(tight[i], roomy[i])
    # EOS: stop right after the first occurrence of a generated token
    p0 = prompts[0]
    eos = int(roomy[0][len(p0) + 3])
    first = len(p0) + int(np.nonzero(roomy[0][len(p0):] == eos)[0][0])
    _, cut = _serve(models, prompts[:1], mode="pard", eos_id=eos, **SMALL)
    np.testing.assert_array_equal(cut[0], roomy[0][:first + 1])
    tc, tp, dc, dp = models
    eng = Engine(tp, tc, dp, dc, config=EngineConfig(**SMALL), device="cpu")
    with pytest.raises(ValueError):
        eng.submit(np.arange(250), 10)             # past max_len
    with pytest.raises(ValueError):
        eng.submit(np.arange(1), 10)               # prompt too short
    eng = Engine(tp, tc, dp, dc, config=EngineConfig(
        kv_num_blocks=3, **SMALL), device="cpu")
    eng.submit(np.arange(100), 10)
    with pytest.raises(RuntimeError):
        eng.run()                                  # can never fit the pool


def test_entry_points_need_a_card_or_cpu(jax_models, monkeypatch):
    tc, tp, dc, dp = _port_models(jax_models, torch.float32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        Engine(tp, tc, dp, dc)
    with pytest.raises(RuntimeError):
        serve.main(["--target", "tiny-target", "--draft", "tiny-draft"])
    comps = serve.main(["--target", "tiny-target", "--draft", "tiny-draft",
                        "--device", "cpu", "--requests", "2", "--max-new",
                        "5"])
    assert [c.generated for c in comps] == [5, 5]
