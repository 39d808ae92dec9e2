"""The port's two-deep dispatch/harvest loop on the CPU (ports of
``tests/test_pipelined.py``): pipelined completions equal the synchronous
loop's request by request on both KV layouts, with sampled rows, EOS
truncation, slot churn, the adaptive reshape, a static tree, AR and VSD;
the stats and host-overhead rules; a step's handle read after the next
dispatch and an admission; and the port's pipelined tokens equal to the
JAX package's ``run_pipelined`` in fp32 (the JAX decoder's module
``forward`` pinned to fp32 for this module, restored after it).
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
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import Engine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.core.spec_decode import TemplateBank, TreeTemplate
from repro_torch.interop import params_from_numpy
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import Engine


@pytest.fixture(autouse=True, scope="module")
def _one_thread_and_fp32_jax():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_sd, "forward",
               functools.partial(jax_forward, dtype=jnp.float32))
    yield
    mp.undo()
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def models():
    """(port target cfg, params, draft cfg, params, JAX target cfg, params,
    draft cfg, params): tiny-target / tiny-draft from PRNGKey(0) / (1),
    converted to the port in fp32."""
    out = []
    for name, seed in (("tiny-target", 0), ("tiny-draft", 1)):
        jcfg, cfg = jax_get_config(name), get_config(name)
        jp = jax_init_params(jax.random.PRNGKey(seed), jcfg)
        out.append((cfg, params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                           "cpu", torch.float32), jcfg, jp))
    (tc, tp, jtc, jtp), (dc, dp, jdc, jdp) = out
    return tc, tp, dc, dp, jtc, jtp, jdc, jdp


def _prompts(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, size=int(t)) for t in
            rng.integers(6, 18, size=n)]


def _engine(max_batch=2, **kw):
    tc, tp, dc, dp = models()[:4]
    cfg = dict(mode="pard", k=4, max_batch=max_batch, max_len=256, seed=0)
    cfg.update(kw)
    return Engine(tp, tc, dp, dc, config=EngineConfig(**cfg), device="cpu")


def _run(pipelined, *, n_req=6, max_batch=2, seed=7, temps=None,
         max_new=12, return_engine=False, **kw):
    eng = _engine(max_batch, **kw)
    for i, p in enumerate(_prompts(seed, n_req)):
        t = None if temps is None else temps[i % len(temps)]
        eng.submit(p, max_new + 2 * (i % 3), temperature=t)
    comps = eng.run(pipelined=pipelined)
    toks = {c.rid: np.asarray(c.tokens) for c in comps}
    return (toks, eng) if return_engine else toks


def _assert_identical(sync, pipe):
    assert set(sync) == set(pipe)
    for rid in sync:
        assert np.array_equal(sync[rid], pipe[rid]), (
            f"rid {rid}: pipelined tokens differ\n"
            f"sync {sync[rid].tolist()}\npipe {pipe[rid].tolist()}")


# ------------------------------------------------------- token identity
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_pipelined_greedy_identical(layout):
    """Greedy: the loop's depth is invisible in the tokens on both layouts,
    with 6 requests through 2 slots (every retirement re-admits while a
    step is in flight)."""
    kw = dict(kv_layout=layout, kv_block_size=32)
    _assert_identical(_run(False, **kw), _run(True, **kw))


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_pipelined_sampled_mixed_identical(layout):
    """Sampled rows beside greedy ones: a row's key advances only on its
    own decoding steps, so the pipeline shifts nothing."""
    kw = dict(kv_layout=layout, kv_block_size=32)
    temps = (0.0, 0.8, 0.0, 1.2)
    _assert_identical(_run(False, temps=temps, **kw),
                      _run(True, temps=temps, **kw))


def test_pipelined_eos_truncation_identical():
    """EOS retirement lags one step in the pipeline (the row runs one more
    step in flight), but the completion is cut from the EOS step's own
    snapshot, so the extra step's tokens never reach the output."""
    sync0 = _run(False, max_new=20)
    gen = np.concatenate([t[6:] for t in sync0.values()])
    eos = int(np.bincount(gen).argmax())       # most common generated token
    sync = _run(False, max_new=20, eos_id=eos)
    pipe = _run(True, max_new=20, eos_id=eos)
    plen = [len(p) for p in _prompts(7, 6)]
    hit = [rid for rid in sync if eos in sync[rid][plen[rid]:].tolist()]
    assert hit, "the chosen eos_id never fired"
    for rid in hit:                     # truncated at the first EOS
        gen = sync[rid][plen[rid]:].tolist()
        assert gen.index(eos) == len(gen) - 1
    _assert_identical(sync, pipe)


def test_pipelined_slot_churn_more_requests_than_slots():
    """10 requests through 2 slots with ragged budgets: every slot is
    re-admitted while steps are in flight, and a stale snapshot is never
    attributed to the slot's new request (the handle's rids)."""
    sync = _run(False, n_req=10, max_new=8)
    pipe = _run(True, n_req=10, max_new=8)
    assert len(pipe) == 10
    _assert_identical(sync, pipe)


def test_pipelined_adaptive_reshape_identical():
    """The adaptive controller with greedy rows and one pinned sampled
    row: re-selections are staged to dispatch boundaries; greedy tokens
    do not depend on the template and the pinned row never reshapes."""
    kw = dict(tree=TemplateBank.default(4), adaptive_tree=True,
              tree_reselect_every=2)

    def run(pipelined):
        eng = _engine(**kw)
        for i, p in enumerate(_prompts(11, 6)):
            if i == 2:
                eng.submit(p, 10, temperature=0.8, tree_idx=0)
            else:
                eng.submit(p, 10 + 2 * (i % 3))
        return {c.rid: c.tokens for c in eng.run(pipelined=pipelined)}, eng

    (sync, es), (pipe, ep) = run(False), run(True)
    _assert_identical(sync, pipe)
    assert es.stats["tree_hist"].sum() == ep.stats["tree_hist"].sum()


def test_pipelined_static_tree_identical():
    kw = dict(tree=TreeTemplate.from_branching((2, 2, 1)))
    _assert_identical(_run(False, **kw), _run(True, **kw))


@pytest.mark.parametrize("mode", ["ar", "vsd"])
def test_pipelined_ar_and_vsd_identical(mode):
    """AR (its window widens on steps with a prefilling row) and VSD (K
    draft forwards), greedy and sampled rows."""
    kw = dict(mode=mode, temps=(0.0, 0.8))
    _assert_identical(_run(False, **kw), _run(True, **kw))


# ----------------------------------------------------------- accounting
def test_pipelined_stats_match_sync():
    """Commit accounting does not depend on the loop's depth: the pipeline
    may run extra steps (retirement lags one dispatch, so a step already
    in flight when the batch drains runs frozen and commits nothing), at
    most one per request, but accepted / live / committed match."""
    sync, es = _run(False, return_engine=True)
    pipe, ep = _run(True, return_engine=True)
    for key in ("accepted", "live_steps", "committed", "prefill_tokens",
                "prefill_chunks"):
        assert es.stats[key] == ep.stats[key], key
    assert es.stats["steps"] <= ep.stats["steps"] <= es.stats["steps"] \
        + len(pipe)
    for eng in (es, ep):
        assert eng.stats["target_forwards"] == eng.stats["steps"]
        assert eng.stats["draft_forwards"] == eng.stats["steps"]
        assert len(eng.sched.step_ms) == eng.stats["steps"]


def test_host_overhead_recorded():
    """latency_summary reports the harvest -> dispatch host overhead; the
    pipelined loop records one sample per dispatch after the first two
    (they precede any harvest), the synchronous loop one per dispatch
    after the first."""
    for pipelined, ramp in ((True, 2), (False, 1)):
        _, eng = _run(pipelined, return_engine=True)
        lat = eng.latency_summary()
        assert len(eng.sched.host_overhead_ms) >= eng.stats["steps"] - ramp
        assert lat["host_overhead_p95_ms"] >= lat["host_overhead_p50_ms"] \
            >= 0.0
        assert lat["step_p50_ms"] > 0.0


def test_config_pipelined_is_the_default_of_run():
    sync = _run(False)
    eng = _engine(pipelined=True, kv_block_size=64)
    for i, p in enumerate(_prompts(7, 6)):
        eng.submit(p, 12 + 2 * (i % 3))
    got = {c.rid: c.tokens for c in eng.run()}
    _assert_identical(sync, got)
    eng2 = _engine()
    for i, p in enumerate(_prompts(7, 6)):
        eng2.submit(p, 12 + 2 * (i % 3))
    _assert_identical(sync, {c.rid: c.tokens for c in eng2.run_pipelined()})


# --------------------------------------------------------------- handles
def _results_equal(x, y):
    for name in ("a", "rank", "live", "n", "gen"):
        u, v = getattr(x, name), getattr(y, name)
        assert (u is None) == (v is None), name
        if u is not None:
            np.testing.assert_array_equal(u, v, err_msg=name)


@pytest.mark.parametrize("kw", [dict(), dict(tree=(2, 2, 1))])
def test_handle_survives_next_dispatch_and_admission(kw):
    """Dispatch step t, admit a request into a free slot, dispatch step
    t + 1, then harvest step t: the result equals the synchronous step t
    (admission writes the new slot's ``n`` / ``gen`` in place and step t+1
    writes every row; the handle holds its own snapshot)."""
    prompts = _prompts(3, 3)

    def start():
        eng = _engine(max_batch=3, **kw)
        for p in prompts[:2]:
            eng.submit(p, 10)
        eng.sched.admit()
        eng.ex.sync_tables(eng.alloc)
        for _ in range(3):
            eng.sched.step()
        return eng

    ref = start()
    want = ref.ex.harvest(ref.sched.dispatch())
    eng = start()
    handle = eng.sched.dispatch()
    eng.submit(prompts[2], 10)
    assert eng.sched.admit() == 1
    eng.ex.sync_tables(eng.alloc)
    later = eng.sched.dispatch()
    got = eng.ex.harvest(handle)
    _results_equal(got, want)
    assert got.n[2] == 2 and not got.gen[2].any()      # the empty slot
    assert eng.ex.harvest(later).n[2] == len(prompts[2])


# ------------------------------------------------------------- vs JAX
@pytest.mark.parametrize("kw", [dict(), dict(kv_layout="contiguous"),
                                dict(adaptive_tree=True)],
                         ids=["paged", "contiguous", "adaptive"])
def test_pipelined_tokens_match_jax_run_pipelined(kw):
    """fp32 activations and KV: the port's pipelined tokens equal the JAX
    Engine's ``run_pipelined`` request by request (greedy and seeded
    sampled rows; adaptive: greedy and a pinned sampled row)."""
    tc, tp, dc, dp, jtc, jtp, jdc, jdp = models()
    cfg = dict(mode="pard", k=4, max_batch=2, max_len=256, seed=0,
               kv_dtype="fp32", kv_block_size=32, **kw)
    temps = (0.0, 0.8, 0.0, 1.2)
    pin = 0 if kw.get("adaptive_tree") else None
    eng = Engine(tp, tc, dp, dc, config=EngineConfig(**cfg), device="cpu")
    jeng = JaxEngine(jtp, jtc, jdp, jdc, config=JaxEngineConfig(**cfg))
    for e in (eng, jeng):
        for i, p in enumerate(_prompts(5, 5)):
            t = temps[i % 4]
            e.submit(p, 10 + 2 * (i % 3), temperature=t,
                     tree_idx=pin if t > 0 else None)
    mine = {c.rid: c.tokens for c in eng.run_pipelined()}
    theirs = {c.rid: np.asarray(c.tokens) for c in jeng.run_pipelined()}
    _assert_identical(theirs, mine)
    for key in ("steps", "committed", "accepted", "prefill_tokens"):
        assert eng.stats[key] == jeng.stats[key], key
