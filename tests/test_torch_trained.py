"""Trained weights through the port and the JAX package, on the CPU.

The port trains the tiny pair in fp32 with the recipe's functions
(``repro_torch.examples.pard_adaptation_train``): tiny-target and
tiny-draft AR, the draft then COD-adapted at K = 4, and an EAGLE head on
the target, just long enough that greedy PARD gets drafts accepted (mean
accepted >= 1.5) from a draft that is not the target. The weights go to
JAX through numpy. With the JAX decoders' forwards pinned to fp32 (for
this module, undone after it), ``generate_ar``, ``generate_spec`` (flat
PARD, the tree (2,2,1,1), VSD with the unadapted draft), the ``Engine``
(paged PARD, the adaptive tree; a batch mixing a greedy and two sampled
requests at T = 0.8) and ``EagleDecoder`` give the JAX package's tokens
and statistics, greedy and at T = 0.8, and greedy PARD equals AR.

Checkpoint round trips between the packages on random weights are in
``tests/test_torch_training.py::test_checkpoints_cross_packages`` (logits
within 1e-4 across packages); here the trained weights make both trips,
each package's logits after the trip within 1e-5 of its own before.
"""
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import eagle as jax_eagle
from repro.core import spec_decode as jax_sd
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.config import SamplingParams as JaxSamplingParams
from repro.serving.engine import Engine as JaxEngine
from repro.training import checkpoint as jax_checkpoint
from repro.training.optimizer import AdamW as JaxAdamW
from repro.training.optimizer import cosine_schedule as jax_cosine_schedule
from repro_torch.configs import get_config
from repro_torch.core import eagle, spec_decode as sd
from repro_torch.data.pipeline import MarkovCorpus
from repro_torch.examples import pard_adaptation_train as recipe
from repro_torch.interop import params_to_numpy
from repro_torch.models import forward, init_params
from repro_torch.serving.config import EngineConfig, SamplingParams
from repro_torch.serving.engine import Engine
from repro_torch.training import checkpoint

AR_STEPS, COD_STEPS, EAGLE_STEPS = 30, 30, 20
EAGLE_PARITY_STEPS = 25         # past the recipe's 20 warm-up steps
K = 4
MAX_NEW = 24
TREE = (2, 2, 1, 1)
STAT_FIELDS = ("iterations", "tokens_generated", "draft_forwards",
               "target_forwards")
SMALL = dict(k=K, max_batch=2, max_len=256, kv_block_size=16, kv_dtype="fp32",
             temperature=0.8, seed=5)
ENGINE_RUNS = {"pard paged": dict(), "adaptive tree paged":
               dict(adaptive_tree=True)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread_and_fp32_jax():
    """One torch thread, and the JAX decoders' forwards in fp32, for this
    module only."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    for mod in (jax_sd, jax_eagle):
        mp.setattr(mod, "forward",
                   functools.partial(jax_forward, dtype=jnp.float32))
    yield
    mp.undo()
    torch.set_num_threads(n)


def to_jax(params):
    return jax.tree.map(jnp.asarray, params_to_numpy(params))


@functools.lru_cache(maxsize=None)
def trained():
    """The port-trained tiny models, their configs (port, JAX), the AR /
    COD / EAGLE loss curves and the JAX copies of the weights."""
    corpus = MarkovCorpus(**recipe.CORPUS)
    tc, dc = get_config("tiny-target"), get_config("tiny-draft")
    quiet = dict(log_every=1, log_fn=None)
    tp, th, _ = recipe.train_ar("tiny-target", 0, AR_STEPS, corpus, "cpu",
                                **quiet)
    dp, dh, _ = recipe.train_ar("tiny-draft", 1, AR_STEPS, corpus, "cpu",
                                **quiet)
    pp, ph, meta = recipe.adapt(dp, K, 0.7, 0.2, True, COD_STEPS, corpus,
                                "cpu", cfg=dc, **quiet)
    ep, eh, _ = recipe.train_eagle_head(tp, tc, EAGLE_STEPS, corpus, "cpu",
                                        log_fn=None)
    curves = {"target": [h["loss"] for h in th],
              "draft": [h["loss"] for h in dh],
              "cod": [h["loss"] for h in ph], "eagle": eh}
    return dict(tc=tc, dc=dc, tp=tp, dp=dp, pp=pp, ep=ep, meta=meta,
                jtc=jax_get_config("tiny-target"),
                jdc=jax_get_config("tiny-draft"), jtp=to_jax(tp),
                jdp=to_jax(dp), jpp=to_jax(pp), jep=to_jax(ep),
                curves=curves)


def prompt():
    """The quickstart's prompts: 4 x 16 tokens of the recipe's corpus."""
    corpus = MarkovCorpus(**recipe.CORPUS)
    return corpus.prompts(np.random.default_rng(5), 4, 16)


@functools.lru_cache(maxsize=None)
def _decoders(draft, tree):
    m = trained()
    kw = dict(k=K, max_len=128, kv_dtype="fp32")
    mine = sd.SpecDecoder(m["tp"], m["tc"], m[draft], m["dc"],
                          kv_block_size=0, tree=tree, **kw)
    theirs = jax_sd.SpecDecoder(m["jtp"], m["jtc"], m["j" + draft], m["jdc"],
                                tree=tree, **kw)
    return mine, theirs


def decoders(draft, temperature, tree=None):
    """The port's and the JAX package's decoders over the trained target
    and ``draft`` ("pp": adapted, "dp": unadapted) at ``temperature``;
    kept across tests, so each JAX decoder compiles once."""
    pair = _decoders(draft, tree)
    for dec in pair:
        dec.temperature = temperature
    return pair


def assert_same_run(mine, theirs):
    (t_m, s_m), (t_j, s_j) = mine, theirs
    np.testing.assert_array_equal(t_m.numpy(), np.asarray(t_j))
    for f in STAT_FIELDS:
        assert getattr(s_m, f) == getattr(s_j, f), f
    if s_j.accept_hist is not None:
        np.testing.assert_array_equal(s_m.accept_hist,
                                      np.asarray(s_j.accept_hist))
    if s_j.round_hist is not None:
        np.testing.assert_array_equal(s_m.round_hist,
                                      np.asarray(s_j.round_hist))
    assert abs(s_m.mean_accepted - s_j.mean_accepted) <= 1e-6
    assert abs(s_m.acceptance_rate - s_j.acceptance_rate) <= 1e-6


def test_training_falls_and_the_adapted_draft_is_accepted():
    """Every loss curve falls; greedy PARD with the adapted draft (not the
    target) accepts drafts, more than the unadapted draft, and equals AR."""
    m = trained()
    for name, curve in m["curves"].items():
        assert np.isfinite(curve).all() and curve[-1] < curve[0], name
    assert m["meta"]["cod"] == dict(k=K, r=0.7, r_min=0.2, drop=True)
    x = prompt()
    ar, _ = decoders("pp", 0.0)[0].generate_ar(x, MAX_NEW)
    got, st = decoders("pp", 0.0)[0].generate_spec(x, MAX_NEW)
    _, base = decoders("dp", 0.0)[0].generate_spec(x, MAX_NEW)
    assert torch.equal(got, ar)
    assert st.mean_accepted >= 1.5
    assert st.mean_accepted > base.mean_accepted


@pytest.mark.parametrize("temperature", [0.0, 0.8])
@pytest.mark.parametrize("path", ["ar", "pard", "vsd", "tree"])
def test_generate_matches_jax(path, temperature):
    draft = "dp" if path == "vsd" else "pp"
    mine, theirs = decoders(draft, temperature,
                            TREE if path == "tree" else None)
    x = prompt()
    if path == "ar":
        got = mine.generate_ar(x, MAX_NEW, seed=5)
        want = theirs.generate_ar(jnp.asarray(x), MAX_NEW, seed=5)
    else:
        mode = "vsd" if path == "vsd" else "pard"
        got = mine.generate_spec(x, MAX_NEW, mode=mode, seed=7)
        want = theirs.generate_spec(jnp.asarray(x), MAX_NEW, mode=mode,
                                    seed=7)
    assert_same_run(got, want)
    if path != "ar":
        assert got[1].mean_accepted > 1.0
    if temperature == 0.0:
        ar, _ = mine.generate_ar(x, MAX_NEW)
        assert torch.equal(got[0], ar)


def engine_prompts():
    corpus = MarkovCorpus(**recipe.CORPUS)
    rng = np.random.default_rng(3)
    return [corpus.prompts(rng, 1, n)[0] for n in (7, 13, 20)]


def request_params(sp_cls):
    """Greedy, the engine's (seed, rid) stream, and a seed of its own."""
    return [sp_cls(max_new=MAX_NEW, temperature=0.0), sp_cls(max_new=MAX_NEW),
            sp_cls(max_new=MAX_NEW, seed=11)]


def _serve(eng, sp_cls):
    rids = {eng.submit(p, params=sp): i for i, (p, sp) in
            enumerate(zip(engine_prompts(), request_params(sp_cls)))}
    return {rids[c.rid]: np.asarray(c.tokens) for c in eng.run()}


@pytest.mark.parametrize("label", list(ENGINE_RUNS))
def test_engine_matches_jax(label):
    """Request by request the port's tokens equal the JAX Engine's, greedy
    and sampled, with the same accepted count, round and template
    histograms and switches; the greedy request equals AR."""
    m = trained()
    cfg = {**SMALL, **ENGINE_RUNS[label]}
    eng = Engine(m["tp"], m["tc"], m["pp"], m["dc"],
                 config=EngineConfig(**cfg), device="cpu")
    got = _serve(eng, SamplingParams)
    jeng = JaxEngine(m["jtp"], m["jtc"], m["jpp"], m["jdc"],
                     config=JaxEngineConfig(**cfg))
    want = _serve(jeng, JaxSamplingParams)
    for i in range(3):
        np.testing.assert_array_equal(got[i], want[i])
    for key in ("accepted", "steps", "draft_forwards", "target_forwards"):
        assert eng.stats[key] == jeng.stats[key], key
    np.testing.assert_array_equal(eng.stats["round_hist"],
                                  np.asarray(jeng.stats["round_hist"]))
    if "adaptive_tree" in cfg:
        np.testing.assert_array_equal(eng.stats["tree_hist"],
                                      np.asarray(jeng.stats["tree_hist"]))
        assert eng.stats["tree_switches"] == jeng.stats["tree_switches"]
    assert eng.mean_accepted() > 1.0
    ar = Engine(m["tp"], m["tc"], None, None, device="cpu",
                config=EngineConfig(**{**SMALL, "mode": "ar",
                                       "temperature": 0.0}))
    np.testing.assert_array_equal(_serve(ar, SamplingParams)[0], got[0])


def test_eagle_decoder_matches_jax():
    """The trained head: greedy tokens and stats equal to the JAX
    EagleDecoder's (bf16 caches on both sides, fp32 forwards) and to AR."""
    m = trained()
    x = prompt()
    got, st = eagle.EagleDecoder(m["tp"], m["tc"], m["ep"], k=K,
                                 max_len=128).generate(x, MAX_NEW)
    want, jst = jax_eagle.EagleDecoder(m["jtp"], m["jtc"], m["jep"], k=K,
                                       max_len=128).generate(
        jnp.asarray(x), MAX_NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for f in STAT_FIELDS:
        assert getattr(st, f) == getattr(jst, f), f
    np.testing.assert_array_equal(st.accept_hist, np.asarray(jst.accept_hist))
    assert abs(st.mean_accepted - jst.mean_accepted) <= 1e-6
    assert st.mean_accepted > 1.0
    ar, _ = decoders("pp", 0.0)[0].generate_ar(x, MAX_NEW)
    assert torch.equal(got, ar)


def test_eagle_head_training_matches_jax():
    """``train_eagle_head`` against stage 3 of the JAX example
    (``examples/pard_adaptation_train.py``: a jitted ``value_and_grad`` of
    ``eagle_loss`` and AdamW on ``cosine_schedule(2e-3, 20, steps)``, over
    ``corpus.batches(8, 48, seed=77)``), from the port's head of seed 9
    handed to JAX, on the trained tiny target: the loss of every step
    within 1e-5 and the final head within 1e-5."""
    m = trained()
    tparams, tc, steps = m["jtp"], m["jtc"], EAGLE_PARITY_STEPS
    ep, losses, _ = recipe.train_eagle_head(
        m["tp"], m["tc"], steps, MarkovCorpus(**recipe.CORPUS), "cpu",
        log_fn=None)

    opt = JaxAdamW(lr=jax_cosine_schedule(2e-3, 20, steps))

    @jax.jit
    def estep(e, state, tokens):
        (loss, _), g = jax.value_and_grad(
            lambda e: jax_eagle.eagle_loss(e, tparams, tc, tokens),
            has_aux=True)(e)
        e, state, _ = opt.update(g, state, e)
        return e, state, loss

    jep = to_jax(eagle.init_eagle(m["tc"], 9, "cpu", torch.float32))
    state = opt.init(jep)
    stream = MarkovCorpus(**recipe.CORPUS).batches(8, 48, seed=77)
    want = []
    for _ in range(steps):
        jep, state, loss = estep(jep, state, jnp.asarray(next(stream)))
        want.append(float(loss))
    np.testing.assert_allclose(losses, want, atol=1e-5, rtol=1e-5)
    got = jax.tree.leaves(params_to_numpy(ep))
    ref = jax.tree.leaves(jax.tree.map(np.asarray, jep))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_trained_checkpoints_cross_packages(tmp_path):
    """Port save -> JAX restore, and JAX save -> port restore, of the
    trained draft: each package's logits after the trip equal its logits
    before within 1e-5, and the two packages agree within 1e-4."""
    m = trained()
    x = prompt()

    def port_logits(p):
        return forward(p, m["dc"], torch.from_numpy(x),
                       dtype=torch.float32)[0].numpy()

    def jax_logits(p):
        return np.asarray(jax_forward(p, m["jdc"], jnp.asarray(x),
                                      dtype=jnp.float32)[0])

    path = os.path.join(tmp_path, "port.npz")
    checkpoint.save(path, m["pp"], metadata=m["meta"])
    like = jax_init_params(jax.random.PRNGKey(0), m["jdc"])
    jrest = jax_checkpoint.restore(path, like)
    assert jax_checkpoint.load_metadata(path) == m["meta"]
    np.testing.assert_allclose(jax_logits(jrest), jax_logits(m["jpp"]),
                               atol=1e-5, rtol=0)

    path = os.path.join(tmp_path, "jax.npz")
    jax_checkpoint.save(path, m["jpp"])
    rest = checkpoint.restore(path, init_params(m["dc"], 1, "cpu",
                                                torch.float32))
    np.testing.assert_allclose(port_logits(rest), port_logits(m["pp"]),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(port_logits(rest), jax_logits(jrest),
                               atol=1e-4, rtol=1e-4)
