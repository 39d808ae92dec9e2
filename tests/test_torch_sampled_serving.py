"""Sampled serving (temperature > 0, per-request seeds) and mode "vsd" in
the port's engine on the CPU, against the JAX package's Engine and against
the port itself.

Both packages run fp32 activations and fp32 KV: the JAX decoder's module
``forward`` is pinned to fp32 for this module (restored after it). The
port's threefry keys draw the JAX package's bits, so at T = 0.8 the port's
tokens equal the JAX Engine's request by request on every path: flat PARD
(paged and contiguous), a static and the adaptive tree, AR and VSD, on
dense tiny models, and VSD on ``tiny-ssm``. Each batch mixes a greedy
request, a sampled request on the engine's (seed, rid) stream and one with
its own ``SamplingParams.seed``; ``max_batch=2`` with 3 requests recycles a
slot.
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
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.config import SamplingParams as JaxSamplingParams
from repro.serving.engine import Engine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.core import spec_decode as sd
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import forward, init_params
from repro_torch.serving.config import EngineConfig, SamplingParams
from repro_torch.serving.engine import Engine

T = 0.8
MAX_NEW = 16
SMALL = dict(k=4, max_batch=2, max_len=256, kv_block_size=16, kv_dtype="fp32",
             temperature=T, seed=5)
RUNS = {
    "pard paged": ("dense", dict()),
    "pard contiguous": ("dense", dict(kv_layout="contiguous")),
    "tree (2,2,1,1) paged": ("dense", dict(tree=(2, 2, 1, 1))),
    "adaptive tree paged": ("dense", dict(adaptive_tree=True)),
    "ar paged": ("dense", dict(mode="ar")),
    "vsd paged": ("dense", dict(mode="vsd")),
    "vsd contiguous": ("dense", dict(mode="vsd", kv_layout="contiguous")),
    "vsd tiny-ssm paged": ("tiny-ssm", dict(mode="vsd")),
}


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
def models(family):
    """(port target cfg, params, draft cfg, params, JAX target cfg, params,
    draft cfg, params): dense = tiny-target / tiny-draft from PRNGKey(0) /
    (1); tiny-ssm drafts for itself, from PRNGKey(3)."""
    names = (("tiny-target", 0), ("tiny-draft", 1)) if family == "dense" \
        else (("tiny-ssm", 3), ("tiny-ssm", 3))
    out = []
    for name, seed in names:
        jcfg, cfg = jax_get_config(name), get_config(name)
        jp = jax_init_params(jax.random.PRNGKey(seed), jcfg)
        out.append((cfg, params_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                           "cpu", torch.float32), jcfg, jp))
    (tc, tp, jtc, jtp), (dc, dp, jdc, jdp) = out
    return tc, tp, dc, dp, jtc, jtp, jdc, jdp


def prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 512, size=n).astype(np.int32) for n in (7, 13, 20)]


def request_params(sp_cls):
    """Greedy, the engine's (seed, rid) stream, and a seed of its own."""
    return [sp_cls(max_new=MAX_NEW, temperature=0.0),
            sp_cls(max_new=MAX_NEW),
            sp_cls(max_new=MAX_NEW, seed=11)]


def port_engine(family, **cfg):
    tc, tp, dc, dp = models(family)[:4]
    return Engine(tp, tc, dp, dc, config=EngineConfig(**{**SMALL, **cfg}),
                  device="cpu")


def serve_port(family, params=None, **cfg):
    eng = port_engine(family, **cfg)
    params = params or request_params(SamplingParams)
    rids = {eng.submit(p, params=sp): i
            for i, (p, sp) in enumerate(zip(prompts(), params))}
    return eng, {rids[c.rid]: c.tokens for c in eng.run()}


@functools.lru_cache(maxsize=None)
def jax_run(label):
    family, cfg = RUNS[label]
    _, _, _, _, jtc, jtp, jdc, jdp = models(family)
    eng = JaxEngine(jtp, jtc, jdp, jdc,
                    config=JaxEngineConfig(**{**SMALL, **cfg}))
    rids = {eng.submit(p, params=sp): i for i, (p, sp) in
            enumerate(zip(prompts(), request_params(JaxSamplingParams)))}
    toks = {rids[c.rid]: np.asarray(c.tokens) for c in eng.run()}
    return toks, eng.stats["accepted"], eng.stats["round_hist"]


@functools.lru_cache(maxsize=None)
def port_run(label):
    family, cfg = RUNS[label]
    eng, toks = serve_port(family, **cfg)
    return toks, eng.stats["accepted"], eng.stats["round_hist"], \
        eng.stats["draft_forwards"], eng.stats["steps"]


def same(got, want):
    return [bool(np.array_equal(got[i], want[i])) for i in sorted(want)]


@pytest.mark.parametrize("label", list(RUNS))
def test_sampled_engine_tokens_match_jax(label):
    """Request by request, the port's tokens equal the JAX Engine's at T =
    0.8, and so do the accepted count and the per-rank round histogram."""
    want, acc, rhist = jax_run(label)
    got, acc_p, rhist_p = port_run(label)[:3]
    assert same(got, want) == [True] * 3
    assert acc_p == acc
    if rhist is None:
        assert rhist_p is None                          # AR
    else:
        np.testing.assert_array_equal(rhist_p, np.asarray(rhist))
    for i, p in enumerate(prompts()):
        assert len(got[i]) == len(p) + MAX_NEW and got[i].max() < 512


@pytest.mark.parametrize("label", list(RUNS))
def test_greedy_rows_of_a_mixed_batch_are_exact(label):
    """The greedy request of the mixed batch equals the same request in an
    all-greedy engine, and equals AR; the sampled requests sample."""
    family, cfg = RUNS[label]
    got = port_run(label)[0]
    _, greedy = serve_port(family, **{**cfg, "temperature": 0.0})
    _, ar = serve_port(family, mode="ar", temperature=0.0)
    assert np.array_equal(got[0], greedy[0])
    assert same(greedy, ar) == [True] * 3
    assert not (np.array_equal(got[1], greedy[1])
                and np.array_equal(got[2], greedy[2]))


@pytest.mark.parametrize("pair", [("pard paged", "pard contiguous"),
                                  ("vsd paged", "vsd contiguous")])
def test_paged_and_contiguous_sampled_runs_agree(pair):
    a, b = (port_run(x)[0] for x in pair)
    assert same(a, b) == [True] * 3


def test_sampled_tree_layouts_agree():
    _, paged = serve_port("dense", tree=(2, 2, 1, 1))
    _, contiguous = serve_port("dense", tree=(2, 2, 1, 1),
                               kv_layout="contiguous")
    assert same(paged, contiguous) == [True] * 3


@pytest.mark.parametrize("mode", ["pard", "vsd"])
def test_request_seed_decouples_from_engine_seed(mode):
    """A request's own seed gives the same tokens under different engine
    seeds; the engine-derived stream does not."""
    p = prompts()[1]

    def run(engine_seed, req_seed):
        eng = port_engine("dense", mode=mode, max_batch=1, seed=engine_seed)
        eng.submit(p, params=SamplingParams(max_new=MAX_NEW, temperature=0.9,
                                            seed=req_seed))
        return eng.run()[0].tokens

    pinned = [run(s, 123) for s in (0, 1, 2)]
    assert all(np.array_equal(pinned[0], x) for x in pinned[1:])
    floating = [run(s, None) for s in (0, 1)]
    assert not np.array_equal(floating[0], floating[1])


@pytest.mark.parametrize("family", ["dense", "tiny-ssm"])
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_greedy_vsd_equals_ar(family, layout):
    """Greedy VSD is lossless: its tokens equal the port's AR engine's (on
    tiny-ssm too; the JAX AR engine lets pads reach the recurrent state)."""
    eng, vsd = serve_port(family, mode="vsd", temperature=0.0,
                          kv_layout=layout)
    _, ar = serve_port(family, mode="ar", temperature=0.0, kv_layout=layout)
    assert same(vsd, ar) == [True] * 3
    assert eng.stats["draft_forwards"] == 4 * eng.stats["steps"]
    if family == "tiny-ssm":
        assert eng.mean_accepted() > 1.5      # the target drafts for itself


@pytest.mark.parametrize("label", ["pard paged", "tree (2,2,1,1) paged",
                                   "adaptive tree paged", "vsd paged"])
def test_round_hist_sums_to_accepted(label):
    _, accepted, rhist, draft_forwards, steps = port_run(label)
    assert int(np.sum(rhist)) == accepted > 0
    k = 4 if label.startswith("vsd") else 1
    assert draft_forwards == k * steps


def test_greedy_batches_run_the_greedy_only_steps():
    """All-greedy batches never build a sampled step (the launch counts of
    greedy serving are unchanged); a mixed batch builds both."""
    greedy = [SamplingParams(max_new=6, temperature=0.0)] * 3
    for cfg in (dict(), dict(mode="ar"), dict(tree=(2, 2, 1, 1))):
        eng, _ = serve_port("dense", params=greedy, **cfg)
        assert {g for _, g in eng.ex._steps} == {True}, cfg
    eng, _ = serve_port("dense", max_batch=1)
    assert {g for _, g in eng.ex._steps} == {True, False}


def test_sampled_request_after_greedy_ar_steps_matches_jax():
    """With max_batch 1 the greedy request runs alone first: the port's AR
    engine leaves the keys alone on those steps, the JAX AR engine splits
    them; the sampled requests after it get fresh keys at admission and
    draw the JAX tokens."""
    cfg = dict(mode="ar", max_batch=1)
    _, got = serve_port("dense", **cfg)
    _, _, _, _, jtc, jtp, _, _ = models("dense")
    eng = JaxEngine(jtp, jtc, config=JaxEngineConfig(**{**SMALL, **cfg}))
    rids = {eng.submit(p, params=sp): i for i, (p, sp) in
            enumerate(zip(prompts(), request_params(JaxSamplingParams)))}
    want = {rids[c.rid]: np.asarray(c.tokens) for c in eng.run()}
    assert same(got, want) == [True] * 3


def test_vsd_proposal_kv_past_the_committed_count_is_never_read():
    """VSD's proposal forwards leave their draft KV at positions n .. n+K-2
    (the caches are written in place). Poisoning every draft KV entry past
    each row's committed count between steps changes no token and no
    later cache entry below the committed count."""
    def run(poison):
        eng = port_engine("dense", mode="vsd", kv_layout="contiguous")
        for p, sp in zip(prompts(), request_params(SamplingParams)):
            eng.submit(p, params=sp)
        while eng.sched.has_work():
            eng.sched.admit()
            eng.sched.step()
            st = eng.ex.state
            if poison:
                pos = torch.arange(st.gen.shape[1])
                past = pos[None] >= st.n[:, None]                # [B, L]
                for entry in st.dcache["scan"]:
                    for name in ("k", "v"):
                        entry[name][:, past] = 1e4
        return {c.rid: c.tokens for c in eng.sched.completions}

    clean, poisoned = run(False), run(True)
    assert sorted(clean) == sorted(poisoned)
    for rid in clean:
        assert np.array_equal(clean[rid], poisoned[rid])


def test_vsd_restores_the_ssm_draft_state():
    """A Mamba2 draft's states after a VSD draft equal those after its
    call-1 forward and gather alone: the K-1 proposal forwards leave no
    trace in the recurrent state."""
    cfg = get_config("tiny-ssm")
    params = init_params(cfg, 0, "cpu", torch.float32)
    dec = sd.SpecDecoder(params, cfg, params, cfg, k=4, kv_block_size=0)
    rng = np.random.default_rng(0)
    b, length = 2, 64
    gen = torch.from_numpy(rng.integers(0, 512, (b, length)))
    n, m = torch.tensor([20, 30]), torch.tensor([17, 29])
    from repro_torch.models import init_caches
    caches = [init_caches(cfg, b, length, "fp32", "cpu") for _ in range(2)]
    for c in caches:                         # a state to restore
        forward(params, cfg, gen[:, :16], caches=c,
                cache_pos=torch.zeros(b, dtype=torch.long),
                dtype=torch.float32)
    temp = torch.tensor([0.0, 0.8])
    keys = sd.acceptance.make_row_keys(1, [0, 1])
    props, lg, _ = dec._propose_vsd(gen, n, m, caches[0], None, None, temp,
                                    keys)
    assert props.shape == (b, 4) and lg.shape[:2] == (b, 4)
    # call 1 alone on the twin caches
    tok = sd._draft_window(gen, n, m, 4, cfg.mask_token_id)[:, :5]
    records = []
    forward(params, cfg, tok, caches=caches[1], cache_pos=m,
            dtype=torch.float32, collect_ssm=records)
    sd.gather_ssm_states(records, n - m - 1)
    for got, want in zip(sd.ssm_leaves(cfg, caches[0]),
                         sd.ssm_leaves(cfg, caches[1])):
        assert torch.equal(got, want)


def test_config_and_submit_validation():
    assert EngineConfig().seed == JaxEngineConfig().seed == 0
    assert EngineConfig(mode="vsd", temperature=0.7, seed=3).seed == 3
    assert SamplingParams(temperature=0.5, seed=9).seed == 9
    for bad in (dict(temperature=-0.1), dict(mode="vsd", tree=(2, 1)),
                dict(mode="vsd", adaptive_tree=True), dict(mode="x")):
        with pytest.raises(ValueError):
            EngineConfig(**bad)
    with pytest.raises(ValueError):
        SamplingParams(temperature=-1.0)
    sp = SamplingParams(temperature=0.5)
    assert sp.merged(8) == dataclasses.replace(sp, max_new=8)
    with pytest.raises(ValueError):
        SamplingParams(max_new=4).merged(8)
    with pytest.raises(ValueError):
        sp.merged(None)
    eng = port_engine("dense")
    with pytest.raises(ValueError, match="SamplingParams"):
        eng.submit(prompts()[0], temperature=0.5,
                   params=SamplingParams(max_new=8))
    rid = eng.submit(prompts()[0], 4, temperature=0.0)
    assert eng.queue[-1].params == SamplingParams(max_new=4, temperature=0.0)
    assert rid == 0


def test_serve_cli_sampled_and_vsd(capsys):
    comps = serve.main(["--target", "tiny-target", "--draft", "tiny-draft",
                        "--device", "cpu", "--mode", "vsd", "--k", "4",
                        "--temperature", "0.8", "--greedy-requests", "2",
                        "--requests", "3", "--max-new", "6",
                        "--max-len", "128"])
    out = capsys.readouterr().out
    assert len(comps) == 3 and all(c.generated == 6 for c in comps)
    assert "mode=vsd" in out and "temperature=0.8" in out
    assert "greedy_requests=2/3" in out and "mean_accepted=" in out


@pytest.mark.slow
def test_sampled_tree_matches_ar_distribution():
    """The statistical gate of the JAX package's sampled trees, on the
    port's engine (40 seeds x 4 rows, 8 new tokens): pooled committed-token
    TV of the (2,2,2,1) tree against AR sampling < 0.5, and the first
    token's chi-squared against the exact target distribution (10
    probability-quantile buckets per row, summed over rows) < 68.0 =
    chi2_0.999(36), for the tree and for the AR control."""
    tc, tp, dc, dp = models("dense")[:4]
    b, plen, new, seeds = 4, 8, 8, 40
    prompt = np.array(jax.random.randint(jax.random.PRNGKey(2), (b, plen),
                                           0, tc.vocab_size))
    logits, _ = forward(tp, tc, torch.from_numpy(prompt).long(),
                        dtype=torch.float32)
    p_exact = torch.softmax(logits[:, -1].float() / T, -1).numpy()
    v = p_exact.shape[-1]

    def run(seed, **cfg):
        eng = Engine(tp, tc, dp, dc, config=EngineConfig(
            max_batch=b, max_len=256, kv_dtype="fp32", temperature=T,
            seed=seed, **cfg), device="cpu")
        for row in prompt:                   # rids 0..B-1: row keys (seed, b)
            eng.submit(row, new)
        out = {c.rid: c.tokens for c in eng.run()}
        return np.stack([out[i] for i in range(b)])

    tree_tok, ar_tok = [], []
    first_tree, first_ar = np.zeros((b, v)), np.zeros((b, v))
    for s in range(seeds):
        out = run(s, tree=(2, 2, 2, 1))
        tree_tok.append(out[:, plen:])
        np.add.at(first_tree, (np.arange(b), out[:, plen]), 1)
        out = run(s, mode="ar", k=4)
        ar_tok.append(out[:, plen:])
        np.add.at(first_ar, (np.arange(b), out[:, plen]), 1)

    def hist(arr):
        h = np.bincount(np.asarray(arr).ravel(), minlength=v).astype(float)
        return h / h.sum()

    tv = 0.5 * np.abs(hist(np.concatenate(tree_tok))
                      - hist(np.concatenate(ar_tok))).sum()
    assert tv < 0.5, f"pooled committed-token TV {tv:.3f} >= 0.5"

    def chi2(firsts, nb=10):
        tot = 0.0
        for r in range(b):
            order = np.argsort(-p_exact[r])
            bucket = np.minimum((np.cumsum(p_exact[r][order]) * nb)
                                .astype(int), nb - 1)
            bid = np.zeros(v, int)
            bid[order] = bucket
            obs, exp = np.zeros(nb), np.zeros(nb)
            np.add.at(obs, bid, firsts[r])
            np.add.at(exp, bid, p_exact[r] * seeds)
            tot += float((((obs - exp) ** 2) / np.maximum(exp, 1e-9)).sum())
        return tot

    c_tree, c_ar = chi2(first_tree), chi2(first_ar)
    assert c_ar < 68.0, f"AR control chi2 {c_ar:.1f}: threshold miscalibrated"
    assert c_tree < 68.0, f"sampled-tree first-token chi2 {c_tree:.1f} >= 68"


@pytest.mark.parametrize("mode", ["tree", "vsd"])
def test_first_sampled_token_follows_the_target(mode):
    """The slow gate's fast sibling: 200 requests of one prompt, each with
    its own seed, through one engine; their first committed tokens against
    the exact target distribution, chi-squared over 10 probability-quantile
    buckets < 27.9 = chi2_0.999(9), for the sampled tree or VSD and for the
    AR control."""
    tc, tp, dc, dp = models("dense")[:4]
    prompt = prompts()[1]
    logits, _ = forward(tp, tc, torch.from_numpy(prompt).long()[None],
                        dtype=torch.float32)
    p_exact = torch.softmax(logits[0, -1].float() / T, -1).numpy()
    n_req, nb = 200, 10
    order = np.argsort(-p_exact)
    bid = np.zeros(len(p_exact), int)
    bid[order] = np.minimum((np.cumsum(p_exact[order]) * nb).astype(int),
                            nb - 1)
    exp = np.bincount(bid, weights=p_exact * n_req, minlength=nb)

    def chi2(**cfg):
        eng = Engine(tp, tc, dp, dc, config=EngineConfig(
            max_batch=16, max_len=64, kv_dtype="fp32", k=4, temperature=T,
            **cfg), device="cpu")
        for s in range(n_req):
            eng.submit(prompt, params=SamplingParams(max_new=1, seed=s))
        firsts = [c.tokens[len(prompt)] for c in eng.run()]
        obs = np.bincount(bid[firsts], minlength=nb)
        return float(((obs - exp) ** 2 / np.maximum(exp, 1e-9)).sum())

    c = chi2(**(dict(tree=(2, 2, 1, 1)) if mode == "tree"
                else dict(mode="vsd")))
    assert chi2(mode="ar") < 27.9
    assert c < 27.9, f"{mode} first-token chi2 {c:.1f}"
