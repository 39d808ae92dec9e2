"""The port's tree drafting and contiguous KV layout against the JAX package
and against itself, on the CPU.

Against JAX: template and bank arrays, greedy tree acceptance, the adaptive
controller on a seeded stream, tree-cache compaction, block growth, window
sizes and one whole tree step (paged and contiguous; tokens, counters and
KV to 2e-3 in fp32). Inside the port, where exact equality is promised:
tree greedy == AR, a degenerate chain == flat K, paged == contiguous, and
the adaptive engine is lossless with every live step accounted.
"""
import dataclasses
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
from repro.models import init_params as jax_init_params
from repro.serving import config as jax_config
from repro.serving import kv_pool as jax_kv_pool
from repro.serving.scheduler import TreeController as JaxTreeController
from repro_torch.configs import get_config
from repro_torch.core import acceptance, spec_decode as sd
from repro_torch.interop import params_from_numpy
from repro_torch.models import init_caches
from repro_torch.serving import kv_pool
from repro_torch.serving.config import EngineConfig, SamplingParams
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import TreeController

BANK = ((1, 1, 1, 1), (2, 2, 2, 1), (4, 2, 1, 1))
KV_TOL = dict(atol=2e-3, rtol=2e-3)


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


@pytest.fixture(scope="module")
def models(jax_models):
    """The port's fp32 tiny target and draft from the JAX params."""
    _, tp, _, dp = jax_models
    tc, dc = get_config("tiny-target"), get_config("tiny-draft")
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return (tc, params_from_numpy(to_np(tp), tc, "cpu", torch.float32),
            dc, params_from_numpy(to_np(dp), dc, "cpu", torch.float32))


def _prompts(seed, n, lo=4, hi=14):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 512, size=int(k)).astype(np.int32)
            for k in rng.integers(lo, hi, size=n)]


def _serve(models, prompts, max_new=12, self_draft=False, tree_idx=None,
           **cfg):
    tc, tp, dc, dp = models
    if self_draft:                  # the target drafts for itself: deep accepts
        dc, dp = tc, tp
    eng = Engine(tp, tc, dp, dc, config=EngineConfig(**cfg), device="cpu")
    rids = {}
    for i, p in enumerate(prompts):
        t = None if tree_idx is None else tree_idx[i]
        rids[eng.submit(p, params=SamplingParams(max_new=max_new,
                                                 tree_idx=t))] = i
    comps = eng.run()
    return eng, {rids[c.rid]: c.tokens for c in comps}


# ----------------------------------------------------------- templates
@pytest.mark.parametrize("branching", [(3, 2, 1), (1,) * 8, (4, 1),
                                       (2, 2, 1, 1, 1, 1, 1, 1), (1,) * 31])
def test_templates_match_jax(branching):
    mine = sd.TreeTemplate.from_branching(branching)
    theirs = jax_sd.TreeTemplate.from_branching(branching)
    for f in ("parent", "depth", "choice", "anc"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(theirs, f))
    assert (mine.num_slots, mine.max_depth, mine.is_chain) == \
        (theirs.num_slots, theirs.max_depth, theirs.is_chain)
    np.testing.assert_array_equal(acceptance.tree_child_map(mine),
                                  jax_acceptance.tree_child_map(theirs))


@pytest.mark.parametrize("which", ["default4", "default8", "mixed"])
def test_banks_match_jax(which):
    if which == "mixed":
        mine = sd.TemplateBank.from_templates(BANK)
        theirs = jax_sd.TemplateBank.from_templates(BANK)
    else:
        k = int(which[-1])
        mine, theirs = sd.TemplateBank.default(k), jax_sd.TemplateBank.default(k)
    for f in ("parent", "depth", "choice", "anc", "child_map", "nslots"):
        np.testing.assert_array_equal(getattr(mine, f), getattr(theirs, f))
    assert (mine.key, mine.max_slots, mine.max_depth, mine.max_branching) == \
        (theirs.key, theirs.max_slots, theirs.max_depth, theirs.max_branching)
    if which == "default8":
        # the 8B engine's adaptive window: 31 slots, slots 30 / 31 in play
        assert mine.key == "1x1x1x1x1x1x1x1|2x2x1x1x1x1x1x1|3x1x1x1x1x1x1x1"
        assert list(mine.nslots) == [9, 31, 25] and mine.max_slots == 31


def test_template_validation():
    with pytest.raises(ValueError, match="window slots"):
        sd.TreeTemplate.from_branching((4, 3, 1, 1))          # 41 slots
    with pytest.raises(ValueError):
        sd.TemplateBank.from_templates([(1, 1), (2, 1, 1)])   # mixed depth
    with pytest.raises(ValueError):
        sd.TreeTemplate.from_branching((2, 0))


def test_window_sizes_match_jax(models, jax_models):
    tc, tp, dc, dp = models
    jtc, jtp, jdc, jdp = jax_models
    for mine_tree, their_tree in (
            (sd.TemplateBank.from_templates(BANK),
             jax_sd.TemplateBank.from_templates(BANK)),
            ((2, 2, 1), jax_sd.TreeTemplate.from_branching((2, 2, 1))),
            (None, None)):
        mine = sd.SpecDecoder(tp, tc, dp, dc, k=6, tree=mine_tree)
        theirs = jax_sd.SpecDecoder(jtp, jtc, jdp, jdc, k=6, tree=their_tree,
                                    kv_block_size=64)
        assert (mine.k, mine.window_slack, mine.chunk_width,
                mine.min_row_slack) == (theirs.k, theirs.window_slack,
                                        theirs.chunk_width,
                                        theirs.min_row_slack)
        if mine.tree is not None:
            assert [mine.row_slack(i) for i in range(len(mine.tree))] == \
                [theirs.row_slack(i) for i in range(len(theirs.tree))]


# ----------------------------------------------------------- acceptance
def test_greedy_tree_accept_rows_matches_jax():
    """Per-row templates of the mixed bank. Node tokens are distinct
    top-k ranks per depth (as the draft makes them); the target argmax is
    planted on one of a slot's candidate children at most slots, and the
    other logits carry many ties (lowest index wins)."""
    rng = np.random.default_rng(3)
    bank = sd.TemplateBank.from_templates(BANK)
    b, s, v = 8, bank.max_slots, 7
    sel = rng.integers(0, len(bank), size=b)
    logits = rng.integers(0, 3, (b, s, v)).astype(np.float32)
    props = np.zeros((b, s - 1), np.int64)
    for r in range(b):
        ranked = [rng.permutation(v) for _ in range(bank.max_depth + 2)]
        dep, cho = bank.depth[sel[r]], bank.choice[sel[r]]
        props[r] = [ranked[dep[i]][cho[i]] for i in range(1, s)]
        for slot in range(s):                # plant the target's pick
            if rng.random() < 0.7:
                c = rng.integers(0, bank.max_branching)
                logits[r, slot, ranked[dep[slot] + 1][c]] = 5.0
    meta = [bank.parent[sel], bank.depth[sel], bank.choice[sel],
            bank.anc[sel], bank.nslots[sel]]
    got = acceptance.greedy_tree_accept_rows(
        torch.from_numpy(logits), torch.from_numpy(props),
        *[torch.from_numpy(np.asarray(x, np.int64)) for x in meta],
        bank.max_depth)
    want = jax.jit(jax_acceptance.greedy_tree_accept_rows,
                   static_argnums=7)(
        jnp.asarray(logits), jnp.asarray(props, jnp.int32),
        *[jnp.asarray(x) for x in meta], bank.max_depth)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].max() >= 2                 # some rows accept deep paths
    tree = sd.TreeTemplate.from_branching((2, 2, 1))
    lg = rng.standard_normal((3, tree.num_slots, v)).astype(np.float32)
    pr = rng.integers(0, v, (3, tree.num_nodes))
    for g, w in zip(acceptance.greedy_tree_accept(
            tree, torch.from_numpy(lg), torch.from_numpy(pr)),
            jax_acceptance.greedy_tree_accept(
                jax_sd.TreeTemplate.from_branching((2, 2, 1)),
                jnp.asarray(lg), jnp.asarray(pr, jnp.int32))):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_topk_indices_match_jax():
    rng = np.random.default_rng(4)
    x = rng.integers(0, 4, (3, 5, 9)).astype(np.float32)      # ties
    np.testing.assert_array_equal(
        sd._topk_indices(torch.from_numpy(x), 3).numpy(),
        np.asarray(jax_sd._topk_indices(jnp.asarray(x), 3)))


# ----------------------------------------------------------- controller
def test_tree_controller_matches_jax():
    """A seeded stream of updates, retirements and selections: the EWMA
    tables and every pick agree."""
    rng = np.random.default_rng(5)
    mine = TreeController(sd.TemplateBank.from_templates(BANK), 3, 0.3)
    theirs = JaxTreeController(jax_sd.TemplateBank.from_templates(BANK), 3,
                               0.3)
    for step in range(40):
        live = rng.random(3) < 0.8
        tree_idx = rng.integers(0, 3, size=3).astype(np.int32)
        a = rng.integers(0, 5, size=3)
        rank = np.full((3, 4), -1, np.int32)
        for r in range(3):
            br = BANK[tree_idx[r]]
            rank[r, :a[r]] = [rng.integers(0, br[d]) for d in range(a[r])]
        for c in (mine, theirs):
            c.update(live, tree_idx, a, rank)
            if step % 7 == 6:
                c.retire_slot(step % 3)
                c.seed_slot((step + 1) % 3)
        np.testing.assert_allclose(mine.slot_p, theirs.slot_p, rtol=0,
                                   atol=1e-15)
        np.testing.assert_allclose(mine.global_p, theirs.global_p, rtol=0,
                                   atol=1e-15)
        for slot in (None, 0, 1, 2):
            for feasible in (None, [0, 1], [2]):
                assert mine.select(slot, feasible) == \
                    theirs.select(slot, feasible)


def test_block_allocator_grow_matches_jax():
    mine = kv_pool.BlockAllocator(8, 16, 2, 128)
    theirs = jax_kv_pool.BlockAllocator(8, 16, 2, 128)
    for alloc in (mine, theirs):
        alloc.allocate(0, 30)
    for op, slot, n in (("g", 0, 20), ("g", 0, 60), ("a", 1, 48),
                        ("g", 0, 100), ("r", 0, 0), ("g", 1, 64)):
        res = []
        for alloc in (mine, theirs):
            if op == "g":
                res.append(alloc.grow(slot, n))
            elif op == "a":
                alloc.allocate(slot, n)
            else:
                alloc.release(slot)
        assert len(set(res)) <= 1
        np.testing.assert_array_equal(mine.tables, theirs.tables)
        assert (mine.version, mine.blocks_in_use, sorted(mine.free)) == \
            (theirs.version, theirs.blocks_in_use, sorted(theirs.free))
    with pytest.raises(ValueError):
        mine.grow(0, 10)                           # released slot


# ------------------------------------------------------------ compaction
def _random_caches(jtree, rng):
    return jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), jtree)


def _to_port(np_tree, port_tree):
    """Copy numpy leaves into the port's cache tree of the same layout."""
    for key in ("prefix", "scan"):
        for e_np, e_pt in zip(np_tree[key], port_tree[key]):
            for n in e_pt:
                e_pt[n].copy_(torch.from_numpy(e_np[n]))
    return port_tree


def _assert_caches_close(port_tree, jax_tree, skip_block0=False):
    for key in ("prefix", "scan"):
        for e_pt, e_jx in zip(port_tree[key], jax_tree[key]):
            for n in e_pt:
                got, want = e_pt[n].numpy(), np.asarray(e_jx[n])
                if skip_block0:       # garbage block: unordered duplicates
                    lead = got.ndim - 4
                    got = got[(slice(None),) * lead + (slice(1, None),)]
                    want = want[(slice(None),) * lead + (slice(1, None),)]
                np.testing.assert_allclose(got, want, **KV_TOL)


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_compact_tree_caches_matches_jax(layout):
    """Random winning slots per depth (identity copies included), a
    destination near the end of a contiguous row (start clamp)."""
    rng = np.random.default_rng(6)
    cfg, jcfg = get_config("tiny-target"), jax_get_config("tiny-target")
    b, depth, max_len, bs = 3, 4, 48, 8
    n = np.array([10, 21, max_len - 2], np.int32)
    src_slot = np.stack([rng.integers(1, 20, size=b) for _ in range(depth)], 1)
    src_slot[0] = np.arange(1, depth + 1)                 # identity row
    src_pos = (n - 1)[:, None] + src_slot
    src_pos[2] = np.minimum(src_pos[2], max_len - 1)
    if layout == "paged":
        tables = rng.permutation(np.arange(1, 1 + b * 6)).reshape(b, 6)
        tables = tables.astype(np.int32)
        jcache = jax_kv_pool.init_paged_caches(jcfg, b, 1 + b * 6, bs,
                                               dtype=jnp.float32)
        port = kv_pool.init_paged_caches(cfg, b, 1 + b * 6, bs,
                                         torch.float32, "cpu")
    else:
        tables = None
        jcache = jax.tree.map(lambda a: a, jax_sd.init_caches(
            jcfg, b, max_len, dtype=jnp.float32))
        port = init_caches(cfg, b, max_len, torch.float32, "cpu")
    vals = _random_caches(jcache, rng)
    port = _to_port(vals, port)
    jt = None if tables is None else jnp.asarray(tables)
    want = jax_sd.compact_tree_caches(
        jcfg, jax.tree.map(jnp.asarray, vals), jnp.asarray(src_pos),
        jnp.asarray(n), depth, jt, bs)
    sd.compact_tree_caches(
        cfg, port, torch.from_numpy(src_pos), torch.from_numpy(n).long(),
        depth, None if tables is None else torch.from_numpy(tables), bs)
    _assert_caches_close(port, want, skip_block0=tables is not None)


# ------------------------------------------------------ one tree step
def _state_arrays(bank, max_len):
    """Four rows: two decoding rows on different templates, a prefilling
    row, a done row."""
    rng = np.random.default_rng(7)
    gen = rng.integers(0, 512, (4, max_len)).astype(np.int32)
    return dict(gen=gen, n=np.array([20, 30, 13, 2], np.int32),
                m=np.array([19, 27, 12, 1], np.int32),
                done=np.array([False, False, False, True]),
                tree_idx=np.array([1, 2, 0, 0], np.int32),
                pf_pos=np.array([20, 30, 3, 0], np.int32),
                pf_len=np.array([20, 30, 12, 0], np.int32))


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_tree_step_matches_jax(models, jax_models, layout, monkeypatch):
    """One greedy tree step of the port against the JAX tree step (jnp
    attention backend) from the same state: committed tokens, counters,
    accepted depths and ranks exactly; target and draft KV after the
    compaction to 2e-3. Both run fp32 activations (the JAX decoder's
    forwards default to bf16, so its module's ``forward`` is pinned to
    fp32 here). The target drafts for itself over caches holding the same
    values, so rows accept depths > 0."""
    monkeypatch.setattr(jax_sd, "forward",
                        functools.partial(jax_forward, dtype=jnp.float32))
    tc, tp, _, _ = models
    jtc, jtp, _, _ = jax_models
    bank = sd.TemplateBank.default(4)
    jbank = jax_sd.TemplateBank.default(4)
    max_len, bs = 64, 8
    paged = layout == "paged"
    arr = _state_arrays(bank, max_len)
    rng = np.random.default_rng(8)
    tables = None
    if paged:
        tables = np.zeros((4, max_len // bs), np.int32)
        tables[:3] = rng.permutation(np.arange(1, 25)).reshape(3, 8)
        nb = 25
        jcache = jax_kv_pool.init_paged_caches(jtc, 4, nb, bs,
                                               dtype=jnp.float32)
    else:
        jcache = jax_sd.init_caches(jtc, 4, max_len, dtype=jnp.float32)
    vals = _random_caches(jcache, rng)

    jdec = jax_sd.SpecDecoder(jtp, jtc, jtp, jtc, max_len=max_len,
                              kv_block_size=bs if paged else 0, tree=jbank)
    jstate = jax_sd.DecodeState(
        gen=jnp.asarray(arr["gen"]), n=jnp.asarray(arr["n"]),
        m=jnp.asarray(arr["m"]), done=jnp.asarray(arr["done"]),
        tcache=jax.tree.map(jnp.asarray, vals),
        dcache=jax.tree.map(jnp.asarray, vals),
        tables=None if tables is None else jnp.asarray(tables),
        temp=jnp.zeros(4, jnp.float32),
        rngs=jax_acceptance.make_row_keys(0, np.arange(4)),
        tree_idx=jnp.asarray(arr["tree_idx"]),
        pf_pos=jnp.asarray(arr["pf_pos"]), pf_len=jnp.asarray(arr["pf_len"]))
    jnew, ja, _, _, jrank, _ = jax.jit(jdec._build_tree_step(
        chunked=True, greedy_only=True))(jstate)

    dec = sd.SpecDecoder(tp, tc, tp, tc, kv_block_size=bs if paged else 0,
                         tree=bank)

    def caches():
        if paged:
            return _to_port(vals, kv_pool.init_paged_caches(
                tc, 4, nb, bs, torch.float32, "cpu"))
        return _to_port(vals, init_caches(tc, 4, max_len, torch.float32,
                                          "cpu"))

    t = {k: torch.from_numpy(v.astype(np.int64) if v.dtype == np.int32
                             else v) for k, v in arr.items()}
    state = sd.DecodeState(
        gen=t["gen"], n=t["n"], m=t["m"], done=t["done"], tcache=caches(),
        dcache=caches(),
        tables=None if tables is None else torch.from_numpy(tables),
        tree_idx=t["tree_idx"], pf_pos=t["pf_pos"], pf_len=t["pf_len"])
    new, a, rank = dec._build_tree_step(chunked=True, greedy_only=True)(state)

    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(rank.numpy(), np.asarray(jrank))
    for f in ("gen", "n", "m", "pf_pos"):
        np.testing.assert_array_equal(getattr(new, f).numpy(),
                                      np.asarray(getattr(jnew, f)))
    _assert_caches_close(new.tcache, jnew.tcache, skip_block0=paged)
    _assert_caches_close(new.dcache, jnew.dcache, skip_block0=paged)
    assert a[:2].max() >= 1                      # a decoding row accepted


# --------------------------------------------------- config and submit
def test_engine_config_trees():
    cfg = EngineConfig(adaptive_tree=True)
    assert cfg.tree.key == jax_config.EngineConfig(adaptive_tree=True).tree.key
    assert EngineConfig(tree=(2, 2, 1)).tree.key == "2x2x1"
    ns = dataclasses.make_dataclass("NS", [("tree", str), ("k", int)])(
        "3,1,1", 3)
    assert EngineConfig.from_args(ns).tree.key == "3x1x1"
    for kw in (dict(tree=(2, 2), mode="ar"), dict(adaptive_tree=True,
                                                  mode="ar"),
               dict(adaptive_tree=True, tree=(2, 2)), dict(tree_ewma=0.0),
               dict(tree_reselect_every=0)):
        with pytest.raises(ValueError):
            EngineConfig(**kw)
    assert EngineConfig(kv_layout="contiguous").paged is False


def test_submit_slack_per_template(models):
    """Paged: a request is sized by its own template's slack; contiguous:
    by the bank's widest, whatever is pinned (batch-wide writes)."""
    tc, tp, _, _ = models
    bank = sd.TemplateBank.from_templates(BANK)
    prompt = np.arange(10) % 512
    # 10 + 32 + 31 (wide) = 73 > 64, but + 10 (chain) = 52 fits
    eng = Engine(tp, tc, tp, tc, config=EngineConfig(
        max_batch=1, max_len=64, kv_block_size=32, tree=bank), device="cpu")
    with pytest.raises(ValueError, match="cache positions"):
        eng.submit(prompt, params=SamplingParams(max_new=32, tree_idx=2))
    with pytest.raises(ValueError, match="tree_idx"):
        eng.submit(prompt, params=SamplingParams(max_new=8, tree_idx=7))
    eng.submit(prompt, params=SamplingParams(max_new=32, tree_idx=0))
    eng.submit(prompt, 32)                         # unpinned: feasible ones
    assert [c.generated for c in eng.run()] == [32, 32]
    cont = Engine(tp, tc, tp, tc, config=EngineConfig(
        max_batch=1, max_len=64, kv_layout="contiguous", tree=bank),
        device="cpu")
    with pytest.raises(ValueError, match="cache positions"):
        cont.submit(prompt, params=SamplingParams(max_new=32, tree_idx=0))
    flat = Engine(tp, tc, None, None, config=EngineConfig(mode="ar"),
                  device="cpu")
    with pytest.raises(ValueError, match="tree_idx"):
        flat.submit(prompt, params=SamplingParams(max_new=8, tree_idx=0))


# ------------------------------------------------- engines in the port
SMALL = dict(max_batch=2, max_len=128, kv_block_size=16, kv_dtype="fp32")


@pytest.fixture(scope="module")
def ar_ref(models):
    prompts = _prompts(9, 5)
    _, ar = _serve(models, prompts, mode="ar", **SMALL)
    return prompts, ar


def _same(got, want):
    for i in want:
        np.testing.assert_array_equal(got[i], want[i])


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_tree_greedy_equals_ar(models, ar_ref, layout):
    """Mixed pinned templates (chain, balanced, wide) in one batch, the
    target drafting for itself: token-identical to AR, deep accepts."""
    prompts, ar = ar_ref
    eng, got = _serve(models, prompts, self_draft=True,
                      tree=sd.TemplateBank.from_templates(BANK),
                      tree_idx=[0, 1, 2, 1, 2], kv_layout=layout, **SMALL)
    _same(got, ar)
    assert eng.mean_accepted() > 1.5
    assert int(eng.stats["tree_hist"].sum()) == eng.stats["live_steps"]


def test_chain_equals_flat_and_layouts_agree(models, ar_ref):
    """A degenerate chain (1,)*K gives the flat-K tokens and acceptance;
    paged == contiguous for flat PARD and for a tree (the real draft)."""
    prompts, ar = ar_ref
    out = {}
    for name, kw in (("flat-paged", dict(k=4)),
                     ("flat-contig", dict(k=4, kv_layout="contiguous")),
                     ("chain-paged", dict(tree=(1, 1, 1, 1))),
                     ("tree-paged", dict(tree=(2, 2, 1, 1))),
                     ("tree-contig", dict(tree=(2, 2, 1, 1),
                                          kv_layout="contiguous"))):
        eng, toks = _serve(models, prompts, **kw, **SMALL)
        out[name] = (toks, eng.stats["accepted"], eng.stats["steps"])
        _same(toks, ar)
    assert out["chain-paged"][1:] == out["flat-paged"][1:]
    assert out["flat-contig"][1:] == out["flat-paged"][1:]
    assert out["tree-contig"][1:] == out["tree-paged"][1:]


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_adaptive_engine_lossless_and_accounted(models, ar_ref, layout):
    prompts, ar = ar_ref
    eng, got = _serve(models, prompts, self_draft=True, k=4,
                      adaptive_tree=True, tree_reselect_every=2,
                      kv_layout=layout, **SMALL)
    _same(got, ar)
    assert int(eng.stats["tree_hist"].sum()) == eng.stats["live_steps"]
    assert eng.mean_accepted() > 1.5
    assert eng.peak_kv_bytes_in_use <= eng.kv_capacity_bytes()


def test_adaptive_falls_back_to_pool_sized_template(models):
    """A pool sized for the chain only: admission serves the request on
    the narrowest feasible template instead of blocking."""
    tc, tp, _, _ = models
    prompt = _prompts(10, 1, 8, 9)[0]
    eng = Engine(tp, tc, tp, tc, config=EngineConfig(
        max_batch=1, max_len=128, kv_block_size=8, kv_num_blocks=7,
        adaptive_tree=True, tree=sd.TemplateBank.from_templates(BANK),
        kv_dtype="fp32"), device="cpu")
    eng.submit(prompt, 16)
    comps = eng.run()
    assert len(comps) == 1 and comps[0].generated == 16
    assert eng.stats["tree_hist"][0] == eng.stats["live_steps"]
