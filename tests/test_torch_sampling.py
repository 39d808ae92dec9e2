"""The port's sampled acceptance rules (``repro_torch.core.acceptance``)
against the JAX package on the CPU: the per-row key helpers bit for bit,
and ``leviathan_accept``, ``sampled_tree_accept_rows`` and
``sample_tree_props_rows`` output for output on the same numpy inputs
(the keys draw the same bits, the probabilities are the same floats).
Then the distribution identities of the two acceptance rules, vectorised
over trials as batch rows: the first committed token is distributed as
the target, total variation < 0.05 over 4000 trials.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import acceptance as jax_acc
from repro.core.spec_decode import TemplateBank as JaxBank
from repro.core.spec_decode import TreeTemplate as JaxTree
from repro_torch.core import acceptance as acc
from repro_torch.core import prng
from repro_torch.core.spec_decode import TemplateBank, TreeTemplate

SEEDS = [0, 3, 2 ** 31 - 1]


def words(a):
    return np.asarray(a).astype(np.int64)


def t(a):
    return torch.from_numpy(np.asarray(a))


def probs(rng, *shape, scale=2.0):
    x = rng.standard_normal(shape) * scale
    e = np.exp(x - x.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).astype(np.float32)


def draw(rng, q):
    """Tokens drawn from the last axis of q (numpy)."""
    flat = q.reshape(-1, q.shape[-1]).astype(np.float64)
    out = [rng.choice(q.shape[-1], p=row / row.sum()) for row in flat]
    return np.asarray(out, np.int64).reshape(q.shape[:-1])


def same(got, want):
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------ row keys
@pytest.mark.parametrize("seed", SEEDS)
def test_row_key_helpers_match(seed):
    ids = np.array([0, 1, 5, 1000, 2 ** 32 - 1], np.uint32)
    jk = jax_acc.make_row_keys(seed, ids)
    tk = acc.make_row_keys(seed, ids.astype(np.int64))
    np.testing.assert_array_equal(tk.numpy(), words(jk))
    jn, ju = jax_acc.split_row_keys(jk)
    tn, tu = acc.split_row_keys(tk)
    np.testing.assert_array_equal(tn.numpy(), words(jn))
    np.testing.assert_array_equal(tu.numpy(), words(ju))
    for tag in (0, 1, 7):
        np.testing.assert_array_equal(acc.fold_row_keys(tk, tag).numpy(),
                                      words(jax_acc.fold_row_keys(jk, tag)))
    np.testing.assert_array_equal(acc.row_uniform(tk).numpy(),
                                  np.asarray(jax_acc.row_uniform(jk)))
    lg = probs(np.random.default_rng(seed % 101), 5, 64)
    np.testing.assert_array_equal(
        acc.row_categorical(tk, t(np.log(lg))).numpy(),
        np.asarray(jax_acc.row_categorical(jk, jnp.log(lg))))


def test_scale_logits_and_temp_softmax_match():
    rng = np.random.default_rng(1)
    lg = rng.standard_normal((4, 3, 50)).astype(np.float32) * 3
    temp = np.array([0.0, 0.8, 1.0, 2.5], np.float32)
    np.testing.assert_array_equal(
        acc.scale_logits(t(lg), t(temp)).numpy(),
        np.asarray(jax_acc.scale_logits(jnp.asarray(lg), jnp.asarray(temp))))
    np.testing.assert_allclose(
        acc.temp_softmax(t(lg), t(temp)).numpy(),
        np.asarray(jax_acc.temp_softmax(jnp.asarray(lg), jnp.asarray(temp))),
        rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------- flat chain
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("k", [1, 4, 8])
def test_leviathan_accept_matches(seed, k):
    """Random draft / target pairs, plus rows whose draft equals the target
    (every draft accepted: the bonus draw from the padded residual)."""
    rng = np.random.default_rng(seed % 1009 + k)
    b, v = 6, 40
    p = probs(rng, b, k + 1, v)
    q = probs(rng, b, k, v)
    q[:2] = p[:2, :k]
    props = draw(rng, q)
    keys_j = jax_acc.make_row_keys(seed, np.arange(b))
    keys_t = acc.make_row_keys(seed, np.arange(b))
    want = jax_acc.leviathan_accept(jnp.asarray(p), jnp.asarray(q),
                                    jnp.asarray(props, jnp.int32), keys_j)
    got = acc.leviathan_accept(t(p), t(q), t(props), keys_t)
    same(got, want)
    assert int(got[0][:2].min()) == k           # q == p accepts everything


def test_speculative_accept_matches():
    rng = np.random.default_rng(4)
    p, q = probs(rng, 3, 5, 30), probs(rng, 3, 4, 30)
    props = draw(rng, q)
    want = jax_acc.speculative_accept(jnp.asarray(p), jnp.asarray(q),
                                      jnp.asarray(props, jnp.int32),
                                      jax.random.PRNGKey(9))
    same(acc.speculative_accept(t(p), t(q), t(props), prng.key(9)), want)


# ---------------------------------------------------------------- tree
def _bank_case(seed, b=8, v=40, k=4):
    """Per-row templates from the default bank (chain, (2,2,2,1) and
    (3,2,1,1) at K=4): padded slots, rows offered fewer siblings than
    max_b, and a few rows whose draft equals the target."""
    rng = np.random.default_rng(seed % 1013)
    jbank, bank = JaxBank.default(k), TemplateBank.default(k)
    assert jbank.key == bank.key
    sel = rng.integers(0, len(bank), b)
    s, d = bank.max_slots, bank.max_depth
    p = probs(rng, b, s, v)
    q = probs(rng, b, d, v)
    p[:2] = np.repeat(q[:2, :1], s, axis=1)       # a target the draft matches
    return rng, bank, sel, p, q


@pytest.mark.parametrize("seed", SEEDS)
def test_sample_tree_props_rows_matches(seed):
    rng, bank, sel, _, q = _bank_case(seed)
    scaled = np.log(q) / 0.7
    depth = bank.depth[sel][:, 1:]
    keys_j = jax_acc.make_row_keys(seed, np.arange(len(sel)))
    want = jax_acc.sample_tree_props_rows(jnp.asarray(scaled),
                                          jnp.asarray(depth), keys_j)
    got = acc.sample_tree_props_rows(t(scaled), t(depth.astype(np.int64)),
                                     acc.make_row_keys(seed,
                                                       np.arange(len(sel))))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS + [11, 12])
def test_sampled_tree_accept_rows_matches(seed):
    rng, bank, sel, p, q = _bank_case(seed)
    b = len(sel)
    keys_j = jax_acc.make_row_keys(seed, np.arange(b))
    keys_t = acc.make_row_keys(seed, np.arange(b))
    props_j = jax_acc.sample_tree_props_rows(
        jnp.log(jnp.asarray(q)), jnp.asarray(bank.depth[sel][:, 1:]), keys_j)
    props = np.asarray(props_j).astype(np.int64)
    props[:, -3:] = rng.integers(0, p.shape[-1], (b, 3))   # padded slots too
    cm = bank.child_map[sel]
    want = jax_acc.sampled_tree_accept_rows(
        jnp.asarray(p), jnp.asarray(q), jnp.asarray(props, jnp.int32),
        jnp.asarray(cm), jax_acc.fold_row_keys(keys_j, 1), bank.max_depth,
        bank.max_branching)
    got = acc.sampled_tree_accept_rows(
        t(p), t(q), t(props), t(cm.astype(np.int64)),
        acc.fold_row_keys(keys_t, 1), bank.max_depth, bank.max_branching)
    same(got, want)


@pytest.mark.parametrize("branching", [(3,), (2, 2), (2, 1, 2)])
def test_single_template_wrappers_match(branching):
    rng = np.random.default_rng(len(branching))
    tree, jtree = (TreeTemplate.from_branching(branching),
                   JaxTree.from_branching(branching))
    b, v = 5, 30
    p, q = probs(rng, b, tree.num_slots, v), probs(rng, b, tree.max_depth, v)
    keys_j = jax_acc.make_row_keys(2, np.arange(b))
    keys_t = acc.make_row_keys(2, np.arange(b))
    props_j = jax_acc.sample_tree_props(jtree, jnp.log(jnp.asarray(q)), keys_j)
    props_t = acc.sample_tree_props(tree, t(np.log(q)), keys_t)
    np.testing.assert_array_equal(props_t.numpy(), np.asarray(props_j))
    same(acc.sampled_tree_accept(tree, t(p), t(q), props_t, keys_t),
         jax_acc.sampled_tree_accept(jtree, jnp.asarray(p), jnp.asarray(q),
                                     props_j, keys_j))


# --------------------------------------------------------- distributions
def _target_and_draft(v=8):
    key = jax.random.PRNGKey(0)
    p = jax.nn.softmax(jax.random.normal(jax.random.fold_in(key, 1), (v,)) * 1.5)
    q = jax.nn.softmax(jax.random.normal(jax.random.fold_in(key, 2), (v,)) * 1.5)
    return np.array(p, np.float32), np.array(q, np.float32)


def _tv(firsts, p):
    emp = np.bincount(firsts, minlength=len(p)) / len(firsts)
    return 0.5 * np.abs(emp - p).sum()


def test_speculative_sampling_preserves_distribution():
    """Leviathan acceptance identity: for any draft q, the first committed
    token is distributed as the target p (4000 trials as batch rows)."""
    v, k, trials = 8, 3, 4000
    p, q = _target_and_draft(v)
    keys = prng.split(prng.key(7), trials)                 # [T, 2]
    r = prng.split(keys, 2)
    props = prng.categorical(r[:, 0], torch.from_numpy(np.log(q))
                             .expand(trials, k, v).contiguous())
    a, _, commit = acc.leviathan_accept(
        torch.from_numpy(p).expand(trials, k + 1, v),
        torch.from_numpy(q).expand(trials, k, v), props, r[:, 1])
    first = torch.where(a >= 1, props[:, 0], commit).numpy()
    tv = _tv(first, p)
    assert tv < 0.05, f"TV distance {tv}"


@pytest.mark.parametrize("branching", [(3,), (2, 2)])
def test_multi_round_accept_preserves_distribution(branching):
    """The recursive rejection sampling identity: for any draft q, the
    first committed token of ``sampled_tree_accept`` is distributed as the
    target p (4000 trials as batch rows)."""
    v, trials = 8, 4000
    p, q = _target_and_draft(v)
    tree = TreeTemplate.from_branching(branching)
    s, d = tree.num_slots, tree.max_depth
    r = prng.split(prng.split(prng.key(7), trials), 2)
    props = prng.categorical(r[:, 0], torch.from_numpy(np.log(q))
                             .expand(trials, tree.num_nodes, v).contiguous())
    a, toks, _, commit, _ = acc.sampled_tree_accept(
        tree, torch.from_numpy(p).expand(trials, s, v),
        torch.from_numpy(q).expand(trials, d, v), props, r[:, 1])
    first = torch.where(a >= 1, toks[:, 0], commit).numpy()
    tv = _tv(first, p)
    assert tv < 0.05, f"TV distance {tv}"


def test_greedy_draft_breaks_the_identity():
    """The gate can fail: proposing the draft's argmax instead of a sample
    moves the first token far from p."""
    v, k, trials = 8, 3, 4000
    p, q = _target_and_draft(v)
    props = torch.full((trials, k), int(np.argmax(q)))
    a, _, commit = acc.leviathan_accept(
        torch.from_numpy(p).expand(trials, k + 1, v),
        torch.from_numpy(q).expand(trials, k, v), props,
        prng.split(prng.key(7), trials))
    first = torch.where(a >= 1, props[:, 0], commit).numpy()
    assert _tv(first, p) > 0.1
