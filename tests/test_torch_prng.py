"""The port's threefry2x32 generator (``repro_torch.core.prng``) against
``jax.random`` on the CPU: keys, folds, splits, bits and uniforms bit for
bit; categorical samples equal index for index. Gumbel noise agrees to a
few float32 ulps only (the two packages' ``log`` differ in the last bit),
which moves a categorical sample only at a true tie of the noisy logits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import prng

SEEDS = [0, 1, 7, 42, 123456789, 2 ** 31 - 1]
TINY = float(np.finfo(np.float32).tiny)


def words(a):
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS + [-1, 2 ** 32 + 5])
def test_key_matches_prngkey(seed):
    np.testing.assert_array_equal(prng.key(seed).numpy(),
                                  words(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_and_split_match(seed):
    jk, tk = jax.random.PRNGKey(seed), prng.key(seed)
    for data in (0, 5, 1000, 2 ** 32 - 1):
        np.testing.assert_array_equal(prng.fold_in(tk, data).numpy(),
                                      words(jax.random.fold_in(jk, data)))
    for n in (2, 3, 8):
        np.testing.assert_array_equal(prng.split(tk, n).numpy(),
                                      words(jax.random.split(jk, n)))
    # vectorised over data and over leading key axes
    data = np.array([3, 9, 2 ** 31], np.uint32)
    want = jax.vmap(lambda d: jax.random.fold_in(jk, d))(data)
    np.testing.assert_array_equal(
        prng.fold_in(tk, torch.from_numpy(data.astype(np.int64))).numpy(),
        words(want))
    keys = jax.random.split(jk, 4)
    want = jax.vmap(lambda k: jax.random.split(k, 2))(keys)
    np.testing.assert_array_equal(prng.split(torch.from_numpy(words(keys)),
                                             2).numpy(), words(want))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape", [(), (3,), (2, 5), (1000,)])
def test_bits_match(seed, shape):
    np.testing.assert_array_equal(
        prng.bits(prng.key(seed), shape).numpy(),
        words(jax.random.bits(jax.random.PRNGKey(seed), shape)))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("minval", [0.0, TINY])
def test_uniform_matches_bitwise(seed, minval):
    jk, tk = jax.random.PRNGKey(seed), prng.key(seed)
    for shape in ((), (7,), (4, 250)):
        want = np.asarray(jax.random.uniform(jk, shape, minval=minval))
        got = prng.uniform(tk, shape, minval=minval).numpy()
        assert got.dtype == np.float32 and got.shape == shape
        np.testing.assert_array_equal(got.view(np.int32),
                                      want.view(np.int32))
    want = np.asarray(jax.random.uniform(jk, (64,), minval=-2.0, maxval=3.0))
    np.testing.assert_array_equal(
        prng.uniform(tk, (64,), minval=-2.0, maxval=3.0).numpy(), want)


def test_uniform_per_row_keys_match_vmap():
    keys = jax.random.split(jax.random.PRNGKey(11), 6)
    want = jax.vmap(lambda k: jax.random.uniform(k, (5,)))(keys)
    got = prng.uniform(torch.from_numpy(words(keys)), (5,))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_ulps(seed):
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed), (4000,)))
    got = prng.gumbel(prng.key(seed), (4000,)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-6)


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_over_v_matches(seed):
    rng = np.random.default_rng(seed % 1000)
    for v in (8, 1000):
        for scale in (1.0, 5.0):
            lg = (rng.standard_normal(v) * scale).astype(np.float32)
            want = int(jax.random.categorical(jax.random.PRNGKey(seed), lg))
            got = prng.categorical(prng.key(seed), torch.from_numpy(lg))
            assert got.dtype == torch.int64 and got.shape == ()
            assert int(got) == want


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_kv_under_vmapped_row_keys_matches(seed):
    """One key per row draws the whole [K, V] block (the PARD proposals'
    draw), as ``vmap(categorical)`` over rows does."""
    b, k, v = 3, 4, 300
    rng = np.random.default_rng(seed % 997)
    lg = (rng.standard_normal((b, k, v)) * 2).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), b)
    want = jax.vmap(lambda kk, row: jax.random.categorical(kk, row))(
        keys, jnp.asarray(lg))
    got = prng.categorical(torch.from_numpy(words(keys)), torch.from_numpy(lg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_categorical_many_seeds_agree():
    """Index for index over 200 seeds of 1000 classes."""
    rng = np.random.default_rng(0)
    lg = rng.standard_normal((200, 1000)).astype(np.float32)
    keys = jax.vmap(jax.random.PRNGKey)(jnp.arange(200))
    want = jax.vmap(jax.random.categorical)(keys, jnp.asarray(lg))
    got = prng.categorical(torch.from_numpy(words(keys)), torch.from_numpy(lg))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_no_host_state():
    """Draws read no torch.Generator and leave the global one alone; the
    same keys give the same draws twice."""
    before = torch.get_rng_state()
    k = prng.split(prng.key(3), 4)
    first = prng.categorical(k, torch.zeros(4, 50))
    second = prng.categorical(k, torch.zeros(4, 50))
    assert torch.equal(first, second)
    assert torch.equal(torch.get_rng_state(), before)


def test_rejects_bad_keys():
    with pytest.raises(TypeError):
        prng.bits(torch.zeros(3, dtype=torch.int64))
    with pytest.raises(TypeError):
        prng.bits(torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        prng.categorical(prng.split(prng.key(0), 3), torch.zeros(2, 5))
    with pytest.raises(ValueError):
        prng.key(2 ** 64)
