"""The port's COD packing and Markov corpus against the JAX package.

``repro_torch.core.cod`` and ``repro_torch.data.pipeline`` are numpy
copies: the same seed must give bit-identical packed batches and token
streams. The port's ``check_invariants`` carries one repair: it bounds
each subtask by the previous subtask's actual count, so the recorded
reproducer (n=8, k=6, r=0.25, r_min=0.25, seed=8: packed counts
[8, 2, 1, 1, 0, 0]) passes in the port while the reference's checker,
which reads an emptied subtask as full, rejects it.
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import cod as jax_cod
from repro.data.pipeline import MarkovCorpus as JaxCorpus
from repro_torch.core import cod
from repro_torch.data.pipeline import MarkovCorpus

MASK = 512


@pytest.mark.parametrize("n,k,r,r_min,seed,drop", [
    (48, 4, 0.7, 0.2, 0, True),
    (512, 8, 0.7, 0.2, 3, True),
    (100, 6, 0.5, 0.0, 11, True),
    (33, 8, 0.9, 0.3, 7, True),
    (64, 5, 0.7, 0.2, 2, False),
])
def test_pack_batch_bit_identical(n, k, r, r_min, seed, drop):
    tokens = np.random.default_rng(seed).integers(0, 500, (3, n))
    mine = cod.pack_batch(tokens, cod.CodConfig(k, r, r_min, drop), MASK,
                          seed=seed)
    theirs = jax_cod.pack_batch(tokens, jax_cod.CodConfig(k, r, r_min, drop),
                                MASK, seed=seed)
    assert mine.keys() == theirs.keys()
    for key in mine:
        assert mine[key].dtype == theirs[key].dtype, key
        np.testing.assert_array_equal(mine[key], theirs[key])
    for row in range(3):
        sample = {key: v[row] for key, v in mine.items()}
        cod.check_invariants(sample, tokens[row],
                             cod.CodConfig(k, r, r_min, drop), MASK)


def test_sizes_and_bound_match_jax():
    for n in (8, 48, 512, 1000):
        for cfg in ((8, 0.7, 0.2), (4, 0.5, 0.0), (6, 0.25, 0.25)):
            np.testing.assert_array_equal(
                cod.subtask_sizes(n, cod.CodConfig(*cfg)),
                jax_cod.subtask_sizes(n, jax_cod.CodConfig(*cfg)))
            assert cod.packed_len_bound(n, cod.CodConfig(*cfg)) == \
                jax_cod.packed_len_bound(n, jax_cod.CodConfig(*cfg))
    # the packed length of the PARD training cell: 512 + 358 + 251 + 176 +
    # 123 + 102 + 102 + 102
    assert cod.packed_len_bound(512, cod.CodConfig(8, 0.7, 0.2)) == 1726
    assert cod.IGNORE == jax_cod.IGNORE


def _reproducer():
    n, k, r, r_min, seed = 8, 6, 0.25, 0.25, 8
    tokens = np.random.default_rng(seed).integers(0, 500, size=n)
    packed = cod.pack_sample(tokens, cod.CodConfig(k, r, r_min), MASK,
                             np.random.default_rng(seed + 1))
    return tokens, packed, (k, r, r_min)


def test_check_invariants_repair_on_the_recorded_reproducer():
    tokens, packed, cfg = _reproducer()
    counts = [int((packed["segment"] == s).sum()) for s in range(1, 7)]
    assert counts == [8, 2, 1, 1, 0, 0]
    cod.check_invariants(packed, tokens, cod.CodConfig(*cfg), MASK)
    with pytest.raises(AssertionError):           # the reference's checker
        jax_cod.check_invariants(packed, tokens, jax_cod.CodConfig(*cfg), MASK)


def test_check_invariants_still_catches_broken_packings():
    tokens = np.random.default_rng(0).integers(0, 500, size=40)
    cfg = cod.CodConfig(5, 0.7, 0.2)
    packed = cod.pack_sample(tokens, cfg, MASK, np.random.default_rng(1))
    cod.check_invariants(packed, tokens, cfg, MASK)
    seg = packed["segment"]
    broken = []
    lab = dict(packed, labels=packed["labels"].copy())
    lab["labels"][int(np.nonzero(seg == 2)[0][0])] += 1          # wrong label
    broken.append(lab)
    chain = dict(packed, segment=seg.copy())
    chain["segment"][np.nonzero(seg == 2)[0]] = 0                 # chain gap
    broken.append(chain)
    pos = dict(packed, position_ids=packed["position_ids"].copy())
    pos["position_ids"][int(np.nonzero(seg == 3)[0][0])] += 1     # position
    broken.append(pos)
    small = dict(packed, segment=seg.copy())
    small["segment"][np.nonzero(seg == 4)[0][1:]] = 0             # too few
    broken.append(small)
    for bad in broken:
        with pytest.raises(AssertionError):
            cod.check_invariants(bad, tokens, cfg, MASK)


@settings(max_examples=40, derandomize=True, database=None, deadline=None)
@given(n=st.integers(8, 200), k=st.integers(1, 8), r=st.floats(0.1, 1.0),
       r_min=st.floats(0.0, 0.5), seed=st.integers(0, 10_000))
def test_cod_invariants_hold_in_the_port(n, k, r, r_min, seed):
    tokens = np.random.default_rng(seed).integers(0, 500, size=n)
    cfg = cod.CodConfig(k=k, r=r, r_min=r_min)
    packed = cod.pack_sample(tokens, cfg, MASK, np.random.default_rng(seed + 1))
    cod.check_invariants(packed, tokens, cfg, MASK)


def test_markov_corpus_streams_match_jax():
    for kw in (dict(vocab_size=512, seed=0), dict(vocab_size=777, seed=3,
                                                  determinism=2.0)):
        mine, theirs = MarkovCorpus(**kw), JaxCorpus(**kw)
        a, b = mine.batches(3, 40, seed=5), theirs.batches(3, 40, seed=5)
        for _ in range(3):
            np.testing.assert_array_equal(next(a), next(b))
        np.testing.assert_array_equal(
            mine.prompts(np.random.default_rng(1), 2, 9),
            theirs.prompts(np.random.default_rng(1), 2, 9))
