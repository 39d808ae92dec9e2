"""The port's prefix cache on the CPU: the refcounted ``BlockAllocator``
against the JAX package's, operation by operation; the content keys byte
for byte; the allocator's invariants (kv_pool I1, I2, I5) under the unit
cases and random interleavings of ``tests/test_prefix_cache.py``; and the
engine: cache-hit completions token-identical to cold ones and to the
contiguous layout, live sharing, the refusals, and warm tokens and hit
statistics equal to the JAX Engine's.

Engine runs compare fp32 activations and fp32 KV on both sides: the JAX
decoder's module ``forward`` is pinned to fp32 for this module (restored
after it).

The JAX engine accepts ``prefix_cache=True`` with a Mamba2 model, where a
hit moves the prefill cursor past the cached blocks while admission zeroes
the row's recurrent state, so the state never sees the cached tokens. The
port refuses such a model; a test below shows the fault on the JAX
engine's state.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs import get_config as jax_get_config
from repro.core import spec_decode as jax_sd
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.serving import kv_pool as jax_kv_pool
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import Engine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.interop import params_from_numpy
from repro_torch.models.config import ModelConfig
from repro_torch.serving import kv_pool
from repro_torch.serving.config import EngineConfig, SamplingParams
from repro_torch.serving.engine import Engine
from repro_torch.serving.kv_pool import BlockAllocator, prefix_block_keys

HYBRID = dict(name="hybrid-test", arch_type="hybrid", num_layers=4,
              attn_every=2, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
              d_ff=128, vocab_size=512, ssm_state=16, ssm_headdim=32,
              ssm_chunk=8, tie_embeddings=True, max_seq_len=1024,
              source="test")
SMALL = dict(k=4, max_batch=2, max_len=256, kv_block_size=16, seed=0)
TEMPS = {"greedy": [0.0] * 5, "mixed-sampled": [0.0, 0.8, 0.0, 0.7, 0.8]}


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


# --------------------------------------------------------------- invariants
def check_invariants(a: BlockAllocator):
    """Every structural invariant the allocator holds between operations."""
    # I1: the garbage block is never handed out, cached or refcounted
    assert 0 not in a.free and 0 not in a.lru and a.ref[0] == 0
    for blocks in a.owned.values():
        assert 0 not in blocks
    counts = {}
    for blocks in a.owned.values():
        for b in blocks:
            counts[b] = counts.get(b, 0) + 1
    for b in range(a.num_blocks):
        assert a.ref[b] == counts.get(b, 0), f"ref drift on block {b}"
    # I5: free or parked iff unmapped; only computed registered blocks park
    for b in list(a.free) + list(a.lru):
        assert a.ref[b] == 0
    assert not set(a.free) & set(a.lru)
    for b in a.lru:
        assert b in a.block_key and b in a.computed
    for key, b in a.index.items():
        assert a.block_key.get(b) == key
    for b, key in a.block_key.items():
        assert a.index.get(key) == b
    assert a.computed <= set(a.block_key)
    # I2: a block mapped by >= 2 slots is computed and writable in at most
    # one table (its original prefiller's)
    for b, c in counts.items():
        if c >= 2:
            assert b in a.computed, f"shared uncomputed block {b}"
            writable = sum(
                1 for s, blocks in a.owned.items()
                if b in blocks
                and blocks.index(b) not in a.read_only.get(s, set()))
            assert writable <= 1, f"block {b} writable in {writable} tables"


def _admit(a, slot: int, prompt, max_new=8, slack=10, keys_of=None):
    """The scheduler's admission protocol against a bare allocator."""
    keys = (keys_of or prefix_block_keys)(prompt, a.block_size)
    hit = a.match_prefix(keys)
    need = len(prompt) + max_new + slack
    if not a.can_allocate(a.blocks_needed(need) - len(hit), hit):
        return None
    a.allocate(slot, need, prefix=hit, keys=keys)
    return len(hit) * a.block_size


# ------------------------------------------------- port vs JAX, op by op
def _snapshot(a):
    return dict(tables=a.tables.tolist(), ref=a.ref.tolist(),
                free=list(a.free), lru=list(a.lru), index=dict(a.index),
                block_key=dict(a.block_key), computed=sorted(a.computed),
                owned={s: list(b) for s, b in a.owned.items()},
                read_only={s: sorted(r) for s, r in a.read_only.items()},
                version=a.version, in_use=a.blocks_in_use)


def _differential(rng, n_ops=80, num_blocks=14, block_size=4, max_batch=3):
    """One random sequence of allocate (with matches and keys) /
    mark_computed / grow / copy_on_write / release through both
    allocators; both hold equal state after every operation."""
    mine = BlockAllocator(num_blocks, block_size, max_batch, 64)
    theirs = jax_kv_pool.BlockAllocator(num_blocks, block_size, max_batch, 64)
    base = rng.integers(0, 512, size=40)
    # prompts that share 0-3 leading blocks, and unique ones
    pool = [np.concatenate([base[:int(c)], rng.integers(0, 512, size=int(t))])
            for c, t in zip(rng.integers(0, 14, size=5),
                            rng.integers(2, 10, size=5))]
    for _ in range(n_ops):
        op = int(rng.integers(0, 5))
        live = sorted(mine.owned)
        slot = int(rng.integers(0, max_batch))
        if op == 0 and slot not in mine.owned:
            prompt = pool[int(rng.integers(0, len(pool)))]
            keys = prefix_block_keys(prompt, block_size)
            assert keys == jax_kv_pool.prefix_block_keys(prompt, block_size)
            hit = mine.match_prefix(keys)
            assert hit == theirs.match_prefix(keys)
            need = len(prompt) + int(rng.integers(1, 12))
            nb = mine.blocks_needed(need) - len(hit)
            ok = mine.can_allocate(nb, hit)
            assert ok == theirs.can_allocate(nb, hit)
            if ok and mine.blocks_needed(need) <= mine.max_blocks_per_seq:
                for a in (mine, theirs):
                    a.allocate(slot, need, prefix=hit, keys=keys)
        elif op == 1 and live:
            slot = live[int(rng.integers(0, len(live)))]
            n = int(rng.integers(0, 40))
            for a in (mine, theirs):
                a.mark_computed(slot, n)
        elif op == 2 and live:
            slot = live[int(rng.integers(0, len(live)))]
            n = int(rng.integers(1, 64))
            assert mine.grow(slot, n) == theirs.grow(slot, n)
        elif op == 3 and live:
            slot = live[int(rng.integers(0, len(live)))]
            idx = int(rng.integers(0, len(mine.owned[slot])))
            got = []
            for a in (mine, theirs):
                try:
                    got.append(a.copy_on_write(slot, idx))
                except RuntimeError:
                    got.append("exhausted")
            assert got[0] == got[1]
        elif op == 4 and live:
            slot = live[int(rng.integers(0, len(live)))]
            assert mine.release(slot) == theirs.release(slot)
        assert _snapshot(mine) == _snapshot(theirs)
        check_invariants(mine)
    for slot in sorted(mine.owned):
        mine.release(slot)
        theirs.release(slot)
    assert _snapshot(mine) == _snapshot(theirs)
    assert mine.blocks_in_use == 0


@pytest.mark.parametrize("seed", range(6))
def test_allocator_matches_jax_op_by_op(seed):
    _differential(np.random.default_rng(seed))


@settings(max_examples=40, deadline=None, database=None)
@given(seed=st.integers(0, 2 ** 32 - 1), block_size=st.sampled_from([2, 4, 8]),
       num_blocks=st.integers(4, 20))
def test_allocator_matches_jax_hypothesis(seed, block_size, num_blocks):
    """The same differential sequence, drawn by hypothesis (no example
    database, no global random state)."""
    _differential(np.random.default_rng(seed), n_ops=50,
                  num_blocks=num_blocks, block_size=block_size)


@pytest.mark.parametrize("kv_dtype", ["bf16", "fp32", "int8", "fp8"])
def test_prefix_keys_byte_equal_to_jax(kv_dtype):
    """The keys equal the JAX package's byte for byte, for an int64 prompt
    (the port's) and an int32 one, at block sizes that leave a partial
    block or none."""
    rng = np.random.default_rng(3)
    p64 = rng.integers(0, 128256, size=199)
    for bs in (16, 64, 66):
        for p in (p64, p64.astype(np.int32), p64[:129]):
            mine = prefix_block_keys(p, bs, kv_dtype)
            theirs = jax_kv_pool.prefix_block_keys(
                np.asarray(p, np.int32), bs, kv_dtype=kv_dtype)
            assert mine == theirs
            assert len(mine) == (len(p) - 1) // bs
            assert all(isinstance(k, bytes) for k in mine)
    salted = {d: prefix_block_keys(p64, 64, d)
              for d in ("bf16", "fp32", "int8", "fp8")}
    others = set().union(*(set(v) for d, v in salted.items() if d != kv_dtype))
    assert not set(salted[kv_dtype]) & others
    assert prefix_block_keys(p64, 64) == salted["bf16"]


def test_prefix_keys_are_content_exact():
    p1 = np.asarray([1, 2, 3, 4, 5, 6, 7, 8, 9])
    p3 = np.asarray([1, 2, 3, 9, 5, 6, 7, 8, 9])
    assert prefix_block_keys(p1, 4) == prefix_block_keys(p1.copy(), 4)
    k1, k3 = prefix_block_keys(p1, 4), prefix_block_keys(p3, 4)
    assert k1[0] != k3[0] and k1[1] != k3[1]      # chained: divergence sticks
    assert len(prefix_block_keys(np.arange(9), 4)) == 2
    assert len(prefix_block_keys(np.arange(8), 4)) == 1
    assert len(prefix_block_keys(np.arange(4), 4)) == 0


# ------------------------------------------------------------ unit cases
def test_register_match_and_computed_gating():
    a = BlockAllocator(num_blocks=16, block_size=4, max_batch=4, max_len=64)
    prompt = np.arange(10)                          # p-1 = 9 -> 2 full blocks
    keys = prefix_block_keys(prompt, 4)
    assert len(keys) == 2
    assert _admit(a, 0, prompt) == 0
    # registered but not computed: a concurrent identical prompt misses
    assert a.match_prefix(keys) == []
    a.mark_computed(0, 4)
    assert a.match_prefix(keys) == [a.owned[0][0]]
    a.mark_computed(0, 9)
    assert a.match_prefix(keys) == a.owned[0][:2]
    check_invariants(a)
    # a second slot maps the prefix copy-free: refcount 2, read-only
    assert _admit(a, 1, prompt) == 8
    assert a.owned[1][:2] == a.owned[0][:2]
    assert all(a.ref[b] == 2 for b in a.owned[0][:2])
    assert a.blocks_in_use == len(set(a.owned[0]) | set(a.owned[1]))
    check_invariants(a)
    # releases drop refs; the cached blocks park on the LRU, not free
    a.release(0)
    assert all(a.ref[b] == 1 for b in a.owned[1][:2])
    a.release(1)
    assert len(a.lru) == 2 and all(a.ref[b] == 0 for b in a.lru)
    check_invariants(a)
    assert _admit(a, 2, prompt) == 8                # ...and still serve
    check_invariants(a)


def test_lru_eviction_recycles_cold_blocks_only():
    a = BlockAllocator(num_blocks=8, block_size=4, max_batch=4, max_len=64)
    p1, p2 = np.arange(5), 100 + np.arange(5)       # 1 full block each
    _admit(a, 0, p1, max_new=2, slack=1)
    a.mark_computed(0, 4)
    _admit(a, 1, p2, max_new=2, slack=1)
    a.mark_computed(1, 4)
    a.release(0)
    a.release(1)                                    # LRU: [p1's, p2's]
    assert len(a.lru) == 2
    check_invariants(a)
    # a big allocation drains the free list, then evicts the OLDEST entry
    a.allocate(2, (len(a.free) + 1) * 4)
    assert len(a.lru) == 1
    check_invariants(a)
    assert a.match_prefix(prefix_block_keys(p1, 4)) == []
    assert len(a.match_prefix(prefix_block_keys(p2, 4))) == 1


def test_copy_on_write_detaches_shared_block():
    a = BlockAllocator(num_blocks=16, block_size=4, max_batch=4, max_len=64)
    prompt = np.arange(10)
    _admit(a, 0, prompt)
    a.mark_computed(0, 9)
    _admit(a, 1, prompt)
    shared = a.owned[1][0]
    assert a.ref[shared] == 2
    old, new = a.copy_on_write(1, 0)                # slot 1 wants to write
    assert old == shared and a.ref[old] == 1 and a.ref[new] == 1
    assert a.owned[1][0] == new and a.tables[1, 0] == new
    assert a.owned[0][0] == old                     # the owner keeps it
    assert 0 not in a.read_only[1]
    check_invariants(a)
    # a sole-owner cached block is unregistered instead of copied
    assert a.copy_on_write(0, 0) is None
    assert old not in a.block_key
    check_invariants(a)
    assert a.copy_on_write(1, 2) is None            # exclusive, uncached
    check_invariants(a)


def test_can_allocate_excludes_lru_parked_prefix_blocks():
    """Matched blocks parked on the LRU leave it in ``allocate``, so they
    must not also count as reclaimable: admission reports backpressure
    instead of passing and then failing inside ``allocate``."""
    a = BlockAllocator(num_blocks=4, block_size=4, max_batch=3, max_len=32)
    prompt = np.arange(9)                           # 2 full blocks
    _admit(a, 0, prompt, max_new=2, slack=1)        # 3 blocks
    a.mark_computed(0, 8)
    a.release(0)                                    # 2 on the LRU, 1 free
    a.allocate(1, 4)                                # drains the free list
    hit = a.match_prefix(prefix_block_keys(prompt, 4))
    assert len(hit) == 2 and all(b in a.lru for b in hit)
    assert not a.can_allocate(1, hit)
    assert a.can_allocate(0, hit)
    with pytest.raises(ValueError, match="can_allocate"):
        a.allocate(2, 12, prefix=hit)
    check_invariants(a)
    a.release(1)
    assert a.can_allocate(1, hit)
    assert _admit(a, 2, prompt, max_new=2, slack=1) == 8
    check_invariants(a)


def test_copy_on_write_exhausted_pool_raises_cleanly():
    a = BlockAllocator(num_blocks=4, block_size=4, max_batch=3, max_len=32)
    prompt = np.arange(9)
    _admit(a, 0, prompt, max_new=2, slack=1)        # all 3 usable blocks
    a.mark_computed(0, 8)
    hit = a.match_prefix(prefix_block_keys(prompt, 4))
    a.allocate(1, 8, prefix=hit)                    # maps only the hit
    assert not a.can_allocate(1)
    with pytest.raises(RuntimeError, match="copy-on-write"):
        a.copy_on_write(1, 0)
    check_invariants(a)


def _run_interleaving(a, ops, picks, n_prompts):
    """Submit / prefill / complete / pressure operations, the invariants
    checked after every one. Prompts come from a small pool so sharing,
    computed gating and eviction all happen."""
    prompts = [np.full(11, i) for i in range(n_prompts)]
    live = {}                                       # slot -> (prompt, pf)
    for op, pick in zip(ops, picks):
        if op == 0:
            free = [s for s in range(3) if s not in live]
            if free:
                prompt = prompts[pick % len(prompts)]
                pf = _admit(a, free[0], prompt, max_new=2, slack=1)
                if pf is not None:
                    live[free[0]] = (prompt, pf)
        elif op == 1 and live:
            slot = sorted(live)[pick % len(live)]
            prompt, pf = live[slot]
            pf = min(pf + 5, len(prompt) - 1)
            a.mark_computed(slot, pf)
            live[slot] = (prompt, pf)
        elif op == 2 and live:
            slot = sorted(live)[pick % len(live)]
            a.release(slot)
            del live[slot]
        elif op == 3 and a.can_allocate(2) and 2 not in live:
            unique = 200 + np.arange(9)
            pf = _admit(a, 2, unique, max_new=2, slack=1)
            if pf is not None:
                live[2] = (unique, pf)
        check_invariants(a)
    for slot in list(live):
        a.release(slot)
        check_invariants(a)
    assert a.blocks_in_use == 0


def test_randomized_interleavings_hold_invariants():
    rng = np.random.default_rng(0)
    for _ in range(20):
        _run_interleaving(
            BlockAllocator(num_blocks=12, block_size=4, max_batch=3,
                           max_len=64),
            rng.integers(0, 4, size=40).tolist(),
            rng.integers(0, 100, size=40).tolist(), int(rng.integers(1, 4)))


@settings(max_examples=40, deadline=None, database=None)
@given(ops=st.lists(st.integers(0, 3), min_size=1, max_size=60),
       picks=st.lists(st.integers(0, 99), min_size=60, max_size=60),
       n_prompts=st.integers(1, 4), block_size=st.sampled_from([2, 4, 8]))
def test_hypothesis_interleavings_hold_invariants(ops, picks, n_prompts,
                                                   block_size):
    _run_interleaving(BlockAllocator(num_blocks=12, block_size=block_size,
                                     max_batch=3, max_len=64),
                      ops, picks, n_prompts)


# ------------------------------------------------------------ engine level
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


def shared_prompts(seed, n, sys_len=33, tail=5):
    rng = np.random.default_rng(seed)
    sys_p = rng.integers(0, 512, size=sys_len)
    return [np.concatenate([sys_p, rng.integers(0, 512, size=tail)])
            for _ in range(n)]


def serve_port(prompts, temps, max_new=12, **cfg):
    tc, tp, dc, dp = models()[:4]
    eng = Engine(tp, tc, dp, dc, config=EngineConfig(**{**SMALL, **cfg}),
                 device="cpu")
    rids = {eng.submit(p, params=SamplingParams(max_new=max_new,
                                                temperature=t)): i
            for i, (p, t) in enumerate(zip(prompts, temps))}
    return eng, {rids[c.rid]: c.tokens for c in eng.run()}


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("temps", list(TEMPS))
def test_cache_hit_completions_identical_to_cold(temps, kv_dtype):
    """Warm (prefix-cache hits) == cold paged == contiguous, request by
    request, greedy and with seeded sampled rows, on bf16 and int8 KV: a
    hit serves the exact blocks (codes and scales) the registering
    request wrote, and prefilling rows do not draw from their keys."""
    prompts = shared_prompts(7, 5)
    got = {}
    for name, kw in (("contiguous", dict(kv_layout="contiguous")),
                     ("cold", dict()), ("warm", dict(prefix_cache=True))):
        eng, got[name] = serve_port(prompts, TEMPS[temps], kv_dtype=kv_dtype,
                                    **kw)
        if name == "warm":
            assert eng.prefix_hit_rate() > 0.5
            assert eng.alloc.blocks_in_use == 0
            check_invariants(eng.alloc)
            # each hit block is one block of prompt not prefilled again
            assert eng.stats["prefill_tokens"] == cold_tokens \
                - SMALL["kv_block_size"] * eng.stats["prefix_hit_blocks"]
        else:
            cold_tokens = eng.stats["prefill_tokens"]
    for i in range(len(prompts)):
        assert np.array_equal(got["contiguous"][i], got["cold"][i])
        assert np.array_equal(got["cold"][i], got["warm"][i])


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_live_sharing_refcounts_and_block_savings(kv_dtype):
    """Two later same-prefix requests map the finished request's cached
    blocks copy-free while live (refcount 2 each), draw fewer fresh
    blocks than cold admissions, and copy_on_write on a shared block
    copies every leaf (int8: codes and scales) into the new block."""
    prompts = shared_prompts(8, 3)
    tc, tp, dc, dp = models()[:4]
    eng = Engine(tp, tc, dp, dc, config=EngineConfig(
        **SMALL, prefix_cache=True, kv_dtype=kv_dtype), device="cpu")
    eng.submit(prompts[0], 8)
    eng.run()
    alloc = eng.alloc
    free_before = len(alloc.free) + len(alloc.lru)
    eng.submit(prompts[1], 8)
    eng.submit(prompts[2], 8)
    eng.sched.admit()
    shared = [b for b in alloc.owned[0] if alloc.ref[b] == 2]
    assert len(shared) == 2                       # both full prompt blocks
    assert shared == alloc.owned[1][:2]
    assert eng.kv_bytes_in_use() == alloc.blocks_in_use * eng.ex.kv_per_block
    assert alloc.blocks_in_use == len(set(alloc.owned[0])
                                      | set(alloc.owned[1]))
    check_invariants(alloc)
    taken = free_before - len(alloc.free) - len(alloc.lru)
    cold_need = 2 * alloc.blocks_needed(len(prompts[1]) + 8
                                        + eng.dec.window_slack)
    assert taken < cold_need
    src, dst = alloc.copy_on_write(0, 0)
    assert src == shared[0] and alloc.ref[src] == alloc.ref[dst] == 1
    eng.ex.copy_block(src, dst)
    n_leaves = 0
    for caches in (eng.ex.state.tcache, eng.ex.state.dcache):
        for entry in caches["scan"]:
            for leaf in entry.values():
                assert torch.equal(leaf[:, dst], leaf[:, src])
                n_leaves += 1
    assert n_leaves == (4 if kv_dtype == "int8" else 2) * 2
    check_invariants(alloc)
    comps = eng.run()
    assert len(comps) == 3 and alloc.blocks_in_use == 0


def test_warm_engine_matches_jax():
    """fp32: the port's warm tokens and its prefix_hit_blocks /
    prefix_lookup_blocks equal the JAX Engine's, request by request,
    greedy and sampled rows mixed."""
    prompts = shared_prompts(11, 5)
    temps = TEMPS["mixed-sampled"]
    eng, mine = serve_port(prompts, temps, kv_dtype="fp32",
                           prefix_cache=True)
    _, _, _, _, jtc, jtp, jdc, jdp = models()
    jeng = JaxEngine(jtp, jtc, jdp, jdc, config=JaxEngineConfig(
        **SMALL, kv_dtype="fp32", prefix_cache=True))
    rids = {jeng.submit(p, 12, temperature=t): i
            for i, (p, t) in enumerate(zip(prompts, temps))}
    theirs = {rids[c.rid]: np.asarray(c.tokens) for c in jeng.run()}
    for key in ("prefix_hit_blocks", "prefix_lookup_blocks",
                "prefill_tokens", "steps"):
        assert eng.stats[key] == jeng.stats[key], key
    assert eng.stats["prefix_hit_blocks"] > 0
    for i in range(len(prompts)):
        assert np.array_equal(mine[i], theirs[i])


# --------------------------------------------------------------- refusals
def test_prefix_cache_rejects_contiguous_layout():
    with pytest.raises(ValueError, match="paged"):
        EngineConfig(kv_layout="contiguous", prefix_cache=True)


@pytest.mark.parametrize("name", ["tiny-ssm", "hybrid"])
@pytest.mark.parametrize("mode", ["pard", "ar"])
def test_prefix_cache_refuses_ssm_models(name, mode):
    """A hit would skip the cached tokens while the row's Mamba2 state
    starts from zero: the port refuses the model (target or draft)."""
    cfg = ModelConfig(**HYBRID) if name == "hybrid" else get_config(name)
    from repro_torch.models import init_params
    p = init_params(cfg, 0, "cpu", torch.float32)
    with pytest.raises(ValueError, match="Mamba2"):
        Engine(p, cfg, p, cfg, config=EngineConfig(mode=mode,
                                                   prefix_cache=True),
               device="cpu")
    tc = get_config("tiny-target")
    if mode == "pard" and name == "tiny-ssm":
        # an attention target with a Mamba2 draft is refused as well
        tp = init_params(tc, 0, "cpu", torch.float32)
        sc = get_config("tiny-ssm")
        with pytest.raises(ValueError, match="Mamba2"):
            Engine(tp, tc, p, sc, config=EngineConfig(prefix_cache=True),
                   device="cpu")


def _ssm_state_after_prefill(jeng, slot):
    """Step the JAX engine until ``slot`` finished its prefill; return its
    Mamba2 states (every SSM leaf's row)."""
    sched = jeng.sched
    while True:
        sched.admit()
        jeng.ex.sync_tables(jeng.alloc)
        sched.process(sched.dispatch())
        rep = sched.replicas[0]
        if rep.slot_pf[slot] >= rep.slot_pf_len[slot]:
            break
    leaves = []
    for entry in jeng.ex.state.tcache["scan"]:
        if "ssm" in entry:
            leaves.append(np.asarray(entry["ssm"][:, slot]))
    return leaves


def test_jax_prefix_cache_skips_the_ssm_state():
    """The fault the port does not copy: on tiny-ssm the JAX engine
    accepts prefix_cache=True, and a request that hits the cache ends its
    prefill with a Mamba2 state that saw only the uncached token. A cold
    request (cache off, or cache on without a hit) ends it with another
    state, the same bit for bit in both engines."""
    jcfg = jax_get_config("tiny-ssm")
    jp = jax_init_params(jax.random.PRNGKey(3), jcfg)
    rng = np.random.default_rng(4)
    system = rng.integers(0, 512, size=32).astype(np.int32)
    first = np.concatenate([system, rng.integers(0, 512, size=2)])
    second = np.concatenate([system, rng.integers(0, 512, size=2)])
    states = {}
    for name, cache, warm_up in (("cold", False, True),
                                 ("miss", True, False),
                                 ("warm", True, True)):
        jeng = JaxEngine(jp, jcfg, jp, jcfg, config=JaxEngineConfig(
            **SMALL, kv_dtype="fp32", prefix_cache=cache))
        if warm_up:
            jeng.submit(first, 4)
            jeng.run()
        jeng.submit(second, 4)
        states[name] = _ssm_state_after_prefill(jeng, 0)
        # the hit covers both blocks of the 33 prefilled tokens
        assert jeng.stats["prefix_hit_blocks"] == (2 if name == "warm" else 0)
    assert states["cold"]
    for cold, miss, warm in zip(states["cold"], states["miss"],
                                states["warm"]):
        np.testing.assert_array_equal(miss, cold)
        assert np.abs(warm - cold).max() > 0.1 * np.abs(cold).max()
