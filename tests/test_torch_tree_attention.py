"""The port's tree-verification and contiguous decode attention against the
JAX package.

On the CPU the port's ``tree_attention_paged``, ``tree_attention`` and
contiguous ``decode_attention`` take their plain PyTorch versions. They are
held against the JAX oracles in ``repro.kernels.ref`` and against the
Pallas kernels ``repro.kernels.ops.*`` run in interpret mode, on the same
numpy inputs. Tolerance 1e-5 (atol and rtol) in float32: every side
computes a float32 softmax, only the summation order differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.models.attention import TreeAttnInfo as JaxTreeAttnInfo
from repro.models.attention import tree_allowed as jax_tree_allowed
from repro_torch import kernels
from repro_torch.core.spec_decode import TreeTemplate
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import tree_attention as ta

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_template(rng, max_slots):
    while True:
        br = tuple(int(x) for x in rng.integers(1, 4, size=rng.integers(1, 6)))
        slots, width = 1, 1
        for x in br:
            width *= x
            slots += width
        if slots <= max_slots:
            return TreeTemplate.from_branching(br)


def _tree_meta(rng, b, tq, templates=None):
    """Per-row packed tree metadata: anc (uint32), depth, win_len."""
    anc = np.zeros((b, tq), np.uint32)
    depth = np.zeros((b, tq), np.int32)
    win_len = np.zeros(b, np.int32)
    for r in range(b):
        t = templates[r] if templates else _random_template(rng, tq)
        ns = t.num_slots
        anc[r, :ns], depth[r, :ns], win_len[r] = t.anc, t.depth, ns
    return anc, depth, win_len


def _tree_case(seed, b, tq, hq, hkv, d, s, templates=None):
    """Contiguous cache [B, S, Hkv, D]; each row's window at a random
    win_start >= 1 (so every query sees a key), kv_len = win_start + Tq,
    logical positions win_start + depth."""
    rng = np.random.default_rng(seed)
    anc, depth, win_len = _tree_meta(rng, b, tq, templates)
    win_start = rng.integers(1, s - tq + 1, size=b).astype(np.int32)
    return dict(
        q=rng.standard_normal((b, tq, hq, d)).astype(np.float32),
        k=rng.standard_normal((b, s, hkv, d)).astype(np.float32),
        v=rng.standard_normal((b, s, hkv, d)).astype(np.float32),
        kv_len=(win_start + tq).astype(np.int32),
        q_pos=(win_start[:, None] + depth).astype(np.int32),
        win_start=win_start, anc=anc, win_len=win_len)


def _paged(arrs, bs, seed):
    """The same rows in a block pool [NB, bs, Hkv, D] with shuffled
    tables; block 0 is the garbage block."""
    rng = np.random.default_rng(seed)
    b, s = arrs["k"].shape[:2]
    mbs = -(-s // bs)
    nb = 1 + b * mbs
    tables = rng.permutation(np.arange(1, nb)).reshape(b, mbs).astype(np.int32)
    out = dict(arrs)
    for name in ("k", "v"):
        pool = np.zeros((nb, bs) + arrs[name].shape[2:], np.float32)
        padded = np.zeros((b, mbs * bs) + arrs[name].shape[2:], np.float32)
        padded[:, :s] = arrs[name]
        pool[tables.reshape(-1)] = padded.reshape((b * mbs, bs)
                                                  + arrs[name].shape[2:])
        out[name] = pool
    out["tables"] = tables
    return out


TREE_ORDER = ("q", "k", "v", "kv_len", "q_pos", "win_start", "anc")
PAGED_ORDER = ("q", "k", "v", "tables", "kv_len", "q_pos", "win_start", "anc")


def _torch(arrs, names):
    out = []
    for n in names:
        x = arrs[n]
        out.append(torch.from_numpy(x.astype(np.int64) if n == "anc" else x))
    return out


def _jax(arrs, names):
    return [jnp.asarray(arrs[n]) for n in names]


def _tree_all(arrs, paged=False, **kw):
    """(port, JAX oracle, JAX Pallas kernel in interpret mode)."""
    names = PAGED_ORDER if paged else TREE_ORDER
    wl = arrs["win_len"]
    if paged:
        port = ta.tree_attention_paged(*_torch(arrs, names),
                                       win_len=torch.from_numpy(wl), **kw)
        want = ref.tree_attention_paged_ref(*_jax(arrs, names),
                                            win_len=jnp.asarray(wl), **kw)
        kern = ops.tree_attention_paged(*_jax(arrs, names),
                                        win_len=jnp.asarray(wl),
                                        interpret=True, **kw)
    else:
        port = ta.tree_attention(*_torch(arrs, names),
                                 win_len=torch.from_numpy(wl), **kw)
        want = ref.tree_attention_ref(*_jax(arrs, names),
                                      win_len=jnp.asarray(wl), **kw)
        kern = ops.tree_attention(*_jax(arrs, names), win_len=jnp.asarray(wl),
                                  interpret=True, **kw)
    return port.numpy(), np.asarray(want), np.asarray(kern)


# ------------------------------------------------------------- tree mask
def test_tree_allowed_matches_jax():
    """Random templates up to 32 slots (bits 30 and 31 included), per-row
    win_len and a sliding window: the boolean masks are equal."""
    rng = np.random.default_rng(0)
    b, tq, s = 4, 32, 80
    chain = TreeTemplate.flat(31)                  # 32 slots: anc[31] = ~0
    wide = TreeTemplate.from_branching((2, 2, 1, 1, 1, 1, 1, 1))   # 31 slots
    anc, depth, win_len = _tree_meta(rng, b, tq)
    anc[0], depth[0], win_len[0] = chain.anc, chain.depth, 32
    anc[1, :31], depth[1, :31], win_len[1] = wide.anc, wide.depth, 31
    assert anc[0, 31] == 0xFFFFFFFF and anc[0, 30] == 0x7FFFFFFF
    ws = np.array([3, 10, 40, 0], np.int32)
    q_pos = ws[:, None] + depth
    kv_pos = np.broadcast_to(np.arange(s)[None], (b, s)).astype(np.int32)
    for window in (0, 6):
        got = ta.tree_allowed(
            torch.from_numpy(q_pos), torch.from_numpy(kv_pos),
            ta.TreeAttnInfo(torch.from_numpy(ws),
                            torch.from_numpy(anc.astype(np.int64)),
                            torch.from_numpy(win_len)), window)
        want = jax_tree_allowed(jnp.asarray(q_pos), jnp.asarray(kv_pos),
                                JaxTreeAttnInfo(jnp.asarray(ws),
                                                jnp.asarray(anc),
                                                jnp.asarray(win_len)),
                                window=window)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_anc_bits_round_trip():
    """int64 masks -> the kernels' int32 bits -> int64, bit for bit, for
    the high slots where a signed shift would go wrong."""
    vals = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFF, 0xC0000001],
                    np.uint32)
    a64 = torch.from_numpy(vals.astype(np.int64))
    a32 = ta.anc_int32(a64)
    assert a32.dtype == torch.int32
    np.testing.assert_array_equal(a32.numpy().view(np.uint32), vals)
    np.testing.assert_array_equal(ta.anc_bits(a32).numpy(), vals)
    for j in (0, 30, 31):
        np.testing.assert_array_equal(((ta.anc_bits(a32) >> j) & 1).numpy(),
                                      (vals >> j) & 1)
    with pytest.raises(TypeError):
        ta.anc_bits(a64.float())


# ------------------------------------------------------------ tree kernels
@pytest.mark.parametrize("b,tq,hq,hkv,d,s", [
    (4, 9, 4, 2, 32, 40),        # small templates, G = 2
    (2, 32, 4, 1, 64, 96),       # full 32-slot window, MQA
    (3, 16, 14, 2, 64, 50),      # G = 7 (qwen2.5 grouping)
])
def test_tree_plain_matches_jax(b, tq, hq, hkv, d, s):
    arrs = _tree_case(b * tq, b, tq, hq, hkv, d, s)
    port, want, kern = _tree_all(arrs)
    np.testing.assert_allclose(port, want, **TOL)
    np.testing.assert_allclose(port, kern, **TOL)


@pytest.mark.parametrize("window,softcap", [(5, 0.0), (0, 30.0), (7, 20.0)])
def test_tree_window_softcap(window, softcap):
    arrs = _tree_case(11, 3, 12, 4, 2, 32, 48)
    for paged in (False, True):
        case = _paged(arrs, 8, 12) if paged else arrs
        port, want, kern = _tree_all(case, paged=paged, window=window,
                                     softcap=softcap)
        np.testing.assert_allclose(port, want, **TOL)
        np.testing.assert_allclose(port, kern, **TOL)


@pytest.mark.parametrize("bs", [8, 16])
def test_tree_paged_plain_matches_jax(bs):
    arrs = _paged(_tree_case(21, 4, 23, 8, 2, 64, 70), bs, 22)
    port, want, kern = _tree_all(arrs, paged=True)
    np.testing.assert_allclose(port, want, **TOL)
    np.testing.assert_allclose(port, kern, **TOL)


def test_tree_never_reads_past_eff_len():
    """Poison block 0 and every cache slot at or past each row's
    eff_len = min(kv_len, win_start + win_len): the output is unchanged."""
    arrs = _tree_case(31, 4, 20, 4, 2, 32, 64)
    arrs["kv_len"] = arrs["kv_len"] + np.array([0, 5, 9, 0], np.int32)
    eff = np.minimum(arrs["kv_len"], arrs["win_start"] + arrs["win_len"])
    clean = _tree_all(arrs)[0]
    poisoned = dict(arrs, k=arrs["k"].copy(), v=arrs["v"].copy())
    for r, e in enumerate(eff):
        poisoned["k"][r, e:], poisoned["v"][r, e:] = 1e4, -1e4
    port, _, kern = _tree_all(poisoned)
    np.testing.assert_array_equal(port, clean)
    np.testing.assert_allclose(port, kern, **TOL)
    paged = _paged(poisoned, 8, 32)
    paged["k"][0], paged["v"][0] = 1e4, -1e4
    port, _, kern = _tree_all(paged, paged=True)
    np.testing.assert_allclose(port, clean, **TOL)
    np.testing.assert_allclose(port, kern, **TOL)


def test_degenerate_chain_equals_causal_decode():
    """A chain template (all-lower-bits masks, q_pos = win_start + slot)
    is causal decode attention over the same window."""
    chain = TreeTemplate.flat(8)
    arrs = _tree_case(41, 3, 9, 4, 2, 64, 40, templates=[chain] * 3)
    np.testing.assert_array_equal(
        arrs["q_pos"], arrs["win_start"][:, None] + np.arange(9)[None])
    tree = _tree_all(arrs)[0]
    causal = da.decode_attention(*_torch(arrs, TREE_ORDER[:5])).numpy()
    np.testing.assert_allclose(tree, causal, **TOL)
    paged = _paged(arrs, 8, 42)
    np.testing.assert_allclose(_tree_all(paged, paged=True)[0], causal, **TOL)


# ------------------------------------------------- contiguous decode kernel
def _decode_case(seed, b, tq, hq, hkv, d, s, kv_len=None):
    rng = np.random.default_rng(seed)
    if kv_len is None:
        kv_len = rng.integers(tq, s + 1, size=b)
    kv_len = np.asarray(kv_len, np.int32)
    return dict(
        q=rng.standard_normal((b, tq, hq, d)).astype(np.float32),
        k=rng.standard_normal((b, s, hkv, d)).astype(np.float32),
        v=rng.standard_normal((b, s, hkv, d)).astype(np.float32),
        kv_len=kv_len,
        q_pos=np.maximum(kv_len[:, None] - tq + np.arange(tq)[None], 0)
        .astype(np.int32))


DECODE_ORDER = ("q", "k", "v", "kv_len", "q_pos")


@pytest.mark.parametrize("b,tq,hq,hkv,d,s", [
    (2, 9, 4, 2, 64, 50),        # PARD verify window (K+1 = 9)
    (3, 1, 4, 4, 32, 33),        # plain AR decode
    (2, 16, 8, 2, 64, 40),       # 2K = 16 draft window
    (2, 4, 14, 2, 32, 20),       # G = 7
])
def test_decode_plain_matches_jax(b, tq, hq, hkv, d, s):
    arrs = _decode_case(b + tq, b, tq, hq, hkv, d, s)
    got = da.decode_attention(*_torch(arrs, DECODE_ORDER)).numpy()
    np.testing.assert_allclose(
        got, np.asarray(ref.decode_attention_ref(*_jax(arrs, DECODE_ORDER))),
        **TOL)
    np.testing.assert_allclose(
        got, np.asarray(ops.decode_attention(*_jax(arrs, DECODE_ORDER),
                                             interpret=True)), **TOL)


@pytest.mark.parametrize("window,softcap", [(6, 0.0), (0, 25.0), (6, 25.0)])
def test_decode_window_softcap(window, softcap):
    arrs = _decode_case(51, 2, 5, 4, 2, 32, 30)
    kw = dict(window=window, softcap=softcap)
    got = da.decode_attention(*_torch(arrs, DECODE_ORDER), **kw).numpy()
    np.testing.assert_allclose(
        got, np.asarray(ref.decode_attention_ref(*_jax(arrs, DECODE_ORDER),
                                                 **kw)), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(ops.decode_attention(*_jax(arrs, DECODE_ORDER),
                                             interpret=True, **kw)), **TOL)


def test_decode_ragged_and_poisoned_tail():
    """kv_len from 0 to S; slots at or past kv_len poisoned change
    nothing; a query that sees no key returns 0 (as the Pallas kernel)."""
    arrs = _decode_case(61, 4, 3, 4, 2, 32, 24, kv_len=[0, 1, 13, 24])
    clean = da.decode_attention(*_torch(arrs, DECODE_ORDER)).numpy()
    for r, n in enumerate(arrs["kv_len"]):
        arrs["k"][r, n:], arrs["v"][r, n:] = 1e4, -1e4
    got = da.decode_attention(*_torch(arrs, DECODE_ORDER)).numpy()
    np.testing.assert_array_equal(got, clean)
    assert not got[0].any()
    np.testing.assert_allclose(
        got, np.asarray(ops.decode_attention(*_jax(arrs, DECODE_ORDER),
                                             interpret=True)), **TOL)
    np.testing.assert_allclose(
        got[1:], np.asarray(ref.decode_attention_ref(
            *_jax(arrs, DECODE_ORDER)))[1:], **TOL)


def test_paged_and_contiguous_decode_agree():
    arrs = _decode_case(71, 3, 9, 4, 2, 32, 40)
    cont = da.decode_attention(*_torch(arrs, DECODE_ORDER))
    paged = _paged(arrs, 8, 72)
    got = da.decode_attention_paged(*_torch(
        paged, ("q", "k", "v", "tables", "kv_len", "q_pos")))
    np.testing.assert_allclose(got.numpy(), cont.numpy(), **TOL)


# ----------------------------------------------------------------- wrappers
def test_cpu_calls_count_no_launch():
    kernels.launches.clear()
    arrs = _tree_case(81, 2, 7, 2, 1, 32, 20)
    t = _torch(arrs, TREE_ORDER)
    p = _torch(_paged(arrs, 8, 83), PAGED_ORDER)
    ta.tree_attention(*t)
    ta.tree_attention_paged(*p)
    da.decode_attention(*t[:5])
    assert sum(kernels.launches.values()) == 0
