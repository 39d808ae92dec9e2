"""The port's COD training attention against the JAX package.

On the CPU the port's ``pard_attention`` takes its plain PyTorch version.
The inputs are real COD layouts: ``pack_batch`` of random tokens (K = 4
and 8, r = 0.7, r_min = 0.2), padded with segment-0 rows. The output is
held against the JAX oracle ``ref.pard_attention_ref`` on the rows that see
a key and against the Pallas kernel ``ops.pard_attention`` (interpret
mode; it repeats KV heads for GQA) on every row; the gradients against
``jax.grad`` of the oracle with a cotangent that is 0 on padding rows (the
oracle's padding rows are garbage that never reaches a loss). Tolerance
1e-5 (atol and rtol) in float32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.models.attention import pard_mask as jax_pard_mask
from repro_torch.core.cod import CodConfig, pack_batch
from repro_torch.kernels import pard_attention as pa

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _layout(seed, b, n, k, extra_pad):
    rng = np.random.default_rng(seed)
    packed = pack_batch(rng.integers(0, 400, (b, n)), CodConfig(k, 0.7, 0.2),
                        511, seed=seed)
    pad = np.zeros((b, extra_pad), np.int32)
    return (np.concatenate([packed["segment"], pad], 1).astype(np.int32),
            np.concatenate([packed["base"], pad], 1).astype(np.int32))


def _inputs(seed, b, t, hq, hkv, d):
    rng = np.random.default_rng(seed + 100)
    return (rng.standard_normal((b, t, hq, d)).astype(np.float32),
            rng.standard_normal((b, t, hkv, d)).astype(np.float32),
            rng.standard_normal((b, t, hkv, d)).astype(np.float32),
            rng.standard_normal((b, t, hq, d)).astype(np.float32))


CASES = [   # b, n, K, extra padding, hq, hkv, d, softcap
    (2, 24, 4, 5, 4, 2, 32, 0.0),
    (1, 40, 8, 0, 4, 1, 64, 0.0),
    (2, 16, 8, 3, 2, 2, 32, 8.0),
]


@pytest.mark.parametrize("b,n,k,extra,hq,hkv,d,softcap", CASES)
def test_pard_plain_matches_jax(b, n, k, extra, hq, hkv, d, softcap):
    seg, base = _layout(n, b, n, k, extra)
    t = seg.shape[1]
    q, kk, v, _ = _inputs(n, b, t, hq, hkv, d)
    info = pa.PardMaskInfo(torch.from_numpy(seg), torch.from_numpy(base))
    got = pa.pard_attention(*(torch.from_numpy(x) for x in (q, kk, v)), info,
                            softcap=softcap).numpy()
    jargs = [jnp.asarray(x) for x in (q, kk, v, seg, base)]
    live = seg > 0
    np.testing.assert_allclose(got[live], np.asarray(
        ref.pard_attention_ref(*jargs, softcap=softcap))[live], **TOL)
    np.testing.assert_allclose(got, np.asarray(
        ops.pard_attention(*jargs, softcap=softcap)), **TOL)
    assert (got[~live] == 0).all()


@pytest.mark.parametrize("b,n,k,extra,hq,hkv,d,softcap", CASES)
def test_pard_plain_grads_match_jax(b, n, k, extra, hq, hkv, d, softcap):
    seg, base = _layout(n + 1, b, n, k, extra)
    t = seg.shape[1]
    q, kk, v, cot = _inputs(n + 1, b, t, hq, hkv, d)
    cot = cot * (seg > 0)[:, :, None, None]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, kk, v))
    (pa.pard_attention(tq, tk, tv, pa.PardMaskInfo(torch.from_numpy(seg),
                                                   torch.from_numpy(base)),
                       softcap=softcap)
     * torch.from_numpy(cot)).sum().backward()
    want = jax.grad(lambda a, b_, c: jnp.sum(ref.pard_attention_ref(
        a, b_, c, jnp.asarray(seg), jnp.asarray(base), softcap=softcap)
        * cot), argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, kk, v)))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL)
    pad = seg == 0
    for g in (tq.grad, tk.grad, tv.grad):       # padding takes no gradient
        assert (g[torch.from_numpy(pad)] == 0).all()


def test_pard_mask_matches_jax():
    seg, base = _layout(3, 2, 30, 6, 4)
    got = pa.pard_mask(*(torch.from_numpy(x) for x in (seg, base, seg, base)))
    want = jax_pard_mask(*(jnp.asarray(x) for x in (seg, base, seg, base)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # every mask token sees its chain, its real context and itself only
    s = torch.from_numpy(seg[0])
    b_ = torch.from_numpy(base[0])
    i = int(np.nonzero(seg[0] == 3)[0][0])
    seen = torch.nonzero(got[0, i]).flatten()
    assert set(zip(s[seen].tolist(), b_[seen].tolist())) == (
        {(1, j) for j in range(int(b_[i]))} | {(2, int(b_[i])),
                                               (3, int(b_[i]))})


def test_pard_inputs_checked():
    q = torch.randn(1, 8, 2, 32)
    seg = torch.ones(1, 8, dtype=torch.int32)
    info = pa.PardMaskInfo
    with pytest.raises(ValueError, match="self-attention"):
        pa._check(q, q[:, :6], q[:, :6], info(seg, seg))
    with pytest.raises(TypeError, match="int32"):
        pa._check(q, q, q, info(seg.long(), seg))
    with pytest.raises(ValueError, match="shape"):
        pa._check(q, q, q, info(seg[:, :7], seg))
    pa._check(q, q, q, info(seg, seg))
