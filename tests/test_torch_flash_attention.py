"""The port's full-sequence flash attention against the JAX package.

On the CPU the port's ``flash_attention`` takes its plain PyTorch version.
Its output is held against the JAX oracle ``ref.flash_attention_ref`` and
the Pallas kernel ``ops.flash_attention`` in interpret mode, and its
gradients (torch autograd) against ``jax.grad`` of the oracle, on the same
numpy inputs. Tolerance 1e-5 (atol and rtol) in float32: both sides run a
float32 softmax, only summation orders differ. Rows that see no key are
compared only against the kernel (the jnp oracle gives garbage there; the
kernel and the port give 0).

The Pallas wrapper pads S to its key block and then hands the kernel the
padded length as ``seq_len``, so its zero-padded keys are visible to
queries that the causal mask does not already cut off (non-causal calls,
or T > S). Where that happens the port is held against the jnp oracle
only, and the rows-that-see-no-key case uses an S that needs no padding.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch import kernels
from repro_torch.kernels import flash_attention as fa

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b, t, s, hq, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, hq, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            rng.standard_normal((b, s, hkv, d)).astype(np.float32),
            rng.standard_normal((b, t, hq, d)).astype(np.float32))


CASES = [   # b, t, s, hq, hkv, d, causal, window, softcap
    (2, 37, 37, 4, 2, 32, True, 0, 0.0),      # GQA G=2, T not a tile multiple
    (1, 50, 50, 4, 1, 64, True, 12, 0.0),     # G=4, sliding window
    (2, 24, 24, 2, 2, 32, True, 0, 5.0),      # softcap
    (1, 40, 40, 2, 2, 128, True, 8, 20.0),    # window + softcap, D=128
    (1, 20, 33, 2, 1, 32, False, 0, 0.0),     # not causal, S != T
]


@pytest.mark.parametrize("b,t,s,hq,hkv,d,causal,window,softcap", CASES)
def test_flash_plain_matches_jax(b, t, s, hq, hkv, d, causal, window, softcap):
    q, k, v, _ = _inputs(0, b, t, s, hq, hkv, d)
    kw = dict(causal=causal, window=window, softcap=softcap)
    got = fa.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)), **kw)
    assert got.shape == q.shape and got.dtype == torch.float32
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        ref.flash_attention_ref(jq, jk, jv, **kw)), **TOL)
    if causal and t <= s:                  # the wrapper's padded keys stay hidden
        np.testing.assert_allclose(got.numpy(), np.asarray(
            ops.flash_attention(jq, jk, jv, **kw)), **TOL)


@pytest.mark.parametrize("b,t,s,hq,hkv,d,causal,window,softcap", CASES)
def test_flash_plain_grads_match_jax(b, t, s, hq, hkv, d, causal, window,
                                     softcap):
    q, k, v, cot = _inputs(1, b, t, s, hq, hkv, d)
    kw = dict(causal=causal, window=window, softcap=softcap)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    (fa.flash_attention(tq, tk, tv, **kw) * torch.from_numpy(cot)).sum() \
        .backward()
    want = jax.grad(lambda a, b_, c: jnp.sum(
        ref.flash_attention_ref(a, b_, c, **kw) * cot), argnums=(0, 1, 2))(
        *(jnp.asarray(x) for x in (q, k, v)))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **TOL)


def test_flash_rows_that_see_no_key_give_zero():
    # T > S under a window: query i >= S + window - 1 sees no key (S = 32
    # is the wrapper's key block, so it pads nothing)
    q, k, v, cot = _inputs(2, 1, 48, 32, 2, 1, 32)
    kw = dict(causal=True, window=8)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    got = fa.flash_attention(tq, tk, tv, **kw)
    want = np.asarray(ops.flash_attention(
        *(jnp.asarray(x) for x in (q, k, v)), **kw))
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    dead = np.arange(48) >= 32 + 8 - 1
    assert dead.sum() == 9
    assert (got[:, dead] == 0).all()
    (got * torch.from_numpy(cot)).sum().backward()
    assert (tq.grad[:, dead] == 0).all()


def test_flash_allowed_and_cpu_route():
    allowed = fa.flash_allowed(6, 6, causal=True, window=3)
    assert allowed.tolist()[5] == [False, False, False, True, True, True]
    assert allowed.tolist()[0] == [True] + [False] * 5
    q = torch.randn(1, 5, 2, 32)
    before = dict(kernels.launches)
    fa.flash_attention(q, q[:, :, :1], q[:, :, :1])
    assert dict(kernels.launches) == before        # CPU: no kernel launch


def test_train_inputs_checked():
    q = torch.randn(1, 8, 4, 32)
    k = torch.randn(1, 8, 2, 32)
    fa.check_train_inputs(q, k, k)
    with pytest.raises(ValueError, match="head dim"):
        fa.check_train_inputs(torch.randn(1, 8, 4, 40),
                              torch.randn(1, 8, 2, 40),
                              torch.randn(1, 8, 2, 40))
    with pytest.raises(TypeError):
        fa.check_train_inputs(q, k.bfloat16(), k.bfloat16())
    with pytest.raises(ValueError, match="group"):
        fa.check_train_inputs(torch.randn(1, 8, 3, 32), k, k)
    with pytest.raises(ValueError, match="contiguous"):
        fa.check_train_inputs(q.transpose(1, 2).contiguous().transpose(1, 2),
                              k, k)
    with pytest.raises(ValueError, match="shape"):
        fa.check_train_inputs(q, k, k, ("lse", torch.zeros(1, 4, 7),
                                        (1, 4, 8), torch.float32))
    with pytest.raises(ValueError, match="no kernel"):
        fa.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))
