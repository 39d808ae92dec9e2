"""The gradient of the port's SSD scan on the CPU against the JAX package.

``ssd_chunked_bwd_ref`` (the plain version of ``csrc/ssd_chunked_bwd.cu``:
an explicit reverse scan over chunks) against autograd of the port's
``ssd_chunked_ref`` and against ``jax.vjp`` of the JAX scans
``ssd_scan_chunked`` and ``ssd_scan_ref``, in float32 at tiny-ssm's shapes
(b 2, h 2, P 32, N 16, chunk 8), t in {1, 9, 40}, with and without an init
state and a final-state cotangent. Tolerance: max |dgrad| / max(1,
max |grad|) <= 1e-5 per gradient (float32 sums taken in another order). Then the
fp32 kernel's decomposition: its CTAs take 32-row blocks of P and sum their
partial dB, dC, ddt and dA afterwards, emulated here as the plain version
on each block of P, summed; the autograd Function's plumbing (None
cotangents, the init state's gradient) with its launches pointed at the
plain versions; finite gradients where |dt A| is large.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jax_ssm
from repro_torch.kernels import ssd

GRADS = ("dx", "ddt", "dA", "dB", "dC", "dinit")
B_, H_, P_, N_, CHUNK = 2, 2, 32, 16, 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def inputs(t, init, dsf, seed=0, b=B_, h=H_, p=P_, n=N_):
    """Numpy float32 inputs and cotangents of one scan."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x, B, C, dy = f(b, t, h, p), f(b, t, n), f(b, t, n), f(b, t, h, p)
    dt = np.log1p(np.exp(f(b, t, h) - 1.0))                   # softplus
    A = -np.exp(f(h) * 0.5)
    s0 = f(b, h, p, n) * 0.1 if init else None
    dS = f(b, h, p, n) if dsf else None
    return x, dt, A, B, C, s0, dy, dS


def _t(a):
    return None if a is None else torch.from_numpy(a)


def close(got, want, rtol=1e-5):
    """max |got - want| <= rtol * max(1, max |want|): relative to the
    gradient's largest entry, and to 1 where the gradient vanishes (dA at
    t = 1 is 0 analytically, its terms cancel to ~1e-6 in float32)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() <= rtol * scale, \
        (np.abs(got - want).max(), scale)


def plain_bwd(ins, chunk=CHUNK):
    x, dt, A, B, C, s0, dy, dS = (_t(a) for a in ins)
    return [g.numpy() for g in ssd.ssd_chunked_bwd_ref(
        x, dt, A, B, C, s0, dy, dS, chunk=chunk)]


def torch_autograd(ins, chunk=CHUNK):
    x, dt, A, B, C, s0, dy, dS = (_t(a) for a in ins)
    leaves = [a.requires_grad_(True) for a in (x, dt, A, B, C, s0)
              if a is not None]
    y, S = ssd.ssd_chunked_ref(x, dt, A, B, C, s0, chunk=chunk)
    outs, cots = ([y, S], [dy, dS]) if dS is not None else ([y], [dy])
    return [g.numpy() for g in torch.autograd.grad(outs, leaves, cots)]


@functools.partial(jax.jit, static_argnums=0)
def _vjp(fn, prim, dy, dS):
    out, vjp = jax.vjp(lambda *a: fn(*a[:5], a[5] if len(a) > 5 else None),
                       *prim)
    return vjp((dy, dS))


def jax_vjp(fn, ins):
    """jax.vjp of ``fn`` (jitted once per shape: the gradient is the same
    function of the same values)."""
    x, dt, A, B, C, s0, dy, dS = ins
    prim = tuple(jnp.asarray(a) for a in (x, dt, A, B, C, s0)
                 if a is not None)
    if dS is None:
        dS = np.zeros((B_, H_, P_, N_), np.float32)
    return [np.asarray(g) for g in _vjp(fn, prim, jnp.asarray(dy),
                                        jnp.asarray(dS))]


def _chunked(*a):
    return jax_ssm.ssd_scan_chunked(*a, chunk=CHUNK)


@pytest.mark.parametrize("t", [1, 9, 40])
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("dsf", [False, True])
def test_plain_backward_matches_autograd_and_jax(t, init, dsf):
    ins = inputs(t, init, dsf, seed=t + 2 * init + 4 * dsf)
    got = plain_bwd(ins)
    n = 6 if init else 5
    assert got[5].shape == (B_, H_, P_, N_)
    wants = [torch_autograd(ins),
             jax_vjp(_chunked, ins),
             jax_vjp(jax_ssm.ssd_scan_ref, ins)]
    for want in wants:
        assert len(want) == n
        for name, g, w in zip(GRADS, got, want):
            close(g, w)


def test_plain_backward_without_init_state_gives_its_cotangent():
    """dinit without an init state is the cotangent of the zero state it
    starts from: the same as with an explicit zero state."""
    ins = inputs(40, False, True, seed=3)
    zero = list(ins)
    zero[5] = np.zeros((B_, H_, P_, N_), np.float32)
    for a, b in zip(plain_bwd(ins), plain_bwd(zero)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("t,p,dsf", [(40, 40, True), (23, 64, False)])
def test_kernel_decomposition_over_p_blocks(t, p, dsf):
    """The fp32 kernel's CTAs own ``SSD_BWD_ROWS`` rows of P each: dx and dinit
    complete per block, dB, dC, ddt and dA partial sums (each block's own
    reverse cumsum of its dcum, decay terms included) added afterwards.
    Emulated as the plain backward on each block of P, summed."""
    ins = inputs(t, True, dsf, seed=p, h=3, p=p, n=24)
    x, dt, A, B, C, s0, dy, dS = (_t(a) for a in ins)
    rows = ssd.SSD_BWD_ROWS
    parts = [ssd.ssd_chunked_bwd_ref(
        x[..., r:r + rows].contiguous(), dt, A, B, C,
        s0[:, :, r:r + rows].contiguous(), dy[..., r:r + rows].contiguous(),
        None if dS is None else dS[:, :, r:r + rows].contiguous(), chunk=16)
        for r in range(0, p, rows)]
    assert len(parts) == -(-p // rows)
    want = plain_bwd(ins, chunk=16)
    close(torch.cat([q[0] for q in parts], dim=-1), want[0])
    close(torch.cat([q[5] for q in parts], dim=2), want[5])
    for i in (1, 2, 3, 4):                  # ddt, dA, dB, dC: summed
        close(sum(q[i] for q in parts), want[i])
    nc, npb = -(-t // 16), -(-p // rows)
    assert ssd._bwd_workspace(2, t, 3, p, 24, 16) == 2 * 3 * (
        nc * p * 24 + npb * (2 * t * 24 + t + 1))


@pytest.mark.parametrize("use", ["both", "y", "state"])
def test_autograd_function_plumbing(monkeypatch, use):
    """``_SSDChunked`` with its launches pointed at the plain versions
    (``_ssd_fwd``, ``ssd_chunked_bwd``), on CPU tensors: the same gradients
    as autograd of the plain scan whichever outputs the loss reads (an
    unread output's cotangent arrives as None), the init state's gradient
    only where one was given."""
    calls = []

    def bwd(*a, chunk):
        calls.append((bool((a[6] == 0).all()), a[7] is None))
        assert all(t is None or t.is_contiguous() for t in a)
        return ssd.ssd_chunked_bwd_ref(*a, chunk=chunk)

    monkeypatch.setattr(ssd, "_ssd_fwd", lambda *a: ssd.ssd_chunked_ref(
        *a[:6], chunk=a[6]))
    monkeypatch.setattr(ssd, "ssd_chunked_bwd", bwd)
    for init in (False, True):
        x, dt, A, B, C, s0, _, _ = (_t(a) for a in inputs(17, init, False))
        leaves = [a for a in (x, dt, A, B, C, s0) if a is not None]
        w = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (B_, H_, P_, N_)).astype(np.float32))

        def loss(y, S):
            return {"both": (y * y).sum() + (S * w).sum(),
                    "y": (y * y).sum(), "state": (S * w).sum()}[use]

        got, want = [], []
        for fn, out in ((lambda *a: ssd._SSDChunked.apply(*a, 8), got),
                        (lambda *a: ssd.ssd_chunked_ref(*a, chunk=8), want)):
            for a in leaves:
                a.requires_grad_(True)
                a.grad = None
            loss(*fn(*leaves, *([None] * (6 - len(leaves))))).backward()
            out.extend(torch.zeros_like(a) if a.grad is None else a.grad
                       for a in leaves)
        for g, w_ in zip(got, want):
            close(g.numpy(), w_.numpy())
    assert calls == [(use == "state", use == "y")] * 2


def test_large_decay_gives_finite_gradients():
    """dt = 20, A = -16: exp(dt A) underflows to 0; the masked side of
    exp(cum_i - cum_j) would overflow were the mask outside the exp."""
    x, dt, A, B, C, s0, dy, dS = inputs(40, True, True, seed=5)
    dt[:] = 20.0
    A[:] = -16.0
    ins = (x, dt, A, B, C, s0, dy, dS)
    got, want = plain_bwd(ins), torch_autograd(ins)
    for g, w in zip(got, want):
        assert np.isfinite(g).all()
        close(g, w)


def test_cpu_wrapper_takes_the_plain_backward():
    ins = inputs(9, True, True, seed=7)
    args = [_t(a) for a in ins]
    got = ssd.ssd_chunked_bwd(*args, chunk=8)
    for g, w in zip(got, plain_bwd(ins)):
        np.testing.assert_array_equal(g.numpy(), w)
