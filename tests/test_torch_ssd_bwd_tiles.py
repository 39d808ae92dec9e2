"""The plan and arithmetic of the bf16 ``ssd_chunked_bwd`` kernel.

For bf16 inputs on the card ``csrc/ssd_chunked_bwd.cu`` runs the gradient
of the SSD scan in three stages and a reduction, every product on the
tensor cores in bf16 with f32 accumulators:

  A  per (P block of 64 rows, head, batch row x chunk): the state the
     chunk adds, X_c = (u x)^T B with u = dt exp(cum_L - cum), and the
     cotangent it sends back, Y_c = (e dy)^T C with e = exp(cum); the
     f32 operands u x and e dy as bf16 pairs hi + lo;
  B  per state entry: the recurrence over chunks, S_{c+1} = exp(cum_L,c)
     S_c + X_c forward from the init state, and dS_c = exp(cum_L,c+1)
     dS_{c+1} + Y_{c+1} backward from the final-state cotangent, in place;
  C  per (P block, head, batch row x chunk): C B^T and D' = dy x^T (exact
     bf16 operands; dt is folded out of D), gated by w_ij = exp(cum_i -
     cum_j) on j <= i in f32; dxdt = G^T dy + f (B dS^T), dB = (w D)^T C
     + f dt (x dS), dC = (w D) B + e (dy S), every f32 operand (G, w D,
     S, dS) as hi + lo; da = sum_{i >= k, j < k} M_ij (M = G o D, taken
     as the product M^T U with U_ik = [i >= k], masked and summed over
     the rows j < k) + the exclusive prefix of dd + the reverse prefix of
     ys + exp(cum_L) sum S o dS; ddt = dxdt . x + da A.
  R  dB, dC over (head, P block) and dA over (batch row, chunk, P block)
     in a fixed order.

No CUDA runs here: ``ssd_bwd_plan`` is tested as the integer function it
is, and ``emulate_bwd`` repeats the decomposition in f32 torch — the
16-row tiles with zero-filled edges, cum in double, the recurrence in
the kernel's order, the hi + lo splits (``v.bfloat16()`` and ``(v -
hi).bfloat16()``), the P-block partials and the fixed-order reduction —
and is held against ``ssd_chunked_bwd_ref`` run in float64 and against
``jax.vjp`` of ``repro.models.ssm.ssd_scan_chunked`` in float32 on the
same numpy inputs from a seed.

Tolerance. x, dy, B and C are bf16 values (the kernel's inputs), so the
products between them are exact in f32. Each f32 operand enters as hi +
lo with |v - hi - lo| <= 2^-8 |v - hi| <= 2^-16 |v|. A term of an output
passes through at most two such splits in turn (u x into X_c, then the
state into dC and ys; e dy into Y_c, then dS into dx, dB and dd; G or
w D or M once), each moving it by at most 2^-16 of its magnitude: 3.1e-5
together. The f32 sums along the way (stage A's over L tokens, stage B's
over nc chunks, stage C's over at most 2 N + L + P = 384 terms, the
reduction over heads) add at most n 2^-24 each, 2.3e-5 for the longest,
~6.9e-5 in all. Against the magnitude ``mag`` — the same decomposition in
float64 without splits on |x|, |dy|, |B|, |C|, |init_state| and
|dS_final| (dt and A as they are), where every term of an output is
positive (ddt's two parts added as dxdt . x + da |A|) — the check is
|emulation - reference| <= 1e-4 mag, the two bounds added. Rounding the
f32 operands to a single bf16 each instead moves a product by up to 2^-8
= 3.9e-3 of its size, which breaks the check for dx, dB, dC and dinit
(``test_single_bf16_rounding_breaks_the_bound``).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jax_ssm
from repro_torch.kernels import ssd

TOL = 1e-4                      # of the summed magnitudes, see above
GRADS = ("dx", "ddt", "dA", "dB", "dC", "dinit")
PB = ssd.SSD_BWD_P_BLOCK


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def _jax_fp32():
    """jax.vjp in float32 on the CPU (the JAX package may raise the
    matmul precision elsewhere); restored after the module."""
    old = jax.config.jax_default_matmul_precision
    jax.config.update("jax_default_matmul_precision", "float32")
    yield
    jax.config.update("jax_default_matmul_precision", old)


# ------------------------------------------------------------------ plan
def test_plan_at_the_training_shape():
    """mamba2-130m at b 4, t 1024 (h 24, P 64, N 128, chunk 64): 1536 CTAs
    a stage, 4 tiles of 16 rows, two 64-column halves of N, and a
    workspace of ~202 MB, which ``_bwd_workspace`` allocates."""
    grid, nk, mt, ws = ssd.ssd_bwd_plan(4, 1024, 24, 64, 128, 64)
    assert grid == (1, 24, 64) and grid[0] * grid[1] * grid[2] == 1536
    assert (nk, mt) == (2, 4)
    states = 4 * 24 * 16 * 64 * 128             # [b, h, nc, P, N]
    parts = 4 * 24 * 1024 * 128                 # [b, h, npb, t, N]
    small = 4 * 24 * 16 + 4 * 24 * 1024 + 4 * 16 * 24
    assert ws == 2 * states + 2 * parts + small
    assert ws * 4 <= 250e6
    assert ssd._bwd_workspace(4, 1024, 24, 64, 128, 64,
                              torch.bfloat16) == ws


@pytest.mark.parametrize("dims,want", [
    ((2, 9, 4, 32, 16, 8), ((1, 4, 4), 1, 1)),        # tiny-ssm
    ((2, 50, 3, 40, 24, 16), ((1, 3, 8), 1, 1)),      # the P-block edge
    ((1, 1, 24, 64, 128, 8), ((1, 24, 1), 2, 1)),     # t = 1
    ((1, 100, 2, 128, 128, 64), ((2, 2, 2), 2, 4)),   # two P blocks
    ((1, 20, 2, 64, 72, 32), ((1, 2, 1), 2, 2)),      # N just past 64
])
def test_plan_grid(dims, want):
    grid, nk, mt, ws = ssd.ssd_bwd_plan(*dims)
    assert (grid, nk, mt) == want
    b, t, h, p, n, chunk = dims
    nc, npb = -(-t // chunk), -(-p // PB)
    assert ws == b * h * (2 * nc * p * n + npb * (2 * t * n + t) + nc
                          + nc * npb)
    assert 16 * mt >= chunk and 64 * nk >= n


@pytest.mark.parametrize("dims,err", [
    ((1, 16, 2, 36, 128, 16), ValueError),      # P off the 16-byte copies
    ((1, 16, 2, 64, 20, 16), ValueError),       # N off them
    ((1, 16, 2, 64, 136, 16), ValueError),      # N past 128
    ((1, 64, 2, 64, 128, 65), ValueError),      # chunk past the tiles
    ((0, 16, 2, 64, 128, 16), ValueError),
    ((1, 16.0, 2, 64, 128, 16), TypeError),
    ((1, 16, True, 64, 128, 16), TypeError),
])
def test_plan_refuses(dims, err):
    with pytest.raises(err):
        ssd.ssd_bwd_plan(*dims)


# ------------------------------------------------------------ emulation
def split(v):
    """The f32 operand v as the bf16 pair hi + lo (values kept in f32)."""
    hi = v.bfloat16().to(v.dtype)
    return hi, (v - hi).bfloat16().to(v.dtype)


def single(v):
    """v rounded to one bf16: what the kernel must not do."""
    return v.bfloat16().to(v.dtype), torch.zeros_like(v)


def exact(v):
    return v, torch.zeros_like(v)


def two(rounding, a, b):
    """a @ b with a as hi + lo (two products, as two MMAs)."""
    hi, lo = rounding(a)
    return hi @ b + lo @ b


def two_b(rounding, a, b):
    """a @ b with b as hi + lo."""
    hi, lo = rounding(b)
    return a @ hi + a @ lo


def emulate_bwd(x, dt, A, B, C, s0, dy, dsf, *, chunk, rounding=split,
                abs_a=False):
    """The bf16 backward's arithmetic in torch (f32 for f32 inputs, whose
    x, dy, B, C hold bf16 values). Returns (dx, ddt, dA, dB, dC, dinit)
    before the outputs' bf16 rounding. With ``abs_a`` ddt adds its two
    parts as dxdt . x + da |A| (the magnitude run)."""
    f = x.dtype
    b, t, h, p = x.shape
    n = B.shape[-1]
    L = ssd.clamp_chunk(chunk, t)
    (npb, _, _), nk, mt, _ = ssd.ssd_bwd_plan(b, t, h, p, n, L)
    R, NW, PW, nc = 16 * mt, 64 * nk, PB * npb, -(-t // L)

    def tiles(a, width=None):
        """a [b, t, (h,) w] -> [b, nc, R, (h,) width]: each chunk's L
        rows (tokens past t zero), rows L .. R - 1 zero, columns past w
        zero."""
        shape = (b, nc, R) + tuple(a.shape[2:-1]) + (width or a.shape[-1],)
        out = torch.zeros(shape, dtype=f)
        for c in range(nc):
            l = min(L, t - c * L)
            out[:, c, :l, ..., :a.shape[-1]] = a[:, c * L:c * L + l]
        return out

    xt, dyt = tiles(x, PW), tiles(dy, PW)               # [b, nc, R, h, PW]
    Bt, Ct = tiles(B, NW), tiles(C, NW)                  # [b, nc, R, NW]
    dtt = tiles(dt[..., None])[..., 0]                   # [b, nc, R, h]
    cum = torch.cumsum((dtt * A).double(), dim=2)        # cum in double
    last = cum[:, :, -1]                                 # [b, nc, h]
    e = torch.exp(cum.to(f))
    fv = torch.exp((last[:, :, None] - cum).to(f))
    decay = torch.exp(last.to(f))

    # A: each chunk's contributions [b, nc, h, PW, NW]
    hx = (dtt * fv).permute(0, 1, 3, 2)[..., None] * xt.permute(0, 1, 3, 2, 4)
    hdy = e.permute(0, 1, 3, 2)[..., None] * dyt.permute(0, 1, 3, 2, 4)
    X = two(rounding, hx.transpose(-1, -2), Bt[:, :, None])
    Y = two(rounding, hdy.transpose(-1, -2), Ct[:, :, None])

    # B: the recurrence over chunks, in place
    S = torch.zeros(b, h, PW, NW, dtype=f)
    if s0 is not None:
        S[:, :, :p, :n] = s0
    states = []
    for c in range(nc):
        states.append(S)
        S = S * decay[:, c, :, None, None] + X[:, c]
    dS = torch.zeros(b, h, PW, NW, dtype=f)
    if dsf is not None:
        dS[:, :, :p, :n] = dsf
    dstates = [None] * nc
    for c in reversed(range(nc)):
        dstates[c] = dS
        dS = decay[:, c, :, None, None] * dS + Y[:, c]
    dinit = dS

    # C: the gradients per chunk, partials per (batch row, head, P block)
    ii = torch.arange(R)
    causal = ii[:, None] >= ii[None, :]                  # [i, j]: j <= i
    U = causal.to(f)                                     # U[i, k] = [i >= k]
    before = (ii[:, None] < ii[None, :]).to(f)           # [j, k]: j < k
    dx = torch.zeros(b, nc, R, h, PW, dtype=f)
    pdB = torch.zeros(b, h, npb, nc, R, NW, dtype=f)
    pdC = torch.zeros(b, h, npb, nc, R, NW, dtype=f)
    pddt = torch.zeros(b, h, npb, nc, R, dtype=f)
    pdA = torch.zeros(b, nc, h, npb, dtype=f)
    Av = A.abs() if abs_a else A
    for c in range(nc):
        xh = xt[:, c].permute(0, 2, 1, 3)                # [b, h, R, PW]
        dyh = dyt[:, c].permute(0, 2, 1, 3)
        Bc, Cc = Bt[:, c, None], Ct[:, c, None]          # [b, 1, R, NW]
        dth = dtt[:, c].permute(0, 2, 1)                 # [b, h, R]
        eh, fh = e[:, c].permute(0, 2, 1), fv[:, c].permute(0, 2, 1)
        cumh = cum[:, c].permute(0, 2, 1)
        cb = Cc @ Bc.transpose(-1, -2)                   # [b, 1, i, j]
        dp = dyh @ xh.transpose(-1, -2)                  # [b, h, i, j]
        diff = cumh[..., :, None] - cumh[..., None, :]
        w = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)
                                          .to(f)), 0.0)
        G = w * cb
        wD = w * dth[..., None, :] * dp
        M = cb * wD
        Rk = (two(rounding, M.transpose(-1, -2), U) * before).sum(-2)
        Sc, dSc = states[c], dstates[c]                  # [b, h, PW, NW]
        dxdt1 = two(rounding, G.transpose(-1, -2), dyh)
        dxdt2 = two_b(rounding, Bc, dSc.transpose(-1, -2))
        dxdt = dxdt1 + fh[..., None] * dxdt2             # [b, h, j, PW]
        dx[:, c] = (dxdt * dth[..., None]).permute(0, 2, 1, 3)
        dB1 = two(rounding, wD.transpose(-1, -2), Cc)
        dC1 = two(rounding, wD, Bc)
        dShi, dSlo = rounding(dSc)
        for pb in range(npb):
            blk = slice(PB * pb, PB * (pb + 1))
            dd = fh * dth * (xh[..., blk] * dxdt2[..., blk]).sum(-1)
            xd = (dxdt[..., blk] * xh[..., blk]).sum(-1)
            dB2 = two_b(rounding, xh[..., blk], dSc[..., blk, :])
            dC2 = two_b(rounding, dyh[..., blk], Sc[..., blk, :])
            ys = eh * (Cc * dC2).sum(-1)
            tail = (Sc[..., blk, :] * (dShi + dSlo)[..., blk, :]).sum((-2, -1))
            first = 1.0 if pb == 0 else 0.0
            da = (first * Rk + torch.cumsum(dd, -1) - dd
                  + ys.flip(-1).cumsum(-1).flip(-1)
                  + (decay[:, c] * tail)[..., None])
            pdB[:, :, pb, c] = first * dB1 + (fh * dth)[..., None] * dB2
            pdC[:, :, pb, c] = first * dC1 + eh[..., None] * dC2
            pddt[:, :, pb, c] = xd + da * Av[:, None]
            pdA[:, c, :, pb] = (da * dth).sum(-1)

    def rows(a):
        """[..., nc, R, w] -> [..., t, w]: each chunk's first L rows."""
        a = a[..., :L, :].reshape(a.shape[:-3] + (nc * L, a.shape[-1]))
        return a[..., :t, :]

    dB = torch.zeros(b, t, NW, dtype=f)
    dC = torch.zeros(b, t, NW, dtype=f)
    for hh in range(h):                                  # fixed order
        for pb in range(npb):
            dB = dB + rows(pdB[:, hh, pb])
            dC = dC + rows(pdC[:, hh, pb])
    ddt = sum(rows(pddt[:, :, pb, ..., None])[..., 0] for pb in range(npb))
    dA = torch.zeros(h, dtype=f)
    for bb in range(b):
        for c in range(nc):
            for pb in range(npb):
                dA = dA + pdA[bb, c, :, pb]
    dx = dx[:, :, :L].reshape(b, nc * L, h, PW)[:, :t, :, :p]
    return (dx, ddt.transpose(1, 2), dA, dB[..., :n], dC[..., :n],
            dinit[:, :, :p, :n])


def inputs(b, t, h, p, n, seed, init=True, dsf=True):
    """numpy inputs and cotangents from a seed; x, dy, B and C rounded to
    bf16 values."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    bf = lambda a: torch.from_numpy(a).bfloat16().float().numpy()  # noqa: E731
    x, B, C, dy = bf(f(b, t, h, p)), bf(f(b, t, n)), bf(f(b, t, n)), \
        bf(f(b, t, h, p))
    dt = np.log1p(np.exp(f(b, t, h) - 1.0))                   # softplus
    A = -np.exp(f(h) * 0.5)
    s0 = f(b, h, p, n) * 0.1 if init else None
    dS = f(b, h, p, n) if dsf else None
    return x, dt, A, B, C, s0, dy, dS


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def magnitude(ins, chunk):
    """The decomposition in float64 without splits on |x|, |dy|, |B|,
    |C|, |init_state|, |dS_final| (dt and A as they are): per gradient
    entry, the sum of its terms' magnitudes."""
    x, dt, A, B, C, s0, dy, dS = ins
    ab = lambda a: None if a is None else np.abs(a)  # noqa: E731
    return emulate_bwd(*(_t(a, torch.float64) for a in (
        ab(x), dt, A, ab(B), ab(C), ab(s0), ab(dy), ab(dS))),
        chunk=chunk, rounding=exact, abs_a=True)


@functools.partial(jax.jit, static_argnums=(0, 1))
def _vjp(chunk, has_init, prim, dy, dS):
    def fn(*a):
        return jax_ssm.ssd_scan_chunked(*a[:5], a[5] if has_init else None,
                                        chunk=chunk)
    _, vjp = jax.vjp(fn, *prim)
    return vjp((dy, dS))


def jax_grads(ins, chunk):
    """jax.vjp of the JAX package's chunked scan in float32; dinit zeros
    without an init state (the kernel's cotangent of the zero state is
    not compared then)."""
    x, dt, A, B, C, s0, dy, dS = ins
    b, _, h, p = x.shape
    n = B.shape[-1]
    prim = tuple(jnp.asarray(a) for a in (x, dt, A, B, C, s0)
                 if a is not None)
    if dS is None:
        dS = np.zeros((b, h, p, n), np.float32)
    got = [np.asarray(g) for g in _vjp(chunk, s0 is not None, prim,
                                       jnp.asarray(dy), jnp.asarray(dS))]
    return got + [None] * (6 - len(got))


def assert_within(got, want, mag, what):
    if want is None:
        return
    err = ((got.double() - torch.as_tensor(np.array(want)).double()).abs()
           / mag.double().clamp(min=1e-30)).max().item()
    assert err <= TOL, f"{what}: {err:.3e} of the magnitudes > {TOL}"


CASES = [
    # name, b, t, h, p, n, chunk, init, dS_final
    ("mamba2-130m widths, 2 chunks", 1, 128, 2, 64, 128, 64, False, False),
    ("mamba2-130m widths, ragged tail", 1, 100, 2, 64, 128, 64, True, True),
    ("tiny-ssm t 9", 2, 9, 4, 32, 16, 8, False, True),
    ("P-block edge", 2, 50, 3, 40, 24, 16, True, True),
    ("t 1", 2, 1, 3, 64, 128, 64, True, False),
    ("two P blocks", 1, 40, 2, 128, 32, 16, True, True),
]


@pytest.mark.parametrize("name,b,t,h,p,n,chunk,init,dsf", CASES)
def test_emulation_matches_float64_and_jax(_jax_fp32, name, b, t, h, p, n,
                                           chunk, init, dsf):
    ins = inputs(b, t, h, p, n, seed=t + p + n, init=init, dsf=dsf)
    L = ssd.clamp_chunk(chunk, t)
    got = emulate_bwd(*map(_t, ins), chunk=chunk)
    mag = magnitude(ins, chunk)
    exact64 = ssd.ssd_chunked_bwd_ref(*(_t(a, torch.float64) for a in ins),
                                      chunk=L)
    jx = jax_grads(ins, L)
    for i, name_ in enumerate(GRADS):
        assert torch.isfinite(got[i]).all(), name_
        assert_within(got[i], exact64[i], mag[i],
                      f"{name}: {name_} vs float64 ssd_chunked_bwd_ref")
        assert_within(got[i], jx[i], mag[i],
                      f"{name}: {name_} vs jax.vjp of ssd_scan_chunked")


def test_emulation_at_a_large_decay_is_finite():
    """dt = 20, A = -16: exp(cum) underflows; w is taken only on j <= i,
    where its exponent is <= 0."""
    x, dt, A, B, C, s0, dy, dS = inputs(1, 40, 2, 32, 16, seed=5)
    dt[:] = 20.0
    A[:] = -16.0
    ins = (x, dt, A, B, C, s0, dy, dS)
    got = emulate_bwd(*map(_t, ins), chunk=16)
    want = ssd.ssd_chunked_bwd_ref(*(_t(a, torch.float64) for a in ins),
                                   chunk=16)
    mag = magnitude(ins, 16)
    for g, w, m, name in zip(got, want, mag, GRADS):
        assert torch.isfinite(g).all(), name
        assert_within(g, w, m, name)


def test_single_bf16_rounding_breaks_the_bound():
    """The check has teeth: rounding each f32 operand to one bf16, where
    the kernel takes hi + lo, moves the gradients at mamba2-130m's widths
    past 1e-4 of their magnitudes."""
    ins = inputs(1, 64, 2, 64, 128, seed=11)
    want = ssd.ssd_chunked_bwd_ref(*(_t(a, torch.float64) for a in ins),
                                   chunk=64)
    mag = magnitude(ins, 64)
    got = emulate_bwd(*map(_t, ins), chunk=64, rounding=single)
    broken = []
    for g, w, m, name in zip(got, want, mag, GRADS):
        try:
            assert_within(g, w, m, name)
        except AssertionError:
            broken.append(name)
    assert {"dx", "dB", "dC", "dinit"} <= set(broken), broken
