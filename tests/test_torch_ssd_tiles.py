"""The tile plan and arithmetic of the bf16 ``ssd_chunked`` kernel.

For bf16 inputs on the card ``csrc/ssd_chunked.cu`` (``mma_kernel``) runs
one CTA of 4 warps per (batch row, head, block of 16 rows of P), with the
block's state slice in f32 mma accumulators, warp w holding state columns
16 nk w .. 16 nk (w + 1) - 1, and every product on the tensor cores in
bf16: C B^T (exact operands), G x with dt folded into G (G as a bf16 pair
hi + lo), C S^T per warp over its columns (S as hi + lo; the four partials
summed in warp order) and the state update (u x)^T B (u x as hi + lo),
accumulated into the state after it is scaled by exp(cum_L). The chunk's
log-decay prefix is a shuffle scan over token pairs. No CUDA runs here:
``ssd_tile_plan`` is tested as the integer function it is, and
``emulate`` repeats the kernel's decomposition in f32 torch — P blocks,
zero-filled edges, the pair scan, the per-warp column ranges, the fold,
the hi + lo splits (``v.bfloat16()`` and ``(v - hi).bfloat16()``) and the
fixed-order cross-warp sum — and is held against the port's plain
versions ``ssd_chunked_ref`` / ``ssd_ref``, the JAX kernel
``repro.kernels.ops.ssd_chunked`` (interpret mode) and the JAX oracle
``repro.models.ssm.ssd_scan_ref`` on the same numpy inputs from a seed.

Tolerance. x, B and C are bf16 values (the kernel's inputs), so C B^T, the
products with x and with B are exact in f32; the f32 operands G, u x and
S enter as hi + lo, and |v - hi - lo| <= 2^-8 |v - hi| <= 2^-16 |v| (bf16
keeps 8 significant bits). Every output is a sum of products, so the
emulation differs from an f32 version by the split residue, at most
2^-16 = 1.5e-5 of the summed magnitudes, and by summation order, at most
~n 2^-24 of them for n <= N + L + 1 = 193 terms a sum (1.2e-5), each
chunk's error decaying with the state after it. Against the magnitude
``mag`` — the plain version on |x|, |B|, |C| and |init_state|, in which
every term is positive — the check is |emulation - reference| <= 1e-4
mag: about 4x the two bounds together. Rounding any of G, u x or S to a
single bf16 instead moves a product by up to 2^-8 of its size, which
breaks this check (``test_single_bf16_rounding_breaks_the_bound``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro.models import ssm as jax_ssm
from repro_torch.kernels import ssd

TOL = 1e-4                      # of the summed magnitudes, see above
WARPS, PB = ssd.SSD_WARPS, ssd.SSD_P_BLOCK


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ plan
@pytest.mark.parametrize("name,p,n,chunk,want", [
    ("mamba2-130m serving window", 64, 128, 16, (4, 2, 1)),
    ("mamba2-130m long scan", 64, 128, 64, (4, 2, 4)),
    ("tiny-ssm", 32, 16, 8, (2, 1, 1)),
    ("chunk 32", 32, 64, 32, (2, 1, 2)),
    ("P-block edge", 40, 128, 16, (3, 2, 1)),
    ("ragged N, chunk 50", 64, 120, 50, (4, 2, 4)),
    ("N just past one k-step per warp", 64, 72, 16, (4, 2, 1)),
    ("smallest", 8, 8, 1, (1, 1, 1)),
])
def test_tile_plan(name, p, n, chunk, want):
    pblocks, nk, mt = ssd.ssd_tile_plan(p, n, chunk)
    assert (pblocks, nk, mt) == want, name
    # the blocks cover P once; the warps' columns cover N, each once
    assert (pblocks - 1) * PB < p <= pblocks * PB
    cols = [range(16 * nk * w, 16 * nk * (w + 1)) for w in range(WARPS)]
    assert sorted(c for r in cols for c in r) == list(range(WARPS * 16 * nk))
    assert WARPS * 16 * (nk - 1) < n <= WARPS * 16 * nk
    # the 16-row tiles hold the chunk; mt is 1, 2 or 4 (the built instances)
    assert mt in (1, 2, 4) and 16 * mt >= chunk > (8 * mt if mt > 1 else 0)


def test_tile_plan_grid_at_the_serving_shapes():
    """mamba2-130m at b = 4 (h = 24, P = 64): 384 CTAs, not 96."""
    pblocks, _, _ = ssd.ssd_tile_plan(64, 128, ssd.clamp_chunk(64, 9))
    assert pblocks * 24 * 4 == 384


@pytest.mark.parametrize("p,n,chunk,err", [
    (36, 128, 16, ValueError),      # P off the 16-byte copies
    (64, 20, 16, ValueError),       # N off them
    (64, 136, 16, ValueError),      # N past the CTA's 128 columns
    (64, 256, 16, ValueError),
    (64, 128, 65, ValueError),      # chunk past the tiles
    (0, 128, 16, ValueError),
    (64.0, 128, 16, TypeError),
    (True, 128, 16, TypeError),
])
def test_tile_plan_refuses(p, n, chunk, err):
    with pytest.raises(err):
        ssd.ssd_tile_plan(p, n, chunk)


# ------------------------------------------------------------ emulation
def split(v):
    """The f32 operand v as the bf16 pair hi + lo (values kept in f32)."""
    hi = v.bfloat16().float()
    return hi, (v - hi).bfloat16().float()


def single(v):
    """v rounded to one bf16: what the kernel must not do."""
    return v.bfloat16().float(), torch.zeros_like(v)


def pair_scan(v):
    """The kernel's log-decay prefix of v [..., R]: lane l holds tokens
    2l and 2l + 1, an inclusive shuffle scan of the pair sums over 32
    lanes, then cum_2l = excl + v_2l and cum_2l+1 = cum_2l + v_2l+1."""
    r = v.shape[-1]
    pairs = torch.zeros(v.shape[:-1] + (32, 2))
    pairs[..., :r // 2, :] = v.reshape(v.shape[:-1] + (r // 2, 2))
    v0, v1 = pairs[..., 0], pairs[..., 1]
    incl = v0 + v1
    for o in (1, 2, 4, 8, 16):
        incl = torch.cat([incl[..., :o], incl[..., o:] + incl[..., :-o]], -1)
    excl = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :-1]], -1)
    cum0 = excl + v0
    cum1 = cum0 + v1
    return torch.stack([cum0, cum1], -1).reshape(v.shape[:-1] + (64,))[..., :r]


def emulate(x, dt, A, B, C, s0=None, *, chunk, rounding=split):
    """The bf16 kernel's arithmetic in f32 torch. x, B, C hold bf16 values
    (f32 tensors); returns (y f32 before the output's bf16 rounding,
    final state f32)."""
    b, t, h, p = x.shape
    n = B.shape[-1]
    L = ssd.clamp_chunk(chunk, t)
    pblocks, nk, mt = ssd.ssd_tile_plan(p, n, L)
    R, NW, cols = 16 * mt, WARPS * 16 * nk, 16 * nk
    xp = torch.zeros(b, t, h, pblocks * PB)
    xp[..., :p] = x
    Bp, Cp = torch.zeros(b, t, NW), torch.zeros(b, t, NW)
    Bp[..., :n], Cp[..., :n] = B, C
    y = torch.zeros(b, t, h, pblocks * PB)
    state = torch.zeros(b, h, pblocks * PB, NW)
    if s0 is not None:
        state[:, :, :p, :n] = s0
    causal = torch.ones(R, R, dtype=torch.bool).tril()
    for blk in range(pblocks):
        rows = slice(PB * blk, PB * (blk + 1))
        S = state[:, :, rows].clone()                        # [b, h, 16, NW]
        for t0 in range(0, t, L):
            l = min(L, t - t0)                               # rows past l: zero
            xs = torch.zeros(b, h, R, PB)
            xs[:, :, :l] = xp[:, t0:t0 + l, :, rows].transpose(1, 2)
            bs, cs = torch.zeros(b, 1, R, NW), torch.zeros(b, 1, R, NW)
            bs[:, 0, :l], cs[:, 0, :l] = Bp[:, t0:t0 + l], Cp[:, t0:t0 + l]
            dts = torch.zeros(b, h, R)
            dts[:, :, :l] = dt[:, t0:t0 + l].transpose(1, 2)
            cum = pair_scan(dts * A[None, :, None])          # [b, h, R]
            last = cum[..., -1:]
            u = dts * torch.exp(last - cum)
            # C B^T, gated, dt folded in; G x with G as hi + lo
            cb = cs @ bs.transpose(-1, -2)                   # [b, 1, R, R]
            diff = cum[..., :, None] - cum[..., None, :]
            g = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0))
                            * dts[..., None, :] * cb, 0.0)
            ghi, glo = rounding(g)
            yi = ghi @ xs + glo @ xs
            # C S^T per warp over its columns, S as hi + lo; summed in order
            shi, slo = rounding(S)
            ysum = None
            for w in range(WARPS):
                c = slice(cols * w, cols * (w + 1))
                part = (cs[..., c] @ shi[..., c].transpose(-1, -2)
                        + cs[..., c] @ slo[..., c].transpose(-1, -2))
                ysum = part if ysum is None else ysum + part
            yc = yi + ysum * torch.exp(cum)[..., None]
            y[:, t0:t0 + l, :, rows] = yc[:, :, :l].transpose(1, 2)
            # S = S exp(cum_L) + (u x)^T B with u x as hi + lo
            ahi, alo = rounding(u[..., None] * xs)
            S = S * torch.exp(last)[..., None]
            S = S + ahi.transpose(-1, -2) @ bs
            S = S + alo.transpose(-1, -2) @ bs
        state[:, :, rows] = S
    return y[..., :p], state[:, :, :p, :n]


def inputs(b, t, h, p, n, seed, init=True):
    """numpy inputs from a seed, x, B and C rounded to bf16 values."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    bf = lambda a: torch.from_numpy(a).bfloat16().float().numpy()  # noqa: E731
    x, B, C = bf(f(b, t, h, p)), bf(f(b, t, n)), bf(f(b, t, n))
    dt = np.log1p(np.exp(f(b, t, h) - 1.0))                   # softplus
    A = -np.exp(f(h) * 0.5)
    s0 = f(b, h, p, n) * 0.1 if init else None
    return x, dt, A, B, C, s0


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


def magnitude(ins, chunk):
    """The plain version on |x|, |B|, |C|, |init_state|: per output, the
    sum of its terms' magnitudes."""
    x, dt, A, B, C, s0 = ins
    t = x.shape[1]
    return ssd.ssd_chunked_ref(
        *map(_t, (np.abs(x), dt, A, np.abs(B), np.abs(C),
                  None if s0 is None else np.abs(s0))),
        chunk=ssd.clamp_chunk(chunk, t))


def assert_within(got, want, mag, what):
    err = ((got.float() - torch.as_tensor(np.array(want)).float()).abs()
           / mag.float().clamp(min=1e-30)).max().item()
    assert err <= TOL, f"{what}: {err:.3e} of the magnitudes > {TOL}"


CASES = [
    # name, b, t, h, p, n, chunk, init
    ("mamba2-130m verify window", 2, 9, 24, 64, 128, 64, True),
    ("mamba2-130m draft window", 2, 16, 24, 64, 128, 64, True),
    ("mamba2-130m window, zero state", 2, 16, 24, 64, 128, 64, False),
    ("tiny-ssm", 2, 19, 4, 32, 16, 8, True),
    ("tiny-ssm, zero state", 2, 9, 4, 32, 16, 8, False),
    ("t 1", 2, 1, 2, 64, 128, 16, True),
    ("t 17 chunk 16", 2, 17, 2, 64, 128, 16, True),
    ("t 17 chunk 64", 2, 17, 2, 64, 128, 64, False),
    ("t 50 chunk 16", 2, 50, 2, 64, 128, 16, False),
    ("t 50 chunk 64", 2, 50, 2, 64, 128, 64, True),
    ("t 130 chunk 16", 2, 130, 2, 64, 128, 16, True),
    ("t 130 chunk 64", 2, 130, 2, 64, 128, 64, True),
    ("P-block edge, ragged N", 2, 23, 3, 40, 24, 16, True),
]


@pytest.mark.parametrize("name,b,t,h,p,n,chunk,init", CASES)
def test_emulation_matches_plain_and_jax(name, b, t, h, p, n, chunk, init):
    ins = inputs(b, t, h, p, n, seed=t + chunk + p, init=init)
    y, s = emulate(*map(_t, ins), chunk=chunk)
    my, ms = magnitude(ins, chunk)
    refs = {
        "ssd_chunked_ref": ssd.ssd_chunked_ref(
            *map(_t, ins), chunk=ssd.clamp_chunk(chunk, t)),
        "ssd_ref": ssd.ssd_ref(*map(_t, ins)),
        "jax ops.ssd_chunked (interpret)": jax_ops.ssd_chunked(
            *map(_j, ins), chunk=chunk),
        "jax ssd_scan_ref": jax_ssm.ssd_scan_ref(*map(_j, ins)),
    }
    for ref_name, (wy, ws) in refs.items():
        assert_within(y, wy, my, f"{name}: y vs {ref_name}")
        assert_within(s, ws, ms, f"{name}: state vs {ref_name}")


@pytest.mark.parametrize("t,h,p,n", [(9, 24, 64, 128), (16, 24, 64, 128),
                                     (16, 4, 32, 16)])
def test_emulated_gather_route(t, h, p, n):
    """dt = 0 past idx[b] gives the state after idx[b] + 1 tokens (the
    collected states of both oracles at idx); a fully masked window
    leaves the state bit for bit as it was."""
    x, dt, A, B, C, s0 = inputs(4, t, h, p, n, seed=t + h)
    idx = np.array([0, t // 3, t - 2, t - 1])
    keep = (np.arange(t)[None] <= idx[:, None])[..., None]
    _, s = emulate(*map(_t, (x, dt * keep, A, B, C, s0)), chunk=64)
    _, ms = magnitude((x, dt * keep, A, B, C, s0), 64)
    _, states = ssd.ssd_ref(*map(_t, (x, dt, A, B, C, s0)),
                            collect_states=True)
    _, jstates = jax_ssm.ssd_scan_ref(*map(_j, (x, dt, A, B, C, s0)),
                                      collect_states=True)
    assert_within(s, states[np.arange(4), idx], ms, "vs ssd_ref states")
    assert_within(s, np.asarray(jstates)[np.arange(4), idx], ms,
                  "vs jax ssd_scan_ref states")
    _, same = emulate(*map(_t, (x, dt * 0, A, B, C, s0)), chunk=64)
    assert torch.equal(same, _t(s0))


def test_single_bf16_rounding_breaks_the_bound():
    """The check has teeth: rounding G, u x and S to one bf16 each, where
    the kernel takes hi + lo, moves the draft window's outputs past
    1e-4 of their magnitudes."""
    ins = inputs(2, 16, 24, 64, 128, seed=5)
    wy, ws = ssd.ssd_chunked_ref(*map(_t, ins), chunk=16)
    my, ms = magnitude(ins, 16)
    y, s = emulate(*map(_t, ins), chunk=16, rounding=single)
    with pytest.raises(AssertionError):
        assert_within(y, wy, my, "y")
    with pytest.raises(AssertionError):
        assert_within(s, ws, ms, "state")
