"""The split-KV plan and arithmetic of the serving kernels' bf16 loop.

``csrc/serve_attention_mma.cuh`` runs ``decode_attention_paged``,
``decode_attention``, ``tree_attention_paged`` and ``tree_attention`` for
bf16 inputs on the card: the host plan ``split_kv_plan`` picks a cluster
of ``cs`` CTAs per (batch row, kv head, row tile) from the shapes and a
row's reach (MBS * block positions of a pool, S of a contiguous cache);
on the device each CTA takes a balanced share of the tile's 64-key chunks
of its visible range, runs an online softmax over them with P rounded to
bf16 for the P V product, and one CTA per row merges the ``cs`` partials
(O, m, l) in split order. No CUDA runs here: the plan is tested as the
integer function it is (and the wrappers are shown to plan with their
reach), and ``emulate`` below repeats the kernel's arithmetic in f32
torch, chunk by chunk, and is held against the port's plain versions and
the JAX package's oracles ``repro.kernels.ref.decode_attention_paged_ref``
/ ``tree_attention_paged_ref`` (pools) and ``decode_attention_ref`` /
``tree_attention_ref`` (contiguous caches) on the same numpy inputs. A
contiguous cache [B, S, Hkv, D] is the pool of B blocks of S positions
with the block tables ``arange(B)[:, None]``, which is how the emulation
reads it: the kernel's contiguous addressing differs from the paged one
only in where a key's bytes lie. The loop's 8-bit route (int8 / fp8 K/V
codes with f32 scales, ``emulate(..., k_scale=, v_scale=)``) runs the
same cases on K/V quantized as the model appends them, against the plain
versions and the JAX oracles given the same scales; its P times v_scale
enters P V as a bf16 pair hi + lo, so it stays within 2^-16 max|v|.

Tolerances: with P kept in f32 the emulation differs from the plain
versions only in summation order (atol = rtol = 1e-5). Rounding P to
bf16 moves each p_j by at most 2^-9 p_j, and an output is a convex
combination of V rows, so it moves by at most 2^-9 max|v| (asserted with
1e-5 for the f32 sums). Rows that see no key are 0 in the port; the JAX
jnp oracle returns garbage there (ROADMAP.md, section C), so they are
left out of the comparison with JAX.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro_torch.core.spec_decode import TreeTemplate
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import tree_attention as ta
from repro_torch.models.attention import quantize_kv

TOL = dict(atol=1e-5, rtol=1e-5)
SMS = 132                                   # an H100's SMs
KEYS = da.KEY_CHUNK
LOG2E = 1.4426950408889634
NEG = -1e30


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ plan
@pytest.mark.parametrize("name,b,hkv,rows,reach,want", [
    ("verify window G4 x Tq9", 4, 8, 36, 1024, (3, 3)),
    ("draft window G4 x Tq16", 4, 8, 64, 1024, (3, 4)),
    ("tree window G4 x Tq31", 4, 8, 124, 1024, (3, 8)),
    ("prefill chunk G4 x Tq8", 4, 8, 32, 1024, (3, 2)),
    ("prompt chunk of 256", 4, 8, 1024, 1024, (1, 8)),
    ("B = 1", 1, 8, 36, 4096, (8, 3)),
    ("G = 7 x Tq 16: 112 rows", 4, 2, 112, 1024, (8, 7)),
    ("G = 7 x Tq 31: 217 rows, two tiles", 4, 2, 217, 1024, (7, 7)),
    ("G = 7 x Tq 36: 252 rows, two tiles", 2, 2, 252, 1024, (8, 8)),
    ("reach below 64 cs", 1, 8, 36, 100, (2, 3)),
    ("reach of one key", 1, 1, 1, 1, (1, 1)),
])
def test_plan_at_main_and_edge_shapes(name, b, hkv, rows, reach, want):
    cs, warps = da.split_kv_plan(b, hkv, rows, reach, SMS)
    assert (cs, warps) == want, name
    tiles = -(-rows // (16 * warps))
    assert 1 <= cs <= da.MAX_CLUSTER and 1 <= warps <= da.MAX_WARPS
    assert tiles * warps * 16 >= rows > tiles * (warps - 1) * 16
    assert cs <= -(-reach // KEYS)
    # one wave: the CTAs stay within 90 % of the SMs unless cs is 1
    assert cs == 1 or b * hkv * tiles * cs <= SMS * 9 // 10


def test_plan_sweep_bounds():
    for b in (1, 2, 3, 4, 8, 64):
        for hkv in (1, 2, 4, 8):
            for rows in (1, 9, 16, 17, 36, 112, 128, 129, 217, 1024):
                for reach in (1, 63, 64, 65, 1024, 8192):
                    cs, warps = da.split_kv_plan(b, hkv, rows, reach, SMS)
                    assert type(cs) is int and type(warps) is int
                    assert 1 <= cs <= 8 and 1 <= warps <= 8
                    assert -(-rows // (16 * warps)) * 16 * warps >= rows


@pytest.mark.parametrize("bad", [torch.tensor(4), np.int64(4), 4.0, True])
def test_plan_takes_python_ints_only(bad):
    """A device value (a tensor's max) must never reach the plan: it would
    synchronize the host and break graph capture."""
    with pytest.raises(TypeError):
        da.split_kv_plan(bad, 8, 36, 1024, SMS)
    with pytest.raises(TypeError):
        da.split_kv_plan(4, 8, 36, bad, SMS)


def test_plan_rejects_empty_shapes():
    with pytest.raises(ValueError):
        da.split_kv_plan(4, 8, 0, 1024, SMS)


# ------------------------------------------------------------ emulation
def _bf16(x):
    return x.to(torch.bfloat16).float()


def emulate(q, k_pages, v_pages, tables, kv_len, q_pos, *, tree=None,
            window=0, softcap=0.0, scale=None, round_p=True, k_scale=None,
            v_scale=None):
    """The bf16 loop's arithmetic in f32: the plan's tiles and key split,
    per-split online softmax over 64-key chunks (log2 units; P rounded to
    bf16 for P V when ``round_p``; l sums the f32 P), the merge in split
    order. ``tree`` = (win_start, win_len, anc) selects the tree mask.
    The plan's reach is MBS * block: S for a contiguous cache passed as B
    blocks of S. With ``k_scale`` / ``v_scale`` (pools of int8 / fp8
    codes), the 8-bit route: the codes enter the products as they are
    (bf16 holds them exactly), k_scale multiplies each score column before
    the scale, and v_scale multiplies P, which enters P V as a bf16 pair
    hi + lo (``round_p``), while l sums the unscaled P; a key past the
    range has code 0 and scale 0.
    Returns f32 [B, Tq, Hq, D]; rows that see no key are 0."""
    b, tq, hq, d = q.shape
    hkv = k_pages.shape[2]
    g = hq // hkv
    rows = tq * g
    mbs, bs = tables.shape[1], k_pages.shape[1]
    cs, warps = da.split_kv_plan(b, hkv, rows, mbs * bs, SMS)
    tile = 16 * warps
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    k = da.gather_pages(k_pages, tables).float()            # [B, S, Hkv, D]
    v = da.gather_pages(v_pages, tables).float()
    quant = k_scale is not None
    if quant:                                               # [B, S, Hkv]
        ks = da.gather_pages(k_scale, tables)
        vs = da.gather_pages(v_scale, tables)
    reach = k.shape[1]
    # row r = i * G + gg of kv head h is query head h * G + gg of query i
    qr = q.float().reshape(b, tq, hkv, g, d).permute(0, 2, 1, 3, 4) \
        .reshape(b, hkv, rows, d)
    out = torch.zeros(b, hkv, rows, d)
    for bi in range(b):
        kl = min(int(kv_len[bi]), reach)
        for r0 in range(0, rows, tile):
            rr = torch.arange(r0, min(rows, r0 + tile))
            qp = q_pos[bi, rr // g].long()
            rlo = qp - window + 1 if window > 0 else torch.zeros_like(qp)
            if tree is not None:
                ws, wl = int(tree[0][bi]), int(tree[1][bi])
                anc = ta.anc_bits(tree[2])[bi, rr // g]
                hi = min(kl, ws + wl)
                lo = min(ws, max(0, int(qp.min()) - window + 1)) \
                    if window > 0 else 0
                rhi = torch.full_like(qp, min(hi, ws))
            else:
                hi = min(kl, int(qp.max()) + 1)
                lo = max(0, int(qp.min()) - window + 1) if window > 0 else 0
                rhi = torch.clamp(qp + 1, max=hi)
            lo = lo // KEYS * KEYS
            nchunk = -(-(hi - lo) // KEYS) if hi > lo else 0
            parts = []
            for split in range(cs):
                m = torch.full((hkv, len(rr)), NEG)
                l = torch.zeros(hkv, len(rr))
                o = torch.zeros(hkv, len(rr), d)
                for c in range(split * nchunk // cs,
                               (split + 1) * nchunk // cs):
                    p = lo + c * KEYS + torch.arange(KEYS)
                    inside = p < hi
                    kc = torch.zeros(KEYS, hkv, d)
                    vc = torch.zeros(KEYS, hkv, d)
                    kc[inside], vc[inside] = k[bi, p[inside]], v[bi, p[inside]]
                    s = torch.einsum("hrd,khd->hrk", qr[bi][:, rr], kc)
                    if quant:
                        ksc = torch.zeros(KEYS, hkv)
                        vsc = torch.zeros(KEYS, hkv)
                        ksc[inside] = ks[bi, p[inside]]
                        vsc[inside] = vs[bi, p[inside]]
                        s = s * ksc.T[:, None]
                    s = s * scale
                    if softcap:
                        s = torch.tanh(s / softcap) * softcap
                    s = s * LOG2E
                    ok = (p[None] >= rlo[:, None]) & (p[None] < rhi[:, None])
                    if tree is not None:
                        jw = (p - ws).clamp(0, tq - 1)
                        bit = (anc[:, None] >> jw[None]) & 1
                        ok |= ((p >= ws) & (p < min(hi, ws + tq)))[None] \
                            & (bit == 1)
                    s = torch.where(ok[None], s, NEG)
                    mx = torch.maximum(m, s.amax(-1))
                    base = torch.where(mx == NEG, 0.0, mx)
                    alpha = torch.exp2(m - base)
                    pr = torch.exp2(s - base[..., None])
                    l = l * alpha + pr.sum(-1)
                    if quant:                   # P v_scale as hi + lo
                        pv = pr * vsc.T[:, None]
                        pv = _bf16(pv) + _bf16(pv - _bf16(pv)) if round_p \
                            else pv
                    else:
                        pv = _bf16(pr) if round_p else pr
                    o = o * alpha[..., None] + torch.einsum("hrk,khd->hrd",
                                                            pv, vc)
                    m = mx
                parts.append((o, m, l))
            mmax = torch.stack([m for _, m, _ in parts]).amax(0)
            base = torch.where(mmax == NEG, 0.0, mmax)
            acc = torch.zeros(hkv, len(rr), d)
            lsum = torch.zeros(hkv, len(rr))
            for o, m, l in parts:                       # split order
                w = torch.exp2(m - base)
                lsum += w * l
                acc += w[..., None] * o
            out[bi][:, rr] = acc / torch.where(lsum == 0, 1.0, lsum)[..., None]
    return out.reshape(b, hkv, tq, g, d).permute(0, 2, 1, 3, 4) \
        .reshape(b, tq, hq, d)


def _window(rng, b, tq, ctx, tree, dead):
    """kv_len, q_pos [B, Tq] and the tree operands of rows with ``ctx``
    context keys. Causal: kv_len = ctx, queries at the last Tq positions.
    Tree: random templates at win_start = ctx, kv_len = ctx + Tq, logical
    positions ctx + depth; rows in ``dead`` get win_len 0 (with ctx 0 they
    see no key)."""
    ctx = np.asarray(ctx, np.int64)
    if not tree:
        return ctx, np.maximum(ctx[:, None] - tq + np.arange(tq)[None], 0), {}
    anc = np.zeros((b, tq), np.int64)
    depth = np.zeros((b, tq), np.int64)
    win_len = np.zeros(b, np.int64)
    for r in range(b):
        while True:
            br = [int(x) for x in rng.integers(1, 4, rng.integers(1, 8))]
            try:
                t = TreeTemplate.from_branching(br)
            except ValueError:
                continue
            if t.num_slots <= tq:
                break
        ns = t.num_slots
        anc[r, :ns], depth[r, :ns], win_len[r] = t.anc, t.depth, ns
    win_len[list(dead)] = 0
    return ctx + tq, ctx[:, None] + depth, dict(
        win_start=torch.from_numpy(ctx).int(),
        win_len=torch.from_numpy(win_len).int(), anc=torch.from_numpy(anc))


def _paged_case(seed, b, tq, hq, hkv, d, bs, ctx, tree=False, dead=()):
    """bf16-valued f32 inputs of ``_window``'s rows. Pools hold each row's
    blocks, shuffled; block 0 is garbage."""
    rng = np.random.default_rng(seed)
    case = dict(q=_bf16(torch.from_numpy(
        rng.standard_normal((b, tq, hq, d)).astype(np.float32))))
    kv_len, q_pos, extra = _window(rng, b, tq, ctx, tree, dead)
    case.update(extra)
    mbs = max(1, int(max(-(-int(n) // bs) for n in kv_len)))
    nb = 1 + b * mbs
    tables = rng.permutation(np.arange(1, nb)).reshape(b, mbs)
    case.update(
        k_pages=_bf16(torch.from_numpy(
            rng.standard_normal((nb, bs, hkv, d)).astype(np.float32))),
        v_pages=_bf16(torch.from_numpy(
            rng.standard_normal((nb, bs, hkv, d)).astype(np.float32))),
        block_tables=torch.from_numpy(tables).int(),
        kv_len=torch.from_numpy(kv_len).int(),
        q_pos=torch.from_numpy(q_pos).int())
    return case


def _contig_case(seed, b, tq, hq, hkv, d, s, ctx, tree=False, dead=()):
    """bf16-valued f32 inputs of ``_window``'s rows in a contiguous cache
    [B, S, Hkv, D]; kv_len may pass S. ``s`` None: S ends at row 0's tree
    window (win_start + win_len)."""
    rng = np.random.default_rng(seed)
    case = dict(q=_bf16(torch.from_numpy(
        rng.standard_normal((b, tq, hq, d)).astype(np.float32))))
    kv_len, q_pos, extra = _window(rng, b, tq, ctx, tree, dead)
    case.update(extra)
    if s is None:
        s = int(extra["win_start"][0] + extra["win_len"][0])
    case.update(
        k=_bf16(torch.from_numpy(
            rng.standard_normal((b, s, hkv, d)).astype(np.float32))),
        v=_bf16(torch.from_numpy(
            rng.standard_normal((b, s, hkv, d)).astype(np.float32))),
        kv_len=torch.from_numpy(kv_len).int(),
        q_pos=torch.from_numpy(q_pos).int())
    return case


def _quantized(case, name):
    """``case`` with its K/V as int8 / fp8 codes and f32 k_scale / v_scale,
    quantized as the model appends them."""
    case = dict(case)
    for n in ("k", "v", "k_pages", "v_pages"):
        if n in case:
            case[n], case[n[0] + "_scale"] = quantize_kv(case[n], name)
    return case


def _jnp(t):
    """A torch tensor as a jnp array (fp8 through its bytes)."""
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(da.as_bytes(t).numpy()).view(jnp.float8_e4m3fn)
    return jnp.asarray(t.numpy())


def _run(case, **kw):
    """(emulation with f32 P, with bf16 P, the port's plain version, the
    JAX oracle) as numpy; plus the rows that see some key. A contiguous
    case (``k``, ``v``) is emulated as B blocks of S. Scales of a
    quantized case go to all four."""
    q, kv_len, q_pos = case["q"], case["kv_len"], case["q_pos"]
    sc = {n: case[n] for n in ("k_scale", "v_scale") if n in case}
    jsc = {n: _jnp(t) for n, t in sc.items()}
    if "k" in case:
        keys = case["k"]
        args = [q, case["k"], case["v"], kv_len, q_pos]
        tables = torch.arange(keys.shape[0], dtype=torch.int32)[:, None]
        emu = [q, case["k"], case["v"], tables, kv_len, q_pos]
        flat = (da.decode_attention_ref, ref.decode_attention_ref)
        tree_fns = (ta.tree_attention_ref, ref.tree_attention_ref)
    else:
        keys = da.gather_pages(case["k_pages"], case["block_tables"])
        args = emu = [q, case["k_pages"], case["v_pages"],
                      case["block_tables"], kv_len, q_pos]
        flat = (da.decode_attention_paged_ref, ref.decode_attention_paged_ref)
        tree_fns = (ta.tree_attention_paged_ref, ref.tree_attention_paged_ref)
    jargs = [_jnp(a) for a in args]
    if "anc" in case:
        tree = (case["win_start"], case["win_len"], case["anc"])
        plain = tree_fns[0](*args, case["win_start"], case["anc"],
                            win_len=case["win_len"], **sc, **kw)
        jax = tree_fns[1](
            *jargs, jnp.asarray(case["win_start"].numpy()),
            jnp.asarray(case["anc"].numpy().astype(np.uint32)),
            win_len=jnp.asarray(case["win_len"].numpy()), **jsc, **kw)
        pos = torch.arange(keys.shape[1])[None].expand(keys.shape[0], -1)
        eff = torch.minimum(kv_len.long(), case["win_start"].long()
                            + case["win_len"].long())
        seen = (ta.tree_allowed(q_pos, pos, ta.TreeAttnInfo(
            case["win_start"], case["anc"], case["win_len"]),
            kw.get("window", 0)) & (pos < eff[:, None])[:, None]).any(-1)
    else:
        tree = None
        plain = flat[0](*args, **sc, **kw)
        jax = flat[1](*jargs, **jsc, **kw)
        seen = da.causal_allowed(q_pos, kv_len, keys.shape[1],
                                 kw.get("window", 0)).any(-1)
    exact = emulate(*emu, tree=tree, round_p=False, **sc, **kw)
    rounded = emulate(*emu, tree=tree, round_p=True, **sc, **kw)
    return (exact.numpy(), rounded.numpy(), plain.numpy(), np.asarray(jax),
            seen.numpy())


def _check_against_plain_and_jax(name, case, kw):
    exact, rounded, plain, jax, seen = _run(case, **kw)
    # the split and merge are exact up to f32 summation order
    np.testing.assert_allclose(exact, plain, **TOL)
    # bf16 P: within 2^-9 max|v| of the plain version; the 8-bit route's
    # P v_scale as hi + lo: within 2^-16 max|v| (v dequantized)
    v = case["v"] if "v" in case else case["v_pages"]
    bits = 9
    if "v_scale" in case:
        v = da.dequantize_kv(v, case["v_scale"])
        bits = 16
    bound = 2.0 ** -bits * float(v.abs().max()) + 1e-5
    assert np.abs(rounded - plain).max() <= bound, name
    # JAX's oracle on the rows that see a key; the others are 0 here
    np.testing.assert_allclose(exact[seen], jax[seen], **TOL)
    assert not exact[~seen].any() and not rounded[~seen].any()


CASES = {
    # B 4 x Hkv 2: clusters of 5 over 5 chunks; the 70-key row leaves 3
    # splits empty, kv_len 1 leaves 4, kv_len 0 sees no key at all
    "empty splits, kv_len 1, a row that sees no key, bs 16": dict(
        b=4, tq=9, hq=8, hkv=2, d=32, bs=16, ctx=[300, 70, 1, 0]),
    # clusters of 8 over the 3 chunks the window leaves
    "window removes whole splits, softcap, bs 64": dict(
        b=1, tq=9, hq=8, hkv=2, d=48, bs=64, ctx=[1000],
        kw=dict(window=100, softcap=30.0)),
    "ragged rows, window, softcap, bs 16": dict(
        b=3, tq=16, hq=8, hkv=2, d=32, bs=16, ctx=[40, 333, 129],
        kw=dict(window=64, softcap=20.0)),
    # G = 7: queries straddle the 16-row mma tiles; Tq 36 makes two CTA
    # tiles of 128 rows with query 18 across the boundary
    "G = 7, Tq 16: 112 rows, bs 16": dict(
        b=3, tq=16, hq=14, hkv=2, d=32, bs=16, ctx=[16, 200, 77]),
    "G = 7, Tq 36: 252 rows in two tiles, bs 64": dict(
        b=2, tq=36, hq=14, hkv=2, d=32, bs=64, ctx=[36, 300]),
    "tree, 31 slots, a row that sees no key, short rows": dict(
        b=4, tq=31, hq=8, hkv=2, d=32, bs=16, ctx=[0, 1, 70, 400],
        tree=True, dead=(0,)),
    # 217 rows in two tiles of 112
    "tree, G = 7, Tq 31: 217 rows, bs 16": dict(
        b=2, tq=31, hq=14, hkv=2, d=32, bs=16, ctx=[5, 300], tree=True),
    "tree, window removes splits, softcap, bs 64": dict(
        b=1, tq=23, hq=8, hkv=2, d=64, bs=64, ctx=[1500], tree=True,
        kw=dict(window=64, softcap=30.0)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_emulation_matches_plain_and_jax(name):
    spec = dict(CASES[name])
    kw = spec.pop("kw", {})
    case = _paged_case(len(name), **spec)
    _check_against_plain_and_jax(name, case, kw)


def test_cases_take_several_splits():
    """Every emulated case splits (cs > 1), and the first two leave some
    split of some row without a chunk."""
    for name, spec in CASES.items():
        rows = spec["tq"] * spec["hq"] // spec["hkv"]
        mbs = max(1, max(-(-(c + spec["tq"] * bool(spec.get("tree"))) //
                            spec["bs"]) for c in spec["ctx"]))
        cs, _ = da.split_kv_plan(spec["b"], spec["hkv"], rows,
                                 mbs * spec["bs"], SMS)
        assert cs > 1, name
    assert da.split_kv_plan(4, 2, 36, 19 * 16, SMS)[0] == 5   # 70 keys: 2 chunks
    assert da.split_kv_plan(1, 2, 36, 16 * 64, SMS)[0] == 8   # window: 3 chunks


def test_full_width_bf16_p_error():
    """G 4, D 128, kv 4096 (Hq 32, Hkv 8, one row, clusters of 8): the
    emulated kernel with bf16 P and a bf16 output stays within the bf16
    tolerance 2e-2 of the plain version."""
    case = _paged_case(7, b=1, tq=9, hq=32, hkv=8, d=128, bs=64, ctx=[4096])
    args = [case[n] for n in ("q", "k_pages", "v_pages", "block_tables",
                              "kv_len", "q_pos")]
    assert da.split_kv_plan(1, 8, 36, 4096, SMS) == (8, 3)
    out = _bf16(emulate(*args, round_p=True))
    plain = da.decode_attention_paged_ref(*args)
    err = (out - plain).abs().max().item()
    assert err <= 2e-2, err


# --------------------------------------- the 8-bit route (int8 / fp8 K/V)
QUANT = ["int8", "fp8"]


def test_widening_codes_to_bf16_is_exact():
    """Every int8 code and every e4m3 value (NaN aside) is a bf16 value, so
    the 8-bit route's products see the codes unrounded."""
    i8 = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8)
    assert torch.equal(_bf16(i8.float()), i8.float())
    e4 = torch.arange(256, dtype=torch.int16).to(torch.uint8).view(
        torch.float8_e4m3fn).float()
    e4 = e4[torch.isfinite(e4)]
    assert e4.numel() == 254
    assert torch.equal(_bf16(e4), e4)


def _byte_perm(x, y, sel):
    """CUDA's __byte_perm on uint32 numpy arrays: byte n of the result is
    byte (sel >> 4 n) & 7 of the 8 bytes y:x (x's low byte is byte 0)."""
    src = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(x, dtype=np.uint32)
    for n in range(4):
        k = (sel >> (4 * n)) & 7
        byte = (src >> np.uint64(8 * k)) & np.uint64(0xFF)
        out |= (byte.astype(np.uint32) << np.uint32(8 * n))
    return out


def widen16(words, code):
    """serve_attention_mma.cuh's ``widen16`` on uint32 words of 4 codes
    each (code 2: int8, 3: e4m3), bit for bit in numpy: the bf16 pairs
    [n, 2] as uint32 words."""
    words = np.asarray(words, np.uint32)
    out = []
    if code == 2:
        u = words ^ np.uint32(0x80808080)
        f = [(_byte_perm(u, np.full_like(u, 0x4B000000), 0x7540 | k)
              .view(np.float32) - np.float32(8388736.0)).view(np.uint32)
             for k in range(4)]
        out = [_byte_perm(f[0], f[1], 0x7632), _byte_perm(f[2], f[3], 0x7632)]
    else:
        for sel in (0x1404, 0x3424):
            t = _byte_perm(words, np.zeros_like(words), sel)
            b = (t & np.uint32(0x80008000)) | \
                ((t & np.uint32(0x7F007F00)) >> np.uint32(4))
            two120 = np.float32(2.0 ** 120)
            lo = (b << np.uint32(16)).view(np.float32) * two120
            hi = (b & np.uint32(0xFFFF0000)).view(np.float32) * two120
            out.append(_byte_perm(lo.view(np.uint32), hi.view(np.uint32),
                                  0x7632))
    return np.stack(out, -1)


@pytest.mark.parametrize("code,dtype", [(2, torch.int8),
                                        (3, torch.float8_e4m3fn)])
def test_kernel_widening_is_exact_bit_for_bit(code, dtype):
    """The kernel widens codes to bf16 with integer and f32 ALU steps, not
    conversions: for every int8 code and every e4m3 value (NaN aside)
    those steps give the code's value, bit for bit."""
    codes = torch.arange(256, dtype=torch.int16).to(torch.uint8)
    words = codes.numpy().view(np.uint32)                  # 4 codes a word
    pairs = widen16(words, code).reshape(-1)               # 2 bf16 a word
    got = torch.from_numpy(pairs.view(np.int16).copy()).view(torch.bfloat16)
    want = codes.view(dtype).float()
    finite = torch.isfinite(want)
    assert int(finite.sum()) == (256 if code == 2 else 254)
    assert torch.equal(got.float()[finite], want[finite])


@pytest.mark.parametrize("qname", QUANT)
@pytest.mark.parametrize("name", list(CASES))
def test_quantized_emulation_matches_plain_and_jax(name, qname):
    """The 8-bit route on every paged case: exact up to summation order
    with f32 P, within 2^-16 max|v| with P times v_scale as hi + lo."""
    spec = dict(CASES[name])
    kw = spec.pop("kw", {})
    case = _quantized(_paged_case(len(name), **spec), qname)
    _check_against_plain_and_jax(name, case, kw)


@pytest.mark.parametrize("qname", QUANT)
def test_quantized_full_width_error(qname):
    """G 4, D 128, kv 4096, and a row of kv_len 1 whose one key has |v|
    near 5, with int8 / fp8 pools: the emulated 8-bit route with a bf16
    output stays within the bf16 tolerance 2e-2 (phase 2 of
    chip_smoke.py) of the plain version on the f32-dequantized K/V, its
    output rounding aside at most 2^-16 max|v| from it. P v_scale rounded
    to one bf16 would move the one-key row by up to 2^-8 of |v|."""
    case = _quantized(_paged_case(7, b=2, tq=9, hq=32, hkv=8, d=128, bs=64,
                                  ctx=[4096, 1]), qname)
    one = case["block_tables"][1, 0]
    case["v_scale"][one, 0] *= 5.0 / float(
        (case["v_pages"][one, 0].float() * case["v_scale"][one, 0, :, None]
         ).abs().max())
    args = [case[n] for n in ("q", "k_pages", "v_pages", "block_tables",
                              "kv_len", "q_pos")]
    sc = dict(k_scale=case["k_scale"], v_scale=case["v_scale"])
    out = emulate(*args, round_p=True, **sc)
    plain = da.decode_attention_paged_ref(*args, **sc)
    vmax = float(da.dequantize_kv(case["v_pages"],
                                  case["v_scale"]).abs().max())
    assert (out - plain).abs().max().item() <= 2.0 ** -16 * vmax + 1e-5
    err = (_bf16(out) - plain).abs().max().item()
    assert err <= 2e-2, err


# ------------------------------------------------------ contiguous caches
CONTIG_CASES = {
    # B 4 x Hkv 2 over S 320: clusters of 5; the 70-key row leaves 3
    # splits empty, kv_len 1 leaves 4, kv_len 0 sees no key at all
    "empty splits, kv_len 1, a row that sees no key": dict(
        b=4, tq=9, hq=8, hkv=2, d=32, s=320, ctx=[300, 70, 1, 0]),
    # clusters of 8 over the 3 chunks the window leaves
    "window removes whole splits, softcap": dict(
        b=1, tq=9, hq=8, hkv=2, d=48, s=1024, ctx=[1000],
        kw=dict(window=100, softcap=30.0)),
    "G = 7, Tq 16: 112 rows": dict(
        b=3, tq=16, hq=14, hkv=2, d=32, s=256, ctx=[16, 200, 77]),
    "G = 7, Tq 36: 252 rows in two tiles": dict(
        b=2, tq=36, hq=14, hkv=2, d=32, s=320, ctx=[36, 300]),
    # kv_len past S: the sweep stops at S; row 0's queries all lie past S,
    # row 1's straddle it
    "kv_len > S": dict(
        b=3, tq=9, hq=8, hkv=2, d=32, s=200, ctx=[230, 205, 150]),
    "tree, G = 7, Tq 31: 217 rows": dict(
        b=2, tq=31, hq=14, hkv=2, d=32, s=400, ctx=[5, 300], tree=True),
    "tree, a row that sees no key, short rows": dict(
        b=4, tq=31, hq=8, hkv=2, d=32, s=512, ctx=[0, 1, 70, 400],
        tree=True, dead=(0,)),
    # S ends at row 0's window: its last window key is the row's last slot
    "tree window ends at S": dict(
        b=2, tq=31, hq=8, hkv=2, d=64, s=None, ctx=[700, 20], tree=True),
    "tree, window removes splits, softcap": dict(
        b=1, tq=23, hq=8, hkv=2, d=64, s=1600, ctx=[1500], tree=True,
        kw=dict(window=64, softcap=30.0)),
}


@pytest.mark.parametrize("name", list(CONTIG_CASES))
def test_contiguous_emulation_matches_plain_and_jax(name):
    spec = dict(CONTIG_CASES[name])
    kw = spec.pop("kw", {})
    case = _contig_case(len(name), **spec)
    b, s, hkv = case["k"].shape[:3]
    rows = spec["tq"] * spec["hq"] // hkv
    assert da.split_kv_plan(b, hkv, rows, s, SMS)[0] > 1, name
    if name == "kv_len > S":
        assert int(case["kv_len"].max()) > s and int(case["q_pos"].max()) >= s
    if name == "tree window ends at S":
        assert int(case["win_start"][0] + case["win_len"][0]) == s
    _check_against_plain_and_jax(name, case, kw)


@pytest.mark.parametrize("qname", QUANT)
@pytest.mark.parametrize("name", ["kv_len > S", "tree window ends at S",
                                  "tree, a row that sees no key, short rows"])
def test_quantized_contiguous_emulation(name, qname):
    spec = dict(CONTIG_CASES[name])
    kw = spec.pop("kw", {})
    case = _quantized(_contig_case(len(name), **spec), qname)
    _check_against_plain_and_jax(name, case, kw)


@pytest.mark.parametrize("kernel", ["decode_attention_paged",
                                    "decode_attention",
                                    "tree_attention_paged", "tree_attention"])
def test_wrappers_plan_with_their_reach(monkeypatch, kernel):
    """Each wrapper hands its kernel split_kv_plan(B, Hkv, Tq * G, reach,
    SMs): reach S for a contiguous cache, MBS * block for a pool. The
    launch and the card's SM count are stubbed, so no CUDA runs."""
    calls = []
    monkeypatch.setattr(da, "sm_count", lambda device: SMS)
    for mod in (da, ta):
        monkeypatch.setattr(mod, "on_card", lambda q: True)
        monkeypatch.setattr(mod, "launch",
                            lambda name, q, *args: calls.append((name, args)))
    tree = kernel.startswith("tree")
    # B 1, Hkv 2, 36 rows: the plan's cluster size follows the reach
    # (S 100: 2 chunks; MBS 3 x block 16 = 48: 1 chunk)
    b, tq, hq, hkv, d, s, bs, mbs = 1, 9, 8, 2, 32, 100, 16, 3
    bf = torch.bfloat16
    i32 = dict(dtype=torch.int32)
    q = torch.zeros(b, tq, hq, d, dtype=bf)
    ints = dict(kv_len=torch.full((b,), 40, **i32),
                q_pos=torch.arange(31, 40, **i32)[None])
    if tree:
        ints.update(win_start=torch.full((b,), 31, **i32),
                    anc=torch.ones(b, tq, dtype=torch.int64),
                    win_len=torch.full((b,), tq, **i32))
    if kernel.endswith("paged"):
        pool = torch.zeros(1 + mbs, bs, hkv, d, dtype=bf)
        tables = torch.arange(1, 1 + mbs, **i32)[None]
        fn = ta.tree_attention_paged if tree else da.decode_attention_paged
        fn(q, pool, pool, tables, **ints)
        reach = mbs * bs
    else:
        cache = torch.zeros(b, s, hkv, d, dtype=bf)
        fn = ta.tree_attention if tree else da.decode_attention
        fn(q, cache, cache, **ints)
        reach = s
    (name, args), = calls
    assert name == kernel
    plan = tuple(a.value for a in args[-2:])
    assert plan == da.split_kv_plan(b, hkv, tq * hq // hkv, reach, SMS)
    assert plan[0] == (2 if reach == s else 1)
