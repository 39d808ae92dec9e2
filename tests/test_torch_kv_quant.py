"""Quantized KV (int8 / fp8 e4m3) in the port against the JAX package, on
the CPU.

The port keeps its own copy of the JAX package's quantization
(``repro_torch.models.attention.quantize_kv`` / ``dequantize_kv``): codes
and scales are held bitwise against ``repro.models.attention`` on inputs
made from a numpy seed, zero vectors and extremes included. The four
serving kernels' plain versions take ``k_scale`` / ``v_scale`` and are
held against ``repro.kernels.ref`` at fp32 (tolerance 1e-5: both
dequantize to the same f32 values, then only the summation order of the
f32 softmax differs). Pools and caches carry the JAX package's scale
leaves and byte accounting; compaction moves scales with their codes.
Inside the port, exactness holds where it is promised: in fp32
activations greedy PARD == AR under int8 and fp8 (flat and tree) and
paged == contiguous under int8. Against the fp32 KV path each committed
token keeps the JAX package's quality floors (``tests/test_kv_quant.py``:
int8 0.80, fp8 0.50), and the port's int8 engine agrees with the JAX
Engine's as far as ``tests/test_torch_engine.py::test_matches_jax_engine``
asks of bf16. The card's 8-bit route of the tensor-core loop is emulated
in ``tests/test_torch_split_kv.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import spec_decode as jax_sd
from repro.kernels import ref as jax_ref
from repro.models import attention as jax_attn
from repro.models import init_caches as jax_init_caches
from repro.models import init_params as jax_init_params
from repro.serving import config as jax_config
from repro.serving import kv_pool as jax_kv_pool
from repro.serving.engine import Engine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.core import spec_decode as sd
from repro_torch.data.pipeline import MarkovCorpus
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import tree_attention as ta
from repro_torch.models import attention as attn
from repro_torch.models import forward, init_caches
from repro_torch.serving import kv_pool
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import Engine

QUANT = ["int8", "fp8"]
TOL = dict(atol=1e-5, rtol=1e-5)
MATCH_FLOOR = 0.5                           # as test_torch_engine.py
QUALITY_FLOOR = {"int8": 0.80, "fp8": 0.50}  # as tests/test_kv_quant.py
SMALL = dict(k=4, max_batch=2, max_len=256, kv_block_size=16)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(x):
    """Raw bytes of a numpy / jax / torch array (fp8 compared bit for bit)."""
    if isinstance(x, torch.Tensor):
        x = attn.as_bytes(x).numpy() if x.dtype == torch.float8_e4m3fn \
            else x.numpy()
        return np.ascontiguousarray(x).view(np.uint8)
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


# ------------------------------------------------------------ quantize
def _quant_inputs(seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((6, 5, 3, 32)).astype(np.float32)
    x[0] *= 1e-3
    x[1] *= 300.0
    x[2, 0] = 0.0                                   # all-zero vectors
    x[2, 1, 0] = [1e30 if i % 2 else -1e30 for i in range(32)]
    x[2, 1, 1] = np.float32(2.0) ** -100            # tiny but normal
    x[2, 2, 2, 5] = 65504.0                         # one outlier
    x[3, 0, 0, :] = 0.0
    x[3, 0, 0, 7] = -3.0                            # one nonzero value
    return x


@pytest.mark.parametrize("name", QUANT)
def test_quantize_matches_jax_bitwise(name):
    x = _quant_inputs(1)
    codes, scale = attn.quantize_kv(torch.from_numpy(x), name)
    jcodes, jscale = jax_attn.quantize_kv(
        jnp.asarray(x), jax_attn.resolve_kv_dtype(name))
    assert codes.dtype == attn.KV_DTYPES[name]
    np.testing.assert_array_equal(_bits(codes), _bits(jcodes))
    np.testing.assert_array_equal(_bits(scale), _bits(jscale))
    assert (scale > 0).all()
    assert (scale[2, 0] == 1.0).all() and not codes[2, 0].float().any()
    np.testing.assert_array_equal(
        _bits(attn.dequantize_kv(codes, scale)),
        _bits(jax_attn.dequantize_kv(jcodes, jscale)))


@pytest.mark.parametrize("name", QUANT)
def test_bf16_input_quantizes_as_in_jax(name):
    """The model quantizes K/V in its activation dtype; bf16 widens first."""
    x = _quant_inputs(2)
    xb = torch.from_numpy(x).bfloat16()
    codes, scale = attn.quantize_kv(xb, name)
    jcodes, jscale = jax_attn.quantize_kv(
        jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16),
        jax_attn.resolve_kv_dtype(name))
    np.testing.assert_array_equal(_bits(codes), _bits(jcodes))
    np.testing.assert_array_equal(_bits(scale), _bits(jscale))


@pytest.mark.parametrize("name", QUANT)
def test_subnormal_amax_stays_finite(name):
    """x = 1.1754944e-38: the scale amax / maxval is subnormal and x /
    scale passes the range. The port clamps before the cast (the reference
    casts fp8 to NaN there, ROADMAP §C) and reconstructs x."""
    x = torch.full((2, 16), 1.1754944e-38)
    x[1, ::2] *= -1
    codes, scale = attn.quantize_kv(x, name)
    back = attn.dequantize_kv(codes, scale)
    assert torch.isfinite(codes.float()).all() and torch.isfinite(back).all()
    assert codes.float().abs().max() == (127.0 if name == "int8" else 448.0)
    torch.testing.assert_close(back, x, atol=0, rtol=0.02)


def test_kv_dtype_registry_matches_jax():
    assert set(attn.KV_DTYPES) == set(jax_attn.KV_DTYPES)
    for name in attn.KV_DTYPES:
        assert attn.kv_dtype_is_quantized(name) == \
            jax_attn.kv_dtype_is_quantized(jax_attn.resolve_kv_dtype(name))
        assert str(attn.resolve_kv_dtype(name)).split(".")[1] == \
            jnp.dtype(jax_attn.resolve_kv_dtype(name)).name


# ------------------------------------------------- plain kernels with scales
def _quant_case(seed, name, b=3, tq=9, hq=4, hkv=2, d=32, bs=8, mbs=6):
    """Codes and scales of random K/V pools, their gathered rows, a causal
    window per row and a tree window (random valid templates)."""
    rng = np.random.default_rng(seed)
    nb = 1 + b * mbs
    kf = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32)
    vf = rng.standard_normal((nb, bs, hkv, d)).astype(np.float32) * 2.0
    kc, ks = attn.quantize_kv(torch.from_numpy(kf), name)
    vc, vs = attn.quantize_kv(torch.from_numpy(vf), name)
    tables = rng.permutation(np.arange(1, nb)).reshape(b, mbs).astype(np.int32)
    kv_len = np.array([bs * mbs - 3 - 5 * i for i in range(b)], np.int32)
    q_pos = (kv_len[:, None] - tq + np.arange(tq)[None]).astype(np.int32)
    depth = np.array([0, 1, 1, 2, 2, 3, 3, 4, 5][:tq])
    anc = np.array([1, 3, 5, 11, 21, 43, 85, 171, 427][:tq], np.int64)
    win_start = (kv_len - tq).astype(np.int32)
    win_len = np.array([tq, tq - 2, 5][:b], np.int32)
    return dict(
        q=rng.standard_normal((b, tq, hq, d)).astype(np.float32),
        kc=kc, vc=vc, ks=ks, vs=vs, tables=tables, kv_len=kv_len,
        q_pos=q_pos, win_start=win_start, win_len=win_len,
        tq_pos=(win_start[:, None] + depth[None]).astype(np.int32),
        anc=np.broadcast_to(anc, (b, tq)).copy())


def _jnp(t):
    """A torch tensor (fp8 through its bytes) as a jnp array."""
    if t.dtype == torch.float8_e4m3fn:
        return jnp.asarray(attn.as_bytes(t).numpy()).view(jnp.float8_e4m3fn)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("name", QUANT)
@pytest.mark.parametrize("kw", [{}, dict(window=13, softcap=20.0)])
def test_plain_kernels_with_scales_match_jax_ref(name, kw):
    c = _quant_case(3, name)
    t = {n: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for n, v in c.items()}
    j = {n: _jnp(v) if isinstance(v, torch.Tensor) else jnp.asarray(v)
         for n, v in t.items()}
    sc = dict(k_scale=t["ks"], v_scale=t["vs"])
    jsc = dict(k_scale=j["ks"], v_scale=j["vs"])
    got = da.decode_attention_paged(t["q"], t["kc"], t["vc"], t["tables"],
                                    t["kv_len"], t["q_pos"], **sc, **kw)
    want = jax_ref.decode_attention_paged_ref(
        j["q"], j["kc"], j["vc"], j["tables"], j["kv_len"], j["q_pos"],
        **jsc, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the contiguous kernel on the gathered rows and scales
    rows = {n: da.gather_pages(t[n], t["tables"])
            for n in ("kc", "vc", "ks", "vs")}
    got_c = da.decode_attention(t["q"], rows["kc"], rows["vc"], t["kv_len"],
                                t["q_pos"], k_scale=rows["ks"],
                                v_scale=rows["vs"], **kw)
    want_c = jax_ref.decode_attention_ref(
        j["q"], _jnp(rows["kc"]), _jnp(rows["vc"]), j["kv_len"], j["q_pos"],
        k_scale=_jnp(rows["ks"]), v_scale=_jnp(rows["vs"]), **kw)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **TOL)
    np.testing.assert_allclose(got_c.numpy(), got.numpy(), **TOL)
    tree = (t["tq_pos"], t["win_start"], t["anc"])
    jtree = (j["tq_pos"], j["win_start"], jnp.asarray(c["anc"], jnp.uint32))
    got_t = ta.tree_attention_paged(t["q"], t["kc"], t["vc"], t["tables"],
                                    t["kv_len"], *tree, win_len=t["win_len"],
                                    **sc, **kw)
    want_t = jax_ref.tree_attention_paged_ref(
        j["q"], j["kc"], j["vc"], j["tables"], j["kv_len"], *jtree,
        win_len=j["win_len"], **jsc, **kw)
    np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t), **TOL)
    got_tc = ta.tree_attention(t["q"], rows["kc"], rows["vc"], t["kv_len"],
                               *tree, win_len=t["win_len"],
                               k_scale=rows["ks"], v_scale=rows["vs"], **kw)
    want_tc = jax_ref.tree_attention_ref(
        j["q"], _jnp(rows["kc"]), _jnp(rows["vc"]), j["kv_len"], *jtree,
        win_len=j["win_len"], k_scale=_jnp(rows["ks"]),
        v_scale=_jnp(rows["vs"]), **kw)
    np.testing.assert_allclose(got_tc.numpy(), np.asarray(want_tc), **TOL)


@pytest.mark.parametrize("name", QUANT)
def test_garbage_block_is_invisible(name):
    """Block 0 (past every row's table) may hold anything: poisoned codes
    and scales change no output of either plain paged kernel."""
    c = _quant_case(4, name, mbs=8)
    t = {n: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
         for n, v in c.items()}
    t["tables"][:, -2:] = 0                          # past the rows: block 0
    t["kv_len"] = torch.minimum(t["kv_len"], torch.tensor(6 * 8))
    t["q_pos"] = t["kv_len"][:, None] - 9 + torch.arange(9)[None]
    outs = []
    for poison in (False, True):
        kc, vc, ks, vs = (t[n].clone() for n in ("kc", "vc", "ks", "vs"))
        if poison:
            attn.as_bytes(kc)[0] = 0x7E                  # 126 / 448 codes
            attn.as_bytes(vc)[0] = 0x7E
            ks[0], vs[0] = 1e4, 3e4
        outs.append(da.decode_attention_paged(
            t["q"], kc, vc, t["tables"], t["kv_len"], t["q_pos"],
            k_scale=ks, v_scale=vs))
    torch.testing.assert_close(outs[0], outs[1], atol=0, rtol=0)
    assert torch.isfinite(outs[1]).all()


# ------------------------------------------------------- pools and caches
def _shapes(tree):
    return jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype)), tree,
                        is_leaf=lambda x: isinstance(x, torch.Tensor))


@pytest.mark.parametrize("name", QUANT)
def test_pools_and_caches_carry_scale_leaves(name):
    cfg, jcfg = get_config("tiny-target"), jax_get_config("tiny-target")
    mine = kv_pool.init_paged_caches(cfg, 2, 9, 8, name, "cpu")
    theirs = jax_kv_pool.init_paged_caches(jcfg, 2, 9, 8, name)
    mine_c = init_caches(cfg, 2, 40, name, "cpu")
    theirs_c = jax_init_caches(jcfg, 2, 40, name)
    for m, t in ((mine, theirs), (mine_c, theirs_c)):
        assert jax.tree.map(lambda s: s[0], _shapes(m),
                            is_leaf=lambda x: isinstance(x, tuple)) == \
            jax.tree.map(lambda a: tuple(a.shape), t)
        for entry in m["scan"]:
            assert entry["k"].dtype == attn.KV_DTYPES[name]
            for n in ("k_scale", "v_scale"):
                assert entry[n].dtype == torch.float32
                assert (entry[n] == 1.0).all()
            assert not entry["k"].float().any()
    assert kv_pool.kv_capacity_bytes(mine) == \
        jax_kv_pool.kv_capacity_bytes(jcfg, theirs)
    assert kv_pool.kv_bytes_per_block(mine, 9) == \
        jax_kv_pool.kv_bytes_per_block(jcfg, theirs, 9)
    assert kv_pool.kv_capacity_bytes(mine_c) == \
        jax_kv_pool.kv_capacity_bytes(jcfg, theirs_c)


@pytest.mark.parametrize("name", QUANT)
@pytest.mark.parametrize("arch,d", [("llama3.1-8b", 128), ("tiny-target", 32)])
def test_quantized_pool_costs_d_plus_4_over_2d(name, arch, d):
    """A 1-byte code per value plus one f32 scale per (position, kv head),
    against 2 bytes per value in bf16: (D + 4) / 2D, 0.52 at D = 128."""
    cfg = get_config(arch)
    assert cfg.resolved_head_dim == d
    per = {n: kv_pool.kv_bytes_per_block(
        kv_pool.init_paged_caches(cfg, 1, 2, 1, n, "meta"), 2)
        for n in ("bf16", name)}
    assert per[name] / per["bf16"] == (d + 4) / (2 * d)
    mine = kv_pool.init_paged_caches(cfg, 1, 2, 1, name, "meta")
    assert kv_pool.kv_scale_bytes(mine) == \
        2 * 2 * cfg.n_kv_heads * 4 * cfg.num_layers


@pytest.mark.parametrize("name", QUANT)
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_compact_tree_caches_moves_scales(name, layout):
    """Compaction moves every leaf: codes and scales land as the JAX
    package's compaction puts them (codes bit for bit)."""
    rng = np.random.default_rng(8)
    cfg, jcfg = get_config("tiny-target"), jax_get_config("tiny-target")
    b, depth, max_len, bs = 3, 4, 48, 8
    n = np.array([10, 21, max_len - 2], np.int32)
    src_pos = (n - 1)[:, None] + np.stack(
        [rng.integers(1, 20, size=b) for _ in range(depth)], 1)
    src_pos[0] = n[0] - 1 + np.arange(1, depth + 1)       # identity row
    src_pos[2] = np.minimum(src_pos[2], max_len - 1)
    if layout == "paged":
        tables = rng.permutation(np.arange(1, 1 + b * 6)).reshape(b, 6)
        tables = tables.astype(np.int32)
        port = kv_pool.init_paged_caches(cfg, b, 1 + b * 6, bs, name, "cpu")
    else:
        tables = None
        port = init_caches(cfg, b, max_len, name, "cpu")
    for entry in port["scan"]:
        for leaf in ("k", "v"):
            x = torch.from_numpy(rng.standard_normal(
                tuple(entry[leaf].shape)).astype(np.float32))
            codes, scale = attn.quantize_kv(x, name)
            entry[leaf].copy_(codes)
            entry[leaf + "_scale"].copy_(scale)
    jtree = {"prefix": [], "scan": [{k: _jnp(v) for k, v in e.items()}
                                    for e in port["scan"]]}
    want = jax_sd.compact_tree_caches(
        jcfg, jtree, jnp.asarray(src_pos), jnp.asarray(n), depth,
        None if tables is None else jnp.asarray(tables), bs)
    sd.compact_tree_caches(
        cfg, port, torch.from_numpy(src_pos), torch.from_numpy(n).long(),
        depth, None if tables is None else torch.from_numpy(tables), bs)
    moved = 0
    for e_pt, e_jx in zip(port["scan"], want["scan"]):
        assert set(e_pt) == set(e_jx) == set(kv_pool.KV_LEAVES)
        for k in e_pt:
            got, exp = _bits(e_pt[k]), _bits(e_jx[k])
            if tables is not None:          # garbage block: unordered writes
                got, exp = got[:, 1:], exp[:, 1:]
            np.testing.assert_array_equal(got, exp)
            moved += k.endswith("scale")
    assert moved == 2


# ------------------------------------------------------------------ engine
@pytest.fixture(scope="module")
def jax_models():
    tc, dc = jax_get_config("tiny-target"), jax_get_config("tiny-draft")
    return (tc, jax_init_params(jax.random.PRNGKey(0), tc),
            dc, jax_init_params(jax.random.PRNGKey(1), dc))


def _port_models(jax_models, dtype):
    _, tp, _, dp = jax_models
    tc, dc = get_config("tiny-target"), get_config("tiny-draft")
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return (tc, params_from_numpy(to_np(tp), tc, "cpu", dtype),
            dc, params_from_numpy(to_np(dp), dc, "cpu", dtype))


@pytest.fixture(scope="module")
def fp32_models(jax_models):
    return _port_models(jax_models, torch.float32)


def _markov_prompts(n=4, length=16):
    """The workload of tests/test_kv_quant.py: Markov prompts, seed 0."""
    corpus = MarkovCorpus(vocab_size=512, seed=0, determinism=2.0)
    rng = np.random.default_rng(0)
    return [corpus.prompts(rng, 1, length)[0] for _ in range(n)]


def _serve(models, prompts, max_new=12, **cfg):
    tc, tp, dc, dp = models
    eng = Engine(tp, tc, dp, dc, config=EngineConfig(**cfg), device="cpu")
    rids = {eng.submit(p, max_new): i for i, p in enumerate(prompts)}
    return {rids[c.rid]: c.tokens for c in eng.run()}


@pytest.fixture(scope="module")
def quant_runs(fp32_models):
    """fp32-activation engines on the Markov workload, by (kv dtype, run)."""
    prompts = _markov_prompts()
    runs = {"ar": dict(mode="ar"), "pard": {},
            "tree": dict(tree=(2, 2, 1)),
            "pard contiguous": dict(kv_layout="contiguous")}
    out = {}
    for name in QUANT:
        for run, kw in runs.items():
            if run == "pard contiguous" and name != "int8":
                continue
            out[name, run] = _serve(fp32_models, prompts, max_new=24,
                                    kv_dtype=name, **dict(SMALL, **kw))
    out["fp32", "ar"] = _serve(fp32_models, prompts, max_new=24,
                               kv_dtype="fp32", **dict(SMALL, mode="ar"))
    return out


@pytest.mark.parametrize("name", QUANT)
@pytest.mark.parametrize("run", ["pard", "tree"])
def test_spec_equals_ar_under_quantized_kv(quant_runs, name, run):
    """Greedy losslessness inside a kv dtype: the verifier reads the cache
    the AR engine builds (quantization is per append, compaction moves
    codes and scales unchanged)."""
    got, ar = quant_runs[name, run], quant_runs[name, "ar"]
    assert got.keys() == ar.keys()
    for i in got:
        np.testing.assert_array_equal(got[i], ar[i])


def test_int8_paged_equals_contiguous(quant_runs):
    got, want = quant_runs["int8", "pard contiguous"], \
        quant_runs["int8", "pard"]
    for i in want:
        np.testing.assert_array_equal(got[i], want[i])


def _teacher_forced_argmax(models, seqs, kv_dtype, window=9, bs=16):
    """The target's greedy token at every position of ``seqs`` [B, L],
    fed through paged pools of ``kv_dtype`` in windows of ``window`` (the
    verify width at K = 8), so each window reads the quantized KV that the
    earlier windows appended."""
    tc, tp = models[:2]
    b, n = seqs.shape
    mbs = -(-n // bs)
    caches = kv_pool.init_paged_caches(tc, b, 1 + b * mbs, bs, kv_dtype,
                                       "cpu")
    tables = torch.arange(1, 1 + b * mbs, dtype=torch.int32).reshape(b, mbs)
    out = []
    for s0 in range(0, n - 1, window):
        w = seqs[:, s0:min(s0 + window, n - 1)]
        logits, _ = forward(tp, tc, w, caches=caches,
                            cache_pos=torch.full((b,), s0), block_tables=tables,
                            kv_block_size=bs, dtype=torch.float32)
        out.append(logits.float().argmax(-1))
    return torch.cat(out, 1)


@pytest.mark.parametrize("name", QUANT)
def test_committed_token_quality_floor(fp32_models, quant_runs, name):
    """Greedy agreement with the fp32 KV path above the JAX package's
    floors, per committed token: the target reads back the quantized KV
    of the fp32 AR continuations of the Markov prompts and picks its next
    token at each of the 24 generated positions, as the fp32 path does
    (one flip no longer decides the rest of a request: on this workload
    the whole-trajectory count of tests/test_kv_quant.py gives the JAX
    Engine itself 0.825 for int8 against its 0.80 floor)."""
    ar = quant_runs["fp32", "ar"]
    seqs = torch.from_numpy(np.stack([ar[i] for i in sorted(ar)])).long()
    gen = slice(seqs.shape[1] - 25, None)           # predicts tokens 16..39
    want = _teacher_forced_argmax(fp32_models, seqs, "fp32")
    got = _teacher_forced_argmax(fp32_models, seqs, name)
    assert torch.equal(want[:, gen], seqs[:, gen.start + 1:])  # AR greedy
    agree = (got[:, gen] == want[:, gen]).float().mean().item()
    assert agree >= QUALITY_FLOOR[name], (name, agree)


def test_int8_engine_matches_jax_engine(jax_models):
    """The port's bf16 engine with int8 KV against the JAX Engine at
    kv_dtype="int8" (bf16 activations on both; oneDNN and XLA round bf16
    products apart, so a share up to the first divergence, as in
    test_torch_engine.py)."""
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 512, size=int(k)).astype(np.int32)
               for k in rng.integers(4, 30, size=6)]
    jtc, jtp, jdc, jdp = jax_models
    jeng = JaxEngine(jtp, jtc, jdp, jdc, config=jax_config.EngineConfig(
        mode="pard", kv_dtype="int8", **SMALL))
    rids = {jeng.submit(p, 12): i for i, p in enumerate(prompts)}
    want = {rids[c.rid]: c.tokens for c in jeng.run()}
    got = _serve(_port_models(jax_models, torch.bfloat16), prompts,
                 kv_dtype="int8", **SMALL)
    shares = []
    for i, p in enumerate(prompts):
        np.testing.assert_array_equal(got[i][:len(p)], p)
        a, b = got[i][len(p):], want[i][len(p):]
        diff = np.nonzero(a != b)[0]
        shares.append((diff[0] if diff.size else len(a)) / len(a))
    assert np.mean(shares) >= MATCH_FLOOR, shares
