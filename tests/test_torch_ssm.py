"""The port's Mamba2 slice on the CPU against the JAX package: the SSD
scans (plain versions and the ``ssd_chunked`` wrapper's CPU route), the
state gather, ``mamba2_apply``, whole-model forwards of ``tiny-ssm`` and of
a dense hybrid, the SSM leaves of params and caches.

Inputs come from numpy with fixed seeds. Tolerances: the scans to 2e-4
absolute, as the JAX package's own kernel test holds its Pallas kernel
(interpret mode) to its oracle; Mamba2 blocks and fp32 forwards to 1e-4
(f32 sums taken in another order).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import spec_decode as jax_sd
from repro.kernels import ops as jax_ops
from repro.models import forward as jax_forward
from repro.models import init_caches as jax_init_caches
from repro.models import init_params as jax_init_params
from repro.models import ssm as jax_ssm
from repro.models.config import ModelConfig as JaxModelConfig
from repro.serving import executor as jax_executor
from repro.serving import kv_pool as jax_kv_pool
from repro_torch.configs import get_config
from repro_torch.core.spec_decode import gather_ssm_states
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.kernels import ssd
from repro_torch.models import forward, init_caches, init_params
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig
from repro_torch.serving import kv_pool
from repro_torch.serving.executor import zero_ssm_rows

SCAN_TOL = dict(atol=2e-4, rtol=0)
TOL = dict(atol=1e-4, rtol=1e-4)

# a dense hybrid: attention every second layer, dense MLPs everywhere
HYBRID = dict(name="hybrid-test", arch_type="hybrid", num_layers=4,
              attn_every=2, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
              d_ff=128, vocab_size=512, ssm_state=16, ssm_headdim=32,
              ssm_chunk=8, tie_embeddings=True, max_seq_len=1024,
              source="test")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def configs(name):
    """(port config, JAX config) of ``name``: a registered config or the
    hybrid built here from the same fields in both packages."""
    if name == "hybrid":
        return ModelConfig(**HYBRID), JaxModelConfig(**HYBRID)
    return get_config(name), jax_get_config(name)


def jax_and_port_params(name, seed=0):
    cfg, jcfg = configs(name)
    jp = jax_init_params(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu",
                           torch.float32)
    return cfg, jcfg, tp, jp


def scan_inputs(b, t, h, p, n, seed, init=True):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x, B, C = f(b, t, h, p), f(b, t, n), f(b, t, n)
    dt = np.log1p(np.exp(f(b, t, h)))                         # softplus
    A = -np.exp(f(h) * 0.5)
    s0 = f(b, h, p, n) * 0.1 if init else None
    return x, dt, A, B, C, s0


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


# ------------------------------------------------------------------ scans

@pytest.mark.parametrize("b,t,h,p,n,chunk,init", [
    (1, 32, 2, 8, 4, 8, True),
    (2, 64, 3, 16, 8, 16, True),
    (1, 50, 2, 8, 8, 16, True),         # t off the chunk
    (2, 9, 2, 32, 16, 64, False),       # one clamped chunk, zero state
    (2, 16, 2, 32, 16, 8, True),
])
def test_ssd_scans_match_jax(b, t, h, p, n, chunk, init):
    ins = scan_inputs(b, t, h, p, n, seed=t + chunk, init=init)
    jy, js = jax_ops.ssd_chunked(*map(_j, ins), chunk=chunk)  # interpret
    cy, cs = jax_ssm.ssd_scan_chunked(*map(_j, ins), chunk=chunk)
    ry, rs = jax_ssm.ssd_scan_ref(*map(_j, ins))
    port = {"ssd_chunked": ssd.ssd_chunked(*map(_t, ins), chunk=chunk),
            "ssd_chunked_ref": ssd.ssd_chunked_ref(
                *map(_t, ins), chunk=ssd.clamp_chunk(chunk, t)),
            "ssd_ref": ssd.ssd_ref(*map(_t, ins))}
    for name, (y, s) in port.items():
        for wy, ws in ((jy, js), (cy, cs), (ry, rs)):
            np.testing.assert_allclose(y.numpy(), np.asarray(wy), **SCAN_TOL,
                                       err_msg=name)
            np.testing.assert_allclose(s.numpy(), np.asarray(ws), **SCAN_TOL,
                                       err_msg=name)


def test_ssd_ref_collects_jax_states():
    ins = scan_inputs(2, 11, 2, 8, 4, seed=3)
    jy, jst = jax_ssm.ssd_scan_ref(*map(_j, ins), collect_states=True)
    y, st = ssd.ssd_ref(*map(_t, ins), collect_states=True)
    assert st.shape == (2, 11, 2, 8, 4)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), **SCAN_TOL)


@pytest.mark.parametrize("t,chunk", [(9, 16), (16, 8), (23, 8)])
def test_masked_dt_scan_is_the_state_after_idx(t, chunk):
    """dt = 0 past idx[b] gives the state after idx[b] + 1 tokens: the JAX
    per-token states at idx (what its gather_ssm_states picks)."""
    x, dt, A, B, C, s0 = scan_inputs(3, t, 2, 8, 4, seed=t)
    idx = np.random.default_rng(t).integers(0, t, 3)
    _, jst = jax_ssm.ssd_scan_ref(*map(_j, (x, dt, A, B, C, s0)),
                                  collect_states=True)
    keep = (np.arange(t)[None] <= idx[:, None])[..., None]
    _, s = ssd.ssd_chunked(*map(_t, (x, dt * keep, A, B, C, s0)), chunk=chunk)
    np.testing.assert_allclose(s.numpy(), np.asarray(jst)[np.arange(3), idx],
                               **SCAN_TOL)
    # a fully masked tail leaves the state bit for bit as it was
    _, s_all = ssd.ssd_chunked(*map(_t, (x, dt * 0, A, B, C, s0)),
                               chunk=chunk)
    assert torch.equal(s_all, torch.from_numpy(s0))


def test_chunk_clamp_matches_the_tpu_wrapper():
    assert [ssd.clamp_chunk(64, t) for t in (1, 5, 9, 16, 17, 2048)] == \
        [8, 8, 16, 16, 32, 64]
    assert ssd.clamp_chunk(16, 2048) == 16


# ------------------------------------------------------------ Mamba2 block

def _block(seed=0):
    cfg, jcfg, tp, jp = jax_and_port_params("tiny-ssm", seed)
    return cfg, jcfg, tp["scan"][0]["mixer"], jp["scan"][0]["mixer"]


def _layer(tree, r=0):
    return jax.tree.map(lambda a: a[r], tree)


def test_mamba2_apply_without_state_matches_jax():
    cfg, jcfg, tp, jp = _block()
    x = np.random.default_rng(0).standard_normal((2, 19, 64)).astype(np.float32)
    want, _ = jax_ssm.mamba2_apply(_layer(jp), jcfg, jnp.asarray(x))
    got, rec = ssm.mamba2_apply({k: v[0] for k, v in tp.items()}, cfg,
                                torch.from_numpy(x))
    assert rec is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _state(rng, cfg, b):
    conv = rng.standard_normal((b, cfg.ssm_conv - 1,
                                cfg.ssm_inner + 2 * cfg.ssm_state))
    s = rng.standard_normal((b, cfg.ssm_nheads, cfg.ssm_headdim,
                             cfg.ssm_state)) * 0.1
    return {"conv": conv.astype(np.float32), "ssm": s.astype(np.float32)}


def test_mamba2_apply_with_state_matches_jax():
    cfg, jcfg, tp, jp = _block()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, 64)).astype(np.float32)
    st = _state(rng, cfg, 2)
    want, jst = jax_ssm.mamba2_apply(_layer(jp), jcfg, jnp.asarray(x),
                                     state=jax.tree.map(jnp.asarray, st))
    port_state = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    got, rec = ssm.mamba2_apply({k: v[0] for k, v in tp.items()}, cfg,
                                torch.from_numpy(x), state=port_state)
    assert rec is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("conv", "ssm"):                   # updated in place
        np.testing.assert_allclose(port_state[k].numpy(), np.asarray(jst[k]),
                                   **TOL)


def test_mamba2_collect_then_gather_matches_jax():
    """A collect window leaves the state; gathering at idx gives the JAX
    per-token state (conv window and SSM state) at idx."""
    cfg, jcfg, tp, jp = _block()
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 9, 64)).astype(np.float32)
    st = _state(rng, cfg, 3)
    idx = np.array([0, 4, 8])
    want, jst = jax_ssm.mamba2_apply(_layer(jp), jcfg, jnp.asarray(x),
                                     state=jax.tree.map(jnp.asarray, st),
                                     collect_states=True)
    port_state = {k: torch.from_numpy(v.copy()) for k, v in st.items()}
    got, rec = ssm.mamba2_apply({k: v[0] for k, v in tp.items()}, cfg,
                                torch.from_numpy(x), state=port_state,
                                collect_states=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for k in ("conv", "ssm"):                   # untouched by the forward
        assert np.array_equal(port_state[k].numpy(), st[k])
    ssm.gather_state(rec, torch.from_numpy(idx))
    for k in ("conv", "ssm"):
        np.testing.assert_allclose(port_state[k].numpy(),
                                   np.asarray(jst[k])[np.arange(3), idx],
                                   **TOL)


# ----------------------------------------------------------- whole models

@pytest.mark.parametrize("name", ["tiny-ssm", "hybrid"])
def test_cache_free_forward_matches_jax(name):
    cfg, jcfg, tp, jp = jax_and_port_params(name)
    toks = np.random.default_rng(3).integers(0, 512, (2, 21)).astype(np.int32)
    want, _, _ = jax_forward(jp, jcfg, jnp.asarray(toks), dtype=jnp.float32)
    got, caches = forward(tp, cfg, torch.from_numpy(toks).long(),
                          dtype=torch.float32)
    assert caches is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _jax_caches(jcfg, layout, b):
    if layout == "paged":
        return jax_kv_pool.init_paged_caches(jcfg, b, num_blocks=9,
                                             block_size=8, dtype=jnp.float32)
    return jax_init_caches(jcfg, b, 64, dtype=jnp.float32)


def _port_caches(cfg, layout, b):
    if layout == "paged":
        return kv_pool.init_paged_caches(cfg, b, 9, 8, torch.float32, "cpu")
    return init_caches(cfg, b, 64, torch.float32, "cpu")


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("name", ["tiny-ssm", "hybrid"])
def test_cached_windows_then_gather_match_jax(name, layout):
    """A prompt window, then a collect window gathered at random per-row
    indices, then one more window: logits, SSM states and conv windows
    against the JAX package (its forward with ``collect_ssm`` and its
    ``gather_ssm_states``)."""
    cfg, jcfg, tp, jp = jax_and_port_params(name)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, 512, (2, 30)).astype(np.int32)
    tables = np.array([[1, 3, 5, 7], [2, 4, 6, 8]], np.int32)
    paged = layout == "paged"
    jkw = dict(dtype=jnp.float32)
    tkw = dict(dtype=torch.float32)
    if paged:
        jkw.update(block_tables=jnp.asarray(tables), kv_block_size=8)
        tkw.update(block_tables=torch.from_numpy(tables), kv_block_size=8)
    jc, tc = _jax_caches(jcfg, layout, 2), _port_caches(cfg, layout, 2)
    idx = rng.integers(0, 9, 2)                # each row's last kept slot
    # (tokens, cache_pos, collect): row b resumes after its kept slot
    windows = [(toks[:, :12], np.zeros(2, np.int64), False),
               (toks[:, 12:21], np.full(2, 12), True),
               (toks[:, 21:26], 12 + idx + 1, False)]
    for w, pos, collect in windows:
        jl, jc, _ = jax_forward(jp, jcfg, jnp.asarray(w), caches=jc,
                                cache_pos=jnp.asarray(pos, jnp.int32),
                                collect_ssm=collect, **jkw)
        records = [] if collect else None
        tl, tc = forward(tp, cfg, torch.from_numpy(w).long(), caches=tc,
                         cache_pos=torch.from_numpy(pos),
                         collect_ssm=records, **tkw)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        if collect:
            jc = jax_sd.gather_ssm_states(jcfg, jc, jnp.asarray(idx))
            gather_ssm_states(records, torch.from_numpy(idx))
    for entry, jentry in zip(tc["scan"], jc["scan"]):
        for k in ("conv", "ssm"):
            if k in entry:
                np.testing.assert_allclose(entry[k].numpy(),
                                           np.asarray(jentry[k]), **TOL)


@pytest.mark.parametrize("name", ["tiny-ssm", "hybrid", "mamba2-130m-smoke"])
def test_params_round_trip(name):
    cfg, jcfg, tp, jp = jax_and_port_params(name)
    back = params_to_numpy(tp)
    flat_j = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, jp))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_j) == len(flat_b)
    for path, leaf in flat_j:
        np.testing.assert_array_equal(flat_b[path], leaf)
    bf = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu",
                           torch.bfloat16)
    mixer = bf["scan"][0]["mixer"]
    for name_ in ("conv_w", "conv_b", "A_log", "D", "dt_bias", "ssm_norm"):
        assert mixer[name_].dtype == torch.float32, name_
    assert mixer["in_proj"].dtype == mixer["out_proj"].dtype == torch.bfloat16


@pytest.mark.parametrize("name", ["tiny-ssm", "hybrid"])
def test_init_params_follow_the_jax_init(name):
    """Leaf shapes equal the JAX package's; the Mamba2 leaves are drawn as
    its init_mamba2 draws them (A_log = log(linspace(1, 16, H)), D ones,
    conv_w normal x 0.1, zero biases); no norm2 / mlp on SSM-only layers."""
    cfg, jcfg, _, jp = jax_and_port_params(name)
    tp = init_params(cfg, 0, "cpu", torch.float32)
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    got = jax.tree.map(lambda a: tuple(a.shape), params_to_numpy(tp))
    assert got == shapes
    mixer = tp["scan"][0]["mixer"]
    h = cfg.ssm_nheads
    np.testing.assert_allclose(mixer["A_log"].numpy(),
                               np.log(np.linspace(1, 16, h))[None].repeat(
                                   mixer["A_log"].shape[0], 0), rtol=1e-6)
    assert (mixer["D"] == 1).all() and (mixer["dt_bias"] == 0).all()
    assert (mixer["conv_b"] == 0).all()
    assert 0.05 < float(mixer["conv_w"].std()) < 0.2
    if name == "tiny-ssm":
        assert set(tp["scan"][0]) == {"norm1", "mixer"}


# ----------------------------------------------------- caches and the pool

@pytest.mark.parametrize("name", ["tiny-ssm", "hybrid"])
def test_paged_caches_match_jax(name):
    cfg, jcfg = configs(name)
    mine = kv_pool.init_paged_caches(cfg, 3, 9, 8, torch.bfloat16, "cpu")
    theirs = jax_kv_pool.init_paged_caches(jcfg, 3, 9, 8, jnp.bfloat16)
    shapes = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), theirs)
    got = jax.tree.map(lambda a: (tuple(a.shape),
                                  str(a.dtype).replace("torch.", "")), mine)
    assert got == shapes
    assert kv_pool.kv_capacity_bytes(mine) == \
        jax_kv_pool.kv_capacity_bytes(jcfg, theirs)
    assert kv_pool.kv_bytes_per_block(mine, 9) == \
        jax_kv_pool.kv_bytes_per_block(jcfg, theirs, 9)
    if name == "tiny-ssm":
        assert kv_pool.kv_capacity_bytes(mine) == 0


@pytest.mark.parametrize("name", ["tiny-ssm", "hybrid"])
def test_zero_ssm_rows_matches_jax(name):
    cfg, jcfg = configs(name)
    caches = init_caches(cfg, 3, 16, torch.float32, "cpu")
    rng = np.random.default_rng(5)
    for entry in caches["prefix"] + caches["scan"]:
        for leaf in entry.values():
            leaf.copy_(torch.from_numpy(rng.standard_normal(leaf.shape)))
    jc = jax.tree.map(lambda a: jnp.asarray(a.numpy()), caches)
    zero_ssm_rows(cfg, caches, 1)
    want = jax_executor._zero_ssm_rows(jcfg, jc, 1)
    got = jax.tree.map(lambda a: a.numpy(), caches)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_outside_the_slice_still_raises():
    moe = ModelConfig(name="m", arch_type="moe", num_layers=1, d_model=32,
                      n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=64,
                      moe_num_experts=4, moe_top_k=2)
    for fn in (functools.partial(init_params, moe, 0, "cpu"),
               functools.partial(kv_pool.init_paged_caches, moe, 2, 3, 8,
                                 device="cpu"),
               functools.partial(init_caches, moe, 2, 8, device="cpu")):
        with pytest.raises(NotImplementedError):
            fn()
    with pytest.raises(ValueError):            # collect needs caches
        cfg = get_config("tiny-ssm")
        forward(init_params(cfg, 0, "cpu", torch.float32), cfg,
                torch.zeros(1, 4, dtype=torch.long), collect_ssm=[])
