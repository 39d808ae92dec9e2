"""The port's paged decode attention against the JAX package.

On the CPU the port's ``decode_attention_paged`` takes its plain PyTorch
version. It is held against the JAX oracle ``ref.decode_attention_paged_ref``
and against the Pallas kernel ``ops.decode_attention_paged`` run in
interpret mode, on the same numpy inputs. Tolerance 1e-5 (atol and rtol)
in float32: both sides compute a float32 softmax, only the summation order
differs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro.models.attention import gather_pages as jax_gather_pages
from repro_torch import kernels
from repro_torch.kernels import decode_attention as da

TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(seed, b, tq, hq, hkv, d, bs, mbs, kv_len=None):
    rng = np.random.default_rng(seed)
    nb = 1 + b * mbs
    arrs = dict(
        q=rng.standard_normal((b, tq, hq, d)).astype(np.float32),
        k=rng.standard_normal((nb, bs, hkv, d)).astype(np.float32),
        v=rng.standard_normal((nb, bs, hkv, d)).astype(np.float32),
        tables=rng.permutation(np.arange(1, nb)).reshape(b, mbs)
        .astype(np.int32))
    if kv_len is None:
        kv_len = [bs * mbs // 2 + 3 * i + tq for i in range(b)]
    kv_len = np.asarray(kv_len, np.int32)
    arrs["kv_len"] = kv_len
    arrs["q_pos"] = np.maximum(kv_len[:, None] - tq + np.arange(tq)[None, :],
                               0).astype(np.int32)
    return arrs


def _args(arrs, lib):
    names = ("q", "k", "v", "tables", "kv_len", "q_pos")
    if lib == "torch":
        return [torch.from_numpy(arrs[n]) for n in names]
    return [jnp.asarray(arrs[n]) for n in names]


def port(arrs, **kw):
    return da.decode_attention_paged(*_args(arrs, "torch"), **kw).numpy()


def jax_ref(arrs, **kw):
    return np.asarray(ref.decode_attention_paged_ref(*_args(arrs, "jax"),
                                                     **kw))


def jax_kernel(arrs, **kw):
    return np.asarray(ops.decode_attention_paged(*_args(arrs, "jax"),
                                                 interpret=True, **kw))


@pytest.mark.parametrize("b,tq,hq,hkv,d,bs,mbs", [
    (2, 9, 4, 2, 64, 32, 4),     # PARD verify window (K+1 = 9)
    (3, 1, 4, 4, 32, 16, 5),     # plain AR decode
    (1, 8, 8, 2, 32, 64, 3),     # chunk window
    (2, 16, 8, 2, 64, 16, 6),    # 2K = 16 draft window
    (2, 4, 14, 2, 64, 8, 5),     # G = 7 (qwen2.5 grouping)
])
def test_plain_matches_jax(b, tq, hq, hkv, d, bs, mbs):
    arrs = _setup(0, b, tq, hq, hkv, d, bs, mbs)
    got = port(arrs)
    np.testing.assert_allclose(got, jax_ref(arrs), **TOL)
    np.testing.assert_allclose(got, jax_kernel(arrs), **TOL)


@pytest.mark.parametrize("window,softcap", [(24, 0.0), (0, 30.0), (24, 30.0)])
def test_window_softcap(window, softcap):
    arrs = _setup(1, 2, 3, 4, 4, 32, 16, 6, kv_len=[77, 60])
    got = port(arrs, window=window, softcap=softcap)
    np.testing.assert_allclose(
        got, jax_ref(arrs, window=window, softcap=softcap), **TOL)
    np.testing.assert_allclose(
        got, jax_kernel(arrs, window=window, softcap=softcap), **TOL)


def test_garbage_block_is_never_attended():
    """Entries past each row's fill point at block 0; poisoning it leaves
    the output unchanged."""
    arrs = _setup(2, 2, 2, 2, 2, 16, 8, 4, kv_len=[14, 25])
    arrs["tables"][0, 2:] = 0
    arrs["tables"][1, 4:] = 0
    clean = port(arrs)
    arrs["k"][0], arrs["v"][0] = 1e4, -1e4
    np.testing.assert_array_equal(port(arrs), clean)
    np.testing.assert_allclose(clean, jax_kernel(arrs), **TOL)


def test_ragged_kv_len_and_empty_rows():
    """kv_len from 0 to the full table. A query that sees no key returns 0,
    as the kernel does; the jnp oracle returns garbage there, so it is
    compared only on rows that see a key."""
    arrs = _setup(3, 4, 5, 4, 2, 32, 8, 5, kv_len=[0, 1, 17, 40])
    got = port(arrs)
    np.testing.assert_allclose(got, jax_kernel(arrs), **TOL)
    assert not got[0].any()
    np.testing.assert_allclose(got[1:], jax_ref(arrs)[1:], **TOL)


def test_bf16_inputs():
    """bf16 q and pools: both compute in f32 and round the output to bf16
    (one bf16 ulp apart at most: atol 1e-2 at |out| <= 1)."""
    arrs = _setup(4, 2, 9, 4, 2, 64, 16, 4)
    t = [x.to(torch.bfloat16) if x.is_floating_point() else x
         for x in _args(arrs, "torch")]
    j = [x.astype(jnp.bfloat16) if jnp.issubdtype(x.dtype, jnp.floating)
         else x for x in _args(arrs, "jax")]
    got = da.decode_attention_paged(*t)
    assert got.dtype == torch.bfloat16
    want = ops.decode_attention_paged(*j, interpret=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=1e-2,
                               rtol=1e-2)


def test_gather_pages_matches_jax():
    arrs = _setup(5, 2, 1, 2, 2, 32, 8, 3)
    got = da.gather_pages(torch.from_numpy(arrs["k"]),
                          torch.from_numpy(arrs["tables"]))
    want = jax_gather_pages(jnp.asarray(arrs["k"]), jnp.asarray(arrs["tables"]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_cpu_call_counts_no_launch():
    kernels.launches.clear()
    port(_setup(6, 2, 9, 4, 2, 64, 32, 4))
    assert kernels.launches["decode_attention_paged"] == 0


def test_build_needs_nvcc(monkeypatch, tmp_path):
    """Without a CUDA toolkit the build raises; it never falls back."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(["decode_attention_paged"])
    name = build.library_path("decode_attention_paged").name
    assert name.startswith("libdecode_attention_paged-") and name.endswith(".so")
