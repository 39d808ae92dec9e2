"""On-card tests of the PyTorch port's CUDA kernel and serving path.

They need a CUDA card and skip without one. This file imports only torch
and the port, so it runs where JAX is not installed:

  PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as da
from repro_torch.models import forward, init_params
from repro_torch.serving import kv_pool
from repro_torch.serving.engine import Engine, EngineConfig

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(dev, b, tq, hq, hkv, d, bs, kv_len, kv_dtype, q_dtype, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    mbs = max(-(-n // bs) for n in kv_len)
    nb = 1 + b * mbs
    k = torch.randn(nb, bs, hkv, d, generator=g)
    v = torch.randn(nb, bs, hkv, d, generator=g)
    k[0], v[0] = 1e4, -1e4                         # garbage block poison
    tables = (torch.randperm(nb - 1, generator=g) + 1).reshape(b, mbs)
    for r, n in enumerate(kv_len):
        tables[r, -(-n // bs):] = 0
    kl = torch.tensor(kv_len)
    q_pos = (kl[:, None] - tq + torch.arange(tq)[None]).clamp(min=0)
    q = torch.randn(b, tq, hq, d, generator=g)
    return dict(q=q.to(dev, q_dtype), k_pages=k.to(dev, kv_dtype),
                v_pages=v.to(dev, kv_dtype),
                block_tables=tables.to(dev, torch.int32),
                kv_len=kl.to(dev, torch.int32), q_pos=q_pos.to(dev, torch.int32))


@pytest.mark.parametrize("tq,hq,hkv,d,bs,kv_len", [
    (9, 32, 8, 128, 64, [1, 70, 500, 1024]),       # target verify window
    (16, 32, 8, 64, 64, [16, 200, 640, 1000]),     # draft window
    (1, 4, 4, 64, 16, [1, 7, 80, 33]),             # AR decode
    (32, 14, 2, 64, 8, [40, 64, 3, 100]),          # G = 7, Tq*G > 64 rows
    (5, 4, 2, 32, 8, [6, 20, 13, 31]),             # tiny test models
])
@pytest.mark.parametrize("kv_dtype,q_dtype,tol", [
    (torch.float32, torch.float32, 1e-4),
    (torch.bfloat16, torch.bfloat16, 2e-2),
    (torch.float32, torch.bfloat16, 2e-2),
])
def test_kernel_matches_plain(cuda, tq, hq, hkv, d, bs, kv_len, kv_dtype,
                              q_dtype, tol):
    case = _case(cuda, 4, tq, hq, hkv, d, bs, kv_len, kv_dtype, q_dtype)
    before = kernels.launches["decode_attention_paged"]
    out = da.decode_attention_paged(**case)
    torch.cuda.synchronize()
    assert kernels.launches["decode_attention_paged"] == before + 1
    want = da.decode_attention_paged_ref(**case)
    assert out.dtype == q_dtype and out.shape == case["q"].shape
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("window,softcap", [(24, 0.0), (0, 30.0), (50, 20.0)])
def test_kernel_window_softcap(cuda, window, softcap):
    case = _case(cuda, 4, 9, 32, 8, 128, 64, [100, 300, 9, 64],
                 torch.float32, torch.float32)
    out = da.decode_attention_paged(**case, window=window, softcap=softcap)
    want = da.decode_attention_paged_ref(**case, window=window,
                                         softcap=softcap)
    torch.testing.assert_close(out, want, atol=1e-4, rtol=1e-4)


def test_kernel_rejects_what_it_does_not_take(cuda):
    case = _case(cuda, 2, 3, 4, 2, 64, 16, [20, 30], torch.float32,
                 torch.float32)
    with pytest.raises(ValueError):                 # head dim not built
        da.decode_attention_paged(case["q"][..., :48].contiguous(),
                                  case["k_pages"][..., :48].contiguous(),
                                  case["v_pages"][..., :48].contiguous(),
                                  case["block_tables"], case["kv_len"],
                                  case["q_pos"])
    with pytest.raises(TypeError):                  # int64 tables
        da.decode_attention_paged(**dict(case, block_tables=case[
            "block_tables"].long()))
    with pytest.raises(ValueError):                 # non-contiguous q
        da.decode_attention_paged(**dict(case, q=case["q"].transpose(1, 2)
                                         .contiguous().transpose(1, 2)))
    with pytest.raises(NotImplementedError):        # quantized pools
        da.decode_attention_paged(**case, k_scale=case["kv_len"],
                                  v_scale=case["kv_len"])


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


def test_forward_card_matches_cpu(cuda):
    cfg = get_config("tiny-target")
    params = init_params(cfg, 0, "cpu", torch.float32)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 512, (2, 20)))
    tables = torch.tensor([[1, 3, 5, 7], [2, 4, 6, 8]], dtype=torch.int32)
    outs = []
    for dev, p in (("cpu", params), (cuda, _tree_to(params, cuda))):
        pools = kv_pool.init_paged_caches(cfg, 9, 8, torch.float32, dev)
        pos = torch.zeros(2, dtype=torch.long, device=dev)
        forward(p, cfg, toks[:, :16].to(dev), caches=pools, cache_pos=pos,
                block_tables=tables.to(dev), kv_block_size=8,
                dtype=torch.float32)
        lg, _ = forward(p, cfg, toks[:, 16:].to(dev), caches=pools,
                        cache_pos=pos + 16, block_tables=tables.to(dev),
                        kv_block_size=8, dtype=torch.float32)
        outs.append(lg.cpu())
    torch.testing.assert_close(outs[1], outs[0], atol=2e-3, rtol=2e-3)


def test_engine_pard_equals_ar_on_card(cuda):
    tc, dc = get_config("tiny-target"), get_config("tiny-draft")
    tp = init_params(tc, 0, cuda, torch.float32)
    dp = init_params(dc, 1, cuda, torch.float32)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, 512, size=int(n))
               for n in rng.integers(4, 30, size=5)]
    out = {}
    for mode in ("pard", "ar"):
        eng = Engine(tp, tc, dp, dc, config=EngineConfig(
            mode=mode, k=4, max_batch=2, max_len=256, kv_block_size=16,
            kv_dtype="fp32"))
        rids = {eng.submit(p, 16): i for i, p in enumerate(prompts)}
        kernels.launches.clear()
        comps = eng.run()
        layers = tc.num_layers + (dc.num_layers if mode == "pard" else 0)
        assert kernels.launches["decode_attention_paged"] == \
            layers * eng.stats["steps"]
        out[mode] = {rids[c.rid]: c.tokens for c in comps}
    for i in range(len(prompts)):
        np.testing.assert_array_equal(out["pard"][i], out["ar"][i])
