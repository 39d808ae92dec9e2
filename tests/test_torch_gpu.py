"""On-card tests of the PyTorch port's CUDA kernels and serving path.

They need a CUDA card and skip without one. This file imports only torch
and the port, so it runs where JAX is not installed:

  PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs import get_config
from repro_torch.core.spec_decode import TreeTemplate
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import tree_attention as ta
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


# ------------------------------------------------ tree and contiguous kernels
def _tree_case(dev, b, tq, hq, hkv, d, bs, kv_dtype, q_dtype, seed=0):
    """Random valid templates per row (Tq <= 32 slots), a window at a
    random win_start >= 1, kv_len = win_start + Tq plus a ragged tail;
    block 0 and every slot at or past each row's eff_len poisoned. Returns
    (paged case, contiguous case) over the same rows."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    rng = np.random.default_rng(seed)
    anc = np.zeros((b, tq), np.int64)
    depth = np.zeros((b, tq), np.int64)
    win_len = np.zeros(b, np.int64)
    for r in range(b):
        while True:
            br = rng.integers(1, 4, size=rng.integers(1, 8))
            if r == 0 and tq == 32:
                br = np.ones(31, np.int64)          # bits 30 and 31 in play
            try:
                t = TreeTemplate.from_branching(br)
            except ValueError:
                continue
            if t.num_slots <= tq:
                break
        ns = t.num_slots
        anc[r, :ns], depth[r, :ns], win_len[r] = t.anc, t.depth, ns
    ws = torch.from_numpy(rng.integers(1, 200, size=b))
    kv_len = ws + tq + torch.from_numpy(rng.integers(0, 3, size=b))
    eff = torch.minimum(kv_len, ws + torch.from_numpy(win_len))
    s = int(kv_len.max()) + 5
    k = torch.randn(b, s, hkv, d, generator=g)
    v = torch.randn(b, s, hkv, d, generator=g)
    for r in range(b):
        k[r, int(eff[r]):], v[r, int(eff[r]):] = 1e4, -1e4
    mbs = -(-s // bs)
    nb = 1 + b * mbs
    tables = (torch.randperm(nb - 1, generator=g) + 1).reshape(b, mbs)
    kp = torch.full((nb, bs, hkv, d), 1e4)
    vp = torch.full((nb, bs, hkv, d), -1e4)
    pad = mbs * bs - s
    kp[tables.reshape(-1)] = torch.nn.functional.pad(
        k, (0, 0, 0, 0, 0, pad), value=1e4).reshape(b * mbs, bs, hkv, d)
    vp[tables.reshape(-1)] = torch.nn.functional.pad(
        v, (0, 0, 0, 0, 0, pad), value=-1e4).reshape(b * mbs, bs, hkv, d)
    q = torch.randn(b, tq, hq, d, generator=g)
    i32 = dict(device=dev, dtype=torch.int32)
    common = dict(q=q.to(dev, q_dtype), kv_len=kv_len.to(**i32),
                  q_pos=(ws[:, None] + torch.from_numpy(depth)).to(**i32),
                  win_start=ws.to(**i32),
                  anc=torch.from_numpy(anc).to(dev),
                  win_len=torch.from_numpy(win_len).to(**i32))
    paged = dict(common, k_pages=kp.to(dev, kv_dtype),
                 v_pages=vp.to(dev, kv_dtype), block_tables=tables.to(**i32))
    cont = dict(common, k=k.to(dev, kv_dtype), v=v.to(dev, kv_dtype))
    return paged, cont


@pytest.mark.parametrize("tq,hq,hkv,d,bs", [
    (31, 32, 8, 128, 64),        # the 8B target's adaptive tree window
    (9, 32, 8, 128, 64),         # the chain template at K = 8
    (32, 14, 2, 64, 16),         # G = 7, full 32-slot window
    (11, 4, 2, 32, 8),           # tiny test models
])
@pytest.mark.parametrize("kv_dtype,q_dtype,tol", [
    (torch.float32, torch.float32, 1e-4),
    (torch.bfloat16, torch.bfloat16, 2e-2),
])
def test_tree_kernels_match_plain(cuda, tq, hq, hkv, d, bs, kv_dtype,
                                  q_dtype, tol):
    paged, cont = _tree_case(cuda, 4, tq, hq, hkv, d, bs, kv_dtype, q_dtype)
    for fn, ref, case in ((ta.tree_attention_paged,
                           ta.tree_attention_paged_ref, paged),
                          (ta.tree_attention, ta.tree_attention_ref, cont)):
        name = fn.__name__
        before = kernels.launches[name]
        out = fn(**case)
        torch.cuda.synchronize()
        assert kernels.launches[name] == before + 1
        want = ref(**case)
        assert out.dtype == q_dtype and out.shape == case["q"].shape
        torch.testing.assert_close(out.float(), want.float(), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("window,softcap", [(24, 0.0), (0, 30.0), (50, 20.0)])
def test_tree_kernels_window_softcap(cuda, window, softcap):
    paged, cont = _tree_case(cuda, 4, 23, 32, 8, 128, 64, torch.float32,
                             torch.float32, seed=1)
    for fn, ref, case in ((ta.tree_attention_paged,
                           ta.tree_attention_paged_ref, paged),
                          (ta.tree_attention, ta.tree_attention_ref, cont)):
        out = fn(**case, window=window, softcap=softcap)
        want = ref(**case, window=window, softcap=softcap)
        torch.testing.assert_close(out, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("tq,hq,hkv,d", [(9, 32, 8, 128), (16, 32, 8, 64),
                                         (1, 4, 4, 32), (40, 14, 2, 64)])
@pytest.mark.parametrize("kv_dtype,q_dtype,tol", [
    (torch.float32, torch.float32, 1e-4),
    (torch.bfloat16, torch.bfloat16, 2e-2),
])
def test_contiguous_decode_matches_plain(cuda, tq, hq, hkv, d, kv_dtype,
                                         q_dtype, tol):
    g = torch.Generator(device="cpu").manual_seed(tq)
    kv_len = torch.tensor([0, 1, 300, 517])
    s = 520
    k = torch.randn(4, s, hkv, d, generator=g)
    v = torch.randn(4, s, hkv, d, generator=g)
    for r in range(4):                             # past kv_len: poison
        k[r, int(kv_len[r]):], v[r, int(kv_len[r]):] = 1e4, -1e4
    q_pos = (kv_len[:, None] - tq + torch.arange(tq)[None]).clamp(min=0)
    case = dict(q=torch.randn(4, tq, hq, d, generator=g).to(cuda, q_dtype),
                k=k.to(cuda, kv_dtype), v=v.to(cuda, kv_dtype),
                kv_len=kv_len.to(cuda, torch.int32),
                q_pos=q_pos.to(cuda, torch.int32))
    before = kernels.launches["decode_attention"]
    out = da.decode_attention(**case)
    torch.cuda.synchronize()
    assert kernels.launches["decode_attention"] == before + 1
    want = da.decode_attention_ref(**case)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)
    out = da.decode_attention(**case, window=40, softcap=20.0)
    want = da.decode_attention_ref(**case, window=40, softcap=20.0)
    torch.testing.assert_close(out.float(), want.float(), atol=tol, rtol=tol)


def test_tree_kernels_reject_what_they_do_not_take(cuda):
    paged, cont = _tree_case(cuda, 2, 9, 4, 2, 64, 16, torch.float32,
                             torch.float32)
    with pytest.raises(ValueError):                 # > 32 window slots
        q = cont["q"].repeat(1, 4, 1, 1)
        ta.tree_attention(**dict(cont, q=q, q_pos=cont["q_pos"].repeat(1, 4),
                                 anc=cont["anc"].repeat(1, 4)))
    with pytest.raises(TypeError):                  # int64 win_len
        ta.tree_attention_paged(**dict(paged, win_len=paged["win_len"].long()))
    with pytest.raises(TypeError):                  # float ancestor masks
        ta.tree_attention(**dict(cont, anc=cont["anc"].float()))
    with pytest.raises(ValueError):                 # cache batch != q batch
        da.decode_attention(cont["q"], cont["k"][:1], cont["v"][:1],
                            cont["kv_len"], cont["q_pos"])
    with pytest.raises(NotImplementedError):        # quantized caches
        ta.tree_attention(**cont, k_scale=cont["kv_len"],
                          v_scale=cont["kv_len"])


def test_tree_and_contiguous_engines_on_card(cuda):
    """Tiny fp32 engines on the card: tree greedy == AR, a chain == flat
    K, paged == contiguous, adaptive lossless; every attention layer of
    every step launches its kernel once."""
    tc, dc = get_config("tiny-target"), get_config("tiny-draft")
    tp = init_params(tc, 0, cuda, torch.float32)
    dp = init_params(dc, 1, cuda, torch.float32)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 512, size=int(n))
               for n in rng.integers(4, 30, size=5)]
    base = dict(max_batch=2, max_len=256, kv_block_size=16, kv_dtype="fp32")
    runs = {
        "ar": dict(mode="ar", k=4),
        "flat": dict(k=4),
        "flat-contig": dict(k=4, kv_layout="contiguous"),
        "chain": dict(tree=(1, 1, 1, 1)),
        "tree": dict(tree=(2, 2, 1, 1)),
        "tree-contig": dict(tree=(2, 2, 1, 1), kv_layout="contiguous"),
        "adaptive": dict(k=4, adaptive_tree=True, tree_reselect_every=2),
    }
    out = {}
    for name, kw in runs.items():
        eng = Engine(tp, tc, dp, dc, config=EngineConfig(**base, **kw))
        rids = {eng.submit(p, 16): i for i, p in enumerate(prompts)}
        kernels.launches.clear()
        comps = eng.run()
        steps = eng.stats["steps"]
        paged = kw.get("kv_layout", "paged") == "paged"
        flat = "decode_attention_paged" if paged else "decode_attention"
        tree = "tree_attention_paged" if paged else "tree_attention"
        if name == "ar":
            want = {flat: tc.num_layers * steps}
        elif eng.bank is None:
            want = {flat: (tc.num_layers + dc.num_layers) * steps}
        else:
            want = {flat: dc.num_layers * steps, tree: tc.num_layers * steps}
        assert dict(kernels.launches) == want, name
        out[name] = ({rids[c.rid]: c.tokens for c in comps},
                     eng.stats["accepted"])
    for name in runs:
        for i in range(len(prompts)):
            np.testing.assert_array_equal(out[name][0][i], out["ar"][0][i])
    assert out["chain"][1] == out["flat"][1]
    assert out["flat-contig"][1] == out["flat"][1]
    assert out["tree-contig"][1] == out["tree"][1]


# ---------------------------------------------------------------------------
# training kernels (flash / pard attention, forward and backward)
# ---------------------------------------------------------------------------

def _fwd_bwd(fn, q, k, v, dout):
    q, k, v = (x.detach().clone().requires_grad_(True) for x in (q, k, v))
    out = fn(q, k, v)
    out.backward(dout)
    return [out.detach(), q.grad, k.grad, v.grad]


def _train_inputs(dev, b, t, s, hq, hkv, d, dtype, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [torch.randn(*shape, generator=g).to(dev, dtype)
            for shape in ((b, t, hq, d), (b, s, hkv, d), (b, s, hkv, d),
                          (b, t, hq, d))]


def _assert_grads_close(got, want, tol):
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol,
                                   msg=name)


@pytest.mark.parametrize("b,t,hq,hkv,d,window,softcap", [
    (2, 300, 8, 2, 64, 0, 0.0),       # G = 4, T not a tile multiple
    (1, 129, 4, 4, 128, 0, 0.0),
    (2, 77, 4, 2, 32, 16, 0.0),       # window
    (1, 200, 4, 1, 64, 0, 30.0),      # softcap
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_flash_kernels_match_plain(cuda, b, t, hq, hkv, d, window, softcap,
                                   dtype, tol):
    from repro_torch.kernels import flash_attention as fa
    q, k, v, dout = _train_inputs(cuda, b, t, t, hq, hkv, d, dtype)
    kw = dict(causal=True, window=window, softcap=softcap)
    before = (kernels.launches["flash_attention"],
              kernels.launches["flash_attention_bwd"])
    got = _fwd_bwd(lambda *x: fa.flash_attention(*x, **kw), q, k, v, dout)
    torch.cuda.synchronize()
    assert (kernels.launches["flash_attention"],
            kernels.launches["flash_attention_bwd"]) == (before[0] + 1,
                                                          before[1] + 1)
    want = _fwd_bwd(lambda *x: fa.flash_attention_ref(*x, **kw), q, k, v,
                    dout)
    _assert_grads_close(got, want, tol)


def test_flash_kernel_rows_that_see_no_key(cuda):
    from repro_torch.kernels import flash_attention as fa
    q, k, v, dout = _train_inputs(cuda, 1, 160, 64, 4, 2, 64, torch.float32)
    got = _fwd_bwd(lambda *x: fa.flash_attention(*x, window=16), q, k, v,
                   dout)
    dead = torch.arange(160, device=cuda) >= 64 + 16 - 1
    assert (got[0][:, dead] == 0).all() and (got[1][:, dead] == 0).all()
    want = _fwd_bwd(lambda *x: fa.flash_attention_ref(*x, window=16), q, k,
                    v, dout)
    for a, b_ in zip(got, want):
        torch.testing.assert_close(a, b_, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("b,n,kk,hq,hkv,d,softcap", [
    (2, 200, 8, 8, 2, 64, 0.0),
    (1, 130, 4, 4, 4, 32, 0.0),
    (2, 64, 8, 4, 1, 128, 20.0),
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_pard_kernels_match_plain(cuda, b, n, kk, hq, hkv, d, softcap, dtype,
                                  tol):
    from repro_torch.core.cod import CodConfig, pack_batch
    from repro_torch.kernels import pard_attention as pa
    rng = np.random.default_rng(n)
    packed = pack_batch(rng.integers(0, 1000, (b, n)),
                        CodConfig(kk, 0.7, 0.2), 1000, seed=n)
    seg = torch.from_numpy(packed["segment"]).to(cuda, torch.int32)
    base = torch.from_numpy(packed["base"]).to(cuda, torch.int32)
    t = seg.shape[1]
    q, k, v, dout = _train_inputs(cuda, b, t, t, hq, hkv, d, dtype)
    before = (kernels.launches["pard_attention"],
              kernels.launches["pard_attention_bwd"])
    got = _fwd_bwd(lambda *x: pa.pard_attention(*x, seg, base,
                                                softcap=softcap),
                   q, k, v, dout)
    torch.cuda.synchronize()
    assert (kernels.launches["pard_attention"],
            kernels.launches["pard_attention_bwd"]) == (before[0] + 1,
                                                         before[1] + 1)
    want = _fwd_bwd(lambda *x: pa.pard_attention_ref(*x, seg, base,
                                                     softcap=softcap),
                    q, k, v, dout)
    _assert_grads_close(got, want, tol)
    pad = seg == 0
    for x in got:                               # padding: output and grads 0
        assert (x[pad] == 0).all()


def test_training_kernels_reject_what_they_do_not_take(cuda):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import pard_attention as pa
    q, k, v, _ = _train_inputs(cuda, 1, 16, 16, 4, 2, 64, torch.float32)
    with pytest.raises(TypeError):                  # mixed dtypes
        fa.flash_attention(q, k.bfloat16(), v.bfloat16())
    with pytest.raises(ValueError):                 # head dim not built
        fa.flash_attention(q[..., :48].contiguous(), k[..., :48].contiguous(),
                           v[..., :48].contiguous())
    seg = torch.ones(1, 16, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):                  # int64 metadata
        pa.pard_attention(q, k, v, seg.long(), seg)
    with pytest.raises(ValueError):                 # metadata on the host
        pa.pard_attention(q, k, v, seg.cpu(), seg)


def test_trainer_on_card_matches_cpu(cuda):
    """Three fp32 steps of the tiny draft, AR and PARD, on the card and on
    the CPU: the same loss histories; every attention layer launches its
    forward and backward kernel once per step."""
    from repro_torch.core.cod import CodConfig
    from repro_torch.data.pipeline import MarkovCorpus
    from repro_torch.training.optimizer import AdamW, cosine_schedule
    from repro_torch.training.train_loop import Trainer
    cfg = get_config("tiny-draft")
    corpus = MarkovCorpus(vocab_size=cfg.vocab_size, seed=0, determinism=2.0)
    for kind, fwd in (("ar", "flash_attention"), ("pard", "pard_attention")):
        hists = []
        for dev in ("cpu", cuda):
            tr = Trainer(cfg, AdamW(lr=cosine_schedule(3e-3, 2, 3)),
                         loss_kind=kind, cod=CodConfig(4, 0.7, 0.2),
                         device=dev)
            params = _tree_to(init_params(cfg, 0, "cpu", torch.float32), dev)
            kernels.launches.clear()
            _, _, hist = tr.fit(params, corpus.batches(4, 40, seed=1), 3,
                                log_every=1, log_fn=None)
            hists.append(hist)
        assert dict(kernels.launches) == {fwd: 3 * cfg.num_layers,
                                          fwd + "_bwd": 3 * cfg.num_layers}
        for a, b in zip(*hists):
            assert b["loss"] == pytest.approx(a["loss"], rel=1e-4)
            assert b["tokens"] == a["tokens"]
