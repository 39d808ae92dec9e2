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
from repro_torch.kernels import ssd
from repro_torch.kernels import tree_attention as ta
from repro_torch.models import forward, init_params
from repro_torch.models.attention import quantize_kv
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
    (9, 4, 2, 48, 16, [1, 29, 70, 130]),           # D = 48 (tiny-mid), G 2
    (16, 2, 2, 48, 8, [16, 40, 95, 200]),          # D = 48, G 1
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
        da.decode_attention_paged(case["q"][..., :40].contiguous(),
                                  case["k_pages"][..., :40].contiguous(),
                                  case["v_pages"][..., :40].contiguous(),
                                  case["block_tables"], case["kv_len"],
                                  case["q_pos"])
    with pytest.raises(TypeError):                  # int64 tables
        da.decode_attention_paged(**dict(case, block_tables=case[
            "block_tables"].long()))
    with pytest.raises(ValueError):                 # non-contiguous q
        da.decode_attention_paged(**dict(case, q=case["q"].transpose(1, 2)
                                         .contiguous().transpose(1, 2)))
    q8 = _quantized(case, torch.int8)
    with pytest.raises(ValueError):                 # int8 pools, no scales
        da.decode_attention_paged(**dict(q8, k_scale=None, v_scale=None))
    with pytest.raises(TypeError):                  # bf16 scales
        da.decode_attention_paged(**dict(q8, k_scale=q8["k_scale"].bfloat16()))
    with pytest.raises(ValueError):                 # scales of fp32 pools
        da.decode_attention_paged(**case, k_scale=q8["k_scale"],
                                  v_scale=q8["v_scale"])


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
        pools = kv_pool.init_paged_caches(cfg, 2, 9, 8, torch.float32, dev)
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
    (11, 4, 2, 48, 8),           # D = 48, G 2
    (9, 2, 2, 48, 16),           # D = 48, G 1
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
                                         (1, 4, 4, 32), (40, 14, 2, 64),
                                         (9, 4, 2, 48), (16, 2, 2, 48)])
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
    q8 = _quantized(cont, torch.float8_e4m3fn)
    with pytest.raises(ValueError):                 # scales of another shape
        ta.tree_attention(**dict(q8, k_scale=q8["k_scale"][:, :-1]))
    with pytest.raises(ValueError):                 # fp8 caches, no scales
        ta.tree_attention(**dict(q8, v_scale=None))


# bf16 q and KV take the tensor-core split-KV loop
# (csrc/serve_attention_mma.cuh) in all four serving kernels: its edges,
# determinism and graph capture, on pools and on contiguous caches
BF = torch.bfloat16
SPLIT_DECODE_EDGES = [
    (4, 9, 32, 8, 128, 64, [4096, 70, 1, 0], 0, 0.0),   # empty splits, no key
    (1, 9, 32, 8, 128, 64, [4000], 100, 30.0),          # window removes splits
    (4, 16, 56, 8, 128, 16, [16, 300, 1000, 2500], 0, 0.0),  # G 7: 112 rows
    (2, 36, 14, 2, 64, 64, [36, 777], 0, 0.0),          # G 7: 2 tiles of 128
    (4, 8, 4, 2, 32, 8, [8, 30, 95, 200], 0, 0.0),      # pages of 8
    (4, 16, 4, 2, 48, 16, [1, 64, 65, 600], 0, 20.0),   # D 48, pages of 16
]
SPLIT_TREE_EDGES = [
    (4, 31, 32, 8, 128, 64, 0, 0.0, True),      # a row that sees no key
    (2, 31, 14, 2, 64, 16, 0, 0.0, False),      # G 7: 217 rows, 2 tiles
    (1, 23, 32, 8, 128, 64, 64, 30.0, False),   # window, softcap, B 1
    (4, 11, 4, 2, 32, 8, 0, 0.0, True),         # pages of 8
]


def _contiguous(case):
    """The contiguous cache [B, MBS * bs, Hkv, D] of a paged ``_case``:
    each row's pages gathered in order (block 0's poison past the row)."""
    out = {n: case[n] for n in ("q", "kv_len", "q_pos")}
    out["k"] = da.gather_pages(case["k_pages"], case["block_tables"])
    out["v"] = da.gather_pages(case["v_pages"], case["block_tables"])
    return out


@pytest.mark.parametrize("b,tq,hq,hkv,d,bs,kv_len,window,softcap",
                         SPLIT_DECODE_EDGES)
def test_split_kv_decode_edges(cuda, b, tq, hq, hkv, d, bs, kv_len, window,
                               softcap):
    case = _case(cuda, b, tq, hq, hkv, d, bs, kv_len, BF, BF)
    out = da.decode_attention_paged(**case, window=window, softcap=softcap)
    want = da.decode_attention_paged_ref(**case, window=window,
                                         softcap=softcap)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("b,tq,hq,hkv,d,bs,kv_len,window,softcap",
                         SPLIT_DECODE_EDGES)
def test_split_kv_contiguous_decode_edges(cuda, b, tq, hq, hkv, d, bs, kv_len,
                                          window, softcap):
    case = _contiguous(_case(cuda, b, tq, hq, hkv, d, bs, kv_len, BF, BF))
    before = kernels.launches["decode_attention"]
    out = da.decode_attention(**case, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert kernels.launches["decode_attention"] == before + 1
    want = da.decode_attention_ref(**case, window=window, softcap=softcap)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2,
                               rtol=2e-2)


def _dead_row(case):
    """No context, no window slot: row 0 sees no key."""
    case["win_start"][0] = 0
    case["win_len"][0] = 0


@pytest.mark.parametrize("b,tq,hq,hkv,d,bs,window,softcap,dead",
                         SPLIT_TREE_EDGES)
def test_split_kv_tree_edges(cuda, b, tq, hq, hkv, d, bs, window, softcap,
                             dead):
    case, _ = _tree_case(cuda, b, tq, hq, hkv, d, bs, BF, BF, seed=5)
    if dead:
        _dead_row(case)
    out = ta.tree_attention_paged(**case, window=window, softcap=softcap)
    want = ta.tree_attention_paged_ref(**case, window=window,
                                       softcap=softcap)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    if dead:
        assert not out[0].any()


@pytest.mark.parametrize("b,tq,hq,hkv,d,bs,window,softcap,dead",
                         SPLIT_TREE_EDGES)
def test_split_kv_contiguous_tree_edges(cuda, b, tq, hq, hkv, d, bs, window,
                                        softcap, dead):
    _, case = _tree_case(cuda, b, tq, hq, hkv, d, bs, BF, BF, seed=5)
    if dead:
        _dead_row(case)
    before = kernels.launches["tree_attention"]
    out = ta.tree_attention(**case, window=window, softcap=softcap)
    torch.cuda.synchronize()
    assert kernels.launches["tree_attention"] == before + 1
    want = ta.tree_attention_ref(**case, window=window, softcap=softcap)
    torch.testing.assert_close(out.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    if dead:
        assert not out[0].any()


@pytest.mark.parametrize("dtype,tol", [(BF, 2e-2), (torch.float32, 1e-4)])
@pytest.mark.parametrize("tree", [False, True])
def test_contiguous_sweep_stops_at_s(cuda, tree, dtype, tol):
    """A contiguous row's sweep stops at S: kv_len past S (queries past S
    too), and a tree window that ends at S (row 0, whose kv_len passes
    S)."""
    if tree:
        _, case = _tree_case(cuda, 4, 31, 32, 8, 128, 64, dtype, dtype,
                             seed=7)
        s = int(case["win_start"][0] + case["win_len"][0])
        fn, ref = ta.tree_attention, ta.tree_attention_ref
    else:
        case = _contiguous(_case(cuda, 4, 9, 32, 8, 128, 64,
                                 [1000, 1030, 700, 1024], dtype, dtype))
        s = 1024
        fn, ref = da.decode_attention, da.decode_attention_ref
    case["k"] = case["k"][:, :s].contiguous()
    case["v"] = case["v"][:, :s].contiguous()
    assert int(case["kv_len"].max()) > s
    out = fn(**case)
    torch.testing.assert_close(out.float(), ref(**case).float(), atol=tol,
                               rtol=tol)


def _bitwise_and_graph_replay(fn, ref, case, kw, tree):
    assert torch.equal(fn(**case, **kw), fn(**case, **kw))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn(**case, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(**case, **kw)
    if tree:
        case["kv_len"] -= 2
        case["q_pos"] += 1
    else:
        case["kv_len"] -= 37
        case["q_pos"] -= 37
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref(**case, **kw).float(),
                               atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("tree", [False, True])
def test_split_kv_bitwise_and_graph_replay(cuda, tree):
    """Two calls are bitwise equal; a call captured in a CUDA graph and
    replayed after kv_len and q_pos are rewritten in place matches the
    plain version on the new values (the wrapper reads no device value)."""
    if tree:
        case, _ = _tree_case(cuda, 4, 31, 32, 8, 128, 64, BF, BF, seed=3)
        _bitwise_and_graph_replay(ta.tree_attention_paged,
                                  ta.tree_attention_paged_ref, case,
                                  dict(window=100), tree)
    else:
        case = _case(cuda, 4, 9, 32, 8, 128, 64, [300, 1000, 2049, 4000],
                     BF, BF)
        _bitwise_and_graph_replay(da.decode_attention_paged,
                                  da.decode_attention_paged_ref, case, {},
                                  tree)


@pytest.mark.parametrize("tree", [False, True])
def test_split_kv_contiguous_bitwise_and_graph_replay(cuda, tree):
    """The same for the contiguous kernels."""
    if tree:
        _, case = _tree_case(cuda, 4, 31, 32, 8, 128, 64, BF, BF, seed=3)
        _bitwise_and_graph_replay(ta.tree_attention, ta.tree_attention_ref,
                                  case, dict(window=100), tree)
    else:
        case = _contiguous(_case(cuda, 4, 9, 32, 8, 128, 64,
                                 [300, 1000, 2049, 4000], BF, BF))
        _bitwise_and_graph_replay(da.decode_attention, da.decode_attention_ref,
                                  case, {}, tree)


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
# quantized KV: int8 / fp8 codes with f32 scales in all four serving kernels
# ---------------------------------------------------------------------------

QUANT = [torch.int8, torch.float8_e4m3fn]


def _quantized(case, qdtype):
    """A kernel case with its K/V quantized (``quantize_kv``, as the model
    appends them): codes in ``qdtype`` and f32 k_scale / v_scale. Poisoned
    slots become codes +-max at scale 1e4 / max: finite, never seen."""
    out = dict(case)
    for name in ("k", "v", "k_pages", "v_pages"):
        if name in case:
            codes, scale = quantize_kv(case[name], qdtype)
            out[name] = codes
            out[name[0] + "_scale"] = scale
    return out


def _quant_cases(dev, qdtype, q_dtype, tq, hq, hkv, d, bs, kv_len, seed):
    """(kernel, plain, case) of all four serving kernels: the causal pair on
    ``_case``'s pools and their gathered rows, the tree pair on
    ``_tree_case`` at the same widths."""
    paged = _quantized(_case(dev, 4, tq, hq, hkv, d, bs, kv_len,
                             torch.float32, q_dtype, seed=seed), qdtype)
    tp, tc = (_quantized(c, qdtype) for c in _tree_case(
        dev, 4, min(tq + 14, 32), hq, hkv, d, bs, torch.float32, q_dtype,
        seed=seed))
    contig = dict(_contiguous(paged), k_scale=da.gather_pages(
        paged["k_scale"], paged["block_tables"]), v_scale=da.gather_pages(
        paged["v_scale"], paged["block_tables"]))
    return [(da.decode_attention_paged, da.decode_attention_paged_ref, paged),
            (da.decode_attention, da.decode_attention_ref, contig),
            (ta.tree_attention_paged, ta.tree_attention_paged_ref, tp),
            (ta.tree_attention, ta.tree_attention_ref, tc)]


@pytest.mark.parametrize("tq,hq,hkv,d,bs,kv_len", [
    (9, 32, 8, 128, 64, [1, 70, 500, 1024]),       # target verify window
    (16, 32, 8, 64, 64, [16, 200, 640, 1000]),     # draft window
    (16, 56, 8, 128, 16, [16, 300, 1000, 2500]),   # G 7, pages of 16
    (9, 4, 2, 48, 16, [1, 29, 70, 130]),           # D 48, G 2
    (5, 4, 2, 32, 8, [6, 20, 13, 31]),             # D 32, pages of 8
])
@pytest.mark.parametrize("qdtype", QUANT)
@pytest.mark.parametrize("q_dtype,tol", [(torch.bfloat16, 2e-2),
                                         (torch.float32, 1e-4)])
def test_quantized_kernels_match_plain(cuda, tq, hq, hkv, d, bs, kv_len,
                                       qdtype, q_dtype, tol):
    """bf16 q takes the tensor-core loop's 8-bit route, f32 q the f32
    loop's dequantizing route; both against the plain version on the
    f32-dequantized K/V."""
    for fn, ref, case in _quant_cases(cuda, qdtype, q_dtype, tq, hq, hkv, d,
                                      bs, kv_len, seed=tq + d):
        name = fn.__name__
        before = kernels.launches[name]
        for kw in ({}, dict(window=40, softcap=20.0)):
            out = fn(**case, **kw)
            torch.cuda.synchronize()
            want = ref(**case, **kw)
            assert out.dtype == q_dtype and torch.isfinite(out).all(), name
            torch.testing.assert_close(out.float(), want.float(), atol=tol,
                                       rtol=tol, msg=name)
        assert kernels.launches[name] == before + 2


@pytest.mark.parametrize("qdtype", QUANT)
def test_quantized_edges(cuda, qdtype):
    """Rows that see no key give 0; contiguous kv_len past S; the garbage
    block's codes of 0 and scales of 1 stay invisible."""
    case = _quantized(_case(cuda, 4, 9, 32, 8, 128, 64, [4096, 70, 1, 0],
                            torch.float32, BF), qdtype)
    da.as_bytes(case["k_pages"])[0] = 0             # codes of 0 (int8, e4m3)
    da.as_bytes(case["v_pages"])[0] = 0
    case["k_scale"][0] = 1.0
    case["v_scale"][0] = 1.0
    out = da.decode_attention_paged(**case)
    torch.testing.assert_close(out.float(), da.decode_attention_paged_ref(
        **case).float(), atol=2e-2, rtol=2e-2)
    assert not out[3].any()
    _, cont = _tree_case(cuda, 4, 31, 32, 8, 128, 64, torch.float32, BF,
                         seed=7)
    cont = _quantized(cont, qdtype)
    s = int(cont["win_start"][0] + cont["win_len"][0])
    for n in ("k", "v"):
        cont[n] = cont[n][:, :s].contiguous()
        cont[n + "_scale"] = cont[n + "_scale"][:, :s].contiguous()
    _dead_row(cont)
    out = ta.tree_attention(**cont)
    torch.testing.assert_close(out.float(), ta.tree_attention_ref(
        **cont).float(), atol=2e-2, rtol=2e-2)
    assert not out[0].any()


@pytest.mark.parametrize("qdtype", QUANT)
def test_quantized_bitwise_and_graph_replay(cuda, qdtype):
    """Each kernel's 8-bit route: two calls bitwise equal, and a CUDA graph
    replayed after kv_len / q_pos are rewritten matches the plain
    version."""
    cases = _quant_cases(cuda, qdtype, BF, 9, 32, 8, 128, 64,
                         [300, 1000, 2049, 4000], seed=11)
    for fn, ref, case in cases:
        _bitwise_and_graph_replay(fn, ref, case, {}, "anc" in case)


def test_quantized_engines_on_card(cuda):
    """Tiny fp32 engines with int8 and fp8 pools on the card: PARD, a tree
    and contiguous rows all give the AR tokens of their kv dtype, through
    the kernels (one launch per attention layer per step)."""
    tc, dc = get_config("tiny-target"), get_config("tiny-draft")
    tp = init_params(tc, 0, cuda, torch.float32)
    dp = init_params(dc, 1, cuda, torch.float32)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 512, size=int(n))
               for n in rng.integers(4, 30, size=4)]
    for kv_dtype in ("int8", "fp8"):
        base = dict(max_batch=2, max_len=256, kv_block_size=16,
                    kv_dtype=kv_dtype)
        out = {}
        for name, kw in {"ar": dict(mode="ar", k=4), "flat": dict(k=4),
                         "tree-contig": dict(tree=(2, 2, 1),
                                             kv_layout="contiguous")}.items():
            eng = Engine(tp, tc, dp, dc, config=EngineConfig(**base, **kw))
            rids = {eng.submit(p, 16): i for i, p in enumerate(prompts)}
            kernels.launches.clear()
            comps = eng.run()
            assert sum(kernels.launches.values()) > 0
            out[name] = {rids[c.rid]: c.tokens for c in comps}
        for name in out:
            for i in range(len(prompts)):
                np.testing.assert_array_equal(out[name][i], out["ar"][i])


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
    (2, 130, 4, 2, 48, 0, 0.0),       # D = 48, G = 2
    (1, 77, 2, 2, 48, 16, 20.0),      # D = 48, G = 1, window + softcap
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
    (2, 100, 8, 4, 2, 48, 0.0),       # D = 48, G = 2
    (1, 64, 4, 2, 2, 48, 20.0),       # D = 48, G = 1
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
    info = pa.PardMaskInfo(seg, base)
    got = _fwd_bwd(lambda *x: pa.pard_attention(*x, info, softcap=softcap),
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


def _cod_inputs(dev, b, n, kk, extra, seed):
    from repro_torch.core.cod import CodConfig, pack_batch
    rng = np.random.default_rng(seed)
    packed = pack_batch(rng.integers(0, 1000, (b, n)),
                        CodConfig(kk, 0.7, 0.2), 1000, seed=seed)
    pad = np.zeros((b, extra), np.int32)
    return [torch.from_numpy(np.concatenate([packed[f], pad], 1)).to(
        dev, torch.int32) for f in ("segment", "base")]


# where the tensor-core tiles can break: one row, a row off the tile, T one
# short of the training length, and rows that see no key (S < T, window)
@pytest.mark.parametrize("t,s,window,hq,hkv", [
    (1, 1, 0, 4, 2), (65, 65, 0, 4, 1), (1023, 1023, 0, 4, 2),
    (300, 128, 40, 4, 2)])
@pytest.mark.parametrize("d", [32, 48, 64, 128])
def test_flash_kernels_at_tile_edges(cuda, t, s, window, hq, hkv, d):
    from repro_torch.kernels import flash_attention as fa
    q, k, v, dout = _train_inputs(cuda, 2, t, s, hq, hkv, d, torch.bfloat16,
                                  seed=t + d)
    got = _fwd_bwd(lambda *x: fa.flash_attention(*x, window=window), q, k, v,
                   dout)
    want = _fwd_bwd(lambda *x: fa.flash_attention_ref(*x, window=window), q,
                    k, v, dout)
    _assert_grads_close(got, want, 2e-2)
    if window:
        dead = torch.arange(t, device=cuda) >= s + window - 1
        assert dead.any()
        assert (got[0][:, dead] == 0).all() and (got[1][:, dead] == 0).all()


# a 64-token tile of padding only (classed empty both ways), and a layout
# with tiles classed full (no per-element mask)
@pytest.mark.parametrize("n,kk,extra,need", [(100, 8, 130, "padding"),
                                             (256, 4, 0, "full")])
@pytest.mark.parametrize("d", [32, 48, 64, 128])
def test_pard_kernels_at_tile_classes(cuda, n, kk, extra, need, d):
    from repro_torch.kernels import pard_attention as pa
    seg, base = _cod_inputs(cuda, 2, n, kk, extra, seed=n + d)
    cls = pa.pard_tile_classes(seg, base)
    if need == "full":
        assert (cls == pa.FULL).any()
    else:
        assert (cls == pa.EMPTY).all(-1).any()
    t = seg.shape[1]
    q, k, v, dout = _train_inputs(cuda, 2, t, t, 4, 2, d, torch.bfloat16,
                                  seed=d)
    info = pa.PardMaskInfo(seg, base)
    got = _fwd_bwd(lambda *x: pa.pard_attention(*x, info), q, k, v, dout)
    want = _fwd_bwd(lambda *x: pa.pard_attention_ref(*x, seg, base), q, k, v,
                    dout)
    _assert_grads_close(got, want, 2e-2)
    for x in got:
        assert (x[seg == 0] == 0).all()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_training_backward_is_deterministic(cuda, dtype):
    """No float atomics: two backward calls give bitwise-equal gradients."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import pard_attention as pa
    q, k, v, dout = _train_inputs(cuda, 2, 333, 333, 8, 2, 64, dtype)
    out, lse = fa.flash_attention_fwd(q, k, v)
    a = fa.flash_attention_bwd(q, k, v, out, lse, dout)
    b = fa.flash_attention_bwd(q, k, v, out, lse, dout)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    seg, base = _cod_inputs(cuda, 2, 200, 8, 5, seed=3)
    t = seg.shape[1]
    q, k, v, dout = _train_inputs(cuda, 2, t, t, 8, 2, 64, dtype)
    info = pa.PardMaskInfo(seg, base)
    out, lse = pa.pard_attention_fwd(q, k, v, info)
    a = pa.pard_attention_bwd(q, k, v, info, out, lse, dout)
    b = pa.pard_attention_bwd(q, k, v, info, out, lse, dout)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_training_kernels_reject_what_they_do_not_take(cuda):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import pard_attention as pa
    q, k, v, _ = _train_inputs(cuda, 1, 16, 16, 4, 2, 64, torch.float32)
    with pytest.raises(TypeError):                  # mixed dtypes
        fa.flash_attention(q, k.bfloat16(), v.bfloat16())
    with pytest.raises(ValueError):                 # head dim not built
        fa.flash_attention(q[..., :40].contiguous(), k[..., :40].contiguous(),
                           v[..., :40].contiguous())
    seg = torch.ones(1, 16, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):                  # int64 metadata
        pa.pard_attention(q, k, v, pa.PardMaskInfo(seg.long(), seg))
    with pytest.raises(ValueError):                 # metadata on the host
        pa.pard_attention(q, k, v, pa.PardMaskInfo(seg.cpu(), seg))
    with pytest.raises(ValueError):                 # metadata of 17 tokens
        pa.pard_attention(q, k, v, pa.PardMaskInfo(
            torch.ones(1, 17, dtype=torch.int32, device=cuda), seg))


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


def test_tiny_mid_draft_engine_on_card(cuda):
    """A head-dim-48 draft (tiny-mid) in fp32 on the card: PARD == AR on
    both layouts, one attention launch per layer per step."""
    tc, dc = get_config("tiny-target"), get_config("tiny-mid")
    tp = init_params(tc, 0, cuda, torch.float32)
    dp = init_params(dc, 1, cuda, torch.float32)
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, 512, size=int(n))
               for n in rng.integers(4, 30, size=4)]
    out = {}
    for layout in ("paged", "contiguous"):
        name = ("decode_attention_paged" if layout == "paged"
                else "decode_attention")
        for mode in ("pard", "ar"):
            eng = Engine(tp, tc, dp, dc, config=EngineConfig(
                mode=mode, k=4, max_batch=2, max_len=256, kv_block_size=16,
                kv_dtype="fp32", kv_layout=layout))
            rids = {eng.submit(p, 16): i for i, p in enumerate(prompts)}
            kernels.launches.clear()
            comps = eng.run()
            layers = tc.num_layers + (dc.num_layers if mode == "pard" else 0)
            assert dict(kernels.launches) == {
                name: layers * eng.stats["steps"]}
            out[layout, mode] = {rids[c.rid]: c.tokens for c in comps}
    for key in out:
        for i in range(len(prompts)):
            np.testing.assert_array_equal(out[key][i],
                                          out["paged", "ar"][i])


# ---------------------------------------------------------------------------
# the Mamba2 SSD scan
# ---------------------------------------------------------------------------

def _ssd_inputs(dev, b, t, h, p, n, dtype, init=True, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(b, t, h, p, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(b, t, h, generator=g) - 1)
    A = -torch.exp(torch.randn(h, generator=g) * 0.5)
    B = torch.randn(b, t, n, generator=g)
    C = torch.randn(b, t, n, generator=g)
    s0 = torch.randn(b, h, p, n, generator=g) * 0.1 if init else None
    f32 = dict(device=dev, dtype=torch.float32)
    return (x.to(dev, dtype), dt.to(**f32), A.to(**f32), B.to(dev, dtype),
            C.to(dev, dtype), None if s0 is None else s0.to(**f32))


def _scaled_close(got, want, tol):
    err = ((got.float() - want.float()).abs()
           / want.float().abs().clamp(min=1.0)).max().item()
    assert err <= tol, err


@pytest.mark.parametrize("b,t,h,p,n,chunk,init", [
    (4, 9, 24, 64, 128, 64, True),     # mamba2-130m verify window
    (4, 16, 24, 64, 128, 64, True),    # mamba2-130m draft window
    (2, 50, 24, 64, 128, 16, False),   # t off the chunk, zero state
    (2, 9, 2, 32, 16, 8, True),        # tiny-ssm
    (3, 50, 2, 32, 16, 16, True),
    (1, 2048, 2, 32, 16, 64, True),    # a long scan of 32 chunks
    (4, 1, 24, 64, 128, 64, True),     # one token
    (4, 17, 24, 64, 128, 64, True),    # a chunk of 32 with 15 rows past t
    (2, 65, 24, 64, 128, 64, False),   # a chunk of 64, then one token
    (2, 16, 3, 40, 128, 16, True),     # a P block of 8 rows
    (2, 23, 3, 40, 24, 16, False),     # and N off the warps' k-steps
])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_ssd_kernel_matches_plain(cuda, b, t, h, p, n, chunk, init, dtype,
                                  tol):
    ins = _ssd_inputs(cuda, b, t, h, p, n, dtype, init)
    before = kernels.launches["ssd_chunked"]
    y, s = ssd.ssd_chunked(*ins, chunk=chunk)
    torch.cuda.synchronize()
    assert kernels.launches["ssd_chunked"] == before + 1
    wy, ws = ssd.ssd_chunked_ref(*ins, chunk=ssd.clamp_chunk(chunk, t))
    assert y.dtype == dtype and y.shape == ins[0].shape
    assert s.dtype == torch.float32 and s.shape == (b, h, p, n)
    _scaled_close(y, wy, tol)
    _scaled_close(s, ws, tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_ssd_gather_route_on_card(cuda, dtype, tol):
    """dt = 0 past idx[b]: the state after idx[b] + 1 tokens, as the
    token-by-token oracle collects it; a fully masked window leaves the
    state bit for bit."""
    x, dt, A, B, C, s0 = _ssd_inputs(cuda, 4, 16, 24, 64, 128, dtype)
    idx = torch.tensor([0, 5, 8, 15], device=cuda)
    keep = torch.arange(16, device=cuda)[None] <= idx[:, None]
    _, s = ssd.ssd_chunked(x, dt * keep[..., None], A, B, C, s0, chunk=64)
    _, states = ssd.ssd_ref(x, dt, A, B, C, s0, collect_states=True)
    _scaled_close(s, states[torch.arange(4, device=cuda), idx], tol)
    _, same = ssd.ssd_chunked(x, dt * 0, A, B, C, s0, chunk=64)
    assert torch.equal(same, s0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_ssd_kernel_is_deterministic_and_replays(cuda, dtype):
    """Two calls are bitwise equal; a call captured in a CUDA graph and
    replayed after new inputs are copied into its buffers equals an eager
    call on them bit for bit (the wrapper reads no device value)."""
    ins = _ssd_inputs(cuda, 4, 9, 24, 64, 128, dtype)
    first, second = ssd.ssd_chunked(*ins), ssd.ssd_chunked(*ins)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        ssd.ssd_chunked(*ins)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ssd.ssd_chunked(*ins)
    new = _ssd_inputs(cuda, 4, 9, 24, 64, 128, dtype, seed=1)
    for buf, val in zip(ins, new):
        buf.copy_(val)
    graph.replay()
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(out, ssd.ssd_chunked(*new)))


def test_ssd_kernel_rejects_what_it_does_not_take(cuda):
    x, dt, A, B, C, s0 = _ssd_inputs(cuda, 1, 16, 2, 32, 16, torch.float32)
    with pytest.raises(TypeError):                  # mixed dtypes
        ssd.ssd_chunked(x, dt, A, B.bfloat16(), C, s0)
    with pytest.raises(TypeError):                  # bf16 dt
        ssd.ssd_chunked(x, dt.bfloat16(), A, B, C, s0)
    with pytest.raises(ValueError):                 # chunk past the tiles
        ssd.ssd_chunked(x.repeat(1, 8, 1, 1), dt.repeat(1, 8, 1), A,
                        B.repeat(1, 8, 1), C.repeat(1, 8, 1), s0, chunk=128)
    with pytest.raises(ValueError):                 # non-contiguous x
        ssd.ssd_chunked(x.transpose(2, 3).contiguous().transpose(2, 3), dt,
                        A, B, C, s0)
    with pytest.raises(NotImplementedError):        # no backward kernel yet
        ssd.ssd_chunked(x.requires_grad_(True), dt, A, B, C, s0)
    # the bf16 kernel: N past 128 or off 8, P off 8, a misaligned x
    for p, n in ((64, 136), (64, 20), (36, 16)):
        ins = _ssd_inputs(cuda, 1, 9, 2, p, n, torch.bfloat16)
        with pytest.raises(ValueError):
            ssd.ssd_chunked(*ins)
    xb, dt, A, B, C, s0 = _ssd_inputs(cuda, 1, 9, 2, 32, 16, torch.bfloat16)
    off = torch.empty(xb.numel() + 1, dtype=xb.dtype, device=cuda)[1:]
    off = off.view(xb.shape).copy_(xb)
    with pytest.raises(ValueError):
        ssd.ssd_chunked(off, dt, A, B, C, s0)


HYBRID = dict(name="hybrid-test", arch_type="hybrid", num_layers=4,
              attn_every=2, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
              d_ff=128, vocab_size=512, ssm_state=16, ssm_headdim=32,
              ssm_chunk=8, tie_embeddings=True, max_seq_len=1024,
              source="test")


@pytest.mark.parametrize("name", ["tiny-ssm", "hybrid"])
def test_ssm_engines_on_card(cuda, name):
    """fp32 Mamba2 / dense-hybrid engines on the card, target = draft:
    forward logits against the CPU; PARD == AR on both layouts with a
    recycled slot; ssd_chunked launches per SSM layer as the steps run."""
    from repro_torch.models.config import ModelConfig
    cfg = ModelConfig(**HYBRID) if name == "hybrid" else get_config(name)
    params = init_params(cfg, 3, "cpu", torch.float32)
    on = _tree_to(params, cuda)
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 512, (2, 19)))
    outs = [forward(p, cfg, toks.to(dev), dtype=torch.float32)[0].cpu()
            for dev, p in (("cpu", params), (cuda, on))]
    torch.testing.assert_close(outs[1], outs[0], atol=2e-3, rtol=2e-3)
    n_ssm = sum(1 for i in range(cfg.num_layers)
                if name == "tiny-ssm" or i % 2 == 0)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 512, size=n) for n in (7, 13, 20)]
    out = {}
    for layout in ("paged", "contiguous"):
        for mode in ("pard", "ar"):
            eng = Engine(on, cfg, on, cfg, config=EngineConfig(
                mode=mode, k=4, max_batch=2, max_len=256, kv_block_size=16,
                kv_dtype="fp32", kv_layout=layout))
            rids = {eng.submit(p, 16): i for i, p in enumerate(prompts)}
            kernels.launches.clear()
            comps = eng.run()
            # PARD: two forwards, each scanned and gathered; AR: one scan
            # a step, plus a gather on the steps widened for prefill
            want = (4 * n_ssm * eng.stats["steps"] if mode == "pard" else
                    n_ssm * (eng.stats["steps"] + eng.stats["prefill_steps"]))
            assert kernels.launches["ssd_chunked"] == want
            out[layout, mode] = {rids[c.rid]: c.tokens for c in comps}
    for key in out:
        for i in range(len(prompts)):
            np.testing.assert_array_equal(out[key][i],
                                          out["paged", "ar"][i])
