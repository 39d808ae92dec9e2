"""The port's engine serving Mamba2 (``tiny-ssm``) and a dense hybrid on
the CPU, against the JAX package and against itself.

Both packages run fp32 activations: the JAX decoder's forwards default to
bf16 activations, so its module-level ``forward`` is pinned to fp32 here
(``monkeypatch``, undone after each test). Greedy tokens are then exact:
the port's PARD tokens equal the JAX Engine's PARD tokens and
``SpecDecoder.generate_ar``, and the port's AR tokens equal its PARD
tokens. ``max_batch=2`` with 3 requests, so a slot is recycled and its
recurrent state must be cleared at admission.

The JAX Engine in mode "ar" is NOT token-identical to ``generate_ar`` on
an SSM target: its chunked AR step widens each row's window with pads and
runs the target without ``collect_ssm``, so the recurrent state takes in
the pads. The port's AR step collects and gathers; a test below holds it
to ``generate_ar`` where the JAX AR engine misses it.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import spec_decode as jax_sd
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models.config import ModelConfig as JaxModelConfig
from repro.serving.config import EngineConfig as JaxEngineConfig
from repro.serving.engine import Engine as JaxEngine
from repro_torch.configs import get_config
from repro_torch.core import spec_decode as sd
from repro_torch.interop import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models.config import ModelConfig
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import Engine

HYBRID = dict(name="hybrid-test", arch_type="hybrid", num_layers=4,
              attn_every=2, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
              d_ff=128, vocab_size=512, ssm_state=16, ssm_headdim=32,
              ssm_chunk=8, tie_embeddings=True, max_seq_len=1024,
              source="test")
SMALL = dict(k=4, max_batch=2, max_len=256, kv_block_size=16, kv_dtype="fp32")
MAX_NEW = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_fp32(monkeypatch):
    """Pin the JAX decoder's forwards to fp32 activations for one test."""
    monkeypatch.setattr(jax_sd, "forward",
                        functools.partial(jax_forward, dtype=jnp.float32))


@functools.lru_cache(maxsize=None)
def models(name):
    """(port cfg, port params, JAX cfg, JAX params): target = draft, the
    JAX params from PRNGKey(3) as the JAX package's own SSM tests draw
    them, converted to the port in fp32."""
    if name == "hybrid":
        cfg, jcfg = ModelConfig(**HYBRID), JaxModelConfig(**HYBRID)
    else:
        cfg, jcfg = get_config(name), jax_get_config(name)
    jp = jax_init_params(jax.random.PRNGKey(3), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu",
                           torch.float32)
    return cfg, tp, jcfg, jp


def prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 512, size=n).astype(np.int32) for n in (7, 13, 20)]


def port_tokens(name, **cfg):
    c, tp, _, _ = models(name)
    eng = Engine(tp, c, tp, c, config=EngineConfig(**{**SMALL, **cfg}),
                 device="cpu")
    rids = {eng.submit(p, MAX_NEW): i for i, p in enumerate(prompts())}
    return eng, {rids[x.rid]: x.tokens for x in eng.run()}


def jax_engine_tokens(name, **cfg):
    _, _, jc, jp = models(name)
    eng = JaxEngine(jp, jc, jp, jc, config=JaxEngineConfig(**{**SMALL, **cfg}))
    rids = {eng.submit(p, MAX_NEW): i for i, p in enumerate(prompts())}
    return {rids[x.rid]: np.asarray(x.tokens) for x in eng.run()}


def jax_generate_ar(name):
    _, _, jc, jp = models(name)
    dec = jax_sd.SpecDecoder(jp, jc, jp, jc, k=4, max_len=256)
    return {i: np.asarray(dec.generate_ar(jnp.asarray(p)[None], MAX_NEW)[0][0])
            for i, p in enumerate(prompts())}


def same(got, want):
    return [bool(np.array_equal(got[i], want[i])) for i in sorted(want)]


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
@pytest.mark.parametrize("name", ["tiny-ssm", "hybrid"])
def test_engine_tokens_match_jax(name, layout, jax_fp32):
    """Port PARD == JAX Engine PARD == generate_ar; port AR == port PARD."""
    ar = jax_generate_ar(name)
    jax_pard = jax_engine_tokens(name, mode="pard", kv_layout=layout)
    eng, pard = port_tokens(name, mode="pard", kv_layout=layout)
    _, port_ar = port_tokens(name, mode="ar", kv_layout=layout)
    assert same(jax_pard, ar) == [True] * 3
    assert same(pard, jax_pard) == [True] * 3
    assert same(port_ar, pard) == [True] * 3
    assert all(len(t) == len(p) + MAX_NEW for t, p in
               zip((pard[i] for i in range(3)), prompts()))
    assert eng.mean_accepted() > 1.5          # the target drafts for itself


@pytest.mark.parametrize("name", ["tiny-ssm", "hybrid"])
def test_ar_engine_does_not_copy_the_jax_ar_fault(name, jax_fp32):
    """The JAX AR engine lets prompt-chunk and decode-window pads into the
    recurrent state and misses generate_ar; the port's AR engine (paged
    and contiguous) gives exactly the generate_ar tokens."""
    ar = jax_generate_ar(name)
    jax_ar = jax_engine_tokens(name, mode="ar")
    assert same(jax_ar, ar) != [True] * 3     # the reference's fault
    for layout in ("paged", "contiguous"):
        _, port_ar = port_tokens(name, mode="ar", kv_layout=layout)
        assert same(port_ar, ar) == [True] * 3, layout


def test_layouts_and_prefill_chunks_agree():
    """Paged == contiguous in tokens, steps and acceptance; a wider AR
    prefill chunk changes nothing (pads never reach the state)."""
    e1, paged = port_tokens("hybrid", mode="pard")
    e2, cont = port_tokens("hybrid", mode="pard", kv_layout="contiguous")
    assert same(paged, cont) == [True] * 3
    assert (e1.stats["steps"], e1.stats["accepted"]) == \
        (e2.stats["steps"], e2.stats["accepted"])
    _, ar8 = port_tokens("tiny-ssm", mode="ar")
    _, ar3 = port_tokens("tiny-ssm", mode="ar", prefill_chunk=3)
    assert same(ar8, ar3) == [True] * 3


def test_trees_with_ssm_models_raise():
    ssm_cfg, ssm_p, _, _ = models("tiny-ssm")
    dense = get_config("tiny-target")
    from repro_torch.models import init_params
    dense_p = init_params(dense, 0, "cpu", torch.float32)
    with pytest.raises(NotImplementedError, match="SSM/hybrid target"):
        sd.SpecDecoder(ssm_p, ssm_cfg, ssm_p, ssm_cfg, tree=(2, 1))
    with pytest.raises(NotImplementedError, match="SSM/hybrid draft"):
        sd.SpecDecoder(dense_p, dense, ssm_p, ssm_cfg, tree=(2, 1))


def test_serve_launcher_runs_tiny_ssm(capsys):
    comps = serve.main(["--target", "tiny-ssm", "--draft", "tiny-ssm",
                        "--device", "cpu", "--requests", "3", "--max-new",
                        "8", "--max-batch", "2", "--k", "4"])
    assert len(comps) == 3 and all(c.generated == 8 for c in comps)
    out = capsys.readouterr().out
    assert "mode=pard device=cpu" in out and "capacity=0.00MB" in out
