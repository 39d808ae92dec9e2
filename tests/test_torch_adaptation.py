"""The port's cache-free forward and training losses against the JAX package.

Weights come from the JAX package's ``init_params`` (tiny-draft, 2 layers,
GQA 2/1, head dim 32) and cross through ``interop.params_from_numpy``;
tokens come from the Markov corpus and COD batches from ``pack_batch``.
Both sides run in float32 (the JAX forward on its default jnp backend).
Bars: logits atol 1e-4; loss values rel 1e-5; every gradient leaf atol
1e-5 / rtol 1e-4 (float32 sums in different orders over a 512-way
softmax and two layers).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import adaptation as jax_adaptation
from repro.core.cod import CodConfig as JaxCodConfig
from repro.core.cod import pack_batch as jax_pack_batch
from repro.data.pipeline import MarkovCorpus
from repro.models import attention as jax_attention
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models.attention import PardMaskInfo as JaxPardMaskInfo
from repro_torch.configs import get_config
from repro_torch.core import adaptation
from repro_torch.core.cod import CodConfig, pack_batch
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.kernels.pard_attention import PardMaskInfo
from repro_torch.models import forward

GRAD_TOL = dict(atol=1e-5, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jnp_backend():
    prev = jax_attention._BACKEND
    jax_attention.set_attention_backend("xla")
    yield
    jax_attention.set_attention_backend(prev)


def _params(name, seed):
    jp = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(seed),
                                                  jax_get_config(name)))
    return jp, params_from_numpy(jp, get_config(name), "cpu", torch.float32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _flat(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree)
                for k, v in _flat(x, f"{prefix}/#{i}").items()}
    return {prefix: np.asarray(tree)}


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_grads(v) for v in tree]
    return tree.grad


def _with_grad(tree):
    if isinstance(tree, dict):
        return {k: _with_grad(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_with_grad(v) for v in tree]
    return tree.requires_grad_(True)


def _assert_grads(port_params, jax_grads):
    got = _flat(params_to_numpy(_grads(port_params)))
    want = _flat(jax.tree.map(np.asarray, jax_grads))
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                   **GRAD_TOL)


def _cod_batch(cfg_name, b, n, k, seed):
    cfg = jax_get_config(cfg_name)
    tokens = MarkovCorpus(cfg.vocab_size, seed=0).sample(
        np.random.default_rng(seed), b, n)
    packed = jax_pack_batch(tokens, JaxCodConfig(k, 0.7, 0.2),
                            cfg.mask_token_id, seed=seed)
    packed.pop("n_tokens")
    return tokens, packed


@pytest.mark.parametrize("name", ["tiny-draft", "tiny-target"])
def test_cache_free_forward_matches_jax(name):
    jp, tp = _params(name, 0)
    cfg, jcfg = get_config(name), jax_get_config(name)
    tokens, packed = _cod_batch(name, 2, 20, 4, 1)
    got, caches = forward(tp, cfg, torch.from_numpy(tokens),
                          dtype=torch.float32)
    assert caches is None
    want, _, _ = jax_forward(jp, jcfg, jnp.asarray(tokens), dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    info = PardMaskInfo(torch.from_numpy(packed["segment"]),
                        torch.from_numpy(packed["base"]))
    got, _ = forward(tp, cfg, torch.from_numpy(packed["input_ids"]),
                     torch.from_numpy(packed["position_ids"]),
                     mask_info=info, dtype=torch.float32)
    want, _, _ = jax_forward(
        jp, jcfg, jnp.asarray(packed["input_ids"]),
        positions=jnp.asarray(packed["position_ids"]),
        mask_info=JaxPardMaskInfo(jnp.asarray(packed["segment"]),
                                  jnp.asarray(packed["base"])),
        dtype=jnp.float32)
    live = packed["segment"] > 0               # the oracle's padding rows are garbage
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("k,per_subtask_norm", [(4, True), (8, True),
                                                (4, False)])
def test_pard_loss_and_grads_match_jax(k, per_subtask_norm):
    jp, tp = _params("tiny-draft", 1)
    cfg, jcfg = get_config("tiny-draft"), jax_get_config("tiny-draft")
    _, packed = _cod_batch("tiny-draft", 3, 40, k, k)
    (want, jm), jgrads = jax.value_and_grad(
        jax_adaptation.pard_adaptation_loss, has_aux=True)(
        jp, jcfg, {n: jnp.asarray(v) for n, v in packed.items()}, k_max=k,
        per_subtask_norm=per_subtask_norm, dtype=jnp.float32)
    tp = _with_grad(tp)
    loss, metrics = adaptation.pard_adaptation_loss(
        tp, cfg, {n: torch.from_numpy(v) for n, v in packed.items()},
        k_max=k, per_subtask_norm=per_subtask_norm, dtype=torch.float32)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    assert set(metrics) == set(jm) - {"load_balance_loss"}
    for name, value in metrics.items():
        assert float(value) == pytest.approx(float(jm[name]), rel=1e-5), name
    _assert_grads(tp, jgrads)


def test_ar_loss_and_grads_match_jax():
    jp, tp = _params("tiny-draft", 2)
    cfg, jcfg = get_config("tiny-draft"), jax_get_config("tiny-draft")
    tokens, _ = _cod_batch("tiny-draft", 3, 33, 4, 2)
    (want, jm), jgrads = jax.value_and_grad(jax_adaptation.ar_loss,
                                            has_aux=True)(
        jp, jcfg, jnp.asarray(tokens), dtype=jnp.float32)
    tp = _with_grad(tp)
    loss, metrics = adaptation.ar_loss(tp, cfg, torch.from_numpy(tokens),
                                       dtype=torch.float32)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    assert float(metrics["nll"]) == pytest.approx(float(jm["nll"]), rel=1e-5)
    _assert_grads(tp, jgrads)


def test_subtask1_loss_equals_ar_loss():
    """Eq. 8's subtask 1 is exactly the AR objective: the real tokens of a
    packed COD batch see only their own prefix."""
    cfg = get_config("tiny-draft")
    _, tp = _params("tiny-draft", 1)
    tokens = MarkovCorpus(cfg.vocab_size, seed=0).sample(
        np.random.default_rng(0), 4, 48)
    l_ar, _ = adaptation.ar_loss(tp, cfg, torch.from_numpy(tokens),
                                 dtype=torch.float32)
    packed = pack_batch(tokens, CodConfig(k=4, r=0.7, r_min=0.2),
                        cfg.mask_token_id, seed=0)
    batch = {n: torch.from_numpy(v) for n, v in packed.items()
             if n != "n_tokens"}
    _, metrics = adaptation.pard_adaptation_loss(tp, cfg, batch, k_max=4,
                                                 dtype=torch.float32)
    assert float(metrics["loss_subtask_1"]) == pytest.approx(float(l_ar),
                                                             rel=1e-5)


def test_remat_gives_the_same_loss_and_grads():
    cfg = get_config("tiny-draft")
    _, packed = _cod_batch("tiny-draft", 2, 24, 4, 5)
    batch = {n: torch.from_numpy(v) for n, v in packed.items()}
    out = []
    for remat in (False, True):
        _, tp = _params("tiny-draft", 3)
        tp = _with_grad(tp)
        loss, _ = adaptation.pard_adaptation_loss(tp, cfg, batch, k_max=4,
                                                  dtype=torch.float32,
                                                  remat=remat)
        loss.backward()
        out.append((float(loss.detach()), _flat(params_to_numpy(_grads(tp)))))
    assert out[0][0] == out[1][0]
    for key, g in out[0][1].items():
        np.testing.assert_array_equal(g, out[1][1][key], err_msg=key)
