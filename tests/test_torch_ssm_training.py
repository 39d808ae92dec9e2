"""Mamba2 and dense-hybrid training in the port on the CPU against the JAX
package, and the refusal of COD on models with SSM layers.

Both packages start from the same weights (the JAX init, converted) and
read the same Markov stream: three AR steps of ``Trainer.fit`` on tiny-ssm
and on a dense hybrid in float32 (metrics within 1e-4 relative, params to
1e-4 but where AdamW's first update is decided by float32 noise), as
``tests/test_torch_training.py`` holds the dense models; one step's
gradients within 1e-5 of each leaf's largest;
``remat`` gives the gradients of the plain forward; the launcher's
tiny-ssm checkpoint restores in JAX to the same logits. COD packs a
sequence's real tokens and its mask tokens into one row and only the
attention mask keeps them apart: the JAX package's packed forward lets a
later real token (a label) move a mask token's logits on tiny-ssm, not on
tiny-draft, so the port refuses PARD adaptation of any model with SSM
layers.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.adaptation import ar_loss as jax_ar_loss
from repro.core.cod import CodConfig as JaxCodConfig
from repro.core.cod import pack_batch as jax_pack_batch
from repro.data.pipeline import MarkovCorpus
from repro.models import attention as jax_attention
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models.attention import PardMaskInfo as JaxPardMaskInfo
from repro.models.config import ModelConfig as JaxModelConfig
from repro.training import checkpoint as jax_checkpoint
from repro.training import optimizer as jax_optimizer
from repro.training.train_loop import Trainer as JaxTrainer
from repro_torch.configs import get_config
from repro_torch.core.adaptation import pard_adaptation_loss
from repro_torch.core.cod import CodConfig, pack_batch
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch import train as launch_train
from repro_torch.models import forward
from repro_torch.models.config import ModelConfig
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import AdamW, cosine_schedule, leaves
from repro_torch.training.train_loop import Trainer

# a dense hybrid: attention every second layer, dense MLPs everywhere
HYBRID = dict(name="hybrid-test", arch_type="hybrid", num_layers=4,
              attn_every=2, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
              d_ff=128, vocab_size=512, ssm_state=16, ssm_headdim=32,
              ssm_chunk=8, tie_embeddings=True, max_seq_len=1024,
              source="test")
COD = (4, 0.7, 0.2)


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


def configs(name):
    if name == "hybrid":
        return ModelConfig(**HYBRID), JaxModelConfig(**HYBRID)
    return get_config(name), jax_get_config(name)


def jax_weights(jcfg, seed=4):
    return jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(seed),
                                                    jcfg))


@pytest.mark.parametrize("name", ["tiny-ssm", "hybrid"])
def test_trainer_histories_match_jax(name):
    cfg, jcfg = configs(name)
    jp = jax_weights(jcfg)
    tr = Trainer(cfg, AdamW(lr=cosine_schedule(3e-3, 2, 3)), device="cpu")
    jtr = JaxTrainer(jcfg, jax_optimizer.AdamW(
        lr=jax_optimizer.cosine_schedule(3e-3, 2, 3)))
    corpus = MarkovCorpus(vocab_size=cfg.vocab_size, seed=0, determinism=2.0)
    tparams, _, hist = tr.fit(params_from_numpy(jp, cfg), corpus.batches(
        4, 40, seed=1), 3, log_every=1, log_fn=None)
    jparams, _, jhist = jtr.fit(jax.tree.map(jnp.asarray, jp),
                                corpus.batches(4, 40, seed=1), 3,
                                log_every=1, log_fn=None)
    assert [h["step"] for h in hist] == [1, 2, 3]
    for h, jh in zip(hist, jhist):
        assert h["tokens"] == jh["tokens"]
        for key in jh:
            if key in ("wall", "load_balance_loss"):
                continue
            assert h[key] == pytest.approx(jh[key], rel=1e-4, abs=1e-7), key
    assert hist[-1]["loss"] < hist[0]["loss"]
    # AdamW's first update of an entry is lr g / (|g| + 1e-8): where the
    # first gradient lies below float32 noise (1e-5 of its leaf's largest,
    # the gradients' agreement in test_first_gradients_match_jax) the two
    # packages may move it anywhere within 2 lr a step (the hybrid has one
    # such entry, |g| = 1.1e-9 in an MLP's wo); every other entry to 1e-4
    toks = jnp.asarray(next(corpus.batches(4, 40, seed=1)))
    g1 = jax.grad(lambda p: jax_ar_loss(p, jcfg, toks, dtype=jnp.float32)[0])(
        jax.tree.map(jnp.asarray, jp))
    moves = 2 * sum(cosine_schedule(3e-3, 2, 3)(i) for i in range(3))
    for got, want, g in zip(jax.tree.leaves(params_to_numpy(tparams)),
                            jax.tree.leaves(jparams), jax.tree.leaves(g1)):
        g = np.abs(np.asarray(g))
        noise = (g > 0) & (g < 1e-5 * g.max())    # 0: an unseen token
        assert noise.mean() < 1e-2
        want = np.asarray(want)
        np.testing.assert_allclose(got[~noise], want[~noise], atol=1e-4)
        assert (np.abs(got - want)[noise] <= moves).all()


@pytest.mark.parametrize("name", ["tiny-ssm", "hybrid"])
def test_first_gradients_match_jax(name):
    """One AR step's gradients of every leaf against ``jax.grad`` of the
    JAX loss: max |dg| <= 1e-5 max |g| per leaf (float32 sums in another
    order)."""
    cfg, jcfg = configs(name)
    jp = jax_weights(jcfg)
    toks = next(MarkovCorpus(vocab_size=cfg.vocab_size, seed=0,
                             determinism=2.0).batches(4, 40, seed=1))
    params = params_from_numpy(jp, cfg)
    tr = Trainer(cfg, AdamW(), device="cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    tr.loss(params, {"tokens": torch.from_numpy(toks)})[0].backward()
    want = jax.grad(lambda p: jax_ar_loss(p, jcfg, jnp.asarray(toks),
                                          dtype=jnp.float32)[0])(
        jax.tree.map(jnp.asarray, jp))
    for p, w in zip(leaves(params), jax.tree.leaves(want)):
        w = np.asarray(w)
        assert np.abs(p.grad.numpy() - w).max() <= 1e-5 * np.abs(w).max()


@pytest.mark.parametrize("name", ["tiny-ssm", "hybrid"])
def test_remat_gives_the_same_gradients(name):
    cfg, jcfg = configs(name)
    params = params_from_numpy(jax_weights(jcfg, seed=2), cfg)
    tokens = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 33)))
    grads = []
    for remat in (False, True):
        tr = Trainer(cfg, AdamW(), remat=remat, device="cpu")
        for p in leaves(params):
            p.requires_grad_(True)
            p.grad = None
        tr.loss(params, {"tokens": tokens})[0].backward()
        grads.append([p.grad.clone() for p in leaves(params)])
    for p in leaves(params):
        p.requires_grad_(False)
        p.grad = None
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_launch_train_tiny_ssm_checkpoint_restores_in_jax(tmp_path):
    cfg, jcfg = configs("tiny-ssm")
    out = os.path.join(tmp_path, "ssm.npz")
    hist = launch_train.main(["--arch", "tiny-ssm", "--steps", "2", "--batch",
                              "2", "--seq", "24", "--device", "cpu", "--out",
                              out])
    assert len(hist) == 2 and np.isfinite(hist[-1]["loss"])
    assert jax_checkpoint.load_metadata(out)["arch"] == "tiny-ssm"
    jp = jax_checkpoint.restore(out, jax_init_params(jax.random.PRNGKey(0),
                                                     jcfg))
    tp = checkpoint.restore(out, params_from_numpy(jax_weights(jcfg), cfg))
    for a, b in zip(jax.tree.leaves(params_to_numpy(tp)),
                    jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 17))
    got, _ = forward(tp, cfg, torch.from_numpy(tokens), dtype=torch.float32)
    want, _, _ = jax_forward(jp, jcfg, jnp.asarray(tokens), dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("name", ["tiny-ssm", "hybrid"])
def test_cod_refused_on_models_with_ssm_layers(name):
    cfg, jcfg = configs(name)
    params = params_from_numpy(jax_weights(jcfg), cfg)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 24))
    batch = {k: torch.from_numpy(v) for k, v in pack_batch(
        tokens, CodConfig(*COD), cfg.mask_token_id, seed=0).items()
        if k != "n_tokens"}
    with pytest.raises(ValueError, match="SSM"):
        pard_adaptation_loss(params, cfg, batch, k_max=COD[0],
                             dtype=torch.float32)
    with pytest.raises(ValueError, match="SSM"):
        Trainer(cfg, AdamW(), loss_kind="pard", cod=CodConfig(*COD),
                device="cpu")
    Trainer(cfg, AdamW(), loss_kind="ar", device="cpu")     # AR stays
    if name == "tiny-ssm":
        with pytest.raises(ValueError, match="SSM"):
            launch_train.main(["--arch", name, "--pard", "--steps", "1",
                               "--device", "cpu"])


def _mask_token_logits(name, tokens, last):
    """The JAX package's packed COD forward (tiny-ssm or tiny-draft, fp32):
    logits of the first segment-2 (mask) token, with the last real token
    set to ``last``."""
    jcfg = jax_get_config(name)
    jp = jax_init_params(jax.random.PRNGKey(0), jcfg)
    toks = tokens.copy()
    toks[-1] = last
    packed = jax_pack_batch(toks[None], JaxCodConfig(*COD),
                            jcfg.mask_token_id, seed=0)
    seg = packed["segment"][0]
    n = len(tokens)
    assert (seg[:n] == 1).all()
    assert packed["input_ids"][0, n - 1] == last  # real tokens come first
    first = int(np.nonzero(seg == 2)[0][0])
    assert packed["base"][0, first] < n - 1       # it must not see token n-1
    logits, _, _ = jax_forward(
        jp, jcfg, jnp.asarray(packed["input_ids"]),
        positions=jnp.asarray(packed["position_ids"]),
        mask_info=JaxPardMaskInfo(jnp.asarray(packed["segment"]),
                                  jnp.asarray(packed["base"])),
        dtype=jnp.float32)
    return np.asarray(logits[0, first])


def test_jax_cod_leaks_labels_into_ssm_mask_tokens():
    """The fault the refusal avoids: in the JAX package, changing the last
    real token of a packed row moves the logits of the first mask token
    (whose base lies before it) on tiny-ssm, whose recurrence ignores the
    COD mask; on tiny-draft the attention mask keeps them equal."""
    tokens = np.random.default_rng(0).integers(0, 512, 24)
    other = (int(tokens[-1]) + 1) % 512
    moved = {name: np.abs(_mask_token_logits(name, tokens, tokens[-1])
                          - _mask_token_logits(name, tokens, other)).max()
             for name in ("tiny-ssm", "tiny-draft")}
    assert moved["tiny-ssm"] > 0.1, moved
    assert moved["tiny-draft"] == 0.0, moved
