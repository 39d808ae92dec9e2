"""The port's optimizer, Trainer, checkpoints and training launcher against
the JAX package.

Both packages get the same numpy inputs: one ``AdamW.update`` fed the same
gradients (atol 1e-6), the clip and ``cosine_schedule``; three steps of
``Trainer.fit`` from the same weights on the same Markov stream, AR and
PARD, in float32 (loss histories within 1e-4 relative); checkpoints
written by one package and read by the other, held to the same cache-free
logits.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.cod import CodConfig as JaxCodConfig
from repro.data.pipeline import MarkovCorpus
from repro.models import attention as jax_attention
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.training import checkpoint as jax_checkpoint
from repro.training import optimizer as jax_optimizer
from repro.training.train_loop import Trainer as JaxTrainer
from repro_torch.configs import get_config
from repro_torch.core.cod import CodConfig
from repro_torch.interop import params_from_numpy, params_to_numpy
from repro_torch.launch import train as launch_train
from repro_torch.models import forward, init_params
from repro_torch.training import checkpoint
from repro_torch.training.optimizer import AdamW, cosine_schedule
from repro_torch.training.train_loop import Trainer


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


def _tree(rng, shapes):
    return {k: (_tree(rng, v) if isinstance(v, dict) else
                [rng.standard_normal(s).astype(np.float32) for s in v]
                if isinstance(v, list) else
                rng.standard_normal(v).astype(np.float32))
            for k, v in shapes.items()}


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(tree.copy())


@pytest.mark.parametrize("scale,schedule", [(1.0, False), (0.01, True)])
def test_adamw_update_matches_jax(scale, schedule):
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 3), "b": {"c": (7,), "d": [(2, 2), (4,)]}}
    params = _tree(rng, shapes)
    state_mu, state_nu = _tree(rng, shapes), _tree(rng, shapes)
    state_nu = jax.tree.map(np.abs, state_nu)
    lr = cosine_schedule(3e-3, 2, 10) if schedule else 3e-3
    jlr = jax_optimizer.cosine_schedule(3e-3, 2, 10) if schedule else 3e-3
    opt, jopt = AdamW(lr=lr), jax_optimizer.AdamW(lr=jlr)
    tparams = _to_torch(params)
    state = opt.init(tparams)._replace(step=3, mu=_to_torch(state_mu),
                                       nu=_to_torch(state_nu))
    jstate = jax_optimizer.AdamWState(jnp.asarray(3, jnp.int32),
                                      jax.tree.map(jnp.asarray, state_mu),
                                      jax.tree.map(jnp.asarray, state_nu))
    jparams = jax.tree.map(jnp.asarray, params)
    for _ in range(2):
        grads = jax.tree.map(lambda x: x * scale, _tree(rng, shapes))
        tparams, state, m = opt.update(_to_torch(grads), state, tparams)
        jparams, jstate, jm = jopt.update(jax.tree.map(jnp.asarray, grads),
                                          jstate, jparams)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                      rel=1e-6)
        assert m["lr"] == pytest.approx(float(jm["lr"]), rel=1e-6)
        for got, want in zip(jax.tree.leaves(params_to_numpy(tparams)),
                             jax.tree.leaves(jparams)):
            np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
        for got, want in zip(jax.tree.leaves(params_to_numpy(state.nu)),
                             jax.tree.leaves(jstate.nu)):
            np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
    assert state.step == int(jstate.step) == 5


def test_adamw_clip_and_quadratic():
    opt = AdamW(lr=0.1, clip_norm=1.0)
    params = {"w": torch.zeros(3)}
    _, _, m = opt.update({"w": torch.tensor([100.0, 0.0, 0.0])},
                         opt.init(params), params)
    assert float(m["grad_norm"]) == pytest.approx(100.0)
    assert float(params["w"][0]) == pytest.approx(-0.1, rel=1e-4)  # clipped
    opt = AdamW(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init(params)
    for _ in range(200):
        params, state, _ = opt.update({"w": 2 * params["w"]}, state, params)
    assert float(params["w"].abs().max()) < 1e-2


def test_cosine_schedule_matches_jax():
    f, jf = cosine_schedule(1.0, 10, 100), jax_optimizer.cosine_schedule(
        1.0, 10, 100)
    for step in (0, 1, 5, 10, 11, 50, 99, 100, 130):
        assert f(step) == pytest.approx(float(jf(jnp.asarray(step))),
                                        rel=1e-6, abs=1e-7)
    assert f(100) == pytest.approx(0.1)


def _trainer_pair(kind):
    cfg, jcfg = get_config("tiny-draft"), jax_get_config("tiny-draft")
    cod = (4, 0.7, 0.2)
    tr = Trainer(cfg, AdamW(lr=cosine_schedule(3e-3, 2, 3)), loss_kind=kind,
                 cod=CodConfig(*cod), device="cpu")
    jtr = JaxTrainer(jcfg, jax_optimizer.AdamW(
        lr=jax_optimizer.cosine_schedule(3e-3, 2, 3)), loss_kind=kind,
        cod=JaxCodConfig(*cod))
    return cfg, jcfg, tr, jtr


@pytest.mark.parametrize("kind", ["ar", "pard"])
def test_trainer_histories_match_jax(kind):
    cfg, jcfg, tr, jtr = _trainer_pair(kind)
    jp = jax.tree.map(np.asarray, jax_init_params(jax.random.PRNGKey(4),
                                                  jcfg))
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
    assert hist[0]["lr"] < hist[1]["lr"]                  # in the warmup
    for got, want in zip(jax.tree.leaves(params_to_numpy(tparams)),
                         jax.tree.leaves(jparams)):
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


def test_trainer_raises_outside_the_slice():
    cfg = get_config("tiny-draft")
    with pytest.raises(NotImplementedError):
        Trainer(cfg, AdamW(), mesh=object(), device="cpu")
    with pytest.raises(ValueError):
        Trainer(cfg, AdamW(), loss_kind="eagle", device="cpu")
    with pytest.raises(NotImplementedError):
        launch_train.main(["--arch", "tiny-draft", "--model-parallel", "2",
                           "--device", "cpu"])


def _logits_both(jp, tparams, tokens):
    cfg, jcfg = get_config("tiny-draft"), jax_get_config("tiny-draft")
    got, _ = forward(tparams, cfg, torch.from_numpy(tokens),
                     dtype=torch.float32)
    want, _, _ = jax_forward(jp, jcfg, jnp.asarray(tokens), dtype=jnp.float32)
    return got.numpy(), np.asarray(want)


def test_checkpoints_cross_packages(tmp_path):
    cfg, jcfg = get_config("tiny-draft"), jax_get_config("tiny-draft")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 17))
    like = init_params(cfg, 0, "cpu", torch.float32)

    # JAX save -> port restore
    jp = jax_init_params(jax.random.PRNGKey(5), jcfg)
    path = os.path.join(tmp_path, "jax.npz")
    jax_checkpoint.save(path, jp, metadata={"step": 3})
    tparams = checkpoint.restore(path, like)
    assert checkpoint.load_metadata(path) == {"step": 3}
    got, want = _logits_both(jp, tparams, tokens)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)

    # port save -> JAX restore
    mine = init_params(cfg, 7, "cpu", torch.float32)
    path = os.path.join(tmp_path, "port")
    checkpoint.save(path, mine, metadata={"arch": "tiny-draft"})
    jrest = jax_checkpoint.restore(path, jp)
    assert jax_checkpoint.load_metadata(path) == {"arch": "tiny-draft"}
    got, want = _logits_both(jrest, mine, tokens)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    for a, b in zip(jax.tree.leaves(params_to_numpy(mine)),
                    jax.tree.leaves(jrest)):
        np.testing.assert_array_equal(a, np.asarray(b))

    # bf16 params widen exactly and restore into bf16 leaves
    half = init_params(cfg, 8, "cpu", torch.bfloat16)
    checkpoint.save(path, half)
    back = checkpoint.restore(path, half)
    for a, b in zip(jax.tree.leaves(params_to_numpy(half)),
                    jax.tree.leaves(params_to_numpy(back))):
        np.testing.assert_array_equal(a, b)
    bad = dict(like, final_norm={"scale": torch.zeros(3)})
    with pytest.raises(ValueError):
        checkpoint.restore(path, bad)


def test_launch_train_runs_and_writes_a_checkpoint(tmp_path, capsys):
    out = os.path.join(tmp_path, "draft.npz")
    hist = launch_train.main(["--arch", "tiny-draft", "--pard", "--k", "3",
                              "--steps", "2", "--batch", "2", "--seq", "24",
                              "--device", "cpu", "--out", out])
    assert len(hist) == 2 and np.isfinite(hist[-1]["loss"])
    assert "loss_subtask_3" in hist[-1]
    meta = jax_checkpoint.load_metadata(out)
    assert meta["pard"] and meta["final_loss"] == hist[-1]["loss"]
    assert "saved" in capsys.readouterr().out


def test_step_events_and_launcher_dtype():
    flags = ["--arch", "tiny-draft", "--steps", "2", "--device", "cpu"]
    args = launch_train.build_parser().parse_args(flags)
    cfg = get_config("tiny-draft")
    assert launch_train.make_trainer(args, cfg, "cpu").dtype == torch.float32
    args = launch_train.build_parser().parse_args(flags + ["--dtype",
                                                           "bfloat16"])
    tr = launch_train.make_trainer(args, cfg, "cpu")
    assert tr.dtype == torch.bfloat16

    order = []

    class Mark:
        def __init__(self, i):
            self.i = i

        def record(self):
            order.append(self.i)

    params = init_params(cfg, 0, "cpu", torch.float32)
    batch = tr.make_batch(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 16)))
    _, _, m = tr.step(params, tr.init_state(params), batch,
                      events=[Mark(i) for i in range(4)])
    assert order == [0, 1, 2, 3] and np.isfinite(float(m["loss"]))
    assert all(p.grad is None for p in jax.tree.leaves(
        params, is_leaf=lambda x: isinstance(x, torch.Tensor)))
