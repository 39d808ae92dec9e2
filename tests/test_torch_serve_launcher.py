"""The port's serve launcher against the JAX launcher: the prompts it
serves, and the checkpoints it restores.

The JAX launcher (``repro.launch.serve.main``) runs with its ``Engine``
replaced by a recorder that keeps each submitted prompt and stops the run
at ``run()``; the port's ``workload`` must give the same prompts, token
for token, for the same flags. A checkpoint written by JAX's
``checkpoint.save`` is served through ``--target-ckpt`` / ``--draft-ckpt``
and through an engine built directly on the restored weights.
"""
import os
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import serve as jax_serve
from repro.models import init_params as jax_init_params
from repro.serving import engine as jax_engine
from repro.training import checkpoint as jax_checkpoint
from repro_torch.configs import get_config
from repro_torch.interop import params_to_numpy
from repro_torch.launch import serve
from repro_torch.models import init_params
from repro_torch.serving.config import EngineConfig
from repro_torch.serving.engine import Engine
from repro_torch.training import checkpoint


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Stop(Exception):
    pass


def jax_submitted(monkeypatch, flags):
    """The prompts the JAX launcher submits for ``flags``, in order."""
    prompts = []

    class Recorder:
        def __init__(self, *a, **k):
            pass

        def submit(self, prompt, params=None):
            prompts.append(np.asarray(prompt))

        def run(self):
            raise _Stop

    monkeypatch.setattr(jax_engine, "Engine", Recorder)
    monkeypatch.setattr(sys, "argv", ["serve", "--target", "tiny-target",
                                      "--mode", "ar"] + flags)
    with pytest.raises(_Stop):
        jax_serve.main()
    return prompts


@pytest.mark.parametrize("flags", [
    ["--requests", "5", "--prompt-len", "12", "--seed", "3"],
    ["--requests", "5", "--prompt-len", "20", "--prefix-share", "2"],
    ["--requests", "6", "--prompt-len", "9", "--prefix-share", "3",
     "--seed", "1"],
], ids=["unique", "share2", "share3"])
def test_workload_equals_the_jax_launchers_prompts(monkeypatch, flags):
    want = jax_submitted(monkeypatch, flags)
    args = serve.build_parser().parse_args(["--target", "tiny-target"]
                                           + flags)
    got = serve.workload(args, get_config("tiny-target").vocab_size)
    assert len(got) == len(want) == args.requests
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if args.prefix_share > 1:
        share = args.prefix_share
        assert all(len(p) == args.prompt_len + 8 for p in got)
        np.testing.assert_array_equal(got[0][:args.prompt_len],
                                      got[-(-args.requests // share)]
                                      [:args.prompt_len])


def test_checkpoints_restore_into_the_launcher(tmp_path):
    """JAX-written checkpoints served through the flags give the tokens of
    an engine built on the restored weights directly; the restored leaves
    are the JAX leaves in the launcher's bf16."""
    paths = {}
    for name, seed in (("tiny-target", 5), ("tiny-draft", 6)):
        jp = jax_init_params(jax.random.PRNGKey(seed), jax_get_config(name))
        paths[name] = os.path.join(tmp_path, f"{name}.npz")
        jax_checkpoint.save(paths[name], jp)
        paths[name, "jax"] = jp
    flags = ["--target", "tiny-target", "--draft", "tiny-draft",
             "--target-ckpt", paths["tiny-target"],
             "--draft-ckpt", paths["tiny-draft"], "--device", "cpu",
             "--requests", "3", "--max-new", "6", "--max-len", "128",
             "--k", "4", "--seed", "2"]
    comps = serve.main(flags)

    args = serve.build_parser().parse_args(flags)
    tc, dc = get_config("tiny-target"), get_config("tiny-draft")
    tp = checkpoint.restore(paths["tiny-target"],
                            init_params(tc, 2, "cpu", torch.bfloat16))
    dp = checkpoint.restore(paths["tiny-draft"],
                            init_params(dc, 3, "cpu", torch.bfloat16))
    for got, want in zip(jax.tree.leaves(params_to_numpy(tp)),
                         jax.tree.leaves(paths["tiny-target", "jax"])):
        want = torch.from_numpy(np.array(want)).to(torch.bfloat16).float()
        np.testing.assert_array_equal(got, want.numpy())
    eng = Engine(tp, tc, dp, dc, config=EngineConfig.from_args(args),
                 device="cpu")
    for p in serve.workload(args, tc.vocab_size):
        eng.submit(p, args.max_new)
    direct = {c.rid: c.tokens for c in eng.run()}
    assert len(comps) == 3
    for c in comps:
        np.testing.assert_array_equal(c.tokens, direct[c.rid])
