"""The port's examples (``repro_torch.examples``) end to end on the CPU.

``pard_adaptation_train --quick`` writes every run of ``AR_RUNS`` and
``PARD_RUNS``, the EAGLE head and the manifest; the JAX package's
``checkpoint.restore`` reads each file into its own ``init_params`` /
``init_eagle`` tree, leaf for leaf what the port restores; a second run
skips every artifact. ``target_independence`` and ``serve_batched`` read
the artifacts and report PARD == AR; ``quickstart`` at a few training
steps passes its fp32 losslessness assertion.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import eagle as jax_eagle
from repro.models import init_params as jax_init_params
from repro.training import checkpoint as jax_checkpoint
from repro_torch.configs import get_config
from repro_torch.core.eagle import init_eagle
from repro_torch.examples import (pard_adaptation_train, quickstart,
                                  serve_batched, target_independence)
from repro_torch.interop import params_to_numpy
from repro_torch.models import init_params
from repro_torch.training import checkpoint

RUNS = ([n for n, _ in pard_adaptation_train.AR_RUNS]
        + [r[0] for r in pard_adaptation_train.PARD_RUNS] + ["eagle_head"])


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("artifacts_torch"))
    manifest = pard_adaptation_train.main(["--quick", "--out", out,
                                           "--device", "cpu"])
    return out, manifest


def test_quick_recipe_writes_every_artifact(artifacts, capsys):
    out, manifest = artifacts
    assert sorted(manifest["runs"]) == sorted(RUNS)
    assert (manifest["ar_steps"], manifest["pard_steps"]) == (30, 20)
    assert manifest["corpus"] == pard_adaptation_train.CORPUS
    with open(os.path.join(out, "manifest.json")) as f:
        assert json.load(f) == json.loads(json.dumps(manifest))
    for name in RUNS:
        assert os.path.exists(os.path.join(out, f"{name}.npz")), name
        meta = checkpoint.load_metadata(os.path.join(out, f"{name}.npz"))
        assert np.isfinite(meta["loss"]), name
    assert manifest["runs"]["pard_k4_r07"]["cod"] == dict(
        k=4, r=0.7, r_min=0.2, drop=True)
    # a second run trains nothing and reads the same manifest back
    again = pard_adaptation_train.main(["--quick", "--out", out,
                                        "--device", "cpu"])
    text = capsys.readouterr().out
    assert all(f"[skip] {name} (exists)" in text for name in RUNS)
    assert json.loads(json.dumps(again)) == json.loads(json.dumps(manifest))


@pytest.mark.parametrize("name", RUNS)
def test_jax_restores_each_artifact(artifacts, name):
    out, _ = artifacts
    path = os.path.join(out, f"{name}.npz")
    if name == "eagle_head":
        cfg = get_config("bench-target")
        like = jax_eagle.init_eagle(jax.random.PRNGKey(9),
                                    jax_get_config("bench-target"))
        mine = checkpoint.restore(path, init_eagle(cfg, 9, "cpu",
                                                   torch.float32))
    else:
        arch = name if name.startswith("bench-") else "bench-draft"
        like = jax_init_params(jax.random.PRNGKey(0), jax_get_config(arch))
        mine = checkpoint.restore(path, init_params(get_config(arch), 0,
                                                    "cpu", torch.float32))
    theirs = jax_checkpoint.restore(path, like)
    got, want = jax.tree.leaves(params_to_numpy(mine)), jax.tree.leaves(theirs)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_target_independence_reads_the_artifacts(artifacts, capsys, tmp_path):
    out, _ = artifacts
    rows = target_independence.main(["--out", out, "--device", "cpu"])
    text = capsys.readouterr().out
    assert [r["target"] for r in rows] == list(target_independence.TARGETS)
    assert all(r["lossless"] for r in rows)
    assert "missing" not in text and "lossless" in text
    target_independence.load("bench-mid", "bench-mid", str(tmp_path), "cpu")
    assert "(artifact bench-mid missing" in capsys.readouterr().out


def test_serve_batched_reads_the_artifacts(artifacts, capsys):
    out, _ = artifacts
    res = serve_batched.main(["--out", out, "--device", "cpu",
                              "--requests", "4", "--max-new", "8"])
    text = capsys.readouterr().out
    assert res["agree"] and len(res["outputs"]["pard"]) == 4
    assert "all PARD outputs identical to AR greedy: True" in text


def test_quickstart_is_lossless_in_fp32(monkeypatch, capsys):
    monkeypatch.setenv("QUICKSTART_STEPS", "8")
    res = quickstart.main(["--device", "cpu"])
    text = capsys.readouterr().out
    assert "fp32: PARD and VSD output identical to AR greedy: True" in text
    assert "bf16: share of PARD's tokens" in text
    ar = res["fp32"]["AR+"][0]
    assert ar.shape == (4, 16 + quickstart.MAX_NEW)
    assert np.array_equal(res["fp32"]["PARD"][0], ar)
