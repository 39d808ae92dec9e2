"""Target independence (paper Table 2 / Fig. 2) in the port: ONE
PARD-adapted draft accelerates a whole family of target models, with no
per-target retraining (unlike EAGLE / Medusa heads). The port of the JAX
package's ``examples/target_independence.py``.

  PYTHONPATH=src python -m repro_torch.examples.target_independence \\
      [--out artifacts_torch] [--device cpu]

Reads the artifacts of ``repro_torch.examples.pard_adaptation_train``
(random weights, with a note, where one is missing). Decodes in float32
(params, activations, KV), where the ``lossless`` column (PARD tokens ==
AR tokens) is exact.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path

import numpy as np
import torch

from ..configs import get_config
from ..core.spec_decode import SpecDecoder
from ..data.pipeline import MarkovCorpus
from ..device import resolve_device, synchronize
from ..models import init_params
from ..training import checkpoint
from .pard_adaptation_train import DEFAULT_OUT

TARGETS = ("bench-target", "bench-mid", "bench-draft")
MAX_NEW = 48
K = 8


def load(name: str, arch: str, out, device):
    """(params, cfg) of ``arch``: the artifact ``name`` under ``out`` if it
    exists, else seeded random f32 weights (and a note saying so)."""
    cfg = get_config(arch)
    params = init_params(cfg, 0, device, torch.float32)
    path = Path(out) / f"{name}.npz"
    if path.exists():
        params = checkpoint.restore(str(path), params)
    else:
        print(f"(artifact {name} missing — random weights; run "
              f"repro_torch.examples.pard_adaptation_train for the real "
              f"numbers)")
    return params, cfg


def _timed(fn, device):
    fn()                                          # warm-up
    synchronize(device)
    t0 = time.perf_counter()
    toks, stats = fn()
    synchronize(device)
    return toks.cpu().numpy(), stats, time.perf_counter() - t0


def independence_row(pard_draft, dc, name: str, tp, tc, prompt,
                     device) -> dict:
    """The table's row of target ``name`` (params ``tp``, config ``tc``):
    AR+ and PARD tok/s at draft depth K, the speedup, the acceptance rate,
    mean accepted and whether PARD's tokens equal AR's."""
    dec = SpecDecoder(tp, tc, pard_draft, dc, k=K, max_len=512,
                      kv_block_size=0, kv_dtype="fp32")
    ar, _, t_ar = _timed(lambda: dec.generate_ar(prompt, MAX_NEW), device)
    sp, st, t_sp = _timed(lambda: dec.generate_spec(prompt, MAX_NEW,
                                                    mode="pard"), device)
    n = MAX_NEW * len(prompt)
    return dict(target=name, ar_tok_s=n / t_ar, pard_tok_s=n / t_sp,
                speedup=t_ar / t_sp, acc=st.acceptance_rate,
                mean_accepted=st.mean_accepted,
                lossless=bool(np.array_equal(ar, sp)))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="artifact directory")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    pard_draft, dc = load("pard_k8_r07", "bench-draft", args.out, device)
    corpus = MarkovCorpus(vocab_size=dc.vocab_size, seed=0, determinism=3.0)
    prompt = corpus.prompts(np.random.default_rng(5), 4, 16)

    print("one PARD draft (bench-draft, adapted once) against three "
          "targets:\n")
    print(f"{'target':14s} {'AR+ tok/s':>10s} {'PARD tok/s':>11s} "
          f"{'speedup':>8s} {'acc':>6s} {'lossless':>9s}")
    rows = []
    for name in TARGETS:
        tp, tc = load(name, name, args.out, device)
        r = independence_row(pard_draft, dc, name, tp, tc, prompt, device)
        rows.append(r)
        print(f"{r['target']:14s} {r['ar_tok_s']:10.1f} "
              f"{r['pard_tok_s']:11.1f} {r['speedup']:7.2f}x "
              f"{r['acc']:6.2f} {str(r['lossless']):>9s}")
    print("\npaper (Table 2, one L3.2-1B PARD draft): L3-8B 3.25x, "
          "L3.2-3B 2.81x, L3.2-1B (self) 2.17x")
    return rows


if __name__ == "__main__":
    main()
