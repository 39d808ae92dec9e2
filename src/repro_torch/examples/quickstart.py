"""Quickstart of the port: the PARD pipeline end to end on tiny models, as
the JAX package's ``examples/quickstart.py``:

1. train a tiny target and draft LM on the synthetic corpus,
2. adapt the draft into a PARD parallel draft (mask tokens + COD),
3. decode with AR / vanilla SD / PARD and compare tokens/s,
4. check that PARD's output equals AR greedy (losslessness).

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

``QUICKSTART_STEPS`` (default 120) sets the training steps. Steps 3 and 4
run in float32 (params, activations and KV), where greedy speculative
decoding equals AR token for token and the check is asserted; then in
bfloat16, where the share of each row's tokens equal to AR's (bf16) up to
the first divergence is reported, not asserted.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from ..configs import get_config
from ..core.spec_decode import SpecDecoder
from ..data.pipeline import MarkovCorpus
from ..device import resolve_device, synchronize
from ..interop import cast_params
from .pard_adaptation_train import adapt, train_ar

STEPS = 120
MAX_NEW = 48


def first_agreement(a: np.ndarray, b: np.ndarray, p: int) -> float:
    """Mean over rows of the share of the new tokens (past ``p``) of ``a``
    equal to ``b``'s up to the first divergence."""
    shares = []
    for x, y in zip(a[:, p:], b[:, p:]):
        diff = np.nonzero(x != y)[0]
        shares.append((diff[0] if diff.size else len(x)) / len(x))
    return float(np.mean(shares))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    steps = int(os.environ.get("QUICKSTART_STEPS", STEPS))
    device = resolve_device(args.device)

    tc, dc = get_config("tiny-target"), get_config("tiny-draft")
    corpus = MarkovCorpus(vocab_size=tc.vocab_size, seed=0, determinism=3.0)
    print(f"== 1. AR-pretrain target ({tc.num_layers}L/{tc.d_model}d) and "
          f"draft ({dc.num_layers}L/{dc.d_model}d), {steps} steps each ==")
    kw = dict(batch=16, seq=96, warmup=20, log_every=steps, log_fn=None)
    tp, h, _ = train_ar("tiny-target", 0, steps, corpus, device, **kw)
    print(f"   target loss: {h[-1]['loss']:.3f}")
    dp, h, _ = train_ar("tiny-draft", 1, steps, corpus, device, **kw)
    print(f"   draft  loss: {h[-1]['loss']:.3f}")

    print("== 2. PARD adaptation (mask tokens + conditional drop, Alg. 1) ==")
    dp_pard, h, _ = adapt(dp, 4, 0.7, 0.2, True, steps * 2, corpus, device,
                          cfg=dc, batch=16, seq=96, seed=7, warmup=20,
                          log_every=steps * 2, log_fn=None)
    print(f"   adaptation loss: {h[-1]['loss']:.3f} "
          f"(train tokens: {h[-1]['tokens']})")

    prompt = corpus.prompts(np.random.default_rng(5), 4, 16)
    p = prompt.shape[1]
    results = {}
    for dtype, kv in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        print(f"== 3. decode in {kv}: AR vs VSD vs PARD ==")
        t, d, dpp = (cast_params(x, dtype) for x in (tp, dp, dp_pard))
        dec_vsd = SpecDecoder(t, tc, d, dc, k=4, max_len=512,
                              kv_block_size=0, kv_dtype=kv)
        dec_pard = SpecDecoder(t, tc, dpp, dc, k=4, max_len=512,
                               kv_block_size=0, kv_dtype=kv)
        runs = {}
        for name, fn in [
            ("AR+", lambda: dec_vsd.generate_ar(prompt, MAX_NEW)),
            ("VSD", lambda: dec_vsd.generate_spec(prompt, MAX_NEW,
                                                  mode="vsd")),
            ("PARD", lambda: dec_pard.generate_spec(prompt, MAX_NEW,
                                                    mode="pard")),
        ]:
            fn()                                     # warm-up
            synchronize(device)
            t0 = time.perf_counter()
            toks, stats = fn()
            synchronize(device)
            secs = time.perf_counter() - t0
            runs[name] = (toks.cpu().numpy(), secs, stats)
            extra = ""
            if name != "AR+":
                extra = (f"  acceptance={stats.acceptance_rate:.2f}"
                         f"  mean_accepted={stats.mean_accepted:.2f}"
                         f"  draft_fwd/iter="
                         f"{stats.draft_forwards / stats.iterations:.1f}")
            print(f"   {name:5s} {MAX_NEW * 4 / secs:8.1f} tok/s{extra}")
        ar_t, vsd_t, pard_t = (runs[k][1] for k in ("AR+", "VSD", "PARD"))
        print(f"   speedups vs AR+: VSD {ar_t / vsd_t:.2f}x, PARD "
              f"{ar_t / pard_t:.2f}x   (paper: VSD 2.31x, PARD 3.57x on A100)")
        results[kv] = runs

    print("== 4. losslessness ==")
    fp32, bf16 = results["fp32"], results["bf16"]
    same = all(np.array_equal(fp32["AR+"][0], fp32[m][0])
               for m in ("VSD", "PARD"))
    print(f"   fp32: PARD and VSD output identical to AR greedy: {same}")
    for m in ("VSD", "PARD"):
        share = first_agreement(bf16[m][0], bf16["AR+"][0], p)
        print(f"   bf16: share of {m}'s tokens equal to AR's up to the "
              f"first divergence: {share:.3f} (mean of {len(prompt)} rows)")
    if not same:
        raise AssertionError("fp32 speculative output differs from AR "
                             "greedy")
    return results


if __name__ == "__main__":
    main()
