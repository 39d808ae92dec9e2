"""Batched serving with continuous batching in the port: the Engine serves
a stream of ragged requests with AR / VSD / PARD and reports throughput
and latency (the port of the JAX package's ``examples/serve_batched.py``).

  PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
      [--requests 12] [--out artifacts_torch] [--device cpu]

Uses the artifacts of ``repro_torch.examples.pard_adaptation_train`` when
present, seeded random weights otherwise. Serves in float32 (params,
activations, paged KV), where PARD's tokens equal AR's exactly.
"""
from __future__ import annotations

import argparse
import time
import zlib
from pathlib import Path

import numpy as np
import torch

from ..configs import get_config
from ..data.pipeline import MarkovCorpus
from ..device import resolve_device
from ..models import init_params
from ..serving.config import EngineConfig, SamplingParams
from ..serving.engine import Engine
from ..training import checkpoint
from .pard_adaptation_train import DEFAULT_OUT


def load(name: str, arch: str, out, device):
    """(params, cfg): the artifact ``name`` under ``out``, or f32 weights
    seeded from the name where it is missing."""
    cfg = get_config(arch)
    params = init_params(cfg, zlib.crc32(name.encode()) % 2**31, device,
                         torch.float32)
    path = Path(out) / f"{name}.npz"
    if path.exists():
        params = checkpoint.restore(str(path), params)
    return params, cfg


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="artifact directory")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    tp, tc = load("bench-target", "bench-target", args.out, device)
    dp, dc = load("bench-draft", "bench-draft", args.out, device)
    pp, _ = load("pard_k8_r07", "bench-draft", args.out, device)

    corpus = MarkovCorpus(vocab_size=tc.vocab_size, seed=0, determinism=3.0)
    rng = np.random.default_rng(0)
    reqs = [corpus.prompts(rng, 1, int(n_tok))[0]
            for n_tok in rng.integers(8, 24, size=args.requests)]

    outputs = {}
    for mode, dparams in [("ar", dp), ("vsd", dp), ("pard", pp)]:
        cfg = EngineConfig(mode=mode, k=8, max_batch=args.max_batch,
                           max_len=512, kv_dtype="fp32")
        eng = Engine(tp, tc, dparams, dc, config=cfg, device=device)
        for r in reqs:
            eng.submit(r, params=SamplingParams(max_new=args.max_new))
        t0 = time.perf_counter()
        comps = eng.run()
        wall = time.perf_counter() - t0
        total = sum(c.generated for c in comps)
        lats = sorted(c.wall_done - c.wall_submitted for c in comps)
        outputs[mode] = {c.rid: c.tokens for c in comps}
        print(f"{mode:5s} {total:4d} tok in {wall:6.2f}s = "
              f"{total / wall:7.1f} tok/s   p50 latency "
              f"{lats[len(lats) // 2]:.2f}s   steps={eng.stats['steps']}"
              f" target_fwd={eng.stats['target_forwards']}"
              f" draft_fwd={eng.stats['draft_forwards']}"
              f" mean_accepted={eng.mean_accepted():.2f}"
              f" kv_peak={eng.peak_kv_bytes_in_use / 1e6:.2f}MB"
              f"/{eng.kv_capacity_bytes() / 1e6:.2f}MB")

    agree = all(np.array_equal(outputs["ar"][r], outputs["pard"][r])
                for r in outputs["ar"])
    print(f"\nall PARD outputs identical to AR greedy: {agree}")
    return dict(outputs=outputs, agree=agree)


if __name__ == "__main__":
    main()
