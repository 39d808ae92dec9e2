#!/usr/bin/env python3
"""Device time of the SSD scan's backward, and which bf16 training route
is nearer the exact gradient, on any tree's kernels.

  python3 tools/ssd_grad_turns.py [--src DIR] [--oracle] [--seed 0]

Builds ``ssd_chunked`` and ``ssd_chunked_bwd`` from the ``repro_torch``
package under ``--src`` (default: this checkout's ``src``) and times
``ssd_chunked_bwd`` at mamba2-130m's training shape (b 4, t 1024, h 24,
P 64, N 128, chunk 64), bf16 and fp32, by device time (one CUDA graph
holding one call per rotating input set, replayed between CUDA events)
and by eager calls, as ``chip_smoke.py`` phase 12 (b) does. With
``--oracle`` it also runs ``chip_smoke.scan_oracle`` on the B=1
mamba2-130m step of phase 12 (c): the step's gradients through the
kernels (bf16 activations), through the plain versions (bf16) and
through the plain versions with f32 activations, the oracle. ``--src``
may name the ``src`` of another tree (a parent unpacked with ``git
archive``), so two versions are compared in one call on one card: run
the script once per tree, in turns. Prints the card's name and power
limit, one line per row, and one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--oracle", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("ssd_grad_turns: no CUDA device", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    sys.path[:0] = [str(src), str(ROOT)]
    import numpy as np

    import chip_smoke as cs
    from repro_torch.kernels import build, ssd

    card = cs.card_line()
    build.build(["ssd_chunked", "ssd_chunked_bwd"])
    cs.log(f"[card] {card}; torch {torch.__version__}; kernels from {src}")
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 31)
    out = {"src": str(src), "card": card}
    for dtype in (torch.bfloat16, torch.float32):
        sets = []
        while not sets or sum(s[0]["x"].numel() * s[0]["x"].element_size()
                              for s in sets) * 2 < cs.COLD_BYTES:
            sets.append(cs._ssd_grad_inputs(torch, gen, "cuda", dtype=dtype,
                                            full=False, **cs.SSD_TRAIN))

        def bwd(s):
            return ssd.ssd_chunked_bwd(*cs._ssd_args(s[0]), s[1], s[2],
                                       chunk=s[0]["chunk"])

        name = str(dtype).split(".")[1]
        out[name] = dict(ms=cs.graph_ms(torch, bwd, sets, 20),
                         eager_ms=cs.time_ms(torch, bwd, sets, 10))
        cs.log(f"[ssd_chunked_bwd] training shape {name}: {out[name]['ms']:.4f}"
               f" ms (eager {out[name]['eager_ms']:.4f}); device time from a "
               f"CUDA graph of {len(sets)} input sets")
        del sets
        torch.cuda.empty_cache()
    if args.oracle:
        from repro_torch.configs import get_config
        from repro_torch.data.pipeline import MarkovCorpus
        from repro_torch.launch import train as launch_train
        from repro_torch.models import init_params

        cfg = get_config(cs.SSM_MODEL)
        n = cs.SSD_TRAIN["t"]
        flags = ["--arch", cs.SSM_MODEL, "--batch", "4", "--seq", str(n),
                 "--seed", str(args.seed), "--lr", str(cs.TRAIN_LR),
                 "--device", "cuda", "--dtype", "bfloat16"]
        tr = launch_train.make_trainer(
            launch_train.build_parser().parse_args(flags), cfg, "cuda")
        params = init_params(cfg, args.seed, "cuda", torch.float32)
        corpus = MarkovCorpus(vocab_size=cfg.vocab_size, seed=0,
                              determinism=2.0)
        one = tr.make_batch(corpus.sample(
            np.random.default_rng(args.seed + 5), 1, n), seed=args.seed)
        out["oracle"] = cs.scan_oracle(torch, tr, params, one)
    cs.log(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
