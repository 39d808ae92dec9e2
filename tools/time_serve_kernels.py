#!/usr/bin/env python3
"""Device times of the serving kernels: the four attention kernels
beside SDPA, and the Mamba2 scan ssd_chunked.

  python3 tools/time_serve_kernels.py [--src DIR] [--seed 0]

Builds ``decode_attention_paged``, ``decode_attention``,
``tree_attention_paged``, ``tree_attention`` and ``ssd_chunked`` from the
``repro_torch`` package under ``--src`` (default: this checkout's
``src``) and runs ``chip_smoke.py``'s timing phases on them: at the
full-width engine's shapes and at kv 1k-4k, each attention kernel (bf16
K/V, and its int8 and fp8 routes, which a tree older than the 8-bit
routes lacks) and SDPA with its boolean mask, and ssd_chunked at
mamba2-130m's shapes (b 4,
bf16; t = 9, 16 and 2048), by device time (one CUDA graph holding one
call per rotating input set, replayed between CUDA events) and by eager
calls, beside the plain version and the bound. ``--src`` may name the ``src`` of another tree
(a parent unpacked with ``git archive``), so two versions are timed in
one call on one card: run the script once per tree, in turns. Prints the
card's name and power limit, one line per timing row, and one JSON line.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SERVING = ("decode_attention_paged", "decode_attention",
           "tree_attention_paged", "tree_attention", "ssd_chunked")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("time_serve_kernels: no CUDA device", file=sys.stderr)
        return 2
    src = Path(args.src).resolve()
    sys.path[:0] = [str(src), str(ROOT)]
    import torch.nn.functional as F

    import chip_smoke
    from repro_torch.kernels import build

    card = chip_smoke.card_line()
    build.build(list(SERVING))
    chip_smoke.log(f"[card] {card}; torch {torch.__version__}; kernels from "
                   f"{src}")
    ns = argparse.Namespace(seed=args.seed, prompt_len=256, max_new=128)
    timing = chip_smoke.phase_timing(torch, F, ns)
    timing.update(chip_smoke.phase_ssd_timing(torch, ns))
    chip_smoke.log(json.dumps({"src": str(src), "card": card,
                               "timings": timing}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
