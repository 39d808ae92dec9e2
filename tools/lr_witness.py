#!/usr/bin/env python3
"""AR training at one peak learning rate, through the port's attention
kernels and through their plain versions, on one CUDA card.

  PYTHONPATH=src python3 tools/lr_witness.py [--arch llama3.2-1b]
      [--lr 3e-3] [--steps 20] [--batch 4] [--seq 1024] [--seed 0]

Both routes start from the same seeded f32 weights, train on the same
``MarkovCorpus`` batches with the trainer of ``repro_torch.launch.train``
(its AdamW and cosine schedule, ``--dtype bfloat16``) and recompute each
layer in the backward pass (``remat``), so that the plain route holds one
layer's [T, T] scores at a time. The plain route points the model's
attention at ``flash_attention_ref``; nothing else differs. Prints the
losses and grad norms of each step of both routes, then one JSON line
with both histories. A loss spike that both routes show belongs to the
optimization, not to the kernels.
"""
from __future__ import annotations

import argparse
import json
import sys


def run(route, args):
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import MarkovCorpus
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as launch_train
    from repro_torch.models import attention as model_attention
    from repro_torch.models import init_params

    cfg = get_config(args.arch)
    flags = ["--arch", args.arch, "--steps", str(args.steps), "--batch",
             str(args.batch), "--seq", str(args.seq), "--lr", str(args.lr),
             "--seed", str(args.seed), "--dtype", "bfloat16"]
    tr = launch_train.make_trainer(launch_train.build_parser().parse_args(flags),
                                   cfg, "cuda")
    tr.remat = True
    params = init_params(cfg, args.seed, "cuda", torch.float32)
    stream = MarkovCorpus(vocab_size=cfg.vocab_size, seed=0,
                          determinism=2.0).batches(args.batch, args.seq,
                                                   seed=args.seed)
    kernels.launches.clear()
    if route == "plain":
        model_attention.flash_attention = fa.flash_attention_ref
    try:
        _, _, hist = tr.fit(params, stream, args.steps, log_every=1,
                            log_fn=None)
    finally:
        model_attention.flash_attention = fa.flash_attention
    torch.cuda.synchronize()
    got = dict(kernels.launches)
    if (route == "plain") == bool(got):
        raise SystemExit(f"{route} route launched {got}")
    del params, tr
    torch.cuda.empty_cache()
    return {"loss": [h["loss"] for h in hist],
            "grad_norm": [h["grad_norm"] for h in hist],
            "launches": got}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("lr_witness: no CUDA device", file=sys.stderr)
        return 2
    out = {route: run(route, args) for route in ("kernels", "plain")}
    print(f"{args.arch} AR, B={args.batch} N={args.seq}, peak lr {args.lr}, "
          f"{torch.cuda.get_device_name(0)}")
    print("step  loss kernels  loss plain  grad_norm kernels  grad_norm plain")
    k, p = out["kernels"], out["plain"]
    for i in range(args.steps):
        print(f"{i + 1:4d}  {k['loss'][i]:12.4f}  {p['loss'][i]:10.4f}  "
              f"{k['grad_norm'][i]:17.4f}  {p['grad_norm'][i]:15.4f}")
    print(json.dumps({"lr": args.lr, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
