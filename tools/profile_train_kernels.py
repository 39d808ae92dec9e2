#!/usr/bin/env python3
"""Device time of the training-attention kernels, split by CUDA kernel.

  PYTHONPATH=src python3 tools/profile_train_kernels.py [--seed 0] [--iters 5]

At the training shapes of ``chip_smoke.py`` phase 8 (bf16, B=4, Hq=32,
Hkv=8, D=64; ``flash_attention`` causal at T=1024, ``pard_attention`` on a
``pack_batch`` COD layout of N=512 at K=8, r=0.7, r_min=0.2), runs the
forward and the backward wrapper once to build and warm them, then
``--iters`` more times under ``torch.profiler`` (CUDA activity). Prints
each CUDA kernel's mean device time per call (the backward's delta, dK/dV
and dQ passes apart) and one JSON line of the same.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iters", type=int, default=5)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_train_kernels: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.cod import CodConfig, pack_batch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import pard_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    b, hq, hkv, d = 4, 32, 8, 64

    def rnd(t, h):
        return torch.randn(b, t, h, d, generator=gen, device="cuda").to(
            torch.bfloat16)

    packed = pack_batch(rng.integers(0, 128000, (b, 512)),
                        CodConfig(8, 0.7, 0.2), 128256, seed=args.seed)
    info = pa.PardMaskInfo(*(torch.from_numpy(packed[f]).to("cuda", torch.int32)
                             for f in ("segment", "base")))
    runs = {}
    for kind, t in (("flash", 1024), ("pard", info.segment.shape[1])):
        q, k, v, dout = rnd(t, hq), rnd(t, hkv), rnd(t, hkv), rnd(t, hq)
        if kind == "flash":
            def fwd():
                return fa.flash_attention_fwd(q, k, v)

            def bwd(o, lse):
                return fa.flash_attention_bwd(q, k, v, o, lse, dout)
        else:
            _ = info.tiles              # made once per batch, as in training

            def fwd():
                return pa.pard_attention_fwd(q, k, v, info)

            def bwd(o, lse):
                return pa.pard_attention_bwd(q, k, v, info, o, lse, dout)
        bwd(*fwd())
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.iters):
                bwd(*fwd())
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            us = float(getattr(e, "device_time_total", 0.0)
                       or getattr(e, "cuda_time_total", 0.0))
            if us > 0:
                rows.append({"kernel": e.key[:160], "calls": e.count,
                             "us_per_call": us / e.count})
        rows.sort(key=lambda r: -r["us_per_call"] * r["calls"])
        print(f"{kind} B={b} T={t} Hq={hq} Hkv={hkv} D={d} bf16, "
              f"{torch.cuda.get_device_name(0)}:")
        for r in rows:
            print(f"  {r['us_per_call']:9.1f} us  x{r['calls']:<3d} "
                  f"{r['kernel'][:110]}")
        runs[kind] = rows
    print(json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
