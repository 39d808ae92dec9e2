#!/usr/bin/env python3
"""Device-time profile of serving steps of the port on one CUDA card.

  PYTHONPATH=src python3 tools/profile_serve_step.py [--target mamba2-130m]
      [--draft mamba2-130m] [--mode pard|ar] [--layout paged|contiguous]
      [--kv-dtype bf16|fp32|int8|fp8]

Builds an ``Engine`` (EngineConfig defaults: K = 8, max_batch 4) on random
bf16 weights (target from seed 0, draft from seed 1), submits four
random prompts of 256 tokens for 128 new tokens each, and steps it
through ``Engine.run`` until no row prefills. It then times ten decode
steps with CUDA events and profiles three more with ``torch.profiler``
(CPU and CUDA activities). Prints the step times, the device kernels and host ops with
the most self device time, and one JSON line: the run with the card's
name and power limit (``nvidia-smi``), the step p50, the profiled steps'
wall time (CUDA events), the device's busy time in them (the summed time
of kernels, memsets and copies on the one stream) and its share, and the
device operations and kernel launches per step. The profiler slows the
host, so the busy share of unprofiled steps is higher by the ratio of
the two step times.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

REQUESTS = 4          # EngineConfig's max_batch: one row per slot
PROFILED = 3          # steps under the profiler


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--target", default="mamba2-130m")
    ap.add_argument("--draft", default="mamba2-130m")
    ap.add_argument("--mode", choices=["pard", "ar"], default="pard")
    ap.add_argument("--layout", choices=["paged", "contiguous"],
                    default="paged")
    ap.add_argument("--kv-dtype", choices=["bf16", "fp32", "int8", "fp8"],
                    default="bf16")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_serve_step: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving.engine import Engine, EngineConfig

    tc = get_config(args.target)
    tp = init_params(tc, 0, "cuda", torch.bfloat16)
    dc = dp = None
    if args.mode == "pard":
        dc = get_config(args.draft)
        dp = init_params(dc, 1, "cuda", torch.bfloat16)
    eng = Engine(tp, tc, dp, dc, device="cuda",
                 config=EngineConfig(mode=args.mode, kv_layout=args.layout,
                                     kv_dtype=args.kv_dtype))
    rng = np.random.default_rng(0)
    for _ in range(REQUESTS):
        eng.submit(rng.integers(0, tc.vocab_size, size=256), 128)

    def steps(n):
        """``n`` more engine steps through the public entry point."""
        eng.run(max_steps=eng.stats["steps"] + n)

    while eng.sched.prefilling_count() or eng.stats["steps"] < 3:
        steps(1)
    times = []
    for _ in range(10):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        steps(1)
        ev[1].record()
        torch.cuda.synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        ev[0].record()
        steps(PROFILED)
        ev[1].record()
        torch.cuda.synchronize()
    if eng.sched.prefilling_count() or len(eng.completions):
        print("profile_serve_step: a request finished or a row prefilled "
              "in the profiled steps", file=sys.stderr)
        return 1
    wall_ms = ev[0].elapsed_time(ev[1])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip().splitlines()[0]

    def dev_us(e):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, name):
                return float(getattr(e, name))
        return 0.0

    rows = prof.key_averages()
    on_dev = sorted((e for e in rows if str(e.device_type).endswith("CUDA")
                     and dev_us(e) > 0), key=dev_us, reverse=True)
    ops = sorted((e for e in rows if not str(e.device_type).endswith("CUDA")
                  and dev_us(e) > 0), key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in on_dev) / 1e3
    dev_ops = sum(e.count for e in on_dev) / PROFILED
    launches = sum(e.count for e in rows
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                "cudaLaunchKernelExC", "cuLaunchKernelEx")
                   ) / PROFILED
    label = (f"{args.target}" + (f" + {args.draft}" if dp else "")
             + f" {args.mode.upper()} {args.layout} B={REQUESTS} "
             f"bf16, kv {args.kv_dtype}, {card}")
    print(f"{label}: step ms (CUDA events, 10 steps) "
          f"{[round(t, 2) for t in times]}; {PROFILED} profiled steps "
          f"{wall_ms:.2f} ms, device busy {busy_ms:.2f} ms; per step "
          f"{dev_ops:.0f} device ops, {launches:.0f} kernel launches")
    out = {}
    for title, group in (("device kernels", on_dev), ("ops", ops)):
        print(f"{'self device ms':>14}  {'calls':>6}  {title}")
        out[title] = []
        for e in group[:15]:
            print(f"{dev_us(e) / 1e3:14.3f}  {e.count:6d}  {e.key[:110]}")
            out[title].append({"name": e.key[:200], "calls": e.count,
                               "self_device_ms": dev_us(e) / 1e3})
    print(json.dumps({"run": label, "step_ms_p50": statistics.median(times),
                      "profiled_steps": PROFILED,
                      "profiled_ms": wall_ms, "device_busy_ms": busy_ms,
                      "busy_share": busy_ms / wall_ms,
                      "device_ops_per_step": dev_ops,
                      "kernel_launches_per_step": launches, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
