#!/usr/bin/env python3
"""Device-time profile of one training step of the port on one CUDA card.

  PYTHONPATH=src python3 tools/profile_train_step.py [--arch llama3.2-1b]
      [--pard] [--batch 4] [--seq 1024] [--seed 0] [--top 25] [--remat]

Builds a ``Trainer`` as ``repro_torch.launch.train`` does (AdamW with its
cosine schedule, COD at K=8, r=0.7, r_min=0.2 with ``--pard``) with bf16
activations and f32 params, takes two warm-up steps, times five steps
with CUDA events, then profiles one more with ``torch.profiler`` (CPU and
CUDA activities). Prints the step times, the device kernels and the
host ops with the most self device time, and one JSON line: the step
p50, the device's busy time in the profiled step (the summed time of its
kernels, memsets and copies on the one stream) and its share of the
step, and the top kernels and ops. ``--remat`` recomputes each layer in
the backward pass (granite-moe-3b-a800m's fp32 params, moments and
gradients leave too little of the card for every layer's activations).
Only APIs that the port has had since it
first trained are used, so the script profiles an older tree the same
way (``PYTHONPATH=<its src>``).
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--pard", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=None,
                    help="N per row (default 512 with --pard, else 1024)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--remat", action="store_true")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_train_step: no CUDA device", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core.cod import CodConfig
    from repro_torch.data.pipeline import MarkovCorpus
    from repro_torch.models import init_params
    from repro_torch.training.optimizer import AdamW, cosine_schedule
    from repro_torch.training.train_loop import Trainer

    n = args.seq or (512 if args.pard else 1024)
    cfg = get_config(args.arch)
    tr = Trainer(cfg, AdamW(lr=cosine_schedule(1e-3, 5, 100)),
                 loss_kind="pard" if args.pard else "ar",
                 cod=CodConfig(8, 0.7, 0.2), dtype=torch.bfloat16,
                 device="cuda", remat=args.remat)
    params = init_params(cfg, args.seed, "cuda", torch.float32)
    state = tr.init_state(params)
    stream = MarkovCorpus(vocab_size=cfg.vocab_size, seed=0,
                          determinism=2.0).batches(args.batch, n,
                                                   seed=args.seed)
    batches = [tr.make_batch(next(stream), seed=i) for i in range(8)]

    def step(batch):
        nonlocal params, state
        params, state, m = tr.step(params, state, batch)
        return m

    for b in batches[:2]:
        step(b)
    times = []
    for b in batches[2:7]:
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        step(b)
        ev[1].record()
        torch.cuda.synchronize()
        times.append(ev[0].elapsed_time(ev[1]))
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        ev[0].record()
        step(batches[7])
        ev[1].record()
        torch.cuda.synchronize()
    step_ms = ev[0].elapsed_time(ev[1])

    def dev_us(e):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, name):
                return float(getattr(e, name))
        return 0.0

    rows = [e for e in prof.key_averages() if dev_us(e) > 0]
    rows.sort(key=dev_us, reverse=True)
    # device rows (kernels, memsets, copies) run on one stream: their sum
    # is the busy time; host rows (aten ops) carry the device time of the
    # kernels they launched themselves
    on_dev = [e for e in rows if str(e.device_type).endswith("CUDA")]
    ops = [e for e in rows if not str(e.device_type).endswith("CUDA")]
    busy_ms = sum(dev_us(e) for e in on_dev) / 1e3
    label = (f"{args.arch} {'PARD' if args.pard else 'AR'} B={args.batch} "
             f"N={n} bf16, {torch.cuda.get_device_name(0)}")
    print(f"{label}: step ms (CUDA events, 5 steps) "
          f"{[round(t, 2) for t in times]}; profiled step {step_ms:.2f} ms, "
          f"device busy {busy_ms:.2f} ms")
    out = {}
    for title, group in (("device kernels", on_dev), ("ops", ops)):
        print(f"{'self device ms':>14}  {'calls':>6}  {title}")
        out[title] = []
        for e in group[:args.top]:
            print(f"{dev_us(e) / 1e3:14.3f}  {e.count:6d}  {e.key[:110]}")
            out[title].append({"name": e.key[:200], "calls": e.count,
                               "self_device_ms": dev_us(e) / 1e3})
    print(json.dumps({"run": label, "step_ms_p50": statistics.median(times),
                      "profiled_step_ms": step_ms, "device_busy_ms": busy_ms,
                      "busy_share": busy_ms / step_ms, **out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
