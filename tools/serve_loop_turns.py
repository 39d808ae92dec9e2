#!/usr/bin/env python3
"""The serving loop synchronous and pipelined (or the prefix cache cold
and warm), in turns, on one CUDA card.

  python3 tools/serve_loop_turns.py [--pairs 3] [--prefix-share N]
      [--target llama3.1-8b] [--draft llama3.2-1b] [--adaptive-tree]
      [--temperature 0.0] [--requests 8] [--prompt-len 256] [--max-new 128]

Builds one set of random bf16 weights (target from seed 0, draft from
seed 1), warms an engine up, then serves the same requests (EngineConfig
defaults: K = 8, max_batch 4, paged bf16 KV) ``--pairs`` times in each of
three variants, the order rotating from pair to pair: ``sync``
(``Engine.run(pipelined=False)``), ``pipelined`` (two steps in flight)
and ``guarded`` (pipelined, its admit / sync_tables / dispatch under
``torch.cuda.set_sync_debug_mode("error")``, as ``chip_smoke.py`` runs
it). Each run reports tok/s, step p50 / p95 (``latency_summary``: the wall
time a step holds the loop), host overhead p50 (harvest done -> next
dispatch), and where a step's wall time goes: the host time inside
``Executor.dispatch`` (issuing the step) and inside ``Executor.harvest``
(waiting for its outputs), and TTFT p50 / p95. With ``--prefix-share N``
> 1 the requests are the launcher's shared-prefix mix (N per system prompt
of ``--prompt-len`` tokens, each with an 8-token tail) and the variants
are ``cold`` and ``warm`` (``prefix_cache=True``), both synchronous.
Tokens must be identical in every run. Prints one line per run and,
last, one JSON line with the card's name and power limit
(``nvidia-smi``) and each variant's medians.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
LOOPS = ("sync", "pipelined", "guarded")
PREFIX = ("cold", "warm")


def _timed(obj, name, sink):
    """Wrap ``obj.name`` to append the host time of each call (ms)."""
    fn = getattr(obj, name)

    def wrapped(*a, **k):
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            sink.append((time.perf_counter() - t0) * 1e3)
    setattr(obj, name, wrapped)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--target", default="llama3.1-8b")
    ap.add_argument("--draft", default="llama3.2-1b")
    ap.add_argument("--adaptive-tree", action="store_true")
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=128)
    ap.add_argument("--prefix-share", type=int, default=1)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("serve_loop_turns: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import workload
    from repro_torch.models import init_params
    from repro_torch.serving.engine import Engine, EngineConfig

    card = chip_smoke.card_line()
    tc, dc = get_config(args.target), get_config(args.draft)
    tp = init_params(tc, 0, "cuda", torch.bfloat16)
    dp = init_params(dc, 1, "cuda", torch.bfloat16)
    cfg = EngineConfig(adaptive_tree=args.adaptive_tree,
                       temperature=args.temperature)
    prompts = workload(argparse.Namespace(
        seed=0, requests=args.requests, prompt_len=args.prompt_len,
        prefix_share=args.prefix_share), tc.vocab_size)
    variants = PREFIX if args.prefix_share > 1 else LOOPS

    def serve(variant):
        eng = Engine(tp, tc, dp, dc, device="cuda", config=dataclasses.replace(
            cfg, prefix_cache=variant == "warm"))
        for p in prompts:
            eng.submit(p, args.max_new)
        issue, wait = [], []
        _timed(eng.ex, "dispatch", issue)
        _timed(eng.ex, "harvest", wait)
        if variant == "guarded":
            chip_smoke.guard_host_side(torch, eng)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        comps = eng.run(pipelined=variant in ("pipelined", "guarded"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lat = eng.latency_summary()
        row = dict(variant=variant, tok_s=sum(c.generated for c in comps)
                   / wall, steps=eng.stats["steps"],
                   step_p50_ms=lat["step_p50_ms"],
                   step_p95_ms=lat["step_p95_ms"],
                   host_overhead_p50_ms=lat["host_overhead_p50_ms"],
                   ttft_p50_ms=lat["ttft_p50_ms"],
                   ttft_p95_ms=lat["ttft_p95_ms"],
                   dispatch_p50_ms=statistics.median(issue),
                   harvest_wait_p50_ms=statistics.median(wait))
        return row, {c.rid: c.tokens for c in comps}

    serve(variants[0])                              # warm-up, not counted
    rows, ref = [], None
    for pair in range(args.pairs):
        k = pair % len(variants)
        order = variants[k:] + variants[:k]
        for variant in order:
            row, toks = serve(variant)
            ref = ref or toks
            same = all(np.array_equal(toks[r], t) for r, t in ref.items())
            row.update(pair=pair, tokens_identical=same)
            rows.append(row)
            print(json.dumps(row), flush=True)
            if not same:
                print("serve_loop_turns: tokens differ between runs",
                      file=sys.stderr)
                return 1
    summary = {v: {k: statistics.median(r[k] for r in rows
                                         if r["variant"] == v)
                   for k in ("tok_s", "step_p50_ms", "step_p95_ms",
                             "host_overhead_p50_ms", "dispatch_p50_ms",
                             "harvest_wait_p50_ms", "ttft_p50_ms",
                             "ttft_p95_ms", "steps")}
               for v in variants}
    print(card)
    print(json.dumps({"card": card, "target": args.target,
                      "draft": args.draft, "adaptive_tree": args.adaptive_tree,
                      "temperature": args.temperature, "pairs": args.pairs,
                      "prefix_share": args.prefix_share,
                      "medians": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
