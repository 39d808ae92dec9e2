"""Serving launcher of the port: stand up the engine on random seeded
weights and stream synthetic requests through it.

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --target llama3.1-8b --draft llama3.2-1b --requests 8 --max-new 128

Runs on the CUDA card; ``--device cpu`` runs the plain PyTorch path (use
the tiny-* configs there). ``--tree 2,2,1,1`` drafts a static candidate
tree, ``--adaptive-tree`` picks per request from the default bank at depth
``--k``; ``--contiguous`` keeps full-length KV rows instead of the paged
pool; ``--kv-dtype int8`` / ``fp8`` stores quantized KV. Prints
throughput, mean accepted tokens per step, latency percentiles, KV usage
(scales included) and, with trees, the template histogram.
"""
from __future__ import annotations

import argparse
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--target", required=True)
    ap.add_argument("--draft", default=None)
    ap.add_argument("--mode", default="pard", choices=["ar", "pard"])
    ap.add_argument("--tree", default=None, metavar="B1,B2,...",
                    help="tree-structured PARD drafting: per-depth branching "
                         "factors of the candidate tree (e.g. 2,2,1,1); "
                         "overrides --k with the tree depth")
    ap.add_argument("--adaptive-tree", action="store_true",
                    help="per-request tree templates from the default "
                         "chain/balanced/wide bank at depth --k, re-selected "
                         "from acceptance statistics; excludes --tree")
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=48)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=512)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and the prompts")
    layout = ap.add_mutually_exclusive_group()
    layout.add_argument("--paged", dest="kv_layout", action="store_const",
                        const="paged", help="block-paged KV cache (default)")
    layout.add_argument("--contiguous", dest="kv_layout",
                        action="store_const", const="contiguous",
                        help="full-length per-slot KV rows")
    ap.set_defaults(kv_layout="paged")
    ap.add_argument("--kv-block-size", type=int, default=64)
    ap.add_argument("--kv-dtype", default="bf16",
                    choices=["bf16", "fp32", "int8", "fp8"],
                    help="KV storage; int8 / fp8 (e4m3) keep a float32 "
                         "scale per (position, kv head)")
    ap.add_argument("--kv-num-blocks", type=int, default=None,
                    help="paged pool size (default: worst-case coverage)")
    ap.add_argument("--prefill-chunk", type=int, default=8,
                    help="prompt tokens per step of the AR baseline")
    ap.add_argument("--prefill-budget", type=int, default=None,
                    metavar="TOKENS",
                    help="max prompt tokens consumed per step across "
                         "prefilling rows (default unthrottled)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import init_params
    from repro_torch.serving.engine import Engine, EngineConfig

    device = resolve_device(args.device)
    tc = get_config(args.target)
    tp = init_params(tc, args.seed, device, torch.bfloat16)
    dp = dc = None
    if args.mode != "ar":
        if not args.draft:
            raise SystemExit("--draft is required for --mode pard")
        dc = get_config(args.draft)
        dp = init_params(dc, args.seed + 1, device, torch.bfloat16)
    eng = Engine(tp, tc, dp, dc, config=EngineConfig.from_args(args),
                 device=device)

    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        eng.submit(rng.integers(0, tc.vocab_size, size=args.prompt_len),
                   args.max_new)
    t0 = time.perf_counter()
    comps = eng.run()
    wall = time.perf_counter() - t0

    total = sum(c.generated for c in comps)
    lat = eng.latency_summary()
    print(f"mode={args.mode} device={device} requests={len(comps)} "
          f"generated={total} tokens wall={wall:.2f}s "
          f"throughput={total / wall:.1f} tok/s "
          f"steps={eng.stats['steps']} "
          f"mean_accepted={eng.mean_accepted():.2f}")
    print(f"step_p50={lat['step_p50_ms']:.1f}ms "
          f"ttft_p50={lat['ttft_p50_ms']:.0f}ms "
          f"tok_p50={lat['tok_p50_ms']:.1f}ms "
          f"tok_p95={lat['tok_p95_ms']:.1f}ms")
    print(f"kv layout={args.kv_layout} dtype={args.kv_dtype} "
          f"capacity={eng.kv_capacity_bytes() / 1e6:.2f}MB "
          f"(scales {eng.ex.kv_scale_bytes / 1e6:.2f}MB) "
          f"peak_in_use={eng.peak_kv_bytes_in_use / 1e6:.2f}MB")
    if eng.bank is not None:
        print(f"tree bank={eng.bank.key} k={eng.k} "
              f"window={eng.bank.max_slots} "
              f"tree_hist={eng.stats['tree_hist'].tolist()} "
              f"switches={eng.stats['tree_switches']}")
    print("engine stats:", eng.stats)
    return comps


if __name__ == "__main__":
    main()
