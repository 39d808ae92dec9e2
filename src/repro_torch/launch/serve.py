"""Serving launcher of the port: stand up the engine on random seeded
weights, or on checkpoints, and stream synthetic requests through it.

  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --target llama3.1-8b --draft llama3.2-1b --requests 8 --max-new 128 \\
      [--target-ckpt a.npz --draft-ckpt b.npz]

Runs on the CUDA card; ``--device cpu`` runs the plain PyTorch path (use
the tiny-* and ``-smoke`` configs there, e.g. ``--target gemma2-27b-smoke
--draft gemma2-27b-smoke``, the MoE ``--target granite-moe-3b-a800m-smoke
--draft granite-moe-3b-a800m-smoke`` or the Mamba2 + attention + MoE
hybrid ``jamba-1.5-large-398b-smoke``; a Mamba2 or hybrid draft such as
``--draft tiny-ssm`` also drafts trees for a dense or MoE target, while a
target with Mamba2 layers serves flat only). ``--target-ckpt`` /
``--draft-ckpt`` restore
checkpoints of either package (``training.checkpoint``, e.g. what
``repro_torch.examples.pard_adaptation_train`` writes) into the seeded
weights. The prompts are drawn from the Markov corpus
(``MarkovCorpus(vocab, seed=0, determinism=2.0)``), the same draws as the
JAX launcher's for the same flags. ``--tree 2,2,1,1`` drafts a static candidate
tree, ``--adaptive-tree`` picks per request from the default bank at depth
``--k``; ``--contiguous`` keeps full-length KV rows instead of the paged
pool; ``--kv-dtype int8`` / ``fp8`` stores quantized KV; ``--mode vsd``
drafts with K AR forwards of the draft (vanilla speculative decoding).
``--temperature 0.8`` samples (seeded by ``--seed``), and
``--greedy-requests N`` keeps the first N requests greedy, so one batch
mixes greedy and sampled rows. ``--prefix-cache`` reuses prompt KV across
requests (paged only); ``--prefix-share N`` sends N requests per system
prompt of ``--prompt-len`` tokens, each with an 8-token tail of its own,
the groups round-robin, so later arrivals of a group hit what earlier ones
prefilled. ``--pipelined`` dispatches step t + 1 before harvesting step t.
Prints throughput, mean accepted tokens per step and the temperature mix,
latency percentiles and the host overhead between a harvest and the next
dispatch, KV usage (scales included), the prefix-cache hit rate and, with
trees, the template histogram.
"""
from __future__ import annotations

import argparse
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--target", required=True)
    ap.add_argument("--draft", default=None)
    ap.add_argument("--target-ckpt", default=None,
                    help="checkpoint restored into the target's weights")
    ap.add_argument("--draft-ckpt", default=None,
                    help="checkpoint restored into the draft's weights")
    ap.add_argument("--mode", default="pard", choices=["ar", "vsd", "pard"])
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
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="sampling temperature (0 = greedy); trees accept "
                         "sampled siblings by multi-round rejection")
    ap.add_argument("--greedy-requests", type=int, default=0, metavar="N",
                    help="submit the first N requests with temperature 0 "
                         "(the rest use --temperature): one batch mixes "
                         "greedy and sampled rows")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights, the prompts and the "
                         "engine's sampling keys")
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
    ap.add_argument("--prefix-cache", action="store_true",
                    help="refcounted prompt-prefix reuse in the paged pool: "
                         "same-prefix requests map cached blocks copy-free "
                         "and prefill only their tail")
    ap.add_argument("--prefix-share", type=int, default=1, metavar="N",
                    help="requests per shared system prompt (each adds an "
                         "8-token tail of its own); 1 = all prompts unique")
    ap.add_argument("--pipelined", action="store_true",
                    help="two steps in flight: dispatch step t + 1 before "
                         "harvesting step t (tokens unchanged)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    return ap


def workload(args, vocab_size: int):
    """The prompts of the run, drawn from the Markov corpus with
    ``--seed``: all unique of ``--prompt-len`` tokens, or with
    ``--prefix-share N`` > 1, N requests per system prompt of
    ``--prompt-len`` tokens, each followed by an 8-token tail of its own,
    the groups taken round-robin: same-prefix requests arrive in different
    batch generations, since concurrent identical prefixes cannot hit (a
    block matches only once computed). The draws are the JAX launcher's,
    in its order: the system prompts first (drawn, and unused, with
    ``--prefix-share 1`` too), then each request's prompt or tail."""
    import numpy as np

    from repro_torch.data.pipeline import MarkovCorpus
    corpus = MarkovCorpus(vocab_size=vocab_size, seed=0, determinism=2.0)
    rng = np.random.default_rng(args.seed)
    share = max(1, args.prefix_share)
    systems = [corpus.prompts(rng, 1, args.prompt_len)[0]
               for _ in range(-(-args.requests // share))]
    prompts = []
    for i in range(args.requests):
        if share > 1:
            prompts.append(np.concatenate([systems[i % len(systems)],
                                           corpus.prompts(rng, 1, 8)[0]]))
        else:
            prompts.append(corpus.prompts(rng, 1, args.prompt_len)[0])
    return prompts


def main(argv=None):
    args = build_parser().parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.models import init_params
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.training import checkpoint

    device = resolve_device(args.device)
    tc = get_config(args.target)
    tp = init_params(tc, args.seed, device, torch.bfloat16)
    if args.target_ckpt:
        tp = checkpoint.restore(args.target_ckpt, tp)
    dp = dc = None
    if args.mode != "ar":
        if not args.draft:
            raise SystemExit(f"--draft is required for --mode {args.mode}")
        dc = get_config(args.draft)
        dp = init_params(dc, args.seed + 1, device, torch.bfloat16)
        if args.draft_ckpt:
            dp = checkpoint.restore(args.draft_ckpt, dp)
    eng = Engine(tp, tc, dp, dc, config=EngineConfig.from_args(args),
                 device=device)

    for i, prompt in enumerate(workload(args, tc.vocab_size)):
        # the first --greedy-requests decode greedily whatever the default
        eng.submit(prompt, args.max_new,
                   temperature=0.0 if i < args.greedy_requests else None)
    t0 = time.perf_counter()
    comps = eng.run(pipelined=args.pipelined)
    wall = time.perf_counter() - t0

    total = sum(c.generated for c in comps)
    lat = eng.latency_summary()
    print(f"mode={args.mode} device={device} requests={len(comps)} "
          f"generated={total} tokens wall={wall:.2f}s "
          f"throughput={total / wall:.1f} tok/s "
          f"steps={eng.stats['steps']} "
          f"mean_accepted={eng.mean_accepted():.2f} "
          f"temperature={args.temperature} "
          f"greedy_requests={min(args.greedy_requests, args.requests)}/"
          f"{args.requests}")
    print(f"step_p50={lat['step_p50_ms']:.1f}ms "
          f"ttft_p50={lat['ttft_p50_ms']:.0f}ms "
          f"ttft_p95={lat['ttft_p95_ms']:.0f}ms "
          f"tok_p50={lat['tok_p50_ms']:.1f}ms "
          f"tok_p95={lat['tok_p95_ms']:.1f}ms "
          f"pipelined={args.pipelined} "
          f"steps/s={eng.stats['steps'] / wall:.1f}")
    print(f"host overhead (harvest->dispatch) "
          f"p50={lat['host_overhead_p50_ms']:.2f}ms "
          f"p95={lat['host_overhead_p95_ms']:.2f}ms")
    print(f"kv layout={args.kv_layout} dtype={args.kv_dtype} "
          f"capacity={eng.kv_capacity_bytes() / 1e6:.2f}MB "
          f"(scales {eng.ex.kv_scale_bytes / 1e6:.2f}MB) "
          f"peak_in_use={eng.peak_kv_bytes_in_use / 1e6:.2f}MB")
    if args.prefix_cache:
        print(f"prefix cache: hit_rate={eng.prefix_hit_rate():.2f} "
              f"({eng.stats['prefix_hit_blocks']}/"
              f"{eng.stats['prefix_lookup_blocks']} prompt blocks) "
              f"prefill_tokens={eng.stats['prefill_tokens']}")
    if eng.bank is not None:
        print(f"tree bank={eng.bank.key} k={eng.k} "
              f"window={eng.bank.max_slots} "
              f"tree_hist={eng.stats['tree_hist'].tolist()} "
              f"switches={eng.stats['tree_switches']}")
    print("engine stats:", eng.stats)
    return comps


if __name__ == "__main__":
    main()
