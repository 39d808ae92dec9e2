#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py [--seed 0] [--requests 8] [--prompt-len 256]
                        [--max-new 128]

Phases, each of which fails the run (non-zero exit, no result line):

  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: every CUDA kernel of the serving path, compiled from
     ``src/repro_torch/csrc`` with ``nvcc -Xptxas -v``;
  3. kernel vs plain: each kernel against its plain PyTorch version at the
     serving path's shapes (target verify window, draft window, ragged
     contexts up to 4096, garbage table entries, window + softcap, bf16 and
     fp32 pools), max abs error against the stated tolerance;
  4. timing: CUDA-event times of the kernel, its plain version and a
     PyTorch library call on the same inputs (cold L2: inputs rotate over
     more than 100 MB), beside the least time the card could take;
  5. reference: tiny-target / tiny-draft in fp32 on the card — forward
     logits against the CPU plain path, and greedy PARD tokens against AR
     tokens (exactly equal: greedy speculative decoding is lossless);
  6. engine: the default ``EngineConfig`` (PARD, K=8, paged bf16 KV in
     blocks of 64, max_batch 4, chunked prefill) at full width —
     llama3.1-8b target, llama3.2-1b draft, random weights from --seed —
     serving --requests prompts; the kernel must launch once per attention
     layer per step: (16 + 32) x steps;
  7. AR comparison: the same requests in mode "ar"; the share of PARD
     tokens equal to AR tokens up to the first divergence is reported
     (bf16 products of different widths may round apart).

The last two lines of standard output are a JSON line of per-kernel
numbers and the result line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
PEAK_OPS = {"bfloat16": 989e12,      # dense tensor-core bf16
            "float32": 67e12}        # fp32 outside the tensor cores
COLD_BYTES = 128 << 20               # rotate inputs past the 50 MB L2
TOL = {"bfloat16": 2e-2, "float32": 1e-4}   # by output (q) dtype


class SmokeFailure(Exception):
    pass


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# kernel inputs
# ---------------------------------------------------------------------------

def paged_case(torch, gen, *, b, tq, hq, hkv, d, bs, kv_len, kv_dtype,
               q_dtype, window=0, softcap=0.0, garbage=True, dev="cuda"):
    """Pools holding exactly the blocks the rows need (interleaved, block 0
    reserved), tables whose entries past each row's fill point at the
    garbage block, and q at the last tq positions of each row."""
    kv_len = [int(x) for x in kv_len]
    mbs = max(-(-n // bs) for n in kv_len)
    nb = 1 + b * mbs
    k = torch.randn(nb, bs, hkv, d, generator=gen, device=dev).to(kv_dtype)
    v = torch.randn(nb, bs, hkv, d, generator=gen, device=dev).to(kv_dtype)
    if garbage:                       # poison block 0: it must never count
        k[0] = 1e4
        v[0] = -1e4
    perm = torch.randperm(nb - 1, generator=gen, device=dev) + 1
    tables = perm.reshape(b, mbs).to(torch.int32)
    for r, n in enumerate(kv_len):
        tables[r, -(-n // bs):] = 0
    kl = torch.tensor(kv_len, dtype=torch.int32, device=dev)
    q_pos = (kl[:, None] - tq + torch.arange(tq, device=dev)[None, :]
             ).clamp(min=0).to(torch.int32)
    q = torch.randn(b, tq, hq, d, generator=gen, device=dev).to(q_dtype)
    return dict(q=q, k_pages=k, v_pages=v, block_tables=tables, kv_len=kl,
                q_pos=q_pos, window=window, softcap=softcap)


def visible_pairs(case) -> int:
    """(query, key) pairs the masks admit, from this case's data."""
    kl = case["kv_len"].long()[:, None]
    qp = case["q_pos"].long()
    hi = (qp + 1).minimum(kl)
    lo = (qp - case["window"] + 1).clamp(min=0) if case["window"] else 0 * qp
    return int((hi - lo).clamp(min=0).sum())


def bound_ms(case):
    """Least time on the card: bytes moved (q, out, tables, the K/V
    entries below each row's reach) over the memory rate vs the
    multiply-adds of QK^T and PV over the peak rate of the pools' type."""
    q, k = case["q"], case["k_pages"]
    b, tq, hq, d = q.shape
    hkv = k.shape[2]
    reach = (case["q_pos"].long().amax(dim=1) + 1).minimum(
        case["kv_len"].long())
    kv_bytes = int(reach.sum()) * hkv * d * k.element_size() * 2
    small = sum(case[n].numel() * 4 for n in ("block_tables", "kv_len",
                                              "q_pos"))
    nbytes = 2 * q.numel() * q.element_size() + kv_bytes + small
    ops = 4 * visible_pairs(case) * (hq // hkv) * hkv * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[str(k.dtype).split(".")[1]]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                      else "operations")


def time_ms(torch, fn, sets, iters):
    """Mean ms per call from CUDA events, rotating over ``sets``."""
    for s in sets[:2]:
        fn(s)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(sets[i % len(sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build(build):
    t0 = time.perf_counter()
    logs = build.build(["decode_attention_paged"])
    log(f"[build] decode_attention_paged.cu in "
        f"{time.perf_counter() - t0:.1f}s (nvcc -O3 sm_90a)")
    for line in logs["decode_attention_paged"].splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log("  " + line.strip())


def _sync(torch, dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


def phase_correctness(torch, da, args, dev="cuda"):
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    bf, f32 = torch.bfloat16, torch.float32
    target = dict(b=4, tq=9, hq=32, hkv=8, d=128, bs=64)
    draft = dict(b=4, tq=16, hq=32, hkv=8, d=64, bs=64)
    ragged = [1, 700, 2049, 4096]
    cases = [
        ("target bf16 ragged", target, dict(kv_len=ragged, kv_dtype=bf, q_dtype=bf)),
        ("draft bf16 ragged", draft, dict(kv_len=ragged, kv_dtype=bf, q_dtype=bf)),
        ("target fp32 ragged", target, dict(kv_len=ragged, kv_dtype=f32, q_dtype=f32)),
        ("draft fp32 ragged", draft, dict(kv_len=ragged, kv_dtype=f32, q_dtype=f32)),
        ("target bf16 window+softcap", target,
         dict(kv_len=[300, 1000, 64, 9], kv_dtype=bf, q_dtype=bf, window=256,
              softcap=30.0)),
        ("target fp32 window+softcap", target,
         dict(kv_len=[300, 1000, 64, 9], kv_dtype=f32, q_dtype=f32,
              window=100, softcap=50.0)),
        ("draft bf16-q fp32 pools", draft,
         dict(kv_len=[17, 333, 512, 1500], kv_dtype=f32, q_dtype=bf)),
    ]
    worst = 0.0
    for name, shape, kw in cases:
        case = paged_case(torch, gen, dev=dev, **shape, **kw)
        out = da.decode_attention_paged(**case)
        _sync(torch, dev)
        want = da.decode_attention_paged_ref(**case)
        if not torch.isfinite(out).all():
            raise SmokeFailure(f"kernel output not finite ({name})")
        err = (out.float() - want.float()).abs().max().item()
        tol = TOL[str(case["q"].dtype).split(".")[1]]
        log(f"[kernel vs plain] {name}: max_abs_err={err:.3e} tol={tol:g}")
        if err > tol:
            raise SmokeFailure(f"decode_attention_paged disagrees with its "
                               f"plain version ({name}): {err} > {tol}")
        worst = max(worst, err)
    return worst


def phase_timing(torch, F, da, args):
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 7)
    ctx = [args.prompt_len + args.max_new // 2 + 16 * i for i in range(4)]
    rows = [
        ("target verify @engine ctx", dict(b=4, tq=9, hq=32, hkv=8, d=128,
                                          bs=64, kv_len=ctx,
                                          kv_dtype=torch.bfloat16,
                                          q_dtype=torch.bfloat16)),
        ("draft window @engine ctx", dict(b=4, tq=16, hq=32, hkv=8, d=64,
                                         bs=64, kv_len=[c - 9 for c in ctx],
                                         kv_dtype=torch.bfloat16,
                                         q_dtype=torch.bfloat16)),
        ("target verify @ctx 1k-4k", dict(b=4, tq=9, hq=32, hkv=8, d=128,
                                         bs=64, kv_len=[1024, 2048, 3072,
                                                        4096],
                                         kv_dtype=torch.bfloat16,
                                         q_dtype=torch.bfloat16)),
        ("target verify fp32 @engine ctx", dict(b=4, tq=9, hq=32, hkv=8,
                                               d=128, bs=64, kv_len=ctx,
                                               kv_dtype=torch.float32,
                                               q_dtype=torch.float32)),
    ]
    results = []
    for name, kw in rows:
        first = paged_case(torch, gen, garbage=False, **kw)
        per_set = sum(t.numel() * t.element_size() for t in first.values()
                      if hasattr(t, "numel"))
        sets = [first] + [paged_case(torch, gen, garbage=False, **kw)
                          for _ in range(max(1, math.ceil(COLD_BYTES / per_set)) - 1)]
        ms = time_ms(torch, lambda c: da.decode_attention_paged(**c), sets, 200)
        plain = time_ms(torch, lambda c: da.decode_attention_paged_ref(**c),
                        sets, 20)
        # library yardstick: one SDPA call on the pre-gathered view
        lib_sets = []
        for c in sets:
            kc = da.gather_pages(c["k_pages"], c["block_tables"])
            vc = da.gather_pages(c["v_pages"], c["block_tables"])
            s = kc.shape[1]
            kp = torch.arange(s, device="cuda")[None, None, :]
            mask = (kp < c["kv_len"].long()[:, None, None]) & (
                kp <= c["q_pos"].long()[:, :, None])
            lib_sets.append((c["q"].transpose(1, 2), kc.transpose(1, 2),
                             vc.transpose(1, 2), mask[:, None]))
        lib = time_ms(torch, lambda x: F.scaled_dot_product_attention(
            x[0], x[1], x[2], attn_mask=x[3], enable_gqa=True), lib_sets, 50)
        bnd, by = bound_ms(first)
        log(f"[timing] {name}: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
            f"sdpa {lib:.4f} ms, bound {bnd:.4f} ms ({by}); "
            f"{len(sets)} input sets, kv_len={kw['kv_len']}")
        results.append(dict(name=name, ms=ms, plain_ms=plain, library_ms=lib,
                            bound_ms=bnd, bound_by=by))
        del sets, lib_sets
        torch.cuda.empty_cache()
    return results


def phase_reference(torch, args, dev="cuda"):
    """tiny-target / tiny-draft in fp32: card vs CPU logits, PARD == AR."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params
    from repro_torch.serving import kv_pool
    from repro_torch.serving.engine import Engine, EngineConfig

    tc, dc = get_config("tiny-target"), get_config("tiny-draft")
    tp_cpu = init_params(tc, args.seed, "cpu", torch.float32)
    dp_cpu = init_params(dc, args.seed + 1, "cpu", torch.float32)
    tp, dp = _tree_to(tp_cpu, dev), _tree_to(dp_cpu, dev)

    rng = np.random.default_rng(args.seed)
    toks = torch.from_numpy(rng.integers(0, tc.vocab_size, (2, 24)))
    tables = torch.tensor([[1, 3, 5, 7], [2, 4, 6, 8]], dtype=torch.int32)
    outs = []
    for where, params in (("cpu", tp_cpu), (dev, tp)):
        pools = kv_pool.init_paged_caches(tc, 9, 8, torch.float32, where)
        pos = torch.zeros(2, dtype=torch.long, device=where)
        forward(params, tc, toks[:, :20].to(where), caches=pools,
                cache_pos=pos, block_tables=tables.to(where), kv_block_size=8,
                dtype=torch.float32)
        lg, _ = forward(params, tc, toks[:, 20:].to(where), caches=pools,
                        cache_pos=pos + 20, block_tables=tables.to(where),
                        kv_block_size=8, dtype=torch.float32)
        outs.append(lg.float().cpu())
    err = (outs[0] - outs[1]).abs().max().item()
    log(f"[reference] tiny-target paged forward card vs CPU: "
        f"max_abs_err={err:.3e} tol=2e-3")
    if not err <= 2e-3:
        raise SmokeFailure(f"card forward disagrees with the CPU path: {err}")

    prompts = [rng.integers(0, tc.vocab_size, size=int(n))
               for n in rng.integers(4, 40, size=6)]
    tokens = {}
    for mode in ("pard", "ar"):
        eng = Engine(tp, tc, dp, dc, config=EngineConfig(
            mode=mode, k=4, max_batch=3, max_len=256, kv_block_size=16,
            kv_dtype="fp32"), device=dev)
        rids = {eng.submit(p, 24): i for i, p in enumerate(prompts)}
        tokens[mode] = {rids[c.rid]: c.tokens for c in eng.run()}
    same = all(np.array_equal(tokens["pard"][i], tokens["ar"][i])
               for i in range(len(prompts)))
    log(f"[reference] tiny fp32 engine on the card: PARD tokens == AR "
        f"tokens for {len(prompts)} requests: {same}")
    if not same:
        raise SmokeFailure("greedy PARD tokens differ from AR tokens")


def serve(torch, kernels, Engine, EngineConfig, tp, tc, dp, dc, prompts,
          max_new, mode, dev):
    eng = Engine(tp, tc, dp, dc, config=EngineConfig(mode=mode), device=dev)
    for p in prompts:
        eng.submit(p, max_new)
    _sync(torch, dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    kernels.launches.clear()                  # counts to 0 just before
    t0 = time.perf_counter()
    comps = eng.run()
    _sync(torch, dev)
    wall = time.perf_counter() - t0
    launches = kernels.launches["decode_attention_paged"]   # just after
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    steps = eng.stats["steps"]
    layers = tc.num_layers + (dc.num_layers if mode == "pard" else 0)
    gen = sum(c.generated for c in comps)
    lat = eng.latency_summary()
    log(f"[engine {mode}] {len(comps)} requests, {gen} tokens in {wall:.2f}s "
        f"= {gen / wall:.1f} tok/s; steps={steps} "
        f"mean_accepted={eng.mean_accepted():.3f} "
        f"step_p50={lat['step_p50_ms']:.2f}ms "
        f"step_p95={lat['step_p95_ms']:.2f}ms "
        f"peak_mem={peak / 2**30:.2f}GiB "
        f"kv_capacity={eng.kv_capacity_bytes() / 2**20:.0f}MiB; "
        f"decode_attention_paged launches={launches} "
        f"(expected {layers} x {steps} = {layers * steps})")
    if len(comps) != len(prompts) or any(c.generated != max_new
                                         for c in comps):
        raise SmokeFailure(f"engine {mode} did not complete every request")
    for c in comps:
        if not (0 <= c.tokens.min() and c.tokens.max() < tc.vocab_size):
            raise SmokeFailure(f"engine {mode} emitted tokens outside the vocab")
    if dev == "cuda" and launches != layers * steps:
        raise SmokeFailure(f"engine {mode}: {launches} kernel launches, "
                           f"expected {layers * steps}")
    return {c.rid: c.tokens for c in comps}, launches


def phase_engine(torch, kernels, args, target="llama3.1-8b",
                 draft="llama3.2-1b", dev="cuda"):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving.engine import Engine, EngineConfig

    tc, dc = get_config(target), get_config(draft)
    t0 = time.perf_counter()
    tp = init_params(tc, args.seed, dev, torch.bfloat16)
    dp = init_params(dc, args.seed + 1, dev, torch.bfloat16)
    _sync(torch, dev)
    n_params = sum(t.numel() for tree in (tp, dp) for t in _leaves(tree))
    log(f"[engine] {target} + {draft} random bf16 weights "
        f"({n_params / 1e9:.2f}B params) on the card in "
        f"{time.perf_counter() - t0:.1f}s; EngineConfig defaults "
        f"{EngineConfig()}")
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, tc.vocab_size, size=args.prompt_len)
               for _ in range(args.requests)]
    # warm-up: library handles and allocator pools, not counted
    warm = Engine(tp, tc, dp, dc, config=EngineConfig(), device=dev)
    warm.submit(prompts[0][:32], 8)
    warm.run()
    del warm
    pard, launches = serve(torch, kernels, Engine, EngineConfig, tp, tc, dp,
                           dc, prompts, args.max_new, "pard", dev)
    if dev == "cuda":
        torch.cuda.empty_cache()
    ar, _ = serve(torch, kernels, Engine, EngineConfig, tp, tc, None, None,
                  prompts, args.max_new, "ar", dev)
    shares = []
    for rid, toks in pard.items():
        p = args.prompt_len
        a, b = toks[p:], ar[rid][p:]
        diff = np.nonzero(a != b)[0]
        shares.append((diff[0] if diff.size else len(a)) / len(a))
    log(f"[ar comparison] share of PARD tokens equal to AR tokens up to the "
        f"first divergence: mean {np.mean(shares):.3f} per request "
        f"{[round(float(s), 3) for s in shares]}")
    return launches


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=128)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch.nn.functional as F
    from repro_torch import kernels
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as da

    t_start = time.perf_counter()
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    try:
        phase_build(build)
        err = phase_correctness(torch, da, args)
        timing = phase_timing(torch, F, da, args)
        phase_reference(torch, args)
        launches = phase_engine(torch, kernels, args)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    main_row = timing[0]
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    log(card)
    log(json.dumps({"kernels": [{
        "name": "decode_attention_paged", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention_paged.cu",
        "replaces": "src/repro/kernels/decode_attention.py:178",
        "launches": launches, "max_abs_err": err,
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
