#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py [--seed 0] [--requests 8] [--prompt-len 256]
                        [--max-new 128] [--train-steps 20]

Phases, each of which fails the run (non-zero exit, no result line):

  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: every CUDA kernel of the serving and training paths, compiled
     from ``src/repro_torch/csrc`` in parallel (one ``nvcc -Xptxas -v``
     each): decode_attention_paged, decode_attention, tree_attention_paged,
     tree_attention, flash_attention(_bwd), pard_attention(_bwd),
     ssd_chunked; for the training kernels, the four serving kernels and
     ssd_chunked each bf16 instance's registers and spills (a spill fails;
     48 serving instances: 4 kernels x 4 head dims x 3 K/V dtypes (bf16,
     int8, fp8 e4m3), each named with its mask, K/V addressing and K/V
     dtype; 6 ssd instances, one per tile plan), and a
     check that the SASS of every bf16 product kernel
     (``cuobjdump -sass``) holds HGMMA or HMMA;
  3. kernel vs plain: each attention kernel against its plain PyTorch
     version on the card (head dims 128 / 64 / 48 / 32, G 1, 2 and 4, bf16
     and fp32, ragged contexts up to 4096, window + softcap, random tree
     templates with per-row win_len up to 32 slots; block 0 and every cache
     slot at or past each row's reach poisoned with +-1e4), max abs error
     against the stated tolerance; the bf16 split-KV loop of all four
     serving kernels also at its edges (splits that get no keys, kv_len 1,
     rows that see no key, a window that leaves a few chunks, pages of 8 /
     16, G = 7 across the mma and CTA row tiles; on contiguous caches
     kv_len past S and a tree window that ends at S), two calls bitwise
     equal, and a call captured in a CUDA graph replayed after kv_len /
     q_pos are rewritten in place; the int8 and fp8 K/V routes of all four
     (quantized as the model appends, f32 scales; bf16 q on the tensor-core
     loop, f32 q on the f32 loop) at D 128 / 64 / 48 / 32, G 4 and 7, pages
     of 64 / 16 / 8, window + softcap, the 31-slot window, rows that see no
     key, contiguous kv_len past S and a tree window that ends at S, each
     with a bitwise repeat and a CUDA-graph replay; ssd_chunked (y and
     final state) at the
     mamba2-130m and tiny shapes, t in {1, 9, 16, 17, 50, 65, 2048},
     chunk 16 and 64, a nonzero initial state, bf16 and fp32, at a ragged
     P block and N and with init_state None; two calls bitwise equal, a
     call captured in a CUDA graph replayed on new inputs equal to an eager
     call, a fully masked window leaving the state bit for bit, and its
     gather route (dt = 0 past a random per-row index) against the
     token-by-token oracle;
  4. timing: each kernel and a PyTorch library call (SDPA with a boolean
     mask over the gathered KV; none for the SSD scan) by device time (a
     CUDA graph of one call per input set, replayed between CUDA events),
     their eager per-call times beside, and the plain version's eager
     time, on the same inputs at the engine's shapes and at kv 1k-4k
     (cold L2: inputs rotate over more than 128 MB), beside the least time
     the card could take; the int8 and fp8 routes of the four serving
     kernels at the same shapes (bound: 1-byte codes and a 4-byte scale per
     position and kv head), with SDPA over the pre-dequantized bf16 K/V as
     a labelled yardstick (no PyTorch call attends over 8-bit K/V);
  5. reference: tiny-target / tiny-draft in fp32 on the card — forward
     logits against the CPU plain path; greedy tokens of flat PARD, a tree,
     a degenerate chain (1,)*K, on paged and contiguous KV, all equal to
     AR tokens (greedy speculative decoding is lossless), the chain's
     acceptance equal to flat K's; then tiny-target with the head-dim-48
     tiny-mid draft, tiny-ssm and a dense hybrid (target = draft): SSM
     forward logits against the CPU, PARD tokens == AR tokens on both
     layouts with max_batch 2 and 3 requests (a recycled slot);
  6. engine at full width (llama3.1-8b target, llama3.2-1b draft, random
     bf16 weights from --seed, K=8, max_batch 4): paged PARD (the
     defaults), AR, the paged adaptive tree (default bank, 31-slot window),
     contiguous flat PARD, the contiguous static tree (2,2,1,1,1,1,1,1),
     paged PARD on int8 KV and the paged adaptive tree on fp8 KV (their
     kv_capacity and the share of tokens equal to the bf16 run's up to the
     first divergence); then mamba2-130m as target (--seed) and draft
     (--seed + 1): paged PARD, contiguous PARD and paged AR; each asserts
     the exact launches of every kernel (one per attention layer per step;
     per Mamba2 layer one ssd_chunked per forward and one per state
     gather: 4 per layer per PARD step);
  7. AR comparison: the share of PARD tokens equal to AR tokens up to the
     first divergence (bf16 products of different widths may round apart);
  8. training kernels vs plain: flash and pard attention, forward and
     backward (out, dq, dk, dv through torch.autograd) against their plain
     versions (D 32 / 48 / 64 / 128, G 1 and 4, T off the 64-row tile, window
     and softcap, COD layouts of the port's pack_batch at K=8, r=0.7,
     r_min=0.2 with segment-0 padding, and the exact bf16 shapes of the
     training runs of phase 9; rows that see no key give 0 and take no
     gradient; two backward calls give bitwise-equal gradients), plus the
     cases where the tensor-core tiles can break, at every head dim in
     bf16: T = 1, 65 and 1023, S < T with a window, a COD layout with a
     64-token tile of padding only and one with tiles classed full; then
     their times at the training shapes, forward and backward, by device
     time as in phase 4 (eager beside), beside the bound, the plain
     versions and SDPA (its backward by device time as a CUDA graph of
     forward and backward less one of the forward; eager over the same
     rotating input sets as the kernel's), and the COD tile classes
     visited and full;
  9. training at full width (llama3.2-1b, 16 layers, random weights from
     --seed, f32 params and AdamW moments, bf16 activations, the cosine
     schedule of ``repro_torch.launch.train`` at peak 1e-3, its trainer
     made by the launcher with ``--dtype bfloat16``): one B=1 step through the
     kernels and through the plain versions (loss and global grad norm
     within 2e-2), then ``--train-steps`` AR steps (B=4, N=1024) and PARD
     steps (B=4, N=512 packed to T=1726) through ``Trainer.fit``, each
     asserting one forward and one backward launch per layer per step and
     a finite, falling loss; then one more ``Trainer.step`` cut into
     forward + loss, backward and AdamW by its CUDA events.

The last two lines of standard output are a JSON line of per-kernel
numbers (a serving-attention kernel's row also lists every timing row of
phase 4 under ``timings``, and its int8 and fp8 routes' error, launches
and times under ``int8`` / ``fp8``) and the result line ``{"ok": true,
"device": {...}}``.
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
QUANT_NAMES = {"torch.int8": "int8", "torch.float8_e4m3fn": "fp8"}
ROUTES = ("int8", "fp8")                     # the serving kernels' 8-bit K/V
REPLACES = {                         # kernel -> the TPU kernel it ports
    "decode_attention_paged": "src/repro/kernels/decode_attention.py:178",
    "decode_attention": "src/repro/kernels/decode_attention.py:115",
    "tree_attention_paged": "src/repro/kernels/tree_attention.py:200",
    "tree_attention": "src/repro/kernels/tree_attention.py:125",
    # the TPU kernels have no backward (XLA autodiff of the jnp path): the
    # backward kernels port the gradient of the same TPU kernel
    "flash_attention": "src/repro/kernels/flash_attention.py:84",
    "flash_attention_bwd": "src/repro/kernels/flash_attention.py:84",
    "pard_attention": "src/repro/kernels/pard_attention.py:73",
    "pard_attention_bwd": "src/repro/kernels/pard_attention.py:73",
    "ssd_chunked": "src/repro/kernels/ssd.py:70",
}
KERNELS = tuple(REPLACES)
TRAIN_KERNELS = {"flash": ("flash_attention", "flash_attention_bwd"),
                 "pard": ("pard_attention", "pard_attention_bwd")}
TRAIN_NAMES = tuple(n for pair in TRAIN_KERNELS.values() for n in pair)
# serving kernels whose bf16-q instances run the tensor-core split-KV loop
# (csrc/serve_attention_mma.cuh): all four, one instance per head dim and
# K/V dtype (bf16, int8, fp8 e4m3) each
MMA_SERVING = ("decode_attention_paged", "decode_attention",
               "tree_attention_paged", "tree_attention")
SMMA_PER_KERNEL = 4 * 3
SMMA_INSTANCES = SMMA_PER_KERNEL * len(MMA_SERVING)
WIDE = (2, 2, 1, 1, 1, 1, 1, 1)      # the default bank's 31-slot template at K=8
TRAIN_MODEL = "llama3.2-1b"
TRAIN_SEQ = {"ar": 1024, "pard": 512}   # N per row; PARD packs 512 to T=1726
# peak of the launcher's cosine schedule: its default (3e-3) suits the tiny
# models; llama3.2-1b from random weights spikes at it and ends its 20 AR
# steps above the first loss, through the plain attention as through the
# kernels (tools/lr_witness.py)
TRAIN_LR = 1e-3
COD = (8, 0.7, 0.2)                  # K, r, r_min of the PARD training cell
SSM_MODEL = "mamba2-130m"            # the Mamba2 serving cell: target = draft
# a dense hybrid built in phase 5: attention every second layer, dense MLPs
HYBRID = dict(name="hybrid-test", arch_type="hybrid", num_layers=4,
              attn_every=2, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
              d_ff=128, vocab_size=512, ssm_state=16, ssm_headdim=32,
              ssm_chunk=8, tie_embeddings=True, max_seq_len=1024,
              source="test")


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

def _templates(rng, b, tq, TreeTemplate, fixed=None):
    """Per-row (anc, depth, win_len) of random valid templates of at most
    tq slots (``fixed``: one branching for every row)."""
    import numpy as np
    anc = np.zeros((b, tq), np.int64)
    depth = np.zeros((b, tq), np.int64)
    win_len = np.zeros(b, np.int64)
    for r in range(b):
        if fixed is not None:
            t = TreeTemplate.from_branching(fixed)
        elif r == 0 and tq == 32:
            t = TreeTemplate.flat(31)                 # slots 30 and 31 in play
        else:
            while True:
                br = [int(x) for x in rng.integers(1, 4, size=rng.integers(1, 9))]
                try:
                    t = TreeTemplate.from_branching(br)
                except ValueError:
                    continue
                if t.num_slots <= tq:
                    break
        ns = t.num_slots
        anc[r, :ns], depth[r, :ns], win_len[r] = t.anc, t.depth, ns
    return anc, depth, win_len


def make_case(torch, gen, rng, kind, *, b, tq, hq, hkv, d, ctx, kv_dtype,
              q_dtype, bs=64, s=None, window=0, softcap=0.0, poison=True,
              template=None, dead=(), dev="cuda"):
    """Inputs of one kernel call. ``kind``: "paged" / "contig" (causal
    decode: kv_len = ctx, queries at the last tq positions) or "tree_paged"
    / "tree_contig" (the window at win_start = ctx, kv_len = ctx + tq,
    logical positions ctx + depth of random templates, or ``template`` on
    every row; the tree rows in ``dead`` get win_len 0, so with ctx 0 they
    see no key). Paged pools hold exactly the blocks each row needs (block
    0 reserved); contiguous caches are [B, S, Hkv, D]. With ``poison``,
    block 0 and every slot at or past each row's reach hold +-1e4. An int8
    or fp8 ``kv_dtype`` quantizes the K/V as the model appends them
    (``quantize_kv``: codes and f32 k_scale / v_scale; a poisoned slot
    becomes codes of +-max at scale 1e4 / max)."""
    from repro_torch.core.spec_decode import TreeTemplate
    if str(kv_dtype) in QUANT_NAMES:
        case = make_case(torch, gen, rng, kind, b=b, tq=tq, hq=hq, hkv=hkv,
                         d=d, ctx=ctx, kv_dtype=torch.float32,
                         q_dtype=q_dtype, bs=bs, s=s, window=window,
                         softcap=softcap, poison=poison, template=template,
                         dead=dead, dev=dev)
        return quantize_case(case, kv_dtype)
    tree = kind.startswith("tree")
    ctx = torch.tensor([int(x) for x in ctx])
    i32 = dict(device=dev, dtype=torch.int32)
    if tree:
        anc, depth, win_len = _templates(rng, b, tq, TreeTemplate, template)
        win_len[list(dead)] = 0
        win_len = torch.from_numpy(win_len)
        kv_len = ctx + tq
        reach = torch.minimum(kv_len, ctx + win_len)
        q_pos = ctx[:, None] + torch.from_numpy(depth)
    else:
        kv_len = ctx
        reach = kv_len
        q_pos = (kv_len[:, None] - tq + torch.arange(tq)[None]).clamp(min=0)
    case = dict(q=torch.randn(b, tq, hq, d, generator=gen, device=dev)
                .to(q_dtype), kv_len=kv_len.to(**i32), q_pos=q_pos.to(**i32),
                window=window, softcap=softcap)
    if tree:
        case.update(win_start=ctx.to(**i32), anc=torch.from_numpy(anc).to(dev),
                    win_len=win_len.to(**i32))
    if kind.endswith("contig"):
        s = s or int(kv_len.max())
        k = torch.randn(b, s, hkv, d, generator=gen, device=dev).to(kv_dtype)
        v = torch.randn(b, s, hkv, d, generator=gen, device=dev).to(kv_dtype)
        if poison:
            for r in range(b):
                k[r, int(reach[r]):], v[r, int(reach[r]):] = 1e4, -1e4
        case.update(k=k, v=v)
        return case
    mbs = max(-(-int(n) // bs) for n in kv_len)
    nb = 1 + b * mbs
    k = torch.randn(nb, bs, hkv, d, generator=gen, device=dev).to(kv_dtype)
    v = torch.randn(nb, bs, hkv, d, generator=gen, device=dev).to(kv_dtype)
    tables = (torch.randperm(nb - 1, generator=gen, device=dev) + 1
              ).reshape(b, mbs).to(torch.int32)
    for r, n in enumerate(kv_len.tolist()):
        tables[r, -(-n // bs):] = 0                   # past the row: garbage
    if poison:
        k[0], v[0] = 1e4, -1e4
        for r in range(b):                            # the rest of its blocks
            for p in range(int(reach[r]), -(-int(kv_len[r]) // bs) * bs):
                blk = int(tables[r, p // bs])
                k[blk, p % bs], v[blk, p % bs] = 1e4, -1e4
    case.update(k_pages=k, v_pages=v, block_tables=tables)
    return case


def quantize_case(case, qdtype):
    """``case`` with its K/V as ``qdtype`` codes and f32 scales."""
    from repro_torch.models.attention import quantize_kv
    case = dict(case)
    for name in ("k", "v", "k_pages", "v_pages"):
        if name in case:
            case[name], case[name[0] + "_scale"] = quantize_kv(case[name],
                                                               qdtype)
    return case


def route(case):
    """The K/V route of a case: "int8", "fp8", or None (bf16 / fp32)."""
    k = case["k"] if "k" in case else case["k_pages"]
    return QUANT_NAMES.get(str(k.dtype))


def _kv(case):
    """A case's K/V rows [B, S, Hkv, D], dequantized when quantized."""
    from repro_torch.kernels.decode_attention import dequant, gather_pages
    if "k" in case:
        k, v, ks, vs = (case.get(n) for n in ("k", "v", "k_scale", "v_scale"))
    else:
        t = case["block_tables"]
        k, v = gather_pages(case["k_pages"], t), gather_pages(case["v_pages"], t)
        ks, vs = ((gather_pages(case[n], t) if n in case else None)
                  for n in ("k_scale", "v_scale"))
    return dequant(k, v, ks, vs)


def allowed_mask(torch, case):
    """[B, Tq, S] visibility over the row's (gathered) keys, as the plain
    versions compute it."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import tree_attention as ta
    k = case["k"] if "k" in case else case["k_pages"]
    if "k_pages" in case:                 # a row's reach: MBS pages of bs
        tables = case["block_tables"]
        b, s = tables.shape[0], tables.shape[1] * k.shape[1]
    else:
        b, s = k.shape[:2]
    if "anc" not in case:
        return da.causal_allowed(case["q_pos"], case["kv_len"], s,
                                 case["window"])
    kv_pos = torch.arange(s, device=k.device)[None].expand(b, s)
    info = ta.TreeAttnInfo(case["win_start"], case["anc"], case["win_len"])
    eff = torch.minimum(case["kv_len"].long(),
                        case["win_start"].long() + case["win_len"].long())
    return ta.tree_allowed(case["q_pos"], kv_pos, info, case["window"]) & (
        kv_pos < eff[:, None])[:, None, :]


def bound_ms(torch, case):
    """Least time on the card: the bytes the call must move (q, out, the
    int operands, and each row's K/V entries up to the last key any query
    sees, read once; int8 / fp8: 1-byte codes plus a 4-byte f32 scale per
    (position, kv head) of K and of V) over the memory rate, vs the
    multiply-adds of QK^T and PV over the visible (query, key) pairs at
    the peak rate of the type they run in (the KV type; bf16 for 8-bit
    K/V under bf16 q, f32 under f32 q); the larger of the two."""
    q = case["q"]
    k = case["k"] if "k" in case else case["k_pages"]
    b, tq, hq, d = q.shape
    hkv = k.shape[2]
    allowed = allowed_mask(torch, case)
    pos = torch.arange(allowed.shape[-1], device=allowed.device)
    last = torch.where(allowed.any(dim=1), pos[None], -1).amax(dim=1) + 1
    per_key = d * k.element_size() + (4 if route(case) else 0)
    kv_bytes = int(last.sum()) * hkv * per_key * 2
    ints = sum(case[n].numel() * 4 for n in ("block_tables", "kv_len",
                                             "q_pos", "win_start", "win_len",
                                             "anc") if n in case)
    nbytes = 2 * q.numel() * q.element_size() + kv_bytes + ints
    ops = 4 * int(allowed.sum()) * hq * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    arith = q.dtype if route(case) else k.dtype
    t_ops = ops / PEAK_OPS[str(arith).split(".")[1]]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                      else "operations")


def time_ms(torch, fn, sets, iters):
    """Mean ms per eager call from CUDA events, rotating over ``sets``
    (the host's work per call included where it exceeds the device's)."""
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


def capture(torch, fn, items):
    """A CUDA graph holding one call of ``fn`` per item, after a warm-up
    on a side stream (as capture requires); returns (graph, outputs)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for x in items[:2]:
            fn(x)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = [fn(x) for x in items]
    return graph, outs


def graph_ms(torch, fn, sets, calls=200):
    """Device ms per call: one CUDA graph holding one call of ``fn`` per
    input set, replayed between CUDA events until about ``calls`` calls
    ran. No host work sits between the events, so a call that is cheaper
    on the device than on the host is timed by the device."""
    graph, _ = capture(torch, fn, sets)
    replays = max(2, math.ceil(calls / len(sets)))
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / (replays * len(sets))
    del graph
    return ms


def kernel_fns():
    """name -> (kernel wrapper, plain version, case kind)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import tree_attention as ta
    return {
        "decode_attention_paged": (da.decode_attention_paged,
                                   da.decode_attention_paged_ref, "paged"),
        "decode_attention": (da.decode_attention, da.decode_attention_ref,
                             "contig"),
        "tree_attention_paged": (ta.tree_attention_paged,
                                 ta.tree_attention_paged_ref, "tree_paged"),
        "tree_attention": (ta.tree_attention, ta.tree_attention_ref,
                           "tree_contig"),
    }


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build(build):
    t0 = time.perf_counter()
    logs = build.build(list(KERNELS))
    log(f"[build] {len(KERNELS)} sources in parallel in "
        f"{time.perf_counter() - t0:.1f}s (nvcc -O3 sm_90a)")
    for name in KERNELS:
        if name in TRAIN_NAMES or name in MMA_SERVING:
            continue
        for line in logs[name].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    if report_mma("ssd_chunked", logs["ssd_chunked"]) != SSD_MMA_INSTANCES:
        raise SmokeFailure(f"expected {SSD_MMA_INSTANCES} bf16 ssd_chunked "
                           f"instances in the ptxas report")
    check_tensor_cores(build, "ssd_chunked")
    smma = 0
    for name in MMA_SERVING:
        smma += report_mma(name, logs[name])
        check_tensor_cores(build, name)
    if smma != SMMA_INSTANCES:
        raise SmokeFailure(f"{smma} bf16 serving instances reported, "
                           f"expected {SMMA_INSTANCES}")
    for name in TRAIN_NAMES:
        lib = build.load(name)
        smem = getattr(lib, f"{name}_smem")
        log(f"  {name}: bf16 dynamic shared memory " + ", ".join(
            f"D={d} {smem(d)} B" for d in (32, 48, 64, 128)))
        report_mma(name, logs[name])
        check_tensor_cores(build, name)


def report_mma(name, text):
    """Log each bf16 tensor-core instance's registers and spills; fail on
    a spill. Returns the number of instances."""
    report = ptxas_report(text)
    for kernel, (regs, spills) in report.items():
        log(f"  {name}: {kernel}: {regs} registers, {spills} spill bytes "
            f"(stores + loads)")
        if spills:
            raise SmokeFailure(f"{name}: {kernel} spills {spills} bytes")
    return len(report)


def ptxas_report(text):
    """{kernel: (registers, spill bytes)} from ``nvcc -Xptxas -v`` output,
    for the entries of the bf16 tensor-core kernels (namespaces tmma and
    smma, and ssd's mma_kernel), named as ``_tmma_label`` names them."""
    import re
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function "
                      r"'(_ZN(?:4[ts]mma|3ssd10mma_kernel)\w+)'", line)
        if m:
            cur = _tmma_label(m.group(1))
            out[cur] = [0, 0]
        elif "Compiling entry function" in line:
            cur = None
        elif cur and "spill stores" in line:
            nums = re.findall(r"(\d+) bytes spill", line)
            out[cur][1] = sum(int(x) for x in nums)
        elif cur and "Used" in line and "registers" in line:
            out[cur][0] = int(re.search(r"Used (\d+) registers", line).group(1))
    return {k: tuple(v) for k, v in out.items()}


def _tmma_label(mangled):
    """fwd_kernel<64, CausalMask> from tmma's mangled kernel name;
    mma_kernel<64, tree, ContigKV, int8> from smma's (its mask flag, K/V
    addressing and K/V dtype); ssd mma_kernel<nk, mt> from ssd's."""
    import re
    ssd_ = re.match(r"_ZN3ssd10mma_kernelILi(\d+)ELi(\d+)E", mangled)
    if ssd_:
        return f"ssd mma_kernel<nk={ssd_.group(1)}, mt={ssd_.group(2)}>"
    m = re.match(r"_ZN4[ts]mma(\d+)", mangled)
    name = mangled[m.end():m.end() + int(m.group(1))]
    rest = mangled[m.end() + int(m.group(1)):]
    d = re.match(r"ILi(\d+)E", rest).group(1)
    tags = [k for k in ("CausalMask", "CodMask") if k in mangled]
    flag = re.match(r"ILi\d+ELb([01])E", rest)
    if flag:
        tags.append("tree" if flag.group(1) == "1" else "causal")
    tags += [k for k in ("PagedKV", "ContigKV") if k in mangled]
    kv = re.search(r"KVELi([123])E", rest)
    if kv:
        tags.append({"1": "bf16", "2": "int8", "3": "fp8"}[kv.group(1)])
    return f"{name}<{', '.join([d] + tags)}>"


def check_tensor_cores(build, name):
    """Fail unless the SASS of every bf16 product kernel of ``name``'s
    library (tmma's fwd / dkdv / dq instances, its delta pass has no
    product; smma's serving loop, one per head dim; ssd's mma_kernel, one
    per tile plan) holds HMMA or HGMMA."""
    tool = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    seen = {}
    for chunk in sass.split("Function : ")[1:]:
        fn = chunk.split(None, 1)[0]
        if (fn.startswith("_ZN4tmma") and any(
                k in fn for k in ("fwd_kernel", "dkdv_kernel", "dq_kernel"))
                or fn.startswith("_ZN4smma") and "mma_kernel" in fn
                or fn.startswith("_ZN3ssd10mma_kernel")):
            seen[_tmma_label(fn)] = ("HGMMA" if "HGMMA" in chunk else
                                     "HMMA" if "HMMA" in chunk else None)
    want = (SSD_MMA_INSTANCES if name == "ssd_chunked" else
            SMMA_PER_KERNEL if name in MMA_SERVING else
            8 if name.endswith("_bwd") else 4)      # (dkdv, dq) x 4 head dims
    missing = [k for k, v in seen.items() if v is None]
    if len(seen) != want or missing:
        raise SmokeFailure(f"{name}: bf16 kernels without tensor-core "
                           f"instructions in SASS: {missing} (found {seen})")
    log(f"  {name}: SASS of {len(seen)} bf16 kernels: "
        + ", ".join(f"{k} {v}" for k, v in sorted(seen.items())))


def _sync(torch, dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def _tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev) for v in tree]
    return tree.to(dev)


def correctness_cases(torch):
    bf, f32 = torch.bfloat16, torch.float32
    target = dict(b=4, hq=32, hkv=8, d=128, bs=64)
    draft = dict(b=4, hq=32, hkv=8, d=64, bs=64)
    tiny = dict(b=4, hq=4, hkv=2, d=32, bs=8)
    mid = dict(b=4, hq=4, hkv=2, d=48, bs=16)        # head dim 48, G 2
    mid1 = dict(b=4, hq=2, hkv=2, d=48, bs=64)       # tiny-mid: G 1
    ragged = [1, 700, 2049, 4096]
    decode = [
        ("target bf16 ragged", dict(target, tq=9, ctx=ragged, kv_dtype=bf, q_dtype=bf)),
        ("draft bf16 ragged", dict(draft, tq=16, ctx=ragged, kv_dtype=bf, q_dtype=bf)),
        ("target fp32 ragged", dict(target, tq=9, ctx=ragged, kv_dtype=f32, q_dtype=f32)),
        ("draft fp32 ragged", dict(draft, tq=16, ctx=ragged, kv_dtype=f32, q_dtype=f32)),
        ("target bf16 window+softcap", dict(target, tq=9, ctx=[300, 1000, 64, 9],
                                            kv_dtype=bf, q_dtype=bf, window=256,
                                            softcap=30.0)),
        ("target fp32 window+softcap", dict(target, tq=9, ctx=[300, 1000, 64, 9],
                                            kv_dtype=f32, q_dtype=f32, window=100,
                                            softcap=50.0)),
        ("draft bf16-q fp32 KV", dict(draft, tq=16, ctx=[17, 333, 512, 1500],
                                      kv_dtype=f32, q_dtype=bf)),
        ("tiny fp32 D=32", dict(tiny, tq=8, ctx=[8, 30, 95, 200], kv_dtype=f32,
                                q_dtype=f32)),
        ("D=48 G=2 fp32 ragged", dict(mid, tq=9, ctx=ragged, kv_dtype=f32,
                                      q_dtype=f32)),
        ("D=48 G=2 bf16 ragged", dict(mid, tq=16, ctx=ragged, kv_dtype=bf,
                                      q_dtype=bf)),
        ("D=48 G=1 fp32", dict(mid1, tq=16, ctx=[16, 75, 300, 1000],
                               kv_dtype=f32, q_dtype=f32)),
        ("D=48 G=1 bf16", dict(mid1, tq=9, ctx=[9, 130, 257, 640],
                               kv_dtype=bf, q_dtype=bf)),
    ]
    tree_ctx = [1, 700, 2049, 4064]
    tree = [
        ("target bf16 31-slot bank window", dict(target, tq=31, ctx=tree_ctx,
                                                 kv_dtype=bf, q_dtype=bf)),
        ("target fp32 31-slot bank window", dict(target, tq=31, ctx=tree_ctx,
                                                 kv_dtype=f32, q_dtype=f32)),
        ("draft-width bf16 32 slots", dict(draft, tq=32, ctx=tree_ctx,
                                           kv_dtype=bf, q_dtype=bf)),
        ("target bf16 window+softcap", dict(target, tq=23, ctx=[300, 1000, 64, 9],
                                            kv_dtype=bf, q_dtype=bf, window=256,
                                            softcap=30.0)),
        ("draft fp32 window+softcap", dict(draft, tq=25, ctx=[300, 1000, 64, 9],
                                           kv_dtype=f32, q_dtype=f32, window=100,
                                           softcap=50.0)),
        ("tiny fp32 D=32", dict(tiny, tq=11, ctx=[5, 30, 95, 200], kv_dtype=f32,
                                q_dtype=f32)),
        ("D=48 G=2 fp32", dict(mid, tq=23, ctx=tree_ctx, kv_dtype=f32,
                               q_dtype=f32)),
        ("D=48 G=2 bf16", dict(mid, tq=32, ctx=tree_ctx, kv_dtype=bf,
                               q_dtype=bf)),
        ("D=48 G=1 fp32", dict(mid1, tq=11, ctx=[5, 30, 95, 200],
                               kv_dtype=f32, q_dtype=f32)),
        ("D=48 G=1 bf16", dict(mid1, tq=31, ctx=[1, 64, 300, 1000],
                               kv_dtype=bf, q_dtype=bf)),
    ]
    # the bf16 split-KV loop's edges, for all four kernels: clusters of 3
    # (B 4 x Hkv 8) to 8 (B <= 2) with splits that get no chunk (short
    # rows, kv_len 1, a row that sees no key, a window that leaves 2-3
    # chunks of 64), page sizes 8 / 16 / 64 (the contiguous kernels take
    # the same rows in caches of S = the longest kv_len), and G = 7, whose
    # queries straddle the 16-row mma tiles and the CTA tiles (Tq 16: 112
    # rows; Tq 36: 252 rows in two tiles of 128, query 18 across the
    # boundary; tree Tq 31: 217 rows in two of 112)
    g7 = dict(b=2, hq=14, hkv=2, d=64, kv_dtype=bf, q_dtype=bf)
    split_decode = [
        ("split bf16 empty splits, kv 1, no key", dict(
            target, tq=9, ctx=[4096, 70, 1, 0], kv_dtype=bf, q_dtype=bf)),
        ("split bf16 B=1 window removes splits", dict(
            target, b=1, tq=9, ctx=[4000], kv_dtype=bf, q_dtype=bf,
            window=100, softcap=30.0)),
        ("split bf16 G=7 Tq=16 bs 16", dict(
            target, hq=56, bs=16, tq=16, ctx=[16, 300, 1000, 2500],
            kv_dtype=bf, q_dtype=bf)),
        ("split bf16 G=7 Tq=36 two CTA tiles", dict(
            g7, bs=64, tq=36, ctx=[36, 777])),
        ("split bf16 tiny D=32 bs 8", dict(tiny, tq=8, ctx=[8, 30, 95, 200],
                                           kv_dtype=bf, q_dtype=bf)),
    ]
    split_tree = [
        ("split bf16 no key, short rows", dict(
            target, tq=31, ctx=[0, 1, 70, 4064], kv_dtype=bf, q_dtype=bf,
            dead=(0,))),
        ("split bf16 B=1 window removes splits", dict(
            target, b=1, tq=23, ctx=[4000], kv_dtype=bf, q_dtype=bf,
            window=64, softcap=30.0)),
        ("split bf16 G=7 Tq=31 two CTA tiles bs 16", dict(
            g7, bs=16, tq=31, ctx=[5, 1000])),
        ("split bf16 tiny D=32 bs 8", dict(tiny, tq=11, ctx=[5, 30, 95, 200],
                                           kv_dtype=bf, q_dtype=bf)),
    ]
    # contiguous rows end at S: kv_len past S (row 1's queries straddle S,
    # q_pos up to 1029), and tree windows that end at S (row 0: 993 + 31)
    # or cross it (row 1: keys 1000 .. 1023 of its 31 slots exist)
    past_s = [(f"S=1024 kv_len > S {dt}", dict(
        target, tq=9, ctx=[1000, 1030, 700, 1024], s=1024, kv_dtype=t,
        q_dtype=t)) for dt, t in (("bf16", bf), ("fp32", f32))]
    window_at_s = [(f"S=1024 window ends at S {dt}", dict(
        target, tq=31, ctx=[993, 1000, 64, 0], s=1024, template=WIDE,
        kv_dtype=t, q_dtype=t)) for dt, t in (("bf16", bf), ("fp32", f32))]
    # int8 / fp8 K/V with f32 scales: bf16 q on the tensor-core loop's
    # 8-bit route at D 128 / 64 / 48 / 32, G 4 and 7, pages of 64 / 16 / 8,
    # window + softcap, the 31-slot window, rows that see no key, empty
    # splits; f32 q on the f32 loop's dequantizing route
    quant_decode, quant_tree, quant_past_s, quant_at_s = [], [], [], []
    for name, qd in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        kq = dict(kv_dtype=qd, q_dtype=bf)
        quant_decode += [
            (f"{name} target D=128 G=4 ragged", dict(target, tq=9, ctx=ragged, **kq)),
            (f"{name} draft D=64 bs 16", dict(draft, bs=16, tq=16,
                                               ctx=[16, 300, 1000, 2500], **kq)),
            (f"{name} D=48 G=2 bs 16", dict(mid, tq=16, ctx=ragged, **kq)),
            (f"{name} D=32 bs 8", dict(tiny, tq=8, ctx=[8, 30, 95, 200], **kq)),
            (f"{name} G=7 Tq=36 two CTA tiles", dict(g7, bs=64, tq=36, ctx=[36, 777],
                                                      kv_dtype=qd)),
            (f"{name} window+softcap", dict(target, tq=9, ctx=[300, 1000, 64, 9],
                                            window=256, softcap=30.0, **kq)),
            (f"{name} empty splits, kv 1, no key", dict(target, tq=9,
                                                        ctx=[4096, 70, 1, 0], **kq)),
            (f"{name} fp32 q, f32 loop", dict(target, tq=9, ctx=ragged, kv_dtype=qd,
                                              q_dtype=f32)),
            (f"{name} fp32 q D=48 window+softcap", dict(
                mid, tq=16, ctx=[300, 1000, 64, 16], window=100, softcap=50.0,
                kv_dtype=qd, q_dtype=f32)),
        ]
        quant_tree += [
            (f"{name} target 31-slot bank window", dict(target, tq=31, ctx=tree_ctx, **kq)),
            (f"{name} no key, short rows", dict(target, tq=31, ctx=[0, 1, 70, 4064],
                                                dead=(0,), **kq)),
            (f"{name} window+softcap", dict(target, tq=23, ctx=[300, 1000, 64, 9],
                                            window=256, softcap=30.0, **kq)),
            (f"{name} G=7 Tq=31 two CTA tiles bs 16", dict(g7, bs=16, tq=31,
                                                            ctx=[5, 1000], kv_dtype=qd)),
            (f"{name} D=48 G=2 32 slots", dict(mid, tq=32, ctx=tree_ctx, **kq)),
            (f"{name} D=32 bs 8", dict(tiny, tq=11, ctx=[5, 30, 95, 200], **kq)),
            (f"{name} D=64 32 slots", dict(draft, tq=32, ctx=tree_ctx, **kq)),
            (f"{name} fp32 q, f32 loop", dict(target, tq=31, ctx=tree_ctx, kv_dtype=qd,
                                              q_dtype=f32)),
        ]
        quant_past_s.append((f"{name} S=1024 kv_len > S", dict(
            target, tq=9, ctx=[1000, 1030, 700, 1024], s=1024, **kq)))
        quant_at_s.append((f"{name} S=1024 window ends at S", dict(
            target, tq=31, ctx=[993, 1000, 64, 0], s=1024, template=WIDE, **kq)))
    return {"decode_attention_paged": decode + split_decode + quant_decode,
            "decode_attention": decode + split_decode + past_s + quant_decode
            + quant_past_s,
            "tree_attention_paged": tree + split_tree + quant_tree,
            "tree_attention": tree + split_tree + window_at_s + quant_tree
            + quant_at_s}


def oracle(ref, case):
    """The plain version of a case. An 8-bit case's comes in f32 (the same
    arithmetic on q widened): the kernel's bf16 output is then its only
    rounding, where a second one, to bf16, could put the two a bf16 ulp
    apart (0.031 once |out| >= 4) with both correct."""
    if route(case):
        case = dict(case, q=case["q"].float())
    return ref(**case)


def phase_correctness(torch, args, dev="cuda"):
    """Every case against its plain version. Returns the worst error per
    kernel (bf16 / fp32 K/V) and per (kernel, route) of the 8-bit K/V."""
    import numpy as np
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rng = np.random.default_rng(args.seed)
    fns = kernel_fns()
    worst = {}
    for name, cases in correctness_cases(torch).items():
        fn, ref, kind = fns[name]
        worst[name] = 0.0
        for label, kw in cases:
            case = make_case(torch, gen, rng, kind, dev=dev, **kw)
            out = fn(**case)
            _sync(torch, dev)
            want = oracle(ref, case)
            if not torch.isfinite(out).all():
                raise SmokeFailure(f"{name} output not finite ({label})")
            err = (out.float() - want.float()).abs().max().item()
            tol = TOL[str(case["q"].dtype).split(".")[1]]
            log(f"[kernel vs plain] {name} {label}: max_abs_err={err:.3e} "
                f"tol={tol:g}")
            if not err <= tol:
                raise SmokeFailure(f"{name} disagrees with its plain version "
                                   f"({label}): {err} > {tol}")
            key = (name, route(case)) if route(case) else name
            worst[key] = max(worst.get(key, 0.0), err)
    return worst


def phase_split_kv(torch, args, dev="cuda"):
    """The split-KV loop of the four serving kernels, bf16 K/V and the int8
    and fp8 routes: two calls are bitwise equal; a call captured in a CUDA
    graph, replayed after kv_len and q_pos are rewritten in place, matches
    the plain version on the new values."""
    import numpy as np
    gen = torch.Generator(device=dev).manual_seed(args.seed + 3)
    rng = np.random.default_rng(args.seed + 3)
    fns = kernel_fns()
    bf = torch.bfloat16
    shape = dict(b=4, hq=32, hkv=8, d=128, bs=64, q_dtype=bf,
                 ctx=[300, 1000, 2049, 4000])
    worst = {}
    decode, tree = dict(shape, tq=9), dict(shape, tq=31, window=200)
    for (name, kw), kv_dtype in ((nk, kd) for kd in (bf, torch.int8,
                                                     torch.float8_e4m3fn)
                                 for nk in (("decode_attention_paged", decode),
                                            ("decode_attention", decode),
                                            ("tree_attention_paged", tree),
                                            ("tree_attention", tree))):
        fn, ref, kind = fns[name]
        case = make_case(torch, gen, rng, kind, dev=dev, kv_dtype=kv_dtype, **kw)
        key = (name, route(case)) if route(case) else name
        name_r = f"{name} {route(case)}" if route(case) else name
        first, second = fn(**case), fn(**case)
        _sync(torch, dev)
        same = torch.equal(first, second)
        log(f"[split-kv] {name_r}: two calls bitwise equal: {same}")
        if not same:
            raise SmokeFailure(f"{name_r}: two calls differ")
        graph, (out,) = capture(torch, lambda c: fn(**c), [case])
        # new contents, same tensors: causal rows 37 keys shorter; tree rows
        # lose their last 3 window slots and move their logical positions
        if "anc" in case:
            case["kv_len"] -= 3
            case["q_pos"] += 1
        else:
            case["kv_len"] -= 37
            case["q_pos"] -= 37
        graph.replay()
        _sync(torch, dev)
        err = (out.float() - oracle(ref, case).float()).abs().max().item()
        log(f"[split-kv] {name_r}: CUDA graph replayed with rewritten kv_len "
            f"and q_pos vs plain: max_abs_err={err:.3e} tol={TOL['bfloat16']:g}")
        if not err <= TOL["bfloat16"]:
            raise SmokeFailure(f"{name_r}: graph replay disagrees with the "
                               f"plain version: {err}")
        worst[key] = err
        del graph
    return worst


def timing_rows(torch, args):
    """(kernel, label, case kwargs); the first row of each kernel is its
    main row, at the full-width engine's shapes; each kernel also has a
    row at kv 1k-4k; then the int8 and fp8 routes of each kernel at the
    engine's shapes (its first such row is the route's row) and at kv
    1k-4k."""
    bf, f32 = torch.bfloat16, torch.float32
    ctx = [args.prompt_len + args.max_new // 2 + 16 * i for i in range(4)]
    target = dict(b=4, hq=32, hkv=8, d=128, bs=64, kv_dtype=bf, q_dtype=bf)
    draft = dict(b=4, hq=32, hkv=8, d=64, bs=64, kv_dtype=bf, q_dtype=bf)
    # the contiguous engine keeps full rows of max_len (1024) positions
    contig = dict(s=1024)
    quant = []
    for name, qd in (("int8", torch.int8), ("fp8", torch.float8_e4m3fn)):
        tq = dict(target, kv_dtype=qd)
        quant += [
            ("decode_attention_paged", f"{name} target verify @engine ctx",
             dict(tq, tq=9, ctx=ctx)),
            ("decode_attention_paged", f"{name} draft window @engine ctx",
             dict(draft, kv_dtype=qd, tq=16, ctx=[c - 9 for c in ctx])),
            ("decode_attention_paged", f"{name} target verify @ctx 1k-4k",
             dict(tq, tq=9, ctx=[1024, 2048, 3072, 4096])),
            ("tree_attention_paged", f"{name} tree verify 31 slots @engine ctx",
             dict(tq, tq=31, ctx=ctx, template=WIDE)),
            ("tree_attention_paged", f"{name} tree verify 31 slots @ctx 1k-4k",
             dict(tq, tq=31, ctx=[1024, 2048, 3072, 4064], template=WIDE)),
            ("decode_attention", f"{name} target verify @engine ctx",
             dict(tq, tq=9, ctx=ctx, **contig)),
            ("decode_attention", f"{name} target verify @ctx 1k-4k",
             dict(tq, tq=9, ctx=[1024, 2048, 3072, 4096], s=4096)),
            ("tree_attention", f"{name} tree verify 31 slots @engine ctx",
             dict(tq, tq=31, ctx=ctx, template=WIDE, **contig)),
            ("tree_attention", f"{name} tree verify 31 slots @ctx 1k-4k",
             dict(tq, tq=31, ctx=[1024, 2048, 3072, 4064], template=WIDE,
                  s=4096)),
        ]
    return [
        ("decode_attention_paged", "target verify @engine ctx",
         dict(target, tq=9, ctx=ctx)),
        ("decode_attention_paged", "draft window @engine ctx",
         dict(draft, tq=16, ctx=[c - 9 for c in ctx])),
        ("decode_attention_paged", "target verify @ctx 1k-4k",
         dict(target, tq=9, ctx=[1024, 2048, 3072, 4096])),
        ("decode_attention_paged", "target verify fp32 @engine ctx",
         dict(target, tq=9, ctx=ctx, kv_dtype=f32, q_dtype=f32)),
        ("decode_attention_paged", "draft window D=48 @engine ctx",
         dict(draft, d=48, tq=16, ctx=[c - 9 for c in ctx])),
        ("tree_attention_paged", "tree verify 31 slots @engine ctx",
         dict(target, tq=31, ctx=ctx, template=WIDE)),
        ("tree_attention_paged", "tree verify 31 slots @ctx 1k-4k",
         dict(target, tq=31, ctx=[1024, 2048, 3072, 4064], template=WIDE)),
        ("decode_attention", "target verify @engine ctx",
         dict(target, tq=9, ctx=ctx, **contig)),
        ("decode_attention", "draft window D=64 @engine ctx",
         dict(draft, tq=16, ctx=[c - 9 for c in ctx], **contig)),
        ("decode_attention", "target verify @ctx 1k-4k",
         dict(target, tq=9, ctx=[1024, 2048, 3072, 4096], s=4096)),
        ("tree_attention", "tree verify 31 slots @engine ctx",
         dict(target, tq=31, ctx=ctx, template=WIDE, **contig)),
        ("tree_attention", "tree verify 31 slots @ctx 1k-4k",
         dict(target, tq=31, ctx=[1024, 2048, 3072, 4064], template=WIDE,
              s=4096)),
    ] + quant


def phase_timing(torch, F, args):
    import numpy as np
    from repro_torch.kernels.tree_attention import anc_int32
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 7)
    rng = np.random.default_rng(args.seed + 7)
    fns = kernel_fns()
    results = {}

    def timing_case(kind, kw):
        case = make_case(torch, gen, rng, kind, poison=False, **kw)
        if "anc" in case:
            # the int32 bits the model hands the tree kernels (converted
            # once per forward), so the timing holds no conversion
            case["anc"] = anc_int32(case["anc"])
        return case

    for name, label, kw in timing_rows(torch, args):
        fn, ref, kind = fns[name]
        first = timing_case(kind, kw)
        per_set = sum(t.numel() * t.element_size() for t in first.values()
                      if hasattr(t, "numel"))
        n_sets = max(2, math.ceil(COLD_BYTES / per_set))
        sets = [first] + [timing_case(kind, kw) for _ in range(n_sets - 1)]

        def call(c):
            return fn(**c)

        ms = graph_ms(torch, call, sets)
        eager = time_ms(torch, call, sets, 200)
        plain = time_ms(torch, lambda c: ref(**c), sets, 20)
        # library yardstick: one SDPA call with the boolean mask over the
        # pre-gathered KV (not used by the port), timed the same two ways.
        # No PyTorch call attends over 8-bit K/V: for those rows SDPA over
        # the pre-dequantized bf16 K/V is a labelled yardstick, not a
        # library time of the same function
        lib_sets = []
        for c in sets:
            kc, vc = (x.to(c["q"].dtype) for x in _kv(c))
            lib_sets.append((c["q"].transpose(1, 2), kc.transpose(1, 2),
                             vc.transpose(1, 2),
                             allowed_mask(torch, c)[:, None]))

        def sdpa(x):
            return F.scaled_dot_product_attention(
                x[0], x[1], x[2], attn_mask=x[3], enable_gqa=True)

        lib = graph_ms(torch, sdpa, lib_sets)
        lib_eager = time_ms(torch, sdpa, lib_sets, 50)
        bnd, by = bound_ms(torch, first)
        quant = route(first)
        sdpa_name = "sdpa over dequantized bf16 K/V" if quant else "sdpa"
        log(f"[timing] {name} {label}: kernel {ms:.4f} ms (eager "
            f"{eager:.4f}), plain {plain:.4f} ms, {sdpa_name} {lib:.4f} ms "
            f"(eager {lib_eager:.4f}), bound {bnd:.5f} ms ({by}); device "
            f"times from a CUDA graph of {len(sets)} input sets, "
            f"ctx={kw['ctx']}")
        if quant:
            row = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bnd,
                       bound_by=by, sdpa_dequantized_bf16_ms=lib)
        else:
            row = dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=bnd,
                       bound_by=by)
        entry = results.setdefault(name, dict(row, timings=[]))
        if quant:
            entry.setdefault(quant, row)
        entry["timings"].append(dict(row, label=label, eager_ms=eager,
                                     library_eager_ms=lib_eager))
        del sets, lib_sets, first
        torch.cuda.empty_cache()
    return results


def _tiny_engine_tokens(torch, Engine, EngineConfig, models, prompts, dev,
                        max_batch=3, **kw):
    tc, tp, dc, dp = models
    eng = Engine(tp, tc, dp, dc, config=EngineConfig(
        max_batch=max_batch, max_len=256, kv_block_size=16, kv_dtype="fp32",
        **kw), device=dev)
    rids = {eng.submit(p, 24): i for i, p in enumerate(prompts)}
    toks = {rids[c.rid]: c.tokens for c in eng.run()}
    return toks, eng.stats["accepted"], eng.stats["steps"]


def phase_reference(torch, args, dev="cuda"):
    """tiny-target / tiny-draft in fp32: card vs CPU logits; flat PARD,
    trees and a chain on both layouts all give the AR tokens."""
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
        pools = kv_pool.init_paged_caches(tc, 2, 9, 8, torch.float32, where)
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
    models = (tc, tp, dc, dp)
    runs = {
        "ar": dict(mode="ar", k=4),
        "pard paged": dict(k=4),
        "pard contiguous": dict(k=4, kv_layout="contiguous"),
        "chain (1,1,1,1) paged": dict(tree=(1, 1, 1, 1)),
        "tree (2,2,1,1) paged": dict(tree=(2, 2, 1, 1)),
        "tree (2,2,1,1) contiguous": dict(tree=(2, 2, 1, 1),
                                          kv_layout="contiguous"),
        "adaptive tree paged": dict(k=4, adaptive_tree=True),
    }
    got = {name: _tiny_engine_tokens(torch, Engine, EngineConfig, models,
                                     prompts, dev, **kw)
           for name, kw in runs.items()}
    for name, (toks_, acc, steps) in got.items():
        same = all(np.array_equal(toks_[i], got["ar"][0][i])
                   for i in range(len(prompts)))
        log(f"[reference] tiny fp32 engine on the card, {name}: tokens == AR "
            f"tokens for {len(prompts)} requests: {same}; accepted={acc} "
            f"steps={steps}")
        if not same:
            raise SmokeFailure(f"greedy {name} tokens differ from AR tokens")
    pairs = (("chain (1,1,1,1) paged", "pard paged"),
             ("pard contiguous", "pard paged"),
             ("tree (2,2,1,1) contiguous", "tree (2,2,1,1) paged"))
    for a, b in pairs:
        ok = got[a][1:] == got[b][1:]
        log(f"[reference] {a} == {b} in accepted drafts and steps: {ok}")
        if not ok:
            raise SmokeFailure(f"{a} and {b} accept differently")


def _layers(cfg):
    """(attention layers, Mamba2 layers) of a config."""
    from repro_torch.models.config import SSM, layer_plan
    ssm = sum(s.mixer == SSM for s in layer_plan(cfg))
    return cfg.num_layers - ssm, ssm


def expected_launches(mode, tc, dc, cfg, steps, prefill_steps):
    """Launches per kernel of an engine run: one attention launch per
    attention layer per forward; for Mamba2 layers one ssd_chunked per
    layer per forward and one more per layer where the forward's states
    are gathered (every PARD forward, and the AR forwards of the
    ``prefill_steps``, whose window is widened with pads)."""
    flat = "decode_attention_paged" if cfg.paged else "decode_attention"
    tree = "tree_attention_paged" if cfg.paged else "tree_attention"
    (ta, ts), (da, ds) = _layers(tc), _layers(dc) if dc else (0, 0)
    if mode == "ar":
        want = {flat: ta * steps, "ssd_chunked": ts * (steps + prefill_steps)}
    elif cfg.tree is None:
        want = {flat: (ta + da) * steps,
                "ssd_chunked": 2 * (ts + ds) * steps}
    else:
        want = {flat: da * steps, tree: ta * steps}
    return {k: v for k, v in want.items() if v}


def serve(torch, kernels, Engine, cfg, tp, tc, dp, dc, prompts, max_new,
          label, dev):
    eng = Engine(tp, tc, dp, dc, config=cfg, device=dev)
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
    launches = dict(kernels.launches)         # just after
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    steps = eng.stats["steps"]
    want = expected_launches(cfg.mode, tc, dc, cfg, steps,
                             eng.stats["prefill_steps"])
    gen = sum(c.generated for c in comps)
    lat = eng.latency_summary()
    hist = (f" tree_hist={eng.stats['tree_hist'].tolist()} "
            f"switches={eng.stats['tree_switches']} bank={eng.bank.key}"
            if eng.bank is not None else "")
    log(f"[engine {label}] {len(comps)} requests, {gen} tokens in "
        f"{wall:.2f}s = {gen / wall:.1f} tok/s; steps={steps} "
        f"mean_accepted={eng.mean_accepted():.3f} "
        f"step_p50={lat['step_p50_ms']:.2f}ms "
        f"step_p95={lat['step_p95_ms']:.2f}ms "
        f"peak_mem={peak / 2**30:.2f}GiB "
        f"kv_capacity={eng.kv_capacity_bytes() / 2**20:.0f}MiB;{hist} "
        f"launches={launches} (expected {want})")
    if len(comps) != len(prompts) or any(c.generated != max_new
                                         for c in comps):
        raise SmokeFailure(f"engine {label} did not complete every request")
    for c in comps:
        if not (0 <= c.tokens.min() and c.tokens.max() < tc.vocab_size):
            raise SmokeFailure(f"engine {label} emitted tokens outside the "
                               f"vocab")
    if dev == "cuda" and launches != want:
        raise SmokeFailure(f"engine {label}: launches {launches}, expected "
                           f"{want}")
    return {c.rid: c.tokens for c in comps}, launches, eng.kv_capacity_bytes()


def phase_engine(torch, kernels, args, target="llama3.1-8b",
                 draft="llama3.2-1b", dev="cuda"):
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.training.optimizer import leaves

    tc, dc = get_config(target), get_config(draft)
    t0 = time.perf_counter()
    tp = init_params(tc, args.seed, dev, torch.bfloat16)
    dp = init_params(dc, args.seed + 1, dev, torch.bfloat16)
    _sync(torch, dev)
    n_params = sum(t.numel() for tree in (tp, dp) for t in leaves(tree))
    log(f"[engine] {target} + {draft} random bf16 weights "
        f"({n_params / 1e9:.2f}B params) on the card in "
        f"{time.perf_counter() - t0:.1f}s; EngineConfig defaults "
        f"{EngineConfig()}")
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, tc.vocab_size, size=args.prompt_len)
               for _ in range(args.requests)]
    # the quantized runs: the int8 route of decode_attention_paged and the
    # fp8 route of tree_attention_paged, each beside its bf16 run
    runs = [
        ("pard paged", EngineConfig(), "decode_attention_paged"),
        ("ar paged", EngineConfig(mode="ar"), None),
        ("adaptive tree paged", EngineConfig(adaptive_tree=True),
         "tree_attention_paged"),
        ("pard contiguous", EngineConfig(kv_layout="contiguous"),
         "decode_attention"),
        (f"tree {','.join(map(str, WIDE))} contiguous",
         EngineConfig(tree=WIDE, kv_layout="contiguous"), "tree_attention"),
        ("pard paged int8", EngineConfig(kv_dtype="int8"),
         ("decode_attention_paged", "int8")),
        ("adaptive tree paged fp8", EngineConfig(adaptive_tree=True,
                                                 kv_dtype="fp8"),
         ("tree_attention_paged", "fp8")),
    ]
    bf16_of = {"pard paged int8": "pard paged",
               "adaptive tree paged fp8": "adaptive tree paged"}
    tokens, main_launches, capacity = {}, {}, {}
    for label, cfg, main in runs:
        # warm-up per configuration (library handles, allocator pools),
        # not counted
        warm = Engine(tp, tc, dp, dc, config=cfg, device=dev)
        warm.submit(prompts[0][:32], 8)
        warm.run()
        del warm
        d_p, d_c = (None, None) if cfg.mode == "ar" else (dp, dc)
        tokens[label], launches, capacity[label] = serve(
            torch, kernels, Engine, cfg, tp, tc, d_p, d_c, prompts,
            args.max_new, label, dev)
        if main is not None:
            kernel = main[0] if isinstance(main, tuple) else main
            main_launches[main] = launches.get(kernel, 0)
        if dev == "cuda":
            torch.cuda.empty_cache()

    def first_divergence(label, base):
        shares = []
        for rid, toks in tokens[label].items():
            a, b = toks[args.prompt_len:], tokens[base][rid][args.prompt_len:]
            diff = np.nonzero(a != b)[0]
            shares.append((diff[0] if diff.size else len(a)) / len(a))
        return (f"mean {np.mean(shares):.3f} per request "
                f"{[round(float(s), 3) for s in shares]}")

    for label in tokens:
        if label == "ar paged":
            continue
        log(f"[ar comparison] {label}: share of tokens equal to AR tokens up "
            f"to the first divergence: {first_divergence(label, 'ar paged')}")
    for label, base in bf16_of.items():
        log(f"[quantized kv] {label}: kv_capacity {capacity[label]} B = "
            f"{capacity[label] / capacity[base]:.4f} x the bf16 run's "
            f"{capacity[base]} B (scales included); share of tokens equal to "
            f"the bf16 run's up to the first divergence: "
            f"{first_divergence(label, base)}")
    return main_launches


# ---------------------------------------------------------------------------
# the Mamba2 SSD scan and Mamba2 serving
# ---------------------------------------------------------------------------

SSD_SHAPES = {"mamba2-130m": dict(h=24, p=64, n=128),
              "tiny": dict(h=2, p=32, n=16)}
# the bf16 kernel's ragged edges: a last 16-row block of P with 8 rows, and
# N off the warps' 16-column k-steps
SSD_EDGE = dict(h=3, p=40, n=24)
SSD_MMA_INSTANCES = 6               # nk 1, 2 x mt 1, 2, 4 (ssd_tile_plan)


def ssd_case(torch, gen, *, b, t, h, p, n, dtype, chunk, init=True,
             dev="cuda"):
    """Inputs of one ssd_chunked call: x, B, C in ``dtype``; dt (softplus),
    A (negative) and a nonzero init_state (None without ``init``) in f32."""
    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    return dict(x=rnd(b, t, h, p).to(dtype),
                dt=torch.nn.functional.softplus(rnd(b, t, h) - 1.0),
                A=-torch.exp(rnd(h) * 0.5), B=rnd(b, t, n).to(dtype),
                C=rnd(b, t, n).to(dtype),
                init_state=rnd(b, h, p, n) * 0.1 if init else None,
                chunk=chunk)


def _ssd_args(c):
    return c["x"], c["dt"], c["A"], c["B"], c["C"], c["init_state"]


def _scaled_err(torch, got, want):
    """(max |got - want| / max(1, |want|), max |got - want|)."""
    diff = (got.float() - want.float()).abs()
    return ((diff / want.float().abs().clamp(min=1.0)).max().item(),
            diff.max().item())


def _ssd_check(torch, ssd, c, label, dev):
    """One ssd_chunked call against its plain version; returns the larger
    max abs error of y and the final state."""
    t = c["x"].shape[1]
    y, st = ssd.ssd_chunked(*_ssd_args(c), chunk=c["chunk"])
    _sync(torch, dev)
    wy, ws = ssd.ssd_chunked_ref(*_ssd_args(c),
                                 chunk=ssd.clamp_chunk(c["chunk"], t))
    tol = TOL[str(c["x"].dtype).split(".")[1]]
    (sy, ay), (ss, as_) = (_scaled_err(torch, y, wy),
                           _scaled_err(torch, st, ws))
    log(f"[kernel vs plain] ssd_chunked {label}: max_abs_err y={ay:.3e} "
        f"state={as_:.3e} (check |err| <= {tol:g} * max(1, |plain|))")
    if not (torch.isfinite(y).all() and torch.isfinite(st).all()):
        raise SmokeFailure(f"ssd_chunked not finite ({label})")
    if not max(sy, ss) <= tol:
        raise SmokeFailure(f"ssd_chunked disagrees with its plain version "
                           f"({label}): {max(sy, ss)} > {tol}")
    return max(ay, as_)


def phase_ssd_correctness(torch, args, dev="cuda"):
    """ssd_chunked against its plain version on the card (y and final
    state): at the mamba2-130m and tiny shapes, t from 1 to 2048, chunk 16
    and 64, bf16 and fp32; then the bf16 kernel's edges (a ragged P block
    and N, init_state None), two calls bitwise equal, a call captured in a
    CUDA graph replayed on new inputs (bitwise equal to an eager call on
    them), a fully masked window (the state bit for bit), and the gather
    route (dt = 0 past a random per-row index) against the token-by-token
    oracle's collected states: |kernel - plain| <= tol * max(1, |plain|)."""
    from repro_torch.kernels import ssd
    gen = torch.Generator(device=dev).manual_seed(args.seed + 17)
    worst = 0.0
    for shape, dims in SSD_SHAPES.items():
        for t in (1, 9, 16, 17, 50, 65, 2048):
            for chunk in (16, 64):
                for dtype in (torch.bfloat16, torch.float32):
                    c = ssd_case(torch, gen, b=4, t=t, dtype=dtype,
                                 chunk=chunk, dev=dev, **dims)
                    worst = max(worst, _ssd_check(
                        torch, ssd, c, f"{shape} t={t} chunk={chunk} {dtype}",
                        dev))
        for t in (9, 16):
            for dtype in (torch.bfloat16, torch.float32):
                c = ssd_case(torch, gen, b=4, t=t, dtype=dtype, chunk=64,
                             dev=dev, **dims)
                idx = torch.randint(0, t, (4,), generator=gen, device=dev)
                keep = torch.arange(t, device=dev)[None] <= idx[:, None]
                x, dt, A, B, C, s0 = _ssd_args(c)
                _, st = ssd.ssd_chunked(x, dt * keep[..., None], A, B, C, s0,
                                        chunk=64)
                _sync(torch, dev)
                _, states = ssd.ssd_ref(x, dt, A, B, C, s0,
                                        collect_states=True)
                want = states[torch.arange(4, device=dev), idx]
                tol = TOL[str(dtype).split(".")[1]]
                sg, ag = _scaled_err(torch, st, want)
                label = f"{shape} t={t} {dtype} idx={idx.tolist()}"
                log(f"[kernel vs plain] ssd_chunked gather route {label}: "
                    f"max_abs_err state={ag:.3e} (check |err| <= {tol:g} * "
                    f"max(1, |plain|))")
                if not sg <= tol:
                    raise SmokeFailure(f"ssd_chunked gather route disagrees "
                                       f"({label}): {sg} > {tol}")
                worst = max(worst, ag)
    for dtype in (torch.bfloat16, torch.float32):
        for t, chunk, init in ((9, 64, True), (50, 16, True), (65, 64, False)):
            c = ssd_case(torch, gen, b=2, t=t, dtype=dtype, chunk=chunk,
                         init=init, dev=dev, **SSD_EDGE)
            worst = max(worst, _ssd_check(
                torch, ssd, c, f"P-block edge {SSD_EDGE} t={t} chunk={chunk} "
                f"init={init} {dtype}", dev))
        c = ssd_case(torch, gen, b=4, t=16, dtype=dtype, chunk=64, init=False,
                     dev=dev, **SSD_SHAPES["mamba2-130m"])
        worst = max(worst, _ssd_check(
            torch, ssd, c, f"mamba2-130m t=16 init_state=None {dtype}", dev))
        _ssd_repeat_and_graph(torch, ssd, gen, dtype, dev)
        c = ssd_case(torch, gen, b=4, t=16, dtype=dtype, chunk=64, dev=dev,
                     **SSD_SHAPES["mamba2-130m"])
        x, dt, A, B, C, s0 = _ssd_args(c)
        _, same = ssd.ssd_chunked(x, dt * 0, A, B, C, s0, chunk=64)
        _sync(torch, dev)
        log(f"[kernel vs plain] ssd_chunked fully masked window {dtype}: "
            f"state == init_state bit for bit: {torch.equal(same, s0)}")
        if not torch.equal(same, s0):
            raise SmokeFailure(f"ssd_chunked: a fully masked window moved the "
                               f"state ({dtype})")
    return {"ssd_chunked": worst}


def _ssd_repeat_and_graph(torch, ssd, gen, dtype, dev):
    """Two calls at the verify window's shapes are bitwise equal; a call
    captured in a CUDA graph, replayed after new inputs are copied into
    its buffers, equals an eager call on them bit for bit."""
    c = ssd_case(torch, gen, b=4, t=9, dtype=dtype, chunk=64, dev=dev,
                 **SSD_SHAPES["mamba2-130m"])
    args = _ssd_args(c)
    first, second = (ssd.ssd_chunked(*args, chunk=64) for _ in range(2))
    _sync(torch, dev)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    graph, outs = capture(torch, lambda a: ssd.ssd_chunked(*a, chunk=64),
                          [args])
    new = _ssd_args(ssd_case(torch, gen, b=4, t=9, dtype=dtype, chunk=64,
                             dev=dev, **SSD_SHAPES["mamba2-130m"]))
    for buf, val in zip(args, new):
        buf.copy_(val)
    graph.replay()
    _sync(torch, dev)
    eager = ssd.ssd_chunked(*new, chunk=64)
    _sync(torch, dev)
    replay = all(torch.equal(a, b) for a, b in zip(outs[0], eager))
    log(f"[kernel vs plain] ssd_chunked {dtype}: two calls bitwise equal: "
        f"{same}; CUDA-graph replay on new inputs == eager call: {replay}")
    if not (same and replay):
        raise SmokeFailure(f"ssd_chunked is not deterministic or does not "
                           f"replay ({dtype}): repeat {same}, replay {replay}")
    del graph


def ssd_bound_ms(c):
    """Least time on the card for one call: bytes (x, dt, A, B, C and the
    init state read once, y and the final state written once) at the memory
    rate, vs the FLOPs these t tokens need (per chunk of l real tokens and
    head: l(l+1)/2 (N + P) multiply-adds for C B^T and the intra-chunk
    product over j <= i, 2 l P N for the state term and the state update)
    at the peak rate of x's type; the larger of the two."""
    from repro_torch.kernels import ssd
    x, bm = c["x"], c["B"]
    b, t, h, p = x.shape
    n = bm.shape[-1]
    el = x.element_size()
    nbytes = (2 * x.numel() * el + 2 * bm.numel() * el + c["dt"].numel() * 4
              + c["A"].numel() * 4 + 2 * b * h * p * n * 4)
    chunk = ssd.clamp_chunk(c["chunk"], t)
    macs = sum(l * (l + 1) // 2 * (n + p) + 2 * l * p * n
               for l in (min(chunk, t - c0) for c0 in range(0, t, chunk)))
    t_ops = 2 * macs * b * h / PEAK_OPS[str(x.dtype).split(".")[1]]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops
                                      else "operations")


def phase_ssd_timing(torch, args, dev="cuda"):
    """ssd_chunked by device time (eager beside) and its plain version at
    the Mamba2 serving shapes (mamba2-130m, B=4, bf16: the verify / AR
    window t=9 and the draft window t=16, chunk 16 after the clamp) and
    one long call (t=2048, chunk 64), beside the bound. No single PyTorch
    call computes this scan: library none."""
    from repro_torch.kernels import ssd
    gen = torch.Generator(device=dev).manual_seed(args.seed + 19)
    dims = SSD_SHAPES["mamba2-130m"]
    result = None
    for label, t in (("verify window t=9", 9), ("draft window t=16", 16),
                     ("long scan t=2048", 2048)):
        first = ssd_case(torch, gen, b=4, t=t, dtype=torch.bfloat16,
                         chunk=64, dev=dev, **dims)
        per_set = sum(v.numel() * v.element_size() for v in first.values()
                      if hasattr(v, "numel"))
        sets = [first] + [ssd_case(torch, gen, b=4, t=t, dtype=torch.bfloat16,
                                   chunk=64, dev=dev, **dims)
                          for _ in range(max(2, math.ceil(COLD_BYTES /
                                                          per_set)) - 1)]
        def call(c):
            return ssd.ssd_chunked(*_ssd_args(c), chunk=c["chunk"])

        ms = graph_ms(torch, call, sets, 200 if t < 100 else 20)
        eager = time_ms(torch, call, sets, 200 if t < 100 else 20)
        chunk = ssd.clamp_chunk(64, t)
        plain = time_ms(torch, lambda c: ssd.ssd_chunked_ref(
            *_ssd_args(c), chunk=chunk), sets, 20 if t < 100 else 3)
        bnd, by = ssd_bound_ms(first)
        log(f"[timing] ssd_chunked {label} B=4 H=24 P=64 N=128 chunk={chunk} "
            f"bf16: kernel {ms:.4f} ms (eager {eager:.4f}), plain {plain:.4f} "
            f"ms, library none, bound {bnd:.5f} ms ({by}); device time from a "
            f"CUDA graph of {len(sets)} input sets")
        row = dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=bnd,
                   bound_by=by)
        if result is None:          # the main row: the verify window
            result = dict(row, timings=[])
        result["timings"].append(dict(row, label=label, eager_ms=eager))
        del sets, first
        torch.cuda.empty_cache()
    return {"ssd_chunked": result}


def phase_reference_ssm(torch, args, dev="cuda"):
    """fp32 on the card: tiny-target with the head-dim-48 tiny-mid draft,
    tiny-ssm and the dense hybrid (target = draft) — forward logits of the
    SSM models against the CPU plain path, and PARD tokens equal to AR
    tokens on paged and contiguous KV, max_batch 2 with 3 requests (a
    recycled slot)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params
    from repro_torch.models.config import ModelConfig
    from repro_torch.serving import kv_pool
    from repro_torch.serving.engine import Engine, EngineConfig

    rng = np.random.default_rng(args.seed + 23)
    pairs = {"tiny-target + tiny-mid (D=48)": ("tiny-target", "tiny-mid"),
             "tiny-ssm": ("tiny-ssm", None), "dense hybrid": ("hybrid", None)}
    for label, (tname, dname) in pairs.items():
        tc = ModelConfig(**HYBRID) if tname == "hybrid" else get_config(tname)
        tp_cpu = init_params(tc, args.seed, "cpu", torch.float32)
        if dname is None:
            dc, dp_cpu = tc, tp_cpu
        else:
            dc = get_config(dname)
            dp_cpu = init_params(dc, args.seed + 1, "cpu", torch.float32)
        tp, dp = _tree_to(tp_cpu, dev), _tree_to(dp_cpu, dev)
        if dname is None:
            toks = torch.from_numpy(rng.integers(0, tc.vocab_size, (2, 24)))
            tables = torch.tensor([[1, 3, 5, 7], [2, 4, 6, 8]],
                                  dtype=torch.int32)
            outs = []
            for where, params in (("cpu", tp_cpu), (dev, tp)):
                caches = kv_pool.init_paged_caches(tc, 2, 9, 8, torch.float32,
                                                   where)
                pos = torch.zeros(2, dtype=torch.long, device=where)
                kw = dict(caches=caches, block_tables=tables.to(where),
                          kv_block_size=8, dtype=torch.float32)
                forward(params, tc, toks[:, :15].to(where), cache_pos=pos,
                        **kw)
                lg, _ = forward(params, tc, toks[:, 15:].to(where),
                                cache_pos=pos + 15, **kw)
                free, _ = forward(params, tc, toks.to(where),
                                  dtype=torch.float32)
                outs.append(torch.cat([lg, free], 1).float().cpu())
            err = (outs[0] - outs[1]).abs().max().item()
            log(f"[reference] {label} forward (paged windows and cache-free) "
                f"card vs CPU: max_abs_err={err:.3e} tol=2e-3")
            if not err <= 2e-3:
                raise SmokeFailure(f"{label}: card forward disagrees with the "
                                   f"CPU path: {err}")
        prompts = [rng.integers(0, tc.vocab_size, size=int(n))
                   for n in rng.integers(4, 40, size=3)]
        got = {}
        for layout in ("paged", "contiguous"):
            for mode in ("ar", "pard"):
                got[mode, layout] = _tiny_engine_tokens(
                    torch, Engine, EngineConfig, (tc, tp, dc, dp), prompts,
                    dev, max_batch=2, k=4, mode=mode, kv_layout=layout)
        for (mode, layout), (toks_, acc, steps) in got.items():
            same = all(np.array_equal(toks_[i], got["ar", "paged"][0][i])
                       for i in range(len(prompts)))
            log(f"[reference] {label} fp32 engine on the card, {mode} "
                f"{layout}: tokens == AR tokens for {len(prompts)} requests "
                f"(max_batch 2): {same}; accepted={acc} steps={steps}")
            if not same:
                raise SmokeFailure(f"{label}: {mode} {layout} tokens differ "
                                   f"from AR tokens")


def phase_ssm_engine(torch, kernels, args, dev="cuda"):
    """mamba2-130m at full width as target (weights from --seed) and PARD
    draft (--seed + 1), bf16, K=8, max_batch 4: paged PARD, contiguous
    PARD and paged AR, each asserting its exact ssd_chunked launches."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.training.optimizer import leaves

    cfg = get_config(SSM_MODEL)
    t0 = time.perf_counter()
    tp = init_params(cfg, args.seed, dev, torch.bfloat16)
    dp = init_params(cfg, args.seed + 1, dev, torch.bfloat16)
    _sync(torch, dev)
    n_params = sum(t.numel() for t in leaves(tp))
    log(f"[engine ssm] {SSM_MODEL} target + draft, random bf16 weights "
        f"({n_params / 1e6:.1f}M params each) on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=args.prompt_len)
               for _ in range(args.requests)]
    runs = [("ssm pard paged", EngineConfig()),
            ("ssm pard contiguous", EngineConfig(kv_layout="contiguous")),
            ("ssm ar paged", EngineConfig(mode="ar"))]
    tokens, main = {}, None
    for label, ecfg in runs:
        warm = Engine(tp, cfg, dp, cfg, config=ecfg, device=dev)
        warm.submit(prompts[0][:32], 8)
        warm.run()
        del warm
        d_p, d_c = (None, None) if ecfg.mode == "ar" else (dp, cfg)
        tokens[label], launches, _ = serve(torch, kernels, Engine, ecfg, tp, cfg,
                                        d_p, d_c, prompts, args.max_new,
                                        label, dev)
        if main is None:
            main = launches.get("ssd_chunked", 0)
    for label in ("ssm pard paged", "ssm pard contiguous"):
        shares = []
        for rid, toks in tokens[label].items():
            a = toks[args.prompt_len:]
            b = tokens["ssm ar paged"][rid][args.prompt_len:]
            diff = np.nonzero(a != b)[0]
            shares.append((diff[0] if diff.size else len(a)) / len(a))
        log(f"[ar comparison] {label}: share of tokens equal to AR tokens up "
            f"to the first divergence: mean {np.mean(shares):.3f} per request "
            f"{[round(float(x), 3) for x in shares]}")
    return {"ssd_chunked": main}


# ---------------------------------------------------------------------------
# training kernels and training
# ---------------------------------------------------------------------------



def _cod_layout(torch, rng, b, n, extra, dev):
    """(segment, base) [B, T] int32 of the port's pack_batch at COD, with
    ``extra`` columns of segment-0 padding past the packed bound."""
    from repro_torch.core.cod import CodConfig, pack_batch
    packed = pack_batch(rng.integers(0, 128000, (b, n)), CodConfig(*COD),
                        128256, seed=int(rng.integers(1 << 30)))
    pad = torch.zeros(b, extra, dtype=torch.int32)
    return [torch.cat([torch.from_numpy(packed[f]).to(torch.int32), pad], 1)
            .to(dev) for f in ("segment", "base")]


def train_case(torch, gen, rng, kind, *, b, hq, hkv, d, dtype, t=None, s=None,
               n=None, extra=0, window=0, softcap=0.0, dev="cuda"):
    """Inputs of one training-attention call: "flash" (t queries, s keys,
    causal) or "pard" (a COD layout of b rows of n tokens)."""
    seg = base = None
    if kind == "pard":
        seg, base = _cod_layout(torch, rng, b, n, extra, dev)
        t = s = seg.shape[1]
    s = s or t

    def rnd(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    return dict(kind=kind, q=rnd(b, t, hq, d), k=rnd(b, s, hkv, d),
                v=rnd(b, s, hkv, d), dout=rnd(b, t, hq, d), seg=seg, base=base,
                window=window, softcap=softcap)


def train_attention(c, plain):
    """The wrapper (or its plain version) of case ``c`` as fn(q, k, v)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import pard_attention as pa
    if c["kind"] == "flash":
        fn = fa.flash_attention_ref if plain else fa.flash_attention
        return lambda q, k, v: fn(q, k, v, causal=True, window=c["window"],
                                  softcap=c["softcap"])
    if plain:
        return lambda q, k, v: pa.pard_attention_ref(
            q, k, v, c["seg"], c["base"], softcap=c["softcap"])
    info = pa.PardMaskInfo(c["seg"], c["base"])
    return lambda q, k, v: pa.pard_attention(q, k, v, info,
                                             softcap=c["softcap"])


def fwd_bwd(c, plain):
    """(out, dq, dk, dv) of case ``c`` through torch.autograd."""
    q, k, v = (c[n].detach().clone().requires_grad_(True) for n in "qkv")
    out = train_attention(c, plain)(q, k, v)
    out.backward(c["dout"])
    return out.detach(), q.grad, k.grad, v.grad


def train_correctness_cases(torch):
    bf, f32 = torch.bfloat16, torch.float32
    flash = [
        ("draft width D=64 G=4 T=1000", dict(b=2, t=1000, hq=32, hkv=8, d=64)),
        ("D=128 G=4 T=333", dict(b=2, t=333, hq=8, hkv=2, d=128)),
        ("tiny D=32 G=2 T=77", dict(b=3, t=77, hq=2, hkv=1, d=32)),
        ("D=64 G=1 window 128 T=600", dict(b=2, t=600, hq=4, hkv=4, d=64,
                                           window=128)),
        ("D=64 G=4 softcap 30 T=515", dict(b=2, t=515, hq=8, hkv=2, d=64,
                                           softcap=30.0)),
        ("rows that see no key: T=300 S=128 window 40",
         dict(b=2, t=300, s=128, hq=8, hkv=2, d=64, window=40)),
        ("D=48 G=2 T=333", dict(b=2, t=333, hq=4, hkv=2, d=48)),
        ("D=48 G=1 window 64 softcap 30 T=200",
         dict(b=2, t=200, hq=2, hkv=2, d=48, window=64, softcap=30.0)),
    ]
    pard = [
        ("draft width D=64 G=4 N=512", dict(b=2, n=512, hq=32, hkv=8, d=64,
                                            extra=21)),
        ("D=128 G=1 N=200", dict(b=2, n=200, hq=4, hkv=4, d=128, extra=5)),
        ("tiny D=32 G=2 N=48", dict(b=3, n=48, hq=2, hkv=1, d=32, extra=3)),
        ("D=64 G=4 softcap 20 N=300", dict(b=2, n=300, hq=8, hkv=2, d=64,
                                           softcap=20.0, extra=0)),
        ("D=48 G=2 N=200", dict(b=2, n=200, hq=4, hkv=2, d=48, extra=7)),
        ("D=48 G=1 N=96", dict(b=2, n=96, hq=2, hkv=2, d=48, extra=0)),
    ]
    # the exact shapes of the training runs of phase 9, in their bf16
    main = [("flash", "main path AR B=4 T=1023 Hq=32 Hkv=8 D=64",
             dict(b=4, t=TRAIN_SEQ["ar"] - 1, hq=32, hkv=8, d=64)),
            ("pard", "main path PARD B=4 N=512 Hq=32 Hkv=8 D=64",
             dict(b=4, n=TRAIN_SEQ["pard"], hq=32, hkv=8, d=64))]
    # where the tensor-core tiles can break (fragment coordinates, tile
    # classes): one row, a row off the tile, T one short of the training
    # length, rows that see no key, a 64-token tile of padding only, and
    # COD tiles classed full; every head dim, bf16
    edge = [(kind, f"edge {label} D={d} bfloat16", dict(kw, d=d, dtype=bf))
            for d in (32, 48, 64, 128) for kind, label, kw in (
                ("flash", "T=1", dict(b=2, t=1, hq=4, hkv=2)),
                ("flash", "T=65 G=4", dict(b=2, t=65, hq=4, hkv=1)),
                ("flash", "T=1023", dict(b=1, t=1023, hq=4, hkv=2)),
                ("flash", "S=128 < T=300 window 40", dict(b=2, t=300, s=128,
                                                          hq=4, hkv=2,
                                                          window=40)),
                ("pard", "a tile of padding N=100", dict(
                    b=2, n=100, hq=4, hkv=2, extra=130, need="padding")),
                ("pard", "full tiles N=256 G=4", dict(
                    b=2, n=256, hq=4, hkv=1, need="full")))]
    return [(kind, f"{label} {str(dt).split('.')[1]}", dict(kw, dtype=dt))
            for kind, cases in (("flash", flash), ("pard", pard))
            for label, kw in cases for dt in (bf, f32)] + [
        (kind, f"{label} bfloat16", dict(kw, dtype=bf))
        for kind, label, kw in main] + edge


def phase_train_correctness(torch, args, dev="cuda"):
    """Each training kernel, forward and backward, against its plain
    version: |kernel - plain| <= tol * max(1, |plain|) element-wise."""
    import numpy as np
    gen = torch.Generator(device=dev).manual_seed(args.seed + 11)
    rng = np.random.default_rng(args.seed + 11)
    from repro_torch.kernels import pard_attention as pa
    worst = {n: 0.0 for n in TRAIN_NAMES}
    for kind, label, kw in train_correctness_cases(torch):
        need = kw.pop("need", None)
        c = train_case(torch, gen, rng, kind, dev=dev, **kw)
        if need:                  # the COD layout holds what the case is for
            cls = pa.pard_tile_classes(c["seg"], c["base"])
            dead = ~(c["seg"] > 0)
            dead = torch.nn.functional.pad(
                dead, (0, cls.shape[-1] * 64 - dead.shape[1]), value=True)
            have = (int(dead.unflatten(1, (cls.shape[-1], 64)).all(-1).sum())
                    if need == "padding" else int((cls == pa.FULL).sum()))
            if not have:
                raise SmokeFailure(f"{label}: the layout has no {need} tile")
        got = fwd_bwd(c, plain=False)
        _sync(torch, dev)
        again = fwd_bwd(c, plain=False)
        _sync(torch, dev)
        if not all(torch.equal(x, y) for x, y in zip(got[1:], again[1:])):
            raise SmokeFailure(f"{kind}: two backward calls differ ({label})")
        want = fwd_bwd(c, plain=True)
        tol = TOL[str(kw["dtype"]).split(".")[1]]
        errs, worst_scaled = {}, 0.0
        for part, a, b in zip(("out", "dq", "dk", "dv"), got, want):
            if not torch.isfinite(a).all():
                raise SmokeFailure(f"{kind} {part} not finite ({label})")
            diff = (a.float() - b.float()).abs()
            scaled = (diff / b.float().abs().clamp(min=1.0)).max().item()
            errs[part] = diff.max().item()
            worst_scaled = max(worst_scaled, scaled)
            if not scaled <= tol:
                raise SmokeFailure(f"{kind} {part} disagrees with the plain "
                                   f"version ({label}): {scaled} > {tol}")
        # rows that see no key: output 0 and no gradient
        if kind == "pard":
            dead, dead_keys = c["seg"] == 0, c["seg"] == 0
        else:
            t, s, w = c["q"].shape[1], c["k"].shape[1], c["window"]
            rows = torch.arange(t, device=c["q"].device)
            dead = (rows >= s + w - 1 if w and t > s else rows < 0)[None]
            dead = dead.expand(c["q"].shape[0], -1)
            dead_keys = None
        n_dead = int(dead.sum())
        if any((x[dead] != 0).any() for x in got[:2]) or (
                dead_keys is not None
                and any((x[dead_keys] != 0).any() for x in got[2:])):
            raise SmokeFailure(f"{kind}: rows that see no key are not 0 "
                               f"({label})")
        fwd, bwd = TRAIN_KERNELS[kind]
        worst[fwd] = max(worst[fwd], errs["out"])
        worst[bwd] = max(worst[bwd], errs["dq"], errs["dk"], errs["dv"])
        log(f"[train kernel vs plain] {kind} {label}: max_abs_err "
            + " ".join(f"{p}={e:.3e}" for p, e in errs.items())
            + f" (check |err| <= {tol:g} * max(1, |plain|): largest "
            f"{worst_scaled:.3e}); "
            f"{n_dead} rows that see no key, all 0; two backward calls "
            f"bitwise equal")
    return worst


def train_bound_ms(torch, c, backward):
    """Least time on the card for one call: FLOPs (4 D per allowed (query,
    key) pair per query head forward, 2.5x that backward) at the bf16
    peak, vs bytes (q, k, v, out and the log-sum-exp once; backward also
    dout and dq, dk, dv; the COD metadata) at the memory rate. K and V are
    counted for k.numel() each; q-sized tensors for q.numel()."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import pard_attention as pa
    q, k = c["q"], c["k"]
    b, t, hq, d = q.shape
    if c["kind"] == "flash":
        pairs = b * int(fa.flash_allowed(t, k.shape[1], window=c["window"],
                                         device=q.device).sum())
    else:
        pairs = int(pa.pard_mask(c["seg"], c["base"], c["seg"], c["base"])
                    .sum())
    flops = 4 * d * hq * pairs * (2.5 if backward else 1.0)
    # forward: q, o and k, v; backward also dout, dq and dk, dv
    io = (4 if backward else 2) * (q.numel() + k.numel())
    nbytes = io * q.element_size() + b * hq * t * 4        # + the lse
    if c["seg"] is not None:
        nbytes += 2 * c["seg"].numel() * 4
    t_ops = flops / PEAK_OPS[str(q.dtype).split(".")[1]]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def phase_train_timing(torch, F, args, dev="cuda"):
    """Kernel, plain and SDPA times, forward and backward, at the training
    shapes: flash B=4 T=1024 Hq=32 Hkv=8 D=64 causal; pard B=4 N=512
    (T=1726) at COD; bf16; then flash at head dim 48 beside its D=64 row
    (not the kernels' main rows). The kernels and SDPA by device time
    (``graph_ms``), eager beside; SDPA's backward by device time is a
    graph of its forward and backward less one of its forward."""
    import numpy as np
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import pard_attention as pa
    gen = torch.Generator(device=dev).manual_seed(args.seed + 13)
    rng = np.random.default_rng(args.seed + 13)
    shape = dict(b=4, hq=32, hkv=8, d=64, dtype=torch.bfloat16, dev=dev)
    rows = [("flash", dict(shape, t=1024)), ("pard", dict(shape, n=512)),
            ("flash", dict(shape, t=1024, d=48))]
    results = {}
    for kind, kw in rows:
        fwd_name, bwd_name = TRAIN_KERNELS[kind]
        first = train_case(torch, gen, rng, kind, **kw)
        per_set = sum(first[n].numel() * first[n].element_size()
                      for n in ("q", "k", "v", "dout")) * 2
        sets = [first] + [train_case(torch, gen, rng, kind, **kw) for _ in
                          range(max(2, math.ceil(COLD_BYTES / per_set)) - 1)]
        if kind == "flash":
            def fwd(c):
                return fa.flash_attention_fwd(c["q"], c["k"], c["v"])

            def bwd(c):
                return fa.flash_attention_bwd(c["q"], c["k"], c["v"], c["o"],
                                              c["lse"], c["dout"])
        else:
            # the class table is made once per batch (PardMaskInfo.tiles),
            # as in training: timed apart from the kernels
            def fwd(c):
                return pa.pard_attention_fwd(c["q"], c["k"], c["v"], c["info"])

            def bwd(c):
                return pa.pard_attention_bwd(c["q"], c["k"], c["v"], c["info"],
                                             c["o"], c["lse"], c["dout"])
            for c in sets:
                c["info"] = pa.PardMaskInfo(c["seg"], c["base"])
            ms_tiles = time_ms(torch, lambda c: pa.pard_tile_classes(
                c["seg"], c["base"]), sets, 20)
            cls = sets[0]["info"].tiles
            log(f"[timing] pard tile classes B=4 T={first['q'].shape[1]}: "
                f"{int((cls != pa.EMPTY).sum())} of {cls.numel()} tiles "
                f"visited, {int((cls == pa.FULL).sum())} full; the table "
                f"takes {ms_tiles:.4f} ms per batch")
        for c in sets:
            c["o"], c["lse"] = fwd(c)
        ms_f = graph_ms(torch, fwd, sets)
        ms_b = graph_ms(torch, bwd, sets, 50)
        eager_f = time_ms(torch, fwd, sets, 20)
        eager_b = time_ms(torch, bwd, sets, 10)

        def plain_fwd(c):
            with torch.no_grad():
                return train_attention(c, plain=True)(c["q"], c["k"], c["v"])

        plain_f = time_ms(torch, plain_fwd, sets[:1], 3)

        def graph(c, fn):
            q, k, v = (c[n].detach().requires_grad_(True) for n in "qkv")
            return fn(q, k, v), (q, k, v), c["dout"]

        def grad_of(g):
            return torch.autograd.grad(g[0], g[1], g[2], retain_graph=True)

        plain_g = graph(first, train_attention(first, plain=True))
        plain_b = time_ms(torch, grad_of, [plain_g], 3)
        del plain_g
        # library yardstick (the port never calls it): SDPA, GQA, on the
        # same inputs; the COD mask as an explicit boolean mask
        if kind == "flash":
            def lib(q, k, v):
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=True, enable_gqa=True)
        else:
            mask = pa.pard_mask(first["seg"], first["base"], first["seg"],
                                first["base"])[:, None]

            def lib(q, k, v):
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=mask, enable_gqa=True)

        def lib_fwd(c):
            return lib(c["q"], c["k"], c["v"])

        def lib_fwd_bwd(c):
            q, k, v = (c[n].detach().requires_grad_(True) for n in "qkv")
            return torch.autograd.grad(lib(q, k, v).transpose(1, 2),
                                       (q, k, v), c["dout"])

        lib_f = graph_ms(torch, lib_fwd, sets)
        lib_b = graph_ms(torch, lib_fwd_bwd, sets, 50) - lib_f
        lib_eager_f = time_ms(torch, lib_fwd, sets, 10)
        # SDPA's eager backward over the same rotating input sets as the
        # kernel's (one autograd graph per set)
        lib_gs = [graph(c, lambda q, k, v: lib(q, k, v).transpose(1, 2))
                  for c in sets]
        lib_eager_b = time_ms(torch, grad_of, lib_gs, 10)
        del lib_gs
        for name, ms, eager, plain, libt, lib_eager, backward in (
                (fwd_name, ms_f, eager_f, plain_f, lib_f, lib_eager_f, False),
                (bwd_name, ms_b, eager_b, plain_b, lib_b, lib_eager_b, True)):
            bnd, by = train_bound_ms(torch, first, backward)
            log(f"[timing] {name} B=4 T={first['q'].shape[1]} Hq=32 Hkv=8 "
                f"D={kw['d']} bf16: kernel {ms:.4f} ms (eager {eager:.4f}), "
                f"plain {plain:.4f} ms, sdpa {libt:.4f} ms (eager "
                f"{lib_eager:.4f}), bound {bnd:.5f} ms ({by}); device times "
                f"from a CUDA graph of {len(sets)} input sets")
            row = dict(ms=ms, plain_ms=plain, library_ms=libt, bound_ms=bnd,
                       bound_by=by)
            results.setdefault(name, dict(row, timings=[]))["timings"].append(
                dict(row, label=f"D={kw['d']}", eager_ms=eager,
                     library_eager_ms=lib_eager))
        del sets, first
        if dev == "cuda":
            torch.cuda.empty_cache()
    return results


def _grad_norm(torch, params):
    from repro_torch.training.optimizer import leaves
    return math.sqrt(sum(float(p.grad.float().square().sum())
                         for p in leaves(params)))


def compare_plain_step(torch, kernels, tr, params, batch):
    """Loss and global grad norm of one step through the kernels and
    through the plain versions on the card (the model's attention module
    is pointed at the plain versions for the second run only)."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import pard_attention as pa
    from repro_torch.models import attention as model_attention
    from repro_torch.training.optimizer import leaves
    got = {}
    tr.remat = True                     # one layer's plain [T, T] scores at a time
    try:
        for route in ("kernels", "plain"):
            if route == "plain":
                model_attention.flash_attention = fa.flash_attention_ref
                model_attention.pard_attention = (
                    lambda q, k, v, info, **kw: pa.pard_attention_ref(
                        q, k, v, info.segment, info.base, **kw))
            for p in leaves(params):
                p.requires_grad_(True)
                p.grad = None
            kernels.launches.clear()
            loss, _ = tr.loss(params, batch)
            loss.backward()
            got[route] = (loss.item(), _grad_norm(torch, params),
                          dict(kernels.launches))
    finally:
        model_attention.flash_attention = fa.flash_attention
        model_attention.pard_attention = pa.pard_attention
        tr.remat = False
        for p in leaves(params):
            p.grad = None
    return got


def step_parts_ms(torch, tr, params, state, batch):
    """One more ``Trainer.step`` cut into forward + loss, backward and the
    AdamW update by its CUDA events (the device timeline, gaps waiting on
    the host included)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    tr.step(params, state, batch, events=ev)
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]


def phase_train(torch, kernels, args, dev="cuda"):
    """llama3.2-1b at full width: a B=1 step through the kernels and the
    plain versions, then the AR and PARD runs of ``Trainer.fit``."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import MarkovCorpus
    from repro_torch.launch import train as launch_train
    from repro_torch.models import init_params

    cfg = get_config(TRAIN_MODEL)
    corpus = MarkovCorpus(vocab_size=cfg.vocab_size, seed=0, determinism=2.0)
    launches = {}
    for kind, n in TRAIN_SEQ.items():
        fwd_name, bwd_name = TRAIN_KERNELS["flash" if kind == "ar" else "pard"]
        flags = ["--arch", TRAIN_MODEL, "--steps", str(args.train_steps),
                 "--batch", "4", "--seq", str(n), "--seed", str(args.seed),
                 "--lr", str(TRAIN_LR), "--device", dev,
                 "--dtype", "bfloat16"]
        if kind == "pard":
            flags += ["--pard", "--k", str(COD[0]), "--r", str(COD[1]),
                      "--r-min", str(COD[2])]
        tr = launch_train.make_trainer(
            launch_train.build_parser().parse_args(flags), cfg, dev)
        params = init_params(cfg, args.seed, dev, torch.float32)

        one = tr.make_batch(corpus.sample(np.random.default_rng(args.seed + 5),
                                          1, n), seed=args.seed)
        got = compare_plain_step(torch, kernels, tr, params, one)
        (lk, gk, nk), (lp, gp, np_) = got["kernels"], got["plain"]
        rel = max(abs(lk - lp) / abs(lp), abs(gk - gp) / abs(gp))
        log(f"[train {kind}] B=1 N={n} one step on the card: loss kernels "
            f"{lk:.6f} plain {lp:.6f}; grad norm kernels {gk:.6f} plain "
            f"{gp:.6f}; max rel diff {rel:.3e} (tol 2e-2); launches kernels "
            f"{nk} plain {np_}")
        if not (rel <= 2e-2 and math.isfinite(lk) and math.isfinite(gk)):
            raise SmokeFailure(f"train {kind}: kernels and plain versions "
                               f"disagree (rel {rel})")
        if np_ or not nk.get(fwd_name) or not nk.get(bwd_name):
            raise SmokeFailure(f"train {kind}: the routes did not take the "
                               f"intended attention ({nk} / {np_})")

        stream = corpus.batches(4, n, seed=args.seed)
        _sync(torch, dev)
        if dev == "cuda":
            torch.cuda.reset_peak_memory_stats()
        kernels.launches.clear()                  # counts to 0 just before
        t0 = time.perf_counter()
        params, state, hist = tr.fit(params, stream, args.train_steps,
                                     log_every=1, log_fn=None)
        _sync(torch, dev)
        wall = time.perf_counter() - t0
        got_launches = dict(kernels.launches)     # just after
        peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
        steps = len(hist)
        want = {fwd_name: cfg.num_layers * steps,
                bwd_name: cfg.num_layers * steps}
        losses = [h["loss"] for h in hist]
        walls = [0.0] + [h["wall"] for h in hist]
        step_ms = np.diff(walls) * 1e3
        steady = step_ms[1:]
        tok_s = (hist[-1]["tokens"] - hist[0]["tokens"]) / (
            hist[-1]["wall"] - hist[0]["wall"])
        log(f"[train {kind}] {TRAIN_MODEL} full width, B=4 N={n} "
            f"(T={one['segment'].shape[1] if kind == 'pard' else n - 1}), "
            f"{steps} steps in {wall:.2f}s; loss {losses[0]:.4f} -> "
            f"{losses[-1]:.4f}; step ms p50 {np.percentile(steady, 50):.2f} "
            f"p95 {np.percentile(steady, 95):.2f} (steps 2-{steps}; step 1 "
            f"{step_ms[0]:.1f}); trained tokens/s {tok_s:.0f} (steps "
            f"2-{steps}, {hist[-1]['tokens']} tokens in all); peak_mem "
            f"{peak / 2**30:.2f}GiB; grad_norm {hist[0]['grad_norm']:.3f} -> "
            f"{hist[-1]['grad_norm']:.3f}; launches={got_launches} "
            f"(expected {want})")
        log(f"[train {kind}] losses {[round(x, 4) for x in losses]}")
        if dev == "cuda":
            parts = step_parts_ms(torch, tr, params, state, tr.make_batch(
                next(stream), seed=args.train_steps))
            log(f"[train {kind}] one more step on the device timeline: "
                f"forward + loss {parts[0]:.2f} ms, backward {parts[1]:.2f} "
                f"ms, AdamW {parts[2]:.2f} ms (sum {sum(parts):.2f} ms)")
        if got_launches != want:
            raise SmokeFailure(f"train {kind}: launches {got_launches}, "
                               f"expected {want}")
        if not all(math.isfinite(x) for x in losses) or \
                not losses[-1] < losses[0]:
            raise SmokeFailure(f"train {kind}: loss not finite and falling "
                               f"({losses[0]} -> {losses[-1]})")
        launches.update(got_launches)
        del params, state, tr
        if dev == "cuda":
            torch.cuda.empty_cache()
    return launches


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=128)
    ap.add_argument("--train-steps", type=int, default=20)
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

    t_start = time.perf_counter()
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    try:
        phase_build(build)
        errs = phase_correctness(torch, args)
        for name, err in phase_split_kv(torch, args).items():
            errs[name] = max(errs.get(name, 0.0), err)
        errs.update(phase_ssd_correctness(torch, args))
        timing = phase_timing(torch, F, args)
        timing.update(phase_ssd_timing(torch, args))
        phase_reference(torch, args)
        phase_reference_ssm(torch, args)
        launches = phase_engine(torch, kernels, args)
        launches.update(phase_ssm_engine(torch, kernels, args))
        errs.update(phase_train_correctness(torch, args))
        timing.update(phase_train_timing(torch, F, args))
        launches.update(phase_train(torch, kernels, args))
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"[done] {time.perf_counter() - t_start:.1f}s")
    log(card)
    # the serving kernels' int8 / fp8 routes: errors, launches in their
    # engine runs (the routes a full-width run does not take: null), times
    for name in MMA_SERVING:
        for r in ROUTES:
            timing[name][r].update(max_abs_err=errs[name, r],
                                   launches=launches.get((name, r)))
    rows = [dict(name=name, route="cuda",
                 source=f"src/repro_torch/csrc/{name}.cu",
                 replaces=REPLACES[name], launches=launches[name],
                 max_abs_err=errs[name], **timing[name]) for name in KERNELS]
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
