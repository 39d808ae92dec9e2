#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one CUDA card.

  python3 chip_smoke.py [--seed 0] [--requests 8] [--prompt-len 256]
                        [--max-new 64] [--train-steps 20]

Phases, each of which fails the run (non-zero exit, no result line):

  1. card: name and power limit (nvidia-smi), torch and CUDA versions;
  2. build: every CUDA kernel of the serving and training paths, compiled
     from ``src/repro_torch/csrc`` in parallel (one ``nvcc -Xptxas -v``
     each): decode_attention_paged, decode_attention, tree_attention_paged,
     tree_attention, flash_attention(_bwd), pard_attention(_bwd),
     ssd_chunked, ssd_chunked_bwd; for the training kernels, the four serving kernels and
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
     with a bitwise repeat and a CUDA-graph replay; one-row windows (tq =
     1: the AR decode step, VSD's proposal forwards) of the two decode
     kernels at D 128 and 64 with bf16, fp32, int8 and fp8 K/V and kv_len
     from 1, each repeated bit for bit; ssd_chunked (y and
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
     layouts with max_batch 2 and 3 requests (a recycled slot); then
     sampled serving at T = 0.8 with per-request seeds (flat PARD paged and
     contiguous, the static tree (2,2,1,1), the adaptive tree, AR and VSD
     on tiny-target / tiny-draft, VSD and AR on tiny-ssm): tokens equal to
     the CPU port's request by request, a bitwise repeat, greedy requests
     of the mixed batch equal to the all-greedy engine's, greedy VSD ==
     greedy AR; then the prefix cache on shared system prompts (warm ==
     cold paged == contiguous == the CPU port's warm tokens, greedy and at
     T = 0.8, 8 hit blocks) and the pipelined loop (pipelined == sync ==
     the CPU port's pipelined tokens for flat PARD, the adaptive tree
     (greedy), AR and VSD);
  6. engine at full width (llama3.1-8b target, llama3.2-1b draft, random
     bf16 weights from --seed, K=8, max_batch 4): paged PARD (the
     defaults), AR, the paged adaptive tree (default bank, 31-slot window),
     contiguous flat PARD, the contiguous static tree (2,2,1,1,1,1,1,1),
     paged PARD on int8 KV and the paged adaptive tree on fp8 KV (their
     kv_capacity and the share of tokens equal to the bf16 run's up to the
     first divergence), paged PARD and the paged adaptive tree at T = 1.0
     with 2 greedy requests of 4 (at most 32 new tokens, as the 8-bit
     runs), VSD greedy and VSD at T = 1.0 (4 requests, at most 16; K = 8
     draft forwards a step), each sampled run repeated bit for bit and its sampled step's device ops, launches and
     device time profiled beside the greedy-only step's on one engine
     state; paged PARD, the paged adaptive tree and paged PARD at T = 1.0
     again with two steps in flight (``Engine.run(pipelined=True)``, its
     admit / sync_tables / dispatch under ``set_sync_debug_mode("error")``):
     tokens equal to the synchronous run's, at most one more step per
     request, tok/s, step and host-overhead percentiles beside the
     synchronous run's; paged PARD with the prefix cache on the launcher's
     shared-prefix mix (2 requests per system prompt of --prompt-len
     tokens, 8-token tails) beside the same prompts cold: tokens equal,
     hit rate 0.5, one block of prefill saved per hit block, every block
     back at the end, TTFT p50 / p95 of both; then mamba2-130m (6 of its
     24 layers, for the time limit) as target (--seed) and draft
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
     forward + loss, backward and AdamW by its CUDA events;
 10. the uniform-batch path (run after phase 6): decode_attention at
     whole-prompt prefill windows (Tq = --prompt-len - 1 = 255 rows, G = 4,
     D 128 and 64, bf16 and fp32; kv_len at the window's end, past it and
     past S, and the window at the end of a longer context) against its
     plain version, each repeated bit for bit; tiny-target / tiny-draft
     fp32 ``generate_ar``, ``generate_spec`` (pard, vsd, a (2,2,1) tree)
     and ``EagleDecoder`` tokens on the card equal to the CPU port's and
     to AR; llama3.1-8b / llama3.2-1b bf16 at batch 1, one --prompt-len
     prompt and 64 new tokens, through AR, VSD, flat PARD (K = 8), the
     PARD tree (2,2,1,1,1,1,1,1) and EAGLE (K = 4, a random head on
     llama3.1-8b), each asserting its exact decode_attention /
     tree_attention launches and printing tok/s, iterations, forwards,
     mean accepted and the share of tokens equal to AR's; and one
     ``eagle_loss`` forward and backward on llama3.1-8b (B = 1, T =
     --prompt-len, bf16) through the kernels and through the plain
     versions (loss and head gradient norms within 2e-2, one backward
     launch: the head's);
 11. trained weights (run after phase 9): the recipe of
     ``repro_torch.examples`` in fp32 (params, moments and activations:
     the attention kernels' fp32 routes): bench-target, bench-draft and
     bench-mid AR (B 8, N 48), pard_k8_r07 (COD K 8, r 0.7, r_min 0.2;
     B 8, N 64) and the EAGLE head on bench-target (B 8, N 48), 300 steps
     each, each asserting its exact flash / pard attention launches and a
     finite, falling loss, and (but bench-mid) one step of its first
     batch through the kernels and the plain versions (loss, gradient
     norm and gradient difference within 2e-2); on those weights the
     quickstart's uniform batch (4 Markov prompts of 16 tokens, 48 new)
     through AR, VSD (K 8), flat PARD at K 4 and K 8, the PARD tree
     (2,2,1,1,1,1,1,1), EAGLE (K 4) and PARD K 4 with the unadapted
     draft, in fp32 and in bf16, each with its exact decode / tree
     attention launches: every fp32 path equal to AR, greedy PARD K 4
     mean accepted >= 1.8 and above the unadapted draft's, the bf16
     share of tokens equal to AR's up to the first divergence printed;
     the engine in fp32 on the serve launcher's prompts (8 of 16 tokens,
     48 new, max_batch 4): paged PARD, AR, VSD and the paged adaptive
     tree (its tree_hist and switches printed), greedy, equal to AR, and
     paged PARD at T = 0.8 repeated bit for bit with mean accepted >=
     1.3, each with its exact paged launches; then the
     target-independence table (pard_k8_r07 against bench-target,
     bench-mid and bench-draft at K 8, lossless);
 12. Mamba2 training (run after phase 11): the SSD scan's backward kernel
     through torch.autograd against ``ssd_chunked_bwd_ref`` and against
     autograd of ``ssd_chunked_ref`` (every gradient, bf16 and fp32) at
     mamba2-130m's training shape (b 4, t 1024, h 24, P 64, N 128, chunk
     64), a ragged tail (b 1, t 1000), t = 1, tiny-ssm's shape, an init
     state with a final-state cotangent and a ragged P block, one forward
     and one backward launch a call, two backward calls bitwise equal,
     finite gradients at dt = 20, A = -16; forward and backward times at
     the training shape beside the bound and the plain versions; then
     mamba2-130m at full width and all 24 layers (random weights from
     --seed, f32 params and moments, bf16 activations, the launcher's
     trainer at peak 1e-3): one B=1 step through the kernels and through
     the plain versions (loss and grad norm within 2e-2), --train-steps AR
     steps at B 4, N 1024 through ``Trainer.fit`` with 24 ssd_chunked and
     24 ssd_chunked_bwd launches a step and a finite, falling loss, and one
     more step cut into forward + loss, backward and AdamW; tiny-ssm and
     the dense hybrid in fp32 (one step kernels vs plain within 1e-4, 3
     Trainer steps equal to the CPU port's within 1e-4); a PARD Trainer on
     tiny-ssm refused with ValueError;
 13. trees with Mamba2 / hybrid drafts: tiny-target (fp32) with a
     tiny-ssm and a dense-hybrid draft under the static tree (2,2,1,1)
     and the adaptive bank, paged and contiguous, greedy and at T = 0.8,
     4 requests of 16 new tokens: the card's tokens equal the CPU port's,
     greedy tokens equal AR's, ssd_chunked launches exactly 2 per draft
     Mamba2 layer a step (the collecting scan and the gather);
 14. the dense families deepseek-67b, command-r-35b and gemma2-27b at
     their published widths and 4 layers (gemma2: 2 local, 2 global),
     random weights made on the card, each with a 1-layer draft of its
     own family: (a) in fp32 and bf16, a cached forward over 2048 tokens
     (gemma2: 4352, past its 4096 window) in prefill windows of 32 rows
     (paged) or 255 rows (contiguous), then eight one-row and one 8-row
     decode windows, against one cache-free forward through
     flash_attention; (b) the same windows through the plain versions;
     both within ``DENSE_TOL`` of the largest logit, with exact launches;
     (c) an Engine in mode pard, K = 8, paged KV, 4 requests of 32 new
     tokens: bf16 tok/s and mean accepted beside the card, fp32 PARD
     tokens equal to AR's;
 15. MoE layers: granite-moe-3b-a800m at full width and all 32 layers
     (40 experts top 8, G 3 at head dim 64) and the jamba hybrid at full
     width and 2 layers (one Mamba2 layer with a dense MLP, one attention
     layer without RoPE with 16 experts top 2; 256 SSD heads), each with
     a 1-layer draft of its family, random weights made on the card:
     (a) in fp32 and bf16 one cache-free forward over 1023 tokens (odd
     and past the 256-token group, so routing drops nothing), its expert
     choices recorded, and the cached windows of 32 rows (paged) and 63
     rows (contiguous), then the decode windows, with those choices
     replayed (``moe_routing``; each window's own router logits within
     ``DENSE_TOL`` of the recorded ones, each own choice that differs a
     near-tie of the recorded logits, in fp32 at most 1 in 1000 such
     flips) against it, (b) the same windows through the plain
     versions, within ``DENSE_TOL`` with exact launches; (c) an Engine,
     K = 8, paged KV, 4 requests of --prompt-len + 32 new tokens: fp32
     PARD (and for granite the adaptive tree) equal to AR, bf16 PARD
     timed, and for granite bf16 PARD pipelined with its host side under
     ``set_sync_debug_mode("error")``, tokens equal to the sync run's;
     then (e) granite AR training at full width and depth (B 4, N 513:
     2048 tokens in capacity groups of 256), a B = 1 step through the
     kernels and the plain versions, 3 ``Trainer.fit`` steps with each
     layer recomputed in the backward pass, a finite loss.

The last two lines of standard output are a JSON line of per-kernel
numbers (a serving-attention kernel's row also lists every timing row of
phase 4 under ``timings``, and its int8 and fp8 routes' error, launches
and times under ``int8`` / ``fp8``; every row lists its launches in each
run of phase 10 under ``generate_launches`` and of phase 11 under
``trained_launches``; the two SSD rows their launches in phase 12's
mamba2-130m run under ``train_launches``; every row its launches in
phase 13 under ``tree_ssm_launches``, per family of phase 14 under
``dense_launches`` and in phase 15 under ``moe_launches``) and the
result line ``{"ok":
true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
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
    "ssd_chunked_bwd": "src/repro/kernels/ssd.py:70",
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
SSM_LAYERS = 6                       # of its 24, for the time limit
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
    if report_mma("ssd_chunked_bwd", logs["ssd_chunked_bwd"]) != len(SSD_BWD_MMA):
        raise SmokeFailure(f"expected {len(SSD_BWD_MMA)} bf16 ssd_chunked_bwd "
                           f"kernels in the ptxas report")
    smem = build.load("ssd_chunked_bwd").ssd_chunked_bwd_smem
    log("  ssd_chunked_bwd: bf16 dynamic shared memory " + ", ".join(
        f"{name} {smem(i)} B" for i, name in enumerate(SSD_BWD_MMA)))
    check_tensor_cores(build, "ssd_chunked_bwd")
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
    smma, ssd's mma_kernel and ssdb's stages A and C), named as
    ``_tmma_label`` names them."""
    import re
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function "
                      r"'(_ZN(?:4[ts]mma|3ssd10mma_kernel|4ssdb\d+(?:chunk|grad)"
                      r"_kernel)\w*)'", line)
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
    addressing and K/V dtype); ssd mma_kernel<nk, mt> from ssd's;
    ssd_chunked_bwd chunk_kernel / grad_kernel from ssdb's."""
    import re
    bwd = re.match(r"_ZN4ssdb\d+(chunk_kernel|grad_kernel)", mangled)
    if bwd:
        return f"ssd_chunked_bwd {bwd.group(1)}"
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
    per tile plan; ssdb's stages A and C, its recurrence and reduction
    have no product) holds HMMA or HGMMA."""
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
                or fn.startswith("_ZN3ssd10mma_kernel")
                or fn.startswith("_ZN4ssdb") and any(
                    k in fn for k in SSD_BWD_MMA)):
            seen[_tmma_label(fn)] = ("HGMMA" if "HGMMA" in chunk else
                                     "HMMA" if "HMMA" in chunk else None)
    want = (SSD_MMA_INSTANCES if name == "ssd_chunked" else
            len(SSD_BWD_MMA) if name == "ssd_chunked_bwd" else
            SMMA_PER_KERNEL if name in MMA_SERVING else
            8 if name.endswith("_bwd") else 4)      # (dkdv, dq) x 4 head dims
    missing = [k for k, v in seen.items() if v is None]
    if len(seen) != want or missing:
        raise SmokeFailure(f"{name}: bf16 kernels without tensor-core "
                           f"instructions in SASS: {missing} (found {seen})")
    log(f"  {name}: SASS of {len(seen)} bf16 kernels: "
        + ", ".join(f"{k} {v}" for k, v in sorted(seen.items())))


def _sync(dev):
    from repro_torch.device import synchronize
    synchronize(dev)


def _tree_to(tree, dev, copy=False):
    if isinstance(tree, dict):
        return {k: _tree_to(v, dev, copy) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, dev, copy) for v in tree]
    return tree.to(dev, copy=copy)


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
    # one-row windows (tq = 1): the AR decode step and VSD's K-1 proposal
    # forwards, at the target's and the draft's head dims, bf16, fp32, int8
    # and fp8 K/V, kv_len from 1 up (phase_correctness repeats each)
    one_row = [(f"one-row {kn} {dn}", dict(shape, tq=1, ctx=[1, 2, 700, 4096],
                                           kv_dtype=kd, q_dtype=qd))
               for dn, shape in (("D=128", target), ("D=64", draft))
               for kn, kd, qd in (("bf16", bf, bf), ("fp32", f32, f32),
                                  ("int8", torch.int8, bf),
                                  ("fp8", torch.float8_e4m3fn, bf))]
    return {"decode_attention_paged": decode + split_decode + quant_decode
            + one_row,
            "decode_attention": decode + split_decode + past_s + quant_decode
            + quant_past_s + one_row,
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
            _sync(dev)
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
            if case["q"].shape[1] == 1:
                again = fn(**case)
                _sync(dev)
                log(f"[kernel vs plain] {name} {label}: a second call bitwise "
                    f"equal: {torch.equal(out, again)}")
                if not torch.equal(out, again):
                    raise SmokeFailure(f"{name} {label}: two calls differ")
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
        _sync(dev)
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
        _sync(dev)
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
        # generate_*'s whole-prompt prefill at batch 1: Tq = P - 1 rows
        ("decode_attention", f"target prefill Tq={args.prompt_len - 1} b=1",
         dict(target, b=1, tq=args.prompt_len - 1,
              ctx=[args.prompt_len - 1], s=args.prompt_len + 128)),
        ("decode_attention", f"draft prefill D=64 Tq={args.prompt_len - 1} "
         f"b=1", dict(draft, b=1, tq=args.prompt_len - 1,
                      ctx=[args.prompt_len - 1], s=args.prompt_len + 128)),
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
    attention layer per forward (VSD: K draft forwards a step); for Mamba2
    layers one ssd_chunked per layer per forward and one more per layer
    where the forward's states are gathered (every PARD forward, VSD's
    first draft forward and its verify, the draft forward of a tree step,
    and the AR forwards of the ``prefill_steps``, whose window is widened
    with pads)."""
    flat = "decode_attention_paged" if cfg.paged else "decode_attention"
    tree = "tree_attention_paged" if cfg.paged else "tree_attention"
    (ta, ts), (da, ds) = _layers(tc), _layers(dc) if dc else (0, 0)
    if mode == "ar":
        want = {flat: ta * steps, "ssd_chunked": ts * (steps + prefill_steps)}
    elif mode == "vsd":
        want = {flat: (ta + da * cfg.k) * steps,
                "ssd_chunked": (2 * ts + (cfg.k + 1) * ds) * steps}
    elif cfg.tree is None:
        want = {flat: (ta + da) * steps,
                "ssd_chunked": 2 * (ts + ds) * steps}
    else:           # a tree's target has no Mamba2 layer (refused)
        want = {flat: da * steps, tree: ta * steps,
                "ssd_chunked": 2 * ds * steps}
    return {k: v for k, v in want.items() if v}


@contextlib.contextmanager
def sync_errors(torch):
    """Any CUDA call inside that makes the host wait for the device
    raises (``torch.cuda.set_sync_debug_mode("error")``)."""
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)


def _host_side(eng):
    return ((eng.sched, "admit"), (eng.ex, "sync_tables"),
            (eng.sched, "dispatch"))


def guard_host_side(torch, eng):
    """Run the engine's admit, sync_tables and dispatch under
    ``sync_errors``: the host side of the pipelined loop must not wait for
    the step in flight. Each wrapper holds its engine in a reference
    cycle: ``unguard_host_side`` drops them."""
    for obj, name in _host_side(eng):
        def guarded(*a, _fn=getattr(obj, name), **k):
            with sync_errors(torch):
                return _fn(*a, **k)
        setattr(obj, name, guarded)


def unguard_host_side(eng):
    """Drop ``guard_host_side``'s wrappers, so that the engine and the
    weights it holds leave the card when the last reference goes, not when
    the cyclic garbage collector next runs."""
    for obj, name in _host_side(eng):
        obj.__dict__.pop(name, None)


def serve(torch, kernels, Engine, cfg, tp, tc, dp, dc, prompts, max_new,
          label, dev, greedy=0, pipelined=False):
    """One engine run through ``Engine.run``; the first ``greedy``
    requests decode greedily whatever the engine's temperature. A
    pipelined run on the card runs its host side under ``guard_host_side``.
    Returns (tokens by request id, launches, the run's numbers)."""
    eng = Engine(tp, tc, dp, dc, config=cfg, device=dev)
    for i, p in enumerate(prompts):
        eng.submit(p, max_new, temperature=0.0 if i < greedy else None)
    if pipelined and dev == "cuda":
        guard_host_side(torch, eng)
    _sync(dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    kernels.launches.clear()                  # counts to 0 just before
    t0 = time.perf_counter()
    comps = eng.run(pipelined=pipelined)
    _sync(dev)
    wall = time.perf_counter() - t0
    unguard_host_side(eng)
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
    log(f"[engine {label}] {len(comps)} requests ({greedy} greedy, "
        f"T={cfg.temperature}{', pipelined' if pipelined else ''}), {gen} "
        f"tokens in {wall:.2f}s = {gen / wall:.1f} tok/s; steps={steps} "
        f"mean_accepted={eng.mean_accepted():.3f} "
        f"step_p50={lat['step_p50_ms']:.2f}ms "
        f"step_p95={lat['step_p95_ms']:.2f}ms "
        f"host_overhead_p50={lat['host_overhead_p50_ms']:.3f}ms "
        f"host_overhead_p95={lat['host_overhead_p95_ms']:.3f}ms "
        f"ttft_p50={lat['ttft_p50_ms']:.0f}ms "
        f"ttft_p95={lat['ttft_p95_ms']:.0f}ms "
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
    info = dict(capacity=eng.kv_capacity_bytes(), stats=dict(eng.stats),
                lat=lat, tok_s=gen / wall, hit_rate=eng.prefix_hit_rate(),
                mean_accepted=eng.mean_accepted(),
                in_use=None if eng.alloc is None else eng.alloc.blocks_in_use)
    return {c.rid: c.tokens for c in comps}, launches, info


def step_cost(torch, eng, any_sampled, steps=3):
    """Per step of the executor's next ``steps`` decode steps (one warm-up
    first) under ``torch.profiler``: device operations, kernel launches and
    device time (the summed self time of kernels, copies and memsets)."""
    from torch.profiler import ProfilerActivity, profile

    def run(n):
        for _ in range(n):
            eng.ex.harvest(eng.ex.dispatch(any_prefilling=False,
                                           any_sampled=any_sampled))

    def dev_us(e):
        for name in ("self_device_time_total", "self_cuda_time_total"):
            if hasattr(e, name):
                return float(getattr(e, name))
        return 0.0

    run(1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(steps)
        torch.cuda.synchronize()
    rows = prof.key_averages()
    on_dev = [e for e in rows if str(e.device_type).endswith("CUDA")
              and dev_us(e) > 0]
    launch_keys = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                   "cuLaunchKernelEx")
    return dict(ops=sum(e.count for e in on_dev) / steps,
                launches=sum(e.count for e in rows
                             if e.key in launch_keys) / steps,
                device_ms=sum(dev_us(e) for e in on_dev) / 1e3 / steps)


def sampled_step_cost(torch, Engine, cfg, tp, tc, dp, dc, prompts, label):
    """The sampled step's extra launches and device time against the
    greedy-only step, on one engine state: 4 requests (2 greedy, 2
    sampled) past prefill, each variant profiled on the next steps."""
    eng = Engine(tp, tc, dp, dc, config=cfg, device="cuda")
    for i, p in enumerate(prompts[:4]):
        eng.submit(p, 64, temperature=0.0 if i < 2 else None)
    while eng.sched.prefilling_count() or not eng.stats["steps"]:
        eng.run(max_steps=eng.stats["steps"] + 1)
    greedy = step_cost(torch, eng, any_sampled=False)
    sampled = step_cost(torch, eng, any_sampled=True)
    log(f"[sampled step {label}] per step, sampled vs greedy-only on the "
        f"same engine state: device ops {sampled['ops']:.0f} vs "
        f"{greedy['ops']:.0f} (+{sampled['ops'] - greedy['ops']:.0f}), "
        f"kernel launches {sampled['launches']:.0f} vs "
        f"{greedy['launches']:.0f} "
        f"(+{sampled['launches'] - greedy['launches']:.0f}), device time "
        f"{sampled['device_ms']:.3f} vs {greedy['device_ms']:.3f} ms "
        f"(+{sampled['device_ms'] - greedy['device_ms']:.3f} ms)")
    del eng
    torch.cuda.empty_cache()


PIPELINED = ("pard paged", "adaptive tree paged", "pard paged T=1.0")


def loop_runs(torch, kernels, Engine, runs, tokens, infos, tp, tc, dp, dc,
              prompts, args, dev):
    """Phase 6 (b), (c): the ``PIPELINED`` runs again with two steps in
    flight, their admit / sync_tables / dispatch under ``sync_errors``.
    Tokens equal the synchronous run's request by request, the steps at
    most one more per request, the launches per step as asserted in
    ``serve``."""
    import numpy as np
    for label, cfg, _main, *opt in runs:
        if label not in PIPELINED:
            continue
        opt = opt[0] if opt else {}
        reqs = prompts[:opt.get("requests", len(prompts))]
        got, _, info = serve(torch, kernels, Engine, cfg, tp, tc, dp, dc,
                             reqs, opt.get("max_new", args.max_new),
                             f"{label} pipelined", dev,
                             greedy=opt.get("greedy", 0), pipelined=True)
        sync = infos[label]
        same = all(np.array_equal(got[r], t) for r, t in tokens[label].items())
        steps, base = info["stats"]["steps"], sync["stats"]["steps"]
        log(f"[pipelined] {label}: sync vs pipelined tok/s "
            f"{sync['tok_s']:.1f} vs {info['tok_s']:.1f}; step p50 / p95 "
            f"{sync['lat']['step_p50_ms']:.2f} / "
            f"{sync['lat']['step_p95_ms']:.2f} vs "
            f"{info['lat']['step_p50_ms']:.2f} / "
            f"{info['lat']['step_p95_ms']:.2f} ms; host overhead p50 / p95 "
            f"{sync['lat']['host_overhead_p50_ms']:.3f} / "
            f"{sync['lat']['host_overhead_p95_ms']:.3f} vs "
            f"{info['lat']['host_overhead_p50_ms']:.3f} / "
            f"{info['lat']['host_overhead_p95_ms']:.3f} ms; steps {base} vs "
            f"{steps}; tokens identical: {same}; no host synchronization in "
            f"admit / sync_tables / dispatch: "
            f"{True if dev == 'cuda' else 'not checked off the card'}")
        if not same:
            raise SmokeFailure(f"pipelined {label}: tokens differ from the "
                               f"synchronous run's")
        if not base <= steps <= base + len(reqs):
            raise SmokeFailure(f"pipelined {label}: {steps} steps against "
                               f"{base} synchronous")
        if dev == "cuda":
            torch.cuda.empty_cache()


def uniform_shared_prefix(seed, requests, prompt_len, share, vocab_size):
    """The shared-prefix mix of phase 6 (a) on uniform random tokens:
    ``share`` requests per system prompt of ``prompt_len`` tokens, each
    with an 8-token tail of its own, the groups round-robin."""
    import numpy as np
    rng = np.random.default_rng(seed)
    systems = [rng.integers(0, vocab_size, size=prompt_len)
               for _ in range(-(-requests // share))]
    return [np.concatenate([systems[i % len(systems)],
                            rng.integers(0, vocab_size, size=8)])
            for i in range(requests)]


def prefix_runs(torch, kernels, Engine, EngineConfig, tp, tc, dp, dc, args,
                dev):
    """Phase 6 (a): paged PARD on a shared-prefix mix of uniform random
    tokens (``--requests`` requests, 2 per system prompt of
    ``--prompt-len`` tokens, each with an 8-token tail), with the prefix
    cache and cold.
    Every request's tokens equal the cold run's (at a fixed batch shape a
    row's arithmetic does not depend on the other rows, and the shared
    positions were prefilled in the same chunks); the second request of
    each system prompt hits all its full system blocks; every block is
    back at the end."""
    import numpy as np
    prompts = uniform_shared_prefix(args.seed, args.requests,
                                    args.prompt_len, 2, tc.vocab_size)
    got = {}
    for label, cache in (("pard paged prefix cold", False),
                         ("pard paged prefix warm", True)):
        got[label] = serve(torch, kernels, Engine,
                           EngineConfig(prefix_cache=cache), tp, tc, dp, dc,
                           prompts, args.max_new, label, dev)
    (cold, _, ci), (warm, _, wi) = got.values()
    cfg = EngineConfig()
    full = (args.prompt_len + 8 - 1) // cfg.kv_block_size
    hits = len(prompts) // 2 * (args.prompt_len // cfg.kv_block_size)
    saved = ci["stats"]["prefill_tokens"] - wi["stats"]["prefill_tokens"]
    checks = {
        "tokens == cold": all(np.array_equal(warm[r], t)
                              for r, t in cold.items()),
        f"hit blocks {wi['stats']['prefix_hit_blocks']} of "
        f"{wi['stats']['prefix_lookup_blocks']} == {hits} of "
        f"{full * len(prompts)}":
            (wi["stats"]["prefix_hit_blocks"],
             wi["stats"]["prefix_lookup_blocks"])
            == (hits, full * len(prompts)),
        f"prefill tokens saved {saved} == {hits * cfg.kv_block_size}":
            saved == hits * cfg.kv_block_size,
        "blocks in use at the end 0": wi["in_use"] == 0,
    }
    log(f"[prefix] hit rate {wi['hit_rate']:.3f}; TTFT p50 / p95 cold "
        f"{ci['lat']['ttft_p50_ms']:.0f} / {ci['lat']['ttft_p95_ms']:.0f} "
        f"ms, warm {wi['lat']['ttft_p50_ms']:.0f} / "
        f"{wi['lat']['ttft_p95_ms']:.0f} ms; tok/s cold {ci['tok_s']:.1f} "
        f"warm {wi['tok_s']:.1f}; prefill steps cold "
        f"{ci['stats']['prefill_steps']} warm {wi['stats']['prefill_steps']}; "
        + "; ".join(f"{k}: {v}" for k, v in checks.items()))
    for k, v in checks.items():
        if not v:
            raise SmokeFailure(f"prefix cache: {k} fails")
    if dev == "cuda":
        torch.cuda.empty_cache()


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
    _sync(dev)
    n_params = sum(t.numel() for tree in (tp, dp) for t in leaves(tree))
    log(f"[engine] {target} + {draft} random bf16 weights "
        f"({n_params / 1e9:.2f}B params) on the card in "
        f"{time.perf_counter() - t0:.1f}s; EngineConfig defaults "
        f"{EngineConfig()}")
    rng = np.random.default_rng(args.seed)
    prompts = [rng.integers(0, tc.vocab_size, size=args.prompt_len)
               for _ in range(args.requests)]
    # the quantized runs: the int8 route of decode_attention_paged and the
    # fp8 route of tree_attention_paged, each beside its bf16 run; the
    # 8-bit runs at 4 requests of 32 new tokens; the sampled runs the same
    # with T = 1.0 and 2 greedy requests, each repeated (seeded: bitwise
    # equal); VSD (K = 8 draft forwards a step, its prefill most of the
    # run) at 16 for 4 requests; all for the time limit
    short = dict(max_new=min(args.max_new, 32), requests=4)
    sampled = dict(short, greedy=2, repeat=True)
    vsd = dict(max_new=min(args.max_new, 16), requests=4)
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
         ("decode_attention_paged", "int8"), short),
        ("adaptive tree paged fp8", EngineConfig(adaptive_tree=True,
                                                 kv_dtype="fp8"),
         ("tree_attention_paged", "fp8"), short),
        ("pard paged T=1.0", EngineConfig(temperature=1.0), None, sampled),
        ("adaptive tree paged T=1.0", EngineConfig(adaptive_tree=True,
                                                   temperature=1.0), None,
         sampled),
        ("vsd paged", EngineConfig(mode="vsd"), None, vsd),
        ("vsd paged T=1.0", EngineConfig(mode="vsd", temperature=1.0), None,
         dict(sampled, **vsd)),
    ]
    bf16_of = {"pard paged int8": "pard paged",
               "adaptive tree paged fp8": "adaptive tree paged"}
    tokens, main_launches, capacity, infos = {}, {}, {}, {}
    for label, cfg, main, *opt in runs:
        opt = opt[0] if opt else {}
        # warm-up per configuration (library handles, allocator pools),
        # not counted
        warm = Engine(tp, tc, dp, dc, config=cfg, device=dev)
        warm.submit(prompts[0][:32], 8)
        warm.run()
        del warm
        d_p, d_c = (None, None) if cfg.mode == "ar" else (dp, dc)
        max_new = opt.get("max_new", args.max_new)
        reqs = prompts[:opt.get("requests", len(prompts))]
        tokens[label], launches, infos[label] = serve(
            torch, kernels, Engine, cfg, tp, tc, d_p, d_c, reqs,
            max_new, label, dev, greedy=opt.get("greedy", 0))
        capacity[label] = infos[label]["capacity"]
        if main is not None:
            kernel = main[0] if isinstance(main, tuple) else main
            main_launches[main] = launches.get(kernel, 0)
        if opt.get("repeat"):
            again, _, _ = serve(torch, kernels, Engine, cfg, tp, tc, d_p, d_c,
                                reqs, max_new, f"{label} repeat", dev,
                                greedy=opt["greedy"])
            same = all(np.array_equal(again[r], t)
                       for r, t in tokens[label].items())
            log(f"[engine {label}] seeded repeat bitwise equal: {same}")
            if not same:
                raise SmokeFailure(f"engine {label}: a seeded repeat differs")
        if cfg.temperature > 0 and dev == "cuda":
            sampled_step_cost(torch, Engine, cfg, tp, tc, d_p, d_c, prompts,
                              label)
        if dev == "cuda":
            torch.cuda.empty_cache()

    loop_runs(torch, kernels, Engine, runs, tokens, infos, tp, tc, dp, dc,
              prompts, args, dev)
    prefix_runs(torch, kernels, Engine, EngineConfig, tp, tc, dp, dc, args,
                dev)

    def first_divergence(label, base, rids=None):
        shares = []
        for rid, toks in tokens[label].items():
            if rids is not None and rid not in rids:
                continue
            a, b = toks[args.prompt_len:], tokens[base][rid][args.prompt_len:]
            n = min(len(a), len(b))
            diff = np.nonzero(a[:n] != b[:n])[0]
            shares.append((diff[0] if diff.size else n) / n)
        return (f"mean {np.mean(shares):.3f} per request "
                f"{[round(float(s), 3) for s in shares]}")

    for label, cfg, *_ in runs:
        if cfg.temperature > 0:
            base = ("adaptive tree paged" if cfg.adaptive_tree else
                    "vsd paged" if cfg.mode == "vsd" else "pard paged")
            log(f"[sampled] {label}: the 2 greedy requests' tokens equal to "
                f"the greedy run's up to the first divergence: "
                f"{first_divergence(label, base, rids=(0, 1))}")
    for label in tokens:
        if label == "ar paged" or "T=" in label:
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
# the bf16 backward's tensor-core stages (csrc/ssd_chunked_bwd.cu): A, C
SSD_BWD_MMA = ("chunk_kernel", "grad_kernel")


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
    _sync(dev)
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
                _sync(dev)
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
        _sync(dev)
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
    _sync(dev)
    same = all(torch.equal(a, b) for a, b in zip(first, second))
    graph, outs = capture(torch, lambda a: ssd.ssd_chunked(*a, chunk=64),
                          [args])
    new = _ssd_args(ssd_case(torch, gen, b=4, t=9, dtype=dtype, chunk=64,
                             dev=dev, **SSD_SHAPES["mamba2-130m"]))
    for buf, val in zip(args, new):
        buf.copy_(val)
    graph.replay()
    _sync(dev)
    eager = ssd.ssd_chunked(*new, chunk=64)
    _sync(dev)
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


SAMPLED_T = 0.8                      # phase 5's sampled tiny engines
SAMPLED_RUNS = {                     # label -> (model family, EngineConfig)
    "pard paged": ("dense", dict(k=4)),
    "pard contiguous": ("dense", dict(k=4, kv_layout="contiguous")),
    "tree (2,2,1,1) paged": ("dense", dict(tree=(2, 2, 1, 1))),
    "adaptive tree paged": ("dense", dict(k=4, adaptive_tree=True)),
    "ar paged": ("dense", dict(mode="ar", k=4)),
    "vsd paged": ("dense", dict(mode="vsd", k=4)),
    "vsd tiny-ssm paged": ("tiny-ssm", dict(mode="vsd", k=4)),
    "ar tiny-ssm paged": ("tiny-ssm", dict(mode="ar", k=4)),
}


def _sampled_tokens(torch, models, prompts, dev, temperature,
                    pipelined=False, max_batch=3, stats=None, **kw):
    """Tokens of a tiny fp32 engine at ``temperature``: request i % 3 == 0
    greedy, 1 on the engine's (seed, rid) stream, 2 with a seed of its
    own. ``stats``, a dict, receives the engine's stats."""
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.config import SamplingParams
    tc, tp, dc, dp = models
    eng = Engine(tp, tc, dp, dc, config=EngineConfig(
        max_batch=max_batch, max_len=256, kv_block_size=16, kv_dtype="fp32",
        temperature=temperature, seed=5, **kw), device=dev)
    rids = {}
    for i, p in enumerate(prompts):
        sp = [SamplingParams(max_new=24, temperature=0.0),
              SamplingParams(max_new=24),
              SamplingParams(max_new=24, seed=100 + i)][i % 3]
        rids[eng.submit(p, params=sp)] = i
    toks = {rids[c.rid]: c.tokens for c in eng.run(pipelined=pipelined)}
    if stats is not None:
        stats.update(eng.stats)
    return toks, eng.stats["accepted"]


def phase_reference_sampled(torch, args, dev="cuda"):
    """Sampled serving in fp32 on the card at T = 0.8, tiny-target /
    tiny-draft and tiny-ssm (target = draft): flat PARD paged and
    contiguous, the static tree (2,2,1,1), the adaptive tree, AR and VSD.
    Each run's tokens equal the CPU port's request by request (the
    threefry keys draw the same bits on both), a repeat gives the same
    tokens bit for bit, the greedy requests of the mixed batch equal the
    all-greedy engine's, and greedy VSD equals greedy AR."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    rng = np.random.default_rng(args.seed + 31)
    families = {}
    for fam, (tn, dn) in (("dense", ("tiny-target", "tiny-draft")),
                          ("tiny-ssm", ("tiny-ssm", "tiny-ssm"))):
        tc, dc = get_config(tn), get_config(dn)
        tp = init_params(tc, args.seed, "cpu", torch.float32)
        dp = tp if dn == tn else init_params(dc, args.seed + 1, "cpu",
                                              torch.float32)
        families[fam] = {"cpu": (tc, tp, dc, dp),
                         dev: (tc, _tree_to(tp, dev), dc, _tree_to(dp, dev))}
    prompts = [rng.integers(0, 512, size=int(n))
               for n in rng.integers(4, 40, size=6)]
    greedy = {}
    for label, (fam, kw) in SAMPLED_RUNS.items():
        m = families[fam]
        t0 = time.perf_counter()
        card, acc = _sampled_tokens(torch, m[dev], prompts, dev, SAMPLED_T,
                                    **kw)
        wall = time.perf_counter() - t0
        again, _ = _sampled_tokens(torch, m[dev], prompts, dev, SAMPLED_T,
                                   **kw)
        cpu, _ = _sampled_tokens(torch, m["cpu"], prompts, "cpu", SAMPLED_T,
                                 **kw)
        greedy[label], _ = _sampled_tokens(torch, m[dev], prompts, dev, 0.0,
                                           **kw)
        n = len(prompts)
        checks = {
            "repeat bitwise equal": all(np.array_equal(card[i], again[i])
                                        for i in range(n)),
            "== CPU port": all(np.array_equal(card[i], cpu[i])
                               for i in range(n)),
            "greedy rows == greedy engine": all(
                np.array_equal(card[i], greedy[label][i])
                for i in range(0, n, 3)),
        }
        sampled_differ = sum(not np.array_equal(card[i], greedy[label][i])
                             for i in range(n) if i % 3)
        log(f"[reference sampled] {label} T={SAMPLED_T} on the card "
            f"({wall:.2f}s, accepted={acc}): "
            + "; ".join(f"{k}: {v}" for k, v in checks.items())
            + f"; sampled requests that differ from greedy: "
            f"{sampled_differ} of {n - len(range(0, n, 3))}")
        for k, v in checks.items():
            if not v:
                raise SmokeFailure(f"sampled {label}: {k} fails")
    for vsd, ar in (("vsd paged", "ar paged"),
                    ("vsd tiny-ssm paged", "ar tiny-ssm paged")):
        ok = all(np.array_equal(greedy[vsd][i], greedy[ar][i])
                 for i in range(len(prompts)))
        log(f"[reference sampled] greedy {vsd} == greedy {ar}: {ok}")
        if not ok:
            raise SmokeFailure(f"greedy {vsd} tokens differ from {ar}")


LOOP_RUNS = {                        # label -> (EngineConfig, temperature)
    "pard paged": (dict(k=4), SAMPLED_T),
    "adaptive tree paged": (dict(k=4, adaptive_tree=True), 0.0),
    "ar paged": (dict(mode="ar", k=4), SAMPLED_T),
    "vsd paged": (dict(mode="vsd", k=4), SAMPLED_T),
}


def phase_reference_loop(torch, args, dev="cuda"):
    """tiny-target / tiny-draft in fp32 on the card: the prefix cache
    (shared system prompts, max_batch 2: warm == cold paged == contiguous,
    greedy and mixed sampled) and the pipelined loop (pipelined == sync
    for flat PARD, the adaptive tree (greedy), AR and VSD, mixed sampled),
    each also equal to the CPU port's tokens request by request."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_params

    tc, dc = get_config("tiny-target"), get_config("tiny-draft")
    cpu = (tc, init_params(tc, args.seed, "cpu", torch.float32),
           dc, init_params(dc, args.seed + 1, "cpu", torch.float32))
    models = {"cpu": cpu, dev: (tc, _tree_to(cpu[1], dev), dc,
                                _tree_to(cpu[3], dev))}
    rng = np.random.default_rng(args.seed + 41)
    systems = [rng.integers(0, 512, size=40) for _ in range(2)]
    shared = [np.concatenate([systems[i % 2], rng.integers(0, 512, size=5)])
              for i in range(6)]
    for temp in (0.0, SAMPLED_T):
        got, stats = {}, {}
        for name, where, kw in (
                ("contiguous", dev, dict(kv_layout="contiguous")),
                ("cold", dev, dict()),
                ("warm", dev, dict(prefix_cache=True)),
                ("warm CPU", "cpu", dict(prefix_cache=True))):
            stats[name] = {}
            got[name], _ = _sampled_tokens(torch, models[where], shared, where,
                                           temp, max_batch=2,
                                           stats=stats[name], k=4, **kw)
        hits = stats["warm"]["prefix_hit_blocks"]
        same = {n: all(np.array_equal(got[n][i], got["warm"][i])
                       for i in range(len(shared)))
                for n in ("contiguous", "cold", "warm CPU")}
        log(f"[reference prefix] T={temp} on the card: warm (hit blocks "
            f"{hits} of {stats['warm']['prefix_lookup_blocks']}) == "
            + "; ".join(f"{n}: {v}" for n, v in same.items()))
        if not all(same.values()) or hits != 8 or \
                stats["warm CPU"]["prefix_hit_blocks"] != hits:
            raise SmokeFailure(f"prefix cache at T={temp}: {same}, {hits} "
                               f"hit blocks (expected 8)")
    prompts = [rng.integers(0, 512, size=int(n))
               for n in rng.integers(4, 40, size=6)]
    for label, (kw, temp) in LOOP_RUNS.items():
        sync, _ = _sampled_tokens(torch, models[dev], prompts, dev, temp,
                                  max_batch=2, **kw)
        pipe, _ = _sampled_tokens(torch, models[dev], prompts, dev, temp,
                                  pipelined=True, max_batch=2, **kw)
        cpu_pipe, _ = _sampled_tokens(torch, cpu, prompts, "cpu", temp,
                                      pipelined=True, max_batch=2, **kw)
        checks = {
            "pipelined == sync": all(np.array_equal(pipe[i], sync[i])
                                     for i in range(len(prompts))),
            "== CPU port": all(np.array_equal(pipe[i], cpu_pipe[i])
                               for i in range(len(prompts))),
        }
        log(f"[reference pipelined] {label} T={temp} on the card: "
            + "; ".join(f"{k}: {v}" for k, v in checks.items()))
        for k, v in checks.items():
            if not v:
                raise SmokeFailure(f"pipelined {label}: {k} fails")


def phase_ssm_engine(torch, kernels, args, dev="cuda"):
    """mamba2-130m at full width, ``SSM_LAYERS`` of its layers deep, as
    target (weights from --seed) and PARD draft (--seed + 1), bf16, K=8,
    max_batch 4: paged PARD, contiguous PARD and paged AR, each asserting
    its exact ssd_chunked launches."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.training.optimizer import leaves

    cfg = dataclasses.replace(get_config(SSM_MODEL), num_layers=SSM_LAYERS)
    t0 = time.perf_counter()
    tp = init_params(cfg, args.seed, dev, torch.bfloat16)
    dp = init_params(cfg, args.seed + 1, dev, torch.bfloat16)
    _sync(dev)
    n_params = sum(t.numel() for t in leaves(tp))
    log(f"[engine ssm] {SSM_MODEL} ({SSM_LAYERS} of 24 layers) target + "
        f"draft, random bf16 weights "
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
# the uniform-batch generate_* path and the EAGLE baseline
# ---------------------------------------------------------------------------

GEN_TARGET, GEN_DRAFT = "llama3.1-8b", "llama3.2-1b"
GEN_K = 8                            # PARD / VSD draft depth at full width
EAGLE_K = 4                          # EAGLE head passes per iteration
GEN_MAX_NEW = 64                     # new tokens of each batch-1 run
PREFILL_HEADS = {"llama3.1-8b": dict(hq=32, hkv=8, d=128),
                 "llama3.2-1b": dict(hq=32, hkv=8, d=64)}


def phase_prefill_windows(torch, args, dev="cuda"):
    """decode_attention at whole-prompt prefill windows: Tq = P - 1 = 255
    rows from position 0 with G = 4 (1020 query rows, 8 row tiles of 128
    in ``split_kv_plan``), at the head dims of llama3.1-8b (128) and
    llama3.2-1b (64), bf16 and fp32; kv_len equal to the window's end, past
    it and past S (keys the causal mask hides), and a 255-row window at the
    end of a longer context. Each against the plain version, and a second
    call bitwise equal. Returns the worst error."""
    import numpy as np
    from repro_torch.kernels import decode_attention as da
    gen = torch.Generator(device=dev).manual_seed(args.seed + 31)
    rng = np.random.default_rng(args.seed + 31)
    tq, worst = args.prompt_len - 1, 0.0
    for model, heads in PREFILL_HEADS.items():
        for dt in (torch.bfloat16, torch.float32):
            shapes = (
                ("kv_len at the window's end", dict(ctx=[tq, tq],
                                                    s=tq + 1), None),
                ("kv_len past the window and past S",
                 dict(ctx=[tq + 45, tq + 45], s=tq + 1), tq + 45),
                ("the window at the end of ctx 600 / 1000",
                 dict(ctx=[600, 1000], s=1024), None))
            for label, kw, past in shapes:
                case = make_case(torch, gen, rng, "contig", b=2, tq=tq,
                                 kv_dtype=dt, q_dtype=dt, dev=dev, **heads,
                                 **kw)
                if past is not None:      # queries at 0 .. tq - 1 again
                    case["q_pos"] = (torch.arange(tq, device=dev)[None]
                                     .expand(2, tq).to(torch.int32)
                                     .contiguous())
                out, again = (da.decode_attention(**case) for _ in range(2))
                _sync(dev)
                want = oracle(da.decode_attention_ref, case)
                if not torch.isfinite(out).all():
                    raise SmokeFailure(f"decode_attention prefill window "
                                       f"output not finite ({label})")
                err = (out.float() - want.float()).abs().max().item()
                tol = TOL[str(dt).split(".")[1]]
                same = torch.equal(out, again)
                log(f"[prefill window] decode_attention Tq={tq} G=4 "
                    f"D={heads['d']} ({model}) {str(dt)[6:]} {label}: "
                    f"max_abs_err={err:.3e} tol={tol:g}; a second call "
                    f"bitwise equal: {same}")
                if not err <= tol:
                    raise SmokeFailure(f"decode_attention disagrees with its "
                                       f"plain version at a {tq}-row prefill "
                                       f"window ({model}, {dt}, {label}): "
                                       f"{err} > {tol}")
                if not same:
                    raise SmokeFailure(f"decode_attention prefill window "
                                       f"({label}): two calls differ")
                worst = max(worst, err)
    return worst


def _generate_runs(tp, tc, dp, dc, ep, *, ks, tree, max_len, kv_dtype,
                   unadapted=None):
    """label -> (K, a call making (tokens, SpecStats)) of each uniform-batch
    run: AR, VSD, flat PARD at each K of ``ks``, the PARD tree and EAGLE
    (EAGLE_K); VSD and the tree at the largest K. Given ``unadapted`` (the
    draft before COD), VSD drafts with it, and PARD with it runs at the
    smallest K as well."""
    from repro_torch.core.eagle import EagleDecoder
    from repro_torch.core.spec_decode import SpecDecoder

    def dec(draft, k, **kw):
        return SpecDecoder(tp, tc, draft, dc, k=k, max_len=max_len,
                           kv_block_size=0, kv_dtype=kv_dtype, **kw)

    top = max(ks)
    flat = {k: dec(dp, k) for k in ks}
    vsd = flat[top] if unadapted is None else dec(unadapted, top)
    with_tree = dec(dp, top, tree=tree)
    eagle = EagleDecoder(tp, tc, ep, k=EAGLE_K, max_len=max_len,
                         kv_dtype=kv_dtype)
    runs = {"ar": (top, lambda x, n: flat[top].generate_ar(x, n)),
            "vsd": (top, lambda x, n: vsd.generate_spec(x, n, mode="vsd"))}
    for k, d in flat.items():
        runs[f"pard k{k}"] = (k, lambda x, n, d=d: d.generate_spec(x, n))
    runs[f"pard tree {','.join(map(str, tree))}"] = (
        top, lambda x, n: with_tree.generate_spec(x, n))
    runs["eagle"] = (EAGLE_K, lambda x, n: eagle.generate(x, n))
    if unadapted is not None:
        k, d = min(ks), dec(unadapted, min(ks))
        runs[f"pard k{k} unadapted"] = (k, lambda x, n: d.generate_spec(x, n))
    return runs


def generate_expected(label, tc, dc, st, k):
    """decode_attention / tree_attention launches of one run: one per
    attention layer per forward. Prefills: the target's (AR: part of its
    max_new forwards), the draft's or the head's; per iteration: the
    target's verify, and one draft forward (PARD, the tree), K (VSD) or K
    one-layer head passes (EAGLE)."""
    ta, da = _layers(tc)[0], _layers(dc)[0]
    it = st.iterations
    if label == "ar":
        return {"decode_attention": ta * st.target_forwards}
    if label == "eagle":
        return {"decode_attention": ta + 1 + (ta + EAGLE_K) * it}
    if label.startswith("pard tree"):
        return {"decode_attention": ta + da + da * it,
                "tree_attention": ta * it}
    per = da * (k if label == "vsd" else 1)
    return {"decode_attention": ta + da + (ta + per) * it}


def phase_generate(torch, kernels, args, dev="cuda"):
    """The uniform-batch path: tiny fp32 generate_ar / generate_spec (pard,
    vsd, tree) and EagleDecoder tokens on the card equal to the CPU port's
    (weights made on the CPU and moved); decode_attention at 255-row
    prefill windows; llama3.1-8b / llama3.2-1b at full width, bf16, batch
    1, a --prompt-len prompt and GEN_MAX_NEW new tokens through AR, VSD,
    flat PARD (K = 8), the PARD tree WIDE and EAGLE (K = 4, a random head on
    llama3.1-8b), each with its exact attention launches; one eagle_loss
    forward and backward on llama3.1-8b (B = 1, T = --prompt-len, bf16
    activations) through the kernels and through the plain versions.
    Returns (worst decode_attention error, launches by kernel and run)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.core.eagle import eagle_loss, init_eagle
    from repro_torch.examples.quickstart import first_agreement
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as model_attention
    from repro_torch.models import init_params
    from repro_torch.training.optimizer import leaves

    card = card_line()
    worst = phase_prefill_windows(torch, args, dev)

    # tiny fp32: the card against the CPU port, and every path == AR
    tc, dc = get_config("tiny-target"), get_config("tiny-draft")
    cpu = (init_params(tc, args.seed, "cpu", torch.float32),
           init_params(dc, args.seed + 1, "cpu", torch.float32),
           init_eagle(tc, args.seed + 2, "cpu", torch.float32))
    rng = np.random.default_rng(args.seed + 37)
    x = rng.integers(0, tc.vocab_size, (3, 12))
    tiny = {}
    for where, (tp, dp, ep) in (("cpu", cpu),
                                (dev, [_tree_to(t, dev) for t in cpu])):
        runs = _generate_runs(tp, tc, dp, dc, ep, ks=(4,), tree=(2, 2, 1),
                              max_len=128, kv_dtype="fp32")
        tiny[where] = {label: fn(x, 16)[0].cpu().numpy()
                       for label, (_, fn) in runs.items()}
    for label, toks in tiny[dev].items():
        same = np.array_equal(toks, tiny["cpu"][label])
        lossless = np.array_equal(toks, tiny[dev]["ar"])
        log(f"[generate] tiny fp32 {label} on the card: tokens == the CPU "
            f"port's: {same}; == AR: {lossless}")
        if not (same and lossless):
            raise SmokeFailure(f"tiny generate {label}: card tokens differ "
                               f"from the CPU port's or from AR")

    # full width, batch 1
    tc, dc = get_config(GEN_TARGET), get_config(GEN_DRAFT)
    t0 = time.perf_counter()
    tp = init_params(tc, args.seed, dev, torch.bfloat16)
    dp = init_params(dc, args.seed + 1, dev, torch.bfloat16)
    ep = init_eagle(tc, args.seed + 2, dev, torch.bfloat16)
    _sync(dev)
    log(f"[generate] {GEN_TARGET} + {GEN_DRAFT} + an EAGLE head on "
        f"{GEN_TARGET}, random bf16 weights, on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    p, max_new = args.prompt_len, min(args.max_new, GEN_MAX_NEW)
    x = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, tc.vocab_size, (1, p))).to(dev)
    runs = _generate_runs(tp, tc, dp, dc, ep, ks=(GEN_K,), tree=WIDE,
                          max_len=p + max_new + 64, kv_dtype="bf16")
    toks, launches = {}, {}
    for label, (k, fn) in runs.items():
        fn(x, 2)                                  # warm-up, not counted
        _sync(dev)
        kernels.launches.clear()                  # counts to 0 just before
        t0 = time.perf_counter()
        out, st = fn(x, max_new)
        _sync(dev)
        wall = time.perf_counter() - t0
        got = dict(kernels.launches)              # just after
        launches[label] = got
        toks[label] = out.cpu().numpy()
        want = generate_expected(label, tc, dc, st, k)
        ok_vocab = bool(((out >= 0) & (out < tc.vocab_size)).all())
        log(f"[generate] {label} batch 1: {st.tokens_generated} tokens in "
            f"{wall:.2f}s = {st.tokens_generated / wall:.1f} tok/s "
            f"({card}); iterations={st.iterations} "
            f"draft_forwards={st.draft_forwards} "
            f"target_forwards={st.target_forwards} "
            f"mean_accepted={st.mean_accepted:.3f} "
            f"launches={got} (expected {want})")
        if out.shape != (1, p + max_new) or not ok_vocab or \
                not torch.equal(out[:, :p], x):
            raise SmokeFailure(f"generate {label}: bad output")
        if st.tokens_generated != max_new:
            raise SmokeFailure(f"generate {label}: {st.tokens_generated} of "
                               f"{max_new} tokens")
        if got != want:
            raise SmokeFailure(f"generate {label}: launches {got}, expected "
                               f"{want}")
    for label in runs:
        if label != "ar":
            share = first_agreement(toks[label], toks["ar"], p)
            log(f"[generate] {label}: share of tokens equal to AR tokens up "
                f"to the first divergence: {share:.3f}")

    # eagle_loss through the kernels and through the plain versions
    toks = torch.from_numpy(np.random.default_rng(args.seed + 41).integers(
        0, tc.vocab_size, (1, p))).to(dev)
    for t in leaves(ep):
        t.requires_grad_(True)
    got = {}
    try:
        eagle_loss(ep, tp, tc, toks, dtype=torch.bfloat16)[0].backward()
        for route in ("kernels", "plain"):                # after a warm-up
            if route == "plain":
                model_attention.flash_attention = fa.flash_attention_ref
            for t in leaves(ep):
                t.grad = None
            _sync(dev)
            kernels.launches.clear()
            t0 = time.perf_counter()
            loss, parts = eagle_loss(ep, tp, tc, toks, dtype=torch.bfloat16)
            loss.backward()
            _sync(dev)
            ms = (time.perf_counter() - t0) * 1e3
            got[route] = (loss.item(), [t.grad.float().clone()
                                         for t in leaves(ep)],
                          dict(kernels.launches), ms)
    finally:
        model_attention.flash_attention = fa.flash_attention
        for t in leaves(ep):
            t.requires_grad_(False)
            t.grad = None
    (lk, gk, nk, msk), (lp, gp, np_, msp) = got["kernels"], got["plain"]
    norms = [(float(a.norm()), float(b.norm())) for a, b in zip(gk, gp)]
    gnorm = [math.sqrt(sum(a * a for a, _ in norms)),
             math.sqrt(sum(b * b for _, b in norms))]
    diff = math.sqrt(sum(float((a - b).square().sum())
                         for a, b in zip(gk, gp)))
    want = {"flash_attention": _layers(tc)[0] + 1, "flash_attention_bwd": 1}
    log(f"[eagle_loss] {GEN_TARGET} B=1 T={p} bf16: loss kernels {lk:.5f} "
        f"plain {lp:.5f}; head grad norm kernels {gnorm[0]:.5f} plain "
        f"{gnorm[1]:.5f}; |g_kernels - g_plain| / |g_plain| = "
        f"{diff / max(gnorm[1], 1e-30):.3e}; forward + backward {msk:.1f} "
        f"ms through the kernels, {msp:.1f} ms plain, eager wall ({card}); "
        f"launches {nk} (expected {want}), plain route {np_}")
    bad = [(a, b) for a, b in norms + [tuple(gnorm)]
           if not abs(a - b) <= 2e-2 * max(1.0, b)]
    if not abs(lk - lp) <= 2e-2 * max(1.0, abs(lp)) or bad:
        raise SmokeFailure(f"eagle_loss through the kernels disagrees with "
                           f"the plain versions: loss {lk} vs {lp}, grad "
                           f"norms (kernels, plain) {bad}")
    if nk != want or any(np_.values()):
        raise SmokeFailure(f"eagle_loss launches {nk} (plain {np_}), "
                           f"expected {want}")
    launches["eagle_loss"] = nk
    return worst, launches


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
        _sync(dev)
        again = fwd_bwd(c, plain=False)
        _sync(dev)
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


def _plain_ssd(x, dt, A, B, C, init_state=None, *, chunk=64):
    """``ssd_chunked`` through its plain version on any device (autograd
    differentiates it)."""
    from repro_torch.kernels import ssd
    return ssd.ssd_chunked_ref(x, dt, A, B, C, init_state,
                               chunk=ssd.clamp_chunk(chunk, x.shape[1]))


@contextlib.contextmanager
def _plain_routes():
    """The model's attention (cache-free and cached) and Mamba2 modules
    pointed at the plain versions inside the block."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import pard_attention as pa
    from repro_torch.kernels import ssd
    from repro_torch.kernels import tree_attention as ta
    from repro_torch.models import attention as model_attention
    from repro_torch.models import ssm as model_ssm
    plain = {"flash_attention": fa.flash_attention_ref,
             "pard_attention": (
                 lambda q, k, v, info, **kw: pa.pard_attention_ref(
                     q, k, v, info.segment, info.base, **kw)),
             "decode_attention": da.decode_attention_ref,
             "decode_attention_paged": da.decode_attention_paged_ref,
             "tree_attention": ta.tree_attention_ref,
             "tree_attention_paged": ta.tree_attention_paged_ref}
    kept = {n: getattr(model_attention, n) for n in plain}
    for n, fn in plain.items():
        setattr(model_attention, n, fn)
    model_ssm.ssd_chunked = _plain_ssd
    try:
        yield
    finally:
        for n, fn in kept.items():
            setattr(model_attention, n, fn)
        model_ssm.ssd_chunked = ssd.ssd_chunked


def _route_grads(torch, kernels, loss_fn, params):
    """Loss, global gradient norm and launches of ``loss_fn()`` through the
    kernels and through the plain versions (``_plain_routes``), and
    |g_kernels - g_plain|, taken one leaf at a time: only the kernel
    route's gradients are kept, not copied, while the plain route's come
    in."""
    from repro_torch.training.optimizer import leaves
    got, kept, diff2 = {}, [], 0.0
    try:
        for route in ("kernels", "plain"):
            with (_plain_routes() if route == "plain"
                  else contextlib.nullcontext()):
                for p in leaves(params):
                    p.requires_grad_(True)
                    p.grad = None
                kernels.launches.clear()
                loss = loss_fn()
                loss.backward()
            norm2 = 0.0
            for i, p in enumerate(leaves(params)):
                g = p.grad.float()
                norm2 += float(g.square().sum())
                if route == "kernels":
                    kept.append(p.grad)
                else:
                    diff2 += float((kept[i].float() - g).square().sum())
                    kept[i] = None
                p.grad = None
            got[route] = (loss.item(), math.sqrt(norm2),
                          dict(kernels.launches))
    finally:
        for p in leaves(params):
            p.requires_grad_(False)
            p.grad = None
    return got, math.sqrt(diff2)


# the Mamba2 leaves nearest the scan (models/ssm.py mamba2_apply): their
# gradients pass through ssd_chunked_bwd and little else
SCAN_LEAVES = ("in_proj", "conv_w", "conv_b", "dt_bias", "A_log")


def _leaf_names(tree, key=""):
    """The last key of each leaf of a params tree, in ``leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaf_names(tree[k], k)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaf_names(v, key)]
    return [key]


def scan_oracle(torch, tr, params, batch):
    """Which bf16 route is nearer the exact gradient of one training step:
    the step's gradients through the kernels (bf16 activations), through
    the plain versions (bf16) and, as the oracle, through the plain
    versions with f32 activations; |g - g_oracle| / |g_oracle| of both bf16
    routes over every leaf and over ``SCAN_LEAVES``, printed. Returns
    {route: (all leaves, scan leaves)}."""
    from repro_torch.training.optimizer import leaves
    names = _leaf_names(params)
    scan = [n in SCAN_LEAVES for n in names]
    dtype, remat = tr.dtype, tr.remat
    grads = {}
    try:
        tr.remat = True
        for route, plain, act in (("kernels bf16", False, dtype),
                                  ("plain bf16", True, dtype),
                                  ("oracle", True, torch.float32)):
            tr.dtype = act
            with _plain_routes() if plain else contextlib.nullcontext():
                for p in leaves(params):
                    p.requires_grad_(True)
                    p.grad = None
                tr.loss(params, batch)[0].backward()
            grads[route] = [p.grad.float() for p in leaves(params)]
    finally:
        tr.dtype, tr.remat = dtype, remat
        for p in leaves(params):
            p.requires_grad_(False)
            p.grad = None

    def dist(route, sel):
        num = sum(float((g - o).square().sum()) for g, o, s in zip(
            grads[route], grads["oracle"], sel) if s)
        den = sum(float(o.square().sum())
                  for o, s in zip(grads["oracle"], sel) if s)
        return math.sqrt(num / den)

    out = {r: (dist(r, [True] * len(scan)), dist(r, scan))
           for r in ("kernels bf16", "plain bf16")}
    (ka, ks), (pa_, ps) = out["kernels bf16"], out["plain bf16"]
    log(f"[train ssm] nearer the exact gradient? one B=1 step, |g - g_f32| "
        f"/ |g_f32| against the plain versions with f32 activations: all "
        f"leaves kernels bf16 {ka:.3e}, plain bf16 {pa_:.3e} (ratio "
        f"{ka / pa_:.3f}); {'/'.join(SCAN_LEAVES)} ({sum(scan)} leaves) "
        f"kernels bf16 {ks:.3e}, plain bf16 {ps:.3e} (ratio {ks / ps:.3f}); "
        f"the kernel route is {'nearer' if ka <= pa_ else 'farther'}"
        + ("" if ka <= 1.5 * pa_ else " by more than 1.5x"))
    del grads
    return out


def compare_plain_step(torch, kernels, tr, params, batch):
    """``_route_grads`` of one training step on the card, one layer's
    plain [T, T] scores at a time (remat)."""
    tr.remat = True
    try:
        return _route_grads(torch, kernels,
                            lambda: tr.loss(params, batch)[0], params)
    finally:
        tr.remat = False


def step_parts_ms(torch, tr, params, state, batch):
    """One more ``Trainer.step`` cut into forward + loss, backward and the
    AdamW update by its CUDA events (the device timeline, gaps waiting on
    the host included)."""
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    torch.cuda.synchronize()
    tr.step(params, state, batch, events=ev)
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]


def full_width_cell(torch, kernels, args, cfg, corpus, flags, n, names, tag,
                    dev="cuda", extra=None, remat=False, falling=True):
    """One full-width training cell with the trainer that
    ``repro_torch.launch.train`` makes from ``flags``, from --seed weights:
    a B=1 step through the kernels and through the plain versions (loss and
    global grad norm within 2e-2, the gradient difference printed), then
    --train-steps steps at B 4, N ``n`` through ``Trainer.fit`` with one
    launch of each kernel in ``names`` per layer per step and a finite,
    falling loss, and one more step cut into forward + loss, backward and
    AdamW; ``extra(tr, params, batch)``, if given, runs on the B=1 step's
    weights and batch before the fit. ``remat`` recomputes each layer in
    the fit's backward passes (so each forward kernel launches twice a
    layer and step); ``falling=False`` asks only for a finite loss.
    Returns the launches of the fit."""
    import numpy as np
    from repro_torch.launch import train as launch_train
    from repro_torch.models import init_params

    tr = launch_train.make_trainer(
        launch_train.build_parser().parse_args(flags), cfg, dev)
    params = init_params(cfg, args.seed, dev, torch.float32)
    one = tr.make_batch(corpus.sample(np.random.default_rng(args.seed + 5),
                                      1, n), seed=args.seed)
    got, diff = compare_plain_step(torch, kernels, tr, params, one)
    (lk, gk, nk), (lp, gp, np_) = got["kernels"], got["plain"]
    rel = max(abs(lk - lp) / abs(lp), abs(gk - gp) / abs(gp))
    log(f"[{tag}] B=1 N={n} one step on the card: loss kernels {lk:.6f} "
        f"plain {lp:.6f}; grad norm kernels {gk:.6f} plain {gp:.6f}; max rel "
        f"diff {rel:.3e} (tol 2e-2); |g_k - g_p| / |g_p| = "
        f"{diff / max(gp, 1e-30):.3e}; launches kernels {nk} plain {np_}")
    if not (rel <= 2e-2 and math.isfinite(lk) and math.isfinite(gk)):
        raise SmokeFailure(f"{tag}: kernels and plain versions disagree "
                           f"(rel {rel})")
    if np_ or not all(nk.get(name) for name in names):
        raise SmokeFailure(f"{tag}: the routes did not take the intended "
                           f"kernels ({nk} / {np_})")
    if extra is not None:
        extra(tr, params, one)

    stream = corpus.batches(4, n, seed=args.seed)
    tr.remat = remat
    _sync(dev)
    if dev == "cuda":
        torch.cuda.reset_peak_memory_stats()
    kernels.launches.clear()                  # counts to 0 just before
    t0 = time.perf_counter()
    params, state, hist = tr.fit(params, stream, args.train_steps,
                                 log_every=1, log_fn=None)
    _sync(dev)
    wall = time.perf_counter() - t0
    got_launches = dict(kernels.launches)     # just after
    peak = torch.cuda.max_memory_allocated() if dev == "cuda" else 0
    steps = len(hist)
    want = {name: cfg.num_layers * steps
            * (2 if remat and not name.endswith("_bwd") else 1)
            for name in names}
    losses = [h["loss"] for h in hist]
    walls = [0.0] + [h["wall"] for h in hist]
    step_ms = np.diff(walls) * 1e3
    steady = step_ms[1:]
    tok_s = (hist[-1]["tokens"] - hist[0]["tokens"]) / (
        hist[-1]["wall"] - hist[0]["wall"])
    packed = one["segment"].shape[1] if "segment" in one else n - 1
    log(f"[{tag}] {cfg.name} full width, {cfg.num_layers} layers, B=4 N={n} "
        f"(T={packed}), {steps} steps in {wall:.2f}s; loss {losses[0]:.4f} "
        f"-> {losses[-1]:.4f}; step ms p50 {np.percentile(steady, 50):.2f} "
        f"p95 {np.percentile(steady, 95):.2f} (steps 2-{steps}; step 1 "
        f"{step_ms[0]:.1f}); trained tokens/s {tok_s:.0f} (steps "
        f"2-{steps}, {hist[-1]['tokens']} tokens in all); peak_mem "
        f"{peak / 2**30:.2f}GiB; grad_norm {hist[0]['grad_norm']:.3f} -> "
        f"{hist[-1]['grad_norm']:.3f}; launches={got_launches} (expected "
        f"{want})")
    log(f"[{tag}] losses {[round(x, 4) for x in losses]}")
    if dev == "cuda":
        parts = step_parts_ms(torch, tr, params, state, tr.make_batch(
            next(stream), seed=args.train_steps))
        log(f"[{tag}] one more step on the device timeline: forward + loss "
            f"{parts[0]:.2f} ms, backward {parts[1]:.2f} ms, AdamW "
            f"{parts[2]:.2f} ms (sum {sum(parts):.2f} ms)")
    if got_launches != want:
        raise SmokeFailure(f"{tag}: launches {got_launches}, expected {want}")
    if not all(math.isfinite(x) for x in losses) or \
            (falling and not losses[-1] < losses[0]):
        raise SmokeFailure(f"{tag}: loss not finite and falling "
                           f"({losses[0]} -> {losses[-1]})")
    del params, state, tr
    if dev == "cuda":
        torch.cuda.empty_cache()
    return got_launches


def phase_train(torch, kernels, args, dev="cuda"):
    """llama3.2-1b at full width: the AR and PARD cells of
    ``full_width_cell``."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import MarkovCorpus

    cfg = get_config(TRAIN_MODEL)
    corpus = MarkovCorpus(vocab_size=cfg.vocab_size, seed=0, determinism=2.0)
    launches = {}
    for kind, n in TRAIN_SEQ.items():
        flags = ["--arch", TRAIN_MODEL, "--steps", str(args.train_steps),
                 "--batch", "4", "--seq", str(n), "--seed", str(args.seed),
                 "--lr", str(TRAIN_LR), "--device", dev,
                 "--dtype", "bfloat16"]
        if kind == "pard":
            flags += ["--pard", "--k", str(COD[0]), "--r", str(COD[1]),
                      "--r-min", str(COD[2])]
        launches.update(full_width_cell(
            torch, kernels, args, cfg, corpus, flags, n,
            TRAIN_KERNELS["flash" if kind == "ar" else "pard"],
            f"train {kind}", dev))
    return launches


# ---------------------------------------------------------------------------
# phase 11: the train -> COD-adapt -> serve recipe on trained weights
# ---------------------------------------------------------------------------

TRAINED_STEPS = 300                  # the recipe's --ar-steps / --pard-steps
TRAINED_NEW = 48                     # new tokens of the uniform-batch runs
TRAINED_T = 0.8                      # the sampled engine run
PARD_FLOOR = 1.8                     # greedy PARD K 4 mean accepted
SAMPLED_FLOOR = 1.3                  # sampled engine mean accepted


def check_step_routes(torch, kernels, label, loss_fn, params, want, dev,
                      tag="trained"):
    """One fp32 step's loss and gradients through the kernels against the
    plain versions: loss, global gradient norm and |g_kernels - g_plain| /
    |g_plain| within TOL["float32"]; the kernel route launches ``want``,
    the plain route nothing. Lines are logged under ``[tag label]``."""
    tol = TOL["float32"]
    got, diff = _route_grads(torch, kernels, loss_fn, params)
    (lk, gk, nk), (lp, gp, np_) = got["kernels"], got["plain"]
    diff /= max(gp, 1e-30)
    rel = max(abs(lk - lp) / max(abs(lp), 1e-30),
              abs(gk - gp) / max(gp, 1e-30), diff)
    log(f"[{tag} {label}] one step, kernels vs plain: loss {lk:.6f} / "
        f"{lp:.6f}, grad norm {gk:.6f} / {gp:.6f}, |g_k - g_p| / |g_p| = "
        f"{diff:.3e} (tol {tol:g}); launches {nk} (expected {want}), plain "
        f"{np_}")
    if not (rel <= tol and math.isfinite(lk)):
        raise SmokeFailure(f"{tag} {label}: kernels and plain versions "
                           f"disagree ({rel})")
    if dev == "cuda" and (nk != want or any(np_.values())):
        raise SmokeFailure(f"{tag} {label}: launches {nk} (plain {np_}), "
                           f"expected {want}")


def _losses(out):
    """(params, Trainer history, meta) -> (params, losses, meta)."""
    params, hist, meta = out
    return params, [h["loss"] for h in hist], meta


def trained_fit(torch, kernels, label, fn, want, dev):
    """Run one training stage ``fn() -> (params, losses, meta)`` with the
    counts set to 0 just before and read just after: exact launches, a
    finite and falling loss. Returns (params, launches)."""
    _sync(dev)
    kernels.launches.clear()
    t0 = time.perf_counter()
    params, losses, _ = fn()
    _sync(dev)
    wall = time.perf_counter() - t0
    got = dict(kernels.launches)
    log(f"[trained {label}] {len(losses)} steps in {wall:.2f}s "
        f"({len(losses) / wall:.1f} steps/s); loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; launches={got} (expected {want})")
    if dev == "cuda" and got != want:
        raise SmokeFailure(f"trained {label}: launches {got}, expected "
                           f"{want}")
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise SmokeFailure(f"trained {label}: loss not finite and falling "
                           f"({losses[0]} -> {losses[-1]})")
    return params, got


def trained_training(torch, kernels, corpus, dev):
    """Phase 11 (a): bench-target, bench-draft and bench-mid AR, the
    pard_k8_r07 adaptation of bench-draft and the EAGLE head on
    bench-target, through the recipe's functions at its shapes and steps;
    before each stage but bench-mid's, one step of the recipe's first
    batch through the kernels and through the plain versions. Returns
    (params by name, launches by stage)."""
    from repro_torch.configs import get_config
    from repro_torch.core.cod import CodConfig
    from repro_torch.core.eagle import eagle_loss, init_eagle
    from repro_torch.examples import pard_adaptation_train as recipe
    from repro_torch.interop import cast_params
    from repro_torch.models import init_params

    flash, pard = TRAIN_KERNELS["flash"], TRAIN_KERNELS["pard"]
    params, launches = {}, {}
    for name, seed in recipe.AR_RUNS:
        cfg, steps = get_config(name), TRAINED_STEPS
        if name != "bench-mid":
            tr = recipe.trainer(cfg, steps, dev)
            batch = tr.make_batch(next(corpus.batches(*recipe.AR_SHAPE,
                                                      seed=seed)))
            p0 = init_params(cfg, seed, dev, torch.float32)
            check_step_routes(torch, kernels, f"{name} AR (D "
                              f"{cfg.resolved_head_dim}, T "
                              f"{recipe.AR_SHAPE[1] - 1})",
                              lambda: tr.loss(p0, batch)[0], p0,
                              {n: cfg.num_layers for n in flash}, dev)
        params[name], launches[f"{name} AR"] = trained_fit(
            torch, kernels, f"{name} AR", lambda: _losses(recipe.train_ar(
                name, seed, steps, corpus, dev, log_every=1, log_fn=None)),
            {n: cfg.num_layers * steps for n in flash}, dev)

    dc = get_config("bench-draft")
    tr = recipe.trainer(dc, TRAINED_STEPS, dev,
                        cod=CodConfig(k=8, r=0.7, r_min=0.2))
    batch = tr.make_batch(next(corpus.batches(*recipe.COD_SHAPE,
                                              seed=recipe.COD_STREAM)),
                          seed=0)
    p0 = cast_params(params["bench-draft"], torch.float32)
    check_step_routes(torch, kernels, f"pard_k8_r07 COD (D "
                      f"{dc.resolved_head_dim}, packed T "
                      f"{batch['segment'].shape[1]})",
                      lambda: tr.loss(p0, batch)[0], p0,
                      {n: dc.num_layers for n in pard}, dev)
    params["pard_k8_r07"], launches["pard_k8_r07 COD"] = trained_fit(
        torch, kernels, "pard_k8_r07 COD K 8", lambda: _losses(recipe.adapt(
            params["bench-draft"], 8, 0.7, 0.2, True, TRAINED_STEPS, corpus,
            dev, log_every=1, log_fn=None)),
        {n: dc.num_layers * TRAINED_STEPS for n in pard}, dev)

    tc, tp = get_config("bench-target"), params["bench-target"]
    toks = torch.from_numpy(next(corpus.batches(
        *recipe.EAGLE_SHAPE, seed=recipe.EAGLE_STREAM))).to(dev)
    e0 = init_eagle(tc, recipe.EAGLE_SEED, dev, torch.float32)
    check_step_routes(torch, kernels, f"eagle head on bench-target (D "
                      f"{tc.resolved_head_dim}, T {recipe.EAGLE_SHAPE[1]})",
                      lambda: eagle_loss(e0, tp, tc, toks)[0], e0,
                      {flash[0]: tc.num_layers + 1, flash[1]: 1}, dev)
    params["eagle_head"], launches["eagle head"] = trained_fit(
        torch, kernels, "eagle head", lambda: recipe.train_eagle_head(
            tp, tc, TRAINED_STEPS, corpus, dev, log_fn=None),
        {flash[0]: (tc.num_layers + 1) * TRAINED_STEPS,
         flash[1]: TRAINED_STEPS}, dev)
    return params, launches


def trained_generate(torch, kernels, params, prompt, dev):
    """Phase 11 (b): the uniform batch on the trained pair, fp32 then
    bf16, through ``_generate_runs``: AR, VSD (K 8, the unadapted draft),
    flat PARD at K 4 and K 8, the PARD tree WIDE, EAGLE (K 4) and PARD K 4
    with the unadapted draft, each with its exact attention launches.
    Returns launches by run."""
    from repro_torch.configs import get_config
    from repro_torch.examples.quickstart import first_agreement
    from repro_torch.interop import cast_params

    tc, dc = get_config("bench-target"), get_config("bench-draft")
    card, p = card_line(), prompt.shape[1]
    x = torch.from_numpy(prompt).to(dev)
    launches, toks, stats = {}, {}, {}
    for dtype, kv in ((torch.float32, "fp32"), (torch.bfloat16, "bf16")):
        tp, dp, pp, ep = (cast_params(params[n], dtype) for n in
                          ("bench-target", "bench-draft", "pard_k8_r07",
                           "eagle_head"))
        runs = _generate_runs(tp, tc, pp, dc, ep, ks=(4, 8), tree=WIDE,
                              max_len=512, kv_dtype=kv, unadapted=dp)
        for label, (k, fn) in runs.items():
            fn(x, 2)                                  # warm-up, not counted
            _sync(dev)
            kernels.launches.clear()                  # counts to 0 just before
            t0 = time.perf_counter()
            out, st = fn(x, TRAINED_NEW)
            _sync(dev)
            wall = time.perf_counter() - t0
            got = dict(kernels.launches)              # just after
            want = generate_expected(label, tc, dc, st, k)
            toks[kv, label], stats[kv, label] = out.cpu().numpy(), st
            launches[f"{label} {kv}"] = got
            log(f"[trained generate {kv}] {label}: {st.tokens_generated} "
                f"tokens in {wall:.3f}s = {st.tokens_generated / wall:.1f} "
                f"tok/s ({card}); iterations={st.iterations} "
                f"draft_forwards={st.draft_forwards} "
                f"target_forwards={st.target_forwards} "
                f"mean_accepted={st.mean_accepted:.3f} launches={got} "
                f"(expected {want})")
            if out.shape != (len(prompt), p + TRAINED_NEW) or \
                    st.tokens_generated != TRAINED_NEW * len(prompt):
                raise SmokeFailure(f"trained generate {label} {kv}: bad "
                                   f"output")
            if dev == "cuda" and got != want:
                raise SmokeFailure(f"trained generate {label} {kv}: "
                                   f"launches {got}, expected {want}")
        for label in runs:
            if label == "ar":
                continue
            share = first_agreement(toks[kv, label], toks[kv, "ar"], p)
            log(f"[trained generate {kv}] {label}: share of tokens equal "
                f"to AR's up to the first divergence {share:.3f} (mean of "
                f"{len(prompt)} rows)")
            if kv == "fp32" and share != 1.0:
                raise SmokeFailure(f"trained generate {label} fp32: tokens "
                                   f"differ from AR's")
    pard, base = stats["fp32", "pard k4"], stats["fp32", "pard k4 unadapted"]
    log(f"[trained generate] greedy PARD K 4 mean accepted "
        f"{pard.mean_accepted:.3f} (floor {PARD_FLOOR}), the unadapted "
        f"bench-draft's {base.mean_accepted:.3f}")
    if not (pard.mean_accepted >= PARD_FLOOR
            and base.mean_accepted < pard.mean_accepted):
        raise SmokeFailure(f"trained PARD K 4: mean accepted "
                           f"{pard.mean_accepted} (floor {PARD_FLOOR}, "
                           f"unadapted {base.mean_accepted})")
    return launches


def trained_engine(torch, kernels, params, args, dev):
    """Phase 11 (c): the engine on the trained pair in fp32 over the
    launcher's prompts (8 requests of 16 tokens, 48 new, max_batch 4):
    paged PARD, AR, VSD (the unadapted draft), the paged adaptive tree,
    and paged PARD at T = 0.8 twice; greedy runs equal AR, the sampled
    run repeats bit for bit and keeps its mean accepted above
    SAMPLED_FLOOR. Returns launches by run."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import workload
    from repro_torch.serving.engine import Engine, EngineConfig

    tc, dc = get_config("bench-target"), get_config("bench-draft")
    tp, dp, pp = (params[n] for n in ("bench-target", "bench-draft",
                                      "pard_k8_r07"))
    prompts = workload(argparse.Namespace(
        seed=args.seed, requests=8, prompt_len=16, prefix_share=1),
        tc.vocab_size)
    base = dict(max_batch=4, max_len=512, kv_dtype="fp32", seed=args.seed)
    runs = {"pard paged": (pp, {}), "ar": (None, dict(mode="ar")),
            "vsd": (dp, dict(mode="vsd")),
            "adaptive tree paged": (pp, dict(adaptive_tree=True)),
            f"pard paged T={TRAINED_T}": (pp, dict(temperature=TRAINED_T)),
            f"pard paged T={TRAINED_T} repeat": (pp, dict(
                temperature=TRAINED_T))}
    toks, infos, launches = {}, {}, {}
    for label, (draft, kw) in runs.items():
        toks[label], launches[label], infos[label] = serve(
            torch, kernels, Engine, EngineConfig(**base, **kw), tp, tc,
            draft, dc if draft is not None else None, prompts, TRAINED_NEW,
            f"trained {label}", dev)
    same = {label: all(np.array_equal(toks[label][r], t)
                       for r, t in toks["ar"].items())
            for label in ("pard paged", "vsd", "adaptive tree paged")}
    sampled = f"pard paged T={TRAINED_T}"
    repeat = all(np.array_equal(toks[sampled][r], t)
                 for r, t in toks[sampled + " repeat"].items())
    acc = infos[sampled]["mean_accepted"]
    log(f"[trained engine] fp32 tokens == AR's: {same}; T={TRAINED_T} "
        f"repeat bitwise equal: {repeat}; sampled mean accepted {acc:.3f} "
        f"(floor {SAMPLED_FLOOR}); greedy PARD mean accepted "
        f"{infos['pard paged']['mean_accepted']:.3f}, adaptive tree "
        f"{infos['adaptive tree paged']['mean_accepted']:.3f}")
    if not all(same.values()) or not repeat or not acc >= SAMPLED_FLOOR:
        raise SmokeFailure(f"trained engine: == AR {same}, repeat {repeat}, "
                           f"sampled mean accepted {acc}")
    launches.pop(sampled + " repeat")
    return launches


def trained_independence(torch, params, prompt, dev):
    """Phase 11 (d): one pard_k8_r07 draft against bench-target, bench-mid
    and bench-draft at K 8 (the target-independence table), fp32: PARD's
    tokens equal AR's for each."""
    from repro_torch.configs import get_config
    from repro_torch.examples import target_independence as ti
    card = card_line()
    dc = get_config("bench-draft")
    for name in ti.TARGETS:
        r = ti.independence_row(params["pard_k8_r07"], dc, name,
                                params[name], get_config(name), prompt,
                                torch.device(dev))
        log(f"[trained independence] {name}: AR+ {r['ar_tok_s']:.1f} tok/s, "
            f"PARD {r['pard_tok_s']:.1f} tok/s, speedup {r['speedup']:.2f}x, "
            f"acceptance {r['acc']:.3f}, mean accepted "
            f"{r['mean_accepted']:.3f}, lossless {r['lossless']} ({card})")
        if not r["lossless"]:
            raise SmokeFailure(f"trained independence {name}: PARD tokens "
                               f"differ from AR's")


def phase_trained(torch, kernels, args, dev="cuda"):
    """The recipe of ``repro_torch.examples`` on the card: training through
    the four training kernels, then the uniform batch, the engine and the
    target-independence table on the weights it trained. Returns each
    kernel's launches by run."""
    import numpy as np
    from repro_torch.data.pipeline import MarkovCorpus
    from repro_torch.examples import pard_adaptation_train as recipe
    corpus = MarkovCorpus(**recipe.CORPUS)
    params, launches = trained_training(torch, kernels, corpus, dev)
    prompt = corpus.prompts(np.random.default_rng(5), 4, 16)
    launches.update(trained_generate(torch, kernels, params, prompt, dev))
    launches.update(trained_engine(torch, kernels, params, args, dev))
    trained_independence(torch, params, prompt, dev)
    if dev == "cuda":
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 12: Mamba2 training through the SSD scan's backward kernel
# ---------------------------------------------------------------------------

SSD_TRAIN = dict(b=4, t=1024, h=24, p=64, n=128, chunk=64)   # mamba2-130m
# label -> (shape, init state and final-state cotangent)
SSD_GRAD_CASES = {
    "mamba2-130m training shape": (SSD_TRAIN, False),
    "ragged tail b=1 t=1000": (dict(SSD_TRAIN, b=1, t=1000), False),
    "t=1": (dict(SSD_TRAIN, t=1), False),
    "tiny-ssm t=9": (dict(b=2, t=9, h=4, p=32, n=16, chunk=8), False),
    "init state + final-state cotangent t=100": (dict(SSD_TRAIN, b=2, t=100),
                                                 True),
    "P-block edge t=50": (dict(SSD_EDGE, b=2, t=50, chunk=16), True),
}
SSD_GRADS = ("dx", "ddt", "dA", "dB", "dC", "dinit")


def _ssd_grad_inputs(torch, gen, dev, *, b, t, h, p, n, chunk, dtype, full):
    """An ssd_case that requires grad, with a cotangent dy (x's dtype) and,
    with ``full``, a nonzero init state and a final-state cotangent."""
    c = ssd_case(torch, gen, b=b, t=t, h=h, p=p, n=n, dtype=dtype,
                 chunk=chunk, init=full, dev=dev)
    dy = torch.randn(b, t, h, p, generator=gen, device=dev).to(dtype)
    ds = torch.randn(b, h, p, n, generator=gen, device=dev) if full else None
    return c, dy, ds


def _ssd_f64(torch, c, dy, ds):
    """float64 copies of one case's inputs and cotangents: the plain
    versions run on them in float64 give the exact gradient of these
    values."""
    c = {k: v.double() if torch.is_tensor(v) else v for k, v in c.items()}
    return c, dy.double(), None if ds is None else ds.double()


def _ssd_autograd(torch, fn, c, dy, ds):
    """The gradients of ``fn`` (ssd_chunked or ssd_chunked_ref) through
    torch.autograd, in ``SSD_GRADS`` order (dinit None without an init
    state)."""
    ins = [a.detach().requires_grad_(True) for a in _ssd_args(c)
           if a is not None]
    y, st = fn(*ins, *([None] * (6 - len(ins))), chunk=c["chunk"])
    outs, cots = ([y, st], [dy, ds]) if ds is not None else ([y], [dy])
    got = torch.autograd.grad(outs, ins, cots)
    return list(got) + [None] * (6 - len(got))


def _grad_err(torch, got, want, tol, ulps):
    """(max |got - want| / bound, max |got - want|) with the bound tol *
    max(1, |want|) + ``ulps`` float32 ulps of max |want| per entry."""
    diff = (got.double() - want).abs()
    floor = ulps * 2.0 ** -23 * want.abs().max().item()
    return ((diff / (tol * want.abs().clamp(min=1.0) + floor)).max().item(),
            diff.max().item())


def _f32_plain_distance(torch, ssd, c, dy, ds, chunk, kernel, exact):
    """max |g - exact| / max(1, |exact|) per gradient of the kernel and of
    the float32 plain versions (``ssd_chunked_bwd_ref`` and autograd of
    ``ssd_chunked_ref``), as one log line: how near float32 can come."""
    routes = {"kernel": kernel,
              "ssd_chunked_bwd_ref f32": ssd.ssd_chunked_bwd_ref(
                  *_ssd_args(c), dy, ds, chunk=chunk),
              "autograd of ssd_chunked_ref f32": _ssd_autograd(
                  torch, lambda *a, chunk: ssd.ssd_chunked_ref(
                      *a, chunk=ssd.clamp_chunk(chunk, a[0].shape[1])),
                  c, dy, ds)}
    log("[ssd grad] float32 at the training shape, max |err| / max(1, "
        "|exact|) against the float64 gradient: " + "; ".join(
            f"{route} " + ", ".join(
                f"{name} {_grad_err(torch, g, w, 1.0, 0)[0]:.2e}"
                for name, g, w in zip(SSD_GRADS, grads, exact)
                if g is not None)
            for route, grads in routes.items()))


def phase_ssd_grad(torch, kernels, args, dev="cuda"):
    """Phase 12 (a): the SSD backward kernel through torch.autograd against
    ``ssd_chunked_bwd_ref`` and against autograd of ``ssd_chunked_ref``,
    every gradient, bf16 and fp32, at ``SSD_GRAD_CASES``; one forward and
    one backward launch per call; two backward calls bitwise equal; finite
    gradients at dt = 20, A = -16. Returns the largest max abs error.

    The plain versions run in float64 on the inputs' values: the exact
    gradient, not a second float32 rounding of it. Each entry must lie
    within TOL * max(1, |plain|); in fp32 plus 2 float32 ulps of the
    gradient's largest entry: at the training shape the gradients reach
    ~1e3 and an entry near 1 (ddt) is a sum of terms that large, which no
    float32 computation holds to 1e-4: at the fp32 training-shape case the
    float32 plain versions' own distance from the float64 gradient is
    printed beside the kernel's (``_f32_plain_distance``)."""
    from repro_torch.kernels import ssd
    gen = torch.Generator(device=dev).manual_seed(args.seed + 29)
    worst = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        tol = TOL[str(dtype).split(".")[1]]
        for label, (dims, full) in SSD_GRAD_CASES.items():
            c, dy, ds = _ssd_grad_inputs(torch, gen, dev, dtype=dtype,
                                         full=full, **dims)
            chunk = ssd.clamp_chunk(c["chunk"], dims["t"])
            before = dict(kernels.launches)
            got = _ssd_autograd(torch, ssd.ssd_chunked, c, dy, ds)
            _sync(dev)
            n_fwd = kernels.launches["ssd_chunked"] - before.get(
                "ssd_chunked", 0)
            n_bwd = kernels.launches["ssd_chunked_bwd"] - before.get(
                "ssd_chunked_bwd", 0)
            c64, dy64, ds64 = _ssd_f64(torch, c, dy, ds)
            ref = ssd.ssd_chunked_bwd_ref(*_ssd_args(c64), dy64, ds64,
                                          chunk=chunk)
            auto = _ssd_autograd(torch, lambda *a, chunk: ssd.ssd_chunked_ref(
                *a, chunk=ssd.clamp_chunk(chunk, a[0].shape[1])), c64, dy64,
                ds64)
            ulps = 2 if dtype == torch.float32 else 0
            errs = {}
            for name, g, r, a in zip(SSD_GRADS, got, ref, auto):
                if g is None:
                    continue
                if not torch.isfinite(g).all():
                    raise SmokeFailure(f"ssd_chunked_bwd {name} not finite "
                                       f"({label} {dtype})")
                errs[name] = (_grad_err(torch, g, r, tol, ulps),
                              _grad_err(torch, g, a, tol, ulps))
            worst = max(worst, *(e[0][1] for e in errs.values()))
            log(f"[ssd grad] {label} {dtype} chunk={chunk}: launches fwd "
                f"{n_fwd} bwd {n_bwd}; max_abs_err vs bwd_ref / vs autograd "
                f"of the plain scan (both float64), worst err / bound: "
                + ", ".join(f"{k} {v[0][1]:.3e} / {v[1][1]:.3e} "
                            f"({max(v[0][0], v[1][0]):.3f})"
                            for k, v in errs.items())
                + f" (bound {tol:g} * max(1, |plain|)"
                + (f" + {ulps} ulps of max |plain|)" if ulps else ")"))
            bad = {k: max(v[0][0], v[1][0]) for k, v in errs.items()
                   if not max(v[0][0], v[1][0]) <= 1.0}
            if bad:
                raise SmokeFailure(f"ssd_chunked_bwd disagrees with its plain "
                                   f"version ({label} {dtype}): {bad}")
            if (n_fwd, n_bwd) != (1, 1):
                raise SmokeFailure(f"ssd grad {label}: launches fwd {n_fwd} "
                                   f"bwd {n_bwd}, expected 1 and 1")
            if dtype == torch.float32 and dims is SSD_TRAIN:
                _f32_plain_distance(torch, ssd, c, dy, ds, chunk, got, ref)
            if dtype == torch.bfloat16 and dims is SSD_TRAIN:
                log("[ssd grad] bf16 kernel at the training shape, max |err| "
                    "/ max(1, |exact|) against the float64 gradient: "
                    + ", ".join(f"{name} {_grad_err(torch, g, w, 1.0, 0)[0]:.2e}"
                                for name, g, w in zip(SSD_GRADS, got, ref)
                                if g is not None))
        c, dy, ds = _ssd_grad_inputs(torch, gen, dev, dtype=dtype, full=True,
                                     **SSD_TRAIN)
        first, second = (ssd.ssd_chunked_bwd(*_ssd_args(c), dy, ds,
                                             chunk=c["chunk"])
                         for _ in range(2))
        _sync(dev)
        same = all(torch.equal(a, b) for a, b in zip(first, second))
        c["dt"].fill_(20.0)
        c["A"].fill_(-16.0)
        big = ssd.ssd_chunked_bwd(*_ssd_args(c), dy, ds, chunk=c["chunk"])
        finite = all(bool(torch.isfinite(g).all()) for g in big)
        log(f"[ssd grad] {dtype} training shape: two backward calls bitwise "
            f"equal: {same}; dt = 20, A = -16: gradients finite: {finite}")
        if not (same and finite):
            raise SmokeFailure(f"ssd_chunked_bwd: repeat {same}, finite at a "
                               f"large |dt A| {finite} ({dtype})")
        del c, dy, ds, first, second, big
    return worst


def ssd_bwd_bound_ms(c, full):
    """Least time on the card for one backward call: bytes (x, dt, A, B, C,
    dy and, with ``full``, the init state and the final-state cotangent read
    once; dx, ddt, dA, dB, dC and dinit written once; nothing saved by the
    forward) at the memory rate, vs the multiply-adds of the gradient (per
    chunk of l real tokens and head: over the l(l+1)/2 pairs C.B, dy.xdt
    and the three intra-chunk products, 3N + 2P; per token the state
    recomputation and the five state products, 6 P N) at the peak rate of
    x's type; the larger of the two."""
    x, bm = c["x"], c["B"]
    b, t, h, p = x.shape
    n = bm.shape[-1]
    el = x.element_size()
    state = b * h * p * n * 4
    nbytes = (3 * x.numel() * el + 4 * bm.numel() * el + 2 * c["dt"].numel() * 4
              + 2 * c["A"].numel() * 4 + state * (3 if full else 1))
    macs = sum(l * (l + 1) // 2 * (3 * n + 2 * p) + 6 * l * p * n
               for l in (min(c["chunk"], t - c0)
                         for c0 in range(0, t, c["chunk"])))
    t_ops = 2 * macs * b * h / PEAK_OPS[str(x.dtype).split(".")[1]]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops
                                      else "operations")


def phase_ssd_grad_timing(torch, args, dev="cuda"):
    """Phase 12 (b): forward and backward at mamba2-130m's training shape
    (b 4, t 1024, h 24, P 64, N 128, chunk 64), bf16 and fp32, by device
    time from a CUDA graph over rotating input sets (eager beside), beside
    the bound and the plain versions' eager times, and the backward's f32
    workspace a call. No single PyTorch call computes this scan or its
    gradient: library none."""
    from repro_torch.kernels import ssd
    gen = torch.Generator(device=dev).manual_seed(args.seed + 31)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        sets = []
        while not sets or sum(s[0]["x"].numel() * s[0]["x"].element_size()
                              for s in sets) * 2 < COLD_BYTES:
            sets.append(_ssd_grad_inputs(torch, gen, dev, dtype=dtype,
                                         full=False, **SSD_TRAIN))

        def fwd(s):
            return ssd.ssd_chunked(*_ssd_args(s[0]), chunk=s[0]["chunk"])

        def bwd(s):
            return ssd.ssd_chunked_bwd(*_ssd_args(s[0]), s[1], s[2],
                                       chunk=s[0]["chunk"])

        def plain_bwd(s):
            return ssd.ssd_chunked_bwd_ref(*_ssd_args(s[0]), s[1], s[2],
                                           chunk=s[0]["chunk"])

        rows = {}
        for kind, fn, plain in (
                ("fwd", fwd, lambda s: ssd.ssd_chunked_ref(
                    *_ssd_args(s[0]), chunk=s[0]["chunk"])),
                ("bwd", bwd, plain_bwd)):
            ms = graph_ms(torch, fn, sets, 20)
            eager = time_ms(torch, fn, sets, 10)
            plain_ms = time_ms(torch, plain, sets, 3)
            bnd, by = (ssd_bound_ms(sets[0][0]) if kind == "fwd"
                       else ssd_bwd_bound_ms(sets[0][0], False))
            rows[kind] = dict(ms=ms, eager_ms=eager, plain_ms=plain_ms,
                              bound_ms=bnd, bound_by=by)
            ws = ""
            if kind == "bwd":
                rows[kind]["workspace_bytes"] = 4 * ssd._bwd_workspace(
                    **SSD_TRAIN, dtype=dtype)
                ws = f"; workspace {rows[kind]['workspace_bytes']} bytes"
            log(f"[timing] ssd_chunked {kind} training shape b=4 t=1024 H=24 "
                f"P=64 N=128 chunk=64 {dtype}: kernel {ms:.4f} ms (eager "
                f"{eager:.4f}), plain {plain_ms:.4f} ms, library none, bound "
                f"{bnd:.5f} ms ({by}); device time from a CUDA graph of "
                f"{len(sets)} input sets{ws}")
        out[str(dtype).split(".")[1]] = rows
        del sets
        torch.cuda.empty_cache()
    bf = out["bfloat16"]["bwd"]
    return {"ssd_chunked_bwd": dict(
        ms=bf["ms"], plain_ms=bf["plain_ms"], library_ms=None,
        bound_ms=bf["bound_ms"], bound_by=bf["bound_by"],
        workspace_bytes=bf["workspace_bytes"],
        timings=[dict(row, label=f"{kind} {dt} training shape")
                 for dt, rows in out.items() for kind, row in rows.items()])}


def ssm_train_mamba(torch, kernels, args, dev="cuda"):
    """Phase 12 (c): mamba2-130m at full width and all 24 layers (random
    weights from --seed, f32 params and AdamW moments, bf16 activations,
    the launcher's trainer at peak lr ``TRAIN_LR``) as a
    ``full_width_cell``: 24 ssd_chunked and 24 ssd_chunked_bwd launches a
    step; before the fit ``scan_oracle`` on the B=1 step. Returns the
    launches of the fit."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import MarkovCorpus

    cfg = get_config(SSM_MODEL)
    n = SSD_TRAIN["t"]
    flags = ["--arch", SSM_MODEL, "--steps", str(args.train_steps), "--batch",
             "4", "--seq", str(n), "--seed", str(args.seed), "--lr",
             str(TRAIN_LR), "--device", dev, "--dtype", "bfloat16"]
    return full_width_cell(
        torch, kernels, args, cfg,
        MarkovCorpus(vocab_size=cfg.vocab_size, seed=0, determinism=2.0),
        flags, n, ("ssd_chunked", "ssd_chunked_bwd"), "train ssm", dev,
        extra=lambda tr, params, batch: scan_oracle(torch, tr, params, batch))


def ssm_train_tiny(torch, kernels, args, dev="cuda"):
    """Phase 12 (d): tiny-ssm and the dense hybrid in fp32, weights made on
    the CPU and moved (``init_params`` draws differ by device): one step
    through the kernels against the plain versions within 1e-4, then 3
    ``Trainer`` steps whose losses equal the CPU port's within 1e-4."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import MarkovCorpus
    from repro_torch.models import init_params
    from repro_torch.models.config import ModelConfig
    from repro_torch.training.optimizer import AdamW, cosine_schedule
    from repro_torch.training.train_loop import Trainer

    for name in ("tiny-ssm", "hybrid"):
        cfg = ModelConfig(**HYBRID) if name == "hybrid" else get_config(name)
        attn, ssm = _layers(cfg)
        corpus = MarkovCorpus(vocab_size=cfg.vocab_size, seed=0,
                              determinism=2.0)
        host = init_params(cfg, args.seed, "cpu", torch.float32)
        trs = {d: Trainer(cfg, AdamW(lr=cosine_schedule(3e-3, 2, 3)),
                          device=d) for d in ("cpu", dev)}
        tr = trs[dev]
        p0 = _tree_to(host, dev)
        batch = tr.make_batch(next(corpus.batches(4, 40, seed=1)))
        want = {"ssd_chunked": ssm, "ssd_chunked_bwd": ssm}
        if attn:
            want.update(flash_attention=attn, flash_attention_bwd=attn)
        check_step_routes(torch, kernels, f"{name} AR fp32 (B 4, T 39)",
                          lambda: tr.loss(p0, batch)[0], p0, want, dev,
                          tag="train ssm")
        hist = {}
        for d, t in trs.items():      # the Trainer updates params in place
            _, _, h = t.fit(_tree_to(host, d, copy=True), corpus.batches(
                4, 40, seed=1), 3, log_every=1, log_fn=None)
            hist[d] = [x["loss"] for x in h]
        rel = max(abs(a - b) / abs(b) for a, b in zip(hist[dev], hist["cpu"]))
        log(f"[train ssm] {name} fp32, 3 Trainer steps: losses card "
            f"{[round(x, 6) for x in hist[dev]]} CPU "
            f"{[round(x, 6) for x in hist['cpu']]}; max rel diff {rel:.3e} "
            f"(tol 1e-4)")
        if not rel <= 1e-4:
            raise SmokeFailure(f"train ssm {name}: card losses differ from "
                               f"the CPU port's ({rel})")


def phase_ssm_train(torch, kernels, args, dev="cuda"):
    """Phase 12: Mamba2 training on the card. (a) the SSD backward kernel
    against its plain versions, (b) its times at the training shape, (c)
    mamba2-130m AR training at full width and depth, (d) tiny-ssm and the
    dense hybrid in fp32 against the plain versions and the CPU port, (e)
    a PARD Trainer on tiny-ssm refused. Returns (max abs error, timing
    row, launches of (c))."""
    from repro_torch.configs import get_config
    from repro_torch.training.optimizer import AdamW
    from repro_torch.training.train_loop import Trainer

    err = phase_ssd_grad(torch, kernels, args, dev)
    timing = phase_ssd_grad_timing(torch, args, dev)
    launches = ssm_train_mamba(torch, kernels, args, dev)
    ssm_train_tiny(torch, kernels, args, dev)
    try:
        Trainer(get_config("tiny-ssm"), AdamW(), loss_kind="pard", device=dev)
    except ValueError as e:
        log(f"[train ssm] PARD Trainer on tiny-ssm refused: {e}")
    else:
        raise SmokeFailure("a PARD Trainer on tiny-ssm was not refused")
    return err, timing, launches


# ---------------------------------------------------------------------------
# trees with Mamba2 / hybrid drafts, and the dense families at full width
# ---------------------------------------------------------------------------

TREE_SSM_NEW = 16                    # phase 13: new tokens of each request
TREE_SSM_T = 0.8                     # phase 13's sampled runs
DENSE_FAMILIES = ("deepseek-67b", "command-r-35b", "gemma2-27b")
DENSE_LAYERS = 4                     # of 95 / 40 / 46: one card, the limit
DENSE_LONG = {"deepseek-67b": 2048, "command-r-35b": 2048,
              "gemma2-27b": 4352}    # (a)'s sequence: gemma2's passes 4096
DENSE_TAIL = [1] * 8 + [8]           # decode windows after the prefill
DENSE_NEW = 32                       # (c): new tokens of each request
PAGED_ROWS, CONTIG_ROWS = 32, 255    # prefill window rows, paged / contiguous
# (a) and (b): max |logits - reference| / max(1, max |reference|). The
# routes sum in other orders (fp32) and round the activations to bf16 at
# other points in each layer (bf16); the largest readings on an H100 were
# 1.6e-5 and 2.9e-2 (gemma2), 1/6 and 1/2 of these bounds
DENSE_TOL = {"float32": 1e-4, "bfloat16": 6.25e-2}


def phase_tree_ssm_draft(torch, kernels, args, dev="cuda"):
    """tiny-target (fp32) with a tiny-ssm and a dense-hybrid draft under
    the static tree (2,2,1,1) and the adaptive bank, paged and contiguous,
    greedy and at T = 0.8: 4 requests of 16 new tokens. Card tokens equal
    the CPU port's, greedy tokens equal AR's, and each run launches
    ssd_chunked exactly (draft Mamba2 layers x 2 scans a step x steps).
    Returns the launches of every card run by kernel."""
    from collections import Counter

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import init_params
    from repro_torch.models.config import ModelConfig
    from repro_torch.serving.engine import Engine, EngineConfig

    tc = get_config("tiny-target")
    tp_cpu = init_params(tc, args.seed, "cpu", torch.float32)
    tp = _tree_to(tp_cpu, dev)
    rng = np.random.default_rng(args.seed + 41)
    prompts = [rng.integers(0, tc.vocab_size, size=int(n))
               for n in rng.integers(4, 40, size=4)]
    base = dict(max_batch=4, max_len=256, kv_block_size=16, kv_dtype="fp32",
                seed=5)
    ar, got, _ = serve(torch, kernels, Engine,
                       EngineConfig(mode="ar", **base), tp, tc, None, None,
                       prompts, TREE_SSM_NEW, "tree-ssm: tiny-target ar", dev)
    total = Counter(got)
    trees = {"(2,2,1,1)": dict(tree=(2, 2, 1, 1)),
             "adaptive": dict(adaptive_tree=True, k=4)}
    for dname in ("tiny-ssm", "hybrid"):
        dc = ModelConfig(**HYBRID) if dname == "hybrid" else get_config(dname)
        dp_cpu = init_params(dc, args.seed + 1, "cpu", torch.float32)
        dp = _tree_to(dp_cpu, dev)
        ds = _layers(dc)[1]
        for tree, tkw in trees.items():
            for layout in ("paged", "contiguous"):
                for temp in (0.0, TREE_SSM_T):
                    cfg = EngineConfig(kv_layout=layout, temperature=temp,
                                       **tkw, **base)
                    label = f"tree-ssm: {dname} draft, {tree} {layout} T={temp}"
                    card, got, info = serve(torch, kernels, Engine, cfg, tp,
                                            tc, dp, dc, prompts, TREE_SSM_NEW,
                                            label, dev)
                    total.update(got)
                    cpu, _, _ = serve(torch, kernels, Engine, cfg, tp_cpu, tc,
                                      dp_cpu, dc, prompts, TREE_SSM_NEW,
                                      label + " (CPU)", "cpu")
                    steps = info["stats"]["steps"]
                    want = ds * 2 * steps
                    checks = {
                        "== CPU port": all(np.array_equal(card[r], cpu[r])
                                           for r in card),
                        f"ssd_chunked launches {got.get('ssd_chunked')} == "
                        f"{ds} Mamba2 layers x 2 scans x {steps} steps":
                            got.get("ssd_chunked") == want}
                    if temp == 0.0:
                        checks["== AR"] = all(np.array_equal(card[r], ar[r])
                                              for r in card)
                    log(f"[{label}] " + "; ".join(
                        f"{k}: {v}" for k, v in checks.items())
                        + f"; mean_accepted={info['mean_accepted']:.3f}")
                    for k, v in checks.items():
                        if not v:
                            raise SmokeFailure(f"{label}: {k} fails")
    return dict(total)


def _max_err(got, want):
    """(max |got - want|, max |want|)."""
    return ((got.float() - want.float()).abs().max().item(),
            want.float().abs().max().item())


def dense_cached(torch, kernels, params, cfg, toks, layout, dtype, ref, dev,
                 rows=None, before=None):
    """A cached forward of ``toks`` [1, T] in windows: the first T - 16
    tokens in prefill windows of ``rows`` rows (default ``PAGED_ROWS``
    paged, block 64, or ``CONTIG_ROWS`` contiguous), then ``DENSE_TAIL``'s
    decode windows, through the kernels and, on caches of their own,
    through the plain versions; ``before(pos, w)``, if given, runs before
    each window. Returns ((a) the kernels' error against the cache-free
    logits ``ref``, (b) the kernels' error against the plain versions,
    the largest |logit|, the share of positions whose argmax agrees with
    ``ref``'s, the kernels' launches, windows)."""
    from repro_torch.models import forward, init_caches
    from repro_torch.serving import kv_pool
    t = toks.shape[1]
    rows = rows or (PAGED_ROWS if layout == "paged" else CONTIG_ROWS)
    head = t - sum(DENSE_TAIL)
    widths = [min(rows, head - i) for i in range(0, head, rows)] + DENSE_TAIL
    kw = dict(dtype=dtype)
    caches = []
    for _ in range(2):
        if layout == "paged":
            nb = -(-t // 64) + 1           # block 0 is the garbage block
            caches.append(kv_pool.init_paged_caches(cfg, 1, nb, 64, dtype,
                                                    dev))
            kw.update(block_tables=torch.arange(
                1, nb, dtype=torch.int32, device=dev)[None],
                kv_block_size=64)
        else:
            caches.append(init_caches(cfg, 1, t, dtype, dev))
    v = cfg.vocab_size
    err_a = err_b = scale = 0.0
    agree = 0
    launches = {}
    pos = 0
    for w in widths:
        window = toks[:, pos:pos + w]
        cpos = torch.full((1,), pos, dtype=torch.long, device=dev)
        if before is not None:
            before(pos, w)
        kernels.launches.clear()
        lg, _ = forward(params, cfg, window, caches=caches[0], cache_pos=cpos,
                        **kw)
        for name, n in kernels.launches.items():
            launches[name] = launches.get(name, 0) + n
        with _plain_routes():
            lp, _ = forward(params, cfg, window, caches=caches[1],
                            cache_pos=cpos, **kw)
        want = ref[:, pos:pos + w, :v]
        ea, m = _max_err(lg[..., :v], want)
        eb, _ = _max_err(lg[..., :v], lp[..., :v])
        err_a, err_b, scale = max(err_a, ea), max(err_b, eb), max(scale, m)
        agree += int((lg[..., :v].argmax(-1) == want.argmax(-1)).sum())
        pos += w
    return err_a, err_b, scale, agree / t, launches, len(widths)


def dense_family(torch, kernels, args, name, card, dev="cuda"):
    """One family of phase 14 at full width and ``DENSE_LAYERS`` layers,
    its 1-layer draft beside: (a) and (b) in fp32 and bf16, (c) the
    engine. Returns the card's launches by kernel."""
    import dataclasses
    from collections import Counter

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.interop import cast_params
    from repro_torch.models import forward, init_params
    from repro_torch.models.config import ATTN_LOCAL, layer_plan
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.training.optimizer import leaves

    full = get_config(name)
    cfg = dataclasses.replace(full, num_layers=DENSE_LAYERS)
    dcfg = dataclasses.replace(full, num_layers=1, name=full.name + "-1l")
    plan = [s.mixer for s in layer_plan(cfg)]
    total = Counter()
    t0 = time.perf_counter()
    tp = init_params(cfg, args.seed, dev, torch.float32)
    dp = init_params(dcfg, args.seed + 1, dev, torch.float32)
    _sync(dev)
    n_t, n_d = (sum(x.numel() for x in leaves(p)) for p in (tp, dp))
    log(f"[dense {name}] depth cut {full.num_layers} -> {DENSE_LAYERS} "
        f"layers ({plan.count(ATTN_LOCAL)} local, "
        f"{DENSE_LAYERS - plan.count(ATTN_LOCAL)} global; window "
        f"{cfg.sliding_window}, attention softcap {cfg.attn_softcap}, final "
        f"softcap {cfg.final_softcap}, scale {cfg.attn_scale or 'hd^-0.5'}, "
        f"layernorm {cfg.use_layernorm}, parallel {cfg.parallel_block}, "
        f"sandwich norms {cfg.post_block_norms}), d {cfg.d_model}, heads "
        f"{cfg.n_heads}/{cfg.n_kv_heads} (G {cfg.n_heads // cfg.n_kv_heads}), "
        f"vocab {cfg.vocab_size}; draft: the same at 1 layer; "
        f"{n_t / 1e9:.2f}B + {n_d / 1e9:.2f}B random params from --seed, "
        f"made on the card in {time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(args.seed + 53)
    t = DENSE_LONG[name]
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, t))).to(dev)
    prompts = [rng.integers(0, cfg.vocab_size, size=args.prompt_len)
               for _ in range(4)]
    fp32_tokens = {}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        if dt == torch.bfloat16:
            tp, dp = cast_params(tp, dt), cast_params(dp, dt)
            torch.cuda.empty_cache()
        # (a) and (b): one cache-free forward (flash_attention) as the
        # reference, then the cached windows on both layouts
        kernels.launches.clear()
        ref, _ = forward(tp, cfg, toks, dtype=dt)
        free = dict(kernels.launches)
        total.update(free)
        if free != {"flash_attention": DENSE_LAYERS}:
            raise SmokeFailure(f"{name}: cache-free launches {free}")
        for layout in ("paged", "contiguous"):
            t1 = time.perf_counter()
            ea, eb, scale, agree, got, nw = dense_cached(
                torch, kernels, tp, cfg, toks, layout, dt, ref, dev)
            total.update(got)
            kname = ("decode_attention_paged" if layout == "paged"
                     else "decode_attention")
            tol = DENSE_TOL[dname] * max(1.0, scale)
            log(f"[dense {name}] {dname} {layout}, {t} tokens in {nw} "
                f"windows ({time.perf_counter() - t1:.1f}s): (a) cached vs "
                f"cache-free max_abs_err={ea:.3e}, (b) kernels vs plain "
                f"max_abs_err={eb:.3e}, tol={tol:.3e} (max |logit| "
                f"{scale:.2f}); argmax agreement {agree:.4f}; launches "
                f"{got}")
            if got != {kname: DENSE_LAYERS * nw}:
                raise SmokeFailure(f"{name} {layout}: launches {got}, "
                                   f"expected {DENSE_LAYERS * nw} {kname}")
            if not (ea <= tol and eb <= tol):
                raise SmokeFailure(f"{name} {dname} {layout}: cached logits "
                                   f"off by {ea} / {eb} > {tol}")
        del ref
        torch.cuda.empty_cache()
        # (c): the engine, K = 8, paged KV in the params' dtype
        kv = "fp32" if dt == torch.float32 else "bf16"
        runs = [("pard", EngineConfig(kv_dtype=kv, mode="pard", k=8))]
        if dt == torch.float32:
            runs.append(("ar", EngineConfig(kv_dtype=kv, mode="ar")))
        else:                                   # warm before the timed run
            warm = Engine(tp, cfg, dp, dcfg, config=runs[0][1], device=dev)
            warm.submit(prompts[0][:32], 8)
            warm.run()
            del warm
        for mode, c in runs:
            d_p, d_c = (None, None) if mode == "ar" else (dp, dcfg)
            out, got, info = serve(torch, kernels, Engine, c, tp, cfg, d_p,
                                   d_c, prompts, DENSE_NEW,
                                   f"dense {name} {mode} {dname}", dev)
            total.update(got)
            log(f"[dense {name}] engine {mode} {dname} (K 8, paged {kv} KV, "
                f"4 requests of {DENSE_NEW}): {info['tok_s']:.1f} tok/s, "
                f"mean accepted {info['mean_accepted']:.3f} on {card}")
            if dt == torch.float32:
                fp32_tokens[mode] = out
        torch.cuda.empty_cache()
    same = all(np.array_equal(fp32_tokens["pard"][r], fp32_tokens["ar"][r])
               for r in fp32_tokens["ar"])
    log(f"[dense {name}] fp32 PARD tokens == AR tokens: {same}")
    if not same:
        raise SmokeFailure(f"{name}: fp32 PARD tokens differ from AR")
    del tp, dp
    torch.cuda.empty_cache()
    return total


def phase_dense(torch, kernels, args, dev="cuda"):
    """deepseek-67b, command-r-35b and gemma2-27b at full width and
    ``DENSE_LAYERS`` layers (random weights made on the card): (a) cached
    logits (paged windows of 32 rows and contiguous windows of 255, then
    one-row and 8-row decode windows) against one cache-free forward
    through flash_attention, gemma2 over 4352 > 4096 tokens so its local
    layers' window and softcap bite; (b) the same cached windows through
    the plain versions; (c) an Engine in mode pard, K = 8, paged KV, 4
    requests of 32 new tokens with a 1-layer draft of the family: bf16
    tok/s and mean accepted, fp32 PARD tokens equal to AR's. Returns the
    launches by kernel and family."""
    card = card_line()
    out = {}
    for name in DENSE_FAMILIES:
        t0 = time.perf_counter()
        out[name] = dense_family(torch, kernels, args, name, card, dev)
        log(f"[phase time] dense {name}: {time.perf_counter() - t0:.1f}s")
    return out


# ---------------------------------------------------------------------------
# phase 15: MoE layers (granite-moe-3b-a800m, the jamba hybrid)
# ---------------------------------------------------------------------------

MOE_MODEL = "granite-moe-3b-a800m"   # 40 experts top 8, all 32 layers
MOE_HYBRID = "jamba-1.5-large-398b"  # Mamba2 + attention + MoE
MOE_HYBRID_LAYERS = 2                # of 72: attn_every 2 keeps both kinds
MOE_LONG = 1023                      # (a): odd and past the 256-token
#                                      group, so groups of one: no drops
MOE_ROWS = {"paged": 32, "contiguous": 63}   # cached windows <= 64 rows:
#                                      dropless routing
MOE_NEW = 32                         # (c): new tokens of each request
MOE_FLIPS_FP32 = 1e-3                # (a): most own choices that may
#                                      differ from the recorded ones in fp32
MOE_TRAIN = dict(n=513, steps=3)     # (e): B 4, so 2048 routed tokens:
#                                      groups of 256, 64 slots an expert


@contextlib.contextmanager
def moe_routing(torch, book, n_moe, tol):
    """Inside the block ``models.layers.moe_route`` records or replays the
    MoE layers' expert choices. With ``book["idx"]`` None it records: each
    call's top-k experts [n, k] and its router logits [n, e] (float32) are
    appended to ``book["record"]``. Else call c takes the recorded experts
    of MoE layer c % ``n_moe`` at rows ``book["rows"]`` (its gates
    renormalized from its own probabilities, as moe_apply does). Two routes
    whose activations differ by rounding pick different experts where two
    router logits are within that rounding (bf16 router logits tie often);
    replaying one route's choices holds the attention kernels to their
    rounding alone. The route's own choices are held all the same: its
    router logits to the recorded ones within ``tol`` x max(1, the row's
    largest |logit|) (the bar of the output logits, ``DENSE_TOL``), and
    each (token, layer) whose own top-k set differs from the recorded one
    (a flip) to a near-tie: the recorded logits of an expert it dropped
    and of one it took are at most twice that bar apart. On the device,
    for one read at the end: ``book["flips"]`` and ``book["decisions"]``,
    ``book["over"]`` the (token, layer)s past either bar, the largest gap
    at a flip in logits (``book["gap"]``) and over the dtype's ulp at
    the larger of the two logits (``book["gap_ulps"]``), and the largest
    own-versus-recorded logit difference over its bar
    (``book["dlogit"]``)."""
    from repro_torch.models import layers
    real = layers.moe_route

    def route(params, x, cfg):
        probs, idx, gates = real(params, x, cfg)
        logits = (x @ params["router"].to(x.dtype)).float()
        if book["idx"] is None:
            book["record"].append((idx, logits))
            return probs, idx, gates
        want, ref = (r[book["rows"]] for r in
                     book["record"][book["calls"] % n_moe])
        book["calls"] += 1
        bar = tol * ref.abs().amax(-1).clamp(min=1.0)
        dl = (logits - ref).abs().amax(-1) / bar
        mine = torch.zeros_like(ref, dtype=torch.bool).scatter_(1, idx, True)
        theirs = torch.zeros_like(mine).scatter_(1, want, True)
        flip = (mine != theirs).any(-1)
        # the route ranks every expert it took above every one it dropped:
        # the widest such pair's recorded gap, and the ulp in x's dtype of
        # the larger of its two logits
        dropped = torch.where(theirs & ~mine, ref, -float("inf")).amax(-1)
        taken = torch.where(mine & ~theirs, ref, float("inf")).amin(-1)
        gap = torch.where(flip, dropped - taken, 0.0)
        ulp = torch.finfo(x.dtype).eps * torch.exp2(torch.floor(torch.log2(
            torch.maximum(dropped.abs(), taken.abs()).clamp(min=1e-30))))
        gap_ulps = torch.where(flip, gap / ulp, 0.0)
        book["flips"] += flip.sum()
        book["over"] += ((gap > 2 * bar) | (dl > 1)).sum()
        book["decisions"] += want.shape[0]
        book["gap"] = torch.maximum(book["gap"], gap.amax())
        book["gap_ulps"] = torch.maximum(book["gap_ulps"], gap_ulps.amax())
        book["dlogit"] = torch.maximum(book["dlogit"], dl.amax())
        g = probs.gather(1, want)
        return probs, want, g / (g.sum(-1, keepdim=True) + 1e-9)

    layers.moe_route = route
    try:
        yield book
    finally:
        layers.moe_route = real


def moe_family(torch, kernels, args, name, card, dev="cuda"):
    """(a)-(c) of phase 15 for one family: its config at full width
    (granite at all 32 layers, jamba cut to ``MOE_HYBRID_LAYERS``) and a
    1-layer draft of the same family, random weights from --seed made on
    the card, fp32 then bf16. Returns the card's launches by kernel."""
    import dataclasses
    from collections import Counter

    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.models import forward, init_params
    from repro_torch.models.config import MLP_MOE, SSM, layer_plan
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.training.optimizer import leaves

    full = get_config(name)
    cfg = full if name == MOE_MODEL else dataclasses.replace(
        full, num_layers=MOE_HYBRID_LAYERS, attn_every=2)
    dcfg = dataclasses.replace(cfg, num_layers=1, name=full.name + "-1l")
    plan = layer_plan(cfg)
    n_moe = sum(sp.mlp == MLP_MOE for sp in plan)
    n_ssm = sum(sp.mixer == SSM for sp in plan)
    n_attn = cfg.num_layers - n_ssm
    total = Counter()
    t0 = time.perf_counter()
    tp = init_params(cfg, args.seed, dev, torch.float32)
    dp = init_params(dcfg, args.seed + 1, dev, torch.float32)
    _sync(dev)
    n_t, n_d = (sum(x.numel() for x in leaves(p)) for p in (tp, dp))
    log(f"[moe {name}] {cfg.num_layers} of {full.num_layers} layers "
        f"({n_attn} attention, {n_ssm} Mamba2; {n_moe} MoE: "
        f"{cfg.moe_num_experts} experts top {cfg.moe_top_k}, expert d_ff "
        f"{cfg.moe_d_ff}), d {cfg.d_model}, heads {cfg.n_heads}/"
        f"{cfg.n_kv_heads} (G {cfg.n_heads // cfg.n_kv_heads}, head dim "
        f"{cfg.resolved_head_dim}), rope {cfg.use_rope}, vocab "
        f"{cfg.vocab_size}; draft: the same at 1 layer; {n_t / 1e9:.2f}B + "
        f"{n_d / 1e9:.2f}B random params from --seed, made on the card in "
        f"{time.perf_counter() - t0:.1f}s")
    rng = np.random.default_rng(args.seed + 59)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (1, MOE_LONG))).to(dev)
    prompts = [rng.integers(0, cfg.vocab_size, size=args.prompt_len)
               for _ in range(4)]
    free_want = {"flash_attention": n_attn, "ssd_chunked": n_ssm}
    fp32_tokens = {}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        if dt == torch.bfloat16:        # jamba's fp32 pair takes 56 GB
            del tp, dp
            gc.collect()
            torch.cuda.empty_cache()
            tp = init_params(cfg, args.seed, dev, dt)
            dp = init_params(dcfg, args.seed + 1, dev, dt)
        # (a) and (b): one cache-free forward as the reference (its
        # routing recorded), then the cached windows on both layouts with
        # that routing replayed
        book = dict(idx=None, record=[])
        kernels.launches.clear()
        with moe_routing(torch, book, n_moe, DENSE_TOL[dname]):
            ref, _ = forward(tp, cfg, toks, dtype=dt)
        free = dict(kernels.launches)
        total.update(free)
        if free != {k: v for k, v in free_want.items() if v}:
            raise SmokeFailure(f"{name}: cache-free launches {free}")
        for layout in ("paged", "contiguous"):
            t1 = time.perf_counter()
            book.update(idx=book["record"], rows=slice(0), calls=0,
                        decisions=0, **{k: torch.zeros((), device=dev) for k
                                        in ("flips", "over", "gap",
                                            "gap_ulps", "dlogit")})
            with moe_routing(torch, book, n_moe, DENSE_TOL[dname]):
                ea, eb, scale, agree, got, nw = dense_cached(
                    torch, kernels, tp, cfg, toks, layout, dt, ref, dev,
                    rows=MOE_ROWS[layout],
                    before=lambda pos, w: book.update(
                        rows=slice(pos, pos + w)))
            total.update(got)
            flips, over = int(book["flips"]), int(book["over"])
            kname = ("decode_attention_paged" if layout == "paged"
                     else "decode_attention")
            want = {kname: n_attn * nw, "ssd_chunked": n_ssm * nw}
            want = {k: v for k, v in want.items() if v}
            tol = DENSE_TOL[dname] * max(1.0, scale)
            log(f"[moe {name}] {dname} {layout}, {MOE_LONG} tokens in {nw} "
                f"windows of <= {MOE_ROWS[layout]} rows (dropless; "
                f"{time.perf_counter() - t1:.1f}s): (a) cached vs "
                f"cache-free max_abs_err={ea:.3e}, (b) kernels vs plain "
                f"max_abs_err={eb:.3e}, tol={tol:.3e} (max |logit| "
                f"{scale:.2f}), routing of the cache-free forward replayed; "
                f"own top-k differing from it in {flips} of "
                f"{book['decisions']} (token, MoE layer) decisions, the "
                f"widest recorded gap at a flip {float(book['gap']):.3e} "
                f"({float(book['gap_ulps']):.1f} ulp of {dname}), own router "
                f"logits off by at most {float(book['dlogit']):.3f} x their "
                f"bar, {over} past a bar; argmax agreement {agree:.4f}; "
                f"launches {got}")
            if got != want:
                raise SmokeFailure(f"{name} {layout}: launches {got}, "
                                   f"expected {want}")
            if not (ea <= tol and eb <= tol):
                raise SmokeFailure(f"{name} {dname} {layout}: cached logits "
                                   f"off by {ea} / {eb} > {tol}")
            if over or (dt == torch.float32
                        and flips > MOE_FLIPS_FP32 * book["decisions"]):
                raise SmokeFailure(f"{name} {dname} {layout}: routing off "
                                   f"the recorded one: {flips} flips of "
                                   f"{book['decisions']}, {over} past a bar")
        del ref, book
        torch.cuda.empty_cache()
        # (c): the engine, K = 8, paged KV in the params' dtype
        kv = "fp32" if dt == torch.float32 else "bf16"
        pard = EngineConfig(kv_dtype=kv, mode="pard", k=8)
        runs = [("pard", pard, False)]
        if dt == torch.float32:
            runs.append(("ar", EngineConfig(kv_dtype=kv, mode="ar"), False))
            if n_ssm == 0:          # an SSM target serves flat only
                runs.append(("adaptive tree", EngineConfig(
                    kv_dtype=kv, mode="pard", k=8, adaptive_tree=True),
                    False))
        else:                                   # warm before the timed run
            warm = Engine(tp, cfg, dp, dcfg, config=pard, device=dev)
            warm.submit(prompts[0][:32], 8)
            warm.run()
            del warm
            if n_ssm == 0:
                runs.append(("pard pipelined", pard, True))
        out = {}
        for mode, c, pipelined in runs:
            out[mode], got, info = serve(
                torch, kernels, Engine, c, tp, cfg, dp, dcfg, prompts,
                MOE_NEW, f"moe {name} {mode} {dname}", dev,
                pipelined=pipelined)
            total.update(got)
            lat = info["lat"]
            log(f"[moe {name}] engine {mode} {dname} (K 8, paged {kv} KV, "
                f"4 requests of {args.prompt_len} + {MOE_NEW}): "
                f"{info['tok_s']:.1f} tok/s, step p50 "
                f"{lat['step_p50_ms']:.2f} ms, mean accepted "
                f"{info['mean_accepted']:.3f} on {card}")
        if dt == torch.float32:
            fp32_tokens = out
        elif "pard pipelined" in out:
            same = all(np.array_equal(out["pard pipelined"][r],
                                      out["pard"][r]) for r in out["pard"])
            log(f"[moe {name}] bf16 pipelined (host side under the sync "
                f"guard) tokens == sync tokens: {same}")
            if not same:
                raise SmokeFailure(f"{name}: pipelined tokens differ")
        torch.cuda.empty_cache()
    for mode in set(fp32_tokens) - {"ar"}:
        same = all(np.array_equal(fp32_tokens[mode][r], fp32_tokens["ar"][r])
                   for r in fp32_tokens["ar"])
        log(f"[moe {name}] fp32 {mode} tokens == AR tokens: {same}")
        if not same:
            raise SmokeFailure(f"{name}: fp32 {mode} tokens differ from AR")
    del tp, dp
    torch.cuda.empty_cache()
    return total


def phase_moe(torch, kernels, args, dev="cuda"):
    """MoE layers on the card: (a)-(c) of ``moe_family`` for
    granite-moe-3b-a800m (full width, 32 layers) and for the jamba hybrid
    (full width, 2 layers), then (e) granite AR training at full width and
    depth through ``full_width_cell`` (B 4, N 513: capacity routing runs;
    3 steps, each layer recomputed in the backward pass, which the card's
    memory needs; a finite loss, the aux term in it: from random weights
    it rose over 3 steps at peak lr 1e-3 and at 3e-4). Returns the
    launches by kernel."""
    import argparse as ap
    from collections import Counter

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import MarkovCorpus

    card = card_line()
    total = Counter()
    for name in (MOE_MODEL, MOE_HYBRID):
        # jamba's fp32 pair takes 56 GB: nothing of an earlier phase may
        # wait on the card for the cyclic garbage collector
        gc.collect()
        if dev == "cuda":
            torch.cuda.empty_cache()
            log(f"[moe] {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
                f"allocated before {name}")
        t0 = time.perf_counter()
        total.update(moe_family(torch, kernels, args, name, card, dev))
        log(f"[phase time] moe {name}: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    cfg = get_config(MOE_MODEL)
    corpus = MarkovCorpus(vocab_size=cfg.vocab_size, seed=0, determinism=2.0)
    n, steps = MOE_TRAIN["n"], MOE_TRAIN["steps"]
    flags = ["--arch", MOE_MODEL, "--steps", str(steps), "--batch", "4",
             "--seq", str(n), "--seed", str(args.seed), "--lr",
             str(TRAIN_LR), "--device", dev, "--dtype", "bfloat16"]
    total.update(full_width_cell(
        torch, kernels, ap.Namespace(**{**vars(args), "train_steps": steps}),
        cfg, corpus, flags, n, TRAIN_KERNELS["flash"], "train moe", dev,
        remat=True, falling=False))
    log(f"[phase time] moe training: {time.perf_counter() - t0:.1f}s")
    return dict(total)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=64)
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
    def timed(fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        log(f"[phase time] {fn.__name__}: {time.perf_counter() - t0:.1f}s")
        return out

    try:
        timed(phase_build, build)
        errs = timed(phase_correctness, torch, args)
        for name, err in timed(phase_split_kv, torch, args).items():
            errs[name] = max(errs.get(name, 0.0), err)
        errs.update(timed(phase_ssd_correctness, torch, args))
        timing = timed(phase_timing, torch, F, args)
        timing.update(timed(phase_ssd_timing, torch, args))
        timed(phase_reference, torch, args)
        timed(phase_reference_ssm, torch, args)
        timed(phase_reference_sampled, torch, args)
        timed(phase_reference_loop, torch, args)
        launches = timed(phase_engine, torch, kernels, args)
        launches.update(timed(phase_ssm_engine, torch, kernels, args))
        err, gen_launches = timed(phase_generate, torch, kernels, args)
        errs["decode_attention"] = max(errs["decode_attention"], err)
        errs.update(timed(phase_train_correctness, torch, args))
        timing.update(timed(phase_train_timing, torch, F, args))
        launches.update(timed(phase_train, torch, kernels, args))
        trained = timed(phase_trained, torch, kernels, args)
        err, ssd_grad_timing, ssm_launches = timed(phase_ssm_train, torch,
                                                   kernels, args)
        errs["ssd_chunked_bwd"] = err
        timing.update(ssd_grad_timing)
        launches["ssd_chunked_bwd"] = ssm_launches["ssd_chunked_bwd"]
        for name in ("ssd_chunked", "ssd_chunked_bwd"):
            timing[name]["train_launches"] = ssm_launches[name]
        tree_ssm = timed(phase_tree_ssm_draft, torch, kernels, args)
        dense = timed(phase_dense, torch, kernels, args)
        moe = timed(phase_moe, torch, kernels, args)
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
    # the uniform-batch runs of phase 10: each kernel's launches per run
    for name in KERNELS:
        timing[name]["generate_launches"] = {
            label: got[name] for label, got in gen_launches.items()
            if got.get(name)}
        # phase 11's runs on trained weights
        timing[name]["trained_launches"] = {
            label: got[name] for label, got in trained.items()
            if got.get(name)}
        # phase 13's tree runs with Mamba2 / hybrid drafts, phase 14's
        # dense families
        timing[name]["tree_ssm_launches"] = tree_ssm.get(name, 0)
        timing[name]["dense_launches"] = {
            fam: got[name] for fam, got in dense.items() if got.get(name)}
        # phase 15's MoE runs (granite, jamba, granite training)
        timing[name]["moe_launches"] = moe.get(name, 0)
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
