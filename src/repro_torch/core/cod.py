"""COnditional Drop token (COD) data processing — paper §3.2.2, Algorithm 1.

A numpy copy of ``repro.core.cod`` (the port imports nothing of the JAX
package): packing is bit-identical for the same seed, since both draw from
``np.random.default_rng``. ``check_invariants`` differs in one repair: it
bounds each subtask against the previous subtask's actual count, where
the reference uses ``(prev_cnt or n)`` and so treats a subtask that
emptied as full.

Training is decomposed into K subtasks (Fig. 4): subtask s predicts the s-th
next token from real context + (s-1) mask tokens. All subtasks pack into one
sequence; the attention pattern is *functionally determined* by two int32
per-token fields (no O(T^2) mask is ever materialised):

  segment[i] = s  (1 = real tokens / subtask 1; s>=2 = mask tokens of
                   subtask s; 0 = padding)
  base[i]    = n  (context length the token conditions on; for segment-1
                   tokens base == original position)

Allowed attention (see kernels.pard_attention.pard_mask):
  q(s, n) -> k(1, n_k)  iff n_k <  n        real context x_0..x_{n-1}
  q(s, n) -> k(j, n)    iff 2 <= j < s      earlier masks of the same chain
  q(s, n) -> k(s, n)                        self

Conditional drop: subtask s retains the bases with the ``N_s`` smallest
per-base priorities, ``N_s = round(N * max(r^{s-1}, r_min))`` (Eq. 11).
Because thresholds shrink with s, retained sets are **nested** per base —
every retained query's preceding mask chain (bases equal, smaller s) is
guaranteed present, i.e. "the preceding KV cache for attention computation is
complete" (Alg. 1 line 7) holds by construction.

Token budget check (Eq. 10): sum_s N_s ≈ N (1-r^K)/(1-r) < N/(1-r).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

IGNORE = -100


@dataclasses.dataclass(frozen=True)
class CodConfig:
    k: int = 8              # K: tokens predicted per draft forward (K_train)
    r: float = 0.7          # retention decay factor
    r_min: float = 0.2      # minimum retention rate
    drop: bool = True       # False = full mask-token training (no COD)


def subtask_sizes(n: int, cod: CodConfig) -> np.ndarray:
    """N_s for s = 1..K (Eq. 9 / Eq. 11). Subtask s has at most n - s valid
    query bases (base ranges over 1..n-s so the label index base+s-1 <= n-1)."""
    out = []
    for s in range(1, cod.k + 1):
        if s == 1:
            out.append(n)                  # all real tokens (subtask 1)
            continue
        avail = max(n - s, 0)              # bases 1..n-s have a valid label
        if not cod.drop:
            out.append(avail)
        else:
            frac = max(cod.r ** (s - 1), cod.r_min)
            out.append(min(int(round(n * frac)), avail))
    return np.asarray(out, np.int64)


def pack_sample(tokens: np.ndarray, cod: CodConfig, mask_token_id: int,
                rng: np.random.Generator, out_len: Optional[int] = None
                ) -> Dict[str, np.ndarray]:
    """Process ONE sample (1-D int array of length N) per Algorithm 1.

    Returns fixed-length (``out_len``) arrays:
      input_ids, position_ids, labels (IGNORE where no loss), segment, base.
    Layout is segment-major: [subtask-1 tokens | subtask-2 masks | ...].
    Physical order is irrelevant to correctness — attention is defined purely
    on (segment, base).
    """
    tokens = np.asarray(tokens, np.int64)
    n = len(tokens)
    sizes = subtask_sizes(n, cod)

    # nested retention: priorities per base; subtask s keeps the N_s smallest
    pri = rng.permutation(np.arange(1, n))  # bases 1..n-1, random priority
    # pri[j] is the base with priority rank j

    segs, bases, ids, poss, labs = [], [], [], [], []

    # subtask 1: the original AR sequence
    segs.append(np.ones(n, np.int32))
    bases.append(np.arange(n, dtype=np.int32))
    ids.append(tokens.astype(np.int32))
    poss.append(np.arange(n, dtype=np.int32))
    lab1 = np.concatenate([tokens[1:], [IGNORE]]).astype(np.int32)
    labs.append(lab1)

    prev = pri                        # subtask-(s-1) retained, priority order
    for s in range(2, cod.k + 1):
        n_s = sizes[s - 1]
        # nested by construction: choose from the PREVIOUS subtask's
        # retained bases (restricted to bases whose subtask-s label exists),
        # in priority order — guarantees every mask's chain is complete
        cand = prev[prev <= n - s]
        if n_s <= 0 or len(cand) == 0:
            prev = cand
            continue
        prev = cand[:min(n_s, len(cand))]
        keep = np.sort(prev)
        n_s = len(keep)
        segs.append(np.full(n_s, s, np.int32))
        bases.append(keep.astype(np.int32))
        ids.append(np.full(n_s, mask_token_id, np.int32))
        # mask m_{s-2} of chain with base n sits at position n + s - 2
        poss.append((keep + s - 2).astype(np.int32))
        labs.append(tokens[keep + s - 1].astype(np.int32))

    seg = np.concatenate(segs)
    base = np.concatenate(bases)
    inp = np.concatenate(ids)
    pos = np.concatenate(poss)
    lab = np.concatenate(labs)

    t = len(seg)
    if out_len is None:
        out_len = t
    if t > out_len:
        raise ValueError(f"packed length {t} exceeds out_len {out_len}")
    pad = out_len - t

    def padded(a, fill):
        return np.concatenate([a, np.full(pad, fill, a.dtype)])

    return {
        "input_ids": padded(inp, 0),
        "position_ids": padded(pos, 0),
        "labels": padded(lab, IGNORE),
        "segment": padded(seg, 0),
        "base": padded(base, 0),
        "n_tokens": np.int32(t),
    }


def packed_len_bound(n: int, cod: CodConfig) -> int:
    """Static upper bound on the packed length for sequence length n."""
    return int(subtask_sizes(n, cod).sum())


def pack_batch(batch_tokens: np.ndarray, cod: CodConfig, mask_token_id: int,
               seed: int = 0) -> Dict[str, np.ndarray]:
    """batch_tokens: [B, N] -> batched packed arrays [B, T_packed]."""
    b, n = batch_tokens.shape
    out_len = packed_len_bound(n, cod)
    rng = np.random.default_rng(seed)
    rows = [pack_sample(batch_tokens[i], cod, mask_token_id, rng, out_len)
            for i in range(b)]
    return {k: np.stack([r[k] for r in rows]) for k in rows[0]}


# ---------------------------------------------------------------------------
# Invariant checks (used by hypothesis property tests)
# ---------------------------------------------------------------------------

def _check(cond, *what) -> None:
    if not cond:
        raise AssertionError(*what)


def check_invariants(packed: Dict[str, np.ndarray], tokens: np.ndarray,
                     cod: CodConfig, mask_token_id: int) -> None:
    """Raise AssertionError unless ``packed`` (one ``pack_sample`` output
    for ``tokens``) keeps Algorithm 1's invariants."""
    seg, base = packed["segment"], packed["base"]
    pos, lab, inp = packed["position_ids"], packed["labels"], packed["input_ids"]
    n = len(tokens)
    live = seg > 0
    # 1. position ids consistent: pos == base + seg - 2 for masks, == base for real
    m = seg >= 2
    _check(np.all(pos[m] == base[m] + seg[m] - 2), "mask positions")
    r1 = seg == 1
    _check(np.all(pos[r1] == base[r1]), "real-token positions")
    _check(np.all(inp[m] == mask_token_id), "mask token ids")
    # 2. labels: subtask s>=2 at base n predicts tokens[n + s - 1];
    #    segment-1 token at position i (base == i) predicts tokens[i + 1]
    valid_lab = live & (lab != IGNORE)
    idx = np.where(seg[valid_lab] == 1, base[valid_lab] + 1,
                   base[valid_lab] + seg[valid_lab] - 1)
    _check(np.all(idx < n), "label index past the sequence")
    _check(np.all(lab[valid_lab] == tokens[idx]), "labels")
    # 3. KV completeness: every mask (s, n) has its full chain (j, n), 2<=j<s
    present = set(zip(seg[live].tolist(), base[live].tolist()))
    for s, b_ in zip(seg[m].tolist(), base[m].tolist()):
        for j in range(2, s):
            _check((j, b_) in present,
                   f"chain broken: ({s},{b_}) missing ({j},{b_})")
    # 4. drop accounting: per-subtask counts match Eq. 11 up to the nested-
    #    retention constraint (the retained set draws from the previous
    #    subtask's set, restricted to bases with a label, which drops at most
    #    one tail base). The bound uses the previous subtask's ACTUAL count:
    #    a subtask that emptied bounds the next one by nothing.
    sizes = subtask_sizes(n, cod)
    prev_cnt = n
    for s in range(1, cod.k + 1):
        cnt = int(np.sum(seg == s))
        _check(cnt <= sizes[s - 1], (s, cnt, sizes[s - 1]))
        if s >= 2:
            _check(cnt >= min(sizes[s - 1], prev_cnt - 1) - 1,
                   (s, cnt, sizes[s - 1], prev_cnt))
        prev_cnt = cnt
