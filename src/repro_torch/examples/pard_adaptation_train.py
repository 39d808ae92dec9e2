"""PARD adaptation pipeline of the port: trains the bench-* model family
and runs the paper's training recipe end to end, as the JAX package's
``examples/pard_adaptation_train.py`` does:

  1. AR-pretrain a target, a mid-size and a small draft model on the same
     corpus (stand-ins for e.g. llama3.1-8b and llama3.2-1b);
  2. adapt the draft into a PARD parallel draft with mask-token training
     (Eq. 8) under Conditional Drop (Alg. 1) for several (K, r, r_min)
     settings (the Fig. 6a / 6b ablations);
  3. train an EAGLE-style head on the target (the comparison baseline);
  4. checkpoint everything under ``--out`` with a ``manifest.json``.

  PYTHONPATH=src python -m repro_torch.examples.pard_adaptation_train \\
      [--quick] [--out artifacts_torch] [--device cpu]

Params, AdamW moments and activations are float32 (the JAX Trainer's
default), so the attention kernels take their fp32 routes on the card. A
run whose checkpoint exists is skipped. Checkpoints are in the format of
``repro_torch.training.checkpoint``, which the JAX package restores too.
"""
from __future__ import annotations

import argparse
import copy
import json
import time
from pathlib import Path

import torch

from ..configs import get_config
from ..core.cod import CodConfig
from ..core.eagle import eagle_loss, init_eagle
from ..data.pipeline import MarkovCorpus
from ..device import resolve_device
from ..models import init_params
from ..training import checkpoint
from ..training.optimizer import AdamW, cosine_schedule, leaves
from ..training.train_loop import Trainer, _grads

DEFAULT_OUT = Path(__file__).resolve().parents[3] / "artifacts_torch"

# the corpus stands in for the paper's code/math corpora: highly predictable
# sequential structure (high acceptance regime, like HumanEval/GSM8K)
CORPUS = dict(vocab_size=512, seed=0, determinism=3.0, branching=4)

AR_RUNS = [("bench-target", 0), ("bench-draft", 1), ("bench-mid", 2)]

# (tag, k_train, r, r_min, drop)
PARD_RUNS = [
    ("pard_k8_r07", 8, 0.7, 0.2, True),     # the paper's setting
    ("pard_k8_r05", 8, 0.5, 0.1, True),     # aggressive drop (Fig. 6a)
    ("pard_k8_nodrop", 8, 1.0, 1.0, False),  # full mask training (Fig. 6a)
    ("pard_k2_r07", 2, 0.7, 0.2, True),     # K_train sweep (Fig. 6b)
    ("pard_k4_r07", 4, 0.7, 0.2, True),
]


# the recipe's batch shapes (rows, tokens a row), stream seeds, peak
# learning rates and warm-ups, as the JAX example sets them
AR_SHAPE, AR_PEAK = (8, 48), 3e-3
COD_SHAPE, COD_STREAM, COD_PEAK = (8, 64), 91, 2.5e-3
WARMUP = 30
EAGLE_SHAPE, EAGLE_SEED, EAGLE_STREAM = (8, 48), 9, 77
EAGLE_PEAK, EAGLE_WARMUP = 2e-3, 20


def trainer(cfg, steps: int, device, cod: CodConfig | None = None,
            warmup: int = WARMUP) -> Trainer:
    """The recipe's Trainer: AdamW on a cosine schedule to AR_PEAK (COD_PEAK
    under ``cod``) after ``warmup`` steps, float32 activations; the PARD
    objective under ``cod`` when given, else AR."""
    peak = AR_PEAK if cod is None else COD_PEAK
    return Trainer(cfg, AdamW(lr=cosine_schedule(peak, warmup, steps)),
                   loss_kind="ar" if cod is None else "pard", cod=cod,
                   device=device)


def _frozen(params):
    """``params`` with autograd off again (the Trainer turns it on)."""
    for t in leaves(params):
        t.requires_grad_(False)
    return params


def train_ar(name: str, seed: int, steps: int, corpus: MarkovCorpus, device,
             *, batch: int = AR_SHAPE[0], seq: int = AR_SHAPE[1],
             warmup: int = WARMUP, log_every: int = 100, log_fn=print):
    """Stage 1: AR pretraining of config ``name`` from seeded random f32
    weights on ``corpus.batches(batch, seq, seed=seed)``. Returns (params,
    the Trainer's history, the checkpoint's metadata)."""
    t0 = time.time()
    cfg = get_config(name)
    params = init_params(cfg, seed, device, torch.float32)
    tr = trainer(cfg, steps, device, warmup=warmup)
    params, _, hist = tr.fit(params, corpus.batches(batch, seq, seed=seed),
                             steps, log_every=log_every, log_fn=log_fn)
    meta = {"loss": hist[-1]["loss"], "steps": steps,
            "wall_s": round(time.time() - t0, 1)}
    return _frozen(params), hist, meta


def adapt(base_params, k: int, r: float, r_min: float, drop: bool,
          steps: int, corpus: MarkovCorpus, device, *, cfg=None,
          batch: int = COD_SHAPE[0], seq: int = COD_SHAPE[1],
          seed: int = COD_STREAM, warmup: int = WARMUP, log_every: int = 100,
          log_fn=print):
    """Stage 2: PARD adaptation of a copy of ``base_params`` (``cfg``,
    default bench-draft) under COD (K, r, r_min, drop) on
    ``corpus.batches(batch, seq, seed=seed)``; ``base_params`` stay as they
    are (the Trainer updates in place). Returns (params, history,
    metadata)."""
    t0 = time.time()
    cfg = cfg or get_config("bench-draft")
    cod = CodConfig(k=k, r=r, r_min=r_min, drop=drop)
    tr = trainer(cfg, steps, device, cod=cod, warmup=warmup)
    params, _, hist = tr.fit(copy.deepcopy(base_params),
                             corpus.batches(batch, seq, seed=seed), steps,
                             log_every=log_every, log_fn=log_fn)
    meta = {"loss": hist[-1]["loss"],
            "token_nll": hist[-1]["token_mean_nll"],
            "train_tokens": hist[-1]["tokens"],
            "wall_s": round(time.time() - t0, 1),
            "cod": dict(k=k, r=r, r_min=r_min, drop=drop)}
    return _frozen(params), hist, meta


def train_eagle_head(target_params, cfg, steps: int, corpus: MarkovCorpus,
                     device, *, log_fn=print):
    """Stage 3: an EAGLE head (seed EAGLE_SEED) on the frozen target,
    ``eagle_loss`` (f32) through autograd and AdamW to EAGLE_PEAK after
    EAGLE_WARMUP steps, on ``corpus.batches(*EAGLE_SHAPE,
    seed=EAGLE_STREAM)``. Returns (head params, the loss of every step,
    metadata)."""
    t0 = time.time()
    ep = init_eagle(cfg, EAGLE_SEED, device, torch.float32)
    opt = AdamW(lr=cosine_schedule(EAGLE_PEAK, EAGLE_WARMUP, steps))
    state = opt.init(ep)
    stream = corpus.batches(*EAGLE_SHAPE, seed=EAGLE_STREAM)
    losses = []
    for i in range(steps):
        tokens = torch.from_numpy(next(stream)).to(device)
        for t in leaves(ep):
            t.requires_grad_(True)
            t.grad = None
        loss, _ = eagle_loss(ep, target_params, cfg, tokens)
        loss.backward()
        grads = _grads(ep)
        for t in leaves(_frozen(ep)):
            t.grad = None
        ep, state, _ = opt.update(grads, state, ep)
        losses.append(loss.detach())
        if log_fn and ((i + 1) % 200 == 0 or i == steps - 1):
            log_fn({"eagle_step": i + 1, "loss": round(float(losses[-1]), 4)})
    losses = torch.stack(losses).cpu().tolist()
    meta = {"loss": losses[-1], "wall_s": round(time.time() - t0, 1)}
    return ep, losses, meta


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="tiny step counts (smoke only)")
    ap.add_argument("--ar-steps", type=int, default=300)
    ap.add_argument("--pard-steps", type=int, default=300)
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="artifact directory (default: artifacts_torch/ at "
                         "the repository root)")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    return ap


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    if args.quick:
        args.ar_steps, args.pard_steps = 30, 20
    device = resolve_device(args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    corpus = MarkovCorpus(**CORPUS)
    manifest = {"corpus": CORPUS, "ar_steps": args.ar_steps,
                "pard_steps": args.pard_steps, "runs": {}}

    def done(name, params, meta):
        checkpoint.save(str(out / f"{name}.npz"), params, metadata=meta)
        manifest["runs"][name] = meta
        print(f"[done] {name}: {meta}")

    def skipped(name) -> bool:
        path = out / f"{name}.npz"
        if path.exists():
            print(f"[skip] {name} (exists)")
            manifest["runs"][name] = checkpoint.load_metadata(str(path))
        return path.exists()

    # ---- stage 1: AR pretraining ---------------------------------------
    for name, seed in AR_RUNS:
        if not skipped(name):
            params, _, meta = train_ar(name, seed, args.ar_steps, corpus,
                                       device)
            done(name, params, meta)

    # ---- stage 2: PARD adaptation of the draft -------------------------
    dc = get_config("bench-draft")
    base_draft = checkpoint.restore(str(out / "bench-draft.npz"),
                                    init_params(dc, 1, device, torch.float32))
    for tag, k, r, r_min, drop in PARD_RUNS:
        if not skipped(tag):
            params, _, meta = adapt(base_draft, k, r, r_min, drop,
                                    args.pard_steps, corpus, device)
            done(tag, params, meta)

    # ---- stage 3: EAGLE-style head for the comparison benchmarks --------
    if not skipped("eagle_head"):
        tc = get_config("bench-target")
        tparams = checkpoint.restore(str(out / "bench-target.npz"),
                                     init_params(tc, 0, device,
                                                 torch.float32))
        ep, _, meta = train_eagle_head(tparams, tc, args.pard_steps, corpus,
                                       device)
        done("eagle_head", ep, meta)

    with open(out / "manifest.json", "w") as f:
        json.dump(manifest, f, indent=1)
    print("all artifacts ready under", out)
    return manifest


if __name__ == "__main__":
    main()
