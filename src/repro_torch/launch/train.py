"""Training launcher of the port: AR pretraining or PARD adaptation on the
synthetic Markov corpus, from random seeded weights or a checkpoint.

  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
      --steps 100 --batch 4 --seq 512 [--pard] [--init ckpt.npz]

Runs on the CUDA card; ``--device cpu`` runs the plain PyTorch path (use
the tiny-* configs there). The flags are the JAX launcher's
(``repro.launch.train``), plus ``--device``; checkpoints (``--init``,
``--out``) are in its format, so either package reads the other's.
Params are float32; the activations float32, as the JAX Trainer's
default is, unless ``--dtype bfloat16`` (a flag of the port's: the
attention kernels then run in bf16). Only one device: ``--model-parallel``
above 1 raises.
"""
from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--pard", action="store_true",
                    help="PARD adaptation objective instead of AR")
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--r", type=float, default=0.7)
    ap.add_argument("--r-min", type=float, default=0.2)
    ap.add_argument("--init", default=None, help="checkpoint to start from")
    ap.add_argument("--out", default=None, help="checkpoint output path")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' runs the plain path")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="activation dtype (params and moments stay float32)")
    return ap


def make_trainer(args, cfg, device):
    """The JAX launcher's optimizer, schedule and COD settings, at the
    activation dtype of ``--dtype``."""
    import torch

    from repro_torch.core.cod import CodConfig
    from repro_torch.training.optimizer import AdamW, cosine_schedule
    from repro_torch.training.train_loop import Trainer

    opt = AdamW(lr=cosine_schedule(args.lr, min(30, args.steps // 5 + 1),
                                   args.steps))
    cod = CodConfig(k=args.k, r=args.r, r_min=args.r_min)
    return Trainer(cfg, opt, loss_kind="pard" if args.pard else "ar", cod=cod,
                   dtype=getattr(torch, args.dtype), device=device)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.model_parallel > 1:
        raise NotImplementedError(
            "--model-parallel > 1: sharded training comes with the "
            "multi-device slice of the port")

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import MarkovCorpus
    from repro_torch.device import resolve_device
    from repro_torch.models import init_params
    from repro_torch.training import checkpoint

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    params = init_params(cfg, args.seed, device, torch.float32)
    if args.init:
        params = checkpoint.restore(args.init, params)

    corpus = MarkovCorpus(vocab_size=cfg.vocab_size, seed=0, determinism=2.0)
    tr = make_trainer(args, cfg, device)
    params, _, hist = tr.fit(params, corpus.batches(args.batch, args.seq,
                                                    seed=args.seed),
                             args.steps, log_every=max(args.steps // 10, 1))
    if args.out:
        checkpoint.save(args.out, params,
                        metadata={"arch": args.arch, "steps": args.steps,
                                  "pard": args.pard,
                                  "final_loss": hist[-1]["loss"]})
        print("saved", args.out)
    return hist


if __name__ == "__main__":
    main()
