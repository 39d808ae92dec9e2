"""Training loops: AR pretraining and PARD adaptation (paper §3.2).

Port of ``repro.training.train_loop``. ``Trainer`` runs one eager step per
batch on ``device`` (the CUDA card unless the caller asks for another):
the loss's forward through the attention and SSD kernels, autograd's
backward through their backward kernels, then ``AdamW.update`` in place.
The AR objective adds 0.01 x the MoE layers' load-balance loss, as the
JAX Trainer's does (a model without MoE layers adds nothing). Mamba2 and
hybrid models train with the AR objective; PARD adaptation of
a model with SSM layers raises (``core.adaptation.refuse_ssm_cod``), and
so does that of a model with local attention layers on sequences longer
than its window (``refuse_windowed_cod``, at ``make_batch``). A step
draws no random numbers: COD packing takes numpy's ``default_rng(step)``,
as the JAX Trainer does. Sharded training (a ``mesh``, param or data
shardings) is not ported yet and raises.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch

from ..core.adaptation import (ar_loss, pard_adaptation_loss,
                               refuse_ssm_cod, refuse_windowed_cod)
from ..core.cod import CodConfig, pack_batch
from ..device import resolve_device
from ..models.config import ModelConfig
from .optimizer import AdamW, AdamWState, leaves


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_grads(v) for v in tree]
    return tree.grad if tree.grad is not None else torch.zeros_like(tree)


@dataclasses.dataclass
class Trainer:
    cfg: ModelConfig
    opt: AdamW
    loss_kind: str = "ar"            # "ar" | "pard"
    cod: Optional[CodConfig] = None
    remat: bool = False
    dtype: Any = torch.float32       # activation dtype; CPU tests train in fp32
    device: Any = None
    mesh: Any = None
    param_sharding: Any = None
    data_sharding: Any = None

    def __post_init__(self):
        if self.loss_kind not in ("ar", "pard"):
            raise ValueError(f"loss_kind {self.loss_kind!r}: 'ar' or 'pard'")
        if self.loss_kind == "pard":
            refuse_ssm_cod(self.cfg)
        if (self.mesh, self.param_sharding, self.data_sharding) != (None,) * 3:
            raise NotImplementedError(
                "sharded training comes with the multi-device slice of the port")
        self.device = resolve_device(self.device)

    def loss(self, params, batch):
        """(loss, metrics) of one batch from ``make_batch``."""
        if self.loss_kind == "ar":
            return ar_loss(params, self.cfg, batch["tokens"], dtype=self.dtype,
                           aux_weight=0.01, remat=self.remat)
        cod = self.cod or CodConfig()
        return pard_adaptation_loss(params, self.cfg, batch, k_max=cod.k,
                                    dtype=self.dtype, remat=self.remat)

    def init_state(self, params) -> AdamWState:
        return self.opt.init(params)

    def make_batch(self, tokens: np.ndarray, seed: int = 0
                   ) -> Dict[str, torch.Tensor]:
        """Raw tokens [B, N] -> the step's tensors on ``device``: the tokens
        (AR) or the packed COD arrays of ``pack_batch(tokens, seed=seed)``."""
        if self.loss_kind == "ar":
            return {"tokens": torch.from_numpy(np.asarray(tokens)).to(
                self.device)}
        refuse_windowed_cod(self.cfg, np.shape(tokens)[1])
        cod = self.cod or CodConfig()
        packed = pack_batch(tokens, cod, self.cfg.mask_token_id, seed=seed)
        packed.pop("n_tokens", None)
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in packed.items()}

    def step(self, params, state: AdamWState, batch, events=None):
        """One optimizer step: (params, state, metrics), params and state
        updated in place; metrics are 0-d tensors (and the float ``lr``).
        ``events``, four CUDA events, are recorded before the forward,
        after the loss, after the backward and after the update."""
        mark = (lambda i: events[i].record()) if events else (lambda i: None)
        ps = leaves(params)
        for p in ps:
            p.requires_grad_(True)
            p.grad = None
        mark(0)
        loss, metrics = self.loss(params, batch)
        mark(1)
        loss.backward()
        mark(2)
        grads = _grads(params)
        for p in ps:
            p.grad = None
        params, state, om = self.opt.update(grads, state, params)
        mark(3)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return params, state, {**metrics, "loss": loss.detach(), **om}

    def fit(self, params, stream: Iterator[np.ndarray], steps: int, *,
            log_every: int = 50, log_fn=print):
        """``steps`` steps over batches drawn from ``stream``. Returns
        (params, state, history): one dict of float metrics per logged step
        with ``step``, ``tokens`` (trained tokens so far: every token for
        AR, the packed tokens with segment > 0 for PARD) and ``wall``
        (seconds since the start, read after the step's metrics reach the
        host)."""
        state = self.init_state(params)
        history = []
        t0 = time.perf_counter()
        tokens_seen = 0
        for i in range(steps):
            raw = next(stream)
            batch = self.make_batch(raw, seed=i)
            params, state, metrics = self.step(params, state, batch)
            if self.loss_kind == "pard":
                tokens_seen += int((batch["segment"] > 0).sum())
            else:
                tokens_seen += raw.size
            if (i + 1) % log_every == 0 or i == steps - 1:
                m = {k: float(v) for k, v in metrics.items()}
                m.update(step=i + 1, tokens=tokens_seen,
                         wall=time.perf_counter() - t0)
                history.append(m)
                if log_fn:
                    log_fn({k: (round(v, 4) if isinstance(v, float) else v)
                            for k, v in m.items()})
        return params, state, history
