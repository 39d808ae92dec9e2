"""PARD adaptation objective (paper §3.2.1, Eq. 8) and the AR objective.

Port of ``repro.core.adaptation``. The packed COD batch (``core.cod``)
trains all K subtasks at once: cross-entropy at every token with a label,
under the COD attention mask of (segment, base). ``per_subtask_norm=True``
is Eq. 8 (each subtask's loss is averaged over its own token count, then
the subtasks are summed); ``False`` is a plain token mean. Log-softmax is
taken in float32; the padded vocab rows hold -1e9 (``unembed_apply``) and
so carry no probability.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.pard_attention import PardMaskInfo
from ..models.transformer import forward
from .cod import IGNORE


def _token_nll(logits, labels):
    """Per-token negative log-likelihood in float32; 0 where the label is
    IGNORE."""
    nll = F.cross_entropy(logits.float().flatten(0, 1), labels.flatten(),
                          ignore_index=IGNORE, reduction="none")
    return nll.view(labels.shape)


def pard_adaptation_loss(params, cfg, batch, *, k_max: int = 0,
                         per_subtask_norm: bool = True,
                         dtype=torch.bfloat16, remat: bool = False):
    """batch: dict of [B, T] tensors from ``cod.pack_batch`` (input_ids,
    position_ids, labels, segment, base; int). Returns (loss, metrics):
    ``loss_subtask_s`` for s = 1..k_max with Eq. 8, ``token_mean_nll`` and
    ``n_loss_tokens``, all tensors."""
    seg = batch["segment"].to(torch.int32).contiguous()
    base = batch["base"].to(torch.int32).contiguous()
    mask_info = PardMaskInfo(seg, base)
    logits, _ = forward(params, cfg, batch["input_ids"],
                        positions=batch["position_ids"], mask_info=mask_info,
                        dtype=dtype, remat=remat)
    labels = batch["labels"].long()
    valid = labels != IGNORE
    tok_nll = _token_nll(logits, labels)
    n_valid = valid.sum()
    token_mean = tok_nll.sum() / n_valid.clamp(min=1)

    metrics = {}
    if per_subtask_norm and k_max:
        loss = torch.zeros((), dtype=torch.float32, device=logits.device)
        for s in range(1, k_max + 1):
            sel = valid & (seg == s)
            ls = torch.where(sel, tok_nll, 0.0).sum() / sel.sum().clamp(min=1)
            metrics[f"loss_subtask_{s}"] = ls
            loss = loss + ls
    else:
        loss = token_mean
    metrics["token_mean_nll"] = token_mean
    metrics["n_loss_tokens"] = n_valid
    return loss, metrics


def ar_loss(params, cfg, tokens, *, dtype=torch.bfloat16, remat: bool = False):
    """Plain next-token AR loss (Eq. 1) over tokens [B, N]: the mean NLL of
    tokens[:, 1:] given tokens[:, :-1]. Returns (loss, {"nll": loss})."""
    logits, _ = forward(params, cfg, tokens[:, :-1], dtype=dtype, remat=remat)
    loss = _token_nll(logits, tokens[:, 1:].long()).mean()
    return loss, {"nll": loss}
