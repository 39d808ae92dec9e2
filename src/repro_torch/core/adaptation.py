"""PARD adaptation objective (paper §3.2.1, Eq. 8) and the AR objective.

Port of ``repro.core.adaptation``. The packed COD batch (``core.cod``)
trains all K subtasks at once: cross-entropy at every token with a label,
under the COD attention mask of (segment, base). ``per_subtask_norm=True``
is Eq. 8 (each subtask's loss is averaged over its own token count, then
the subtasks are summed); ``False`` is a plain token mean. Log-softmax is
taken in float32; the padded vocab rows hold -1e9 (``unembed_apply``) and
so carry no probability. For a model with MoE layers the AR loss adds
``aux_weight`` times the layers' load-balance loss, and the COD loss
reports it as the metric ``load_balance_loss`` without adding it, as the
JAX package does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.pard_attention import PardMaskInfo
from ..models.config import ATTN_LOCAL, MLP_MOE, scan_plan
from ..models.transformer import forward
from .cod import IGNORE
from .spec_decode import has_ssm


def refuse_ssm_cod(cfg) -> None:
    """COD packs a sequence's real tokens and the mask tokens of its
    subtasks into one row, and only the attention mask keeps a mask token
    at base n from the real tokens at n and after. A Mamba2 layer has no
    mask: its recurrence carries every earlier token of the packed row,
    the labels included, into each mask token. The JAX package trains such
    a draft anyway; the port refuses it."""
    if has_ssm(cfg):
        raise ValueError(
            f"PARD adaptation (COD) of {cfg.name!r}: a model with SSM layers "
            f"cannot train on a packed COD row, because the recurrence "
            f"carries the packed row's real tokens (the labels) into every "
            f"mask token; train it with the AR objective")


def has_moe(cfg) -> bool:
    plan = scan_plan(cfg)
    return any(s.mlp == MLP_MOE for s in plan.prefix + plan.period)


def has_local_layers(cfg) -> bool:
    plan = scan_plan(cfg)
    return any(s.mixer == ATTN_LOCAL for s in plan.prefix + plan.period)


def refuse_windowed_cod(cfg, seq_len: int) -> None:
    """COD's mask has no window: a mask token at base n attends to every
    real token before n. Served, a local layer sees only the last
    ``sliding_window`` positions, so on a sequence longer than the window
    COD would train the local layers on context they never see (the JAX
    package does). The port refuses such a sequence; positions of a packed
    row run 0 .. seq_len - 1."""
    if seq_len > cfg.sliding_window and has_local_layers(cfg):
        raise ValueError(
            f"PARD adaptation (COD) of {cfg.name!r} on {seq_len}-token "
            f"sequences: its local attention layers see only "
            f"{cfg.sliding_window} positions when served, and the COD mask "
            f"has no window; train on sequences of at most "
            f"{cfg.sliding_window} tokens or with the AR objective")


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
    ``n_loss_tokens`` (and ``load_balance_loss`` for a model with MoE
    layers, which the loss does not add), all tensors. Raises
    ``ValueError`` for a config with SSM layers (``refuse_ssm_cod``), and
    for one with local attention layers when the row's positions span
    more than its window (``refuse_windowed_cod``)."""
    refuse_ssm_cod(cfg)
    if has_local_layers(cfg):       # the span's read waits for the device
        refuse_windowed_cod(cfg, int(batch["position_ids"].max()) + 1)
    seg = batch["segment"].to(torch.int32).contiguous()
    base = batch["base"].to(torch.int32).contiguous()
    mask_info = PardMaskInfo(seg, base)
    logits, _, aux = forward(params, cfg, batch["input_ids"],
                             positions=batch["position_ids"],
                             mask_info=mask_info, dtype=dtype, remat=remat,
                             return_aux=True)
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
    if has_moe(cfg):
        metrics["load_balance_loss"] = aux
    return loss, metrics


def ar_loss(params, cfg, tokens, *, dtype=torch.bfloat16,
            aux_weight: float = 0.0, remat: bool = False):
    """Plain next-token AR loss (Eq. 1) over tokens [B, N]: the mean NLL of
    tokens[:, 1:] given tokens[:, :-1], plus ``aux_weight`` times the
    load-balance loss for a model with MoE layers. Returns (loss,
    {"nll": the mean NLL})."""
    logits, _, aux = forward(params, cfg, tokens[:, :-1], dtype=dtype,
                             remat=remat, return_aux=True)
    nll = _token_nll(logits, tokens[:, 1:].long()).mean()
    loss = nll + aux_weight * aux
    return loss, {"nll": nll}
