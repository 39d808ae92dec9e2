"""Mamba2 (SSD, state-space duality) block. arXiv:2405.21060.

Port of ``repro.models.ssm`` with n_groups = 1:
  in_proj -> [z | x | B | C | dt], causal depthwise conv over [x | B | C],
  SSD scan, the ``D`` skip, gated RMSNorm, out_proj.

Every scan goes through ``kernels.ssd.ssd_chunked`` (the CUDA kernel on the
card). A cache-free forward (``state=None``, training) differentiates
through it: on the card its backward is ``csrc/ssd_chunked_bwd.cu``; the
conv, softplus, gated norm and projections stay plain PyTorch under
autograd, as the JAX package computes them outside any Pallas kernel. The
decode-time state of a layer is ``{"conv": [B, W-1, C], "ssm":
[B, H, P, N]}`` in float32 (``init_mamba2_state``); a window with a state
updates it IN PLACE.

A speculative window must keep the state after its last accepted token,
not after its last slot. The JAX package collects every token's state
([B, T, H, P, N]: 1.2 GB per forward at mamba2-130m, B = 4, T = 16); here a
collect forward leaves the state untouched and returns what the gather
(``core.spec_decode.gather_ssm_states``) needs to rebuild the state after
any token of the window: the incoming state (the cache itself), the
window's x, dt, B, C and the conv context ``[B, W-1+T, C]``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ssd import ssd_chunked


def init_mamba2_state(cfg, batch: int, device="cuda"):
    """Zeroed decode state ``{"conv": [batch, W-1, C], "ssm": [batch, H, P,
    N]}``, float32 whatever the activation and KV dtypes."""
    conv_dim = cfg.ssm_inner + 2 * cfg.ssm_state
    return {"conv": torch.zeros(batch, cfg.ssm_conv - 1, conv_dim,
                                dtype=torch.float32, device=device),
            "ssm": torch.zeros(batch, cfg.ssm_nheads, cfg.ssm_headdim,
                               cfg.ssm_state, dtype=torch.float32,
                               device=device)}


def causal_conv(ctx, w, b):
    """Depthwise causal conv over ``ctx [B, W-1+T, C]`` (the W-1 context
    tokens first): out[t] = silu(sum_k ctx[t+k] w[k] + b), accumulated in
    f32, returned in ctx's dtype as [B, T, C]."""
    width = w.shape[0]
    t = ctx.shape[1] - (width - 1)
    out = torch.zeros(ctx.shape[0], t, ctx.shape[2], dtype=torch.float32,
                      device=ctx.device)
    for k in range(width):
        out = out + ctx[:, k:k + t].float() * w[k]
    return F.silu(out + b).to(ctx.dtype)


def mamba2_apply(params, cfg, x, *, state=None, collect_states: bool = False):
    """x [B, T, d] -> (y [B, T, d], record).

    ``state`` None: the scan starts from zeros (cache-free forwards, the
    training path: autograd runs the scan's backward kernel). With
    ``state`` and no ``collect_states``, the window's final conv and SSM
    states are written into ``state`` in place and the record is None.
    With ``collect_states`` the state is left as it was and the record
    holds what ``gather_ssm_states`` needs: the state dict itself (the
    incoming state), A, x, dt, B, C, the conv context and the chunk.
    """
    b, t, _ = x.shape
    d_in, n, h, p = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_nheads, cfg.ssm_headdim
    chunk = cfg.ssm_chunk
    proj = x @ params["in_proj"].to(x.dtype)
    z, xs, bm, cm, dt = proj.split([d_in, d_in, n, n, h], dim=-1)

    conv_in = torch.cat([xs, bm, cm], dim=-1)
    width = params["conv_w"].shape[0]
    if state is None:
        ctx = F.pad(conv_in, (0, 0, width - 1, 0))
    else:
        ctx = torch.cat([state["conv"].to(x.dtype), conv_in], dim=1)
    conv_out = causal_conv(ctx, params["conv_w"], params["conv_b"])
    xs, bm, cm = conv_out.split([d_in, n, n], dim=-1)
    xh = xs.reshape(b, t, h, p).contiguous()
    bm, cm = bm.contiguous(), cm.contiguous()
    dtv = F.softplus(dt.float() + params["dt_bias"])
    A = -torch.exp(params["A_log"].float())

    s0 = None if state is None else state["ssm"]
    y, s_new = ssd_chunked(xh, dtv, A, bm, cm, s0, chunk=chunk)
    y = y + xh.float() * params["D"][None, None, :, None]
    y = y.reshape(b, t, d_in).to(x.dtype)

    # gated RMSNorm (mamba2 norm_before_gate=False: norm(y * silu(z)))
    g = y * F.silu(z)
    gf = g.float()
    var = gf.square().mean(dim=-1, keepdim=True)
    g = (gf * torch.rsqrt(var + cfg.norm_eps) * params["ssm_norm"]).to(x.dtype)
    out = g @ params["out_proj"].to(x.dtype)

    record = None
    if state is not None:
        if collect_states:
            record = dict(state=state, A=A, x=xh, dt=dtv, B=bm, C=cm, ctx=ctx,
                          chunk=chunk)
        else:
            state["ssm"].copy_(s_new)
            state["conv"].copy_(ctx[:, ctx.shape[1] - (width - 1):])
    return out, record


def gather_state(record, idx) -> None:
    """Write into the recorded state the state after ``idx[b] + 1`` tokens
    of the window: one ``ssd_chunked`` from the incoming state with
    dt = 0 past each row's index (dt = 0 leaves the state as it is and
    adds nothing), and the conv window ``ctx[b, idx+1 : idx+W]``."""
    state, dt, ctx = record["state"], record["dt"], record["ctx"]
    t = dt.shape[1]
    keep = torch.arange(t, device=dt.device)[None, :] <= idx[:, None]
    _, s_new = ssd_chunked(record["x"], dt * keep[..., None], record["A"],
                           record["B"], record["C"], state["ssm"],
                           chunk=record["chunk"])
    w1 = state["conv"].shape[1]
    pos = idx[:, None] + 1 + torch.arange(w1, device=dt.device)[None, :]
    conv = ctx.gather(1, pos[..., None].expand(-1, -1, ctx.shape[2]))
    state["ssm"].copy_(s_new)
    state["conv"].copy_(conv)
