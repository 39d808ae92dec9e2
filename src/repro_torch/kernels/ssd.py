"""Mamba2 SSD scan: the CUDA kernel's wrapper and its plain PyTorch
versions.

Port of the Pallas TPU kernel ``repro.kernels.ssd.ssd_chunked_kernel``
(wrapper ``ops.ssd_chunked``) and of the model's jnp scans
``repro.models.ssm.ssd_scan_ref`` / ``ssd_scan_chunked``. Shapes, as in
the JAX package:

  x  [b, t, h, p]   dt [b, t, h] (after softplus)   A [h] (negative)
  B, C [b, t, n]    shared across heads
  init_state [b, h, p, n] (None: zeros)
  -> y [b, t, h, p] in x's dtype, final state [b, h, p, n] float32

``ssd_ref`` runs the recurrence token by token (the oracle; with
``collect_states`` it returns every token's state). ``ssd_chunked_ref`` is
the plain chunked version. ``ssd_chunked`` launches ``csrc/ssd_chunked.cu``
for CUDA tensors (bf16 inputs on the tensor cores, tiled by
``ssd_tile_plan``; float32 inputs on an f32 loop) and takes
``ssd_chunked_ref`` only for CPU tensors; every
Mamba2 scan of the port's model goes through it. A token with dt = 0 leaves
the state unchanged and adds nothing to it, so padding t with dt = 0 (the
wrapper) and masking the tail of a window with dt = 0 (the state gather of
``core.spec_decode``) are exact.

The gradient: the TPU kernel has none (JAX differentiates the jnp scan).
On CUDA tensors with grad enabled and an input that requires grad,
``ssd_chunked`` runs ``_SSDChunked``: the forward kernel, then in the
backward ``ssd_chunked_bwd`` (``csrc/ssd_chunked_bwd.cu``), which
recomputes the chunk states: for bf16 chunk-parallel on the tensor cores
with an elementwise recurrence over chunks (tiled by ``ssd_bwd_plan``),
for float32 by a walk over the chunks forward and then in reverse.
``ssd_chunked_bwd_ref`` is its plain version, the same reverse scan over
chunks; on the CPU autograd differentiates ``ssd_chunked_ref``.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .decode_attention import _DTYPE_CODE, launch, on_card, ptr

MAX_CHUNK = 64          # the kernel's chunk bound (its shared-memory tiles)
# the bf16 route (csrc/ssd_chunked.cu, mma_kernel): one CTA of SSD_WARPS
# warps per (batch row, head, block of SSD_P_BLOCK rows of P)
SSD_WARPS = 4
SSD_P_BLOCK = 16


def ssd_ref(x, dt, A, B, C, init_state=None, collect_states: bool = False):
    """Token-by-token recurrence (the oracle):

      S_t = exp(dt_t A) S_{t-1} + (dt_t x_t) B_t^T,   y_t = S_t C_t

    Returns (y [b,t,h,p] in x's dtype, final state [b,h,p,n] f32); with
    ``collect_states`` the second element is every token's state
    [b,t,h,p,n]."""
    b, t, h, p = x.shape
    n = B.shape[-1]
    S = (torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    A = A.float()
    ys, states = [], []
    for i in range(t):
        decay = torch.exp(dtf[:, i] * A)[:, :, None, None]          # [b,h,1,1]
        upd = (dtf[:, i, :, None] * xf[:, i])[..., None] * Bf[:, i, None, None, :]
        S = decay * S + upd
        ys.append(torch.einsum("bhpn,bn->bhp", S, Cf[:, i]))
        if collect_states:
            states.append(S)
    y = torch.stack(ys, dim=1).to(x.dtype)
    if collect_states:
        return y, torch.stack(states, dim=1)
    return y, S


def _acc(x) -> torch.dtype:
    """The plain versions' arithmetic type: float32, or float64 for float64
    inputs (a float64 run is the oracle of the float32 ones)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def ssd_chunk_body(x, dt, A, B, C, S_in):
    """Exact SSD over one chunk of l tokens from the incoming state S_in:

      cum = cumsum(dt A)
      y   = ((C B^T) o exp(cum_i - cum_j) o [j <= i]) @ (dt x) + (C S^T) exp(cum)
      S   = S exp(cum_l) + (x dt exp(cum_l - cum))^T B

    The causal mask sits inside the exp: the masked side (j > i) has a
    positive exponent that overflows. Returns (y [b,l,h,p] in x's dtype,
    S_out f32; f64 for f64 inputs)."""
    acc, y_dtype = _acc(x), x.dtype
    x, dt, A, B, C, S_in = (a.to(acc) for a in (x, dt, A, B, C, S_in))
    dtA = dt * A                                                # [b,l,h]
    cum = torch.cumsum(dtA, dim=1)
    diff = cum[:, :, None, :] - cum[:, None, :, :]              # [b,i,j,h]
    seq = x.shape[1]
    causal = torch.ones(seq, seq, dtype=torch.bool, device=x.device).tril()
    w = torch.exp(torch.where(causal[None, :, :, None], diff, -1e30))
    cb = torch.einsum("bin,bjn->bij", C, B)
    gate = w * cb[..., None]                                    # [b,i,j,h]
    xdt = x * dt[..., None]                                     # [b,l,h,p]
    y_intra = torch.einsum("bijh,bjhp->bihp", gate, xdt)
    y_state = torch.einsum("bhpn,bin,bih->bihp", S_in, C, torch.exp(cum))
    decay_to_end = torch.exp(cum[:, -1:, :] - cum)              # [b,l,h]
    S_out = S_in * torch.exp(cum[:, -1])[:, :, None, None] + \
        torch.einsum("bjh,bjhp,bjn->bhpn", decay_to_end, xdt, B)
    return (y_intra + y_state).to(y_dtype), S_out


def _pad_t(a, pad: int):
    """Zero-pad axis 1 of ``a`` by ``pad`` entries."""
    if not pad:
        return a
    return torch.cat([a, a.new_zeros((a.shape[0], pad) + tuple(a.shape[2:]))],
                     dim=1)


def ssd_chunked_ref(x, dt, A, B, C, init_state=None, *, chunk: int = 64):
    """The plain chunked version: ``ssd_chunk_body`` over chunks of
    ``chunk`` tokens, t padded to a chunk multiple with dt = 0."""
    b, t, h, p = x.shape
    n = B.shape[-1]
    S = (torch.zeros(b, h, p, n, dtype=_acc(x), device=x.device)
         if init_state is None else init_state.to(_acc(x)))
    pad = -t % chunk
    x, dt, B, C = (_pad_t(a, pad) for a in (x, dt, B, C))
    ys = []
    for c0 in range(0, t + pad, chunk):
        sl = slice(c0, c0 + chunk)
        y, S = ssd_chunk_body(x[:, sl], dt[:, sl], A, B[:, sl], C[:, sl], S)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :t], S


def ssd_chunked_bwd_ref(x, dt, A, B, C, init_state, dy, dS_final, *,
                        chunk: int):
    """The gradient of ``ssd_chunked_ref`` by an explicit reverse scan over
    chunks: the decomposition ``csrc/ssd_chunked_bwd.cu`` runs.

    dy [b,t,h,p] is the cotangent of y, dS_final [b,h,p,n] (or None) that
    of the final state. Per chunk, from its incoming state S (recomputed
    forward) and the carried dS (the cotangent of the chunk's outgoing
    state), with w_ij = exp(cum_i - cum_j) [j <= i], e = exp(cum),
    f = exp(cum_L - cum), xdt = x dt:

      D_ij   = dy_i . xdt_j                      (over P, per head)
      dxdt_j = sum_i w_ij (C_i.B_j) dy_i + f_j dS B_j
      dC_i   = sum_j,h w_ij D_ij B_j + sum_h e_i S^T dy_i
      dB_j   = sum_i,h w_ij D_ij C_i + sum_h f_j dS^T xdt_j
      M_ij   = w_ij (C_i.B_j) D_ij,  dd_j = f_j xdt_j . dS B_j
      da_k   = sum_{i >= k, j < k} M_ij + sum_{j < k} dd_j
               + sum_{i >= k} e_i dy_i . S C_i + exp(cum_L) sum S o dS
      dS    <- exp(cum_L) dS + sum_i e_i dy_i C_i^T

    da is the gradient of cum = cumsum(dt A) summed backward, da_k = sum_{i
    >= k} dcum_i, with the terms that cancel in that sum left out: taken as
    row sums less column sums of M, then cumulated, it would lose float32
    digits to cancellation (da_0 of M's part is 0 exactly). ddt = dxdt . x
    + da A, dA = sum over b and t of da dt. Returns (dx, ddt, dA, dB, dC,
    dinit): dx, dB, dC in x's dtype, the rest float32 (float64 for float64
    inputs; dinit the cotangent of the initial state, zeros taken for
    None)."""
    b, t, h, p = x.shape
    n = B.shape[-1]
    pad = -t % chunk
    acc = _acc(x)
    xf, dtf, Bf, Cf, dyf = (_pad_t(a.to(acc), pad) for a in (x, dt, B, C, dy))
    A = A.to(acc)
    S = (torch.zeros(b, h, p, n, dtype=acc, device=x.device)
         if init_state is None else init_state.to(acc))
    starts = list(range(0, t + pad, chunk))
    states = []                         # each chunk's incoming state
    for c0 in starts[:-1]:
        sl = slice(c0, c0 + chunk)
        states.append(S)
        cum = torch.cumsum((dtf[:, sl] * A).double(), dim=1)
        f = torch.exp((cum[:, -1:] - cum).to(acc)) * dtf[:, sl]
        S = S * torch.exp(cum[:, -1].to(acc))[..., None, None] + torch.einsum(
            "bjh,bjhp,bjn->bhpn", f, xf[:, sl], Bf[:, sl])
    states.append(S)
    dS = (torch.zeros(b, h, p, n, dtype=acc, device=x.device)
          if dS_final is None else dS_final.to(acc))
    dx, ddt = torch.zeros_like(xf), torch.zeros_like(dtf)
    dB, dC = torch.zeros_like(Bf), torch.zeros_like(Cf)
    dA = torch.zeros_like(A)
    causal = torch.ones(chunk, chunk, dtype=torch.bool,
                        device=x.device).tril()[None, :, :, None]
    before = causal.logical_not().transpose(1, 2)               # [k, j]: j < k
    for c0, S_in in zip(reversed(starts), reversed(states)):
        sl = slice(c0, c0 + chunk)
        xc, dtc, Bc, Cc, dyc = xf[:, sl], dtf[:, sl], Bf[:, sl], Cf[:, sl], \
            dyf[:, sl]
        # cum in float64, as the kernel takes it: w's exponent is a
        # difference of two sums that grow along the chunk
        cum = torch.cumsum((dtc * A).double(), dim=1)               # [b,l,h]
        diff = (cum[:, :, None, :] - cum[:, None, :, :]).to(acc)    # [b,i,j,h]
        w = torch.exp(torch.where(causal, diff, -1e30))
        cb = torch.einsum("bin,bjn->bij", Cc, Bc)
        xdt = xc * dtc[..., None]
        D = torch.einsum("bihp,bjhp->bijh", dyc, xdt)
        gate = w * cb[..., None]
        dcb = w * D
        M = gate * D
        e = torch.exp(cum.to(acc))
        f = torch.exp((cum[:, -1:] - cum).to(acc))
        last = cum[:, -1].to(acc)                                   # [b,h]
        sb = torch.einsum("bhpn,bjn->bjhp", dS, Bc)                 # dS B_j
        sc = torch.einsum("bhpn,bin->bihp", S_in, Cc)               # S C_i
        dxdt = torch.einsum("bijh,bihp->bjhp", gate, dyc) + f[..., None] * sb
        dx[:, sl] = dxdt * dtc[..., None]
        dC[:, sl] = torch.einsum("bijh,bjn->bin", dcb, Bc) + torch.einsum(
            "bih,bhpn,bihp->bin", e, S_in, dyc)
        dB[:, sl] = torch.einsum("bijh,bin->bjn", dcb, Cc) + torch.einsum(
            "bjh,bhpn,bjhp->bjn", f, dS, xdt)
        dd = f * (xdt * sb).sum(-1)                                 # [b,l,h]
        ys = e * (dyc * sc).sum(-1)
        # da_k = sum_{i >= k} dcum_i without its cancellations: the terms
        # of w whose two ends are both at or past k cancel, and dd_i at i
        # cancels its share of the sum at L - 1
        da = (_rcumsum(M) * before).sum(2) + dd.cumsum(1) - dd + \
            _rcumsum(ys) + (torch.exp(last) * (S_in * dS).sum((-2, -1)))[:, None]
        ddt[:, sl] = (dxdt * xc).sum(-1) + da * A
        dA += (da * dtc).sum((0, 1))
        dS = torch.exp(last)[..., None, None] * dS + torch.einsum(
            "bih,bihp,bin->bhpn", e, dyc, Cc)
    return (dx[:, :t].to(x.dtype), ddt[:, :t], dA, dB[:, :t].to(B.dtype),
            dC[:, :t].to(C.dtype), dS)


def _rcumsum(a):
    """The reverse cumulative sum over axis 1: out[:, k] = sum_{i >= k}."""
    return a.flip(1).cumsum(1).flip(1)


def clamp_chunk(chunk: int, t: int) -> int:
    """The TPU wrapper's chunk: ``min(chunk, max(8, next_pow2(t)))``."""
    return min(chunk, max(8, 1 << (t - 1).bit_length()))


def ssd_tile_plan(p: int, n: int, chunk: int) -> Tuple[int, int, int]:
    """(P blocks, nk, mt) of the bf16 kernel for head dim ``p``, state
    dim ``n`` and the clamped ``chunk``.

    The grid is (P blocks, h, b) with P blocks = ceil(p / 16). Each of the
    CTA's 4 warps holds 16 nk state columns (nk = 1 for n <= 64, 2 for
    n <= 128: columns past n are zero), and a chunk runs in mt = 1, 2 or 4
    tiles of 16 token rows (rows past the chunk are zero). The kernel
    copies 16 bytes at a time, so p and n must be multiples of 8; n past
    128 and chunk past 64 are refused. A function of integers, so the
    plan never reads a device value.
    """
    args = (p, n, chunk)
    if not all(isinstance(v, int) and not isinstance(v, bool) for v in args):
        raise TypeError(f"ssd_tile_plan takes Python ints, got "
                        f"{[type(v).__name__ for v in args]}")
    if min(args) < 1:
        raise ValueError(f"ssd_tile_plan needs positive sizes, got {args}")
    if p % 8 or n % 8:
        raise ValueError(f"the bf16 ssd_chunked kernel needs P and N multiples "
                         f"of 8 (16-byte copies), got P={p} N={n}")
    if n > 2 * SSD_WARPS * 16:
        raise ValueError(f"the bf16 ssd_chunked kernel holds N <= "
                         f"{2 * SSD_WARPS * 16} state columns, got N={n}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk {chunk} > {MAX_CHUNK}")
    nk = 1 if n <= SSD_WARPS * 16 else 2
    tiles = -(-chunk // 16)
    mt = 1 << (tiles - 1).bit_length()
    return -(-p // SSD_P_BLOCK), nk, mt


def _check(x, dt, A, B, C, init_state, chunk):
    b, t, h, p = x.shape
    n = B.shape[-1]
    shapes = [("dt", dt, (b, t, h)), ("A", A, (h,)), ("B", B, (b, t, n)),
              ("C", C, (b, t, n))]
    if init_state is not None:
        shapes.append(("init_state", init_state, (b, h, p, n)))
    for name, a, shape in shapes:
        if tuple(a.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(a.shape)}, expected "
                             f"{shape}")
    if x.dtype not in _DTYPE_CODE or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"dtypes x={x.dtype} B={B.dtype} C={C.dtype}: the "
                        f"kernel takes one of float32/bfloat16")
    for name, a in (("dt", dt), ("A", A), ("init_state", init_state)):
        if a is not None and a.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {a.dtype}")
    for name, a in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C),
                    ("init_state", init_state)):
        if a is None:
            continue
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")
        if not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if chunk > MAX_CHUNK:
        raise ValueError(f"chunk {chunk} > {MAX_CHUNK}: the kernel's tiles "
                         f"hold at most {MAX_CHUNK} tokens")


def _ssd_fwd(x, dt, A, B, C, init_state, chunk):
    """Launch ``csrc/ssd_chunked.cu`` at the clamped ``chunk``."""
    b, t, h, p = x.shape
    _check(x, dt, A, B, C, init_state, chunk)
    n = B.shape[-1]
    nk = mt = 0                 # the f32 loop takes no tile plan
    if x.dtype == torch.bfloat16:
        _, nk, mt = ssd_tile_plan(p, n, chunk)
        for name, a in (("x", x), ("B", B), ("C", C),
                        ("init_state", init_state)):
            if a is not None and a.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned for the "
                                 f"bf16 kernel's copies")
    y = torch.empty_like(x)
    state = torch.empty(b, h, p, n, dtype=torch.float32, device=x.device)
    s0 = ctypes.c_void_p(None) if init_state is None else ptr(init_state)
    launch("ssd_chunked", x, ptr(x), ptr(dt), ptr(A), ptr(B), ptr(C), s0,
           ptr(y), ptr(state),
           *(ctypes.c_int(v) for v in (b, t, h, p, n, chunk,
                                       _DTYPE_CODE[x.dtype], nk, mt)))
    return y, state


SSD_BWD_ROWS = 32       # rows of P per CTA of the fp32 backward
SSD_BWD_P_BLOCK = 64    # rows of P per CTA of the bf16 backward


def ssd_bwd_plan(b: int, t: int, h: int, p: int, n: int,
                 chunk: int) -> Tuple[Tuple[int, int, int], int, int, int]:
    """(grid, nk, mt, workspace floats) of the bf16 backward
    (``csrc/ssd_chunked_bwd.cu``) at the clamped ``chunk``.

    Stages A and C run one CTA of 4 warps per (block of 64 rows of P,
    head, batch row x chunk): grid = (ceil(p / 64), h, b * nc) with nc =
    ceil(t / chunk). A chunk runs in mt = 1, 2 or 4 tiles of 16 token
    rows, N in nk = 1 or 2 halves of 64 columns (rows and columns past
    the shape are zero). The f32 workspace holds each chunk's state
    contribution and then its incoming state, the same for the state's
    cotangent [b, h, nc, p, n] each; the partial dB and dC of each (batch
    row, head, P block) [t, n] each; each chunk's decay exp(cum_L) [b, h,
    nc]; the partial ddt of each P block [b, h, npb, t]; and the partial
    dA of each CTA [b, nc, h, npb]. The shapes ``ssd_tile_plan`` takes:
    P and N multiples of 8, N <= 128, chunk <= 64. A function of
    integers, so the plan never reads a device value.
    """
    args = (b, t, h, p, n, chunk)
    if not all(isinstance(v, int) and not isinstance(v, bool) for v in args):
        raise TypeError(f"ssd_bwd_plan takes Python ints, got "
                        f"{[type(v).__name__ for v in args]}")
    if min(args) < 1:
        raise ValueError(f"ssd_bwd_plan needs positive sizes, got {args}")
    _, nk, mt = ssd_tile_plan(p, n, chunk)
    nc, npb = -(-t // chunk), -(-p // SSD_BWD_P_BLOCK)
    ws = b * h * (2 * nc * p * n + npb * (2 * t * n + t) + nc + nc * npb)
    return (npb, h, b * nc), nk, mt, ws


def _bwd_workspace(b: int, t: int, h: int, p: int, n: int, chunk: int,
                   dtype: torch.dtype = torch.float32) -> int:
    """Floats of the backward kernel's f32 workspace. bf16: the layout of
    ``ssd_bwd_plan``. fp32: each chunk's incoming state [b, h, nc, p, n],
    then per CTA (batch row, head, block of ``SSD_BWD_ROWS`` rows of P)
    its partial dB and dC [t, n], ddt [t] and dA."""
    if dtype == torch.bfloat16:
        return ssd_bwd_plan(b, t, h, p, n, chunk)[3]
    nc, npb = -(-t // chunk), -(-p // SSD_BWD_ROWS)
    return b * h * (nc * p * n + npb * (2 * t * n + t + 1))


def ssd_chunked_bwd(x, dt, A, B, C, init_state, dy, dS_final, *, chunk: int):
    """The gradient of ``ssd_chunked`` at the clamped ``chunk``: (dx, ddt,
    dA, dB, dC, dinit), dx, dB and dC in x's dtype, the rest float32.

    CUDA tensors launch ``csrc/ssd_chunked_bwd.cu`` (one call, counted
    once: bf16 runs its four stages on the tensor cores as ``ssd_bwd_plan``
    lays them out, fp32 its backward walk and a reduction; no float
    atomics, so two calls are bitwise equal); dy in x's dtype and dS_final
    (float32 or None) contiguous, as the forward's inputs, and for bf16
    x, dy, B, C, init_state and dS_final 16-byte aligned. CPU tensors take
    ``ssd_chunked_bwd_ref``."""
    if not on_card(x):
        return ssd_chunked_bwd_ref(x, dt, A, B, C, init_state, dy, dS_final,
                                   chunk=chunk)
    _check(x, dt, A, B, C, init_state, chunk)
    b, t, h, p = x.shape
    n = B.shape[-1]
    for name, a, dtype, shape in (("dy", dy, x.dtype, x.shape),
                                  ("dS_final", dS_final, torch.float32,
                                   (b, h, p, n))):
        if a is None:
            continue
        if tuple(a.shape) != tuple(shape) or a.dtype != dtype:
            raise ValueError(f"{name} is {a.dtype} {tuple(a.shape)}, "
                             f"expected {dtype} {tuple(shape)}")
        if a.device != x.device or not a.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    nk = mt = 0                 # the f32 loop takes no plan
    if x.dtype == torch.bfloat16:
        _, nk, mt, _ = ssd_bwd_plan(b, t, h, p, n, chunk)
        for name, a in (("x", x), ("dy", dy), ("B", B), ("C", C),
                        ("init_state", init_state), ("dS_final", dS_final)):
            if a is not None and a.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned for the "
                                 f"bf16 backward's copies")
    dx, ddt, dA = torch.empty_like(x), torch.empty_like(dt), torch.empty_like(A)
    dB, dC = torch.empty_like(B), torch.empty_like(C)
    dinit = torch.empty(b, h, p, n, dtype=torch.float32, device=x.device)
    size = _bwd_workspace(b, t, h, p, n, chunk, x.dtype)
    ws = torch.empty(size, dtype=torch.float32, device=x.device)
    launch("ssd_chunked_bwd", x, ptr(x), ptr(dt), ptr(A), ptr(B), ptr(C),
           ptr(init_state), ptr(dy), ptr(dS_final), ptr(dx), ptr(ddt),
           ptr(dA), ptr(dB), ptr(dC), ptr(dinit), ptr(ws),
           ctypes.c_longlong(size),
           *(ctypes.c_int(v) for v in (b, t, h, p, n, chunk,
                                       _DTYPE_CODE[x.dtype], nk, mt)))
    return dx, ddt, dA, dB, dC, dinit


class _SSDChunked(torch.autograd.Function):
    """``ssd_chunked`` on the card under autograd: the forward kernel, whose
    inputs are all the backward keeps (it recomputes the chunk states), and
    ``ssd_chunked_bwd``. Either cotangent may be None: y's is then zeros,
    the final state's is skipped."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, init_state, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C, init_state)
        ctx.chunk = chunk
        return _ssd_fwd(x, dt, A, B, C, init_state, chunk)

    @staticmethod
    def backward(ctx, dy, d_state):
        x, dt, A, B, C, init_state = ctx.saved_tensors
        dy = torch.zeros_like(x) if dy is None else dy.contiguous()
        if d_state is not None:
            d_state = d_state.contiguous()
        dx, ddt, dA, dB, dC, dinit = ssd_chunked_bwd(
            x, dt, A, B, C, init_state, dy, d_state, chunk=ctx.chunk)
        return (dx, ddt, dA, dB, dC,
                None if init_state is None else dinit, None)


def ssd_chunked(x, dt, A, B, C, init_state: Optional[torch.Tensor] = None, *,
                chunk: int = 64):
    """Chunked SSD scan. Returns (y [b,t,h,p] in x's dtype, final state
    [b,h,p,n] float32).

    The chunk is clamped to ``min(chunk, max(8, next_pow2(t)))`` and t is
    padded to a chunk multiple with dt = 0, as the TPU wrapper does; the
    kernel pads in its loads, the plain version with zeros. CUDA tensors
    launch ``csrc/ssd_chunked.cu``: x, B, C float32 or bfloat16 (one
    dtype), dt, A and init_state float32, all contiguous, chunk <= 64;
    for bf16 also the shapes ``ssd_tile_plan`` takes and 16-byte aligned
    x, B, C and init_state. With grad enabled and an input that requires
    grad they go through ``_SSDChunked``, whose backward launches
    ``csrc/ssd_chunked_bwd.cu``; CPU tensors take ``ssd_chunked_ref``
    under autograd.
    """
    chunk = clamp_chunk(chunk, x.shape[1])
    if not on_card(x):
        return ssd_chunked_ref(x, dt, A, B, C, init_state, chunk=chunk)
    if torch.is_grad_enabled() and any(
            a is not None and a.requires_grad
            for a in (x, dt, A, B, C, init_state)):
        return _SSDChunked.apply(x, dt, A, B, C, init_state, chunk)
    return _ssd_fwd(x, dt, A, B, C, init_state, chunk)
