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

The kernel has no backward yet: on CUDA tensors that require grad the
wrapper raises.
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


def ssd_chunk_body(x, dt, A, B, C, S_in):
    """Exact SSD over one chunk of l tokens from the incoming state S_in:

      cum = cumsum(dt A)
      y   = ((C B^T) o exp(cum_i - cum_j) o [j <= i]) @ (dt x) + (C S^T) exp(cum)
      S   = S exp(cum_l) + (x dt exp(cum_l - cum))^T B

    The causal mask sits inside the exp: the masked side (j > i) has a
    positive exponent that overflows. Returns (y [b,l,h,p] in x's dtype,
    S_out f32)."""
    dtA = dt.float() * A.float()                                # [b,l,h]
    cum = torch.cumsum(dtA, dim=1)
    diff = cum[:, :, None, :] - cum[:, None, :, :]              # [b,i,j,h]
    seq = x.shape[1]
    causal = torch.ones(seq, seq, dtype=torch.bool, device=x.device).tril()
    w = torch.exp(torch.where(causal[None, :, :, None], diff, -1e30))
    cb = torch.einsum("bin,bjn->bij", C.float(), B.float())
    gate = w * cb[..., None]                                    # [b,i,j,h]
    xdt = x.float() * dt.float()[..., None]                     # [b,l,h,p]
    y_intra = torch.einsum("bijh,bjhp->bihp", gate, xdt)
    y_state = torch.einsum("bhpn,bin,bih->bihp", S_in.float(), C.float(),
                           torch.exp(cum))
    decay_to_end = torch.exp(cum[:, -1:, :] - cum)              # [b,l,h]
    S_out = S_in.float() * torch.exp(cum[:, -1])[:, :, None, None] + \
        torch.einsum("bjh,bjhp,bjn->bhpn", decay_to_end, xdt, B.float())
    return (y_intra + y_state).to(x.dtype), S_out


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
    S = (torch.zeros(b, h, p, n, dtype=torch.float32, device=x.device)
         if init_state is None else init_state.float())
    pad = -t % chunk
    x, dt, B, C = (_pad_t(a, pad) for a in (x, dt, B, C))
    ys = []
    for c0 in range(0, t + pad, chunk):
        sl = slice(c0, c0 + chunk)
        y, S = ssd_chunk_body(x[:, sl], dt[:, sl], A, B[:, sl], C[:, sl], S)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :t], S


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
    if any(a is not None and a.requires_grad
           for a in (x, dt, A, B, C, init_state)):
        raise NotImplementedError(
            "ssd_chunked has no backward kernel yet: Mamba2 training on the "
            "card comes with the slice that hand-writes the SSD backward")


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
    x, B, C and init_state.
    """
    b, t, h, p = x.shape
    chunk = clamp_chunk(chunk, t)
    if not on_card(x):
        return ssd_chunked_ref(x, dt, A, B, C, init_state, chunk=chunk)
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
