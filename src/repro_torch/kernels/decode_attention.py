"""Decode / verify attention: the CUDA kernels' wrappers and their plain
PyTorch versions.

Ports of the Pallas TPU kernels ``repro.kernels.decode_attention``
(``decode_attention_paged`` and the contiguous ``decode_attention``) and
their oracles ``ref.decode_attention_paged_ref`` / ``ref.decode_attention_ref``.
A small query window attends under the causal mask to a block-paged KV
pool through per-row block tables, or to a contiguous ``[B, S, Hkv, D]``
cache. The serving engine's flat steps go through here: the PARD draft
window (Tq = 2K), the verify window (Tq = K+1) and prompt chunks.

K/V in bf16 or fp32, or quantized: int8 or fp8 (e4m3) codes with float32
dequant scales ``k_scale`` / ``v_scale``, one per (position, kv head) of
the pool ``[NB, bs, Hkv]`` or cache ``[B, S, Hkv]``. The plain versions
dequantize first (as ``ref._maybe_dequant`` does); the kernels dequantize
inside their KV stream.

Each wrapper launches its kernel (``csrc/decode_attention_paged.cu``,
``csrc/decode_attention.cu``) for CUDA tensors and takes the plain version
only for CPU tensors. The helpers shared with ``tree_attention`` (the
masked f32 core ``attend``, the input checks, the launcher and the bf16
kernels' split-KV plan ``split_kv_plan``) live here.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import build, launches

NEG_INF = -1e30

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2,
               torch.float8_e4m3fn: 3}
_Q_DTYPES = (torch.float32, torch.bfloat16)
QUANT_KV = (torch.int8, torch.float8_e4m3fn)
_HEAD_DIMS = (32, 48, 64, 128)

# the bf16 tensor-core loop of the serving kernels (csrc/serve_attention_mma.cuh)
MAX_WARPS = 8           # 16 query rows each: 128 rows per CTA
MAX_CLUSTER = 8         # the portable thread-block cluster size
KEY_CHUNK = 64          # keys per cp.async ring stage


def split_kv_plan(b: int, hkv: int, rows: int, reach: int,
                  sms: int) -> Tuple[int, int]:
    """(cluster size cs, warps with rows per CTA) of the bf16 loop.

    ``rows`` = Tq * G query rows per kv head, ``reach`` the positions a
    row can hold (MBS * block for a paged pool, S for a contiguous
    cache), ``sms`` the card's SM count. The rows
    split into balanced tiles of at most 128 (``warps`` * 16 rows each,
    one CTA of 8 warps per tile, all of which copy);
    the B * Hkv * tiles groups each take a cluster of ``cs`` CTAs that
    split the group's visible keys in 64-key chunks: as many as keep the
    CTAs within 90 % of the SMs, at most 8, and no more than the reach has
    chunks. A CTA holds an SM, and a cluster needs cs SMs of one GPC; the
    10 % left over keeps all clusters in one wave (on an H100, 32 clusters
    of 4 did not fit at once). A function of integers the host knows, never
    of a device value, so a call can be captured in a CUDA graph and
    replayed with other kv_len.
    """
    args = (b, hkv, rows, reach, sms)
    if not all(isinstance(x, int) and not isinstance(x, bool) for x in args):
        raise TypeError(f"split_kv_plan takes Python ints, got "
                        f"{[type(x).__name__ for x in args]}")
    if min(args) < 1:
        raise ValueError(f"split_kv_plan needs positive sizes, got {args}")
    tiles = -(-rows // (16 * MAX_WARPS))
    warps = -(-rows // (16 * tiles))
    cs = min(MAX_CLUSTER, sms * 9 // 10 // (b * hkv * tiles),
             -(-reach // KEY_CHUNK))
    return max(1, cs), warps


def as_bytes(t: torch.Tensor) -> torch.Tensor:
    """``t``, or its uint8 view for fp8: PyTorch's index_copy_,
    index_select and advanced indexing do not all take float8 dtypes, and
    a move of bytes is exact."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t


def gather_pages(pages: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Per-row contiguous view of a paged pool.

    pages: [NB, bs, ...]; block_tables: [B, MBS] -> [B, MBS * bs, ...].
    """
    g = as_bytes(pages)[block_tables.long()]             # [B, MBS, bs, ...]
    g = g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + g.shape[3:])
    return g.view(pages.dtype)


def causal_allowed(q_pos, kv_len, s: int, window: int = 0):
    """Boolean [B, Tq, S] causal visibility: key p is visible to query i
    iff p < kv_len, p <= q_pos[i] and, with a window, p > q_pos[i] - window."""
    kp = torch.arange(s, device=q_pos.device)[None, None, :]         # [1,1,S]
    qp = q_pos.long()[:, :, None]                                    # [B,Tq,1]
    allowed = (kp < kv_len.long()[:, None, None]) & (kp <= qp)
    if window:
        allowed &= kp > qp - window
    return allowed


def dequantize_kv(codes, scale):
    """codes [..., D] x scales [...] -> float32 values."""
    return codes.float() * scale[..., None].float()


def dequant(k, v, k_scale, v_scale):
    """float32 K/V from codes and their scales, or k, v as they are when
    no scales are given (the plain versions' first step)."""
    if k_scale is None and v_scale is None:
        return k, v
    return dequantize_kv(k, k_scale), dequantize_kv(v, v_scale)


def attend(q, k, v, allowed, *, softcap=0.0, scale=None):
    """Masked GQA attention core in f32 (the plain arithmetic).

    q: [B, Tq, Hq, D]; k, v: [B, S, Hkv, D] where key index = position;
    allowed: [B, Tq, S] bool. A query that sees no key returns 0, as the
    kernels do.
    """
    b, tq, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, tq, hkv, g, d).float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    allowed = allowed[:, None, None]                                 # [B,1,1,Tq,S]
    logits = torch.where(allowed, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(allowed, torch.exp(logits - m), 0.0)
    denom = p.sum(dim=-1, keepdim=True)
    probs = p / torch.where(denom == 0, 1.0, denom)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(b, tq, hq, d).to(q.dtype)


def decode_attention_ref(q, k, v, kv_len, q_pos, *, k_scale=None,
                         v_scale=None, window=0, softcap=0.0, scale=None):
    """The contiguous plain version: dequantize (with scales), then the
    causal masked f32 softmax over k, v [B, S, Hkv, D]."""
    k, v = dequant(k, v, k_scale, v_scale)
    return attend(q, k, v, causal_allowed(q_pos, kv_len, k.shape[1], window),
                  softcap=softcap, scale=scale)


def gather_scales(k_scale, v_scale, block_tables):
    """Each row's scales [B, MBS * bs, Hkv] from scale pools, or Nones."""
    if k_scale is None:
        return None, None
    return (gather_pages(k_scale, block_tables),
            gather_pages(v_scale, block_tables))


def decode_attention_paged_ref(q, k_pages, v_pages, block_tables, kv_len,
                               q_pos, *, k_scale=None, v_scale=None, window=0,
                               softcap=0.0, scale=None):
    """The paged plain version: gather each row's pages (and scales) into
    a contiguous view, then the contiguous plain version."""
    ks, vs = gather_scales(k_scale, v_scale, block_tables)
    return decode_attention_ref(q, gather_pages(k_pages, block_tables),
                                gather_pages(v_pages, block_tables), kv_len,
                                q_pos, k_scale=ks, v_scale=vs, window=window,
                                softcap=softcap, scale=scale)


def check_inputs(q, k, v, ints, k_scale=None, v_scale=None):
    """Raise on what the attention kernels do not take.

    q: [B, Tq, Hq, D] float32 / bfloat16; k, v: a pool [NB, bs, Hkv, D]
    or a cache [B, S, Hkv, D] in float32 / bfloat16, or int8 / fp8 with
    float32 scales k_scale, v_scale of k's shape less D; ``ints``: (name,
    tensor, shape) of each int32 operand.
    """
    b, tq, hq, d = q.shape
    if k.dim() != 4 or v.shape != k.shape or k.shape[-1] != d:
        raise ValueError(f"K/V shapes {tuple(k.shape)} / {tuple(v.shape)} do "
                         f"not fit q {tuple(q.shape)}")
    hkv = k.shape[2]
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} kv heads")
    if d not in _HEAD_DIMS:
        raise ValueError(f"head dim {d} not built (kernels take {_HEAD_DIMS})")
    if q.dtype not in _Q_DTYPES or k.dtype not in _DTYPE_CODE \
            or v.dtype != k.dtype:
        raise TypeError(f"dtypes q={q.dtype} k={k.dtype} v={v.dtype}: "
                        f"kernels take float32/bfloat16 q and "
                        f"float32/bfloat16/int8/float8_e4m3fn K/V")
    scales = [("k_scale", k_scale), ("v_scale", v_scale)]
    if k.dtype in QUANT_KV:
        for name, t in scales:
            if t is None:
                raise ValueError(f"{k.dtype} K/V need {name}")
            if tuple(t.shape) != tuple(k.shape[:-1]):
                raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                                 f"expected {tuple(k.shape[:-1])}")
            if t.dtype != torch.float32:
                raise TypeError(f"{name} must be float32, got {t.dtype}")
    elif k_scale is not None or v_scale is not None:
        raise ValueError(f"scales come with int8 / fp8 K/V, not {k.dtype}")
    scales = [(n, t) for n, t in scales if t is not None]
    for name, t, shape in ints:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"{tuple(shape)}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
    for name, t in [("q", q), ("k", k), ("v", v)] + scales + \
            [(n, t) for n, t, _ in ints]:
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:                 # 16-byte vector loads
            raise ValueError(f"{name} must be 16-byte aligned")


def on_card(q) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (the plain version); raises for any other device."""
    if q.device.type == "cpu":
        return False
    if q.device.type != "cuda":
        raise ValueError(f"no kernel for device {q.device}")
    return True


def launch(name: str, q, *args):
    """Launch ``csrc/<name>.cu``'s C function on q's device and the
    current stream, with ``args`` as ctypes values (the stream is
    appended); raise on a CUDA error, count the launch."""
    fn = getattr(build.load(name), name)
    with torch.cuda.device(q.device):
        args = args + (ctypes.c_void_p(torch.cuda.current_stream().cuda_stream),)
        if fn.argtypes is None:
            fn.argtypes = [type(a) for a in args]
            fn.restype = ctypes.c_int
        err = fn(*args)
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    launches[name] += 1


def ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    """A tensor's device address; None (no scales) is a null pointer."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def dims(q, k, scale, window, softcap):
    """The shared trailing ctypes arguments: (B, Tq, Hq, Hkv, D) first,
    then the dtype codes, scale, window and softcap."""
    b, tq, hq, d = q.shape
    head = tuple(ctypes.c_int(x) for x in (b, tq, hq, k.shape[2], d))
    tail = (ctypes.c_int(_DTYPE_CODE[q.dtype]), ctypes.c_int(_DTYPE_CODE[k.dtype]),
            ctypes.c_float(scale), ctypes.c_int(int(window)),
            ctypes.c_float(float(softcap)))
    return head, tail


def sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def plan_args(q, hkv: int, reach: int):
    """The serving kernels' trailing (cluster, warps) ctypes arguments:
    ``split_kv_plan`` of q [B, Tq, Hq, D], ``hkv`` kv heads and a row's
    ``reach`` (an int from shapes), with the card's SM count."""
    b, tq, hq, _ = q.shape
    plan = split_kv_plan(b, hkv, tq * (hq // hkv), reach, sm_count(q.device))
    return tuple(ctypes.c_int(x) for x in plan)


def decode_attention_paged(q, k_pages, v_pages, block_tables, kv_len, q_pos,
                           *, k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None, window=0,
                           softcap=0.0, scale=None):
    """Paged-pool decode/verify attention.

    q: [B, Tq, Hq, D]; k_pages, v_pages: [NB, block, Hkv, D] (block 0 is
    the reserved garbage block); block_tables: [B, MBS] int32; kv_len: [B]
    int32; q_pos: [B, Tq] int32; k_scale, v_scale: [NB, block, Hkv]
    float32, with int8 / fp8 pools. Returns [B, Tq, Hq, D] in q's dtype.
    On the card, bf16 q with bf16, int8 or fp8 pools takes the split-KV
    tensor-core loop; the call reads no device value and allocates only
    its output.
    """
    b, tq, _, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if not on_card(q):
        return decode_attention_paged_ref(
            q, k_pages, v_pages, block_tables, kv_len, q_pos,
            k_scale=k_scale, v_scale=v_scale, window=window, softcap=softcap,
            scale=scale)
    check_inputs(q, k_pages, v_pages, (
        ("block_tables", block_tables, (b, block_tables.shape[-1])),
        ("kv_len", kv_len, (b,)), ("q_pos", q_pos, (b, tq))), k_scale, v_scale)
    nb, bs = k_pages.shape[:2]
    out = torch.empty_like(q)
    head, tail = dims(q, k_pages, scale, window, softcap)
    launch("decode_attention_paged", q, ptr(q), ptr(k_pages), ptr(v_pages),
           ptr(k_scale), ptr(v_scale),
           ptr(block_tables), ptr(kv_len), ptr(q_pos), ptr(out), *head,
           *(ctypes.c_int(x) for x in (nb, bs, block_tables.shape[1])), *tail,
           *plan_args(q, k_pages.shape[2], block_tables.shape[1] * bs))
    return out


def decode_attention(q, k, v, kv_len, q_pos, *,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None, window=0,
                     softcap=0.0, scale=None):
    """Contiguous-cache decode/verify attention.

    q: [B, Tq, Hq, D]; k, v: [B, S, Hkv, D]; kv_len: [B] int32 (entries
    past S do not exist: the sweep stops at min(kv_len, S)); q_pos: [B, Tq]
    int32; k_scale, v_scale: [B, S, Hkv] float32, with int8 / fp8 caches.
    Returns [B, Tq, Hq, D] in q's dtype. Unlike the TPU wrapper, S is not
    padded. On the card, bf16 q with a bf16, int8 or fp8 cache takes the
    split-KV tensor-core loop, planned with the reach S; the call reads no
    device value and allocates only its output.
    """
    b, tq, _, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if not on_card(q):
        return decode_attention_ref(q, k, v, kv_len, q_pos, k_scale=k_scale,
                                    v_scale=v_scale, window=window,
                                    softcap=softcap, scale=scale)
    if k.shape[0] != b:
        raise ValueError(f"cache batch {k.shape[0]} != q batch {b}")
    check_inputs(q, k, v, (("kv_len", kv_len, (b,)),
                           ("q_pos", q_pos, (b, tq))), k_scale, v_scale)
    out = torch.empty_like(q)
    head, tail = dims(q, k, scale, window, softcap)
    s = k.shape[1]
    launch("decode_attention", q, ptr(q), ptr(k), ptr(v), ptr(k_scale),
           ptr(v_scale), ptr(kv_len),
           ptr(q_pos), ptr(out), *head, ctypes.c_int(s), *tail,
           *plan_args(q, k.shape[2], s))
    return out
