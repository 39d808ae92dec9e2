"""Counter-based threefry2x32 random numbers that draw the JAX package's
own bits, in plain PyTorch.

A key is two uint32 words held in an int64 tensor ``[..., 2]``; any
leading axes are independent keys, so one call draws for ``[B]`` rows or
``[B, N]`` tree nodes at once. Every draw hashes (key, counter) with the
Threefry-2x32 block cipher (20 rounds), as ``jax.random`` does with its
default ``threefry2x32`` implementation and ``jax_threefry_partitionable``
on:

  * ``key(seed)`` is ``[0, seed mod 2^32]`` (``threefry_seed`` with 64-bit
    integers disabled);
  * ``fold_in(k, d)`` hashes the counter pair (0, d);
  * ``split(k, n)[i]`` hashes (0, i), so it equals ``fold_in(k, i)``;
  * ``bits(k, shape)`` hashes the flat index of each element, split into
    (high, low) 32-bit words, and xors the two output words;
  * ``uniform`` puts the top 23 bits in the mantissa of a float in [1, 2)
    and subtracts 1; ``categorical`` is the Gumbel-max argmax of
    ``logits - log(-log(u))`` with ``u`` uniform in [tiny, 1) (JAX's "low"
    mode).

The generator keeps no host state: no ``torch.Generator``, no ``.item()``.
The same keys give the same bits on the CPU and on the card, so sampled
tokens depend only on the keys, never on the device. Each draw is ~170
elementwise int64 passes over its output; a fused kernel is later work.
"""
from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_TINY = torch.finfo(torch.float32).tiny


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash of counters (x0, x1) under key (k0, k1): int64
    tensors holding uint32 words, broadcast against each other. Returns the
    two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """[2] int64 key of an integer seed, as ``jax.random.PRNGKey(seed)``
    gives it with 64-bit integers disabled: ``[0, seed mod 2^32]``."""
    seed = int(seed)
    if not -2 ** 63 <= seed < 2 ** 63:
        raise ValueError(f"seed {seed} does not fit 64 bits")
    return torch.tensor([0, seed & MASK], dtype=torch.int64, device=device)


def _words(keys: torch.Tensor):
    if keys.shape[-1:] != (2,) or keys.dtype != torch.int64:
        raise TypeError(f"keys must be [..., 2] int64, got "
                        f"{tuple(keys.shape)} {keys.dtype}")
    return keys[..., 0], keys[..., 1]


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """Keys ``[..., 2]`` with ``data`` (an int, or uint32 values in an
    integer tensor broadcast against the key axes) folded in."""
    k0, k1 = _words(keys)
    if isinstance(data, torch.Tensor):
        data = data.to(device=keys.device, dtype=torch.int64) & MASK
        y0, y1 = threefry2x32(k0, k1, torch.zeros_like(data), data)
    else:       # a Python int stays on the host: no copy into the step
        y0, y1 = threefry2x32(k0, k1, 0, int(data) & MASK)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(keys: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``[..., n, 2]``: ``n`` new keys from each key (``jax.random.split``)."""
    return fold_in(keys[..., None, :],
                   torch.arange(n, dtype=torch.int64, device=keys.device))


def _counters(shape, device):
    """(high, low) words of the flat element index over ``shape``."""
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    return idx >> 32, idx & MASK


def bits(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """uint32 words (int64) of shape ``keys.shape[:-1] + shape``: each key
    draws ``shape`` words, as ``jax.random.bits(key, shape)``."""
    shape = tuple(shape)
    k0, k1 = _words(keys)
    lead = k0.shape
    k0 = k0.reshape(lead + (1,) * len(shape))
    k1 = k1.reshape(lead + (1,) * len(shape))
    hi, lo = _counters(shape, keys.device)
    y0, y1 = threefry2x32(k0, k1, hi, lo)
    return y0 ^ y1


def uniform(keys: torch.Tensor, shape=(), minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """float32 draws in [minval, maxval) of shape ``keys.shape[:-1] +
    shape``, bit for bit ``jax.random.uniform(key, shape, float32, minval,
    maxval)`` under each key."""
    word = (bits(keys, shape) >> 9) | 0x3F800000
    floats = word.to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = np.float32(maxval) - lo            # float32 arithmetic, on the host
    if span == 1.0:
        out = floats * float(span) + float(lo)      # the product is exact
    else:
        # XLA fuses the scale and shift into one multiply-add: the f64
        # product is exact, so one rounding to f32 is what it gives
        out = (floats.double() * float(span) + float(lo)).float()
    return out.clamp(min=float(lo))


def gumbel(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """float32 Gumbel draws (``jax.random.gumbel``, mode "low")."""
    return -torch.log(-torch.log(uniform(keys, shape, minval=_TINY)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """Samples of ``softmax(logits)`` over the last axis (int64), as
    ``jax.random.categorical(key, logits)``: each key of ``keys [..., 2]``
    draws Gumbel noise over the rest of ``logits``, whose leading axes are
    the key axes; the argmax keeps the lowest index on ties."""
    lead = keys.shape[:-1]
    if tuple(logits.shape[:len(lead)]) != tuple(lead):
        raise ValueError(f"logits {tuple(logits.shape)} do not start with "
                         f"the key axes {tuple(lead)}")
    logits = logits.float()
    noise = gumbel(keys, logits.shape[len(lead):])
    return (noise + logits).argmax(dim=-1)
