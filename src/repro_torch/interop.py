"""Convert params between the JAX package and the port.

``params_from_numpy`` takes the JAX params tree with every leaf turned
into a numpy array (``jax.tree.map(np.asarray, params)``: nested dicts and
lists, the stacked ``params["scan"]`` leaves included) and returns the
port's tree of tensors. Both packages use the same einsum layouts
(``wq [d, Hq, hd]``, ``wo [Hq, hd, d]``, ...), so the conversion is a copy.
Leaves are stored in ``dtype`` except the norm scales, which stay float32:
bf16 storage equals the JAX code's ``.astype(x.dtype)`` at use.
``params_to_numpy`` is its inverse: the port's tree with every leaf a
float32 numpy array (bf16 leaves widen exactly), for checkpoints and for
handing trained weights back to the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.config import ModelConfig
from .models.transformer import leaf_dtype, param_shapes


def params_from_numpy(tree, cfg: ModelConfig, device="cpu",
                      dtype=torch.float32):
    """JAX params (numpy leaves) -> port params on ``device``."""
    return _convert(tree, param_shapes(cfg), "", device, dtype)


def _convert(tree, shapes, name, device, dtype):
    if isinstance(shapes, dict):
        if not isinstance(tree, dict) or set(tree) != set(shapes):
            raise ValueError(f"params at {name!r}: keys "
                             f"{sorted(tree) if isinstance(tree, dict) else tree!r}"
                             f" != {sorted(shapes)}")
        return {k: _convert(tree[k], shapes[k], k, device, dtype)
                for k in shapes}
    if isinstance(shapes, list):
        if len(tree) != len(shapes):
            raise ValueError(f"params at {name!r}: {len(tree)} entries, "
                             f"expected {len(shapes)}")
        return [_convert(t, s, name, device, dtype)
                for t, s in zip(tree, shapes)]
    arr = np.asarray(tree)
    if arr.shape != tuple(shapes):
        raise ValueError(f"param {name!r}: shape {arr.shape} != {shapes}")
    return torch.from_numpy(arr.astype(np.float32)).to(
        device=device, dtype=leaf_dtype(name, dtype))


def params_to_numpy(tree):
    """Port params (nested dicts and lists of tensors) -> the same tree of
    float32 numpy arrays on the host."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    return tree.detach().to("cpu", torch.float32).numpy()
