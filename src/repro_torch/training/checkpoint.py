"""Checkpoints in the JAX package's format, so each package reads what the
other writes.

Port of ``repro.training.checkpoint``: one ``.npz`` whose keys are the
``/``-joined paths of the tree (``/embed/embedding``, ``/scan/#0/mixer/wq``;
dict keys sorted, list entries ``#i``, ``None`` as ``<path>/@none``) plus a
``.manifest.json`` with the keys and the caller's metadata. Tensors are
written as float32 numpy arrays (bf16 widens exactly); ``restore`` casts
each array to the dtype and device of the matching leaf of ``like``.
"""
from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch


def _flatten(tree) -> dict:
    flat = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(f"{prefix}/{k}", node[k])
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(f"{prefix}/#{i}", v)
        elif node is None:
            flat[prefix + "/@none"] = np.zeros((0,))
        elif isinstance(node, torch.Tensor):
            x = node.detach().cpu()
            flat[prefix] = (x.float() if x.dtype == torch.bfloat16 else x).numpy()
        else:
            flat[prefix] = np.asarray(node)

    walk("", tree)
    return flat


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def _manifest_path(path: str) -> str:
    base = path[:-4] if path.endswith(".npz") else path
    return base + ".manifest.json"


def save(path: str, tree: Any, metadata: dict | None = None) -> None:
    """Write ``tree`` (nested dicts / lists of tensors or arrays) to
    ``path`` (.npz) and its manifest."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = _flatten(tree)
    np.savez(_npz_path(path), **flat)
    with open(_manifest_path(path), "w") as f:
        json.dump({"keys": sorted(flat), "metadata": metadata or {}}, f)


def restore(path: str, like: Any) -> Any:
    """Read a checkpoint into the structure of ``like`` (shapes checked;
    each leaf takes the dtype and device of ``like``'s leaf)."""
    with np.load(_npz_path(path)) as npz:
        def build(prefix, node):
            if isinstance(node, dict):
                return {k: build(f"{prefix}/{k}", node[k]) for k in node}
            if isinstance(node, (list, tuple)):
                return type(node)(build(f"{prefix}/#{i}", v)
                                  for i, v in enumerate(node))
            if node is None:
                return None
            arr = npz[prefix]
            if arr.shape != tuple(node.shape):
                raise ValueError(f"{prefix}: shape {arr.shape} != "
                                 f"{tuple(node.shape)}")
            return torch.from_numpy(np.ascontiguousarray(arr)).to(
                device=node.device, dtype=node.dtype)

        return build("", like)


def load_metadata(path: str) -> dict:
    with open(_manifest_path(path)) as f:
        return json.load(f)["metadata"]
