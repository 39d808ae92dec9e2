"""Config registry of the port: the paper's draft/target families, the
tiny test models and mamba2-130m (copies of ``repro.configs.paper_models``
/ ``tiny`` / ``mamba2_130m``).

``get_config(name)`` takes the dashed public id (e.g. ``llama3.1-8b``) or a
``-smoke`` suffix for the reduced same-family variant. The JAX package's
other architectures come with the slices that port their layers.
"""
from __future__ import annotations

from ..models.config import ModelConfig
from . import mamba2_130m, paper_models, tiny

CONFIGS = {mamba2_130m.CONFIG.name: mamba2_130m.CONFIG}
CONFIGS.update(paper_models.CONFIGS)
CONFIGS.update(tiny.CONFIGS)


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return CONFIGS[name[:-len("-smoke")]].reduced()
    return CONFIGS[name]
