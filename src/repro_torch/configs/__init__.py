"""Config registry of the port: the paper's draft/target families and the
tiny test models (copies of ``repro.configs.paper_models`` / ``tiny``).

``get_config(name)`` takes the dashed public id (e.g. ``llama3.1-8b``) or a
``-smoke`` suffix for the reduced same-family variant. The JAX package's
other architectures come with the slices that port their layers.
"""
from __future__ import annotations

from ..models.config import ModelConfig
from . import paper_models, tiny

CONFIGS = {}
CONFIGS.update(paper_models.CONFIGS)
CONFIGS.update(tiny.CONFIGS)


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return CONFIGS[name[:-len("-smoke")]].reduced()
    return CONFIGS[name]
