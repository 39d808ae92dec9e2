"""Config registry of the port: the paper's draft/target families, the
tiny test models, mamba2-130m, the dense families deepseek-67b,
command-r-35b and gemma2-27b, the MoE decoder granite-moe-3b-a800m and
the Mamba2 + attention + MoE hybrid jamba-1.5-large-398b (copies of the
JAX package's ``repro.configs`` modules of the same names).

``get_config(name)`` takes the dashed public id (e.g. ``llama3.1-8b``) or a
``-smoke`` suffix for the reduced same-family variant. The JAX package's
other architectures come with the slices that port their layers.
"""
from __future__ import annotations

from ..models.config import ModelConfig
from . import (command_r_35b, deepseek_67b, gemma2_27b, granite_moe_3b_a800m,
               jamba_1_5_large_398b, mamba2_130m, paper_models, tiny)

CONFIGS = {m.CONFIG.name: m.CONFIG for m in (
    command_r_35b, gemma2_27b, deepseek_67b, mamba2_130m,
    granite_moe_3b_a800m, jamba_1_5_large_398b)}
CONFIGS.update(paper_models.CONFIGS)
CONFIGS.update(tiny.CONFIGS)


def get_config(name: str) -> ModelConfig:
    if name.endswith("-smoke"):
        return CONFIGS[name[:-len("-smoke")]].reduced()
    return CONFIGS[name]
