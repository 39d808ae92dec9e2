"""Typed configuration of the serving stack (port of
``repro.serving.config``) with the JAX package's defaults.

Settings outside the port's slices so far raise ``NotImplementedError``:
mode ``vsd``, the prefix cache, ``tp``/``dp`` > 1 and temperature > 0.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

from ..core.spec_decode import TemplateBank, TreeTemplate, as_bank
from ..models.attention import KV_DTYPES


def _later(what: str):
    raise NotImplementedError(f"{what} comes with a later slice of the port")


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decode options: ``max_new`` tokens to generate, the
    temperature (0 or None = greedy, the only ported rule) and
    ``tree_idx``, which pins one TemplateBank template (tree engines)."""
    max_new: Optional[int] = None
    temperature: Optional[float] = None
    tree_idx: Optional[int] = None

    def __post_init__(self):
        if self.max_new is not None and self.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")
        if self.temperature is not None and self.temperature < 0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.temperature:
            _later("sampling (temperature > 0)")


@dataclasses.dataclass
class EngineConfig:
    """Engine construction knobs; validated once at construction. ``tree``
    (a branching iterable, TreeTemplate or TemplateBank) is normalised to a
    TemplateBank; ``adaptive_tree`` without a tree selects
    ``TemplateBank.default(k)``."""

    mode: str = "pard"
    k: int = 8
    max_batch: int = 4
    max_len: int = 1024
    temperature: float = 0.0
    eos_id: Optional[int] = None
    kv_layout: str = "paged"
    kv_block_size: int = 64
    kv_num_blocks: Optional[int] = None
    kv_dtype: str = "bf16"
    tree: Any = None
    adaptive_tree: bool = False
    tree_ewma: float = 0.2
    tree_reselect_every: int = 4
    prefix_cache: bool = False
    prefill_chunk: int = 8
    prefill_budget: Optional[int] = None
    admit_window: int = 8
    tp: int = 1
    dp: int = 1

    def __post_init__(self):
        if self.mode not in ("ar", "vsd", "pard"):
            raise ValueError(f"mode must be ar, vsd or pard, got {self.mode!r}")
        if self.kv_layout not in ("paged", "contiguous"):
            raise ValueError(f"kv_layout must be paged or contiguous, "
                             f"got {self.kv_layout!r}")
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(f"unknown kv_dtype {self.kv_dtype!r}")
        if self.tree is not None and self.mode != "pard":
            raise ValueError("tree templates apply to the PARD draft path only")
        if self.adaptive_tree:
            if self.mode != "pard":
                raise ValueError("adaptive trees require mode='pard'")
            if self.tree is None:
                self.tree = TemplateBank.default(self.k)
            if not isinstance(self.tree, TemplateBank):
                raise ValueError("adaptive_tree selects from a TemplateBank")
        if self.tree is not None:
            self.tree = as_bank(self.tree)
        for name in ("k", "max_batch", "max_len", "kv_block_size",
                     "prefill_chunk", "admit_window", "tree_reselect_every",
                     "tp", "dp"):
            if getattr(self, name) < 1:
                raise ValueError(f"{name} must be >= 1, "
                                 f"got {getattr(self, name)}")
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, "
                             f"got {self.temperature}")
        if not 0.0 < self.tree_ewma <= 1.0:
            raise ValueError(f"tree_ewma must be in (0, 1], "
                             f"got {self.tree_ewma}")
        if self.mode == "vsd":
            _later("VSD")
        if self.prefix_cache:
            _later("the prefix cache")
        if self.tp > 1 or self.dp > 1:
            _later("multi-device serving (tp/dp > 1)")
        if self.temperature > 0:
            _later("sampling (temperature > 0)")

    @property
    def paged(self) -> bool:
        return self.kv_layout == "paged"

    @classmethod
    def from_args(cls, ns) -> "EngineConfig":
        """Build from an argparse namespace; missing attributes keep the
        field defaults. ``ns.tree`` may be the CLI string form ("2,2,1")."""
        tree = getattr(ns, "tree", None)
        if getattr(ns, "adaptive_tree", False) and tree is not None:
            raise ValueError("--adaptive-tree selects its own bank; drop --tree")
        if isinstance(tree, str):
            tree = TreeTemplate.from_branching(int(x) for x in tree.split(","))
        kw = {f.name: getattr(ns, f.name) for f in dataclasses.fields(cls)
              if f.name != "tree" and hasattr(ns, f.name)}
        return cls(tree=tree, **kw)
