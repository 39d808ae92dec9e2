"""Model configuration and per-layer plan derivation.

A ``ModelConfig`` fully describes one architecture from the assigned pool.
``layer_plan(cfg)`` expands it into a list of ``LayerSpec`` (one per layer),
and ``scan_plan(cfg)`` groups the layers into a repeating *period*. Params
and caches of the periodic layers are stacked on a leading ``n_repeats``
axis, as in the JAX package, so its weights convert by plain copies.

A copy of ``repro.models.config`` (pure Python): the port never imports
the JAX package.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Layer spec
# ---------------------------------------------------------------------------

# mixer kinds
ATTN_GLOBAL = "attn_global"   # full causal self attention (GQA)
ATTN_LOCAL = "attn_local"     # sliding-window causal self attention
ATTN_MLA = "attn_mla"         # multi-head latent attention (compressed KV)
ATTN_CROSS = "attn_cross"     # cross attention to static encoder/image KV
SSM = "ssm"                   # mamba2 SSD block

# mlp kinds
MLP_DENSE = "dense"
MLP_MOE = "moe"
MLP_NONE = "none"             # mamba2 blocks carry no MLP


@dataclass(frozen=True)
class LayerSpec:
    mixer: str
    mlp: str


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str              # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # --- attention flavour -------------------------------------------------
    attn_kind: str = "gqa"      # gqa | mla
    rope_theta: float = 10000.0
    sliding_window: int = 0             # 0 = no local layers
    local_global_period: int = 0        # gemma2: 2 -> alternate local/global
    attn_softcap: float = 0.0           # gemma2 attention logit softcap
    final_softcap: float = 0.0          # gemma2 final logit softcap
    attn_scale: float = 0.0             # 0 -> 1/sqrt(head_dim)
    qkv_bias: bool = False
    parallel_block: bool = False        # command-r: attn & mlp from same input
    use_layernorm: bool = False         # LayerNorm instead of RMSNorm
    mlp_act: str = "silu"               # silu | gelu
    mlp_gated: bool = True
    use_rope: bool = True
    abs_pos: bool = False               # additive sinusoidal positions (whisper)
    post_block_norms: bool = False      # gemma2 sandwich norms
    embed_scale: bool = False           # gemma: scale embeddings by sqrt(d)
    qk_norm: bool = False

    # --- MLA ---------------------------------------------------------------
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # --- MoE ---------------------------------------------------------------
    moe_num_experts: int = 0
    moe_top_k: int = 0
    moe_num_shared: int = 0
    moe_d_ff: int = 0                   # per-expert ffn dim (0 -> d_ff)
    moe_period: int = 1                 # MoE every `period` layers
    first_dense_layers: int = 0         # deepseek-v2: leading dense layers
    first_dense_d_ff: int = 0
    moe_capacity_factor: float = 1.25

    # --- SSM / hybrid ------------------------------------------------------
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 64
    attn_every: int = 0                 # jamba: 1 attention layer per N layers

    # --- structure ---------------------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500             # whisper: mel frames after conv
    cross_attn_period: int = 0          # llama-vision: every Nth layer cross
    cross_kv_len: int = 0               # static image/encoder KV length
    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    max_seq_len: int = 131072
    source: str = ""                    # citation

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 for clean vocab-axis sharding.
        Always reserves >=1 extra id: ``vocab_size`` itself is the PARD mask
        token (embeddable but masked out of the logits, so it can never be
        predicted)."""
        return _round_up(self.vocab_size + 1, 256)

    @property
    def mask_token_id(self) -> int:
        return self.vocab_size

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_nheads(self) -> int:
        return self.ssm_inner // self.ssm_headdim

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test variant of the same family: <=2 layers, d_model<=512,
        <=4 experts. Keeps every structural feature (MLA, MoE, SSD, softcaps)."""
        changes = dict(
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 2),
            d_model=min(self.d_model, 256),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 1024),
            max_seq_len=512,
        )
        if self.head_dim:
            changes["head_dim"] = 64
        if self.kv_lora_rank:
            changes.update(kv_lora_rank=64, q_lora_rank=min(self.q_lora_rank, 96) if self.q_lora_rank else 0,
                           qk_nope_head_dim=32, qk_rope_head_dim=16, v_head_dim=32)
        if self.moe_num_experts:
            changes.update(moe_num_experts=4, moe_top_k=min(self.moe_top_k, 2),
                           moe_num_shared=min(self.moe_num_shared, 1),
                           moe_d_ff=min(self.moe_d_ff or self.d_ff, 128),
                           first_dense_layers=min(self.first_dense_layers, 1))
        if self.ssm_state:
            changes.update(ssm_state=16, ssm_headdim=32, ssm_chunk=16)
        if self.attn_every:
            # keep the hybrid character: 1 attn + 1 ssm
            changes.update(num_layers=2, attn_every=2)
        if self.cross_attn_period:
            changes.update(num_layers=2, cross_attn_period=2, cross_kv_len=16)
        if self.local_global_period:
            changes.update(num_layers=2, sliding_window=64)
        if self.is_encoder_decoder:
            changes.update(encoder_layers=1, encoder_seq=24)
        if self.first_dense_layers and self.moe_num_experts:
            changes["num_layers"] = 2
        changes.update(overrides)
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# Layer plan
# ---------------------------------------------------------------------------

def _mixer_for_layer(cfg: ModelConfig, i: int) -> str:
    if cfg.attn_every:                       # jamba hybrid: layer i%N==attn_idx
        # 1 attention layer per `attn_every` layers; place it mid-period
        # (jamba places attention at index 4 of each 8-layer block; we use
        #  the last slot of the period for an even split at any period)
        if (i % cfg.attn_every) == cfg.attn_every - 1:
            return ATTN_GLOBAL
        return SSM
    if cfg.arch_type == "ssm":
        return SSM
    if cfg.cross_attn_period and (i % cfg.cross_attn_period) == cfg.cross_attn_period - 1:
        return ATTN_CROSS
    if cfg.attn_kind == "mla":
        return ATTN_MLA
    if cfg.local_global_period:
        # gemma2: even layers local (sliding window), odd layers global
        return ATTN_LOCAL if (i % cfg.local_global_period) != cfg.local_global_period - 1 else ATTN_GLOBAL
    if cfg.sliding_window:
        # sliding window with no period -> every layer local (the windowed
        # long-context serving variant, see launch.steps._windowed)
        return ATTN_LOCAL
    return ATTN_GLOBAL


def _mlp_for_layer(cfg: ModelConfig, i: int) -> str:
    if cfg.arch_type == "ssm":
        return MLP_NONE
    if cfg.attn_every and _mixer_for_layer(cfg, i) == SSM:
        pass  # jamba: every layer (attn or ssm) has an MLP/MoE
    if cfg.moe_num_experts:
        if i < cfg.first_dense_layers:
            return MLP_DENSE
        if (i % cfg.moe_period) == cfg.moe_period - 1 or cfg.moe_period == 1:
            return MLP_MOE
        return MLP_DENSE
    return MLP_DENSE


def layer_plan(cfg: ModelConfig) -> Tuple[LayerSpec, ...]:
    return tuple(LayerSpec(_mixer_for_layer(cfg, i), _mlp_for_layer(cfg, i))
                 for i in range(cfg.num_layers))


@dataclass(frozen=True)
class ScanPlan:
    """Decomposition of the layer stack into prefix + stacked periods.

    layers[0:prefix] run one by one; the remaining layers form
    ``n_repeats`` copies of ``period`` (a tuple of LayerSpec), whose params
    are stacked on a leading ``n_repeats`` axis.
    """
    prefix: Tuple[LayerSpec, ...]
    period: Tuple[LayerSpec, ...]
    n_repeats: int


def scan_plan(cfg: ModelConfig) -> ScanPlan:
    plan = layer_plan(cfg)
    n = len(plan)
    # find smallest period p and prefix q such that plan[q:] is p-periodic
    for prefix_len in range(0, n + 1):
        rest = plan[prefix_len:]
        if not rest:
            return ScanPlan(plan, (), 0)
        for p in range(1, len(rest) + 1):
            if len(rest) % p:
                continue
            period = rest[:p]
            if all(rest[i] == period[i % p] for i in range(len(rest))):
                return ScanPlan(plan[:prefix_len], period, len(rest) // p)
    raise AssertionError("unreachable")
