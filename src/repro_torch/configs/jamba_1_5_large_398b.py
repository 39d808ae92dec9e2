"""jamba-1.5-large-398b — hybrid Mamba2+attention (1:7 interleave) + MoE.
[arXiv:2403.19887] 72L d_model=8192 64H (kv=8) d_ff=24576 vocab=65536,
MoE 16 experts top-2 on every other layer, ssm_state=128.
A copy of ``repro.configs.jamba_1_5_large_398b`` (the port never
imports the JAX package).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    num_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    head_dim=128,
    attn_every=8,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    moe_num_experts=16,
    moe_top_k=2,
    moe_d_ff=24576,
    moe_period=2,
    use_rope=False,
    tie_embeddings=False,
    max_seq_len=262144,
    source="arXiv:2403.19887",
)
