"""granite-moe-3b-a800m — MoE decoder, 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base family] 32L d_model=1536 24H
(kv=8) expert d_ff=512 vocab=49155.
NOTE: assignment bracket said "32 experts"; the column spec says 40e —
we use 40 (DESIGN.md §4).
A copy of ``repro.configs.granite_moe_3b_a800m`` (the port never
imports the JAX package).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    arch_type="moe",
    num_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    head_dim=64,
    moe_num_experts=40,
    moe_top_k=8,
    moe_d_ff=512,
    tie_embeddings=True,
    max_seq_len=4096,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
)
