"""gemma2-27b — dense GQA with local/global alternation + logit softcaps.
[arXiv:2408.00118] 46L d_model=4608 32H (kv=16) d_ff=36864 vocab=256000,
sliding_window=4096 on local layers, attn softcap 50, final softcap 30,
sandwich norms, sqrt(d) embedding scale, query scale (d/h)^-0.5.
A copy of ``repro.configs.gemma2_27b`` (the port never imports the JAX
package).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    arch_type="dense",
    num_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab_size=256000,
    head_dim=128,
    local_global_period=2,
    sliding_window=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    attn_scale=(4608 / 32) ** -0.5,
    post_block_norms=True,
    embed_scale=True,
    mlp_act="gelu",
    tie_embeddings=True,
    max_seq_len=8192,
    source="arXiv:2408.00118",
)
