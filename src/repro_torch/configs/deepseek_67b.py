"""deepseek-67b — llama-architecture dense GQA decoder. [arXiv:2401.02954]
95L d_model=8192 64H (kv=8) d_ff=22016 vocab=102400.
A copy of ``repro.configs.deepseek_67b`` (the port never imports the JAX
package).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    arch_type="dense",
    num_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab_size=102400,
    head_dim=128,
    tie_embeddings=False,
    max_seq_len=4096,
    source="arXiv:2401.02954",
)
