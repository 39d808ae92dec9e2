"""command-r-35b — dense GQA decoder, parallel attn/ffn block, no bias.
[hf:CohereForAI/c4ai-command-r-v01] 40L d_model=8192 64H (kv=8)
d_ff=22528 vocab=256000.
A copy of ``repro.configs.command_r_35b`` (the port never imports the JAX
package).
"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    arch_type="dense",
    num_layers=40,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    head_dim=128,
    use_layernorm=True,
    parallel_block=True,
    rope_theta=8_000_000.0,
    tie_embeddings=True,
    max_seq_len=131072,
    source="hf:CohereForAI/c4ai-command-r-v01",
)
